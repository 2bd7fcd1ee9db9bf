"""Share of the fused K-steps whose wipeoff kernel ran a partial last
column tile, in %: gps_sdr_tpu_torch.utils.profiling's
track.partial_tile_steps counter over the count of its track.kstep span
(ops/kstep_graphs.py counts both, for eager and replayed K-steps), from
set-up's warm-up session and the untraced window: spans and counters add
nothing while the profiler runs.  100 where every K-step ran on the
card at a code period off the kernels' 128-column grid (2.4 MS/s: cs
2400).  None where the program keeps no such totals or counted no such
K-step (a program without the counter, a period on the grid, the CPU),
or recorded no K-step."""


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    snap = profiling.snapshot()
    n = snap["counts"].get("track.partial_tile_steps")
    sp = snap["spans"].get("track.kstep")
    if not n or sp is None or not sp["count"]:
        return None
    return 100.0 * n / sp["count"]
