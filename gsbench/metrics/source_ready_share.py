"""Share of the capture's blocks that the receiver loop took without
waiting on the file read, in %: gps_sdr_tpu_torch.utils.profiling's
source.ready counter (runtime/sources.py replay_blocks: blocks of a
chunk its reader thread had read before the loop asked for it) over its
source.blocks counter (blocks handed out), from set-up's warm-up
session and the untraced window: counters add nothing while the
profiler runs.  None where the program keeps no such totals or counts
no block handed out (a program that reads the capture on the loop's own
thread)."""


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    counts = profiling.snapshot()["counts"]
    blocks = counts.get("source.blocks", 0)
    if not blocks:
        return None
    return 100.0 * counts.get("source.ready", 0) / blocks
