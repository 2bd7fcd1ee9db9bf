"""Share of the PRNs searched that acquisition found, in %:
gps_sdr_tpu_torch.utils.profiling's acq.found counter over its acq.prns
counter (ops/acquisition.py acquire_all: cold sweeps, warm grids and
channel re-sweeps), from set-up's warm-up session and the untraced
window: counters add nothing while the profiler runs.  None where the
program keeps no such counters or searched no PRN."""


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    counts = profiling.snapshot()["counts"]
    searched = counts.get("acq.prns", 0)
    if "acq.found" not in counts or not searched:
        return None
    return 100.0 * counts["acq.found"] / searched
