"""Median host milliseconds of one acquisition grid search (cold, warm
or a channel re-sweep: gps_sdr_tpu_torch.utils.profiling's acq.sweep
span around ops/acquisition.py acquire_all, results on the host), over
the span's last durations (profiling.RING) from set-up's warm-up
session and the untraced window: spans add nothing while the profiler
runs.  None where the program keeps no such totals or recorded none."""

import numpy as np


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    sp = profiling.snapshot()["spans"].get("acq.sweep")
    if sp is None or not sp["durations_s"]:
        return None
    return 1e3 * float(np.median(sp["durations_s"]))
