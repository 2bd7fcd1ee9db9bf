"""Median host microseconds to enqueue one fused K-step (heavy_stage and
channel_step_k: gps_sdr_tpu_torch.utils.profiling's track.kstep span in
ops/tracking.py _fused_steps; the K=1 blocks are track.block and left
out), over the span's last durations (profiling.RING) from set-up's
warm-up session and the untraced window: spans add nothing while the
profiler runs.  None where the program keeps no such totals or recorded
none."""

import numpy as np


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    sp = profiling.snapshot()["spans"].get("track.kstep")
    if sp is None or not sp["durations_s"]:
        return None
    return 1e6 * float(np.median(sp["durations_s"]))
