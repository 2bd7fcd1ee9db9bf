"""95th percentile of the host milliseconds one chunk takes in
Receiver.run, from dispatch to its EpochInput (gps_sdr_tpu_torch.utils.
profiling's rx.chunk span: upload, K-step enqueue, download, nav and any
channel re-sweep), over the span's last durations (profiling.RING) from
set-up's warm-up session and the untraced window: spans add nothing
while the profiler runs.  None where the program keeps no such totals
or recorded none."""

import numpy as np


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    sp = profiling.snapshot()["spans"].get("rx.chunk")
    if sp is None or not sp["durations_s"]:
        return None
    return 1e3 * float(np.percentile(sp["durations_s"], 95))
