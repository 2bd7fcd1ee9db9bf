"""The host chunks' upload rate in GB/s: the rx.upload_bytes counter
over the rx.upload span's total (gps_sdr_tpu_torch.utils.profiling;
np.stack, the complex64 cast and the pageable host-to-device copy in
Receiver._dispatch_chunk).  Both come from the program's totals over
set-up's warm-up session and the untraced window: spans and counters
add nothing while the profiler runs.  None where the program keeps no
such totals or recorded none."""


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    snap = profiling.snapshot()
    sp = snap["spans"].get("rx.upload")
    moved = snap["counts"].get("rx.upload_bytes", 0)
    if sp is None or not moved or sp["total_s"] <= 0:
        return None
    return moved / sp["total_s"] / 1e9
