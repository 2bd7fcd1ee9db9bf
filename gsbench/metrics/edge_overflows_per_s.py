"""Bit edges the compact download dropped over its cap
(gps_sdr_tpu_torch.utils.profiling's rx.edge_overflows counter, counted
as each chunk or window is consumed: runtime/receiver.py, and the
serving path through it) per stream-signal second tracked (the
rx.blocks counter, summed over streams, times a block's seconds), from
set-up's warm-up session and the untraced window: counters add nothing
while the profiler runs.  The host-fed path downloads whole outputs and
counts 0.  None where the program keeps no such counter or tracked
nothing."""


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    counts = profiling.snapshot()["counts"]
    blocks = counts.get("rx.blocks", 0)
    if "rx.edge_overflows" not in counts or not blocks:
        return None
    sh = ctx.shape
    signal_s = blocks * sh["code_samples"] * sh["n_cyc"] / sh["fs"]
    return counts["rx.edge_overflows"] / signal_s
