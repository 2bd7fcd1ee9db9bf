"""Host milliseconds waiting for each chunk's kernels and copying its
outputs to the host (gps_sdr_tpu_torch.utils.profiling's rx.download
span, outs_to_numpy in Receiver._consume_chunk) per signal second
tracked (the rx.blocks counter times a block's seconds).  Both come from
the program's totals over set-up's warm-up session and the untraced
window: spans and counters add nothing while the profiler runs, so the
traced lead-in and span are left out.  None where the program keeps no
such totals or recorded none."""


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    snap = profiling.snapshot()
    sp = snap["spans"].get("rx.download")
    blocks = snap["counts"].get("rx.blocks", 0)
    if sp is None or not blocks:
        return None
    sh = ctx.shape
    signal_s = blocks * sh["code_samples"] * sh["n_cyc"] / sh["fs"]
    return 1e3 * sp["total_s"] / signal_s
