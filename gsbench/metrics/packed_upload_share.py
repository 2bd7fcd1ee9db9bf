"""Share of the tracked host blocks that crossed to the device as the
capture's packed words, in %: gps_sdr_tpu_torch.utils.profiling's
rx.packed_blocks counter (Receiver._upload: 2 bytes a sample, unpacked
on the device) over its rx.blocks counter, from set-up's warm-up session
and the untraced window: counters add nothing while the profiler runs.
None where the program keeps no such totals, counts no packed upload at
all (a program without the mechanism), or tracked no block."""


def read(ctx):
    from gps_sdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "snapshot"):
        return None
    counts = profiling.snapshot()["counts"]
    blocks = counts.get("rx.blocks", 0)
    if "rx.packed_blocks" not in counts or not blocks:
        return None
    return 100.0 * counts["rx.packed_blocks"] / blocks
