"""95th percentile, over every epoch that left the evaluator in the
window, of the time from the request of its chunk's last block to the
epoch leaving the evaluator (host-fed cells only)."""


def read(ctx):
    return ctx.stats.get("epoch_p95_ms")
