"""Host milliseconds of the window outside the evaluator per signal
second, on the single-receiver entry: the chunk loop's dispatch,
upload, download and consume, and each session's construction."""


def read(ctx):
    s = ctx.stats["signal_s"]
    if "receiver_s" not in ctx.stats or s <= 0:
        return None
    return 1e3 * ctx.stats["receiver_s"] / s
