"""StreamServer.perf["dispatch"] (provider calls and the tracking
enqueue) in the window, in ms per stream-signal second."""


def read(ctx):
    s = ctx.stats["signal_s"]
    if "perf_dispatch_s" not in ctx.stats or s <= 0:
        return None
    return 1e3 * ctx.stats["perf_dispatch_s"] / s
