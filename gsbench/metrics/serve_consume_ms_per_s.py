"""StreamServer.perf's unpack and consume (the host decode of the
packed rows and the receivers' nav and epoch build) in the window, in
ms per stream-signal second."""


def read(ctx):
    s = ctx.stats["signal_s"]
    if "perf_consume_s" not in ctx.stats or s <= 0:
        return None
    return 1e3 * (ctx.stats["perf_unpack_s"]
                  + ctx.stats["perf_consume_s"]) / s
