"""Share of the traced span in which no kernel or copy ran on a device
(the interval union of its events), the mean over the cards used."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["devices"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
