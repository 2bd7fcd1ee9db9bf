"""Signal seconds the program finished in the window, summed over its
streams, over the window's seconds: every block whose epoch left the
evaluator before the window closed, in sessions or passes complete or
cut by the close."""


def read(ctx):
    return ctx.stats["signal_s"] / ctx.seconds
