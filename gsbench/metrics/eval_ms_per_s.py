"""Host milliseconds inside the evaluator (Evaluator.process, or
process_many on the serving path) per signal second finished."""


def read(ctx):
    s = ctx.stats["signal_s"]
    return 1e3 * ctx.stats["eval_s"] / s if s > 0 else None
