"""A hand-written kernel's share of its roofline in the traced span:
its bound at the cell's launch shape, times the launches the program
counted, over the summed device time of that kernel's events."""

import sys

from gsbench import work


def kernel_share(ctx, kind: str):
    tr = ctx.trace
    n = ctx.delta.get(kind, 0)
    if tr is None or not n:
        return None
    got = tr["kernels"][kind]
    if got["count"] != n:
        raise RuntimeError(f"{kind}: {got['count']} kernel events in the "
                           f"trace, {n} launches counted")
    r = ctx.config["receiver"]
    k, c, s = r["blocks_per_step"], r["max_sat"], ctx.streams_per_launch
    if kind == "wipeoff":
        n_bytes, n_flops = work.wipeoff_bound(ctx.shape, s, c, k)
    else:
        n_bytes, n_flops = work.cheap_bound(ctx.shape, s * c, k)
    least, what = work.floor_s(n_bytes * n, n_flops * n)
    print(f"gsbench: {kind} {n} launches of {s} x {c} channels x K={k}, "
          f"bound by {what}, {least:.6g} s least over {got['s']:.6g} s",
          file=sys.stderr)
    return 100.0 * work.share(least, got["s"], f"{kind}_roofline_pct")
