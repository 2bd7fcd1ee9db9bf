"""The K-fused tracking loop's share of the H100's roofline: the least
time of work_per_block (gsbench/work.py) times the blocks that fused
K-steps tracked in the traced span (the receivers' k_steps times K,
summed over streams), over the devices' busy time in the span."""

import sys

from gsbench import work


def read(ctx):
    tr = ctx.trace
    k = ctx.config["receiver"]["blocks_per_step"]
    blocks = ctx.delta.get("k_steps", 0) * k
    busy = sum(tr["devices"].values()) if tr else 0.0
    if not blocks or busy <= 0:
        return None
    w = work.work_per_block(ctx.shape, ctx.config["receiver"]["max_sat"])
    least, what = work.floor_s(w["bytes"] * blocks, w["flops"] * blocks)
    print(f"gsbench: track_roofline {blocks} blocks, bound by {what}, "
          f"{least:.6g} s least over {busy:.6g} s busy", file=sys.stderr)
    return 100.0 * work.share(least, busy, "track_roofline_pct")
