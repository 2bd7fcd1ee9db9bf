"""The cheap-stage kernel's share of its roofline, its bytes counted
from the configuration's shapes (gsbench/work.py cheap_bound)."""

from gsbench.metrics._kernel import kernel_share


def read(ctx):
    return kernel_share(ctx, "cheap")
