"""The wipeoff kernel's share of its roofline (whichever of
wipeoff_kernel and wipeoff_vpu_kernel ran: the same work)."""

from gsbench.metrics._kernel import kernel_share


def read(ctx):
    return kernel_share(ctx, "wipeoff")
