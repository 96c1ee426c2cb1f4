"""The search cells' backward kernels' share of their roofline, %."""
from perfbench.readers import cell_roofline


def read(ctx):
    return cell_roofline(ctx, backward=True)
