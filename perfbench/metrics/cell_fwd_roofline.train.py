"""The search cells' forward kernels' share of their roofline, %."""
from perfbench.readers import cell_roofline as read  # noqa: F401
