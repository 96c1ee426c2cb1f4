"""Device kernels launched a device step."""
from perfbench.readers import launches_per_step as read  # noqa: F401
