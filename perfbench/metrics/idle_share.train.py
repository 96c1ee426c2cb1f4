"""% of the profiled window with nothing on the device."""
from perfbench.readers import idle_share as read  # noqa: F401
