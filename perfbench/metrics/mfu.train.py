"""The whole step's algorithmic FLOPs a second as a % of the dtype's peak."""
from perfbench.readers import mfu as read  # noqa: F401
