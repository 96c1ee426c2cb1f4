"""The Conformer's relative-position attention forward kernels' share of
their roofline, %."""
from perfbench.archs.conformer_ctc import attention_roofline as read  # noqa: F401
