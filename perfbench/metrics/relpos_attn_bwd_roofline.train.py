"""The Conformer's relative-position attention backward kernels' share of
their roofline, %."""
from perfbench.archs.conformer_ctc import attention_roofline


def read(ctx):
    return attention_roofline(ctx, backward=True)
