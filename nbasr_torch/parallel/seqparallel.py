"""The encoder's finite receptive field, as a time halo.

Counterpart of ``_op_pads`` and ``encoder_halo`` in
``nbasr_tpu/parallel/seqparallel.py``: a window of features extended by
``encoder_halo(model)`` frames on each side computes the global encoder
output on its interior, which is what exact chunked serving relies on.
"""

import numpy as np

from ..models.layers import conv_padding

__all__ = ['encoder_halo']

_OP_CONVS = {'conv5': (5, 1), 'conv5d2': (5, 2),
             'conv7': (7, 1), 'conv7d2': (7, 2)}


def _op_pads(op_name):
    if op_name in _OP_CONVS:
        k, d = _OP_CONVS[op_name]
        return conv_padding(k, d, 1)
    return (0, 0)  # linear / zero / skip are pointwise in time


def encoder_halo(model):
    """(left, right) input-frame halo for exact windowed execution.

    Walks the blocks back to front: a cell's node pads add up, a block conv
    scales the downstream need by its stride and adds its own pads.
    Rounded up to the total time reduction so trims stay integral.
    """
    need_l = need_r = 0
    blocks = list(zip(model.block_kernels, model.block_strides,
                      model.cells_per_block))
    for kernel, stride, cells in reversed(blocks):
        need_l += cells * sum(_op_pads(n[0])[0] for n in model.arch_desc)
        need_r += cells * sum(_op_pads(n[0])[1] for n in model.arch_desc)
        lp, rp = conv_padding(kernel, 1, stride)
        need_l = need_l * stride + lp
        need_r = need_r * stride + rp
    total = int(np.prod(model.block_strides))
    up = lambda v: int(-(-v // total) * total)
    return up(need_l), up(need_r)
