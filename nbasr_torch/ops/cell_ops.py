"""Split-layout cell ops (``grouped_impl='pallas_split'``): pad -> grouped
conv -> + bias -> clip-ReLU(0, 20) on ``[B, c, T, G]`` activations.

Port of ``nbasr_tpu/ops/cell_ops.py``.  A whole block's cell stack keeps
the split layout (channel ``c_full = g * c + c_in``, group-major); the
forward is the grouped conv kernel of ``nbasr_torch/csrc/grouped_conv.cu``
with the bias and clip-ReLU in its f32 accumulator, one rounding at the
end; the backward runs its dx and dW kernels (``ops/grouped_conv.py``).
The gate and the bias gradient are elementwise torch ops, as XLA computes
them around the TPU kernels.
"""

import torch
from torch.autograd.function import once_differentiable

from .grouped_conv import conv_dw, conv_dx, conv_forward, from_split, \
    to_split

__all__ = ['to_split', 'from_split', 'grouped_conv_relu', 'GroupedConvRelu']


class GroupedConvRelu(torch.autograd.Function):
    """Forward kernel with its bias + clip-ReLU epilogue; the backward
    takes the gate from the saved output, strictly inside (0, 20): at
    exactly 0 or 20 it passes no gradient (``cell_ops.py:155-158``), where
    ``relu20``'s gate passes half.  dx in xs's dtype, dW in the weight
    operand's, db summed in f32 and cast to the bias operand's."""

    @staticmethod
    def forward(ctx, xs, w, b, lpad, dilation):
        B, _, T, G = xs.shape
        ys = torch.empty((B, w.shape[2] // G, T, G), dtype=xs.dtype,
                         device=xs.device)
        conv_forward(xs, w, b, lpad, dilation, ys)
        ctx.save_for_backward(xs, w, ys)
        ctx.conf = lpad, dilation, b.dtype
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        xs, w, ys = ctx.saved_tensors
        lpad, dilation, b_dtype = ctx.conf
        dz = torch.where((ys > 0.0) & (ys < 20.0), dy,
                         torch.zeros((), dtype=dy.dtype, device=dy.device))
        # [co, G] -> group-major [C_out]
        db = dz.sum(dim=(0, 2), dtype=torch.float32).T.reshape(-1).to(b_dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.empty(xs.shape, dtype=xs.dtype, device=xs.device)
            conv_dx(dz, w, lpad, dilation, dx)
        if ctx.needs_input_grad[1]:
            dw = conv_dw(xs, dz, w, lpad, dilation)
        return dx, dw, db, None, None


def grouped_conv_relu(xs, w, b, groups, lpad, rpad, dilation=1):
    """Pad -> grouped conv1d (stride 1) -> + bias -> clip-ReLU(0, 20).

    ``xs`` is a split-layout ``[B, ci, T, G]`` tensor, contiguous or a view
    of any strides (:func:`to_split` of a dense tensor); ``w`` the compact
    grouped kernel ``[K, ci, C_out]`` and ``b`` ``[C_out]``, both in
    ``xs.dtype``.  Returns a contiguous ``[B, co, T, G]``; the padding must
    keep the length.  Differentiable with respect to xs, w and b."""
    K = w.shape[0]
    if lpad + rpad != (K - 1) * dilation:
        raise ValueError(f'padding ({lpad}, {rpad}) does not keep the length '
                         f'for K={K}, d={dilation}')
    if xs.shape[3] != groups:
        raise ValueError(f'xs {tuple(xs.shape)} does not hold {groups} groups')
    return GroupedConvRelu.apply(xs, w, b, lpad, dilation)
