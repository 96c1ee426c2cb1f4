"""Primitive layers of the ASR encoder, PyTorch, channels-last ([B, T, C]).

Counterpart of ``nbasr_tpu/models/layers.py``.  Module and parameter names
follow the JAX package (``kernel``, ``scale``, ``conv_kernel_grouped`` ...)
so :mod:`nbasr_torch.convert` maps checkpoints by name; the one layout
change is the dense block conv, whose weight is PyTorch's ``[cout, cin, K]``.
Grouped cell convs are not here: the SearchCell runs them in its fused
kernel (``nbasr_torch/ops/fused_cell.py``).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_cell import relu20_gate

__all__ = ['FUTURE_CONTEXT', 'norm_eps', 'relu20', 'conv_padding',
           'kernel_initializer', 'Dense', 'LayerNorm', 'PadConvRelu',
           'LinearRelu', 'MeanVarianceNorm']

#: 4 frames of look-ahead = 40 ms (reference model/tf/ops.py:3).
FUTURE_CONTEXT = 4

#: LayerNorm epsilon (reference model/torch/model.py:47,92).
norm_eps = 1e-3


class _Relu20(torch.autograd.Function):
    """clip(x, 0, 20) with ``jnp.clip``'s VJP: the gradient passes whole
    inside (0, 20), half at exactly 0 or 20, and not at all outside.
    ``torch.clamp`` would pass all of it at the ends; with zero biases a
    fully masked frame puts a block conv's output exactly at 0, so the ends
    are met every step, not by chance."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 20.0)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * relu20_gate(x).to(grad.dtype)


def relu20(x):
    """ReLU clipped at 20 (reference tf/ops.py:26, torch/ops.py:28), with
    the JAX package's gradient at the ends (see :class:`_Relu20`)."""
    return _Relu20.apply(x)


def _fans(shape):
    """(fan_in, fan_out) as flax computes them: in axis -2, out axis -1,
    every leading axis a receptive-field axis."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def kernel_initializer(scheme):
    """``init(shape, generator) -> f32 tensor`` by scheme name, drawing from
    the distributions of ``nbasr_tpu.models.layers.kernel_initializer``:
    ``'scaled'`` N(0, 1/fan_in), ``'he'`` N(0, 2/fan_in) (flax's
    ``variance_scaling(..., 'normal')`` draws an untruncated normal), and
    otherwise glorot-uniform (``'reference'``)."""
    def init(shape, generator):
        fan_in, fan_out = _fans(shape)
        if scheme in ('scaled', 'he'):
            gain = 2.0 if scheme == 'he' else 1.0
            return torch.randn(shape, generator=generator) * math.sqrt(
                gain / fan_in)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape).uniform_(-limit, limit, generator=generator)
    return init


def conv_padding(kernel_size, dilation, strides, context=FUTURE_CONTEXT,
                 pad_math='torch'):
    """(left, right) time padding for :class:`PadConvRelu`: the right pad is
    capped at ``context // strides`` frames of look-ahead, the rest of the
    receptive field is left pad; the output length is ``ceil(T / strides)``.
    ``pad_math='tf'`` is the shipped TF backend's dilation-blind formula
    (``model/tf/ops.py:16-21``), meaningful only with dilation 1."""
    if pad_math == 'tf':
        if dilation != 1:
            raise ValueError(
                "pad_math='tf' pads for an undilated conv; combine it with "
                "apply_dilation=False (the TF backend drops dilation, "
                "model/tf/ops.py:24) or shapes will not line up")
        span = kernel_size - strides
        if context // strides >= span:
            return 0, span
        rpad = context // strides
        return kernel_size - 1 - rpad, rpad
    span = kernel_size * dilation - strides
    if context // strides >= span:
        return 0, span
    rpad = context // strides
    return (kernel_size - 1) * dilation - rpad, rpad


class Dense(nn.Module):
    """``x @ kernel + bias`` with flax's ``Dense`` layout: kernel ``[in, out]``."""

    def __init__(self, in_features, features, init, generator):
        super().__init__()
        self.kernel = nn.Parameter(init((in_features, features), generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, statistics in f32, flax's parameter
    names; the result keeps the input's dtype."""

    def __init__(self, features, epsilon=norm_eps):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            self.epsilon).to(x.dtype)


class _ConvWeights(nn.Module):
    """The dense conv's ``weight [cout, cin, K]`` and ``bias``, initialised
    on flax's ``[K, cin, cout]`` shape so the fans match."""

    def __init__(self, cin, filters, kernel_size, init, generator):
        super().__init__()
        self.weight = nn.Parameter(
            init((kernel_size, cin, filters), generator).permute(2, 1, 0)
            .contiguous())
        self.bias = nn.Parameter(torch.zeros(filters))


class PadConvRelu(nn.Module):
    """Pad → dense Conv1D (stride) → clip-ReLU(20): the encoder's block
    convs (``groups == 1``).  ``[B, T, cin] -> [B, ceil(T/stride), filters]``
    in the input's dtype."""

    def __init__(self, cin, filters, kernel_size, strides=1, dilation=1,
                 pad_math='torch', init_scheme='reference', generator=None):
        super().__init__()
        self.strides = strides
        self.dilation = dilation
        self.pads = conv_padding(kernel_size, dilation, strides,
                                 pad_math=pad_math)
        self.conv = _ConvWeights(cin, filters, kernel_size,
                                 kernel_initializer(init_scheme), generator)

    def forward(self, x):
        xp = F.pad(x.transpose(1, 2), self.pads)
        y = F.conv1d(xp, self.conv.weight.to(x.dtype),
                     self.conv.bias.to(x.dtype), stride=self.strides,
                     dilation=self.dilation)
        return relu20(y).transpose(1, 2).contiguous()


class LinearRelu(nn.Module):
    """Parameters of the ``linear`` cell op, Dense → clip-ReLU(20), under
    the JAX package's ``dense/{kernel,bias}``; the op itself runs in the
    fused cell."""

    def __init__(self, cin, filters, init_scheme='reference', generator=None):
        super().__init__()
        self.dense = Dense(cin, filters, kernel_initializer(init_scheme),
                           generator)


class MeanVarianceNorm(nn.Module):
    """(x - mean) / sqrt(var + eps) with frozen stats (buffers, the JAX
    package's ``stats`` collection); masked frames -> 0."""

    def __init__(self, mean, variance, epsilon=1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer('mean', torch.as_tensor(mean, dtype=torch.float32))
        self.register_buffer('variance',
                             torch.as_tensor(variance, dtype=torch.float32))

    def forward(self, x, mask=None):
        out = ((x - self.mean) / torch.sqrt(self.variance + self.epsilon)
               ).to(x.dtype)
        if mask is not None:
            out = torch.where(mask[..., None], out, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
        return out
