"""Primitive layers of the ASR encoder, PyTorch, channels-last ([B, T, C]).

Counterpart of ``nbasr_tpu/models/layers.py``.  Module and parameter names
follow the JAX package (``kernel``, ``scale``, ``conv_kernel_grouped`` ...)
so :mod:`nbasr_torch.convert` maps checkpoints by name; the one layout
change is the dense block conv, whose weight is PyTorch's ``[cout, cin, K]``.
The cell ops (:class:`GroupedPadConvRelu`, :class:`LinearRelu`) hold the
parameters the fused cell kernel reads (``nbasr_torch/ops/fused_cell.py``)
and run themselves on the unfused ``grouped_impl`` paths: ``'pallas'`` and
``'pallas_split'`` in the grouped conv kernels
(``nbasr_torch/ops/grouped_conv.py``, ``cell_ops.py``), and the JAX
package's XLA lowerings ``'chunked'``, ``'masked_dense'`` and ``'native'``
in stock PyTorch (they reach no Pallas kernel there).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cell_ops import grouped_conv_relu
from ..ops.fused_cell import dropout_bits, inv_keep, keep_threshold, \
    relu20_gate
from ..ops.grouped_conv import grouped_conv1d, to_split
from ..utils import tracing

__all__ = ['FUTURE_CONTEXT', 'norm_eps', 'relu20', 'conv_padding',
           'kernel_initializer', 'hash_dropout', 'chunk_count', 'Dense',
           'LayerNorm', 'SplitLayerNorm', 'PadConvRelu', 'GroupedPadConvRelu',
           'LinearRelu', 'MeanVarianceNorm', 'CELL_CONV_IMPLS']

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


def hash_dropout(y, rate, seed, counter, groups=None, c0=0):
    """Dropout of a cell op's output with the fused cell's stateless hash:
    the bits of :func:`~nbasr_torch.ops.fused_cell.dropout_bits` for draw
    ``counter`` of the cell's CPU ``seed`` (int32 ``[2]``), in the dense
    ``(t, c_full)`` coordinates, so the unfused paths drop what the fused
    cell drops.  ``y`` is ``[B, T, C]``, or the split layout ``[B, c, T,
    G]`` when ``groups`` is given (the mask is permuted to it); ``c0``
    is a channel shard's first channel in the whole cell.  flax's
    ``nn.Dropout`` divides by ``1 - rate``; this multiplies by that
    reciprocal rounded to f32, as the fused cell does: at most 1 ulp apart.
    Plain torch ops, as the JAX package leaves dropout to XLA."""
    if groups is None:
        B, T, C = y.shape
    else:
        B, c, T, G = y.shape
        C = c * G
    keep = dropout_bits(seed, counter, B, T, C, y.device, c0) < \
        keep_threshold(rate)
    if groups is not None:
        keep = to_split(keep, groups)
    return torch.where(keep, y * inv_keep(rate),
                       torch.zeros((), dtype=y.dtype, device=y.device))


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
    names; the result keeps the input's dtype.

    On the CPU the two-pass f32 LayerNorm is written out: torch's CPU
    ``layer_norm`` backward forms the scale gradient as a difference of two
    sums, which leaves a residue on a constant row (normalised to exactly
    0) when the gradient reaching it is large, as in ``synflow`` at full
    width.  On the card ``F.layer_norm`` is one launch and has no such
    residue."""

    def __init__(self, features, epsilon=norm_eps):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        if xf.device.type != 'cpu':
            y = F.layer_norm(xf, (x.shape[-1],), self.scale, self.bias,
                             self.epsilon)
        else:
            mu = xf.mean(dim=-1, keepdim=True)
            var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + self.epsilon) * self.scale \
                + self.bias
        return y.to(x.dtype)


class SplitLayerNorm(LayerNorm):
    """LayerNorm over the channels of a split-layout ``[B, c, T, G]`` tensor
    (axes 1 and 3), statistics in f32; ``scale`` and ``bias`` index the
    dense channels group-major, with :class:`LayerNorm`'s names and shapes,
    so checkpoints cross between the layouts."""

    def forward(self, xs):
        _, c, _, G = xs.shape
        xf = xs.float()
        mu = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.square(xf - mu).mean(dim=(1, 3), keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.epsilon)
        scale = self.scale.view(G, c).T[None, :, None, :]
        bias = self.bias.view(G, c).T[None, :, None, :]
        return (y * scale + bias).to(xs.dtype)


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
    convs (``groups == 1``).  ``[B, T, cin] -> [B, T_out, filters]`` in the
    input's dtype, ``T_out`` the conv's own output length.  ``impl`` is the JAX layer's ``dense_impl``: ``'auto'`` and
    ``'conv'`` run ``F.conv1d``; ``'tap_matmul'`` runs the K taps as shifted
    ``[B*T, cin] x [cin, cout]`` matmuls summed in f32, then rounds to the
    input's dtype and adds the bias there
    (``nbasr_tpu/models/layers.py:325-344``), with the same parameters."""

    def __init__(self, cin, filters, kernel_size, strides=1, dilation=1,
                 pad_math='torch', init_scheme='reference', generator=None,
                 impl='auto'):
        super().__init__()
        if impl not in ('auto', 'conv', 'tap_matmul'):
            raise ValueError(f'unknown block conv impl: {impl!r}')
        self.strides = strides
        self.dilation = dilation
        self.impl = impl
        self.pads = conv_padding(kernel_size, dilation, strides,
                                 pad_math=pad_math)
        self.conv = _ConvWeights(cin, filters, kernel_size,
                                 kernel_initializer(init_scheme), generator)

    @tracing.module_span('block_conv')
    def forward(self, x):
        if self.impl == 'tap_matmul':
            return relu20(self._tap_matmul(x))
        xp = F.pad(x.transpose(1, 2), self.pads)
        y = F.conv1d(xp, self.conv.weight.to(x.dtype),
                     self.conv.bias.to(x.dtype), stride=self.strides,
                     dilation=self.dilation)
        return relu20(y).transpose(1, 2).contiguous()

    def _tap_matmul(self, x):
        """Tap k reads ``x_pad[:, k*d + s*t]``.  The output length is the
        conv's own, ``(T_pad - (K-1)*d - 1) // s + 1``: the JAX version
        takes ``ceil(T / s)`` instead, which a padding with less than
        ``s - 1`` frames of slack (K*d <= s + context) overruns."""
        w = self.conv.weight                          # [cout, cin, K]
        K, d, s = w.shape[2], self.dilation, self.strides
        xp = F.pad(x, (0, 0, *self.pads))
        t_out = (xp.shape[1] - (K - 1) * d - 1) // s + 1
        acc = None
        for k in range(K):
            off = k * d
            xs = xp[:, off:off + (t_out - 1) * s + 1:s]
            # the operands in the input's dtype, their products summed in f32
            part = xs.float() @ w[:, :, k].to(x.dtype).float().T
            acc = part if acc is None else acc + part
        return acc.to(x.dtype) + self.conv.bias.to(x.dtype)


def chunk_count(groups, cin, cout):
    """Super-group count of the ``'chunked'`` lowering: the divisor of
    ``groups`` with the fewest 128-padded matmul tiles over all chunks, ties
    to fewer chunks (``nbasr_tpu/models/layers.py`` ``chunk_count``)."""
    def cost(s):
        gc = groups // s
        tiles = -(-gc * cin // 128) * -(-gc * cout // 128)
        return (s * tiles, s)
    return min((s for s in range(1, groups + 1) if groups % s == 0), key=cost)


def _block_diagonal(kernel, groups, chunks):
    """Compact ``[K, ci, G*co]`` -> ``[K, (G/chunks)*ci, G*co]``: each of
    ``chunks`` super-groups' kernel block-diagonal over its groups (one
    chunk: the whole dense kernel), as the JAX ``'chunked'`` and
    ``'masked_dense'`` lowerings expand it."""
    K, ci, C = kernel.shape
    gc = groups // chunks
    kg = kernel.reshape(K, ci, chunks, gc, C // groups)
    eye = torch.eye(gc, dtype=kernel.dtype, device=kernel.device)
    return torch.einsum('kcsgo,gh->khcsgo', kg, eye).reshape(K, gc * ci, C)


#: The cell conv lowerings of the unfused paths (``grouped_impl``).
CELL_CONV_IMPLS = ('pallas', 'pallas_split', 'chunked', 'masked_dense',
                   'native')


class GroupedPadConvRelu(nn.Module):
    """A cell's conv op, stride 1, with the JAX layer's parameters:
    ``conv_kernel_grouped [K, ci, filters]`` and ``conv_bias [filters]``,
    which the fused cell reads; where the JAX package runs ``nn.Conv``
    (``'native'``, and every unfused path at ``groups=1``) ``conv.weight
    [filters, ci, K]`` and ``conv.bias``, which :mod:`nbasr_torch.convert`
    maps to ``conv/{kernel,bias}``.  On the unfused paths it runs itself:

    - ``'pallas'``: ``[B, T, C]`` → pad → grouped conv (the kernel rounds
      its f32 sum to the activation dtype) → + bias in the activation
      dtype → :func:`relu20` → dropout
      (``nbasr_tpu/models/layers.py:291-303``);
    - ``'pallas_split'``: split layout ``[B, ci, T, G]`` → pad → grouped
      conv with the bias and clip-ReLU in the kernel's f32 accumulator, one
      rounding, a gate that passes nothing at exactly 0 or 20 → dropout
      (``nbasr_tpu/models/layers.py:243-262``);
    - the JAX package's XLA lowerings, in stock PyTorch
      (``nbasr_tpu/models/layers.py:264-324``): ``'chunked'``, one conv of
      :func:`chunk_count` groups whose kernels are block-diagonal over their
      groups; ``'masked_dense'``, one dense conv of the block-diagonal
      kernel; ``'native'``, ``F.conv1d(groups=G)``; each then + bias →
      :func:`relu20` → dropout.

    Dropout is the fused cell's hash (:func:`hash_dropout`) on every path.
    """

    def __init__(self, cin, filters, kernel_size, dilation=1, groups=1,
                 dropout_rate=0.0, impl='pallas', pad_math='torch',
                 init_scheme='reference', generator=None):
        super().__init__()
        if impl not in CELL_CONV_IMPLS + ('fused',):
            raise ValueError(f'unknown cell conv impl: {impl!r}')
        self.groups = groups
        #: the dropout hash's first channel (a tensor-parallel shard's)
        self.channel_offset = 0
        self.dilation = dilation
        self.dropout_rate = dropout_rate
        if impl != 'fused' and groups == 1:
            impl = 'native'         # the JAX layer's nn.Conv at groups=1
        self.impl = impl
        self.split = impl == 'pallas_split'
        self.pads = conv_padding(kernel_size, dilation, 1, pad_math=pad_math)
        init = kernel_initializer(init_scheme)
        if impl == 'native':
            self.conv = _ConvWeights(cin, filters, kernel_size, init,
                                     generator)
        else:
            self.conv_kernel_grouped = nn.Parameter(
                init((kernel_size, cin, filters), generator))
            self.conv_bias = nn.Parameter(torch.zeros(filters))

    def forward(self, x, seed=None, counter=0):
        """``seed`` (the cell's, on the CPU) turns dropout on, with the
        cell's ``counter``-th draw."""
        if self.impl == 'native':
            xp = F.pad(x.transpose(1, 2), self.pads)
            y = F.conv1d(xp, self.conv.weight.to(x.dtype),
                         self.conv.bias.to(x.dtype), dilation=self.dilation,
                         groups=self.groups)
            y = relu20(y.transpose(1, 2))
        elif self.impl in ('chunked', 'masked_dense'):
            w = self.conv_kernel_grouped
            G, ci = self.groups, w.shape[1]
            chunks = (chunk_count(G, ci, w.shape[2] // G)
                      if self.impl == 'chunked' else 1)
            wide = _block_diagonal(w, G, chunks).to(x.dtype)
            xp = F.pad(x.transpose(1, 2), self.pads)
            y = F.conv1d(xp, wide.permute(2, 1, 0), dilation=self.dilation,
                         groups=chunks)
            y = relu20(y.transpose(1, 2) + self.conv_bias.to(x.dtype))
        else:
            w = self.conv_kernel_grouped.to(x.dtype)
            b = self.conv_bias.to(x.dtype)
            if self.split:
                y = grouped_conv_relu(x, w, b, self.groups, *self.pads,
                                      self.dilation)
            else:
                y = relu20(grouped_conv1d(x, w, self.groups, *self.pads,
                                          self.dilation) + b)
        if seed is not None:
            y = hash_dropout(y, self.dropout_rate, seed, counter,
                             self.groups if self.split else None,
                             self.channel_offset)
        return y


class LinearRelu(nn.Module):
    """The ``linear`` cell op, Dense → clip-ReLU(20) → dropout, under the
    JAX package's ``dense/{kernel,bias}`` (which the fused cell reads);
    ``[B, T, C]`` in the activation dtype."""

    def __init__(self, cin, filters, init_scheme='reference', generator=None,
                 dropout_rate=0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dense = Dense(cin, filters, kernel_initializer(init_scheme),
                           generator)

    def forward(self, x, seed=None, counter=0):
        y = relu20(self.dense(x))
        if seed is not None:
            y = hash_dropout(y, self.dropout_rate, seed, counter)
        return y


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
