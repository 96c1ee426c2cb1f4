"""Conformer (L) with a CTC head: the port's second encoder family.

Gulati et al., "Conformer: Convolution-augmented Transformer for Speech
Recognition", Interspeech 2020 (arXiv:2005.08100), Table 1's Conformer
(L): 17 blocks at d = 512, 8 heads, feed-forward 2048, convolution kernel
32; here with a linear CTC head of ``num_classes + 1`` outputs in place of
the paper's RNN-T decoder (114,883,121 parameters at 49 outputs).

  [B, T, 80] log-mel -> mask -> frozen mean/var norm (as ASRModel)
  -> subsampling: Conv2d(1->d, 3x3, stride 2), ReLU, Conv2d(d->d, 3x3,
     stride 2), ReLU (no padding: T -> (((T-3)//2+1)-3)//2+1, 80 -> 19),
     flatten d*19 -> Linear -> d, dropout
  -> 17 x block:  x += 1/2 FFN(x);  x += MHSA(x);  x += Conv(x);
                  x += 1/2 FFN(x);  x = LayerNorm(x)
  -> Linear d -> num_classes + 1 (f32 logits)

FFN(x) = Drop(W2 Drop(Swish(W1 LN(x) + b1)) + b2), W1: d -> 2048.
MHSA(x) = Drop(W_o Attn(LN(x))): Transformer-XL's relative-position
attention (:func:`nbasr_torch.ops.relpos_attention.relpos_attention`, the
fused kernel on the card), ``r_m = W_r R_m`` for the sinusoidal encoding R
of the offset ``m in [-(T'-1), T'-1]``, learned ``pos_bias_u`` and
``pos_bias_v`` ``[H, d / H]``, keys at or past the row's length masked.
The lengths are the Trainer's own ``logits_length(feature_size, T, T')``,
so the mask and the CTC lengths agree.
Conv(x) = Drop(PW2(Swish(BN(DW(GLU(PW1(LN(x)))))))): PW1 d -> 2d, GLU,
frames past the row's length zeroed, depthwise conv of kernel 32 padded
15 left and 16 right, BatchNorm whose batch statistics leave those
frames out (running statistics for eval), Swish, PW2 d -> d.

Dropout (``dropout_rate``, 0.1) at each residual unit's output, inside
the FFN after the Swish, and after the subsampling; none on the attention
probabilities.  Its masks are the port's stateless hash
(:func:`nbasr_torch.ops.hash_dropout.hash_dropout`): in training mode a
call draws a seed for the subsampling and one for each block from
``generator`` (two int32 each, as ``SearchCell.draw_seed`` draws), and a
site's mask is the hash of that seed, the site's counter (subsampling 1;
a block's FFN1 inner 1 and outer 2, MHSA 3, Conv 4, FFN2 inner 5 and
outer 6), the row, the frame and the channel.

Precision (``compute_dtype``): f32 master weights; the matrix products,
convolutions and attention in the compute dtype with f32 sums; the
residual stream, LayerNorm, the BatchNorm statistics, the softmax
statistics and the logits in f32.

Parameter names: every convolution kernel ends in ``.conv.weight`` (the
subsampling's two, and each block's pointwise and depthwise kernels), the
leaves the recipe's conv L2 (``training.loss.conv_l2``) takes; nothing
else does.

Spans (``nbasr_torch.utils.tracing``): ``conformer.subsample``,
``conformer.ffn``, ``conformer.mhsa``, ``conformer.conv_module``, each
with its ``.backward``; counter ``mhsa.pairs`` (H * sum of the rows'
squared lengths a call: with tracing on, the lengths are read to the host
once a forward).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.hash_dropout import hash_dropout
from ..ops.relpos_attention import relpos_attention
from ..utils import tracing
from .asr import logits_length, resolve_device
from .layers import MeanVarianceNorm, norm_eps

__all__ = ['ConformerCTC', 'get_conformer', 'subsampled_length',
           'relative_positions', 'NUM_FEATURES']

NUM_FEATURES = 80
LN_EPS = 1e-5
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def subsampled_length(n):
    """Frames (or mel bins) left of ``n`` by the two unpadded 3x3 stride-2
    convolutions."""
    return ((n - 3) // 2 + 1 - 3) // 2 + 1


def relative_positions(T, d, device):
    """``[2T - 1, d]`` f32 sinusoidal encoding of the offsets ``-(T - 1)
    .. T - 1`` (row ``m + T - 1``): sin on the even channels, cos on the
    odd, at frequencies ``10000^(-2k / d)``."""
    m = torch.arange(-(T - 1), T, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    out = torch.empty((2 * T - 1, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(m * div)
    out[:, 1::2] = torch.cos(m * div)
    return out


def _linear(x, layer, dt):
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def _init(module, generator):
    """Weights N(0, 1 / fan_in) from ``generator``, biases 0, norms 1 and
    0, the position biases N(0, 0.02^2)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith('bias') and 'pos_bias' not in name:
                p.zero_()
            elif name.endswith('norm.weight'):
                p.fill_(1.0)
            elif 'pos_bias' in name:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(fan_in))


class _Kernel(nn.Module):
    """Holds a convolution's kernel and bias as ``conv.weight`` and
    ``conv.bias``, the names the recipe's conv L2 selects."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv


class Subsampling(nn.Module):
    def __init__(self, d, dropout_rate):
        super().__init__()
        self.conv1 = _Kernel(nn.Conv2d(1, d, 3, stride=2))
        self.conv2 = _Kernel(nn.Conv2d(d, d, 3, stride=2))
        self.out = nn.Linear(d * subsampled_length(NUM_FEATURES), d)
        self.dropout_rate = dropout_rate

    @tracing.module_span('conformer.subsample')
    def forward(self, x, seed=None):
        """``[B, T, 80]`` (compute dtype) -> ``[B, T', d]`` f32."""
        dt = x.dtype
        c1, c2 = self.conv1.conv, self.conv2.conv
        y = F.relu(F.conv2d(x[:, None], c1.weight.to(dt), c1.bias.to(dt),
                            stride=2), inplace=True)
        y = F.relu(F.conv2d(y, c2.weight.to(dt), c2.bias.to(dt), stride=2),
                   inplace=True)
        B, C, T, M = y.shape
        y = _linear(y.permute(0, 2, 1, 3).reshape(B, T, C * M), self.out, dt)
        if seed is not None:
            y = hash_dropout(y, seed, 1, self.dropout_rate)
        return y.float()


class FeedForward(nn.Module):
    def __init__(self, d, ffn_dim, dropout_rate, compute_dtype):
        super().__init__()
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.w1 = nn.Linear(d, ffn_dim)
        self.w2 = nn.Linear(ffn_dim, d)
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype

    @tracing.module_span('conformer.ffn')
    def forward(self, x, seed=None, counter=1):
        dt = self.compute_dtype
        h = F.silu(_linear(self.norm(x), self.w1, dt))
        if seed is not None:
            h = hash_dropout(h, seed, counter, self.dropout_rate)
        y = _linear(h, self.w2, dt)
        if seed is not None:
            y = hash_dropout(y, seed, counter + 1, self.dropout_rate)
        return y


class RelposAttentionCore(nn.Module):
    """The attention alone, between the projections: a module of its own
    so that a caller can find its calls (no parameters)."""

    def forward(self, q, k, v, r, pos_bias_u, pos_bias_v, lengths):
        return relpos_attention(q, k, v, r, pos_bias_u, pos_bias_v, lengths)


class RelPosSelfAttention(nn.Module):
    def __init__(self, d, num_heads, dropout_rate, compute_dtype):
        super().__init__()
        if d % num_heads:
            raise ValueError(f'd={d} is not a multiple of {num_heads} heads')
        self.heads = num_heads
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.pos = nn.Linear(d, d, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, d // num_heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, d // num_heads))
        self.out = nn.Linear(d, d)
        self.attention = RelposAttentionCore()
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype

    @tracing.module_span('conformer.mhsa')
    def forward(self, x, lengths, positions, seed=None, pairs=None):
        dt = self.compute_dtype
        B, T, d = x.shape
        H = self.heads
        h = self.norm(x)
        q, k, v = (_linear(h, lin, dt).view(B, T, H, d // H)
                   for lin in (self.q, self.k, self.v))
        r = F.linear(positions.to(dt), self.pos.weight.to(dt)).view(
            2 * T - 1, H, d // H)
        o = self.attention(q, k, v, r, self.pos_bias_u, self.pos_bias_v,
                           lengths)
        if pairs is not None:
            tracing.count('mhsa.pairs', pairs)
        y = _linear(o.reshape(B, T, d), self.out, dt)
        if seed is not None:
            y = hash_dropout(y, seed, 3, self.dropout_rate)
        return y


class MaskedBatchNorm(nn.Module):
    """BatchNorm over ``[B, C, T]`` whose training statistics (f32, biased
    variance) count only the frames ``frames`` marks; running statistics
    (momentum 0.1, unbiased variance) for eval."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, y, frames):
        yf = y.float()
        if self.training:
            m = frames[:, None, :].to(torch.float32)
            n = m.sum()
            mean = (yf * m).sum(dim=(0, 2)) / n
            var = (torch.square(yf - mean[:, None]) * m).sum(dim=(0, 2)) / n
            with torch.no_grad():
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * mean)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * var * n / (n - 1).clamp(min=1.0))
        else:
            mean, var = self.running_mean, self.running_var
        out = (yf - mean[:, None]) * (torch.rsqrt(var + BN_EPS)
                                      * self.weight)[:, None] \
            + self.bias[:, None]
        return out.to(y.dtype)


class ConvModule(nn.Module):
    def __init__(self, d, kernel, dropout_rate, compute_dtype):
        super().__init__()
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.pointwise1 = _Kernel(nn.Conv1d(d, 2 * d, 1))
        self.depthwise = _Kernel(nn.Conv1d(d, d, kernel, groups=d))
        self.batch_norm = MaskedBatchNorm(d)
        self.pointwise2 = _Kernel(nn.Conv1d(d, d, 1))
        self.pad = ((kernel - 1) // 2, kernel // 2)
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype

    @tracing.module_span('conformer.conv_module')
    def forward(self, x, frames, seed=None):
        dt = self.compute_dtype
        pw1, dw, pw2 = (m.conv for m in (self.pointwise1, self.depthwise,
                                          self.pointwise2))
        h = F.linear(self.norm(x).to(dt), pw1.weight[..., 0].to(dt),
                     pw1.bias.to(dt))
        h = F.glu(h, dim=-1)
        h = torch.where(frames[..., None], h,
                        torch.zeros((), dtype=dt, device=h.device))
        h = F.conv1d(F.pad(h.transpose(1, 2), self.pad), dw.weight.to(dt),
                     dw.bias.to(dt), groups=h.shape[-1])
        h = F.silu(self.batch_norm(h, frames)).transpose(1, 2)
        y = F.linear(h, pw2.weight[..., 0].to(dt), pw2.bias.to(dt))
        if seed is not None:
            y = hash_dropout(y, seed, 4, self.dropout_rate)
        return y


class ConformerBlock(nn.Module):
    def __init__(self, d, num_heads, ffn_dim, kernel, dropout_rate,
                 compute_dtype):
        super().__init__()
        self.ffn1 = FeedForward(d, ffn_dim, dropout_rate, compute_dtype)
        self.mhsa = RelPosSelfAttention(d, num_heads, dropout_rate,
                                        compute_dtype)
        self.conv_module = ConvModule(d, kernel, dropout_rate, compute_dtype)
        self.ffn2 = FeedForward(d, ffn_dim, dropout_rate, compute_dtype)
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x, lengths, frames, positions, seed=None, pairs=None):
        """``x`` ``[B, T', d]`` f32 -> the same."""
        x = torch.add(x, self.ffn1(x, seed, 1), alpha=0.5)
        x = x + self.mhsa(x, lengths, positions, seed, pairs)
        x = x + self.conv_module(x, frames, seed)
        x = torch.add(x, self.ffn2(x, seed, 5), alpha=0.5)
        return self.norm(x)


class ConformerCTC(nn.Module):
    """The Conformer encoder with a CTC head; the model contract the
    Trainer uses: ``model(features, feature_size, generator=None)`` ->
    ``[B, T', num_classes + 1]`` f32 logits.  Built on the CPU from
    ``generator`` (seed 0 when none is given), in eval mode."""

    def __init__(self, num_classes=48, num_blocks=17, d_model=512,
                 num_heads=8, ffn_dim=2048, conv_kernel=32, dropout_rate=0.1,
                 data_mean=None, data_variance=None,
                 compute_dtype=torch.float32, generator=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.num_classes = num_classes
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        self.data_norm = (None if data_mean is None else MeanVarianceNorm(
            data_mean, data_variance, epsilon=norm_eps))
        self.subsample = Subsampling(d_model, dropout_rate)
        self.blocks = nn.ModuleList(
            ConformerBlock(d_model, num_heads, ffn_dim, conv_kernel,
                           dropout_rate, compute_dtype)
            for _ in range(num_blocks))
        self.head = nn.Linear(d_model, num_classes + 1)
        _init(self, generator)
        self._positions = {}
        self.eval()

    def positions(self, T, device):
        """The ``[2T - 1, d]`` encoding, computed once a length and
        device."""
        key = (T, str(device))
        if key not in self._positions:
            self._positions[key] = relative_positions(T, self.d_model, device)
        return self._positions[key]

    def _seeds(self, generator):
        if not (self.training and self.dropout_rate):
            return [None] * (1 + len(self.blocks))
        if generator is None:
            raise ValueError('dropout in training mode draws from a '
                             'torch.Generator: pass generator=, or call '
                             '.eval()')
        return [torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                              dtype=torch.int32).tolist()
                for _ in range(1 + len(self.blocks))]

    def forward(self, features, feature_size, generator=None):
        x = features.to(self.compute_dtype)
        T = x.shape[1]
        mask = torch.arange(T, device=x.device)[None, :] < feature_size[:, None]
        x = torch.where(mask[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
        if self.data_norm is not None:
            x = self.data_norm(x, mask=mask)
        seeds = self._seeds(generator)
        x = self.subsample(x, seeds[0])
        Tp = x.shape[1]
        lengths = logits_length(feature_size, T, Tp).clamp(1, Tp)
        frames = torch.arange(Tp, device=x.device)[None, :] < lengths[:, None]
        positions = self.positions(Tp, x.device)
        pairs = (self.num_heads * int(torch.square(lengths.long()).sum())
                 if tracing.is_enabled() else None)
        for block, seed in zip(self.blocks, seeds[1:]):
            x = block(x, lengths, frames, positions, seed, pairs)
        return F.linear(x.float(), self.head.weight, self.head.bias)


def get_conformer(num_classes=48, num_blocks=17, d_model=512, num_heads=8,
                  ffn_dim=2048, conv_kernel=32, dropout_rate=0.1,
                  data_norm=None, compute_dtype=torch.float32, device='cuda',
                  generator=None):
    """Conformer-CTC factory on ``device`` (Conformer (L)'s sizes by
    default); ``data_norm`` is the frozen ``(mean, variance)`` of the
    features, or ``None``."""
    device = resolve_device(device)
    mean, var = (None, None) if data_norm is None else data_norm
    model = ConformerCTC(num_classes, num_blocks, d_model, num_heads, ffn_dim,
                         conv_kernel, dropout_rate, mean, var, compute_dtype,
                         generator)
    return model.to(device)
