"""NAS-Bench-ASR's encoder (Mehrotra et al., ICLR 2021; SamsungLabs/nb-asr):
everything the harness knows of this architecture.  A configuration names
it by ``"model": "nas_bench_asr"`` and gives ``arch_vec``, the block sizes
(``block_kernels``, ``block_strides``, ``block_filters``,
``cells_per_block``), ``cell_groups``, ``rnn_units``, ``num_classes`` and
``dropout``.

The program's model comes from the port's own factory, ``get_model``
(:func:`build`).  The rest is the plain PyTorch reference, written from the
published description; it imports nothing of the program under test.
The model (``model/torch/model.py:72-103`` of the reference repository):
log-mel features, masked to the true frame count, normalised by frozen
TIMIT mean and variance; four blocks of a dense conv (kernel 8, strides
1/1/2/2, filters 600/800/1000/1200, clip-ReLU at 20), a LayerNorm and
3/4/5/6 search cells; an LSTM of 500 units and a dense head of 49 outputs.
A cell's node ``i`` applies its op (a linear map, or a grouped conv of 5
or 7 taps, dilation 1 or 2, in 100 groups) to node ``i - 1``'s output,
clips at [0, 20], drops, and adds every earlier output whose branch bit is
set; a LayerNorm ends the cell.  Convs pad for at most 4 frames of
look-ahead.  In training, dropout 0.2 in every cell op (a stateless hash
of the cell's seed, the row, the node, the frame and the channel) and
before the LSTM (one mask per row and channel, shared over time); the
recipe's L2 takes the conv kernels.

``rnd`` is applied wherever the recipe states a rounding to its compute
dtype (weights as the ops read them, each layer's output; the gradient
reaching each of those points in the backward); the reference itself
passes the identity.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..common import DTYPES
from ..reference.model import identity, load_stats

__all__ = ['build', 'param_table', 'forward', 'regularised',
           'algorithmic_flops', 'output_stride', 'halo', 'OPS', 'CONVS',
           'arch_nodes', 'conv_padding', 'dropout_bits', 'draw_cell_seed']

OPS = ['linear', 'conv5', 'conv5d2', 'conv7', 'conv7d2', 'zero']
CONVS = {'conv5': (5, 1), 'conv5d2': (5, 2), 'conv7': (7, 1),
         'conv7d2': (7, 2)}
CONTEXT = 4          # frames of look-ahead a conv may take
NORM_EPS = 1e-3      # LayerNorm and the frozen mean/variance norm
CLIP = 20.0
NUM_FEATURES = 80
_U32 = 0xFFFFFFFF


def build(cfg, mix, device):
    """The program's model of ``cfg`` through its own factory, with the
    mix's compute dtype, dropout and cell path; its weights are its own
    initialisation, which :func:`perfbench.weights.install` replaces."""
    from nbasr_torch.models.asr import get_model
    return get_model(
        cfg['arch_vec'], use_rnn=True, dropout_rate=mix.get('dropout', 0.0),
        data_norm=load_stats(), num_classes=cfg['num_classes'],
        compute_dtype=DTYPES[mix['compute_dtype']],
        grouped_impl=mix.get('grouped_impl', 'auto'), device=device,
        generator=torch.Generator().manual_seed(0),
        block_kernels=tuple(cfg['block_kernels']),
        block_strides=tuple(cfg['block_strides']),
        block_filters=tuple(cfg['block_filters']),
        cells_per_block=tuple(cfg['cells_per_block']),
        cell_groups=cfg['cell_groups'], rnn_units=cfg['rnn_units'])


def arch_nodes(arch_vec):
    """``[[op, bit...], ...]`` -> ``[(op_name, branches), ...]``: node ``i``
    adds output ``j`` (0 the cell input) where bit ``j`` is 1."""
    return [(OPS[v[0]], tuple(j for j, b in enumerate(v[1:]) if b == 1))
            for v in arch_vec]


def conv_padding(K, d, s):
    """(left, right) time padding: at most ``CONTEXT // s`` frames on the
    right, the rest of the receptive field on the left."""
    span = K * d - s
    if CONTEXT // s >= span:
        return 0, span
    rpad = CONTEXT // s
    return (K - 1) * d - rpad, rpad


def param_table(cfg):
    """``[(name, shape, std, offset)]`` of every parameter in model order:
    a tensor is ``offset + std * N(0, 1)``; ``offset`` is a number or
    ``'forget'`` (1 on the LSTM's forget-gate quarter, 0 elsewhere).
    Kernels take ``std = 1 / sqrt(fan_in)``; biases and LayerNorm
    parameters small draws around their usual values, so that no value
    sits on a clip boundary by construction."""
    out = []
    nodes = arch_nodes(cfg['arch_vec'])
    cin = NUM_FEATURES
    G = cfg['cell_groups']
    for i, (K, s, C, n) in enumerate(zip(
            cfg['block_kernels'], cfg['block_strides'], cfg['block_filters'],
            cfg['cells_per_block'])):
        out += [(f'block{i}_conv.conv.weight', (C, cin, K),
                 1 / math.sqrt(K * cin), 0.0),
                (f'block{i}_conv.conv.bias', (C,), 0.05, 0.0),
                (f'block{i}_norm.scale', (C,), 0.1, 1.0),
                (f'block{i}_norm.bias', (C,), 0.1, 0.0)]
        ci = C // G
        for j in range(n):
            pre = f'block{i}_cell{j}.'
            for k, (op, _) in enumerate(nodes):
                if op == 'linear':
                    out += [(f'{pre}node{k}_linear.dense.kernel', (C, C),
                             1 / math.sqrt(C), 0.0),
                            (f'{pre}node{k}_linear.dense.bias', (C,), 0.05,
                             0.0)]
                elif op in CONVS:
                    Kc = CONVS[op][0]
                    out += [(f'{pre}node{k}_{op}.conv_kernel_grouped',
                             (Kc, ci, C), 1 / math.sqrt(Kc * ci), 0.0),
                            (f'{pre}node{k}_{op}.conv_bias', (C,), 0.05, 0.0)]
            out += [(f'{pre}norm.scale', (C,), 0.1, 1.0),
                    (f'{pre}norm.bias', (C,), 0.1, 0.0)]
        cin = C
    H = cfg['rnn_units']
    out += [('lstm.kernel', (cin, 4 * H), 1 / math.sqrt(cin), 0.0),
            ('lstm.recurrent', (H, 4 * H), 1 / math.sqrt(H), 0.0),
            ('lstm.bias', (4 * H,), 0.05, 'forget'),
            ('head.kernel', (H, cfg['num_classes'] + 1), 1 / math.sqrt(H),
             0.0),
            ('head.bias', (cfg['num_classes'] + 1,), 0.05, 0.0)]
    return out



class _Relu20(torch.autograd.Function):
    """clip(x, 0, 20); the gradient passes whole inside (0, 20), half at
    exactly 0 or 20, not at all outside."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(0.0, CLIP)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = ((x > 0) & (x < CLIP)).to(g.dtype)
        edge = ((x == 0) | (x == CLIP)).to(g.dtype)
        return g * (inside + 0.5 * edge)


def relu20(x):
    return _Relu20.apply(x)


def dropout_bits(seed_words, counter, B, T, C, device):
    """``[B, T, C]`` uint32 hash bits (as int64) of the cell seed's two
    words, the draw counter (1, 2, ... over the cell's conv and linear
    nodes), the frame ``t``, the channel ``c`` and the row ``b``."""
    s0, s1 = (int(v) & _U32 for v in seed_words)

    def ramp(n, dim):
        shape = [1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    const = ((s0 * 0xC2B2AE35) & _U32) ^ ((s1 + 0x27D4EB2F) & _U32) \
        ^ ((counter * 0x5851F42D) & _U32)
    x = (((ramp(T, 1) * 0x9E3779B1) & _U32)
         ^ ((ramp(C, 2) * 0x85EBCA6B) & _U32)
         ^ ((ramp(B, 0) * 0x165667B1) & _U32) ^ const)
    for shift in (15, 13, 16):
        x = x ^ (x >> shift)
        x = (x * 0x2545F491) & _U32
    return x ^ (x >> 16)


def draw_cell_seed(gen):
    """A cell's dropout seed: two int32 words in ``[0, 2**31 - 1)``."""
    return torch.randint(0, 2 ** 31 - 1, (2,), generator=gen,
                         dtype=torch.int32).tolist()


def _layer_norm(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + NORM_EPS) * scale + bias


def _cell(p, pre, nodes, x, G, rate, seed, rnd):
    B, T, C = x.shape
    outs = [x]
    counter = 0
    thr = min(int((1.0 - rate) * (1 << 32)), _U32)
    keep_scale = float(np.float32(1.0 / (1.0 - rate))) if rate else 1.0
    for k, (op, branches) in enumerate(nodes):
        if op == 'zero':
            total = torch.zeros_like(x)
        else:
            src = outs[-1]
            if op == 'linear':
                acc = src @ rnd(p[f'{pre}node{k}_linear.dense.kernel']) \
                    + p[f'{pre}node{k}_linear.dense.bias']
            else:
                K, d = CONVS[op]
                w = rnd(p[f'{pre}node{k}_{op}.conv_kernel_grouped'])
                lp, rp = conv_padding(K, d, 1)
                acc = F.conv1d(F.pad(src.transpose(1, 2), (lp, rp)),
                               w.permute(2, 1, 0), dilation=d,
                               groups=G).transpose(1, 2) \
                    + p[f'{pre}node{k}_{op}.conv_bias']
            total = relu20(acc)
            if seed is not None:
                counter += 1
                keep = dropout_bits(seed, counter, B, T, C, x.device) < thr
                total = torch.where(keep, total * keep_scale,
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device))
        for j in branches:
            total = total + outs[j]
        outs.append(rnd(total))
    return rnd(_layer_norm(outs[-1], p[f'{pre}norm.scale'],
                           p[f'{pre}norm.bias']))


def _lstm(p, x, rnd):
    B, T, _ = x.shape
    H = p['lstm.recurrent'].shape[0]
    xw = rnd(x @ rnd(p['lstm.kernel']) + p['lstm.bias'])
    rec = rnd(p['lstm.recurrent'])
    c = h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(T):
        gates = rnd(xw[:, t] + rnd(h @ rec))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = rnd(torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g))
        h = rnd(torch.sigmoid(o) * torch.tanh(c))
        hs.append(h)
    return torch.stack(hs, dim=1)


def forward(p, cfg, feats, feature_size, stats, gen=None, rnd=identity,
            lstm_rate=0.0):
    """``[B, T, 80]`` log-mel features -> ``[B, T_out, 49]`` logits.
    ``gen`` (a CPU ``torch.Generator``) turns training-mode dropout on: each
    cell draws its seed from it in order (the cells drop ``cfg['dropout']``),
    then the pre-LSTM mask (``lstm_rate``)."""
    rate = cfg['dropout'] if gen is not None else 0.0
    B, T, _ = feats.shape
    dt = feats.dtype
    mask = (torch.arange(T, device=feats.device)[None, :]
            < feature_size[:, None])[..., None]
    zero = torch.zeros((), dtype=dt, device=feats.device)
    x = torch.where(mask, rnd(feats), zero)
    mean, var = (torch.as_tensor(s, dtype=dt, device=feats.device)
                 for s in stats)
    x = torch.where(mask, rnd((x - mean) / torch.sqrt(var + NORM_EPS)), zero)
    nodes = arch_nodes(cfg['arch_vec'])
    G = cfg['cell_groups']
    for i, (K, s, n) in enumerate(zip(cfg['block_kernels'],
                                      cfg['block_strides'],
                                      cfg['cells_per_block'])):
        lp, rp = conv_padding(K, 1, s)
        y = F.conv1d(F.pad(x.transpose(1, 2), (lp, rp)),
                     rnd(p[f'block{i}_conv.conv.weight']),
                     rnd(p[f'block{i}_conv.conv.bias']), stride=s)
        x = rnd(relu20(rnd(y))).transpose(1, 2)
        x = rnd(_layer_norm(x, p[f'block{i}_norm.scale'],
                            p[f'block{i}_norm.bias']))
        for j in range(n):
            seed = draw_cell_seed(gen) if rate else None
            x = _cell(p, f'block{i}_cell{j}.', nodes, x, G, rate, seed, rnd)
    if gen is not None and lstm_rate:
        keep = 1.0 - lstm_rate
        m = (torch.rand((B, 1, x.shape[2]), generator=gen) < keep).to(
            x.device)
        x = rnd(torch.where(m, x / keep, zero))
    x = _lstm(p, x, rnd)
    return x @ p['head.kernel'] + p['head.bias']


def regularised(name):
    """Whether the recipe's L2 takes the leaf ``name``: the block convs'
    and the cell convs' kernels."""
    return (name.endswith('.conv.weight')
            or name.endswith('conv_kernel_grouped'))


def algorithmic_flops(cfg, batch, frames, train=True):
    """FLOPs of one step of ``batch`` rows of ``frames`` input frames: a
    frozen copy of the port's count (``nbasr_torch/models/asr.py``
    ``algorithmic_flops``): 2 per multiply-add of the block convs, the cell
    ops at their true grouped cost, the LSTM and the head; elementwise work
    left out; a training step counts 3 forwards."""
    B, t, cin = batch, frames, NUM_FEATURES
    nodes = arch_nodes(cfg['arch_vec'])
    fwd = 0.0
    for k, s, c, cells in zip(cfg['block_kernels'], cfg['block_strides'],
                              cfg['block_filters'], cfg['cells_per_block']):
        t = -(-t // s)
        fwd += 2.0 * B * t * k * cin * c
        ci = c // cfg['cell_groups']
        for op, _ in nodes:
            if op == 'linear':
                fwd += cells * 2.0 * B * t * c * c
            elif op in CONVS:
                fwd += cells * 2.0 * B * t * cfg['cell_groups'] * ci * ci \
                    * CONVS[op][0]
        cin = c
    h = cfg['rnn_units']
    fwd += 2.0 * B * t * 4 * h * (cin + h)
    fwd += 2.0 * B * t * h * (cfg['num_classes'] + 1)
    return fwd * (3.0 if train else 1.0)


def output_stride(cfg):
    """Input frames a logit frame: the block convs' strides multiplied."""
    return math.prod(cfg['block_strides'])


def halo(cfg):
    """(left, right) input frames of context the whole encoder takes: each
    cell's node pads added up, scaled through each block conv's stride,
    rounded up to the total stride."""
    need_l = need_r = 0
    nodes = arch_nodes(cfg['arch_vec'])
    ts = math.prod(cfg['block_strides'])
    for K, s, n in reversed(list(zip(cfg['block_kernels'],
                                     cfg['block_strides'],
                                     cfg['cells_per_block']))):
        pads = [conv_padding(*CONVS[op], 1) for op, _ in nodes if op in CONVS]
        need_l += n * sum(lp for lp, _ in pads)
        need_r += n * sum(rp for _, rp in pads)
        lp, rp = conv_padding(K, 1, s)
        need_l, need_r = need_l * s + lp, need_r * s + rp
    return -(-need_l // ts) * ts, -(-need_r // ts) * ts
