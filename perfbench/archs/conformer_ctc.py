"""Conformer (L) with a CTC head (Gulati et al., Interspeech 2020,
arXiv:2005.08100, Table 1): everything the harness knows of this
architecture.  A configuration names it by ``"model": "conformer_ctc"``
and gives ``num_blocks``, ``d_model``, ``num_heads``, ``ffn_dim``,
``conv_kernel``, ``num_classes`` and ``dropout``.

The program's model comes from the port's own factory, ``get_conformer``
(:func:`build`), which also hooks its attention calls for the two
rooflines (:func:`attention_roofline`).  The rest is the plain PyTorch
reference, written from the published description and the departures the
configuration lists under ``assumed``; it imports nothing of the program
under test.  The encoder: log-mel features, masked to the true frame
count, normalised by frozen TIMIT mean and variance; a 4x subsampling
(two unpadded 3x3 stride-2 Conv2d with ReLU, d channels; a Linear from
d x 19 to d); 17 blocks of x += FFN/2, x += MHSA, x += Conv, x += FFN/2,
LayerNorm (FFN: LN, W1 to 2048, Swish, W2; MHSA: LN, Transformer-XL
relative-position attention with biases u and v over sinusoidal offsets,
keys past the row's length masked; Conv: LN, pointwise to 2d, GLU, frames
past the length zeroed, depthwise kernel 32 padded 15 / 16, BatchNorm of
the valid frames' batch statistics, Swish, pointwise); a Linear head.  In
training, dropout at every residual unit, inside the FFN and after the
subsampling, by the stateless hash of a seed a block (drawn in order from
the generator, the subsampling's first), the site's counter, the row, the
frame and the channel.  Each block (and the subsampling) is recomputed in
the backward (``torch.utils.checkpoint``), so that the reference fits
the card at the cell's shapes; the materialised ``[B, H, T, 2T - 1]``
scores live inside one block at a time.

``rnd`` is applied wherever the program rounds to its compute dtype (the
matrix products' and convolutions' operands and outputs, LayerNorm and
BatchNorm outputs, the activations, the dropout outputs, the attention's
operands and output; not the f32 residual stream, statistics or head);
the reference itself passes the identity.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common import DTYPES
from ..flops import least_seconds
from ..reference.model import identity, load_stats
from .nas_bench_asr import dropout_bits

__all__ = ['build', 'param_table', 'forward', 'regularised',
           'algorithmic_flops', 'output_stride', 'halo', 'attention_counts',
           'attention_roofline', 'CALLS', 'ATTENTION_RANGE', 'BACKWARD_NODE']

NUM_FEATURES = 80
NORM_EPS = 1e-3      # the frozen mean/variance norm
LN_EPS = 1e-5
BN_EPS = 1e-5
_U32 = 0xFFFFFFFF

#: The host range the build's hooks open around each attention call while
#: a profiler records, and the autograd node of its backward.
ATTENTION_RANGE = 'perfbench.relpos_attn'
BACKWARD_NODE = 'RelposAttentionBackward'
#: ``(B, T, lengths)`` of each attention call made while a profiler
#: records (the lengths a device tensor, read when a reader asks).
CALLS = []


def _hook_attention(model):
    """Open :data:`ATTENTION_RANGE` around every call of the model's
    attention cores (``...mhsa.attention``) and record it in
    :data:`CALLS`, while a profiler records; otherwise the hooks read one
    flag and return."""
    cores = [m for n, m in model.named_modules()
             if n.endswith('mhsa.attention')]
    open_ranges = []

    def recording():
        return getattr(torch.autograd.profiler, '_is_profiler_enabled',
                       False)

    def pre(module, args):
        if recording():
            rf = torch.profiler.record_function(ATTENTION_RANGE)
            rf.__enter__()
            open_ranges.append(rf)
            CALLS.append((args[0].shape[0], args[0].shape[1], args[6]))

    def post(module, args, out):
        if open_ranges:
            open_ranges.pop().__exit__(None, None, None)

    for m in cores:
        m.register_forward_pre_hook(pre)
        m.register_forward_hook(post)


def build(cfg, mix, device):
    """The program's model of ``cfg`` through its own factory, with the
    mix's compute dtype, the configuration's dropout and the hooks of
    :func:`_hook_attention`; its weights are its own initialisation, which
    :func:`perfbench.weights.install` replaces."""
    from nbasr_torch.models.conformer import get_conformer
    model = get_conformer(
        num_classes=cfg['num_classes'], num_blocks=cfg['num_blocks'],
        d_model=cfg['d_model'], num_heads=cfg['num_heads'],
        ffn_dim=cfg['ffn_dim'], conv_kernel=cfg['conv_kernel'],
        dropout_rate=cfg['dropout'], data_norm=load_stats(),
        compute_dtype=DTYPES[mix['compute_dtype']], device=device,
        generator=torch.Generator().manual_seed(0))
    CALLS.clear()
    _hook_attention(model)
    return model


def _sub(n):
    return ((n - 3) // 2 + 1 - 3) // 2 + 1


def param_table(cfg):
    """``[(name, shape, std, offset)]`` of every parameter, block by block
    in the order of the layers' equations (:func:`perfbench.weights.generate`
    draws them in this order): kernels ``std = 1 / sqrt(fan_in)``;
    biases small draws around 0; LayerNorm and BatchNorm scales around 1."""
    d, f, H = cfg['d_model'], cfg['ffn_dim'], cfg['num_heads']
    K = cfg['conv_kernel']

    def lin(name, n_in, n_out, bias=True):
        out = [(f'{name}.weight', (n_out, n_in), 1 / math.sqrt(n_in), 0.0)]
        return out + ([(f'{name}.bias', (n_out,), 0.05, 0.0)] if bias else [])

    def norm(name):
        return [(f'{name}.weight', (d,), 0.1, 1.0),
                (f'{name}.bias', (d,), 0.1, 0.0)]

    out = [('subsample.conv1.conv.weight', (d, 1, 3, 3), 1 / 3.0, 0.0),
           ('subsample.conv1.conv.bias', (d,), 0.05, 0.0),
           ('subsample.conv2.conv.weight', (d, d, 3, 3),
            1 / math.sqrt(9 * d), 0.0),
           ('subsample.conv2.conv.bias', (d,), 0.05, 0.0)]
    out += lin('subsample.out', d * _sub(NUM_FEATURES), d)

    def ffn(name):
        return norm(f'{name}.norm') + lin(f'{name}.w1', d, f) \
            + lin(f'{name}.w2', f, d)

    for i in range(cfg['num_blocks']):
        pre = f'blocks.{i}.'
        out += ffn(pre + 'ffn1')
        m = f'{pre}mhsa.'
        out += norm(m + 'norm')
        for n in 'qkv':
            out += lin(m + n, d, d)
        out += lin(m + 'pos', d, d, bias=False)
        out += [(m + 'pos_bias_u', (H, d // H), 0.1, 0.0),
                (m + 'pos_bias_v', (H, d // H), 0.1, 0.0)]
        out += lin(m + 'out', d, d)
        c = f'{pre}conv_module.'
        out += norm(c + 'norm')
        out += [(c + 'pointwise1.conv.weight', (2 * d, d, 1),
                 1 / math.sqrt(d), 0.0),
                (c + 'pointwise1.conv.bias', (2 * d,), 0.05, 0.0),
                (c + 'depthwise.conv.weight', (d, 1, K), 1 / math.sqrt(K),
                 0.0),
                (c + 'depthwise.conv.bias', (d,), 0.05, 0.0),
                (c + 'batch_norm.weight', (d,), 0.1, 1.0),
                (c + 'batch_norm.bias', (d,), 0.1, 0.0),
                (c + 'pointwise2.conv.weight', (d, d, 1), 1 / math.sqrt(d),
                 0.0),
                (c + 'pointwise2.conv.bias', (d,), 0.05, 0.0)]
        out += ffn(pre + 'ffn2') + norm(f'{pre}norm')
    out += lin('head', d, cfg['num_classes'] + 1)
    return out


def _drop(x, seed, counter, rate, rnd):
    if seed is None or not rate:
        return x
    B, T, C = x.shape
    thr = min(int((1.0 - rate) * (1 << 32)), _U32)
    keep = dropout_bits(seed, counter, B, T, C, x.device) < thr
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    return rnd(torch.where(keep, x * scale,
                           torch.zeros((), dtype=x.dtype, device=x.device)))


def _lin(x, p, name, rnd):
    """``rnd(rnd(x) W^T + b)`` with W and b rounded."""
    b = p.get(name + '.bias')
    return rnd(F.linear(rnd(x), rnd(p[name + '.weight']),
                        None if b is None else rnd(b)))


def _ln(x, p, name, rnd):
    return rnd(F.layer_norm(x, (x.shape[-1],), p[name + '.weight'],
                            p[name + '.bias'], LN_EPS))


def _positions(T, d, device):
    """The sinusoidal encoding of the offsets ``-(T - 1) .. T - 1``."""
    m = torch.arange(-(T - 1), T, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    out = torch.empty((2 * T - 1, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(m * div)
    out[:, 1::2] = torch.cos(m * div)
    return out


def _attention(q, k, v, r, u, vb, lengths, rnd):
    """``[B, T, H, D]`` relative-position attention, scores materialised
    over the offsets and gathered to the keys."""
    B, T, H, D = q.shape
    qu = rnd(q + u)
    qv = rnd(q + vb)
    content = torch.einsum('bihd,bjhd->bhij', qu, k)
    band = torch.einsum('bihd,mhd->bhim', qv, r)
    t = torch.arange(T, device=q.device)
    shift = (t[:, None] - t[None, :] + T - 1).expand(B, H, T, T)
    s = (content + band.gather(-1, shift)) / math.sqrt(D)
    del content, band
    valid = t[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float('-inf'))
    out = torch.einsum('bhij,bjhd->bihd', torch.softmax(s, dim=-1), v)
    return rnd(torch.where(valid[:, :, None, None], out, 0.0))


def _block(p, i, cfg, x, lengths, frames, pos, seed, rate, rnd):
    pre = f'blocks.{i}.'
    B, T, d = x.shape
    H, K = cfg['num_heads'], cfg['conv_kernel']

    def ffn(x, name, counter):
        h = rnd(F.silu(_lin(_ln(x, p, name + 'norm', rnd), p, name + 'w1',
                            rnd)))
        h = _drop(h, seed, counter, rate, rnd)
        return _drop(_lin(h, p, name + 'w2', rnd), seed, counter + 1, rate,
                     rnd)

    x = x + 0.5 * ffn(x, pre + 'ffn1.', 1)
    m = pre + 'mhsa.'
    h = _ln(x, p, m + 'norm', rnd)
    q, k, v = (_lin(h, p, m + n, rnd).view(B, T, H, d // H) for n in 'qkv')
    r = rnd(F.linear(rnd(pos), rnd(p[m + 'pos.weight']))).view(
        2 * T - 1, H, d // H)
    o = _attention(q, k, v, r, p[m + 'pos_bias_u'], p[m + 'pos_bias_v'],
                   lengths, rnd)
    x = x + _drop(_lin(o.reshape(B, T, d), p, m + 'out', rnd), seed, 3, rate,
                  rnd)
    c = pre + 'conv_module.'
    h = rnd(F.linear(_ln(x, p, c + 'norm', rnd),
                     rnd(p[c + 'pointwise1.conv.weight'][..., 0]),
                     rnd(p[c + 'pointwise1.conv.bias'])))
    h = rnd(F.glu(h, dim=-1))
    h = torch.where(frames[..., None], h, 0.0).transpose(1, 2)
    h = rnd(F.conv1d(F.pad(h, ((K - 1) // 2, K // 2)),
                     rnd(p[c + 'depthwise.conv.weight']),
                     rnd(p[c + 'depthwise.conv.bias']), groups=d))
    mk = frames[:, None, :].to(h.dtype)
    n = mk.sum()
    mean = (h * mk).sum(dim=(0, 2)) / n
    var = (torch.square(h - mean[:, None]) * mk).sum(dim=(0, 2)) / n
    h = rnd((h - mean[:, None]) * (torch.rsqrt(var + BN_EPS)
                                   * p[c + 'batch_norm.weight'])[:, None]
            + p[c + 'batch_norm.bias'][:, None])
    h = rnd(F.silu(h)).transpose(1, 2)
    h = rnd(F.linear(h, rnd(p[c + 'pointwise2.conv.weight'][..., 0]),
                     rnd(p[c + 'pointwise2.conv.bias'])))
    x = x + _drop(h, seed, 4, rate, rnd)
    x = x + 0.5 * ffn(x, pre + 'ffn2.', 5)
    return F.layer_norm(x, (d,), p[pre + 'norm.weight'],
                        p[pre + 'norm.bias'], LN_EPS)


def _subsample(p, x, seed, rate, rnd):
    B = x.shape[0]
    x = F.relu(F.conv2d(x[:, None], rnd(p['subsample.conv1.conv.weight']),
                        rnd(p['subsample.conv1.conv.bias']), stride=2))
    x = F.relu(F.conv2d(rnd(x), rnd(p['subsample.conv2.conv.weight']),
                        rnd(p['subsample.conv2.conv.bias']), stride=2))
    _, C, T, M = x.shape
    x = _lin(rnd(x).permute(0, 2, 1, 3).reshape(B, T, C * M), p,
             'subsample.out', rnd)
    return _drop(x, seed, 1, rate, rnd)


def _maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(p, cfg, feats, feature_size, stats, gen=None, rnd=identity,
            lstm_rate=0.0):
    """``[B, T, 80]`` log-mel features -> ``[B, T', num_classes + 1]``
    logits.  ``gen`` (a CPU ``torch.Generator``) turns training-mode
    dropout on (``cfg['dropout']``): the subsampling's seed, then each
    block's, two int32 words each.  ``lstm_rate`` is not used (this
    encoder has no LSTM)."""
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
    n = cfg['num_blocks']
    seeds = ([torch.randint(0, 2 ** 31 - 1, (2,), generator=gen,
                            dtype=torch.int32).tolist() for _ in range(n + 1)]
             if rate else [None] * (n + 1))
    x = _maybe_checkpoint(lambda x: _subsample(p, x, seeds[0], rate, rnd), x)
    Tp = x.shape[1]
    ratio = torch.tensor(T, dtype=torch.float32) \
        / torch.tensor(Tp, dtype=torch.float32)
    lengths = (feature_size.to(torch.float32) / ratio).to(
        torch.int64).clamp(1, Tp).to(feats.device)
    frames = torch.arange(Tp, device=feats.device)[None, :] < lengths[:, None]
    pos = _positions(Tp, cfg['d_model'], feats.device).to(dt)
    for i in range(n):
        x = _maybe_checkpoint(
            lambda x, i=i: _block(p, i, cfg, x, lengths, frames, pos,
                                  seeds[i + 1], rate, rnd), x)
    return F.linear(x, p['head.weight'], p['head.bias'])


def regularised(name):
    """Whether the recipe's L2 takes the leaf ``name``: the convolution
    kernels (the subsampling's two, each block's pointwise and depthwise
    kernels), the leaves named ``*.conv.weight``."""
    return name.endswith('.conv.weight')


def algorithmic_flops(cfg, batch, frames, train=True):
    """FLOPs of one step of ``batch`` rows of ``frames`` input frames, 2
    per multiply-add: the subsampling's convolutions and Linear, each
    block's linear and pointwise products, depthwise convolution, position
    projection and attention (three ``T' x T' x d`` products a head at
    the padded T'), and the head; elementwise work left out; a training
    step counts 3 forwards."""
    B, d, f = batch, cfg['d_model'], cfg['ffn_dim']
    H, K = cfg['num_heads'], cfg['conv_kernel']
    t1, m1 = (frames - 3) // 2 + 1, (NUM_FEATURES - 3) // 2 + 1
    t, m = _sub(frames), _sub(NUM_FEATURES)
    fwd = 2.0 * B * t1 * m1 * d * 9 + 2.0 * B * t * m * d * d * 9 \
        + 2.0 * B * t * m * d * d
    block = (2 * 2.0 * B * t * d * f * 2          # the two FFNs
             + 4 * 2.0 * B * t * d * d            # q, k, v, out
             + 2.0 * (2 * t - 1) * d * d          # the position projection
             + 3 * 2.0 * B * H * t * t * (d // H)  # content, position, PV
             + 2.0 * B * t * d * 2 * d            # pointwise 1
             + 2.0 * B * t * d * K                # depthwise
             + 2.0 * B * t * d * d)               # pointwise 2
    fwd += cfg['num_blocks'] * block + 2.0 * B * t * d * (cfg['num_classes']
                                                         + 1)
    return fwd * (3.0 if train else 1.0)


def output_stride(cfg):
    """Input frames a logit frame: the two stride-2 convolutions."""
    return 4


def halo(cfg):
    """Full-context attention has no finite halo: the encoder does not
    stream."""
    raise NotImplementedError('conformer_ctc: full-context attention has no '
                              'finite halo; the encoder does not stream')


def attention_counts(cfg, B, T, lengths, esize, backward=False):
    """``(operations, bytes)`` of one attention call on ``B`` rows of ``T``
    frames with valid ``lengths`` (a list): 6 H d sum(L^2) operations
    forward (three L x L x d products a row), 10 backward (dV, dP, dQ, dK,
    dR); bytes over the valid rows, each input read once and each output
    written once: q, k, v (o, dO), the band of r over the longest row, u
    and v's bias (f32), the lengths and the log-sum-exp (f32)."""
    H = cfg['num_heads']
    D = cfg['d_model'] // H
    sq = float(sum(L * L for L in lengths))
    rows = float(sum(lengths))
    act = rows * H * D * esize
    band = (2 * max(lengths) - 1) * H * D * esize
    bias = 2 * H * D * 4
    lse = rows * H * 4
    if backward:     # q, k, v, r, u, v, o, dO, lse in; dq, dk, dv, dr, du, dv out
        return 10.0 * H * D * sq, 5 * act + band + bias + lse \
            + 3 * act + band + bias
    return 6.0 * H * D * sq, 3 * act + band + bias + 4 * B + act + lse


def attention_roofline(ctx, backward=False):
    """The least time of the span-profiled stretch's attention calls over
    the device time of the kernels they launched, %: the forward's
    launched inside :data:`ATTENTION_RANGE`, the backward's inside the
    autograd engine's :data:`BACKWARD_NODE` nodes.  None where the run
    has no such calls (another architecture, or a program without the
    hooks' ranges)."""
    tr = ctx.get('spans')
    if tr is None or not tr.kernels():
        return None
    n = sum(len(v) for v in tr.ranges.get(ATTENTION_RANGE, {}).values())
    calls = CALLS[-n:] if n else []
    if not calls:
        return None
    names = ([r for r in tr.ranges if BACKWARD_NODE in r] if backward
             else [ATTENTION_RANGE])
    kernels = tr.layer_kernels(names)
    if not kernels:
        return None
    seconds = sum(e - s for s, e, _ in kernels) / 1e6
    es = ctx['esize']
    least = sum(least_seconds(*attention_counts(
        ctx['cfg'], B, T, [int(v) for v in lengths.tolist()], es, backward),
        es) for B, T, lengths in calls)
    return 100.0 * least / seconds
