"""Plain PyTorch reference of the NAS-Bench-ASR encoder, its training loss
and its update, written from the published description and the recipe's
stated contract; it imports nothing of the program under test.

The model (NAS-Bench-ASR, ``model/torch/model.py:72-103`` of the
reference repository): log-mel features, masked to the true frame count,
normalised by frozen TIMIT mean and variance; four blocks of a dense
conv (kernel 8, strides 1/1/2/2, filters 600/800/1000/1200, clip-ReLU at
20), a LayerNorm and 3/4/5/6 search cells; an LSTM of 500 units and a
dense head of 49 outputs.  A cell's node ``i`` applies its op (a linear
map, or a grouped conv of 5 or 7 taps, dilation 1 or 2, in 100 groups) to
node ``i - 1``'s output, clips at [0, 20], drops, and adds every earlier
output whose branch bit is set; a LayerNorm ends the cell.  Convs pad for
at most 4 frames of look-ahead.

Training follows the recipe: dropout 0.2 in every cell op (a stateless
hash of the cell's seed, the row, the node, the frame and the channel)
and before the LSTM (one mask per row and channel, shared over time), the
CTC loss of each valid row over its logit length + 1, averaged over the
valid rows, plus 0.01 times the squared conv kernels; the gradients
clipped to a global norm of 5; Adam (0.9, 0.999, eps 1e-16).

``rnd`` is applied wherever the recipe states a rounding to its compute
dtype (weights as the ops read them, each layer's output; the gradient
reaching each of those points in the backward); the reference itself
passes the identity and computes in ``dtype`` throughout.  The control
passes a rounding to the precision below the configuration's
(:func:`rounding`).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import frontend as fe

__all__ = ['OPS', 'arch_nodes', 'param_table', 'forward', 'train_objective',
           'follow_train', 'ReferenceAdam', 'draw_cell_seed', 'load_stats',
           'logit_lengths', 'halo', 'identity', 'rounding']

OPS = ['linear', 'conv5', 'conv5d2', 'conv7', 'conv7d2', 'zero']
CONVS = {'conv5': (5, 1), 'conv5d2': (5, 2), 'conv7': (7, 1),
         'conv7d2': (7, 2)}
CONTEXT = 4          # frames of look-ahead a conv may take
NORM_EPS = 1e-3      # LayerNorm and the frozen mean/variance norm
L2_COEFF = 0.01
CLIP = 20.0
NUM_FEATURES = 80
_U32 = 0xFFFFFFFF


def identity(x):
    return x


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn, grad_fn):
        ctx.grad_fn = grad_fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grad_fn(g), None, None


def _tf32(x):
    """Round float32 ``x`` to TF32's 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _to(dtype, scaled=False):
    """Rounding to ``dtype``; ``scaled``: of the tensor divided by its
    largest magnitude over the dtype's largest value (a per-tensor
    scale, as low-precision gradients are kept), then scaled back."""
    top = float(torch.finfo(dtype).max)

    def fn(x):
        scale = (x.abs().amax() / top).clamp(min=1e-30) if scaled else 1.0
        return (x / scale).clamp(-top, top).to(dtype).to(x.dtype) * scale
    return fn


def rounding(name):
    """``x -> x`` rounded to the precision ``name`` ('tf32', or a torch
    dtype's name such as 'bfloat16' or 'float8_e4m3fn', saturating at its
    largest finite value), and the gradient reaching it rounded alike (a
    one-byte dtype with a per-tensor scale); 'float32' is the identity."""
    if name == 'float32':
        return identity
    if name == 'tf32':
        fn = grad_fn = _tf32
    else:
        dtype = getattr(torch, name)
        fn, grad_fn = _to(dtype), _to(dtype, scaled=dtype.itemsize == 1)
    return lambda x: _Round.apply(x, fn, grad_fn)


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


def load_stats():
    """The frozen TIMIT-train log-mel mean and variance (80 each)."""
    import pathlib
    with np.load(pathlib.Path(__file__).with_name(
            'timit_train_stats.npz')) as s:
        return s['mean'], s['variance']


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


def logit_lengths(feature_size, t_in, t_out):
    """True logit lengths: the frame counts over the float32 ratio of the
    padded input to the output length, truncated."""
    ratio = np.float32(t_in) / np.float32(t_out)
    return (feature_size.to(torch.float32) / float(ratio)).to(torch.int64)


def train_objective(p, cfg, batch, stats, gen, rnd=identity, lstm_rate=0.0):
    """The training loss of one batch (features computed here from its
    audio): ``(loss, mean normalised CTC of the valid rows, logits, logit
    lengths)``."""
    dt = next(iter(p.values())).dtype
    audio = batch['audio'].to(dt)
    feats = fe.log_mel(audio)
    fsize = batch['feature_size'].long()
    logits = forward(p, cfg, feats, fsize, stats, gen, rnd, lstm_rate)
    llen = logit_lengths(fsize, feats.shape[1], logits.shape[1])
    rows = torch.nonzero(batch['valid'] > 0).flatten()
    lp = torch.log_softmax(logits[rows], dim=-1)
    nll = F.ctc_loss(lp.transpose(0, 1), batch['labels'][rows].long(),
                     llen[rows], batch['label_size'][rows].long(), blank=0,
                     reduction='none', zero_infinity=True)
    ctc = (nll / (llen[rows] + 1).to(dt)).sum() / max(len(rows), 1)
    l2 = sum(v.square().sum() for k, v in p.items()
             if k.endswith('.conv.weight') or k.endswith('conv_kernel_grouped'))
    return ctc + L2_COEFF * l2, ctc, logits, llen


class ReferenceAdam:
    """Global-norm clipping at ``clip``, then Adam; a step whose gradients
    are not all finite changes nothing."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-16, clip=5.0):
        self.params = params
        self.lr, self.b1, self.b2, self.eps, self.clip = lr, b1, b2, eps, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        """Update the parameters; returns the clipped gradients, or None
        for a skipped step."""
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            return None
        scale = self.clip / norm if norm >= self.clip else 1.0
        grads = {k: g * scale for k, g in grads.items()}
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = math.sqrt(1 - self.b2 ** self.t)
        for k, g in grads.items():
            m, v = self.m[k], self.v[k]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            self.params[k].sub_(self.lr / bc1 * m / (v.sqrt() / bc2 + self.eps))
        return grads


def follow_train(cfg, mix, stats, weights0, batches, seed, device,
                 rnd=identity, dtype=torch.float32):
    """Train from ``weights0`` on ``batches`` (numpy dicts) as the recipe
    states, with the dropout stream of a CPU generator seeded ``seed + 1``.
    Returns ``{'loss': each step's mean normalised CTC, 'first': each
    leaf's norm of the first step's clipped gradient, 'change': each
    leaf's norm of its change over all the steps, 'logits' and
    'logit_len': the first step's logits and their lengths, 'grads': the
    first step's clipped gradients}``."""
    p = {k: v.detach().to(dtype).clone().requires_grad_(True)
         for k, v in weights0.items()}
    gen = torch.Generator().manual_seed(int(seed) + 1)
    opt = ReferenceAdam(p, mix['lr'], clip=mix['clip'])
    losses, first, logits, logit_len, first_grads = [], None, None, None, {}
    for k, b in enumerate(batches):
        tb = {n: torch.as_tensor(v, device=device) for n, v in b.items()}
        tb['audio'] = tb['audio'].to(dtype)
        loss, ctc, lg, llen = train_objective(p, cfg, tb, stats, gen, rnd,
                                              mix['dropout'])
        grads = torch.autograd.grad(loss, list(p.values()))
        clipped = opt.step(dict(zip(p, grads)))
        if k == 0:
            first = {n: float(g.norm()) for n, g in (clipped or {}).items()}
            first_grads = clipped or {}
            logits, logit_len = lg.detach().float(), llen
        losses.append(float(ctc.detach()))
        del loss, ctc, grads, clipped, lg
    change = {n: float((p[n].detach() - weights0[n].to(dtype)).norm())
              for n in p}
    return {'loss': losses, 'first': first, 'change': change,
            'logits': logits, 'logit_len': logit_len, 'grads': first_grads}


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
