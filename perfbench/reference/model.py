"""Plain PyTorch reference of the recipe's training loss and update, and the
roundings of the control, written from the recipe's stated contract; it
imports nothing of the program under test.  The encoder is the
architecture's own (``perfbench/archs/<model>.py``, passed in as
``arch``): its ``forward`` and which leaves its ``regularised`` puts
under the L2.

Training follows the recipe: the CTC loss of each valid row over its logit
length + 1, averaged over the valid rows, plus 0.01 times the squared
regularised leaves; the gradients clipped to a global norm of 5; Adam
(0.9, 0.999, eps 1e-16).

``rnd`` is applied wherever the recipe states a rounding to its compute
dtype; the reference itself passes the identity and computes in ``dtype``
throughout.  The control passes a rounding to the precision below the
configuration's (:func:`rounding`).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import frontend as fe

__all__ = ['train_objective', 'follow_train', 'ReferenceAdam', 'load_stats',
           'logit_lengths', 'identity', 'rounding']

L2_COEFF = 0.01


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


def load_stats():
    """The frozen TIMIT-train log-mel mean and variance (80 each)."""
    import pathlib
    with np.load(pathlib.Path(__file__).with_name(
            'timit_train_stats.npz')) as s:
        return s['mean'], s['variance']


def logit_lengths(feature_size, t_in, t_out):
    """True logit lengths: the frame counts over the float32 ratio of the
    padded input to the output length, truncated."""
    ratio = np.float32(t_in) / np.float32(t_out)
    return (feature_size.to(torch.float32) / float(ratio)).to(torch.int64)


def train_objective(arch, p, cfg, batch, stats, gen, rnd=identity,
                    lstm_rate=0.0):
    """The training loss of one batch of the architecture ``arch`` (features
    computed here from its audio): ``(loss, mean normalised CTC of the valid
    rows, logits, logit lengths)``."""
    dt = next(iter(p.values())).dtype
    audio = batch['audio'].to(dt)
    feats = fe.log_mel(audio)
    fsize = batch['feature_size'].long()
    logits = arch.forward(p, cfg, feats, fsize, stats, gen, rnd, lstm_rate)
    llen = logit_lengths(fsize, feats.shape[1], logits.shape[1])
    rows = torch.nonzero(batch['valid'] > 0).flatten()
    lp = torch.log_softmax(logits[rows], dim=-1)
    nll = F.ctc_loss(lp.transpose(0, 1), batch['labels'][rows].long(),
                     llen[rows], batch['label_size'][rows].long(), blank=0,
                     reduction='none', zero_infinity=True)
    ctc = (nll / (llen[rows] + 1).to(dt)).sum() / max(len(rows), 1)
    l2 = sum(v.square().sum() for k, v in p.items() if arch.regularised(k))
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


def follow_train(arch, cfg, mix, stats, weights0, batches, seed, device,
                 rnd=identity, dtype=torch.float32):
    """Train the architecture ``arch`` from ``weights0`` on ``batches``
    (numpy dicts) as the recipe states, with the dropout stream of a CPU
    generator seeded ``seed + 1``.
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
        loss, ctc, lg, llen = train_objective(arch, p, cfg, tb, stats, gen,
                                              rnd, mix['dropout'])
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
