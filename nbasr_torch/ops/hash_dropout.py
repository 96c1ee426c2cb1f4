"""Dropout of ``[B, T, C]`` activations by the port's stateless hash, as a
Triton kernel on the card: the mask is recomputed from the seed, never
stored, and the backward is the same pass on the gradient.

Source note.  It replaces no TPU kernel (the JAX package leaves dropout
outside its cell kernel to XLA).  It was added for the Conformer
(``nbasr_torch/models/conformer.py``), whose residual units drop 0.1 of
``[B, T, 512]`` and ``[B, T, 2048]`` tensors six times a block: the hash
written in PyTorch ops (``fused_cell.dropout_bits``) takes some twenty
int64 passes over each, and a mask drawn from a generator would be a
draw the plain reference cannot follow.  Bound: bytes (one read and one
write of the tensor, about 40 integer operations an element); one pass.

The bits are :func:`nbasr_torch.ops.fused_cell.dropout_bits`' for the seed
words, the site's ``counter``, the frame, the channel and the row, so a
plain reference follows the masks bit for bit.  Kept elements are
multiplied by ``1 / (1 - rate)`` rounded to f32, in f32, and rounded once
to the tensor's dtype.  A CUDA tensor goes to the kernel
(``nbasr_hash_dropout``), a CPU tensor to :func:`dropout_reference`;
``LAUNCHES`` counts the calls.
"""

import functools

import torch

from . import _build
from .fused_cell import dropout_bits, inv_keep, keep_threshold

__all__ = ['hash_dropout', 'dropout_reference', 'LAUNCHES', 'reset_launches']

#: Calls of the kernel (``'kernel'``) and of the plain version
#: (``'plain'``), forward and backward alike, since :func:`reset_launches`.
LAUNCHES = {'kernel': 0, 'plain': 0}

_U32 = 0xFFFFFFFF
_BLOCK = 1024

tl = None       # triton.language, bound by _kernel() on first use


def reset_launches():
    LAUNCHES.update(kernel=0, plain=0)


def _hash_constant(words, counter):
    """The hash's per-call constant of the seed's two words and the
    draw ``counter``, a uint32 as a Python int."""
    s0, s1 = (int(w) & _U32 for w in words)
    return ((s0 * 0xC2B2AE35) & _U32) ^ ((s1 + 0x27D4EB2F) & _U32) \
        ^ ((counter * 0x5851F42D) & _U32)


def hash_dropout(x, words, counter, rate):
    """``x`` ``[B, T, C]`` with dropout ``rate`` by the hash of the seed
    ``words`` (two ints) and ``counter``; the identity at rate 0."""
    if not rate:
        return x
    return _HashDropout.apply(x, tuple(int(w) for w in words), int(counter),
                              float(rate))


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, words, counter, rate):
        ctx.args = (words, counter, rate)
        return _apply(x, words, counter, rate)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, *ctx.args), None, None, None


def _apply(x, words, counter, rate):
    if x.dim() != 3:
        raise ValueError(f'hash_dropout takes [B, T, C], got '
                         f'{tuple(x.shape)}')
    if x.device.type == 'cpu':
        return dropout_reference(x, words, counter, rate)
    if x.device.type != 'cuda':
        raise ValueError(f'hash_dropout runs on cuda or cpu, not {x.device}')
    return _launch(x, words, counter, rate)


def dropout_reference(x, words, counter, rate):
    """The plain version: the hash's bits in int64 torch ops."""
    _build.count_launch(LAUNCHES, 'plain')
    B, T, C = x.shape
    seed = torch.tensor([int(w) for w in words], dtype=torch.int32)
    keep = dropout_bits(seed, counter, B, T, C, x.device) \
        < keep_threshold(rate)
    return torch.where(keep, x * inv_keep(rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    triton, tl = _build.triton()

    @triton.jit
    def nbasr_hash_dropout(X, Y, N, T, C, CONST, THR, scale,
                           BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        ok = offs < N
        c = (offs % C).to(tl.uint32)
        t = ((offs // C) % T).to(tl.uint32)
        b = (offs // (C * T)).to(tl.uint32)
        h = (t * 0x9E3779B1) ^ (c * 0x85EBCA6B) ^ (b * 0x165667B1)
        h = (h.to(tl.int64) ^ CONST).to(tl.uint32)
        h = h ^ (h >> 15)
        h = h * 0x2545F491
        h = h ^ (h >> 13)
        h = h * 0x2545F491
        h = h ^ (h >> 16)
        h = h * 0x2545F491
        h = h ^ (h >> 16)
        keep = h.to(tl.int64) < THR
        x = tl.load(X + offs, mask=ok, other=0.)
        y = tl.where(keep, x.to(tl.float32) * scale, 0.0)
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=ok)

    return nbasr_hash_dropout


def _launch(x, words, counter, rate):
    kernel = _kernel()
    x = x.contiguous()
    B, T, C = x.shape
    y = torch.empty_like(x)
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f'hash_dropout: {n} elements; the kernel indexes '
                         f'in int32')
    with torch.cuda.device(x.device):
        kernel[(-(-n // _BLOCK),)](x, y, n, T, C, _hash_constant(words, counter),
                                   keep_threshold(rate), inv_keep(rate),
                                   BLOCK=_BLOCK, num_warps=4)
    _build.count_launch(LAUNCHES, 'kernel')
    return y
