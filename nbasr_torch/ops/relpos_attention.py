"""Relative-position multi-head self-attention (Transformer-XL's, as the
Conformer uses it) on the card: one fused CUDA kernel forward and two
backward (``nbasr_torch/csrc/relpos_attention.cu``), their plain versions,
and the autograd Function over them.

Source note.  The kernels replace no TPU kernel: the JAX package has no
attention.  They were added for the Conformer encoder
(``nbasr_torch/models/conformer.py``), whose plain formula materialises
``[B, H, T, 2T-1]`` position scores, rel-shifts them into ``[B, H, T, T]``
and takes a softmax: at a 35 s utterance (T = 875 frames after the 4x
subsampling, B = 32, H = 8) one such f32 tensor is 1.57 GB, several are
saved per layer, and 17 layers do not fit the card.  Bound: operations
(6 H d L^2 a row's forward at d = 64, against 4 H d L bytes; about 75
GFLOP to 0.1 GB a layer at the long bucket); the design keeps every score
on chip, as FlashAttention does, so the bytes are the inputs and outputs.

:func:`relpos_attention` takes ``q``, ``k``, ``v`` ``[B, T, H, D]`` (the
projections' layout, last axis contiguous), ``r`` ``[2T - 1, H, D]`` (the
projected sinusoidal encoding of the offset ``m = i - j``, row ``m + T -
1``), the learned biases ``pos_bias_u`` and ``pos_bias_v`` ``[H, D]`` and
the rows' ``lengths`` ``[B]`` (int), and returns ``[B, T, H, D]``:

    score_ij = ((q_i + u) . k_j + (q_i + v) . r_{i-j}) / sqrt(D),

softmax over the keys ``j < lengths[b]``, times ``v``; rows at or past
their length give zeros, so their gradients are zeros too (a length is
taken as at least 1 and at most T).

The forward kernel (``nbasr_relpos_attn_fwd``) walks a 64-row query tile
over the row's 64-key tiles with an online softmax.  A tile's position
term is the product ``(q + v) band^T`` with the 127 rows of r its (i, j)
block needs, kept in shared memory, from which each score reads its
column (the rel-shift as an indexed read).  It saves the output and each
row's log-sum-exp; nothing of size T x T reaches memory.  The backward
recomputes the scores: ``nbasr_relpos_attn_bwd_dq`` (a block a query
tile) stores its rows' ``dO . O``, sums dQ and adds its rows' content and
position parts into du and dv (f32, by atomics); then
``nbasr_relpos_attn_bwd_dkv`` (a block a key tile) sums dK and dV in
registers and adds each tile's dr band into an f32 ``[H, 2T - 1, D]``
buffer by atomics, the band's high half carried to the next query tile,
whose low half covers the same rows.  Key and query tiles past a row's
length are skipped.  bf16 operands run on the tensor cores (``mma.sync``)
with f32 sums; f32 operands take f32 FMAs.  The kernels take a head size
of 64 (``HEAD``), the Conformer's.

A CUDA tensor goes to the kernels, a CPU tensor to the plain versions
(:func:`attention_reference`, the formula materialised, and
:func:`attention_backward_reference`, its autograd); nothing falls back.
``LAUNCHES`` counts the calls of each direction.
"""

import ctypes
import math

import torch

from . import _build

__all__ = ['relpos_attention', 'RelposAttention', 'attention_reference',
           'attention_backward_reference', 'LAUNCHES', 'reset_launches',
           'BLOCK', 'HEAD', 'KERNELS']

#: Calls of the kernels (``'kernel'``) and of the plain versions
#: (``'plain'``) of each direction since the last :func:`reset_launches`.
LAUNCHES = {name: {'kernel': 0, 'plain': 0} for name in ('forward', 'backward')}

#: Query and key rows a tile (the band of r is two such tiles).
BLOCK = 64
#: The head size the kernels take.
HEAD = 64
#: The kernels' names, as the profiler shows them (templates on the dtype).
KERNELS = ('nbasr_relpos_attn_fwd', 'nbasr_relpos_attn_bwd_dq',
           'nbasr_relpos_attn_bwd_dkv')


def reset_launches():
    for counts in LAUNCHES.values():
        counts.update(kernel=0, plain=0)


def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def relpos_attention(q, k, v, r, pos_bias_u, pos_bias_v, lengths):
    """``[B, T, H, D]`` attention output of the relative-position scores
    (module docstring)."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, r, pos_bias_u, pos_bias_v))
    if needs_grad:
        return RelposAttention.apply(q, k, v, r, pos_bias_u, pos_bias_v,
                                     lengths)
    return _forward(q, k, v, r, pos_bias_u, pos_bias_v, lengths)[0]


def _device_kind(x):
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'relpos_attention runs on cuda or cpu, not '
                         f'{x.device}')
    return x.device.type


def _forward(q, k, v, r, u, vb, lengths):
    if _device_kind(q) == 'cpu':
        return attention_reference(q, k, v, r, u, vb, lengths)
    return _launch_forward(q, k, v, r, u, vb, lengths)


def _backward(q, k, v, r, u, vb, lengths, o, lse, do):
    if _device_kind(q) == 'cpu':
        return attention_backward_reference(q, k, v, r, u, vb, lengths, o,
                                            lse, do)
    return _launch_backward(q, k, v, r, u, vb, lengths, o, lse, do)


class RelposAttention(torch.autograd.Function):
    """The attention with its backward (kernels or plain); saves the
    output and the rows' log-sum-exp, never the scores."""

    @staticmethod
    def forward(ctx, q, k, v, r, u, vb, lengths):
        o, lse = _forward(q, k, v, r, u, vb, lengths)
        ctx.save_for_backward(q, k, v, r, u, vb, lengths, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        grads = _backward(*ctx.saved_tensors, do)
        return (*grads, None)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _check(q, k, v, r, u, vb, lengths):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'q, k, v: expected three [B, T, H, D] tensors, got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    B, T, H, D = q.shape
    if tuple(r.shape) != (2 * T - 1, H, D):
        raise ValueError(f'r: expected {(2 * T - 1, H, D)}, got '
                         f'{tuple(r.shape)}')
    for name, t in (('pos_bias_u', u), ('pos_bias_v', vb)):
        if tuple(t.shape) != (H, D):
            raise ValueError(f'{name}: expected {(H, D)}, got '
                             f'{tuple(t.shape)}')
    if tuple(lengths.shape) != (B,):
        raise ValueError(f'lengths: expected [{B}], got '
                         f'{tuple(lengths.shape)}')
    return B, T, H, D


def attention_reference(q, k, v, r, u, vb, lengths):
    """The plain version of the forward kernel: ``(out [B, T, H, D] in q's
    dtype, lse [B, H, T] f32)`` from the materialised scores, in f32 (the
    inputs' dtype if wider).  ``q + u`` and ``q + v`` are rounded to q's
    dtype before their products, as the kernel feeds them to its tensor
    cores."""
    _build.count_launch(LAUNCHES['forward'], 'plain')
    return _materialised(q, k, v, r, u, vb, lengths)


def _materialised(q, k, v, r, u, vb, lengths):
    B, T, H, D = _check(q, k, v, r, u, vb, lengths)
    acc = _acc(q.dtype)
    qf = q.to(acc)
    qu = (qf + u.to(acc)).to(q.dtype).to(acc)
    qv = (qf + vb.to(acc)).to(q.dtype).to(acc)
    content = torch.einsum('bihd,bjhd->bhij', qu, k.to(acc))
    band = torch.einsum('bihd,mhd->bhim', qv, r.to(acc))
    t = torch.arange(T, device=q.device)
    shift = (t[:, None] - t[None, :] + T - 1).expand(B, H, T, T)
    s = (content + band.gather(-1, shift)) / math.sqrt(D)
    lengths = lengths.to(q.device).clamp(1, T)
    keys = (t[None, :] < lengths[:, None])[:, None, None, :]
    s = s.masked_fill(~keys, float('-inf'))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum('bhij,bjhd->bihd', torch.exp(s - lse[..., None]),
                       v.to(acc))
    rows = t[None, :] < lengths[:, None]
    out = torch.where(rows[:, :, None, None], out, 0.0)
    lse = torch.where(rows[:, None, :], lse, 0.0)
    return out.to(q.dtype), lse.float()


def attention_backward_reference(q, k, v, r, u, vb, lengths, o, lse, do):
    """The plain version of the backward kernels: the gradients of ``q``,
    ``k``, ``v``, ``r``, ``u`` and ``v``'s bias, by autograd through
    :func:`attention_reference` (``o`` and ``lse`` unused: it recomputes
    them)."""
    _build.count_launch(LAUNCHES['backward'], 'plain')
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (q, k, v, r, u, vb)]
        out, _ = _materialised(*leaves, lengths)
        return torch.autograd.grad(out, leaves, do)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGS = [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
_BWD_ARGS = [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _P, _P, _P, _P, _P, _P, _P, _P]
#: The operand dtypes the kernels take, in the C interface's order.
_DTYPES = (torch.float32, torch.bfloat16)


def _aligned(t):
    """``t`` with a unit last stride, its rows 16-byte aligned (the kernels
    stage rows in 16-byte vectors), else a contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1])):
        return t
    return t.contiguous()


def _operands(q, k, v, r, u, vb, lengths):
    """The operands as the kernels take them: q, k, v, r of one dtype of
    ``_DTYPES``, head size ``HEAD``, rows aligned; u and v's bias f32
    contiguous; the lengths int32, clipped to [1, T]."""
    B, T, H, D = _check(q, k, v, r, u, vb, lengths)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, r)):
        raise ValueError(f'q, k, v, r: one dtype of {list(_DTYPES)}, got '
                         f'{[t.dtype for t in (q, k, v, r)]}')
    if D != HEAD:
        raise ValueError(f'head size {D}: the kernels take {HEAD}')
    dev = q.device
    for name, t in (('k', k), ('v', v), ('r', r), ('pos_bias_u', u),
                    ('pos_bias_v', vb), ('lengths', lengths)):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, q on {dev}')
    q, k, v, r = (_aligned(t) for t in (q, k, v, r))
    u = u.float().contiguous()
    vb = vb.float().contiguous()
    lengths = lengths.to(torch.int32).clamp(1, T).contiguous()
    return (B, T, H, D), (q, k, v, r, u, vb, lengths)


def _strides(*tensors):
    """The strides the C interface reads: each [B, T, H, D] tensor's first
    three, r's first two, in the order given."""
    flat = [s for t in tensors for s in t.stride()[:-1]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_forward(q, k, v, r, u, vb, lengths):
    (B, T, H, D), (q, k, v, r, u, vb, lengths) = _operands(
        q, k, v, r, u, vb, lengths)
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, r)
    fn = _build.function('relpos_attention', 'nbasr_relpos_attn_forward',
                         _FWD_ARGS)
    with torch.cuda.device(q.device):
        err = fn(_DTYPES.index(q.dtype), B, T, H, D, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), r.data_ptr(), u.data_ptr(),
                 vb.data_ptr(), lengths.data_ptr(),
                 ctypes.cast(strides, _P), o.data_ptr(), lse.data_ptr(),
                 _stream(q))
    _build.check(err, 'relpos_attention', 'relative-position attention')
    _build.count_launch(LAUNCHES['forward'], 'kernel')
    return o, lse


def _launch_backward(q, k, v, r, u, vb, lengths, o, lse, do):
    """dQ, du and dv's bias first (storing each row's ``dO . O``), then dK,
    dV and dr."""
    u_dtype, vb_dtype = u.dtype, vb.dtype
    (B, T, H, D), (q, k, v, r, u, vb, lengths) = _operands(
        q, k, v, r, u, vb, lengths)
    do, o = (_aligned(t.to(q.dtype)) for t in (do, o))
    lse = lse.float().contiguous()
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dr = torch.zeros((H, 2 * T - 1, D), dtype=torch.float32, device=q.device)
    du = torch.zeros((H, D), dtype=torch.float32, device=q.device)
    dvb = torch.zeros((H, D), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, r, o, do)
    fn = _build.function('relpos_attention', 'nbasr_relpos_attn_backward',
                         _BWD_ARGS)
    with torch.cuda.device(q.device):
        err = fn(_DTYPES.index(q.dtype), B, T, H, D, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), r.data_ptr(), u.data_ptr(),
                 vb.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), ctypes.cast(strides, _P),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dr.data_ptr(),
                 du.data_ptr(), dvb.data_ptr(), delta.data_ptr(), _stream(q))
    _build.check(err, 'relpos_attention', 'relative-position attention '
                 'backward')
    _build.count_launch(LAUNCHES['backward'], 'kernel')
    return (dq, dk, dv, dr.to(r.dtype).permute(1, 0, 2), du.to(u_dtype),
            dvb.to(vb_dtype))
