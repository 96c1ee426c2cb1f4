"""Fused SearchCell, forward and backward: the Hopper kernels' wrappers,
their plain versions, and the autograd Function that joins them.

Port of ``nbasr_tpu/ops/fused_cell.py``: ``_fwd_kernel`` runs one whole
cell — every node's grouped conv or dense product, bias, clip-ReLU(20),
dropout, branch adds, and the trailing LayerNorm — per call, and
``_bwd_kernel`` its backward (LayerNorm backward, then a reverse walk of
the node DAG giving dx, per-node dW and db, and the LayerNorm's dscale and
dbias).  The kernels are ``nbasr_torch/csrc/fused_cell.cu`` and
``nbasr_torch/csrc/fused_cell_bwd.cu``; their headers state the bounds and
the designs.  The TPU layout tricks (chunk expansion, 128-lane padding) are
not carried over: the kernels read and write the compact ``[K, ci, C]``
weights.  The forward's conv nodes run the grouped conv forward's body
and the backward's conv nodes its dW and dx kernels
(``nbasr_torch/csrc/gconv_body.cuh``), on launch plans made here
(:func:`forward_plans`, :func:`backward_plans`) and checked again in C.
A linear node's three products (``z = src W``, ``dx += dz W^T``, ``dW =
src^T dz``) run in bf16 on the tensor cores (``csrc/linear_mma.cuh``)
where :func:`linear_plans` finds C % 8 == 0 and every operand on 16 bytes,
else (f32, which on the tensor cores would be TF32) on the SIMT kernels;
the counters ``cell.linear_mma`` and ``cell.linear_fma`` of
:mod:`nbasr_torch.utils.tracing` count the linear node calls of each path,
forward and backward.

Dropout draws its bits from the JAX kernel's interpret-mode generator
(``_Prng.bits``): a stateless hash of (seed, batch row, node, t, c) in
uint32 arithmetic.  The kernel, the plain version and the JAX package in
interpret mode therefore draw the same mask from the same seed, and the
backward needs no stored generator state.  A tensor-parallel shard of a
cell (``FusedCellSpec.channel_offset`` ``c0``) hashes its channel ``c`` as
the whole cell's ``c0 + c``, so its masks are the whole cell's on its
channels.

A training forward keeps every node output and every node's multiplier
(clip-ReLU gate × dropout keep / (1 − p), in the activation dtype) for the
backward, which then recomputes nothing: the TPU kernel recomputes only
because a cell has to fit one VMEM residency.

:func:`fused_cell_forward` is the differentiable entry point.  A CUDA tensor
goes to the kernels and a CPU tensor to the plain versions, and nothing
else: there is no fallback from one to the other.  ``LAUNCHES`` and
``BACKWARD_LAUNCHES`` count the calls of each, so a run can show which one
it went through.
"""

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils import tracing
from . import _build, grouped_conv

__all__ = ['ConvNode', 'LinearNode', 'ZeroNode', 'FusedCellSpec', 'FusedCell',
           'fused_cell_forward', 'fused_cell_train_forward',
           'fused_cell_backward', 'fused_cell_reference',
           'fused_cell_backward_reference', 'dropout_bits', 'keep_threshold',
           'inv_keep', 'relu20_gate', 'dx_outputs', 'forward_plans',
           'backward_plans', 'linear_path', 'linear_plans', 'dw_chunks',
           'forward_desc_ints', 'backward_desc_ints',
           'LINEAR_FMA', 'LINEAR_MMA', 'LAUNCHES', 'BACKWARD_LAUNCHES',
           'reset_launches']

LN_EPS_DEFAULT = 1e-3

#: Calls of the forward CUDA kernel (``'kernel'``) and of its plain version
#: (``'plain'``) since the last :func:`reset_launches`.
LAUNCHES = {'kernel': 0, 'plain': 0}
#: The same for the backward.
BACKWARD_LAUNCHES = {'kernel': 0, 'plain': 0}

_KIND = {'conv': 0, 'linear': 1, 'zero': 2}
_MAX_NODES = 7          # kMaxOutputs - 1 in the kernels
_DESC = 7               # ints per node that describe it (:func:`_describe`)
#: Ints per node of the forward kernel's descriptor: the seven, then a conv
#: node's launch plan (zeros for other nodes).
FWD_DESC_INTS = _DESC + len(grouped_conv.FWD_PLAN_FIELDS)
#: The register tiles (taps, outputs) the forward's conv node instantiates
#: in f32, the serving dtype: conv5's taps by the search space's 6, 8, 10
#: channels a group (12 as two tiles of 6; conv7 as chunks of 5 and 2).  In
#: bf16 they are the grouped forward's own.
F32_TILES = ((5,), (6, 8, 10))
#: Resident blocks per SM a conv node's plan keeps where it can: a block's
#: epilogue pass runs after its sums, so other blocks' sums have to cover
#: it (``fwd_sweep.py --fused``: plans of two blocks an SM ran up to 1.2x
#: the fastest at the train step's widths).
MIN_BLOCKS = 4
#: Where a conv node's dx goes in the backward kernel: rounded into dx (node
#: 0 where nothing else writes g[0]), stored into its f32 gradient buffer
#: g[n], or added there (after branch adds).
DX_OUT, DX_STORE, DX_ADD = 0, 1, 2
#: Ints per node of the backward's descriptor: the forward's seven, the dx
#: output, a conv node's dW plan and its dx plan (zeros for other nodes).
BWD_DESC_INTS = (_DESC + 1 + len(grouped_conv.DW_PLAN_FIELDS)
                 + len(grouped_conv.FWD_PLAN_FIELDS))
#: A linear node's path, the first int of its plan in either descriptor:
#: the SIMT kernels (FMAs) or the tensor-core GEMMs (bf16 only).
LINEAR_FMA, LINEAR_MMA = 0, 1
#: The tensor-core GEMM's output tile (rows, columns) and k a stage
#: (``csrc/linear_mma.cuh``: kBM, kBN, kBK), and its blocks an SM.
MMA_TILE = (128, 128)
MMA_TILE_K = 64
MMA_BLOCKS_PER_SM = 2
#: dW's row chunks keep at least this many k tiles (of MMA_TILE_K rows)
#: each, so that a chunk's operand ring runs well past its fill.
DW_MIN_K_TILES = 8
_U32 = 0xFFFFFFFF


def reset_launches():
    LAUNCHES.update(kernel=0, plain=0)
    BACKWARD_LAUNCHES.update(kernel=0, plain=0)


class ConvNode:
    """A grouped dilated conv node: tap k reads ``x[t + k*d - lpad]``."""

    kind = 'conv'

    def __init__(self, kernel_size, dilation, lpad, rpad, groups, cin_pg,
                 cout_pg, branches):
        if lpad + rpad != (kernel_size - 1) * dilation:
            raise ValueError(f'padding ({lpad}, {rpad}) does not keep the '
                             f'length for K={kernel_size}, d={dilation}')
        self.K = kernel_size
        self.d = dilation
        self.lpad = lpad
        self.rpad = rpad
        self.groups = groups
        self.cin_pg = cin_pg
        self.cout_pg = cout_pg
        self.branches = tuple(branches)   # indices into the outputs list


class LinearNode:
    kind = 'linear'

    def __init__(self, branches):
        self.branches = tuple(branches)


class ZeroNode:
    kind = 'zero'

    def __init__(self, branches):
        self.branches = tuple(branches)


class FusedCellSpec:
    """Static description of a cell: its nodes, dropout, then LayerNorm or
    not.  Dropout applies only when ``train`` is set and the rate is
    positive (:attr:`dropping`); ``channel_offset`` is the whole cell's
    channel of this cell's channel 0 in the dropout hash (a tensor-parallel
    shard's first channel, 0 for a whole cell)."""

    def __init__(self, nodes, dropout_rate=0.0, train=False,
                 ln_eps=LN_EPS_DEFAULT, use_norm=True, channel_offset=0):
        if channel_offset < 0:
            raise ValueError(f'channel_offset={channel_offset} < 0')
        self.nodes = tuple(nodes)
        self.dropout_rate = float(dropout_rate)
        self.train = bool(train)
        self.ln_eps = float(ln_eps)
        self.use_norm = bool(use_norm)
        self.channel_offset = int(channel_offset)

    @property
    def dropping(self):
        return self.train and self.dropout_rate > 0.0


def keep_threshold(rate):
    """Keep iff the 32 random bits are below this (``_keep_threshold``)."""
    return min(int((1.0 - rate) * (1 << 32)), (1 << 32) - 1)


def inv_keep(rate):
    """The dropout multiplier ``1 / (1 - rate)`` rounded to f32."""
    return float(np.float32(1.0 / (1.0 - rate)))


def relu20_gate(a):
    """The VJP gate of ``clip(a, 0, 20)`` as ``jnp.clip`` gives it: 1 inside
    (0, 20), 0.5 at exactly 0 or 20, 0 outside; f32."""
    return torch.where((a > 0) & (a < 20), 1.0,
                       torch.where((a == 0) | (a == 20), 0.5, 0.0))


def _seed_words(seed):
    """The seed's two int32 words as uint32 Python ints."""
    if seed is None or tuple(seed.shape) != (2,):
        raise ValueError('a dropping cell needs an int32 seed of shape [2]')
    return [int(v) & _U32 for v in seed.tolist()]


def dropout_bits(seed, counter, B, T, C, device=None, c0=0):
    """``[B, T, C]`` int64 tensor of uint32 bits: the JAX kernel's
    interpret-mode hash (``_Prng.bits``) at ``i`` = t, ``j`` = ``c0`` + c,
    ``pid`` = batch row, for the ``counter``-th draw (1, 2, ... over the
    conv and linear nodes in node order); ``c0`` > 0 gives a channel shard's
    slice of the whole cell's bits.  int64 arithmetic masked to 32 bits after
    every multiply and add, which is uint32 arithmetic with wraparound; every
    shifted value is non-negative, so ``>>`` is the logical shift."""
    s0, s1 = _seed_words(seed)
    device = device or seed.device

    def ramp(n, dim):
        shape = [1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    const = ((s0 * 0xC2B2AE35) & _U32) ^ ((s1 + 0x27D4EB2F) & _U32) \
        ^ ((counter * 0x5851F42D) & _U32)
    x = (((ramp(T, 1) * 0x9E3779B1) & _U32)
         ^ (((ramp(C, 2) + c0) * 0x85EBCA6B) & _U32)
         ^ ((ramp(B, 0) * 0x165667B1) & _U32) ^ const)
    for shift in (15, 13, 16):
        x = x ^ (x >> shift)
        x = (x * 0x2545F491) & _U32
    return x ^ (x >> 16)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _device_kind(x):
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'the fused cell runs on cuda or cpu, not {x.device}')
    return x.device.type


def fused_cell_forward(spec, x, weights, ln, seed=None):
    """Run one cell; differentiable.

    ``x [B, T, C]`` f32 or bf16; ``weights``: flat per-node ``(w, b)`` in
    node order, zero nodes taking none — conv ``w`` compact ``[K, ci, C]``,
    linear ``w [C, C]``, both in ``x.dtype``, ``b [C]`` f32; ``ln``:
    ``(scale [C], bias [C])`` f32, ignored when ``spec.use_norm`` is False;
    ``seed``: int32 ``[2]`` on x's device, needed when ``spec.dropping``.
    Where a gradient is needed the call goes through :class:`FusedCell`.
    """
    kind = _device_kind(x)
    ln_scale, ln_bias = ln if spec.use_norm else (None, None)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, *weights, ln_scale, ln_bias)):
        return FusedCell.apply(spec, x, seed, ln_scale, ln_bias, *weights)
    if kind == 'cpu':
        _count_plain_linear(spec, x, weights)
        return fused_cell_reference(spec, x, weights, ln, seed)
    return _launch(spec, x, weights, ln, seed, save=False)[0]


def fused_cell_train_forward(spec, x, weights, ln, seed=None):
    """The forward that keeps what the backward needs: ``(y, outs, mults)``
    with ``outs [n_nodes, B, T, C]`` the node outputs and ``mults [n_nodes,
    B, T, C]`` each conv or linear node's multiplier, both in ``x.dtype``
    (a zero node's slot is not read).  Not differentiable."""
    if _device_kind(x) == 'cpu':
        _count_plain_linear(spec, x, weights)
        return fused_cell_reference(spec, x, weights, ln, seed, save=True)
    return _launch(spec, x, weights, ln, seed, save=True)


def fused_cell_backward(spec, x, outs, mults, dy, weights, ln):
    """``(dx, dweights, dln)`` of one cell from what
    :func:`fused_cell_train_forward` kept: ``dx`` in ``x.dtype``,
    ``dweights`` flat per-node ``(dW in x.dtype, db f32)``, ``dln``
    ``(dscale, dbias)`` f32 or None without LayerNorm."""
    if _device_kind(x) == 'cpu':
        _count_plain_linear(spec, x, weights)
        return fused_cell_backward_reference(spec, x, outs, mults, dy,
                                             weights, ln)
    return _launch_backward(spec, x, outs, mults, dy, weights, ln)


class FusedCell(torch.autograd.Function):
    """One cell with its fused backward.  Gradients for x, every weight and
    bias, and the LayerNorm scale and bias; the seed has none.  dW comes
    back in the weight operand's dtype (x's), as the JAX kernel's VJP gives
    it; the caller's ``.to(dtype)`` carries it to an f32 parameter."""

    @staticmethod
    def forward(ctx, spec, x, seed, ln_scale, ln_bias, *weights):
        ln = (ln_scale, ln_bias) if spec.use_norm else None
        y, outs, mults = fused_cell_train_forward(spec, x, weights, ln, seed)
        ctx.spec = spec
        ctx.save_for_backward(x, outs, mults, ln_scale, ln_bias, *weights)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, outs, mults, ln_scale, ln_bias, *weights = ctx.saved_tensors
        spec = ctx.spec
        ln = (ln_scale, ln_bias) if spec.use_norm else None
        dx, dweights, dln = fused_cell_backward(
            spec, x, outs, mults, dy.contiguous(), weights, ln)
        return (None, dx, None, *(dln or (None, None)), *dweights)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _conv_input(src, node):
    """``[B, T, C]`` -> ``[B, C, lpad + T + rpad]`` f32."""
    return F.pad(src.float().transpose(1, 2), (node.lpad, node.rpad))


def fused_cell_reference(spec, x, weights, ln, seed=None, save=False):
    """The plain PyTorch version of the forward kernel, with the same
    rounding points: f32 sums and bias, dropout on the clipped value in
    f32, node outputs rounded to ``x.dtype``, f32 LayerNorm statistics, the
    result rounded to ``x.dtype``.  ``save=True`` returns ``(y, outs,
    mults)`` as :func:`fused_cell_train_forward` does."""
    _build.count_launch(LAUNCHES, 'plain')
    B, T, C = x.shape
    n = len(spec.nodes)
    if spec.dropping:
        thr = keep_threshold(spec.dropout_rate)
        keep_scale = inv_keep(spec.dropout_rate)
    outs = [x]
    mults = torch.zeros((n, B, T, C), dtype=x.dtype, device=x.device) \
        if save else None
    wi = counter = 0
    for i, node in enumerate(spec.nodes):
        src = outs[-1]
        if node.kind == 'zero':
            total = torch.zeros((B, T, C), dtype=torch.float32,
                                device=x.device)
        else:
            w, b = weights[wi].float(), weights[wi + 1]
            wi += 2
            if node.kind == 'conv':
                acc = F.conv1d(_conv_input(src, node), w.permute(2, 1, 0),
                               dilation=node.d,
                               groups=node.groups).transpose(1, 2)
            else:
                acc = src.float() @ w
            acc = acc + b
            total = torch.clamp(acc, 0.0, 20.0)
            gate = relu20_gate(acc)
            if spec.dropping:
                counter += 1
                keep = dropout_bits(seed, counter, B, T, C, x.device,
                                    spec.channel_offset) < thr
                total = torch.where(keep, total * keep_scale, 0.0)
                gate = torch.where(keep, gate * keep_scale, 0.0)
            if save:
                mults[i] = gate.to(x.dtype)
        for j in node.branches:
            total = total + outs[j].float()
        outs.append(total.to(x.dtype))
    xf = outs[-1].float()
    if spec.use_norm:
        xf = _layer_norm(xf, ln, spec.ln_eps)
    y = xf.to(x.dtype)
    if save:
        return y, torch.stack(outs[1:]), mults
    return y


def _layer_norm(xf, ln, eps):
    """The forward's LayerNorm of f32 rows: two-pass f32 statistics (the
    mean, then the mean of squared deviations), as the JAX kernel."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * ln[0] + ln[1]


def fused_cell_backward_reference(spec, x, outs, mults, dy, weights, ln):
    """The plain PyTorch version of the backward kernel, written out with
    the JAX kernel's rounding points: the saved multipliers, gradient
    buffers in f32, db from the f32 ``dz``, ``dz`` rounded to x's dtype
    before the dW and dx products, dW rounded to x's dtype, dx rounded to
    x's dtype.  Returns what :func:`fused_cell_backward` returns."""
    _build.count_launch(BACKWARD_LAUNCHES, 'plain')
    B, T, C = x.shape
    n = len(spec.nodes)
    inputs = [x] + list(outs.unbind(0))
    dyf = dy.float()
    dln = None
    if spec.use_norm:
        xf = inputs[n].float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + spec.ln_eps)
        xhat = (xf - mu) * inv
        dln = ((dyf * xhat).sum(dim=(0, 1)), dyf.sum(dim=(0, 1)))
        dxhat = dyf * ln[0]
        g_last = (dxhat - dxhat.sum(dim=-1, keepdim=True) / C
                  - xhat * ((dxhat * xhat).sum(dim=-1, keepdim=True) / C)) * inv
    else:
        g_last = dyf
    g = [torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
         for _ in range(n)] + [g_last]
    starts, wi = [], 0
    for node in spec.nodes:
        starts.append(wi)
        wi += 0 if node.kind == 'zero' else 2
    dweights = [None] * len(weights)
    for i in reversed(range(n)):
        node = spec.nodes[i]
        dtotal = g[i + 1]
        for j in node.branches:
            g[j] = g[j] + dtotal
        if node.kind == 'zero':
            continue
        dz = dtotal * mults[i].float()
        wi = starts[i]
        dweights[wi + 1] = dz.sum(dim=(0, 1))
        dzc = dz.to(x.dtype).float()
        w = weights[wi].float()
        if node.kind == 'linear':
            src = inputs[i].float().reshape(-1, C)
            dw = src.T @ dzc.reshape(-1, C)
            contrib = dzc @ w.T
        else:
            xp = _conv_input(inputs[i], node)
            dzt = dzc.transpose(1, 2)
            wt = w.permute(2, 1, 0)
            dw = torch.nn.grad.conv1d_weight(
                xp, wt.shape, dzt, dilation=node.d,
                groups=node.groups).permute(2, 1, 0)
            contrib = torch.nn.grad.conv1d_input(
                xp.shape, wt, dzt, dilation=node.d, groups=node.groups)
            contrib = contrib[:, :, node.lpad:node.lpad + T].transpose(1, 2)
        dweights[wi] = dw.to(x.dtype)
        g[i] = g[i] + contrib
    return g[0].to(x.dtype), dweights, dln


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def dx_outputs(desc):
    """Per node of a forward descriptor (:func:`_describe`'s ints), where a
    conv node's dx goes (None for other nodes): ``DX_ADD`` where a node
    names it among its branches (node m names only j <= m, so those adds
    reach g[j] before node j's own dx), else ``DX_STORE``, or ``DX_OUT``
    for node 0, whose sums then round straight into dx."""
    n = len(desc) // _DESC
    named = 0
    for i in range(n):
        named |= desc[i * _DESC + 6]
    return [None if desc[i * _DESC] != _KIND['conv'] else
            DX_ADD if named >> i & 1 else DX_OUT if i == 0 else DX_STORE
            for i in range(n)]


def forward_plans(desc, B, T, C, esize, src_align, out_align, sms=132,
                  blocks_per_sm=grouped_conv.estimated_blocks_per_sm):
    """Per node of a forward descriptor (:func:`_describe`'s ints), the
    conv node's launch plan in the forward kernel, None for other nodes.

    A conv node runs the grouped forward's body on its dense ``[B, T, C]``
    input seen as the ``[B, c, T, G]`` view (strides ``(T*C, 1, C, c)``):
    :func:`grouped_conv.fwd_plan` of that conv with an f32 output tile
    (``y_esize`` 4: the epilogue leaves f32 values there, and a store pass
    adds the branches and rounds), the staged input at ``src_align[i]``
    bytes past 16, and the store pass's alignment ``out_align[i]`` (0, 8 or
    4: vectors of 4, 2 or 1 elements, :func:`_store_align`); in f32 from
    :data:`F32_TILES`; with :data:`MIN_BLOCKS` resident blocks an SM where
    a plan has them.  ``blocks_per_sm(kt, ot, threads, smem)`` gives
    resident blocks per SM (the card's occupancy calculator, or the CPU's
    estimate)."""
    out = []
    for i in range(len(desc) // _DESC):
        kind, K, d, _, ci, co, _ = desc[i * _DESC:(i + 1) * _DESC]
        if kind != _KIND['conv']:
            out.append(None)
            continue
        st = (T * C, 1, C, ci)
        out.append(grouped_conv.fwd_plan(
            B, T, C // ci, ci, co, K, d, esize, st, st, src_align[i],
            out_align[i], sms, blocks_per_sm, y_esize=4,
            reg_tiles=F32_TILES if esize == 4 else None,
            min_blocks=MIN_BLOCKS))
    return out


def _store_align(ptrs, esize):
    """The f32 plan's output alignment for the store pass, whose vectors of
    4, 2 or 1 elements read and write the tensors at ``ptrs``: 0 where
    every one lies on 4 elements, 8 on 2, else 4 (one f32 a vector)."""
    for n, align in ((4, 0), (2, 8)):
        if all(p % (n * esize) == 0 for p in ptrs):
            return align
    return 4


def linear_path(esize, C, aligned):
    """A linear node's path: :data:`LINEAR_MMA` in bf16 (``esize`` 2) where
    C % 8 == 0 (TMA's rows of 16 bytes) and ``aligned`` (every operand on
    16 bytes), else :data:`LINEAR_FMA`."""
    return LINEAR_MMA if esize == 2 and C % 8 == 0 and aligned else LINEAR_FMA


def dw_chunks(rows, C, sms=132):
    """Row chunks of a tensor-core dW: enough that tiles x chunks fill the
    card's ``sms`` SMs about once at :data:`MMA_BLOCKS_PER_SM` blocks an SM,
    each chunk keeping :data:`DW_MIN_K_TILES` k tiles; 1 where the tiles
    alone fill them."""
    tiles = -(-C // MMA_TILE[0]) * -(-C // MMA_TILE[1])
    k_tiles = -(-rows // MMA_TILE_K)
    return max(1, min(sms * MMA_BLOCKS_PER_SM // tiles,
                      k_tiles // DW_MIN_K_TILES))


def linear_plans(desc, rows, C, esize, aligned, sms=132):
    """Per node of a descriptor (:func:`_describe`'s ints), a linear
    node's plan, None for other nodes: ``{'path': ..., 'chunks': ...}``,
    the path by :func:`linear_path` with ``aligned[i]`` (node i's operands
    on 16 bytes), the chunks of its dW's rows by :func:`dw_chunks` on the
    tensor cores (1 on FMAs).  ``rows`` is B * T."""
    out = []
    for i in range(len(desc) // _DESC):
        if desc[i * _DESC] != _KIND['linear']:
            out.append(None)
            continue
        path = linear_path(esize, C, aligned[i])
        out.append(dict(path=path, chunks=dw_chunks(rows, C, sms)
                        if path == LINEAR_MMA else 1))
    return out


def _count_linear(plans):
    """Count each linear node's call (its plan; None for other nodes)
    under its path's tracing counter."""
    for plan in plans:
        if plan is not None:
            tracing.count('cell.linear_mma' if plan['path'] == LINEAR_MMA
                          else 'cell.linear_fma')


def _count_plain_linear(spec, x, weights):
    """The counters of a call of the plain versions: the path the kernels
    would take for x's dtype and width, the operands on 16 bytes where x's
    and the linear weights' storage lies there."""
    if not tracing.is_enabled():
        return
    wi, plans = 0, []
    for node in spec.nodes:
        if node.kind == 'linear':
            aligned = x.data_ptr() % 16 == 0 and weights[wi].data_ptr() % 16 == 0
            plans.append(dict(path=linear_path(x.element_size(), x.shape[-1],
                                               aligned)))
        wi += 0 if node.kind == 'zero' else 2
    _count_linear(plans)


def _estimated_dx_blocks(f32_out, *args):
    return grouped_conv.estimated_blocks_per_sm(*args)


def backward_plans(desc, B, T, C, esize, src_align, out_align, sms=132,
                   dw_blocks_per_sm=grouped_conv.estimated_blocks_per_sm,
                   dx_blocks_per_sm=_estimated_dx_blocks):
    """Per node, ``(dx output, dW plan, dx plan)`` of a conv node's
    launches in the backward kernel, None for other nodes.

    The backward runs the grouped conv's dW and dx kernels on the dense
    ``[B, T, C]`` tensors seen as the ``[B, c, T, G]`` view (strides
    ``(T*C, 1, C, c)``): the dW plan is :func:`grouped_conv.dw_plan` of src
    (node i's input, at ``src_align[i]`` bytes past 16) and dzc, the dx
    plan :func:`grouped_conv.fwd_plan` of the conv on dzc (the dims
    swapped, as ``grouped_conv._PLANS['dx']``) into dx (``out_align``) or
    into an f32 gradient buffer (``y_esize`` 4).  The workspace's dzc and
    gradient buffers lie on 16 bytes.  ``dw_blocks_per_sm(kt, ot,
    threads, smem)`` and ``dx_blocks_per_sm(f32_out, kt, ot, threads,
    smem)`` give resident blocks per SM (the card's occupancy calculator,
    or the CPU's estimate)."""
    out = []
    for i, mode in enumerate(dx_outputs(desc)):
        if mode is None:
            out.append(None)
            continue
        _, K, d, _, ci, co, _ = desc[i * _DESC:(i + 1) * _DESC]
        G = C // ci
        xst, zst = (T * C, 1, C, ci), (T * C, 1, C, co)
        dw = grouped_conv.dw_plan(B, T, G, ci, co, K, d, esize, xst, zst,
                                  src_align[i], 0, sms, dw_blocks_per_sm)
        dx = grouped_conv.fwd_plan(
            B, T, G, co, ci, K, d, esize, zst, xst, 0,
            out_align if mode == DX_OUT else 0, sms,
            functools.partial(dx_blocks_per_sm, int(mode != DX_OUT)),
            y_esize=esize if mode == DX_OUT else 4)
        out.append((mode, dw, dx))
    return out


_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_FWD_ARGS = ([ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int), _PP, _PP]
             + [_P] * 5 + [ctypes.c_int, ctypes.c_float, _P, ctypes.c_uint,
                           ctypes.c_float, ctypes.c_int, _P, _P])
_BWD_ARGS = ([ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int), _PP]
             + [_P] * 5 + [ctypes.c_int, ctypes.c_float, _P, _PP, _PP, _P, _P,
                           _P, _P])
_WORKSPACE_ARGS = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]


def _check(t, name, shape, dtype, device):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f'{name}: expected a contiguous {dtype} tensor of '
                         f'shape {tuple(shape)} on {device}, got {t.dtype} '
                         f'{tuple(t.shape)} on {t.device}')


def _refuse_detach(tensors):
    """A launch makes tensors with no ``grad_fn``: where autograd would need
    one, refuse rather than cut the graph silently."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError('the fused cell kernel would detach an input that '
                           'needs a gradient; call fused_cell_forward, which '
                           'goes through FusedCell')


def _describe(spec, x, weights):
    """(desc ints, weight pointers, bias pointers) after checking every
    operand as the kernels take it."""
    B, T, C = x.shape
    n = len(spec.nodes)
    if not 1 <= n <= _MAX_NODES:
        raise ValueError(f'the fused cell kernels take 1..{_MAX_NODES} '
                         f'nodes, got {n}')
    desc, wptrs, bptrs = [], [], []
    wi = 0
    for i, node in enumerate(spec.nodes):
        if any(not 0 <= j <= i for j in node.branches):
            raise ValueError(f'node {i}: branches {node.branches} must '
                             f'index outputs 0..{i}')
        mask = sum(1 << j for j in set(node.branches))
        if node.kind == 'zero':
            desc += [_KIND['zero'], 0, 0, 0, 0, 0, mask]
            wptrs.append(None)
            bptrs.append(None)
            continue
        w, b = weights[wi], weights[wi + 1]
        wi += 2
        if node.kind == 'conv':
            if node.groups * node.cin_pg != C or node.groups * node.cout_pg != C:
                raise ValueError(f'node {i}: {node.groups} groups of '
                                 f'{node.cin_pg}/{node.cout_pg} do not make '
                                 f'C={C}')
            _check(w, f'node {i} weight', (node.K, node.cin_pg, C), x.dtype,
                   x.device)
            desc += [_KIND['conv'], node.K, node.d, node.lpad, node.cin_pg,
                     node.cout_pg, mask]
        else:
            _check(w, f'node {i} weight', (C, C), x.dtype, x.device)
            desc += [_KIND['linear'], 0, 0, 0, 0, 0, mask]
        _check(b, f'node {i} bias', (C,), torch.float32, x.device)
        wptrs.append(w.data_ptr())
        bptrs.append(b.data_ptr())
    return desc, wptrs, bptrs


def _ln_ptrs(spec, ln, x, which=(0, 1)):
    if not spec.use_norm:
        return [None] * len(which)
    C = x.shape[-1]
    for i in which:
        _check(ln[i], ('ln scale', 'ln bias')[i], (C,), torch.float32,
               x.device)
    return [ln[i].data_ptr() for i in which]


@functools.lru_cache(maxsize=4096)
def _forward_launch(device, desc, B, T, C, esize, src_align, out_align,
                    linear_aligned):
    """(the forward descriptor's ints, the linear plans) of one cell on
    ``device``: conv plans by :func:`forward_plans` on the card's SMs and
    occupancy calculator, linear paths by :func:`linear_plans`.  Kept per
    spec, shape, dtype, device and pointer alignment, so that a step plans
    each cell shape once."""
    sms = grouped_conv._sm_count(device)
    plans = forward_plans(
        desc, B, T, C, esize, src_align, out_align, sms, functools.partial(
            grouped_conv._blocks_per_sm, device, 'fused_cell',
            'nbasr_fused_conv_fwd_blocks_per_sm', int(esize == 2)))
    linear = linear_plans(desc, B * T, C, esize, linear_aligned, sms)
    ints = forward_desc_ints(desc, plans, linear)
    return (ctypes.c_int * len(ints))(*ints), linear


def forward_desc_ints(desc, plans, linear):
    """The forward kernel's descriptor: per node its seven ints, then a
    conv node's plan (``plans[i]``, FWD_PLAN_FIELDS) or a linear node's
    path (``linear[i]``), zeros to :data:`FWD_DESC_INTS`."""
    ints = []
    for i, plan in enumerate(plans):
        ints += desc[i * _DESC:(i + 1) * _DESC]
        tail = ([plan[k] for k in grouped_conv.FWD_PLAN_FIELDS]
                if plan is not None else
                [linear[i]['path']] if linear[i] is not None else [])
        ints += tail + [0] * (FWD_DESC_INTS - _DESC - len(tail))
    return ints


def _launch(spec, x, weights, ln, seed, save):
    """The forward kernel: ``(y, outs, mults)``, the last two None unless
    ``save``."""
    _refuse_detach([x, *weights, *(ln or ())])
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'the fused cell kernel takes f32 or bf16, '
                         f'not {x.dtype}')
    B, T, C = x.shape
    _check(x, 'x', (B, T, C), x.dtype, x.device)
    desc, wptrs, bptrs = _describe(spec, x, weights)
    ln_ptrs = _ln_ptrs(spec, ln, x)
    n = len(spec.nodes)
    # a conv node reads its bias in 16-byte vectors: an aligned copy of one
    # that is not, kept alive through the launch
    copies, wi = [], 0
    for i, node in enumerate(spec.nodes):
        if node.kind != 'zero':
            if node.kind == 'conv' and bptrs[i] % 16:
                copies.append(weights[wi + 1].clone())
                bptrs[i] = copies[-1].data_ptr()
            wi += 2
    if spec.dropping:
        _check(seed, 'seed', (2,), torch.int32, x.device)
        seed_ptr = seed.data_ptr()
        thr, keep_scale = keep_threshold(spec.dropout_rate), inv_keep(
            spec.dropout_rate)
    else:
        seed_ptr, thr, keep_scale = None, 0, 1.0
    scratch = torch.empty((n, B, T, C), dtype=x.dtype, device=x.device)
    mults = torch.empty_like(scratch) if save else None
    y = torch.empty_like(x)
    # each node's input and output, as the kernel addresses them
    esize = x.element_size()
    ptrs = [x.data_ptr()] + [scratch.data_ptr() + i * B * T * C * esize
                             for i in range(n)]
    if not spec.use_norm:
        ptrs[n] = y.data_ptr()
    out_align = tuple(
        _store_align([ptrs[i + 1]] + [ptrs[j] for j in set(node.branches)],
                     esize) for i, node in enumerate(spec.nodes))
    # a linear node's operands on 16 bytes: its input, output, branches,
    # weight and multipliers
    linear_aligned = tuple(
        node.kind == 'linear' and all(p % 16 == 0 for p in (
            ptrs[i], ptrs[i + 1], wptrs[i], *(ptrs[j] for j in node.branches),
            *((mults.data_ptr() + i * B * T * C * esize,) if save else ())))
        for i, node in enumerate(spec.nodes))
    desc_arr, linear = _forward_launch(
        x.device, tuple(desc), B, T, C, esize, tuple(p % 16 for p in ptrs[:n]),
        out_align, linear_aligned)
    _count_linear(linear)
    fn = _build.function('fused_cell', 'nbasr_fused_cell_forward', _FWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(int(x.dtype == torch.bfloat16), B, T, C, n, desc_arr,
                 (ctypes.c_void_p * n)(*wptrs), (ctypes.c_void_p * n)(*bptrs),
                 x.data_ptr(), scratch.data_ptr(), y.data_ptr(), *ln_ptrs,
                 int(spec.use_norm), spec.ln_eps, seed_ptr, thr, keep_scale,
                 spec.channel_offset, mults.data_ptr() if save else None,
                 stream)
    _build.check(err, 'fused_cell', 'fused cell forward')
    _build.count_launch(LAUNCHES, 'kernel')
    return (y, scratch, mults) if save else (y, None, None)


@functools.lru_cache(maxsize=4096)
def _backward_launch(device, desc, B, T, C, esize, src_align, out_align,
                     linear_aligned):
    """(the backward descriptor's ints, workspace floats, the linear
    plans) of one cell on ``device``: conv plans by :func:`backward_plans`
    on the card's SMs and occupancy calculator, linear paths and dW chunks
    by :func:`linear_plans`.  Kept per spec, shape, dtype, device and
    pointer alignment, so that a train step plans each cell shape once."""
    def occupancy(kernel):
        return functools.partial(
            grouped_conv._blocks_per_sm, device, 'fused_cell_bwd',
            f'nbasr_fused_conv_{kernel}_blocks_per_sm', int(esize == 2))

    sms = grouped_conv._sm_count(device)
    plans = backward_plans(desc, B, T, C, esize, src_align, out_align, sms,
                           occupancy('dw'), occupancy('dx'))
    linear = linear_plans(desc, B * T, C, esize, linear_aligned, sms)
    ints = backward_desc_ints(desc, plans, linear)
    arr = (ctypes.c_int * len(ints))(*ints)
    size = _build.function('fused_cell_bwd',
                           'nbasr_fused_cell_backward_workspace',
                           _WORKSPACE_ARGS, ctypes.c_longlong)
    return arr, size(B, T, C, len(plans), arr), linear


def backward_desc_ints(desc, plans, linear):
    """The backward kernel's descriptor: per node its seven ints, then a
    conv node's dx output, dW plan and dx plan (``plans[i]``), or a linear
    node's path and dW row chunks (``linear[i]``), zeros to
    :data:`BWD_DESC_INTS`."""
    ints = []
    for i, plan in enumerate(plans):
        ints += desc[i * _DESC:(i + 1) * _DESC]
        if plan is None:
            tail = ([] if linear[i] is None else
                    [linear[i]['path'], linear[i]['chunks']])
            ints += tail + [0] * (BWD_DESC_INTS - _DESC - len(tail))
            continue
        mode, dw, dx = plan
        ints += ([mode] + [dw[k] for k in grouped_conv.DW_PLAN_FIELDS]
                 + [dx[k] for k in grouped_conv.FWD_PLAN_FIELDS])
    return ints


def _launch_backward(spec, x, outs, mults, dy, weights, ln):
    B, T, C = x.shape
    n = len(spec.nodes)
    for t, name in ((x, 'x'), (dy, 'dy')):
        _check(t, name, (B, T, C), x.dtype, x.device)
    for t, name in ((outs, 'outs'), (mults, 'mults')):
        _check(t, name, (n, B, T, C), x.dtype, x.device)
    desc, wptrs, _ = _describe(spec, x, weights)
    (scale_ptr,) = _ln_ptrs(spec, ln, x, which=(0,))
    dx = torch.empty_like(x)
    esize = x.element_size()
    src = [x.data_ptr()] + [outs.data_ptr() + i * B * T * C * esize
                            for i in range(n - 1)]
    # a linear node's operands on 16 bytes: its input and weight (dz, the
    # gradient buffers and the partials lie in the workspace, dW is new)
    linear_aligned = tuple(
        node.kind == 'linear' and src[i] % 16 == 0 and wptrs[i] % 16 == 0
        for i, node in enumerate(spec.nodes))
    desc_arr, size, linear = _backward_launch(
        x.device, tuple(desc), B, T, C, esize, tuple(p % 16 for p in src),
        dx.data_ptr() % 16, linear_aligned)
    _count_linear(linear)
    fn = _build.function('fused_cell_bwd', 'nbasr_fused_cell_backward',
                         _BWD_ARGS)
    work = torch.empty((size,), dtype=torch.float32, device=x.device)
    dweights, dwptrs, dbptrs = [], [], []
    for w in weights:      # per node: dW like its weight, db f32 like its bias
        dweights.append(torch.empty_like(w))
    wi = 0
    for node in spec.nodes:
        if node.kind == 'zero':
            dwptrs.append(None)
            dbptrs.append(None)
            continue
        dwptrs.append(dweights[wi].data_ptr())
        dbptrs.append(dweights[wi + 1].data_ptr())
        wi += 2
    dln = (torch.empty((C,), dtype=torch.float32, device=x.device),
           torch.empty((C,), dtype=torch.float32, device=x.device)) \
        if spec.use_norm else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(int(x.dtype == torch.bfloat16), B, T, C, n, desc_arr,
                 (ctypes.c_void_p * n)(*wptrs), x.data_ptr(), outs.data_ptr(),
                 mults.data_ptr(), dy.data_ptr(), scale_ptr,
                 int(spec.use_norm), spec.ln_eps, dx.data_ptr(),
                 (ctypes.c_void_p * n)(*dwptrs), (ctypes.c_void_p * n)(*dbptrs),
                 dln[0].data_ptr() if dln else None,
                 dln[1].data_ptr() if dln else None, work.data_ptr(), stream)
    _build.check(err, 'fused_cell_bwd', 'fused cell backward')
    _build.count_launch(BACKWARD_LAUNCHES, 'kernel')
    return dx, dweights, dln
