"""The LSTM recurrence on the card: one persistent kernel launch forward
and one backward, their plain versions, and their launch plan.

Source note.  The kernels (``nbasr_lstm_fwd`` and ``nbasr_lstm_bwd`` of
``nbasr_torch/csrc/lstm.cu``, whose header states the bound and the design)
replace no TPU kernel: ``nbasr_tpu/models/lstm.py`` ``FastLSTM`` runs its
recurrence as a ``lax.scan``, which XLA compiles into one loop on the TPU.
They were added because the port's loop of PyTorch ops launched about 14
kernels a frame forward and 23 backward, which made the LSTM the largest
host cost of a train step and of a serving step.

:func:`lstm_recurrence` takes ``xw = x @ kernel + bias`` ``[B, T, 4H]`` and
``rec`` ``[H, 4H]`` (Keras gate order i, f, g, o) in the compute dtype, and
the carry ``(c0, h0)`` or None for zeros, and returns ``out [B, T, H]`` and
the final ``(c, h)``.  With grad enabled it runs under an autograd Function
whose forward saves the gate activations and ``c`` a frame, and whose
backward returns ``dxw = dgates``, ``drec = h_prev^T @ dgates`` (one matrix
product after the kernel) and the carry's gradients.  A CUDA tensor goes to
the kernels (float32 or bfloat16; anything else raises), a CPU tensor to the
plain versions: :func:`recurrence_reference`, the loop the module ran
before, op for op, and :func:`recurrence_backward_reference`, its analytic
backward.  Nothing falls back from one to the other.  ``LAUNCHES`` counts
the calls of each.  :func:`recurrence_plan` splits the units and the batch
over the card's SMs, pure and tested on the CPU; the kernels check it again.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ['lstm_recurrence', 'recurrence_reference',
           'recurrence_backward_reference', 'recurrence_plan', 'rec_blocks',
           'LAUNCHES', 'reset_launches', 'PLAN_FIELDS']

#: Calls of the kernel (``'kernel'``) and of the plain version
#: (``'plain'``) of each direction since the last :func:`reset_launches`.
LAUNCHES = {name: {'kernel': 0, 'plain': 0} for name in ('forward', 'backward')}


def reset_launches():
    for counts in LAUNCHES.values():
        counts.update(kernel=0, plain=0)


def _device_kind(x):
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'the LSTM recurrence runs on cuda or cpu, not '
                         f'{x.device}')
    return x.device.type


def _acc(dtype):
    """The sums' dtype: float32 for bf16 and f32 operands (the module's
    ``preferred_element_type``), float64 for float64 ones."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def lstm_recurrence(xw, rec, c0=None, h0=None):
    """``xw [B, T, 4H]``, ``rec [H, 4H]``, ``c0``/``h0 [B, H]`` or None ->
    ``(out [B, T, H], (c, h))``, all in ``xw``'s dtype."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (xw, rec, c0, h0))
    if needs_grad:
        out, c, h = _Recurrence.apply(xw, rec, c0, h0)
    else:
        out, c, h, _ = _forward(xw, rec, c0, h0, save=False)
    return out, (c, h)


def _forward(xw, rec, c0, h0, save):
    if _device_kind(xw) == 'cpu':
        return recurrence_reference(xw, rec, c0, h0, save=save)
    return _launch_forward(xw, rec, c0, h0, save)


def _backward(acts, cs, rec, c0, dout, dc, dh, need_h0):
    if _device_kind(acts) == 'cpu':
        return recurrence_backward_reference(acts, cs, rec, c0, dout, dc, dh,
                                             need_h0=need_h0)
    return _launch_backward(acts, cs, rec, c0, dout, dc, dh, need_h0)


class _Recurrence(torch.autograd.Function):
    """The recurrence with its analytic backward (kernel or plain)."""

    @staticmethod
    def forward(ctx, xw, rec, c0, h0):
        out, c, h, (acts, cs) = _forward(xw, rec, c0, h0, save=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(rec, c0, h0, out, acts, cs)
        return out, c, h

    @staticmethod
    def backward(ctx, dout, dc, dh):
        rec, c0, h0, out, acts, cs = ctx.saved_tensors
        need_xw, need_rec, need_c0, need_h0 = ctx.needs_input_grad
        dgates, dc0, dh0 = _backward(acts, cs, rec, c0, dout, dc, dh,
                                     need_h0)
        drec = None
        if need_rec:
            H = rec.shape[0]
            acc = _acc(rec.dtype)
            h_prev = out[:, :-1]
            h_prev = (F.pad(h_prev, (0, 0, 1, 0)) if h0 is None
                      else torch.cat([h0[:, None], h_prev], dim=1))
            drec = (h_prev.reshape(-1, H).to(acc).T
                    @ dgates.reshape(-1, 4 * H).to(acc)).to(rec.dtype)
        return (dgates if need_xw else None, drec,
                dc0 if need_c0 else None, dh0 if need_h0 else None)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def recurrence_reference(xw, rec, c0=None, h0=None, save=False):
    """The plain version of the forward kernel: the loop ``FastLSTM`` ran
    before, op for op (bit-equal to it), returning ``(out, c, h, saved)``;
    ``saved`` is ``(acts [B, T, 4H], cs [B, T, H])`` with ``save``, else
    ``()``."""
    _build.count_launch(LAUNCHES['forward'], 'plain')
    B, T, H4 = xw.shape
    dt = xw.dtype
    rec_f = rec.to(_acc(dt))
    zeros = (torch.zeros((B, H4 // 4), dtype=dt, device=xw.device)
             if c0 is None or h0 is None else None)
    c = zeros if c0 is None else c0
    h = zeros if h0 is None else h0
    hs, acts, cs = [], [], []
    for t in range(T):
        gates = xw[:, t] + (h.to(rec_f.dtype) @ rec_f).to(dt)
        i, f, g, o = gates.chunk(4, dim=-1)
        si, sf, tg, so = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
        c = sf * c + si * tg
        h = so * torch.tanh(c)
        hs.append(h)
        if save:
            acts.append(torch.cat([si, sf, tg, so], dim=-1))
            cs.append(c)
    out = torch.stack(hs, dim=1)
    saved = (torch.stack(acts, dim=1), torch.stack(cs, dim=1)) if save else ()
    return out, c, h, saved


def recurrence_backward_reference(acts, cs, rec, c0, dout, dc=None, dh=None,
                                  need_h0=True):
    """The plain version of the backward kernel: from the forward's saved
    ``acts`` and ``cs``, ``c0`` (None for zeros) and the gradients of
    ``out``, the final ``c`` and ``h`` (each None for zeros) ->
    ``(dgates [B, T, 4H], dc0, dh0)`` in the compute dtype (``dh0`` None
    unless ``need_h0``).  Sums and the running ``dc``/``dh`` in f32 (the
    inputs' dtype if wider); ``dgates`` rounded to the compute dtype once,
    as the kernel stores them."""
    _build.count_launch(LAUNCHES['backward'], 'plain')
    B, T, H4 = acts.shape
    H = H4 // 4
    dt = acts.dtype
    acc = _acc(dt)
    rec_t = rec.to(acc).T
    dc = (torch.zeros((B, H), dtype=acc, device=acts.device) if dc is None
          else dc.to(acc))
    dh_next = (torch.zeros((B, H), dtype=acc, device=acts.device)
               if dh is None else dh.to(acc))
    dgs = [None] * T
    for t in reversed(range(T)):
        dh_t = dh_next if dout is None else dout[:, t].to(acc) + dh_next
        i, f, g, o = acts[:, t].to(acc).chunk(4, dim=-1)
        c = cs[:, t].to(acc)
        if t > 0:
            c_prev = cs[:, t - 1].to(acc)
        else:
            c_prev = (torch.zeros_like(c) if c0 is None else c0.to(acc))
        tc = torch.tanh(c)
        d_o = dh_t * tc
        dc = dc + dh_t * o * (1 - tc * tc)
        d_i, d_f, d_g = dc * g, dc * c_prev, dc * i
        dgs[t] = torch.cat([d_i * i * (1 - i), d_f * f * (1 - f),
                            d_g * (1 - g * g), d_o * o * (1 - o)],
                           dim=-1).to(dt)
        dc = dc * f
        if t > 0 or need_h0:
            dh_next = dgs[t].to(acc) @ rec_t
    return (torch.stack(dgs, dim=1), dc.to(dt),
            dh_next.to(dt) if need_h0 else None)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

#: Threads a block (``kThreads`` of ``lstm.cu``), and its warps.
THREADS = 256
WARPS = THREADS // 32
#: The shared memory a block of an H100 may opt in to, and its SMs: the
#: defaults of :func:`recurrence_plan` where no card is asked.
H100_SHARED_LIMIT = 232448
H100_SMS = 132
PLAN_FIELDS = ('U', 'nb_u', 'BB', 'nb_b', 'BT', 'S', 'Kp', 'Cp', 'ld',
               'rec_smem', 'mma', 'smem')


def _round_up(n, m):
    return -(-n // m) * m


def _splits(tiles, workers, steps):
    """How many workers (threads or warps) share an output tile's k: the
    most, a power of two, with every worker at work at most once and two
    k steps a worker at least."""
    S = 1
    while tiles * S * 2 <= workers and 2 * S * 2 <= steps:
        S *= 2
    return S


def _layout(K, U, cols, BT, mma, rec_smem):
    """(Kp, Cp, ld, S, smem bytes) of a tile of BT rows: the mma path in
    bf16 (k in steps of 16, 16 x 8 output tiles a warp, op and rec in bf16
    rows of ld = Kp + 8, an odd multiple of 16 bytes, for ldmatrix), else
    f32 FMAs (k in quads, 4 x 4 output tiles a thread, rows of ld floats
    four banks apart)."""
    if mma:
        Kp, Cp = _round_up(K, 16), _round_up(cols * U, 8)
        ld = Kp + 8
        tiles = (BT // 16) * (Cp // 8)
        S = _splits(tiles, WARPS, Kp // 16)
        floats = 128 * tiles * S + (BT * ld + Cp * ld) // 2
    else:
        Kp, Cp = _round_up(K, 4), _round_up(cols * U, 4)
        ld = Kp + (4 - Kp) % 32
        tiles = (BT // 4) * (Cp // 4)
        S = _splits(tiles, THREADS, Kp // 4)
        floats = 16 * tiles * S + BT * ld + (Kp * Cp if rec_smem else 0)
    return Kp, Cp, ld, S, 4 * floats


def recurrence_plan(B, H, esize, backward=False, sms=H100_SMS,
                    smem_limit=H100_SHARED_LIMIT):
    """The kernel's launch for ``B`` rows and ``H`` units in ``esize``-byte
    elements on a card of ``sms`` SMs whose blocks may opt in to
    ``smem_limit`` bytes of shared memory.

    A block owns ``U`` units (``nb_u`` slices) of ``BB`` rows (``nb_b``
    slices); ``nb_u * nb_b <= sms``.  Its slice of rec is ``Kp`` rows (K = H
    forward, 4H backward, padded) by ``Cp`` columns (4U gate columns
    forward, U rows of rec backward, padded); it sits in shared memory
    (``rec_smem``) beside a tile of ``BT`` rows of h (dgates) at ``ld``
    elements a row and the partials of ``S`` workers an output tile, in
    ``smem`` bytes.  bf16 (``esize`` 2) runs on the tensor cores (``mma``)
    where its tile fits, f32 on FMAs; a tile holds at most ``THREADS / U``
    rows (one (row, unit) a thread).  Picked by an estimate of a frame's
    cycles in a block (L2 bytes at 32 a cycle, FMAs at 128 or 1024, 400 a
    tile pass); a shape with no tile that fits is refused (ValueError)."""
    if B < 1 or H < 1:
        raise ValueError(f'no recurrence of {B} rows and {H} units')
    K, cols = (4 * H, 1) if backward else (H, 4)
    best = None
    nb_b = 1
    while True:
        BB = -(-B // nb_b)
        nbb = -(-B // BB)
        if nbb > sms:
            break
        U = -(-H // (sms // nbb))
        nb_u = -(-H // U)
        layouts = [(True, 1, 16)] if esize == 2 else []
        for mma, rec_smem, step in layouts + [(False, 1, 4), (False, 0, 4)]:
            BT = min(_round_up(BB, step), THREADS // U // step * step)
            while BT >= step and _layout(K, U, cols, BT, mma,
                                         rec_smem)[4] > smem_limit:
                BT -= step
            if BT >= step:
                break
        else:
            BT = 0
        if BT:
            Kp, Cp, ld, S, smem = _layout(K, U, cols, BT, mma, rec_smem)
            passes = -(-BB // BT)
            streamed = 0 if rec_smem else passes * 4 * Kp * Cp
            rate = 1024 if mma else 128
            cycles = ((BB * K * esize + streamed) / 32
                      + _round_up(BB, step) * Kp * Cp / rate + 400 * passes)
            plan = dict(U=U, nb_u=nb_u, BB=BB, nb_b=nbb, BT=BT, S=S, Kp=Kp,
                        Cp=Cp, ld=ld, rec_smem=rec_smem, mma=int(mma),
                        smem=smem)
            key = (cycles, nb_u * nbb)
            if best is None or key < best[0]:
                best = (key, plan)
        if BB == 1:
            break
        nb_b *= 2
    if best is None:
        raise ValueError(f'a recurrence of {H} units: no tile of rows of '
                         f'{K} fits {smem_limit} bytes of shared memory')
    return best[1]


@functools.lru_cache(maxsize=None)
def _card(device):
    """(SMs, opt-in shared memory of a block) of a CUDA device, read
    once."""
    with torch.cuda.device(device):
        sms = _build.function('lstm', 'nbasr_lstm_sm_count', [])()
        limit = _build.function('lstm', 'nbasr_lstm_shared_limit', [])()
    if sms < 1 or limit < 0:
        raise RuntimeError(f'could not read the SMs and shared memory of '
                           f'{device}')
    return sms, limit


def device_plan(B, H, dtype, device, backward):
    """:func:`recurrence_plan` on a CUDA device's card."""
    sms, limit = _card(device)
    return recurrence_plan(B, H, torch.finfo(dtype).bits // 8, backward,
                           sms, limit)


@functools.lru_cache(maxsize=64)
def _block_index(H, U, nb_u, Kp, Cp, backward, device):
    """Row and column indices into rec padded with a zero row and column
    (index H, 4H) that lay out every block's slice: ``[nb_u, Kp, Cp]``."""
    k = torch.arange(Kp)
    j = torch.arange(Cp)
    g = torch.arange(nb_u)
    if backward:        # block g, row k, column j < U: rec[g U + j, k]
        unit = g[:, None] * U + j[None, :]
        ok = (j < U)[None, :] & (unit < H)
        rows = torch.where(ok, unit, H)[:, None, :]
        cols = torch.where(k < 4 * H, k, 4 * H)[None, :, None]
    else:               # block g, row k, column j = gate U + u < 4U: rec[k, gate H + g U + u]
        unit = g[:, None] * U + (j % U)[None, :]
        ok = (j < 4 * U)[None, :] & (unit < H)
        cols = torch.where(ok, (j // U)[None, :] * H + unit, 4 * H)[:, None, :]
        rows = torch.where(k < H, k, H)[None, :, None]
    return rows.to(device), cols.to(device)


def rec_blocks(rec, plan, backward):
    """rec ``[H, 4H]`` as every block's f32 slice, ``[nb_u, Kp, Cp]``:
    forward, block g's column ``gate * U + u`` is rec's column ``gate * H +
    g U + u``; backward, its column ``j`` is rec's row ``g U + j``,
    transposed; zeros past H and 4H."""
    H = rec.shape[0]
    rows, cols = _block_index(H, plan['U'], plan['nb_u'], plan['Kp'],
                              plan['Cp'], backward, rec.device)
    padded = F.pad(rec.float(), (0, 1, 0, 1))
    return padded[rows, cols]


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGS = [_I] * 4 + [_P] * 12
_BWD_ARGS = [_I] * 4 + [_P] * 14
_DTYPES = (torch.float32, torch.bfloat16)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _operand(t, shape, dtype, device, name):
    """``t`` checked (shape, dtype, device), contiguous and 16-byte
    aligned (the kernels read four elements a load), or None."""
    if t is None:
        return None
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f'{name}: expected {dtype} {shape} on {device}, got '
                         f'{t.dtype} {tuple(t.shape)} on {t.device}')
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _plan_ints(plan):
    return (ctypes.c_int * len(PLAN_FIELDS))(*(plan[k] for k in PLAN_FIELDS))


def _launch_forward(xw, rec, c0, h0, save):
    if xw.dim() != 3 or xw.shape[2] % 4 or xw.dtype not in _DTYPES:
        raise ValueError(f'xw: expected a float32 or bfloat16 [B, T, 4H] '
                         f'tensor, got {xw.dtype} {tuple(xw.shape)}')
    B, T, H4 = xw.shape
    H = H4 // 4
    if B < 1 or T < 1 or H < 1:
        raise ValueError(f'xw: empty batch, time or unit axis, '
                         f'{tuple(xw.shape)}')
    dt, dev = xw.dtype, xw.device
    xw = _operand(xw, (B, T, H4), dt, dev, 'xw')
    rec = _operand(rec, (H, H4), dt, dev, 'rec')
    c0 = _operand(c0, (B, H), dt, dev, 'c0')
    h0 = _operand(h0, (B, H), dt, dev, 'h0')
    plan = device_plan(B, H, dt, dev, backward=False)
    blocks = rec_blocks(rec, plan, backward=False)
    out = torch.empty((B, T, H), dtype=dt, device=dev)
    c = torch.empty((B, H), dtype=dt, device=dev)
    h = torch.empty((B, H), dtype=dt, device=dev)
    acts = torch.empty((B, T, H4), dtype=dt, device=dev) if save else None
    cs = torch.empty((B, T, H), dtype=dt, device=dev) if save else None
    flags = torch.empty(THREADS, dtype=torch.int32, device=dev)
    fn = _build.function('lstm', 'nbasr_lstm_forward', _FWD_ARGS)
    ints = _plan_ints(plan)
    with torch.cuda.device(dev):
        err = fn(_DTYPES.index(dt), B, T, H, ctypes.cast(ints, _P),
                 xw.data_ptr(), blocks.data_ptr(), _ptr(c0), _ptr(h0),
                 out.data_ptr(), c.data_ptr(), h.data_ptr(), _ptr(acts),
                 _ptr(cs), flags.data_ptr(), _stream(xw))
    _build.check(err, 'lstm', 'LSTM forward')
    _build.count_launch(LAUNCHES['forward'], 'kernel')
    return out, c, h, (acts, cs) if save else ()


def _launch_backward(acts, cs, rec, c0, dout, dc, dh, need_h0):
    B, T, H4 = acts.shape
    H = H4 // 4
    dt, dev = acts.dtype, acts.device
    if dt not in _DTYPES:
        raise ValueError(f'acts: expected float32 or bfloat16, got {dt}')
    rec = _operand(rec, (H, H4), dt, dev, 'rec')
    c0 = _operand(c0, (B, H), dt, dev, 'c0')
    dout = _operand(dout, (B, T, H), dt, dev, 'dout')
    dc = _operand(dc, (B, H), dt, dev, 'dc')
    dh = _operand(dh, (B, H), dt, dev, 'dh')
    plan = device_plan(B, H, dt, dev, backward=True)
    blocks = rec_blocks(rec, plan, backward=True)
    dgates = torch.empty((B, T, H4), dtype=dt, device=dev)
    dc0 = torch.empty((B, H), dtype=dt, device=dev)
    dh0 = torch.empty((B, H), dtype=dt, device=dev) if need_h0 else None
    dcs = torch.empty((B, H), dtype=torch.float32, device=dev)
    flags = torch.empty(THREADS, dtype=torch.int32, device=dev)
    fn = _build.function('lstm', 'nbasr_lstm_backward', _BWD_ARGS)
    ints = _plan_ints(plan)
    with torch.cuda.device(dev):
        err = fn(_DTYPES.index(dt), B, T, H, ctypes.cast(ints, _P),
                 acts.data_ptr(), cs.data_ptr(), blocks.data_ptr(), _ptr(c0),
                 _ptr(dout), _ptr(dc), _ptr(dh), dgates.data_ptr(),
                 dc0.data_ptr(), _ptr(dh0), dcs.data_ptr(), flags.data_ptr(),
                 _stream(acts))
    _build.check(err, 'lstm', 'LSTM backward')
    _build.count_launch(LAUNCHES['backward'], 'kernel')
    return dgates, dc0, dh0
