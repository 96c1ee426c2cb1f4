"""Grouped 1-D convolution (stride 1, dilated) on the card: the wrappers of
its three Hopper kernels, their plain versions, and ``grouped_conv1d``.

Port of ``nbasr_tpu/ops/grouped_conv.py`` (``grouped_impl='pallas'``):
``_fwd_kernel``, ``_dx_kernel`` and ``_dw_kernel`` become the forward, the
input gradient and the weight gradient of ``nbasr_torch/csrc/grouped_conv.cu``,
whose header states the bound and the design.  The same three kernels serve
``nbasr_torch/ops/cell_ops.py`` (``'pallas_split'``), whose forward adds the
bias and clip-ReLU(0, 20) in the f32 accumulator.

Every activation is handed to a kernel as the split view ``[B, c, T, G]``
(:func:`to_split`): channel ``c_full = g * c + c_in``, group-major, as the
compact grouped kernel ``[K, ci, C_out]`` and ``F.conv1d(groups=G)`` number
them.  A dense ``[B, T, C]`` tensor is that view with strides ``(T*C, 1, C,
c)`` and the split layout the same view contiguous, so the kernels take
the strides and serve both layouts without a copy, where the TPU wrappers
materialise the transposes.

:func:`conv_forward`, :func:`conv_dx` and :func:`conv_dw` take a CUDA
tensor to the kernel and a CPU tensor to the plain version, and nothing
else: no fallback from one to the other.  ``LAUNCHES`` counts the calls of
each, so a run can show which one it went through.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build

__all__ = ['grouped_conv1d', 'GroupedConv1d', 'to_split', 'from_split',
           'conv_forward', 'conv_dx', 'conv_dw', 'conv_forward_reference',
           'conv_dx_reference', 'conv_dw_reference', 'LAUNCHES',
           'reset_launches']

#: Calls of each kernel (``'kernel'``) and of its plain version
#: (``'plain'``) since the last :func:`reset_launches`.
LAUNCHES = {name: {'kernel': 0, 'plain': 0} for name in ('forward', 'dx', 'dw')}

#: The weight gradient's launch plan (:func:`dw_plan`): shared memory a
#: block may use on Hopper, the share of it one block aims for (two blocks
#: per SM), the row tile's first length, threads per block, the tap and
#: output tiles a thread may hold in registers in bf16 (the kernel's
#: template instantiations; f32, the checks' dtype, has the widest alone),
#: and the cap on the partial sums' f32 bytes as a share of the activation
#: bytes.
SMEM_LIMIT = 232448
DW_SMEM_TARGET = 100 * 1024
DW_ROWS = 64
DW_THREADS = 256
DW_TAP_TILES = (5, 7)           # any other K: chunks of the first
DW_OUT_TILES = (6, 8, 10, 12)
DW_F32_TILE = (7, 12)
DW_PARTIAL_SHARE = 0.25
#: Ints of a plan in the order ``nbasr_grouped_conv_dw`` reads them.
DW_PLAN_FIELDS = ('gs', 'items', 'lanes', 'rows', 'x_rows', 'tiles',
                  'chunks', 'item_chunks', 'kt', 'ot', 'nk', 'no', 'x_mode',
                  'x_vec', 'z_mode', 'z_vec', 'x_buf', 'z_buf', 'smem')
#: The forward's launch plan (:func:`fwd_plan`): threads per block, the
#: times a thread holds (RT, the kernel's kFwdRt), the tap and output tiles
#: of the bf16 instantiations and f32's one tile (the checks' dtype).
FWD_THREADS = 256
FWD_RT = 7                      # odd: time tiles of a warp on other banks
FWD_TAP_TILES = (5, 7)          # any other K: chunks of the first
FWD_OUT_TILES = (6, 8, 10)      # a larger co: further output tiles
FWD_F32_TILE = (7, 6)
FWD_SPANS = (1, 2, 3, 4, 6, 8)  # units of (utterance, time tile) a block walks
#: Ints of a plan in the order ``nbasr_grouped_conv_forward`` reads them.
FWD_PLAN_FIELDS = ('gs', 'slabs', 'rows', 'tiles', 'span', 'rt', 'kt', 'ot',
                   'nk', 'no', 'wstride', 'cc', 'x_mode', 'x_vec', 'y_mode',
                   'y_vec', 'x_buf', 'y_buf', 'w_buf', 'smem', 'threads')


def reset_launches():
    for counts in LAUNCHES.values():
        counts.update(kernel=0, plain=0)


def to_split(x, groups):
    """``[B, T, C]`` -> the split view ``[B, C // groups, T, groups]`` of the
    same memory (a copy only where the strides do not allow a view)."""
    B, T, C = x.shape
    return x.reshape(B, T, groups, C // groups).permute(0, 3, 1, 2)


def from_split(xs):
    """``[B, c, T, G]`` -> ``[B, T, G * c]``, the inverse of :func:`to_split`."""
    B, c, T, G = xs.shape
    return xs.permute(0, 2, 3, 1).reshape(B, T, G * c)


def _dims(xs, w):
    """(B, ci, T, G, K, co) after checking that the shapes agree."""
    if xs.dim() != 4 or w.dim() != 3:
        raise ValueError(f'expected a [B, ci, T, G] view and a [K, ci, C_out] '
                         f'weight, got {tuple(xs.shape)} and {tuple(w.shape)}')
    B, ci, T, G = xs.shape
    K, wci, c_out = w.shape
    if wci != ci or c_out % G:
        raise ValueError(f'weight {tuple(w.shape)} does not fit {G} groups '
                         f'of {ci} input channels')
    return B, ci, T, G, K, c_out // G


def _rpad(K, lpad, dilation):
    rpad = (K - 1) * dilation - lpad
    if rpad < 0:
        raise ValueError(f'lpad={lpad} exceeds the receptive field of K={K}, '
                         f'd={dilation}')
    return rpad


def _device_kind(x):
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'the grouped conv runs on cuda or cpu, not {x.device}')
    return x.device.type


# ---------------------------------------------------------------------------
# entry points: the kernel for a CUDA tensor, the plain version for a CPU one
# ---------------------------------------------------------------------------

def conv_forward(xs, w, bias, lpad, dilation, out):
    """``out[b,o,t,g] = sum_{k,c} xs[b,c,t+k*d-lpad,g] * w[k,c,g*co+o]``
    (zero outside ``[0, T)``), summed in f32 and written into ``out``, a
    ``[B, co, T, G]`` view in ``xs.dtype``.  With ``bias`` (``[C_out]`` in
    ``xs.dtype``) the sum starts at the bias and is clipped to ``[0, 20]``
    before the one rounding.  ``w`` is compact ``[K, ci, C_out]`` in
    ``xs.dtype``.  Not differentiable; returns ``out``."""
    if _device_kind(xs) == 'cpu':
        return conv_forward_reference(xs, w, bias, lpad, dilation, out)
    return _launch_forward(xs, w, bias, lpad, dilation, out)


def conv_dx(dz, w, lpad, dilation, out):
    """The input gradient of :func:`conv_forward` (without its epilogue):
    ``out[b,c,t,g] = sum_{k,o} dz[b,o,t+lpad-k*d,g] * w[k,c,g*co+o]``, f32
    sums, written into ``out``, a ``[B, ci, T, G]`` view in ``dz.dtype``."""
    if _device_kind(dz) == 'cpu':
        return conv_dx_reference(dz, w, lpad, dilation, out)
    return _launch_dx(dz, w, lpad, dilation, out)


def conv_dw(xs, dz, w, lpad, dilation):
    """The weight gradient of :func:`conv_forward` (without its epilogue):
    ``dw[k,c,g*co+o] = sum_{b,t} xs[b,c,t+k*d-lpad,g] * dz[b,o,t,g]`` summed
    in f32, returned as a new ``[K, ci, C_out]`` tensor in ``w.dtype`` (the
    weight operand's, as the JAX VJP casts it)."""
    if _device_kind(xs) == 'cpu':
        return conv_dw_reference(xs, dz, w, lpad, dilation)
    return _launch_dw(xs, dz, w, lpad, dilation)


# ---------------------------------------------------------------------------
# plain versions: F.conv1d and its gradients, f32, one rounding at the end
# ---------------------------------------------------------------------------

def _ncw(xs):
    """A ``[B, c, T, G]`` view -> ``[B, G*c, T]`` f32, ``F.conv1d``'s layout."""
    B, c, T, G = xs.shape
    return xs.permute(0, 3, 1, 2).reshape(B, G * c, T).float()


def _split_ncw(y, groups):
    """``[B, G*c, T]`` -> the ``[B, c, T, G]`` view."""
    return y.unflatten(1, (groups, -1)).permute(0, 2, 3, 1)


def conv_forward_reference(xs, w, bias, lpad, dilation, out):
    """The plain version of :func:`conv_forward`."""
    _build.count_launch(LAUNCHES['forward'], 'plain')
    _, _, _, G, K, _ = _dims(xs, w)
    xp = F.pad(_ncw(xs), (lpad, _rpad(K, lpad, dilation)))
    acc = F.conv1d(xp, w.float().permute(2, 1, 0), dilation=dilation,
                   groups=G)
    if bias is not None:
        acc = torch.clamp(acc + bias.float()[:, None], 0.0, 20.0)
    return out.copy_(_split_ncw(acc, G))


def conv_dx_reference(dz, w, lpad, dilation, out):
    """The plain version of :func:`conv_dx`."""
    _build.count_launch(LAUNCHES['dx'], 'plain')
    B, _, T, G = dz.shape
    K, ci, c_out = w.shape
    span = (K - 1) * dilation
    grad = torch.nn.grad.conv1d_input(
        (B, G * ci, T + span), w.float().permute(2, 1, 0), _ncw(dz),
        dilation=dilation, groups=G)
    return out.copy_(_split_ncw(grad[:, :, lpad:lpad + T], G))


def conv_dw_reference(xs, dz, w, lpad, dilation):
    """The plain version of :func:`conv_dw`."""
    _build.count_launch(LAUNCHES['dw'], 'plain')
    _, _, _, G, K, _ = _dims(xs, w)
    xp = F.pad(_ncw(xs), (lpad, _rpad(K, lpad, dilation)))
    dw = torch.nn.grad.conv1d_weight(xp, tuple(w.permute(2, 1, 0).shape),
                                     _ncw(dz), dilation=dilation, groups=G)
    return dw.permute(2, 1, 0).to(w.dtype)


# ---------------------------------------------------------------------------
# the weight gradient's launch plan (pure Python, so the CPU tests check it)
# ---------------------------------------------------------------------------

def _ceil(a, b):
    return -(-a // b)


def _align16(nbytes):
    return _ceil(nbytes, 16) * 16


def _stage(strides, nch, gs, groups, esize, ptr):
    """(mode, vector bytes) of how a block stages one operand's tile.

    Mode 1, the dense layout (channels contiguous, groups one after
    another): one run over the slab's ``(g, c)`` per time step, shared
    memory ``[t][g][c]``.  Mode 0, any other view: runs over the slab's
    groups, shared memory ``[t][c][g]``, element by element unless ``g``
    is contiguous (the split layout).  The vector is the widest of 16, 8
    and 4 bytes that every address and run of the tile is aligned to,
    else one element."""
    s_b, s_c, s_t, s_g = strides
    last = groups - (_ceil(groups, gs) - 1) * gs
    if (s_c == 1 or nch == 1) and s_g == nch:
        mode, lens, step, offsets = 1, (gs * nch, last * nch), 1, ()
    else:
        mode, lens, step, offsets = 0, (gs, last), s_g, (s_c,)
    for vec in (16, 8, 4):
        if vec <= esize or step != 1:
            break
        need = (ptr, s_b * esize, s_t * esize, gs * s_g * esize) + tuple(
            o * esize for o in offsets + lens)
        if all(v % vec == 0 for v in need):
            return mode, vec
    return mode, esize


def estimated_blocks_per_sm(kt, ot, threads, smem):
    """Resident blocks of the dW or forward kernel per SM, as the CPU can
    guess it: 2048 threads, 228 KB of shared memory and 64 K registers at
    128 per thread (about what ptxas gives the bf16 instantiations).  On
    the card the wrapper asks the CUDA occupancy calculator."""
    return max(1, min(2048 // threads, (228 * 1024) // max(smem + 1024, 1),
                      65536 // (128 * threads)))


def dw_plan(B, T, G, ci, co, K, d, esize, x_strides, z_strides, x_ptr=0,
            z_ptr=0, sms=132, blocks_per_sm=estimated_blocks_per_sm):
    """How ``nbasr_grouped_conv_dw`` cuts the weight gradient: a dict of
    :data:`DW_PLAN_FIELDS` plus the grid and the workspace.

    A block owns a slab of ``gs`` groups and a chunk of the ``B * tiles``
    row tiles (``rows`` time steps of one utterance each, so a tile never
    crosses an utterance); it stages each tile's x (with the ``(K-1)*d``
    halo) and dz in shared memory, two tiles in flight, and ``lanes``
    threads share each ``(group, channel, tap/output tile)`` item, summed
    in order at the end.  ``chunks`` blocks along the rows each write one
    partial set, summed in order by a second pass (none for one chunk);
    they are as many as one wave of resident blocks holds
    (``blocks_per_sm(kt, ot, threads, smem)`` on ``sms`` SMs), within
    ``DW_PARTIAL_SHARE`` of the activation bytes, and the slab size is the
    one that fills that wave best.  Raises ``ValueError`` only where one
    time step of one group does not fit shared memory."""
    halo = (K - 1) * d
    if esize == 4:
        kt, ot = DW_F32_TILE
        nk, no = _ceil(K, kt), _ceil(co, ot)
    else:
        kt = K if K in DW_TAP_TILES else DW_TAP_TILES[0]
        nk = _ceil(K, kt)
        no = _ceil(co, DW_OUT_TILES[-1])
        ot = next(t for t in DW_OUT_TILES if t >= _ceil(co, no))
    nq = nk * no

    act_bytes = B * T * G * (ci + co) * esize
    cap = max(1, int(DW_PARTIAL_SHARE * act_bytes // (K * ci * G * co * 4)))

    def layout(gs):
        """The plan for slabs of ``gs`` groups, or None where one time step
        does not fit shared memory: row tiles of up to DW_ROWS steps, shorter
        while the two stages pass DW_SMEM_TARGET, balanced over T."""
        items_all = gs * ci * nq
        items = min(items_all, DW_THREADS)
        lanes = max(1, min(8, DW_THREADS // items))

        def smem_for(rows):
            x_buf = _align16((rows + halo) * gs * ci * esize) // esize
            z_buf = _align16(rows * gs * co * esize) // esize
            reduce = (lanes - 1) * items * kt * ot * 4
            return x_buf, z_buf, max(2 * (x_buf + z_buf) * esize, reduce)

        rows = DW_ROWS
        while rows > 1 and smem_for(rows)[2] > DW_SMEM_TARGET:
            rows //= 2
        if smem_for(rows)[2] > SMEM_LIMIT:
            return None
        tiles = max(1, _ceil(T, rows))
        rows = max(1, _ceil(T, tiles))        # balanced tiles, never longer
        x_buf, z_buf, smem = smem_for(rows)
        item_chunks = _ceil(items_all, items)
        blocks_x = _ceil(G, gs) * item_chunks
        # one wave: as many row chunks as resident blocks allow, within cap
        slots = sms * max(1, blocks_per_sm(kt, ot, items * lanes, smem))
        chunks = max(1, min(B * tiles, cap, slots // blocks_x, 65535))
        x_mode, x_vec = _stage(x_strides, ci, gs, G, esize, x_ptr)
        z_mode, z_vec = _stage(z_strides, co, gs, G, esize, z_ptr)
        plan = dict(gs=gs, items=items, lanes=lanes, rows=rows,
                    x_rows=rows + halo, tiles=tiles, chunks=chunks,
                    item_chunks=item_chunks, kt=kt, ot=ot, nk=nk, no=no,
                    x_mode=x_mode, x_vec=x_vec, z_mode=z_mode, z_vec=z_vec,
                    x_buf=x_buf, z_buf=z_buf, smem=smem)
        plan.update(grid=(blocks_x, chunks), threads=items * lanes,
                    workspace=chunks * K * ci * G * co if chunks > 1 else 0)
        # ranked by the share of the wave it fills (to the nearest quarter),
        # then by padded groups, 10% more where a staged vector is under 8
        # bytes (copies of 4 bytes or one element), then by the larger slab
        fill = min(1.0, blocks_x * chunks / slots)
        padded = _ceil(G, gs) * gs + (G // 10 if min(x_vec, z_vec) < 8 else 0)
        return (-int(4 * fill + 0.5), padded, -gs), plan

    # slabs of at most about 128 items; one group always stages unless a
    # single time step overflows shared memory
    plans = [p for p in map(layout, range(1, max(1, min(G, 128 // (ci * nq)))
                                         + 1)) if p is not None]
    if not plans:
        raise ValueError(f'the dW kernel cannot stage one time step of a '
                         f'group: halo {halo}, ci={ci}, co={co} need more '
                         f'than {SMEM_LIMIT} bytes of shared memory')
    return min(plans, key=lambda p: p[0])[1]


@functools.lru_cache(maxsize=65536)
def _fwd_wavefronts(mode, ci, gs, rt, d, esize, ntt, threads):
    """Shared-memory wavefronts of one warp-wide read, the worst warp of a
    forward block: (x window element, one float2 of weights).  An x read
    takes as many wavefronts as the most distinct 4-byte words that fall in
    one of the 32 banks (for two neighbouring channels, as the element
    offset moves the bf16 pairs); a weight read one per 128 bytes of
    distinct groups' rows (lanes on one group share an address)."""
    s_c, s_t, s_g = (gs, ci * gs, 1) if mode == 0 else (1, gs * ci, ci)
    x_worst = w_worst = 1
    for w0 in range(0, min(threads, 128), 32):     # the pattern repeats
        lanes = range(w0, min(threads, w0 + 32))
        groups = {lane % gs for lane in lanes}
        w_worst = max(w_worst, _ceil(8 * len(groups), 128))
        for c in range(min(ci, 2)):
            banks = {}
            for lane in lanes:
                gl, tt = lane % gs, lane // gs % ntt
                e = c * s_c + gl * s_g + (tt % d + d * rt * (tt // d)) * s_t
                word = e * esize // 4
                banks.setdefault(word % 32, set()).add(word)
            x_worst = max(x_worst, max(map(len, banks.values())))
    return x_worst, w_worst


def _copy_lines(run_bytes, vec):
    """L1 lines one warp-wide copy of ``vec``-byte vectors touches, runs
    of ``run_bytes`` lying apart."""
    return max(_ceil(32 * vec, 128), _ceil(32, _ceil(run_bytes, vec)))


def _fwd_tiles(K, co, esize, reg_tiles=None):
    """(kt, nk, ot, no): the register tile's taps and outputs and how many
    of each cover K and co, in bf16 the narrowest output tile that covers
    co in the fewest tiles; from ``reg_tiles`` (taps, outputs), where given,
    the same way in either dtype."""
    if esize == 4 and reg_tiles is None:
        kt, ot = FWD_F32_TILE
        no = _ceil(co, ot)
    else:
        taps, outs = reg_tiles or (FWD_TAP_TILES, FWD_OUT_TILES)
        kt = K if K in taps else taps[0]
        no = _ceil(co, outs[-1])
        ot = next(t for t in outs if t >= _ceil(co, no))
    return kt, _ceil(K, kt), ot, no


def fwd_candidates(B, T, G, ci, co, K, d, esize, x_strides, y_strides,
                   x_ptr=0, y_ptr=0, sms=132,
                   blocks_per_sm=estimated_blocks_per_sm, y_esize=None,
                   reg_tiles=None):
    """Every launch plan ``nbasr_grouped_conv_forward`` can run for this
    shape, as ``(cost, plan)`` pairs; :func:`fwd_plan` takes the cheapest.

    A block owns a slab of ``gs`` groups and walks ``span`` units of
    ``rows`` time steps of one utterance each (``tiles`` balanced tiles
    cover T; ``rows`` a multiple of ``RT * d``, the times of one thread in
    one dilation phase).  Its ``gs * rows / RT`` threads of one output
    tile hold as many of the ``no`` output tiles at a time as
    ``FWD_THREADS`` allows, and walk them in passes; with more than one
    pass the output has a tile of its own (``y_buf`` elements), else it
    reuses the x tile's room.  It stages each unit's x tile with the
    ``(K-1)*d`` halo (:func:`_stage`'s mode and vector; two tiles where it
    walks more than one unit, the next in flight) and the weights of ``cc``
    input channels at a time in f32, ``wstride`` floats per group (an odd
    number of float2, so that a half-warp's 8-byte reads fall in distinct
    banks).  The output's elements are ``y_esize`` bytes (``esize`` unless
    given: the fused cell backward's dx leaves f32 sums in an f32 output
    tile and stores them into an f32 gradient buffer).  ``reg_tiles`` (taps,
    outputs) are the register tiles the caller's kernel instantiates, where
    they are not this library's (:func:`_fwd_tiles`).

    The cost is an estimate of one SM's issue cycles: per thread and unit
    the FMAs, the window's loads and conversions and the weights' float2
    loads, plus its share of staging and storing (more for narrow
    vectors), and of staging the weights (once a block where one chunk
    holds them all); blocks are spread over ``sms`` SMs in rounds of
    ``blocks_per_sm(kt, ot, threads, smem)``, and a round costs its warps'
    instructions over four schedulers, or its shared-memory and L1
    wavefronts one a cycle (:func:`_fwd_wavefronts`: bank conflicts
    count), or at least four cycles an instruction where too few warps
    hide the latency, plus one wait for a first tile."""
    halo, rt = (K - 1) * d, FWD_RT
    step = rt * d
    y_esize = y_esize or esize
    kt, nk, ot, no = _fwd_tiles(K, co, esize, reg_tiles)
    wstride = no * ot + 2 * ((no * ot // 2) % 2 == 0)
    # per thread, unit, output tile and input channel: FMAs, window loads
    # and conversions, the weights' float2 loads
    per_c = K * rt * ot + 2 * nk * (rt + kt - 1) + K * ot // 2
    out = []
    for gs in range(1, min(G, FWD_THREADS // d) + 1):
        slabs = _ceil(G, gs)
        x_mode, x_vec = _stage(x_strides, ci, gs, G, esize, x_ptr)
        y_mode, y_vec = _stage(y_strides, co, gs, G, y_esize, y_ptr)
        for nq in range(1, FWD_THREADS // (gs * d) + 1):
            rows = step * nq
            tiles = max(1, _ceil(T, rows))
            if step * _ceil(max(T, 1), tiles * step) != rows:
                continue            # balanced tiles only, never longer
            units = B * tiles
            per_pass = gs * nq * d
            passes = _ceil(no, FWD_THREADS // per_pass)
            threads = per_pass * _ceil(no, passes)
            warps = _ceil(threads, 32)
            y_elems = rows * gs * co
            y_bytes = _align16(y_elems * y_esize)
            x_buf = _align16(max((rows + halo) * gs * ci * esize,
                                 y_bytes if passes == 1 else 0)) // esize
            y_buf = 0 if passes == 1 else y_bytes // y_esize
            x_vecs = (rows + halo) * gs * ci * esize // x_vec
            y_vecs = y_elems * y_esize // y_vec
            per_channel = K * gs * wstride * 4
            # shared-memory and L1 wavefronts per unit and warp: the
            # window and weight reads, the output tile's writes, and the
            # vector copies (a warp's copy touches a line per run it spans)
            x_wf, w_wf = _fwd_wavefronts(x_mode, ci, gs, rt, d, esize, nq * d,
                                         threads)
            x_lines = _copy_lines(gs * (ci if x_mode else 1) * esize, x_vec)
            y_lines = _copy_lines(gs * (co if y_mode else 1) * y_esize, y_vec)
            mio = (passes * (ci * (nk * (rt + kt - 1) * x_wf
                                   + K * (ot // 2) * w_wf) + rt * ot * x_wf)
                   + (x_vecs * x_lines + y_vecs * y_lines) / 32 / warps)
            for span in FWD_SPANS:
                if span > max(1, units):
                    break
                x_bytes = ((2 if span > 1 else 1) * x_buf * esize
                           + y_buf * y_esize)
                room = (SMEM_LIMIT - x_bytes) // per_channel
                for cc in sorted({min(ci, room), _ceil(ci, 2), _ceil(ci, 4)}):
                    if cc > room or cc < 1:
                        continue
                    w_buf = K * cc * gs * wstride
                    smem = x_bytes + 4 * w_buf
                    occ = blocks_per_sm(kt, ot, threads, smem)
                    if occ < 1:
                        continue
                    unit = (passes * (ci * per_c + 40 * _ceil(ci, cc)) + 200
                            + 25 * (x_vecs + y_vecs) / threads)
                    weights = 4 * K * ci * gs * co / threads
                    block = span * unit + weights * (
                        span * passes if cc < ci else 1)
                    blocks = slabs * _ceil(units, span)
                    rounds, rem = divmod(_ceil(blocks, sms), occ)

                    def round_cost(n):
                        return max(n * warps * block / 4,
                                   n * warps * span * mio, 4 * block) + 1000

                    cost = rounds * round_cost(occ) + (round_cost(rem) if rem
                                                       else 0)
                    plan = dict(gs=gs, slabs=slabs, rows=rows, tiles=tiles,
                                span=span, rt=rt, kt=kt, ot=ot, nk=nk, no=no,
                                wstride=wstride, cc=cc, x_mode=x_mode,
                                x_vec=x_vec, y_mode=y_mode, y_vec=y_vec,
                                x_buf=x_buf, y_buf=y_buf, w_buf=w_buf,
                                smem=smem, threads=threads)
                    plan.update(grid=blocks, blocks_per_sm=occ)
                    out.append((cost, plan))
    return out


def fwd_plan(B, T, G, ci, co, K, d, esize, x_strides, y_strides, x_ptr=0,
             y_ptr=0, sms=132, blocks_per_sm=estimated_blocks_per_sm,
             y_esize=None, reg_tiles=None, min_blocks=1):
    """How ``nbasr_grouped_conv_forward`` cuts the forward: a dict of
    :data:`FWD_PLAN_FIELDS` plus the grid (blocks) and the resident blocks
    per SM: of :func:`fwd_candidates` (``y_esize`` the output's element
    size, ``reg_tiles`` the register tiles to pick from) with at least
    ``min_blocks`` resident blocks per SM where any has, and with a block
    for every one of the ``sms`` SMs (all of them where none has), the
    cheapest (ties: the larger slab, then the shorter tile).  Raises
    ``ValueError`` only where one time step of one group with its halo does
    not fit shared memory."""
    plans = fwd_candidates(B, T, G, ci, co, K, d, esize, x_strides, y_strides,
                           x_ptr, y_ptr, sms, blocks_per_sm, y_esize,
                           reg_tiles)
    if not plans:
        raise ValueError(
            f'the forward kernel cannot stage one time step of a group: '
            f'B={B}, T={T}, G={G}, ci={ci}, co={co}, K={K}, d={d} in '
            f'{esize}-byte elements need more than {SMEM_LIMIT} bytes of '
            f'shared memory')
    plans = [p for p in plans if p[1]['blocks_per_sm'] >= min_blocks] or plans
    return min(plans, key=lambda p: (p[1]['grid'] < sms, p[0], -p[1]['gs'],
                                     p[1]['rows']))[1]


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_S = ctypes.POINTER(ctypes.c_longlong)
_DIMS = [ctypes.c_int] * 9          # bf16, B, T, G, ci, co, K, d, lpad
_PLAN = ctypes.POINTER(ctypes.c_int)
_FWD_ARGS = _DIMS + [_P, _S, _P, _P, _P, _S, _PLAN, _P]
_DX_ARGS = _DIMS + [_P, _S, _P, _P, _S, _PLAN, _P]
_DW_ARGS = _DIMS + [_P, _S, _P, _S, _P, _P, ctypes.POINTER(ctypes.c_int), _P]


@functools.lru_cache(maxsize=4096)
def _c_strides(strides):
    return (ctypes.c_longlong * 4)(*strides)


def _strides(t):
    return _c_strides(t.stride())


def _check_operand(t, name, shape, dtype, device, contiguous=False):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or (contiguous and not t.is_contiguous())):
        raise ValueError(f'{name}: expected a {"contiguous " * contiguous}'
                         f'{dtype} tensor of shape {tuple(shape)} on {device}, '
                         f'got {t.dtype} {tuple(t.shape)} on {t.device}')


def _kernel_dims(xs, w, lpad, dilation):
    """The integer arguments every entry point takes, after checking the
    activation dtype, the weight and the padding."""
    if xs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'the grouped conv kernels take f32 or bf16, '
                         f'not {xs.dtype}')
    B, ci, T, G, K, co = _dims(xs, w)
    _check_operand(w, 'weight', w.shape, xs.dtype, xs.device, contiguous=True)
    _rpad(K, lpad, dilation)
    if lpad < 0 or dilation < 1:
        raise ValueError(f'lpad={lpad}, dilation={dilation}')
    return [int(xs.dtype == torch.bfloat16), B, T, G, ci, co, K, dilation,
            lpad]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _run(fn, device, *args):
    """``fn(*args)`` with ``device`` current, switching only where it is
    not."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device, library, function, *args):
    """Resident blocks per SM of the card from the occupancy entry point
    ``function`` of ``csrc/<library>.cu`` (the CUDA occupancy calculator on
    the built kernel), for its int arguments ``args``: here the ``'dw'``,
    ``'fwd'`` or ``'dx'`` kernel's (bf16, kt, ot, threads, smem)."""
    fn = _build.function(library, function, [ctypes.c_int] * len(args))
    blocks = _run(fn, device, *args)
    if blocks < 1:
        raise RuntimeError(f'no resident block of {function} for {args}')
    return blocks


#: The input gradient runs the forward's machinery on dz, so its plan is
#: :func:`fwd_plan` of that conv: called with the dims swapped (``co``
#: input channels, ``ci`` outputs) and dz's and dx's strides.
_PLANS = {'dw': (dw_plan, DW_PLAN_FIELDS), 'fwd': (fwd_plan, FWD_PLAN_FIELDS),
          'dx': (fwd_plan, FWD_PLAN_FIELDS)}


@functools.lru_cache(maxsize=4096)
def _launch_plan(device, kernel, *args):
    """(plan, its ints as the C entry point reads them) of ``_PLANS[kernel]``
    (``'dw'``, ``'fwd'`` or ``'dx'``) on ``device``: its SMs, and its
    occupancy calculator on the built kernel.  Kept per shape, strides and
    pointer alignment, so a train step plans each node once."""
    plan_fn, fields = _PLANS[kernel]
    plan = plan_fn(*args, sms=_sm_count(device), blocks_per_sm=functools.partial(
        _blocks_per_sm, device, 'grouped_conv',
        f'nbasr_grouped_conv_{kernel}_blocks_per_sm', int(args[7] == 2)))
    return plan, (ctypes.c_int * len(fields))(*(plan[k] for k in fields))


def _launch_forward(xs, w, bias, lpad, dilation, out):
    dims = _kernel_dims(xs, w, lpad, dilation)
    B, T, G, ci, co, K = dims[1:7]
    if bias is not None:
        _check_operand(bias, 'bias', (G * co,), xs.dtype, xs.device,
                       contiguous=True)
    _check_operand(out, 'out', (B, co, T, G), xs.dtype, xs.device)
    _, plan = _launch_plan(xs.device, 'fwd', B, T, G, ci, co, K, dilation,
                           xs.element_size(), xs.stride(), out.stride(),
                           xs.data_ptr() % 16, out.data_ptr() % 16)
    fn = _build.function('grouped_conv', 'nbasr_grouped_conv_forward',
                         _FWD_ARGS)
    err = _run(fn, xs.device, *dims, xs.data_ptr(), _strides(xs),
               w.data_ptr(), None if bias is None else bias.data_ptr(),
               out.data_ptr(), _strides(out), plan, _stream(xs))
    _build.check(err, 'grouped_conv', 'grouped conv forward')
    _build.count_launch(LAUNCHES['forward'], 'kernel')
    return out


def _launch_dx(dz, w, lpad, dilation, out):
    B, co, T, G = dz.shape
    K, ci, _ = w.shape
    _check_operand(out, 'out', (B, ci, T, G), dz.dtype, dz.device)
    dims = _kernel_dims(out, w, lpad, dilation)
    if dims[5] != co:
        raise ValueError(f'dz has {co} channels per group, the weight '
                         f'{dims[5]}')
    # the forward on dz with the taps reversed: the halo mirrored
    dims[8] = _rpad(K, lpad, dilation)
    _, plan = _launch_plan(dz.device, 'dx', B, T, G, co, ci, K, dilation,
                           dz.element_size(), dz.stride(), out.stride(),
                           dz.data_ptr() % 16, out.data_ptr() % 16)
    fn = _build.function('grouped_conv', 'nbasr_grouped_conv_dx', _DX_ARGS)
    err = _run(fn, dz.device, *dims, dz.data_ptr(), _strides(dz),
               w.data_ptr(), out.data_ptr(), _strides(out), plan, _stream(dz))
    _build.check(err, 'grouped_conv', 'grouped conv dx')
    _build.count_launch(LAUNCHES['dx'], 'kernel')
    return out


def _launch_dw(xs, dz, w, lpad, dilation):
    dims = _kernel_dims(xs, w, lpad, dilation)
    B, T, G, co = dims[1], dims[2], dims[3], dims[5]
    _check_operand(dz, 'dz', (B, co, T, G), xs.dtype, xs.device)
    plan, plan_ints = _launch_plan(
        xs.device, 'dw', B, T, G, w.shape[1], co, w.shape[0], dilation,
        xs.element_size(), xs.stride(), dz.stride(), xs.data_ptr() % 16,
        dz.data_ptr() % 16)
    dw = torch.empty_like(w)
    work = torch.empty((plan['workspace'],), dtype=torch.float32,
                       device=xs.device) if plan['workspace'] else None
    fn = _build.function('grouped_conv', 'nbasr_grouped_conv_dw', _DW_ARGS)
    err = _run(fn, xs.device, *dims, xs.data_ptr(), _strides(xs),
               dz.data_ptr(), _strides(dz), dw.data_ptr(),
               None if work is None else work.data_ptr(), plan_ints,
               _stream(xs))
    _build.check(err, 'grouped_conv', 'grouped conv dW')
    _build.count_launch(LAUNCHES['dw'], 'kernel')
    return dw


# ---------------------------------------------------------------------------
# grouped_conv1d: the 'pallas' path's op
# ---------------------------------------------------------------------------

class GroupedConv1d(torch.autograd.Function):
    """Forward kernel; backward the dx and dW kernels on the dense tensors
    seen as split views.  dx comes back in x's dtype, dW in the weight
    operand's (the JAX VJP's ``.astype(w.dtype)``)."""

    @staticmethod
    def forward(ctx, x, w, groups, lpad, dilation):
        B, T, _ = x.shape
        y = torch.empty((B, T, w.shape[2]), dtype=x.dtype, device=x.device)
        conv_forward(to_split(x, groups), w, None, lpad, dilation,
                     to_split(y, groups))
        ctx.save_for_backward(x, w)
        ctx.conf = groups, lpad, dilation
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        groups, lpad, dilation = ctx.conf
        dz = to_split(dy, groups)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            conv_dx(dz, w, lpad, dilation, to_split(dx, groups))
        if ctx.needs_input_grad[1]:
            dw = conv_dw(to_split(x, groups), dz, w, lpad, dilation)
        return dx, dw, None, None, None


def grouped_conv1d(x, w, groups, lpad, rpad, dilation=1):
    """Grouped conv1d, stride 1: ``[B, T, C] x [K, ci, C_out] -> [B, T,
    C_out]`` in ``x.dtype``, f32 sums.  ``w`` is the compact grouped kernel
    (``ci = C // groups``, output channels group-major) in ``x.dtype``;
    ``(lpad, rpad)`` is the time padding, which must keep the length
    (``lpad + rpad == (K - 1) * dilation``, as every cell conv does).
    Differentiable with respect to ``x`` and ``w``."""
    K = w.shape[0]
    if lpad + rpad != (K - 1) * dilation:
        raise ValueError(f'padding ({lpad}, {rpad}) does not keep the length '
                         f'for K={K}, d={dilation}')
    if x.shape[2] != groups * w.shape[1]:
        raise ValueError(f'x has {x.shape[2]} channels, the weight takes '
                         f'{groups} groups of {w.shape[1]}')
    return GroupedConv1d.apply(x, w, groups, lpad, dilation)
