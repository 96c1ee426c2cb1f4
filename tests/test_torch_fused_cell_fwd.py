"""The fused cell forward's conv nodes on the grouped forward's machinery,
on the CPU: the launch plans that ``fused_cell._launch`` hands the kernel
(``fused_cell.forward_plans``: the grouped forward's plan of each conv node
on the cell's dense [B, T, C] tensors, with an f32 output tile) cover every
output exactly once and pass a mirror of the kernel's own check; and the
node kernel (the grouped forward's loader, weight staging, register tiles
and output tile, then the fused cell's epilogue: f32 bias, clip, gate,
hash dropout and multipliers, and the store pass with the branch adds and
one rounding), emulated in numpy on flat memory, equals the plain
version.  The plain version against the JAX kernel is
tests/test_torch_fused_cell.py's."""

import numpy as np
import pytest
import torch

from nbasr_torch.models.layers import conv_padding
from nbasr_torch.ops import fused_cell, grouped_conv
from nbasr_torch.ops.fused_cell import ConvNode, FusedCellSpec

from test_torch_grouped_conv import (_check_fwd_plan, _emulate_forward,
                                     _emulated_plan, _flat, _unflat)

KD = ((5, 1), (5, 2), (7, 1), (7, 2))
# (B, T, C, groups): the serving window's four widths (B=4), the train
# step's (B=32), 50 groups of 24 channels, groups of one channel, T below
# the halo
SHAPES = [(4, 772, 600, 100), (4, 772, 800, 100), (4, 386, 1000, 100),
          (4, 193, 1200, 100), (32, 300, 600, 100), (32, 300, 800, 100),
          (32, 150, 1000, 100), (32, 75, 1200, 100), (4, 75, 1200, 50),
          (4, 75, 100, 100), (4, 3, 600, 100)]
SHAPE_IDS = ['serve600', 'serve800', 'serve1000', 'serve1200', 'train600',
             'train800', 'train1000', 'train1200', 'ci24', 'ci1', 'short']
# the register tiles the kernel instantiates (fused_cell.cu with_conv_tile)
INSTANTIATED = {2: {(kt, ot) for kt in grouped_conv.FWD_TAP_TILES
                    for ot in grouped_conv.FWD_OUT_TILES},
                4: {(kt, ot) for kt in fused_cell.F32_TILES[0]
                    for ot in fused_cell.F32_TILES[1]}}
SMEM_LIMIT = 232448
F32 = 4


def _spec(C, groups, kds, branches, rate=0.0):
    """A cell of one conv node per (K, d), node i naming ``branches[i]``."""
    ci = C // groups
    nodes = []
    for (K, d), br in zip(kds, branches):
        lpad, rpad = conv_padding(K, d, 1)
        nodes.append(ConvNode(K, d, lpad, rpad, groups, ci, ci, br))
    return FusedCellSpec(nodes, dropout_rate=rate, train=True, use_norm=False)


def _desc(spec, C, dtype):
    x = torch.zeros((1, 1, C), dtype=dtype)
    weights = []
    for n in spec.nodes:
        weights += [torch.zeros((n.K, n.cin_pg, C), dtype=dtype),
                    torch.zeros((C,))]
    return fused_cell._describe(spec, x, weights)[0]


def _bad_fwd_plan(p, esize, ysize, B, T, G, ci, co, K, d):
    """gconv_body.cuh's bad_fwd_plan, line by line."""
    def bad_vec(v, size):
        return not (v == size or (v in (4, 8, 16) and v > size))
    if (p['gs'] < 1 or p['rt'] != grouped_conv.FWD_RT or p['rows'] < 1
            or p['rows'] % (p['rt'] * d) or p['no'] < 1):
        return True
    per_pass = p['gs'] * (p['rows'] // p['rt'])
    ow = p['threads'] // per_pass
    halo = (K - 1) * d
    x_need = ci * (p['rows'] + halo) * p['gs']
    y_need = co * p['rows'] * p['gs']
    w_need = K * p['cc'] * p['gs'] * p['wstride']
    units = B * p['tiles']
    x_bytes = (2 if p['span'] > 1 else 1) * p['x_buf'] * esize
    return (p['gs'] > G or p['slabs'] != -(-G // p['gs']) or p['tiles'] < 1
            or p['rows'] * p['tiles'] < T or p['rows'] * (p['tiles'] - 1) >= T
            or p['span'] < 1 or units > 2 ** 31 - 1 or p['nk'] * p['kt'] < K
            or p['no'] * p['ot'] < co or p['wstride'] < p['no'] * p['ot']
            or p['wstride'] % 2 or p['cc'] < 1 or p['cc'] > ci
            or p['threads'] % per_pass or ow < 1 or ow > p['no']
            or p['threads'] > grouped_conv.FWD_THREADS
            or p['x_mode'] not in (0, 1) or p['y_mode'] not in (0, 1)
            or bad_vec(p['x_vec'], esize) or bad_vec(p['y_vec'], ysize)
            or p['x_buf'] < x_need
            or (p['y_buf'] == 0 and (ow < p['no']
                                     or p['x_buf'] * esize < y_need * ysize))
            or (p['y_buf'] != 0 and p['y_buf'] < y_need) or p['y_buf'] < 0
            or p['x_buf'] * esize % 16 or p['y_buf'] * ysize % 16
            or p['w_buf'] < w_need
            or p['smem'] < x_bytes + p['y_buf'] * ysize + 4 * p['w_buf']
            or p['smem'] > SMEM_LIMIT
            or p['slabs'] * -(-units // p['span']) > 2 ** 31 - 1)


@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('B,T,C,groups', SHAPES, ids=SHAPE_IDS)
def test_forward_plans_cover_every_output_once(B, T, C, groups, esize):
    """Every conv node's plan as the kernel gets it, for a cell of conv5,
    conv5d2, conv7 and conv7d2 nodes: every (b, t, channel) of the node's
    output in exactly one thread, on the dense strides, with the f32 output
    tile (``y_esize`` 4); a register tile the kernel instantiates; the
    kernel's own check (bad_fwd_plan) passes; the descriptor as the C entry
    point reads it.  The plans of a dense view of 16-byte aligned tensors
    stage and store 16-byte vectors."""
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    spec = _spec(C, groups, KD, [(0,), (0, 1), (2,), (0, 3)])
    desc = _desc(spec, C, dtype)
    n = len(spec.nodes)
    plans = fused_cell.forward_plans(desc, B, T, C, esize, (0,) * n,
                                     (0,) * n)
    ci = C // groups
    dense = (T * C, 1, C, ci)
    for (K, d), p in zip(KD, plans):
        tiles = fused_cell.F32_TILES if esize == 4 else None
        _check_fwd_plan(p, B, T, groups, ci, ci, K, d, 'dense', esize, dense,
                        dense, y_esize=F32, ptrs=(0, 0), reg_tiles=tiles)
        assert (p['kt'], p['ot']) in INSTANTIATED[esize]
        assert not _bad_fwd_plan(p, esize, F32, B, T, groups, ci, ci, K, d)
        assert p['x_mode'] == p['y_mode'] == 1
        if ci * esize % 16 == 0:
            assert p['x_vec'] == 16 and p['y_vec'] == 16
    assert fused_cell.FWD_DESC_INTS == 7 + len(grouped_conv.FWD_PLAN_FIELDS)


def test_forward_plans_skip_other_nodes_and_follow_alignment():
    """Linear and zero nodes keep their own kernels: no plan.  A node input
    off 16 bytes stages narrower vectors, and a store pass whose tensors
    lie on 2 elements, not 4, stores 8-byte f32 vectors (2 elements)."""
    spec = FusedCellSpec([ConvNode(5, 1, 4, 0, 4, 6, 6, (0,)),
                          fused_cell.ZeroNode((1,)),
                          fused_cell.LinearNode((0, 2))], train=True)
    x = torch.zeros((1, 1, 24))
    weights = [torch.zeros((5, 6, 24)), torch.zeros(24), torch.zeros((24, 24)),
               torch.zeros(24)]
    desc = fused_cell._describe(spec, x, weights)[0]
    plans = fused_cell.forward_plans(desc, 2, 21, 24, 4, (0, 0, 0), (0, 0, 0))
    assert plans[0] is not None and plans[1:] == [None, None]
    spec = _spec(48, 4, [(5, 1)], [(0,)])
    desc = _desc(spec, 48, torch.bfloat16)
    (p,) = fused_cell.forward_plans(desc, 2, 21, 48, 2, (0,), (0,))
    assert p['x_vec'] == p['y_vec'] == 16
    for src, out, x_vec, y_vec in ((8, 8, 8, 8), (4, 4, 4, 4), (2, 0, 2, 16)):
        (p,) = fused_cell.forward_plans(desc, 2, 21, 48, 2, (src,), (out,))
        assert (p['x_vec'], p['y_vec']) == (x_vec, y_vec)
    assert fused_cell._store_align([0, 32], 4) == 0
    assert fused_cell._store_align([0, 8], 4) == 8
    assert fused_cell._store_align([2], 2) == 4


def _hash(s0, s1, b, t, c, counter):
    """fused_cell.cu's dropout_bits, in numpy uint32 arithmetic."""
    u = np.uint32
    x = ((t.astype(u) * u(0x9E3779B1)) ^ (c.astype(u) * u(0x85EBCA6B))
         ^ u((s0 * 0xC2B2AE35) & 0xFFFFFFFF) ^ u((s1 + 0x27D4EB2F) & 0xFFFFFFFF)
         ^ (b.astype(u) * u(0x165667B1)) ^ u((counter * 0x5851F42D) & 0xFFFFFFFF))
    for shift in (15, 13, 16):
        x = x ^ (x >> u(shift))
        x = x * u(0x2545F491)
    return x ^ (x >> u(16))


def _emulate_node(i, spec, src, outs, w, bias, seed, esize, choice, B, T, C):
    """Node i of ``spec`` (a conv node) by the kernel's index math: the
    grouped forward on ``src`` ([B, T, C], the plain version's node input)
    with the plan of ``choice``, its plain sums in the f32 output tile, then
    the store pass (ConvEpilogue::store): per vector of y_vec / 4 elements
    of the tile's (g, c) runs, at each element's (b, t, c) the f32 bias, the
    clip by comparisons and in training the gate and the hash's keep, the
    multiplier, and the branches (``outs``, the plain version's node
    outputs) added in order before the one rounding.  Returns (node output,
    multipliers, keep mask) as f64 arrays, NaN where nothing was written."""
    node = spec.nodes[i]
    G, ci, K, d = node.groups, node.cin_pg, node.K, node.d
    bias = bias.double().numpy()
    xf, st = _flat(src.double().numpy(), 'dense', G)
    tiles = fused_cell.F32_TILES if esize == 4 else None
    if choice == 'plan':
        n = len(spec.nodes)
        p = fused_cell.forward_plans(_desc(spec, C, torch.float32), B, T, C,
                                     esize, (0,) * n, (0,) * n)[i]
    else:
        p = _emulated_plan(B, T, G, ci, ci, K, d, esize, st, st, choice,
                           y_esize=F32, reg_tiles=tiles)
    assert p['y_mode'] == 1
    total = np.full(B * T * C, np.nan)
    mult = np.full(B * T * C, np.nan)
    keep_seen = np.zeros(B * T * C, bool)
    branch = [outs[j].double().numpy().reshape(-1)
              for j in sorted(set(node.branches))]
    s0, s1 = (int(v) & 0xFFFFFFFF for v in seed)
    thr = fused_cell.keep_threshold(spec.dropout_rate)
    scale = np.float32(fused_cell.inv_keep(spec.dropout_rate))

    def store(yt, b, t0, at, nrows, geff):
        per_vec = p['y_vec'] // F32
        vpr = geff * ci // per_vec
        for k in range(nrows * vpr):
            trow, v = divmod(k, vpr)
            soff = trow * p['gs'] * ci + v * per_vec   # smem_view of mode 1
            e0 = at + trow * st[2] + v * per_vec
            assert soff * F32 % p['y_vec'] == 0 and e0 % per_vec == 0
            t = t0 + trow
            for q in range(per_vec):
                e = e0 + q
                c = e - (b * T + t) * C
                a = np.float32(yt[soff + q] + bias[c])
                y = 0.0 if a < 0 else a
                y = 20.0 if y > 20 else y
                m = (1.0 if 0 < a < 20 else 0.5 if a == 0 or a == 20
                     else 0.0)
                if spec.dropping:
                    keep = bool(_hash(s0, s1, np.array([b]), np.array([t]),
                                      np.array([c]), i + 1)[0] < thr)
                    y, m = (y * scale, m * scale) if keep else (0.0, 0.0)
                    keep_seen[e] = keep
                mult[e] = m
                for br in branch:          # in order, in f32 on the card
                    y = y + br[e]
                total[e] = y

    _emulate_forward(xf, st, w.double().numpy(), None, st, p, B, T, G, ci,
                     ci, K, d, node.lpad, esize, y_esize=F32, store=store)
    rounded = torch.from_numpy(total).to(src.dtype).double().numpy()
    return (rounded.reshape(B, T, C), mult.reshape(B, T, C),
            keep_seen.reshape(B, T, C))


# (B, T, groups, ci, plan choice, (K, d) per node, branches per node): the
# cells' asymmetric padding and dilation, tap chunks (K=7 in f32's taps of
# 5), partial slabs, several time tiles, channel chunks, blocks of several
# units, output tiles in passes (blocks of at most 8 threads), and branch
# adds onto x and earlier nodes
EMULATED = [
    (2, 19, 3, 4, 'plan', ((5, 1), (7, 2)), ((0,), (0, 1))),
    (2, 13, 3, 6, 'chunks', ((7, 1), (5, 2)), ((), (1,))),
    (3, 21, 4, 3, 'span', ((5, 2), (7, 2)), ((0,), ())),
    (3, 20, 2, 14, 'passes', ((5, 1),), ((0,),)),
    (2, 3, 3, 2, 'plan', ((7, 2),), ((0,),)),
]


@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('rate', [0.0, 0.2])
@pytest.mark.parametrize('B,T,G,ci,choice,kds,branches', EMULATED)
def test_conv_node_emulation_matches_reference(B, T, G, ci, choice, kds,
                                               branches, rate, esize,
                                               monkeypatch):
    """Each conv node of a cell, emulated on flat memory with its plan,
    equals fused_cell_reference's node output (1e-5 of the scale in f32,
    one bf16 ulp of it in bf16: the emulation sums in f64) and multipliers
    (exactly: 0, 0.5, 1 times 1 / (1 - p)); its keep mask is dropout_bits'
    below the threshold; x with NaN, +inf and -inf planted puts NaN and
    +-inf where the reference does."""
    if choice == 'passes':
        monkeypatch.setattr(grouped_conv, 'FWD_THREADS', 8)
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    C = G * ci
    spec = _spec(C, G, kds, branches, rate)
    rng = np.random.RandomState(B * T + C)
    seed = torch.tensor([123, -456789], dtype=torch.int32)
    weights = []
    for n in spec.nodes:
        weights += [torch.from_numpy(rng.randn(n.K, ci, C) * 0.3).float(),
                    torch.from_numpy(rng.randn(C) * 0.1).float()]
    for planted in (False, True):
        x = rng.randn(B, T, C)
        if planted:
            x[0, T // 2, 1] = np.nan
            x[B - 1, 0, C - 1] = np.inf
            x[B - 1, T - 1, 0] = -np.inf
        xt = torch.from_numpy(x).to(dtype)
        ops = [w.to(dtype) if k % 2 == 0 else w for k, w in enumerate(weights)]
        y, outs, mults = fused_cell.fused_cell_reference(
            spec, xt, ops, None, seed, save=True)
        inputs = [xt] + list(outs.unbind(0))
        for i in range(len(spec.nodes)):
            got, mult, keep = _emulate_node(
                i, spec, inputs[i], inputs, ops[2 * i], weights[2 * i + 1],
                seed.tolist(), esize, choice, B, T, C)
            want = inputs[i + 1].double().numpy()
            for test in (np.isnan, np.isposinf, np.isneginf):
                np.testing.assert_array_equal(test(got), test(want))
            finite = np.isfinite(want)
            scale = np.abs(want[finite]).max()
            tol = 2.0 ** -8 if esize == 2 else 1e-5
            np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                       atol=tol * scale)
            np.testing.assert_array_equal(mult, mults[i].double().numpy())
            if spec.dropping:
                thr = fused_cell.keep_threshold(rate)
                bits = fused_cell.dropout_bits(seed, i + 1, B, T, C)
                np.testing.assert_array_equal(keep, (bits < thr).numpy())
            if planted and i == 0:
                assert np.isnan(got).any()


def _fma32(a, b, c):
    """An f32 FMA: the exact product, one rounding of the sum (in f64,
    whose rounding before the f32 one moves the result only at a tie)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


@pytest.mark.parametrize('C', [24, 600, 1200, 2100])
def test_layer_norm_row_walk_matches_reference(C):
    """The LayerNorm kernel (``nbasr_layer_norm``), emulated in numpy f32
    as a warp walks a row: lane l sums elements l, l + 32, ... in order,
    the xor tree sums the 32 lanes, mean = sum / C; the squared deviations
    the same way, each added by an FMA (as nvcc contracts ``v += dv *
    dv``); 1 / sqrt(var + eps); then (x - mean) * inv, times scale plus
    shift by an FMA.  It equals the plain version's f32 two-pass
    LayerNorm to f32 summation order, at a row the lanes leave part empty
    (24), flagship widths (600, 1200) and a wider row (2100)."""
    rng = np.random.RandomState(C)
    x = (rng.randn(64, C) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    shift = (0.1 * rng.randn(C)).astype(np.float32)
    eps = np.float32(1e-3)
    lanes = [x[:, lane::32] for lane in range(32)]

    def warp_sum(parts):
        v = list(parts)
        for o in (16, 8, 4, 2, 1):
            v = [v[lane] + v[lane ^ o] for lane in range(32)]
        assert all(np.array_equal(v[0], w) for w in v)
        return v[0]

    s = []
    for xs in lanes:
        acc = np.zeros(len(x), np.float32)
        for j in range(xs.shape[1]):
            acc = acc + xs[:, j]
        s.append(acc)
    mu = (warp_sum(s) / np.float32(C))[:, None]
    q = []
    for xs in lanes:
        acc = np.zeros(len(x), np.float32)
        for j in range(xs.shape[1]):
            dv = xs[:, j] - mu[:, 0]
            acc = _fma32(dv, dv, acc)
        q.append(acc)
    var = (warp_sum(q) / np.float32(C))[:, None]
    inv = (1 / np.sqrt(var + eps)).astype(np.float32)
    got = _fma32((x - mu) * inv, scale, shift)
    want = fused_cell._layer_norm(torch.from_numpy(x), [
        torch.from_numpy(scale), torch.from_numpy(shift)], float(eps)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# The linear node's tensor-core GEMMs (csrc/linear_mma.cuh): widths from
# the tests' 24 to the recipe's 1200, rows of one proxy call (B=1 x 128),
# the short bucket's blocks (4,800 to 19,200), the long bucket's 37,632 and
# a tail off every tile
LINEAR_WIDTHS = (24, 300, 600, 800, 1000, 1200)
LINEAR_ROWS = (128, 4800, 9600, 19200, 37632, 37632 - 37)
# (M, N, K) of each product over B*T rows at width C: z = src W, g += dz
# W^T, dW = src^T dz
PRODUCTS = {'fwd': lambda rows, C: (rows, C, C),
            'dx': lambda rows, C: (rows, C, C),
            'dw': lambda rows, C: (C, C, rows)}
# (vector columns V, rows of vectors P a thread at a time) of each
# product's epilogue pass over the staged tile
EPILOGUE_PASS = {'fwd': (8, 2), 'dx': (4, 8), 'dw': (4, 4)}
MMA_CONSUMERS = 256     # two warpgroups; the producer warp writes nothing
BK = fused_cell.MMA_TILE_K


def _fragment_cells():
    """(row, column) of the tile that each consumer thread's accumulator
    register acc[4 j + 2 h + e] stages: thread t of warpgroup wg holds rows
    wg*64 + 16 (t / 32) + (t % 32) / 4 + 8 h, columns 8 j + 2 (t % 4) + e
    (wgmma.m64n128's layout, as gemm_tile writes it)."""
    t = np.arange(MMA_CONSUMERS)[:, None, None, None]
    h = np.arange(2)[None, :, None, None]
    j = np.arange(fused_cell.MMA_TILE[1] // 8)[None, None, :, None]
    e = np.arange(2)[None, None, None, :]
    wg, lane = t // 128, t % 32
    row = wg * 64 + (t % 128) // 32 * 16 + lane // 4 + 8 * h
    col = 8 * j + 2 * (lane % 4) + e
    return np.broadcast_arrays(row, col)


def _pass_vectors(V, P):
    """(row, first column) of every vector that tile_pass hands the
    epilogue, over all consumer threads and passes, in one tile."""
    BM, BN = fused_cell.MMA_TILE
    per_row = BN // V
    rows_per = MMA_CONSUMERS // per_row
    t = np.arange(MMA_CONSUMERS)[:, None, None]
    p0 = np.arange(0, BM, P * rows_per)[None, :, None]
    q = np.arange(P)[None, None, :]
    row = p0 + q * rows_per + t // per_row
    col = np.broadcast_to((t % per_row) * V, row.shape)
    return row.ravel(), col.ravel()


@pytest.mark.parametrize('product', sorted(EPILOGUE_PASS))
def test_linear_mma_tile_staged_and_passed_once(product):
    """Within one 128 x 128 tile: the accumulator fragments stage every
    cell exactly once, and the product's epilogue pass reads every cell in
    exactly one vector of one thread."""
    BM, BN = fused_cell.MMA_TILE
    row, col = _fragment_cells()
    staged = np.zeros((BM, BN), np.int64)
    np.add.at(staged, (row.ravel(), col.ravel()), 1)
    assert (staged == 1).all()
    V, P = EPILOGUE_PASS[product]
    vrow, vcol = _pass_vectors(V, P)
    passed = np.zeros((BM, BN), np.int64)
    for i in range(V):
        np.add.at(passed, (vrow, vcol + i), 1)
    assert (passed == 1).all()


def _covered_once(starts, width, limit):
    """Whether the spans [s, s + width) cut at limit cover [0, limit)
    exactly once."""
    count = np.zeros(limit + width, np.int64)
    for s in starts:
        count[s:min(s + width, limit)] += 1
    return (count[:limit] == 1).all() and not count[limit:].any()


@pytest.mark.parametrize('product', sorted(PRODUCTS))
@pytest.mark.parametrize('rows', LINEAR_ROWS)
@pytest.mark.parametrize('C', LINEAR_WIDTHS)
def test_linear_plans_cover_every_output_once(C, rows, product):
    """Each product's grid as the kernel decodes it (blockIdx.x: N tiles
    fastest, then M tiles; blockIdx.y: dW's row chunk) covers every output
    exactly once with the row and column masks (r < M, c < N by vectors),
    and its k tiles every term once (TMA's zero fill past K); dW's row
    chunks (the kernel's kt0 = k_tiles * chunk / chunks) partition the k
    tiles, at least DW_MIN_K_TILES each where there are several, with
    tiles x chunks filling the SMs about once.  Widths off 8 elements
    plan no tensor-core launch."""
    plan, = fused_cell.linear_plans([1, 0, 0, 0, 0, 0, 1], rows, C, 2,
                                    (True,))
    if C % 8:
        assert plan == dict(path=fused_cell.LINEAR_FMA, chunks=1)
        return
    assert plan['path'] == fused_cell.LINEAR_MMA
    M, N, K = PRODUCTS[product](rows, C)
    BM, BN = fused_cell.MMA_TILE
    n_tiles, m_tiles = -(-N // BN), -(-M // BM)
    bid = np.arange(n_tiles * m_tiles)
    m0, n0 = bid // n_tiles * BM, bid % n_tiles * BN
    assert len(set(zip(m0.tolist(), n0.tolist()))) == len(bid)
    assert _covered_once(np.unique(m0), BM, M)
    V, _ = EPILOGUE_PASS[product]
    assert N % V == 0
    starts = [s + k for s in np.unique(n0) for k in range(0, BN, V)
              if s + k < N]
    assert _covered_once(starts, V, N)
    k_tiles = -(-K // BK)
    assert _covered_once(np.arange(k_tiles) * BK, BK, K)
    chunks = plan['chunks'] if product == 'dw' else 1
    assert 1 <= chunks <= k_tiles
    kt = [k_tiles * c // chunks for c in range(chunks + 1)]
    assert kt[0] == 0 and kt[-1] == k_tiles
    sizes = np.diff(kt)
    assert (sizes >= 1).all()
    if chunks > 1:
        assert (sizes >= fused_cell.DW_MIN_K_TILES).all()
        assert n_tiles * m_tiles * chunks <= 132 * fused_cell.MMA_BLOCKS_PER_SM
    assert M <= 2 ** 31 - BM and K <= 2 ** 31 - BK


@pytest.mark.parametrize('esize,C,aligned,path', [
    (2, 600, True, fused_cell.LINEAR_MMA),
    (2, 24, True, fused_cell.LINEAR_MMA),
    (2, 1200, True, fused_cell.LINEAR_MMA),
    (4, 600, True, fused_cell.LINEAR_FMA),
    (4, 1200, True, fused_cell.LINEAR_FMA),
    (2, 300, True, fused_cell.LINEAR_FMA),
    (2, 20, True, fused_cell.LINEAR_FMA),
    (2, 600, False, fused_cell.LINEAR_FMA),
], ids=['bf16-600', 'bf16-24', 'bf16-1200', 'f32-600', 'f32-1200',
        'bf16-300', 'bf16-20', 'bf16-unaligned'])
def test_linear_dispatch_by_dtype_width_and_alignment(esize, C, aligned, path):
    """bf16 at C % 8 == 0 with every operand on 16 bytes goes to the
    tensor-core GEMMs; f32, widths off 8 elements and operands off 16
    bytes keep the SIMT kernels.  The descriptors carry the path where the
    kernels read it (forward: the plan's first int; backward: the dx
    output's slot, then dW's row chunks) and zeros after; conv and zero
    nodes get no linear plan."""
    assert fused_cell.linear_path(esize, C, aligned) == path
    spec = FusedCellSpec([ConvNode(5, 1, 4, 0, C // 4, 4, 4, (0,))
                          if C % 4 == 0 else fused_cell.ZeroNode((0,)),
                          fused_cell.LinearNode((0, 1)),
                          fused_cell.ZeroNode((2,))], train=True)
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    x = torch.zeros((1, 1, C), dtype=dtype)
    weights = ([torch.zeros((5, 4, C), dtype=dtype), torch.zeros(C)]
               if C % 4 == 0 else [])
    weights += [torch.zeros((C, C), dtype=dtype), torch.zeros(C)]
    desc = fused_cell._describe(spec, x, weights)[0]
    linear = fused_cell.linear_plans(desc, 37632, C, esize,
                                     (aligned,) * 3)
    assert linear[0] is None and linear[2] is None
    assert linear[1]['path'] == path
    assert (linear[1]['chunks'] > 1) == (path == fused_cell.LINEAR_MMA)
    fwd = fused_cell.forward_desc_ints(desc, [None] * 3, linear)
    bwd = fused_cell.backward_desc_ints(desc, [None] * 3, linear)
    n = fused_cell.FWD_DESC_INTS
    assert len(fwd) == 3 * n
    assert fwd[n:n + 7] == desc[7:14] and fwd[n + 7] == path
    assert not any(fwd[n + 8:2 * n]) and not any(fwd[7:n])
    m = fused_cell.BWD_DESC_INTS
    assert len(bwd) == 3 * m
    assert bwd[m + 7:m + 9] == [path, linear[1]['chunks']]
    assert not any(bwd[m + 9:2 * m]) and not any(bwd[2 * m + 7:])
