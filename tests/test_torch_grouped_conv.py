"""The port's grouped conv ops (``nbasr_torch.ops.grouped_conv`` and
``cell_ops``, the plain versions of their kernels on the CPU) against the
JAX package's Pallas kernels in interpret mode: forward, dx and dW of
``grouped_conv1d``; forward, dx, dW and db of ``grouped_conv_relu`` on a
contiguous split tensor and on a strided split view; and the two paths'
own clip-ReLU gates at exact ties."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import nbasr_tpu.ops.cell_ops as jax_cell_ops
from nbasr_tpu.models.layers import conv_padding
from nbasr_tpu.ops.grouped_conv import grouped_conv1d as jax_grouped_conv1d

from nbasr_torch.models.layers import relu20
from nbasr_torch.ops import cell_ops, grouped_conv
from nbasr_torch.ops.grouped_conv import from_split, grouped_conv1d, to_split

# tests/test_grouped_conv.py's cases and the flagship's block-0 group shape
CASES = [
    # (B, T, C, groups, K, dilation)
    (2, 24, 12, 4, 5, 1),
    (2, 24, 12, 4, 5, 2),
    (3, 17, 24, 4, 7, 1),
    (1, 31, 8, 2, 7, 2),
    (2, 40, 600, 100, 5, 1),
]
CASE_IDS = ['k5', 'k5d2', 'k7', 'k7d2', 'flagship']
# f32 on both sides, sums in another order: the forward within 1e-5 of the
# output's scale, dx and dW (sums over up to B*T = 80 rows) within 1e-4
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# one bf16 ulp of the scale: both round the same f32 sum once
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_cell_ops, 'INTERPRET', True)
    with jax.default_matmul_precision('highest'):
        yield


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _inputs(B, T, C, groups, K, dilation, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    w = (rng.randn(K, C // groups, C) * 0.2).astype(np.float32)
    b = (rng.randn(C) * 0.1).astype(np.float32)
    cot = rng.randn(B, T, C).astype(np.float32)
    if ties:        # whole windows of exact-zero pre-activations
        x[:, 8:16] = 0.0
        b[:] = 0.0
    return x, w, b, cot, conv_padding(K, dilation, 1)


def _t(a, grad=True):
    return torch.tensor(a, requires_grad=grad)


def _jax_vjp(f, cot, *args):
    """``f(*args)`` and its VJP at ``cot``."""
    y, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
    return y, vjp(jnp.asarray(cot))


@pytest.mark.parametrize('B,T,C,groups,K,dilation', CASES, ids=CASE_IDS)
def test_grouped_conv1d_matches_jax(B, T, C, groups, K, dilation):
    x, w, _, cot, (lpad, rpad) = _inputs(B, T, C, groups, K, dilation)
    y, (gx, gw) = _jax_vjp(lambda x, w: jax_grouped_conv1d(
        x, w, groups, lpad, rpad, dilation, True), cot, x, w)
    xt, wt = _t(x), _t(w)
    yt = grouped_conv1d(xt, wt, groups, lpad, rpad, dilation)
    yt.backward(torch.from_numpy(cot))
    _close(yt, y, FWD_TOL)
    _close(xt.grad, gx, GRAD_TOL)
    _close(wt.grad, gw, GRAD_TOL)


def _jax_split(x, w, b, groups, lpad, rpad, dilation):
    return jax_cell_ops.from_split(jax_cell_ops.grouped_conv_relu(
        jax_cell_ops.to_split(x, groups), w, b, groups, lpad, rpad, dilation))


def _port_split(xt, wt, bt, groups, lpad, rpad, dilation, layout):
    xs = to_split(xt, groups)
    if layout == 'contiguous':
        xs = xs.contiguous()
    else:
        assert not xs.is_contiguous()
    ys = cell_ops.grouped_conv_relu(xs, wt, bt, groups, lpad, rpad, dilation)
    assert ys.is_contiguous()
    return from_split(ys)


@pytest.mark.parametrize('layout', ['contiguous', 'view'])
@pytest.mark.parametrize('B,T,C,groups,K,dilation', CASES, ids=CASE_IDS)
def test_grouped_conv_relu_matches_jax(B, T, C, groups, K, dilation, layout):
    x, w, b, cot, (lpad, rpad) = _inputs(B, T, C, groups, K, dilation, seed=1)
    y, want = _jax_vjp(lambda x, w, b: _jax_split(x, w, b, groups, lpad, rpad,
                                                  dilation), cot, x, w, b)
    xt, wt, bt = _t(x), _t(w), _t(b)
    yt = _port_split(xt, wt, bt, groups, lpad, rpad, dilation, layout)
    yt.backward(torch.from_numpy(cot))
    _close(yt, y, FWD_TOL)
    for got, w_ in zip((xt.grad, wt.grad, bt.grad), want):
        _close(got, w_, GRAD_TOL)


@pytest.mark.parametrize('op', ['pallas', 'pallas_split'])
def test_bf16_rounding_points(op):
    """bf16 operands: both sides sum in f32 and round once (the split op
    after its bias and clip), the 'pallas' op's bias add rounds again."""
    B, T, C, groups, K, dilation = CASES[1]
    x, w, b, _, (lpad, rpad) = _inputs(B, T, C, groups, K, dilation, seed=2)
    xj, wj, bj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    xt, wt, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    if op == 'pallas':
        want = jax_grouped_conv1d(xj, wj, groups, lpad, rpad, dilation, True)
        got = grouped_conv1d(xt, wt, groups, lpad, rpad, dilation)
    else:
        want = _jax_split(xj, wj, bj, groups, lpad, rpad, dilation)
        got = _port_split(xt, wt, bt, groups, lpad, rpad, dilation, 'view')
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_ULP)


def test_each_path_keeps_its_gate_at_ties():
    """Zero biases and zeroed input rows put whole windows of
    pre-activations at exactly 0.  The split op's gate (from its saved
    output, strictly inside (0, 20)) passes nothing there; the 'pallas'
    path's relu20 (jnp.clip's VJP) passes half.  Each matches its JAX
    counterpart, and their bias gradients differ by exactly half the
    cotangent summed over the ties."""
    B, T, C, groups, K, dilation = CASES[0]
    x, w, b, cot, (lpad, rpad) = _inputs(B, T, C, groups, K, dilation, seed=3,
                                         ties=True)

    def jax_pallas(x, w, b):
        return jnp.clip(jax_grouped_conv1d(x, w, groups, lpad, rpad, dilation,
                                           True) + b, 0.0, 20.0)

    grads = {}
    for name, jf in (('split', lambda x, w, b: _jax_split(
            x, w, b, groups, lpad, rpad, dilation)), ('pallas', jax_pallas)):
        _, want = _jax_vjp(jf, cot, x, w, b)
        xt, wt, bt = _t(x), _t(w), _t(b)
        if name == 'split':
            yt = _port_split(xt, wt, bt, groups, lpad, rpad, dilation, 'view')
        else:
            pre = grouped_conv1d(xt, wt, groups, lpad, rpad, dilation) + bt
            yt = relu20(pre)
        yt.backward(torch.from_numpy(cot))
        for got, w_ in zip((xt.grad, wt.grad, bt.grad), want):
            _close(got, w_, GRAD_TOL)
        grads[name] = bt.grad
    ties = (pre == 0).detach()
    assert int(ties.sum()) >= B * 4 * C          # rows 8-11 at least
    half = 0.5 * torch.where(ties, torch.from_numpy(cot), 0.0).sum(dim=(0, 1))
    torch.testing.assert_close(grads['pallas'] - grads['split'], half,
                               rtol=0, atol=1e-5)
    assert float(half.abs().max()) > 0.5


def test_cpu_runs_the_plain_versions():
    x, w, b, cot, (lpad, rpad) = _inputs(*CASES[0])
    grouped_conv.reset_launches()
    xt, wt = _t(x), _t(w)
    grouped_conv1d(xt, wt, 4, lpad, rpad, 1).sum().backward()
    cell_ops.grouped_conv_relu(to_split(xt.detach(), 4), wt.detach(),
                               torch.from_numpy(b), 4, lpad, rpad, 1)
    assert grouped_conv.LAUNCHES == {'forward': {'kernel': 0, 'plain': 2},
                                     'dx': {'kernel': 0, 'plain': 1},
                                     'dw': {'kernel': 0, 'plain': 1}}


# (B, T, G, ci, co, K, d): the flagship's dW nodes at the train step's B=32,
# and the edge shapes the card checks (ci = 24, ci = 1, T shorter than the
# halo, B=1, T not a multiple of the row tile, taps and outputs past the
# register tile, one group of 800, ci != co both ways)
PLAN_SHAPES = [
    (32, 300, 100, 6, 6, 5, 1), (32, 300, 100, 8, 8, 5, 1),
    (32, 150, 100, 10, 10, 5, 1), (32, 75, 100, 12, 12, 5, 1),
    (4, 75, 50, 24, 24, 5, 1), (4, 75, 100, 1, 1, 5, 1),
    (4, 3, 100, 6, 6, 7, 2), (1, 300, 100, 6, 6, 5, 1),
    (4, 77, 100, 12, 12, 7, 2), (2, 10, 3, 30, 30, 9, 1),
    (2, 20, 1, 800, 800, 5, 2), (4, 75, 100, 6, 12, 5, 1),
    (2, 13, 3, 14, 2, 5, 2),
]


def _plan_strides(B, T, G, ci, co, layout):
    if layout == 'dense':       # [B, T, C] seen as the split view
        return (T * G * ci, 1, G * ci, ci), (T * G * co, 1, G * co, co)
    if layout == 'strided':     # [B, G, T, c] seen as [B, c, T, G]
        return (G * T * ci, 1, ci, T * ci), (G * T * co, 1, co, T * co)
    return (ci * T * G, T * G, G, 1), (co * T * G, T * G, G, 1)


@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('layout', ['dense', 'split', 'strided'])
@pytest.mark.parametrize('B,T,G,ci,co,K,d', PLAN_SHAPES)
def test_dw_plan_covers_every_row_once(B, T, G, ci, co, K, d, layout, esize):
    """The weight gradient's launch plan: every (b, t) row in exactly one
    chunk and one time tile of its utterance; every (group, channel, tap,
    output) in one item; shared memory within Hopper's 227 KB and enough
    for both stages and the lanes' sums; the workspace sized to the chunks;
    the grid and block within CUDA's limits; a staged vector aligned to
    every address it copies."""
    xst, zst = _plan_strides(B, T, G, ci, co, layout)
    p = grouped_conv.dw_plan(B, T, G, ci, co, K, d, esize, xst, zst, 256,
                             512, sms=132)
    _check_dw_plan(p, B, T, G, ci, co, K, d, layout, esize, xst, zst)


def _check_dw_plan(p, B, T, G, ci, co, K, d, layout, esize, xst, zst,
                   ptrs=(256, 512)):
    """The dW plan's invariants (the strides of x and dz, their pointers'
    bytes past an aligned base in ``ptrs``)."""
    assert set(grouped_conv.DW_PLAN_FIELDS) <= p.keys()
    units = B * p['tiles']
    seen = np.zeros((B, T), np.int64)
    for y in range(p['chunks']):
        for u in range(units * y // p['chunks'], units * (y + 1) // p['chunks']):
            b, i = divmod(u, p['tiles'])
            t0 = i * p['rows']
            seen[b, t0:min(T, t0 + p['rows'])] += 1
            assert t0 < T
    assert (seen == 1).all()
    assert p['items'] * p['item_chunks'] >= p['gs'] * ci * p['nk'] * p['no']
    assert p['nk'] * p['kt'] >= K and p['no'] * p['ot'] >= co
    if esize == 4:
        assert (p['kt'], p['ot']) == grouped_conv.DW_F32_TILE
    else:
        assert p['kt'] in grouped_conv.DW_TAP_TILES
        assert p['ot'] in grouped_conv.DW_OUT_TILES
    assert p['x_rows'] == p['rows'] + (K - 1) * d
    assert p['x_buf'] >= ci * p['x_rows'] * p['gs']
    assert p['z_buf'] >= co * p['rows'] * p['gs']
    stages = 2 * (p['x_buf'] + p['z_buf']) * esize
    lanes = (p['lanes'] - 1) * p['items'] * p['kt'] * p['ot'] * 4
    assert max(stages, lanes) <= p['smem'] <= grouped_conv.SMEM_LIMIT
    assert p['x_buf'] * esize % 16 == 0 and p['z_buf'] * esize % 16 == 0
    assert 1 <= p['threads'] == p['items'] * p['lanes'] <= 1024
    gx, gy = p['grid']
    assert gx == -(-G // p['gs']) * p['item_chunks'] <= 2 ** 31 - 1
    assert gy == p['chunks'] <= 65535
    n = K * ci * G * co
    assert p['workspace'] == (p['chunks'] * n if p['chunks'] > 1 else 0)
    # partials: a small share of the activation bytes
    assert p['workspace'] * 4 <= max(
        grouped_conv.DW_PARTIAL_SHARE * B * T * G * (ci + co) * esize, 4 * n)
    for (mode, vec), strides, ptr, nch in (
            ((p['x_mode'], p['x_vec']), xst, ptrs[0], ci),
            ((p['z_mode'], p['z_vec']), zst, ptrs[1], co)):
        assert vec == esize or (vec in (4, 8, 16) and vec > esize)
        s_b, s_c, s_t, s_g = strides
        if vec > esize:
            assert (ptr % vec, s_b * esize % vec, s_t * esize % vec) == (0, 0, 0)
            assert p['gs'] * s_g * esize % vec == 0
        assert mode == int(layout == 'dense' or (layout == 'split' and nch == 1))
        if layout == 'strided' and nch > 1:     # g strided: element by element
            assert vec == esize
    if layout == 'dense' and esize == 2 and (ci, co) == (6, 6):
        assert (p['x_vec'], p['z_vec']) == (16, 16)   # the flagship's block 0


def test_dw_plan_fills_the_card_and_bounds_the_partials():
    """At the flagship's block 0 (B=32, T=300, C=600, bf16) and block 3
    (T=75, C=1200): enough blocks for the 132 SMs, and partial sums within
    a quarter of the activation bytes (the old kernel's 64 chunks wrote
    1.2x the activation bytes at block 3)."""
    for B, T, G, ci, co, K, d in PLAN_SHAPES[:4]:
        xst, zst = _plan_strides(B, T, G, ci, co, 'dense')
        p = grouped_conv.dw_plan(B, T, G, ci, co, K, d, 2, xst, zst)
        gx, gy = p['grid']
        act = B * T * G * (ci + co) * 2
        assert 4 * p['workspace'] <= 0.25 * act
        assert gx * gy >= 100
        assert p['smem'] <= grouped_conv.DW_SMEM_TARGET


def _fwd_units(p, B):
    """(block, slab, unit) of every unit a forward block walks: block
    (slab, q), units q*span, ... below B * tiles."""
    blk = np.arange(p['grid'])
    slab, u0 = blk % p['slabs'], (blk // p['slabs']) * p['span']
    blk, slab, unit = (np.repeat(a, p['span']) for a in (blk, slab, u0))
    unit = unit + np.tile(np.arange(p['span']), p['grid'])
    keep = unit < B * p['tiles']
    return blk[keep], slab[keep], unit[keep]


def _fwd_owners(p, B, T, G, co, d):
    """(b, t, g, o) of every sum the forward kernel's threads hold, and
    whether the kernel writes it, by the kernel's index math: block (slab,
    q) walking units (b, tile), thread (gl, tt, oq) with gl fastest, RT
    times of one dilation phase, OT outputs of output tile q0 + oq in the
    pass that starts at tile q0."""
    gs, rows, rt, ot = p['gs'], p['rows'], p['rt'], p['ot']
    ntt = rows // rt
    ow = p['threads'] // (gs * ntt)
    blk, slab, unit = _fwd_units(p, B)
    b, t0 = unit // p['tiles'], (unit % p['tiles']) * rows
    tid = np.arange(p['threads'])
    gl, rest = tid % gs, tid // gs
    tt = rest % ntt
    oq = np.arange(0, p['no'], ow)[:, None] + rest // ntt    # [pass, thread]
    r0 = tt % d + d * rt * (tt // d)
    shape = (len(blk),) + oq.shape + (rt, ot)
    t = (t0[:, None, None, None, None] + r0[None, None, :, None, None]
         + d * np.arange(rt)[None, None, None, :, None])
    g = slab[:, None, None, None, None] * gs + gl[None, None, :, None, None]
    o = (oq * ot)[None, :, :, None, None] + np.arange(ot)
    b = np.broadcast_to(b[:, None, None, None, None], shape)
    t, g, o = (np.broadcast_to(a, shape) for a in (t, g, o))
    on = np.broadcast_to((oq < p['no'])[None, :, :, None, None], shape)
    written = (t < T) & (g < G) & (o < co) & on
    return b, t, g, o, written


@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('layout', ['dense', 'split', 'strided'])
@pytest.mark.parametrize('B,T,G,ci,co,K,d', PLAN_SHAPES)
def test_fwd_plan_covers_every_output_once(B, T, G, ci, co, K, d, layout,
                                           esize):
    """The forward's launch plan: every (b, t, g, o) in exactly one
    thread's register tile; each block's staged rows [t0 - lpad, t0 + rows
    + halo - lpad) of its own utterance hold every row its windows read;
    shared memory within Hopper's 227 KB and enough for the x tile, the
    output tile (over the x tile, or its own where the threads walk the
    output tiles in passes) and the weights; the grid and block within
    CUDA's limits; a staged vector aligned to every address it copies."""
    xst, yst = _plan_strides(B, T, G, ci, co, layout)
    p = grouped_conv.fwd_plan(B, T, G, ci, co, K, d, esize, xst, yst, 256,
                              512, sms=132)
    _check_fwd_plan(p, B, T, G, ci, co, K, d, layout, esize, xst, yst)


@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('layout', ['dense', 'split', 'strided'])
@pytest.mark.parametrize('B,T,G,ci,co,K,d', PLAN_SHAPES)
def test_dx_plan_covers_every_output_once(B, T, G, ci, co, K, d, layout,
                                          esize):
    """The input gradient's launch plan, ``_PLANS['dx']``: the forward's
    plan of the conv on dz (co input channels, ci outputs, dz's and dx's
    strides) holds every invariant of the forward's, so every (b, t, g, c)
    of dx has exactly one owner."""
    xst, zst = _plan_strides(B, T, G, ci, co, layout)
    plan_fn, fields = grouped_conv._PLANS['dx']
    assert fields == grouped_conv.FWD_PLAN_FIELDS
    p = plan_fn(B, T, G, co, ci, K, d, esize, zst, xst, 256, 512, sms=132)
    _check_fwd_plan(p, B, T, G, co, ci, K, d, layout, esize, zst, xst)


def _check_fwd_plan(p, B, T, G, ci, co, K, d, layout, esize, xst, yst,
                    y_esize=None, ptrs=(256, 512), reg_tiles=None):
    """The forward plan's invariants (ci, co and the strides: the staged
    operand's and the output's, at ``ptrs`` bytes from an aligned base;
    the output's elements ``y_esize`` bytes, ``esize`` unless given; the
    register tile one of ``reg_tiles``, (taps, outputs), where the kernel
    is not this library's)."""
    y_esize = y_esize or esize
    assert set(grouped_conv.FWD_PLAN_FIELDS) <= p.keys()
    b, t, g, o, written = _fwd_owners(p, B, T, G, co, d)
    idx = ((b * T + t) * G + g) * co + o
    seen = np.bincount(idx[written], minlength=B * T * G * co)
    assert seen.shape == (B * T * G * co,) and (seen == 1).all()
    # every block walks at least one unit, a block's units in one slab
    blk, _, unit = _fwd_units(p, B)
    assert (np.bincount(blk, minlength=p['grid']) >= 1).all()
    assert 1 <= p['span'] and unit.max() < B * p['tiles'] or T * B == 0
    rt, rows, kt = p['rt'], p['rows'], p['kt']
    halo = (K - 1) * d
    assert p['nk'] * kt >= K and p['no'] * p['ot'] >= co
    if reg_tiles:
        assert kt in reg_tiles[0] and p['ot'] in reg_tiles[1]
    elif esize == 4:
        assert (kt, p['ot']) == grouped_conv.FWD_F32_TILE
    else:
        assert kt in grouped_conv.FWD_TAP_TILES
        assert p['ot'] in grouped_conv.FWD_OUT_TILES
    # the windows: tap chunk k0 of thread tile tt reads rows r0 + d*(k0 + m),
    # m < RT + kn - 1, of the staged rows + halo
    assert rows % (rt * d) == 0
    for tt in range(rows // rt):
        r0 = tt % d + d * rt * (tt // d)
        for k0 in range(0, K, kt):
            kn = min(kt, K - k0)
            assert 0 <= r0 + d * (k0 + rt + kn - 2) < rows + halo
    assert p['tiles'] * rows >= T > (p['tiles'] - 1) * rows or T == 0
    per_pass = p['gs'] * rows // rt
    ow = p['threads'] // per_pass
    assert p['threads'] % per_pass == 0 and 1 <= ow <= p['no']
    assert p['x_buf'] >= (rows + halo) * p['gs'] * ci
    y_need = rows * p['gs'] * co
    if p['y_buf'] == 0:                 # one pass: the output over the x tile
        assert ow == p['no'] and p['x_buf'] * esize >= y_need * y_esize
    else:
        assert p['y_buf'] >= y_need
    assert p['x_buf'] * esize % 16 == 0 and p['y_buf'] * y_esize % 16 == 0
    assert p['wstride'] >= p['no'] * p['ot'] and (p['wstride'] // 2) % 2 == 1
    assert 1 <= p['cc'] <= ci
    assert p['w_buf'] >= K * p['cc'] * p['gs'] * p['wstride']
    bufs = 2 if p['span'] > 1 else 1
    assert (bufs * p['x_buf'] * esize + p['y_buf'] * y_esize + 4 * p['w_buf']
            <= p['smem'] <= grouped_conv.SMEM_LIMIT)
    assert 1 <= p['threads'] <= grouped_conv.FWD_THREADS
    assert p['grid'] == p['slabs'] * -(-B * p['tiles'] // p['span'])
    assert p['grid'] <= 2 ** 31 - 1
    assert p['slabs'] == -(-G // p['gs'])
    last = G - (p['slabs'] - 1) * p['gs']
    for (mode, vec), strides, ptr, nch, size in (
            ((p['x_mode'], p['x_vec']), xst, ptrs[0], ci, esize),
            ((p['y_mode'], p['y_vec']), yst, ptrs[1], co, y_esize)):
        assert vec == size or (vec in (4, 8, 16) and vec > size)
        s_b, s_c, s_t, s_g = strides
        if vec > size:
            assert (ptr % vec, s_b * size % vec, s_t * size % vec) == (0, 0, 0)
            run = p['gs'] * nch if mode == 1 else p['gs']
            tail = last * nch if mode == 1 else last
            assert run * size % vec == 0 and tail * size % vec == 0
            if mode == 0:
                assert s_g == 1 and s_c * size % vec == 0
        assert mode == int(layout == 'dense' or (layout == 'split' and nch == 1))
        if layout == 'strided' and nch > 1:     # g strided: element by element
            assert vec == size
    if layout == 'dense' and esize == 2 and (T, ci) == (300, 6) and B == 32:
        assert (p['x_vec'], p['y_vec']) == (16, 16)   # the flagship's block 0


def test_fwd_plan_fills_the_card():
    """At the flagship's four widths (B=32, bf16 and f32, both layouts):
    at least one block for each of the 132 SMs (block 3 has only B*T =
    2,400 rows), each block small enough to be resident."""
    for B, T, G, ci, co, K, d in PLAN_SHAPES[:4]:
        for layout in ('dense', 'split'):
            for esize in (2, 4):
                xst, yst = _plan_strides(B, T, G, ci, co, layout)
                p = grouped_conv.fwd_plan(B, T, G, ci, co, K, d, esize, xst,
                                          yst)
                assert p['grid'] >= 132, (T, ci, layout, esize, p['grid'])
                assert p['blocks_per_sm'] >= 1


def _tile_run(r, mode, nch, nrows, gs, s_c):
    """Run r of a tile as the kernel's for_each_vector addresses it: (time
    row, shared offset, channel offset)."""
    if mode == 0:
        c, trow = divmod(r, nrows)
        return trow, (trow * nch + c) * gs, c * s_c
    return r, r * gs * nch, 0


def _emulate_copy(mem, strides, sm, nch, mode, vec, esize, base, ts0, nrows,
                  gs, geff, T, stage, bounds=True, add=False):
    """stage_tile (``stage``: device memory ``mem`` -> shared ``sm``, a time
    outside [0, T) reads zero unless ``bounds`` is off) or store_tile (the
    reverse, times [0, nrows); add_tile with ``add``), run by run and
    element by element, with the kernel's alignment: each vector's shared
    and device addresses are multiples of its bytes (the base pointer
    counts as aligned)."""
    s_b, s_c, s_t, s_g = strides
    per_vec = vec // esize
    run_len = geff if mode == 0 else geff * nch
    assert run_len % per_vec == 0
    vpr = run_len // per_vec
    step = s_g if mode == 0 else 1
    for i in range((nch * nrows if mode == 0 else nrows) * vpr):
        r, v = divmod(i, vpr)
        trow, soff, goff = _tile_run(r, mode, nch, nrows, gs, s_c)
        s = soff + v * per_vec
        a = base + goff + (ts0 + trow) * s_t + v * per_vec * step
        assert s >= 0 and s * esize % vec == 0 and a * esize % vec == 0
        for e in range(per_vec):
            if not stage:
                assert 0 <= a + e < len(mem)
                mem[a + e] = mem[a + e] + sm[s + e] if add else sm[s + e]
            elif ((bounds and not 0 <= ts0 + trow < T)
                  or not 0 <= a + e < len(mem)):
                sm[s + e] = 0.0
            else:
                sm[s + e] = mem[a + e]


def _emulate_forward(x, xst, w, bias, yst, p, B, T, G, ci, co, K, d, lpad,
                     esize, bounds=True, dx=False, y_esize=None, prior=None,
                     store=None):
    """The forward kernel's loader, weight staging, register tiles and
    store in numpy (f64 sums), on flat memory addressed by the strides;
    shared memory starts as NaN, so a read of what was never staged shows
    in an output.  Unwritten outputs stay NaN.  With ``dx`` the input
    gradient's kernel, the same body on dz: ``x`` is dz (``ci`` its
    channels), the output dx (``co``), ``w`` the conv's ``[K, co, G*ci]``,
    staged transposed and tap-reversed, and ``lpad`` the mirrored pad.
    ``y_esize`` is the output's element size (the fused backward's f32
    tile and buffer: 4); with ``prior`` (flat memory like the output) the
    output tile is added into it (add_tile), else stored.  ``store(yt, b,
    t0, at, nrows, geff)`` takes the output tile's place in the store (the
    fused cell forward's epilogue: utterance ``b``, first time ``t0``,
    element offset ``at`` in the output's view)."""
    gs, rows, x_buf, y_buf = p['gs'], p['rows'], p['x_buf'], p['y_buf']
    y_esize = y_esize or esize
    if not y_buf:           # the output tile over the x tile: it must fit
        assert rows * gs * co * y_esize <= x_buf * esize
    y = np.full(B * co * T * G, np.nan) if prior is None else prior.copy()
    units = B * p['tiles']
    for blk in range(p['grid']):
        slab, u0 = blk % p['slabs'], (blk // p['slabs']) * p['span']
        g0 = slab * gs
        geff = min(gs, G - g0)
        # one x tile, or two where the block walks more than one unit
        smem = np.full((2 if p['span'] > 1 else 1) * x_buf, np.nan)
        out_tile = np.full(y_buf, np.nan)
        wsm = np.full(p['w_buf'], np.nan)

        def tile(u):
            return smem[(u - u0) % 2 * x_buf:][:x_buf]

        def stage(u):
            _emulate_copy(x, xst, tile(u), ci, p['x_mode'], p['x_vec'], esize,
                          u // p['tiles'] * xst[0] + g0 * xst[3],
                          u % p['tiles'] * rows - lpad, rows + (K - 1) * d,
                          gs, geff, T, True, bounds)

        stage(u0)
        u1 = min(units, u0 + p['span'])
        for u in range(u0, u1):
            if u + 1 < u1:          # the next unit into the other tile
                stage(u + 1)
            yt = out_tile if y_buf else tile(u)
            _emulate_unit(tile(u), yt, wsm, w, bias, p, ci, co, K, d, g0,
                          geff, first=u == u0, dx=dx)
            b, t0 = divmod(u, p['tiles'])
            t0 *= rows
            at = b * yst[0] + g0 * yst[3] + t0 * yst[2]
            if store is not None:
                store(yt, b, t0, at, min(rows, T - t0), geff)
                continue
            _emulate_copy(y, yst, yt, co, p['y_mode'], p['y_vec'], y_esize,
                          at, 0, min(rows, T - t0), gs, geff, T, False,
                          add=prior is not None)
    return y


def _emulate_unit(tile, yt, wsm, w, bias, p, ci, co, K, d, g0, geff, first,
                  dx=False):
    """One unit of a forward (or ``dx``) block: per pass over the output
    tiles, its threads' register tiles summed over the channel chunks (each
    chunk's weights staged first where they are staged a chunk at a time,
    or on the block's ``first`` unit and pass), then written into ``yt``."""
    gs, rows, rt, kt, ot, ws, cc = (p[k] for k in ('gs', 'rows', 'rt', 'kt',
                                                   'ot', 'wstride', 'cc'))
    ntt, tap = rows // rt, cc * gs * ws
    ow = p['threads'] // (gs * ntt)

    def view(mode, nch):            # smem_view: (c, t, g) strides
        return (gs, nch * gs, 1) if mode == 0 else (1, gs * nch, nch)

    sx_c, sx_t, sx_g = view(p['x_mode'], ci)
    sy_c, sy_t, sy_g = view(p['y_mode'], co)
    for q0 in range(0, p['no'], ow):
        threads = []                # (gl, r0, o0, sums) of the live threads
        for tid in range(p['threads']):
            gl, rest = tid % gs, tid // gs
            tt, oq = rest % ntt, rest // ntt
            if gl < geff and q0 + oq < p['no']:
                o0 = (q0 + oq) * ot
                b0 = np.zeros(ot)
                if bias is not None:
                    n = min(ot, co - o0)
                    b0[:n] = bias[(g0 + gl) * co + o0:][:n]
                threads.append((gl, tt % d + d * rt * (tt // d), o0,
                                np.tile(b0, (rt, 1))))
        for c0 in range(0, ci, cc):
            cn = min(cc, ci - c0)
            if (cc < ci or (first and q0 == 0)) and dx:
                # stage_weights<kDx>: thread j on w's (g, c) run, its tap k
                # from w's K-1-k, every output o
                for j in range(geff * cn):
                    g, c = divmod(j, cn)
                    for k in range(K):
                        for o in range(co):
                            wsm[k * tap + c * gs * ws + g * ws + o] = w[
                                K - 1 - k, o, (g0 + g) * ci + c0 + c]
            elif cc < ci or (first and q0 == 0):
                for j in range(geff * co):
                    g, o = divmod(j, co)
                    for k in range(K):
                        for c in range(cn):
                            wsm[k * tap + c * gs * ws + g * ws + o] = w[
                                k, c0 + c, (g0 + g) * co + o]
            for gl, r0, o0, acc in threads:
                for c in range(cn):
                    xc = (c0 + c) * sx_c + gl * sx_g + r0 * sx_t
                    wc = (c * gs + gl) * ws + o0
                    for k0 in range(0, K, kt):
                        kn = min(kt, K - k0)
                        xk = xc + k0 * d * sx_t
                        xw = np.array([tile[xk + m * d * sx_t]
                                       if m < rt + kn - 1 else 0.0
                                       for m in range(rt + kt - 1)])
                        for k in range(kn):
                            acc += np.outer(xw[k:k + rt],
                                            wsm[wc + (k0 + k) * tap:][:ot])
        for gl, r0, o0, acc in threads:   # the pass's outputs into yt
            for o in range(min(ot, co - o0)):
                v = acc[:, o]
                if bias is not None:
                    v = np.where(v < 0, 0.0, np.where(v > 20, 20.0, v))
                for j in range(rt):
                    yt[(r0 + d * j) * sy_t + (o0 + o) * sy_c + gl * sy_g] = v[j]


def _flat(a, layout, G):
    """A [B, T, G*c] array as flat memory of ``layout`` and its strides."""
    B, T, C = a.shape
    c = C // G
    if layout == 'dense':
        return a.reshape(-1), (T * C, 1, C, c)
    if layout == 'strided':
        return (a.reshape(B, T, G, c).transpose(0, 2, 1, 3).reshape(-1),
                (G * T * c, 1, c, T * c))
    return a.reshape(B, T, G, c).transpose(0, 3, 1, 2).reshape(-1), (
        c * T * G, T * G, G, 1)


def _unflat(y, strides, B, co, T, G):
    s_b, s_c, s_t, s_g = strides
    b, c, t, g = np.meshgrid(np.arange(B), np.arange(co), np.arange(T),
                             np.arange(G), indexing='ij')
    return y[b * s_b + c * s_c + t * s_t + g * s_g]        # [B, co, T, G]


# (B, T, G, ci, co, K, d, layout, esize, plan choice): shapes small enough
# for an element-by-element emulation that still cut the work several
# ways: partial slabs, several time tiles and the last one short, T below
# the halo, dilation phases, tap chunks (K=9 in bf16's taps of 5), channel
# chunks, further output tiles (co=14), blocks that walk several units
# (the last block fewer), and output tiles walked in passes (here with a
# block of at most 8 threads, so that co=14 needs them)
EMULATED = [
    (2, 19, 6, 3, 3, 5, 2, 'dense', 4, 'plan'),
    (2, 13, 5, 2, 4, 7, 1, 'split', 2, 'chunks'),
    (3, 3, 4, 2, 2, 7, 2, 'strided', 2, 'plan'),
    (2, 11, 3, 4, 14, 9, 1, 'dense', 2, 'chunks'),
    (3, 40, 5, 2, 2, 5, 1, 'split', 4, 'span'),
    (3, 21, 4, 3, 3, 7, 2, 'dense', 2, 'span'),
    (2, 11, 3, 2, 14, 5, 2, 'split', 4, 'passes'),
    (3, 20, 2, 3, 14, 5, 1, 'dense', 2, 'passes'),
]


def _emulated_plan(B, T, G, ci, co, K, d, esize, xst, yst, choice,
                   kernel='fwd', y_esize=None, reg_tiles=None):
    """The plan of ``_PLANS[kernel]`` (``'dx'``: ci, co and the strides
    those of the conv on dz; ``y_esize`` the output's element size,
    ``reg_tiles`` the register tiles), or the candidate that cuts the work
    as ``choice`` says."""
    if choice == 'plan':
        return grouped_conv._PLANS[kernel][0](B, T, G, ci, co, K, d, esize,
                                              xst, yst, y_esize=y_esize,
                                              reg_tiles=reg_tiles)
    plans = [p for _, p in grouped_conv.fwd_candidates(
        B, T, G, ci, co, K, d, esize, xst, yst, y_esize=y_esize,
        reg_tiles=reg_tiles)]
    if choice == 'passes':  # output tiles in passes, blocks of several units
        return max(plans, key=lambda p: (p['y_buf'] > 0, p['span'] > 1,
                                         G % p['gs'] > 0, p['cc'] < ci))
    if choice == 'span':    # blocks of several units, the last one short
        return max(plans, key=lambda p: (
            p['span'] > 1 and B * p['tiles'] % p['span'] > 0, p['tiles'] > 1,
            G % p['gs'] > 0, p['span']))
    # several tiles, a partial slab and input channels in chunks
    return max(plans, key=lambda p: (p['cc'] < ci, G % p['gs'] > 0,
                                     p['tiles'] > 1, -p['rows']))


@pytest.mark.parametrize('epilogue', [False, True], ids=['plain', 'bias_relu'])
@pytest.mark.parametrize('B,T,G,ci,co,K,d,layout,esize,choice', EMULATED)
def test_fwd_emulation_matches_reference(B, T, G, ci, co, K, d, layout,
                                         esize, choice, epilogue, monkeypatch):
    """The forward kernel's index math, emulated in numpy on flat memory
    with its plan, equals conv_forward_reference; with the loader's bound
    on the utterance switched off, a halo that reads the neighbouring
    utterance (or past the end) shows."""
    if choice == 'passes':
        monkeypatch.setattr(grouped_conv, 'FWD_THREADS', 8)
    rng = np.random.RandomState(B * T + ci)
    x = rng.randn(B, T, G * ci)
    w = rng.randn(K, ci, G * co) * 0.3
    bias = rng.randn(G * co) * 3 if epilogue else None
    lpad = conv_padding(K, d, 1)[0]
    xf, xst = _flat(x, layout, G)
    _, yst = _flat(np.zeros((B, T, G * co)), layout, G)
    p = _emulated_plan(B, T, G, ci, co, K, d, esize, xst, yst, choice)
    if choice == 'chunks':
        assert p['cc'] < ci or p['no'] > 1
    if choice == 'span':
        assert p['span'] > 1 and B * p['tiles'] % p['span'] > 0
    if choice == 'passes':
        assert p['y_buf'] > 0 and p['threads'] <= 8
    want = grouped_conv.conv_forward_reference(
        to_split(torch.from_numpy(x), G), torch.from_numpy(w),
        None if bias is None else torch.from_numpy(bias), lpad, d,
        torch.empty((B, co, T, G), dtype=torch.float64)).numpy()
    got = _unflat(_emulate_forward(xf, xst, w, bias, yst, p, B, T, G, ci, co,
                                   K, d, lpad, esize), yst, B, co, T, G)
    scale = np.abs(want).max()
    # the plain version sums in f32, the emulation in f64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    leaky = _unflat(_emulate_forward(xf, xst, w, bias, yst, p, B, T, G, ci,
                                     co, K, d, lpad, esize, bounds=False),
                    yst, B, co, T, G)
    assert np.abs(leaky - want).max() > 1e-2 * scale


# (B, T, G, ci, co, K, d, lpad, layout, esize, plan choice) of the conv
# whose input gradient is emulated: ci != co both ways (dz of 14 channels
# in chunks, dx of 14 in output tiles walked in passes), lpad 0, the whole
# span and between (the cells' asymmetric conv_padding among them: 0 at
# K=5/d=1, 8 at K=7/d=2, 4 at K=9), d = 2, T below the halo, tap chunks
# (K=9 in bf16), blocks of several units, every layout, and dz expanded
# along T (autograd's dy of a sum, stride 0)
DX_EMULATED = [
    (2, 13, 3, 2, 14, 5, 2, 0, 'dense', 2, 'chunks'),
    (2, 13, 3, 2, 14, 5, 2, 3, 'strided', 4, 'chunks'),
    (2, 11, 3, 14, 2, 5, 2, 8, 'split', 4, 'passes'),
    (3, 20, 2, 14, 3, 5, 1, 2, 'dense', 2, 'passes'),
    (2, 12, 3, 14, 2, 7, 2, 5, 'strided', 2, 'plan'),
    (3, 21, 4, 3, 3, 7, 2, 8, 'dense', 2, 'span'),
    (3, 40, 5, 2, 2, 5, 1, 0, 'split', 4, 'span'),
    (3, 3, 4, 2, 2, 7, 2, 12, 'split', 2, 'plan'),
    (2, 11, 3, 4, 6, 9, 1, 4, 'dense', 2, 'chunks'),
    (2, 16, 3, 3, 5, 5, 2, 4, 'expanded', 2, 'plan'),
]


@pytest.mark.parametrize('B,T,G,ci,co,K,d,lpad,layout,esize,choice',
                         DX_EMULATED)
def test_dx_emulation_matches_reference(B, T, G, ci, co, K, d, lpad, layout,
                                        esize, choice, monkeypatch):
    """The input gradient's kernel, emulated in numpy on flat memory: the
    forward's body on dz with the plan of ``_PLANS['dx']`` (the conv on dz:
    co input channels, ci outputs), the weights staged transposed and
    tap-reversed and the halo mirrored (rpad = span - lpad on the left),
    equals conv_dx_reference; with the loader's bound on the utterance
    switched off, a halo that reads the neighbouring utterance (or past
    the end) shows."""
    if choice == 'passes':
        monkeypatch.setattr(grouped_conv, 'FWD_THREADS', 8)
    rng = np.random.RandomState(B * T + ci + 7 * co)
    dz = rng.randn(B, 1 if layout == 'expanded' else T, G * co)
    w = rng.randn(K, ci, G * co) * 0.3
    mem = 'dense' if layout == 'expanded' else layout
    zf, zst = _flat(dz, mem, G)
    if layout == 'expanded':
        zst = (zst[0], zst[1], 0, zst[3])
        dz = np.broadcast_to(dz, (B, T, G * co))
    _, xst = _flat(np.zeros((B, T, G * ci)), mem, G)
    p = _emulated_plan(B, T, G, co, ci, K, d, esize, zst, xst, choice, 'dx')
    if choice == 'chunks':
        assert p['cc'] < co or p['no'] > 1
    if choice == 'span':
        assert p['span'] > 1 and B * p['tiles'] % p['span'] > 0
    if choice == 'passes':
        assert p['y_buf'] > 0 and p['threads'] <= 8
    want = grouped_conv.conv_dx_reference(
        to_split(torch.from_numpy(np.ascontiguousarray(dz)), G),
        torch.from_numpy(w), lpad, d,
        torch.empty((B, ci, T, G), dtype=torch.float64)).numpy()

    def emulate(bounds):
        return _unflat(_emulate_forward(
            zf, zst, w, None, xst, p, B, T, G, co, ci, K, d,
            (K - 1) * d - lpad, esize, bounds=bounds, dx=True), xst, B, ci,
            T, G)

    scale = np.abs(want).max()
    # the plain version sums in f32, the emulation in f64
    np.testing.assert_allclose(emulate(True), want, rtol=0, atol=1e-5 * scale)
    assert np.abs(emulate(False) - want).max() > 1e-2 * scale


def test_refuses_other_devices_and_bad_padding():
    w = torch.zeros((5, 3, 12))
    with pytest.raises(ValueError, match='cuda or cpu'):
        grouped_conv1d(torch.empty((1, 8, 12), device='meta'),
                       w.to('meta'), 4, 0, 4, 1)
    with pytest.raises(ValueError, match='keep the length'):
        grouped_conv1d(torch.zeros((1, 8, 12)), w, 4, 0, 3, 1)
    with pytest.raises(ValueError, match='groups'):
        cell_ops.grouped_conv_relu(torch.zeros((1, 3, 8, 4)), w,
                                   torch.zeros(12), 2, 0, 4, 1)
