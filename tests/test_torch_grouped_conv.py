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
# register tile)
PLAN_SHAPES = [
    (32, 300, 100, 6, 6, 5, 1), (32, 300, 100, 8, 8, 5, 1),
    (32, 150, 100, 10, 10, 5, 1), (32, 75, 100, 12, 12, 5, 1),
    (4, 75, 50, 24, 24, 5, 1), (4, 75, 100, 1, 1, 5, 1),
    (4, 3, 100, 6, 6, 7, 2), (1, 300, 100, 6, 6, 5, 1),
    (4, 77, 100, 12, 12, 7, 2), (2, 10, 3, 30, 30, 9, 1),
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
            ((p['x_mode'], p['x_vec']), xst, 256, ci),
            ((p['z_mode'], p['z_vec']), zst, 512, co)):
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
