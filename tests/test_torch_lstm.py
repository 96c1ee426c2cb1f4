"""The LSTM recurrence (nbasr_torch.ops.lstm_recurrence) on the CPU: its
plain forward is the loop FastLSTM ran before, bit for bit; its analytic
backward matches autograd through that loop in float64; the launch plan
fits the card and covers every unit and row once; and a float64 emulation
of lstm.cu's loops (blocks, tiles, k splits, partials) on the plan and the
block layout of rec matches the plain versions."""

import pytest
import torch

from nbasr_torch.models.lstm import FastLSTM
from nbasr_torch.ops import lstm_recurrence as L


@pytest.fixture(autouse=True)
def _fresh_counts():
    L.reset_launches()
    yield
    L.reset_launches()


def _old_loop(m, x, initial_carry=None):
    """FastLSTM.forward's recurrence as the module ran it before the
    recurrence moved into ops.lstm_recurrence."""
    B, T, _ = x.shape
    dt = m.compute_dtype
    xw = (x.to(dt).float() @ m.kernel.to(dt).float() + m.bias).to(dt)
    rec = m.recurrent.to(dt).float()
    if initial_carry is None:
        c = h = torch.zeros((B, m.hidden), dtype=dt, device=x.device)
    else:
        c, h = (v.to(dt) for v in initial_carry)
    hs = []
    for t in range(T):
        gates = xw[:, t] + (h.float() @ rec).to(dt)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, h)


def _loop64(xw, rec, c, h):
    """The same loop in float64 throughout, for autograd."""
    hs = []
    for t in range(xw.shape[1]):
        i, f, g, o = (xw[:, t] + h @ rec).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1), c, h


@pytest.mark.parametrize('grad', [False, True])
@pytest.mark.parametrize('carry', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plain_forward_is_the_loop_bit_for_bit(dtype, carry, grad):
    gen = torch.Generator().manual_seed(1)
    m = FastLSTM(6, 5, compute_dtype=dtype, generator=gen)
    x = torch.randn(3, 7, 6, generator=gen)
    init = ((torch.randn(3, 5, generator=gen), torch.randn(3, 5, generator=gen))
            if carry else None)
    want, (wc, wh) = _old_loop(m, x, init)
    with torch.set_grad_enabled(grad):
        got, (c, h) = m(x, init, return_carry=True)
        plain = m(x, init)
    for a, b in ((got, want), (c, wc), (h, wh), (plain, want)):
        assert a.dtype == dtype and torch.equal(a, b)
    assert got.requires_grad == grad
    assert L.LAUNCHES == {'forward': {'kernel': 0, 'plain': 2},
                          'backward': {'kernel': 0, 'plain': 0}}


@pytest.mark.parametrize('wanted', ['out', 'carry', 'both'])
def test_plain_backward_matches_autograd_through_the_loop(wanted):
    B, T, H = 3, 7, 5
    gen = torch.Generator().manual_seed(2)

    def draw(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    dtype=torch.float64)).requires_grad_()

    xw, rec = draw(B, T, 4 * H), draw(H, 4 * H, scale=0.5)
    c0, h0 = draw(B, H), draw(B, H)
    w = [torch.randn(s, generator=gen, dtype=torch.float64)
         for s in ((B, T, H), (B, H), (B, H))]
    use = {'out': (0,), 'carry': (1, 2), 'both': (0, 1, 2)}[wanted]
    inputs = (xw, rec, c0, h0)

    def loss(outs):
        return sum((outs[i] * w[i]).sum() for i in use)

    want = torch.autograd.grad(loss(_loop64(*inputs)), inputs)
    out, (c, h) = L.lstm_recurrence(*inputs)
    got = torch.autograd.grad(loss((out, c, h)), inputs)
    for name, a, b in zip(('dxw', 'drec', 'dc0', 'dh0'), got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=name)
    assert L.LAUNCHES == {'forward': {'kernel': 0, 'plain': 1},
                          'backward': {'kernel': 0, 'plain': 1}}


def test_plain_backward_without_a_carry_in_f32():
    """The module's own call: no initial carry, the loss on the output;
    the Function's gradients against autograd through the old loop in f32
    (sums in another order: f32 rounding)."""
    gen = torch.Generator().manual_seed(3)
    m = FastLSTM(6, 5, generator=gen)
    x = torch.randn(2, 9, 6, generator=gen, requires_grad=True)
    w = torch.randn(2, 9, 5, generator=gen)
    params = (x, m.kernel, m.recurrent, m.bias)
    want = torch.autograd.grad((_old_loop(m, x)[0] * w).sum(), params)
    got = torch.autograd.grad((m(x) * w).sum(), params)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_no_grad_saves_nothing_and_other_devices_raise():
    x = torch.randn(2, 3, 8)
    rec = torch.randn(2, 8, requires_grad=True)
    with torch.no_grad():
        out, (c, h) = L.lstm_recurrence(x, rec)
    assert out.grad_fn is None and out.shape == (2, 3, 2)
    assert L.LAUNCHES['forward']['plain'] == 1
    with pytest.raises(ValueError, match='cuda or cpu'):
        L.lstm_recurrence(x.to('meta'), rec.to('meta'))


# ---------------------------------------------------------------------------
# the launch plan and an emulation of the kernels' loops
# ---------------------------------------------------------------------------

PLAN_CASES = [
    # (B, H, esize, sms, smem_limit): the main path's shapes on an H100 ...
    (64, 500, 2, 132, L.H100_SHARED_LIMIT),
    (48, 500, 2, 132, L.H100_SHARED_LIMIT),
    (64, 500, 4, 132, L.H100_SHARED_LIMIT),
    (1, 500, 2, 132, L.H100_SHARED_LIMIT),
    (256, 500, 4, 132, L.H100_SHARED_LIMIT),
    (7, 2048, 2, 132, L.H100_SHARED_LIMIT),    # rec streamed backward
    # ... and small ones that the emulation runs
    (5, 6, 8, 4, L.H100_SHARED_LIMIT),
    (9, 7, 8, 6, L.H100_SHARED_LIMIT),
    (9, 7, 8, 6, 3000),                        # small tiles, rec streamed
    (1, 3, 8, 132, L.H100_SHARED_LIMIT),
    (5, 6, 2, 4, L.H100_SHARED_LIMIT),         # the mma path
    (19, 9, 2, 6, L.H100_SHARED_LIMIT),
    (3, 5, 2, 132, L.H100_SHARED_LIMIT),
]


@pytest.mark.parametrize('backward', [False, True])
@pytest.mark.parametrize('B,H,esize,sms,limit', PLAN_CASES)
def test_plan_fits_and_covers_every_unit_and_row_once(B, H, esize, sms, limit,
                                                      backward):
    p = L.recurrence_plan(B, H, esize, backward, sms, limit)
    K, cols = (4 * H, 1) if backward else (H, 4)
    assert p['nb_u'] * p['nb_b'] <= sms
    assert p['nb_u'] == -(-H // p['U']) and p['nb_b'] == -(-B // p['BB'])
    assert p['BT'] * p['U'] <= L.THREADS
    S = p['S']
    assert S & (S - 1) == 0
    if p['mma']:            # bf16 on the tensor cores: 16 x 8 tiles a warp
        assert esize == 2 and p['rec_smem'] == 1
        assert p['Kp'] == -(-K // 16) * 16 and p['ld'] == p['Kp'] + 8
        assert (p['ld'] * 2 // 16) % 2 == 1    # rows an odd 16 bytes apart
        assert p['Cp'] == -(-cols * p['U'] // 8) * 8
        assert p['BT'] % 16 == 0 and 16 <= p['BT'] <= -(-p['BB'] // 16) * 16
        tiles = (p['BT'] // 16) * (p['Cp'] // 8)
        assert S == 1 or tiles * S <= L.WARPS
        floats = 128 * tiles * S + (p['BT'] + p['Cp']) * p['ld'] // 2
    else:                   # f32 FMAs: 4 x 4 tiles a thread
        assert p['Kp'] == -(-K // 4) * 4 and p['ld'] >= p['Kp']
        assert p['ld'] % 32 == 4
        assert p['Cp'] == -(-cols * p['U'] // 4) * 4
        assert p['BT'] % 4 == 0 and 4 <= p['BT'] <= -(-p['BB'] // 4) * 4
        tiles = (p['BT'] // 4) * (p['Cp'] // 4)
        assert S == 1 or tiles * S <= L.THREADS
        floats = (p['BT'] * p['ld'] + 16 * tiles * S
                  + (p['Kp'] * p['Cp'] if p['rec_smem'] else 0))
    assert p['smem'] == 4 * floats <= limit
    units = sorted(u for g in range(p['nb_u'])
                   for u in range(g * p['U'], min(H, (g + 1) * p['U'])))
    rows = sorted(b for g in range(p['nb_b'])
                  for b in range(g * p['BB'], min(B, (g + 1) * p['BB'])))
    assert units == list(range(H)) and rows == list(range(B))


def test_plan_picks_a_grid_of_units_by_rows_at_the_recipe_shapes():
    for B in (48, 64):
        for esize, backward in ((2, False), (2, True), (4, False)):
            p = L.recurrence_plan(B, 500, esize, backward)
            assert (p['nb_u'], p['nb_b'], p['rec_smem'],
                    p['mma']) == (32, 4, 1, int(esize == 2))
    with pytest.raises(ValueError, match='fits'):
        L.recurrence_plan(2, 4000, 2, backward=True)


def _partials(op, rec, p, rows):
    """gemm_fma (4 x 4 tiles, k quads) or gemm_mma (16 x 8 tiles, k steps
    of 16): item w = s tiles + tile sums the k steps s, s+S, ... of its
    tile (tiles: the plan's BT x Cp in tiles)."""
    TR, TC, KS = (16, 8, 16) if p['mma'] else (4, 4, 4)
    tiles_c, S, steps = p['Cp'] // TC, p['S'], p['Kp'] // KS
    tiles = p['BT'] // TR * tiles_c
    red = torch.zeros(S * tiles, TR * TC, dtype=op.dtype)
    for tile in range(-(-rows // TR) * tiles_c):
        tr, tc = divmod(tile, tiles_c)
        for s in range(S):
            for q in range(s, steps, S):
                red[s * tiles + tile] += (
                    op[TR * tr:TR * (tr + 1), KS * q:KS * (q + 1)]
                    @ rec[KS * q:KS * (q + 1), TC * tc:TC * (tc + 1)]
                ).reshape(-1)
    return red


def _gemm_sum(red, r, c, p):
    TR, TC = (16, 8) if p['mma'] else (4, 4)
    tiles = p['BT'] // TR * (p['Cp'] // TC)
    tile = (r // TR) * (p['Cp'] // TC) + c // TC
    return sum(red[s * tiles + tile, TC * (r % TR) + c % TC]
               for s in range(p['S']))


def _blocks(p, B, H):
    for blk in range(p['nb_u'] * p['nb_b']):
        ug, bg = blk % p['nb_u'], blk // p['nb_u']
        u0, b0 = ug * p['U'], bg * p['BB']
        b1 = min(B, b0 + p['BB'])
        for tb in range(b0, b1, p['BT']):
            yield ug, u0, min(p['U'], H - u0), tb, min(p['BT'], b1 - tb)


def _stage(src, rows, p):
    op = torch.zeros(p['BT'], p['Kp'], dtype=src.dtype)
    op[:rows, :src.shape[1]] = src[:rows]
    return op


def _emulate_forward(xw, rec, c0, h0, p):
    B, T, H4 = xw.shape
    H = H4 // 4
    recb = L.rec_blocks(rec, p, backward=False).double()
    out = torch.zeros(B, T, H, dtype=xw.dtype)
    c_run = torch.zeros(B, H, dtype=xw.dtype)
    acts = torch.zeros(B, T, H4, dtype=xw.dtype)
    for t in range(T):
        gemm = t > 0 or h0 is not None
        for ug, u0, nu, tb, rows in _blocks(p, B, H):
            if gemm:
                src = h0 if t == 0 else out[:, t - 1]
                red = _partials(_stage(src[tb:tb + rows], rows, p), recb[ug],
                                p, rows)
            for r in range(rows):
                for u in range(nu):
                    b, unit = tb + r, u0 + u
                    pre = [xw[b, t, g * H + unit] + (_gemm_sum(
                        red, r, g * p['U'] + u, p) if gemm else 0.0)
                        for g in range(4)]
                    ig, fg, og = (torch.sigmoid(pre[k]) for k in (0, 1, 3))
                    gg = torch.tanh(pre[2])
                    cp = (c_run[b, unit] if t > 0 else
                          (c0[b, unit] if c0 is not None else 0.0))
                    c_run[b, unit] = fg * cp + ig * gg
                    out[b, t, unit] = og * torch.tanh(c_run[b, unit])
                    for g, a in enumerate((ig, fg, gg, og)):
                        acts[b, t, g * H + unit] = a
    return out, c_run, acts


def _emulate_backward(acts, cs, rec, c0, dout, dc, dh, p):
    B, T, H4 = acts.shape
    H = H4 // 4
    recb = L.rec_blocks(rec, p, backward=True).double()
    dgates = torch.zeros_like(acts)
    dcs = torch.zeros(B, H, dtype=acts.dtype)
    dh0 = torch.zeros(B, H, dtype=acts.dtype)
    for t in range(T - 1, -2, -1):
        gemm = t < T - 1
        for ug, u0, nu, tb, rows in _blocks(p, B, H):
            if gemm:
                red = _partials(_stage(dgates[tb:tb + rows, t + 1], rows, p),
                                recb[ug], p, rows)
            for r in range(rows):
                for u in range(nu):
                    b, unit = tb + r, u0 + u
                    if t < 0:
                        dh0[b, unit] = _gemm_sum(red, r, u, p)
                        continue
                    dh_t = (_gemm_sum(red, r, u, p) if gemm
                            else dh[b, unit]) + dout[b, t, unit]
                    d = dcs[b, unit] if gemm else dc[b, unit]
                    ig, fg, gg, og = (acts[b, t, g * H + unit]
                                      for g in range(4))
                    c = cs[b, t, unit]
                    cp = cs[b, t - 1, unit] if t > 0 else c0[b, unit]
                    tc = torch.tanh(c)
                    d = d + dh_t * og * (1 - tc * tc)
                    for g, v in enumerate((d * gg * ig * (1 - ig),
                                           d * cp * fg * (1 - fg),
                                           d * ig * (1 - gg * gg),
                                           dh_t * tc * og * (1 - og))):
                        dgates[b, t, g * H + unit] = v
                    dcs[b, unit] = d * fg
    return dgates, dcs, dh0


@pytest.mark.parametrize('carry', [False, True])
@pytest.mark.parametrize('B,H,esize,sms,limit',
                         [c for c in PLAN_CASES if c[1] < 10])
def test_emulated_kernels_match_the_plain_versions(B, H, esize, sms, limit,
                                                   carry):
    T = 3
    gen = torch.Generator().manual_seed(4)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    # rec_blocks holds rec in f32, as the kernels do: draw f32 values
    xw, rec = draw(B, T, 4 * H), (0.5 * draw(H, 4 * H)).float().double()
    c0, h0 = (draw(B, H), draw(B, H)) if carry else (None, None)
    pf = L.recurrence_plan(B, H, esize, False, sms, limit)
    pb = L.recurrence_plan(B, H, esize, True, sms, limit)
    out, c, h, (acts, cs) = L.recurrence_reference(xw, rec, c0, h0, save=True)
    e_out, e_c, e_acts = _emulate_forward(xw, rec, c0, h0, pf)
    for a, b in ((e_out, out), (e_c, c), (e_acts, acts)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    dout, dc, dh = draw(B, T, H), draw(B, H), draw(B, H)
    zero = torch.zeros(B, H, dtype=torch.float64)
    dg, dc0, dh0 = L.recurrence_backward_reference(acts, cs, rec, c0, dout,
                                                   dc, dh)
    e_dg, e_dc0, e_dh0 = _emulate_backward(
        acts, cs, rec, zero if c0 is None else c0, dout, dc, dh, pb)
    for a, b in ((e_dg, dg), (e_dc0, dc0), (e_dh0, dh0)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
