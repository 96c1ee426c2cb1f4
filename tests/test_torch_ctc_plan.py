"""The CTC recursions at the state widths the kernels' two paths meet, and
their launch plan, on the CPU.

The port runs the plain versions of its alpha and beta kernels here; they
are held against the JAX package's Pallas kernels in interpret mode and
its XLA scans at the main path's widths (S=65 at the train step's T=75,
an eval batch's S=161), at the warp path's edge (S_WARP - 1, S_WARP,
S_WARP + 1) and on degenerate rows: one frame, one state (a batch with
no labels), rows whose every entry is a floor.  Then
``ctc_pallas.recursion_plan``, which picks the kernels' path, over every
width from 1 to 8193."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nbasr_tpu.ops import ctc as jctc
from nbasr_tpu.ops import ctc_pallas as jcp

from nbasr_torch.ops import ctc_pallas
from nbasr_torch.ops.ctc_pallas import S_WARP, recursion_plan

from test_torch_ctc import STACK_ATOL, STACK_RTOL, _same_stack

NEG = -1e30
# (T, B, S, rows whose every emission is a floor)
CASES = {
    'train step S=65': (75, 3, 65, ()),
    'eval S=161': (24, 2, 161, ()),
    'S_WARP-1': (12, 2, S_WARP - 1, ()),
    'S_WARP': (12, 2, S_WARP, ()),
    'S_WARP+1': (12, 2, S_WARP + 1, ()),
    'T=1': (1, 3, 65, ()),
    'S=1': (9, 3, 1, ()),
    'all floors': (10, 3, 33, (1,)),
}


def _operands(T, B, S, floored, seed):
    """em of log-probability size with a -1e30 sprinkle (certain-blank
    padding puts such entries in real rows) and whole floored rows; a skip
    mask off in the first two states and on 40% of the others (the loss's
    masks skip only into label states; the kernels take any mask); one or
    two final states a row."""
    rng = np.random.RandomState(seed)
    em = (-np.abs(rng.randn(T, B, S)) * 3).astype(np.float32)
    em[rng.rand(T, B, S) < 0.05] = NEG
    for b in floored:
        em[:, b] = NEG
    skip = rng.rand(B, S) < 0.4
    skip[:, :2] = False
    final = np.zeros((B, S), bool)
    final[:, S - 1] = True
    final[:, max(S - 2, 0)] = rng.rand(B) < 0.7
    return em, skip, final


# Every case against both JAX references, but beta at S=1: the JAX
# package's beta has no answer there (its Pallas kernel rolls the lanes by
# S - 2, which pltpu.roll refuses when negative; its scan concatenates a
# [B, 2] fill to a [B, 1] row), so test_beta_at_one_state holds the port
# to the recursion's definition instead.
PARAMS = [(case, recursion, reference) for case in CASES
          for recursion in ('alpha', 'beta')
          for reference in ('pallas_interpret', 'xla_scan')
          if (case, recursion) != ('S=1', 'beta')]


@pytest.mark.parametrize('case,recursion,reference', PARAMS)
def test_recursion_matches_jax_at_every_path_edge(case, recursion, reference):
    """The plain recursion (the kernels' yardstick on the card) against
    the JAX package at the file's own STACK_RTOL/ATOL, floors floored on
    both sides; a floored row stays floored at every step."""
    T, B, S, floored = CASES[case]
    em, skip, final = _operands(T, B, S, floored, seed=T * 1000 + S)
    jem, jskip, jfinal = (jnp.asarray(a) for a in (em, skip, final))
    if recursion == 'alpha':
        want = (jcp.alpha_scan_pallas(jem, jskip, interpret=True)
                if reference == 'pallas_interpret'
                else jctc._alpha_scan(jem, jskip))
        got = ctc_pallas.alpha_scan_pallas(torch.from_numpy(em),
                                           torch.from_numpy(skip))
    else:
        want = (jcp.beta_scan_pallas(jem, jskip, jfinal, interpret=True)
                if reference == 'pallas_interpret'
                else jctc._beta_scan(jem, jskip, jfinal))
        got = ctc_pallas.beta_scan_pallas(*(torch.from_numpy(a) for a in
                                            (em, skip, final)))
    assert tuple(got.shape) == (T, B, S)
    finite, _ = _same_stack(got, want)
    assert finite > 0
    for b in floored:
        rows = got.numpy()[:, b]
        # alpha's first step and beta's last keep their own init
        rows = rows[1:] if recursion == 'alpha' else rows[:-1]
        assert (rows <= -1e29).all()


def _np_log_add(a, b):
    mx = np.maximum(a, b)
    mx = np.where(mx <= NEG, np.float32(0), mx)
    return mx + np.log(np.exp(a - mx) + np.exp(b - mx))


def test_beta_at_one_state():
    """S=1 (a batch without labels): no neighbour and no skip, so
    beta[t] = la(beta[t+1] + em[t+1], -1e30) from beta[T-1] = 0 on a final
    state, -1e30 elsewhere; a row with no final state stays floored."""
    T, B, S, _ = CASES['S=1']
    em, skip, final = _operands(T, B, S, (), seed=11)
    final[1] = False
    want = np.empty((T, B, S), np.float32)
    want[-1] = np.where(final, np.float32(0), np.float32(NEG))
    with np.errstate(divide='ignore'):
        for t in range(T - 2, -1, -1):
            want[t] = _np_log_add(want[t + 1] + em[t + 1], np.float32(NEG))
    got = ctc_pallas.beta_scan_pallas(*(torch.from_numpy(a) for a in
                                        (em, skip, final)))
    _same_stack(got, want)
    assert (got.numpy()[:, 1] <= -1e29).all()


def _emulate_warp(recursion, em, skip, final):
    """The warp path of ctc.cu in numpy, warp by warp and step by step: warp
    p holds 64 states, two a lane (lane l: local states 2l, 2l + 1), at
    global base + local with base = p*WARP_OWN - 16 (alpha) or p*WARP_OWN
    (beta); it owns the top WARP_OWN (alpha) or the bottom WARP_OWN (beta)
    and borrows the other 16 from warp p-1 (alpha) or p+1 (beta) at the
    start of every window of WARP_HALO steps but the first.  A neighbour
    past the warp's lanes is -1e30, a state past the row held at -1e30; the
    second log_add only where the state skips."""
    T, B, S = em.shape
    own, halo = ctc_pallas.WARP_OWN, ctc_pallas.WARP_HALO
    warps = -(-S // own)
    neg = np.float32(NEG)
    out = np.full((T, B, S), np.nan, np.float32)
    lo = 0 if recursion == 'beta' else -2 * halo
    glob = [p * own + lo + np.arange(64) for p in range(warps)]
    valid = [(g >= 0) & (g < S) for g in glob]
    pick = lambda x, g, v, fill: np.where(v, x[..., np.clip(g, 0, S - 1)], fill)
    if recursion == 'alpha':
        sk = [pick(skip, g, v, False) for g, v in zip(glob, valid)]
        owned = [np.arange(64) >= 2 * halo] * warps
    else:
        nxt = np.concatenate([skip[:, 2:], np.zeros((B, 2), bool)], 1)
        sk = [pick(nxt, g, v, False) for g, v in zip(glob, valid)]
        owned = [np.arange(64) < own] * warps

    def put(t, p, x):
        keep = owned[p] & valid[p]
        out[t][:, glob[p][keep]] = x[:, keep]

    with np.errstate(divide='ignore', invalid='ignore'):
        if recursion == 'alpha':
            a = [np.where(v & (g < 2), pick(em[0], g, v, neg), neg) for g, v in zip(glob, valid)]
            for p in range(warps):
                put(0, p, a[p])
            for t in range(1, T):
                if t > 1 and (t - 1) % halo == 0:
                    for p in range(1, warps):
                        a[p] = a[p].copy()
                        a[p][:, :2 * halo] = a[p - 1][:, 64 - 2 * halo:]
                for p in range(warps):
                    x = a[p]
                    m1 = np.concatenate([np.full((B, 1), neg), x[:, :-1]], 1)
                    m2 = np.concatenate([np.full((B, 2), neg), x[:, :-2]], 1)
                    v = _np_log_add(x, m1)
                    v = np.where(sk[p], _np_log_add(v, m2), v)
                    a[p] = np.where(valid[p], v + pick(em[t], glob[p], valid[p], 0), neg)
                    put(t, p, a[p])
        else:
            inc = []
            for p in range(warps):
                b = np.where(pick(final, glob[p], valid[p], False), np.float32(0), neg)
                put(T - 1, p, b)
                inc.append(np.where(valid[p], b + pick(em[T - 1], glob[p], valid[p], 0), neg))
            for i in range(T - 1):
                t = T - 2 - i
                if i > 0 and i % halo == 0:
                    for p in range(warps - 1):
                        inc[p] = inc[p].copy()
                        inc[p][:, own:] = inc[p + 1][:, :2 * halo]
                for p in range(warps):
                    x = inc[p]
                    p1 = np.concatenate([x[:, 1:], np.full((B, 1), neg)], 1)
                    p2 = np.concatenate([x[:, 2:], np.full((B, 2), neg)], 1)
                    v = _np_log_add(x, p1)
                    v = np.where(sk[p], _np_log_add(v, p2), v)
                    put(t, p, v)
                    inc[p] = np.where(valid[p], v + pick(em[t], glob[p], valid[p], 0), neg)
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize('recursion', ['alpha', 'beta'])
@pytest.mark.parametrize('T', [9, 30])
@pytest.mark.parametrize('S', [1, 2, 33, 48, 49, 65, 96, 97, 161, 255, 256])
def test_warp_path_emulation_matches_plain(recursion, S, T):
    """The warp path's layout, shuffles and handovers, emulated at the
    plan's warps, give the plain version's stack: every edge of the lanes,
    the warps, the windows (T=9 ends with the first window) and the row."""
    em, skip, final = _operands(T, 2, S, (), seed=S + T)
    assert recursion_plan(T, 2, S)['warps'] == -(-S // ctc_pallas.WARP_OWN)
    got = _emulate_warp(recursion, em, skip, final)
    args = [torch.from_numpy(a) for a in (em, skip, final)]
    want = (ctc_pallas.alpha_scan_reference(*args[:2]) if recursion == 'alpha'
            else ctc_pallas.beta_scan_reference(*args))
    _same_stack(torch.from_numpy(got), want.numpy())


def test_stack_tolerance_is_the_jax_packages():
    """The tolerance above is tests/test_ctc_pallas.py's for the JAX
    package's own kernels against its scans."""
    assert (STACK_RTOL, STACK_ATOL) == (1e-5, 1e-4)


# the shared memory a block may opt in to: an H100, a card without the
# opt-in (48 KB), a smaller one
LIMITS = (232448, 49152, 101376)


@pytest.mark.parametrize('limit', LIMITS)
def test_plan_gives_every_width_one_path(limit):
    """S = 1 ... 8193: the warp path takes every S <= S_WARP, on as many
    warps as it takes to own S states; beyond it the block path, whose
    shared memory fits the limit, the state in the global scratch where it
    does not fit beside the ring; a row whose ring alone does not fit is
    refused, on an H100 none up to 8193 states."""
    for S in range(1, 8194):
        ring_bytes = 4 * S * ctc_pallas.BLOCK_RING
        if S > S_WARP and ring_bytes > limit:
            assert limit < ctc_pallas.H100_SHARED_LIMIT, S
            with pytest.raises(ValueError):
                recursion_plan(75, 32, S, limit)
            continue
        plan = recursion_plan(75, 32, S, limit)
        assert plan['path'] == ('warp' if S <= S_WARP else 'block'), S
        if plan['path'] == 'warp':
            warps = plan['warps']
            assert warps * ctc_pallas.WARP_OWN >= S > (warps - 1) * ctc_pallas.WARP_OWN, S
            assert plan['threads'] == 32 * warps <= 192
            assert (plan['ring'], plan['state'], plan['smem']) == (0, 'registers', 0)
            continue
        assert plan['threads'] == 32 * plan['warps'] == min(
            ctc_pallas.BLOCK_THREADS, 32 * -(-S // 32)), S
        assert plan['ring'] == ctc_pallas.BLOCK_RING, S
        words = plan['ring'] + (2 if plan['state'] == 'shared' else 0)
        assert plan['smem'] == 4 * S * words <= limit, S
        if plan['state'] == 'global':   # the state did not fit beside the ring
            assert ring_bytes + 8 * S > limit, S


@pytest.mark.parametrize('T,B', [(1, 1), (75, 32), (200, 16), (4000, 4096)])
def test_plan_depends_on_the_row_alone(T, B):
    """T and B change nothing: one block a row."""
    for S in (65, 161, 257, 8193):
        assert recursion_plan(T, B, S) == recursion_plan(1, 1, S)


def test_plan_long_rows():
    """Past the shared memory: the state to the global scratch beside the
    ring, and a row whose ring does not fit refused."""
    assert recursion_plan(40, 4, 8193)['state'] == 'shared'
    assert recursion_plan(40, 4, 14528)['state'] == 'shared'
    plan = recursion_plan(24, 2, 14529)
    assert (plan['state'], plan['ring'], plan['smem']) == ('global', 2, 8 * 14529)
    plan = recursion_plan(24, 2, 24577)
    assert (plan['state'], plan['ring']) == ('global', 2)
    assert recursion_plan(2, 1, 29056)['state'] == 'global'
    with pytest.raises(ValueError):
        recursion_plan(2, 1, 29057)
    with pytest.raises(ValueError):
        recursion_plan(0, 1, 5)
    with pytest.raises(ValueError):
        recursion_plan(3, 1, 0)


def test_launch_args_and_operands():
    """The plan's ints in the order the kernel reads them, a scratch only
    for a global state; masks of any dtype taken as bool."""
    em = torch.zeros((3, 2, 24577))
    ints, state = ctc_pallas._launch_args(em, recursion_plan(3, 2, 24577))
    assert list(ints) == [1, 32, 1024, 2] and state.shape == (2, 2, 24577)
    em = torch.zeros((3, 2, 65))
    ints, state = ctc_pallas._launch_args(em, recursion_plan(3, 2, 65))
    assert list(ints) == [0, 2, 64, 0] and state is None
    _, _, _, (m,) = ctc_pallas._operands(em, (torch.tensor([[0.0, 2.0] * 32 + [1.0]] * 2),))
    assert m.dtype == torch.bool and m.is_contiguous() and int(m.sum()) == 66
