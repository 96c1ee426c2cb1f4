"""The fused cell backward's conv nodes on the grouped conv's machinery, on
the CPU: the launch plans that ``fused_cell._launch_backward`` hands the
kernel (the grouped conv's dW and dx plans on the cell's dense [B, T, C]
tensors) cover every dW and dx output exactly once, and the dx kernel's
f32 epilogue (the sums stored or added unrounded into a gradient buffer),
emulated in numpy on flat memory, equals the buffer plus the plain input
gradient.  The VJP against the JAX kernel is tests/test_torch_fused_cell.py's."""

import numpy as np
import pytest
import torch

from nbasr_torch.models.cell import SearchCell
from nbasr_torch.models.layers import conv_padding
from nbasr_torch.ops import fused_cell, grouped_conv
from nbasr_torch.ops.grouped_conv import to_split

from test_torch_grouped_conv import (_check_dw_plan, _check_fwd_plan,
                                     _emulate_forward, _emulated_plan, _flat,
                                     _unflat)

CONV_OPS = ('conv5', 'conv5d2', 'conv7', 'conv7d2')
# (B, T, C, groups): the flagship's four widths at the train step's B=32,
# 50 groups of 24 channels, B=1
SHAPES = [(32, 300, 600, 100), (32, 300, 800, 100), (32, 150, 1000, 100),
          (32, 75, 1200, 100), (4, 75, 1200, 50), (1, 300, 600, 100)]
# three nodes of one op: no branches (node 0's dx rounds straight into dx,
# the others store into their buffers), or skips that name outputs 0 and 1
# (their nodes' dx add into the branch adds)
BRANCHES = {'none': ((0,), (0, 0), (0, 0, 0)),
            'skips': ((1,), (0, 1), (0, 0, 0))}


def _cell_desc(op, branches, C, groups, dtype):
    arch = [[op, *bits] for bits in BRANCHES[branches]]
    cell = SearchCell(C, arch, groups=groups)
    x = torch.zeros((1, 1, C), dtype=dtype)
    desc, _, _ = fused_cell._describe(cell.train_spec, x,
                                      cell.operands(dtype)[0])
    return cell.train_spec, desc


@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('branches', sorted(BRANCHES))
@pytest.mark.parametrize('B,T,C,groups', SHAPES)
@pytest.mark.parametrize('op', CONV_OPS)
def test_backward_plans_cover_every_output_once(op, B, T, C, groups,
                                                branches, esize):
    """Every conv node's plans as the kernel gets them: the dW plan's
    every row once and every (tap, channel, output) in one item, the dx
    plan's every (b, t, channel) of the node's input gradient in exactly
    one thread, on the dense strides; the output in the activation dtype
    for node 0 without branch adds, else f32 (stored, or added after the
    branch adds); the descriptor as the C entry point reads it."""
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    spec, desc = _cell_desc(op, branches, C, groups, dtype)
    modes = fused_cell.dx_outputs(desc)
    want = ([fused_cell.DX_OUT, fused_cell.DX_STORE, fused_cell.DX_STORE]
            if branches == 'none' else
            [fused_cell.DX_ADD, fused_cell.DX_ADD, fused_cell.DX_STORE])
    assert modes == want
    plans = fused_cell.backward_plans(desc, B, T, C, esize, (0, 0, 0), 0)
    ci = C // groups
    dense = (T * C, 1, C, ci)
    checked = []
    for node, (mode, dw, dx) in zip(spec.nodes, plans):
        assert mode == modes[len(checked)]
        key = (mode == fused_cell.DX_OUT, tuple(sorted(dw.items())),
               tuple(sorted(dx.items())))
        checked.append(key)
        if key in checked[:-1]:
            continue            # the same plans as an earlier node's
        _check_dw_plan(dw, B, T, groups, ci, ci, node.K, node.d, 'dense',
                       esize, dense, dense, ptrs=(0, 0))
        _check_fwd_plan(dx, B, T, groups, ci, ci, node.K, node.d, 'dense',
                        esize, dense, dense, ptrs=(0, 0),
                        y_esize=esize if mode == fused_cell.DX_OUT else 4)
    assert fused_cell.BWD_DESC_INTS == (8 + len(grouped_conv.DW_PLAN_FIELDS)
                                        + len(grouped_conv.FWD_PLAN_FIELDS))


def test_backward_plans_skip_other_nodes():
    """Linear and zero nodes keep their own kernels: no plan; a conv node
    that a later node names adds its dx."""
    spec, desc = _cell_desc('linear', 'none', 24, 4, torch.float32)
    assert fused_cell.dx_outputs(desc) == [None, None, None]
    cell = SearchCell(24, [['conv5', 0], ['zero', 1, 1], ['linear', 1, 0, 1]],
                      groups=4)
    desc, _, _ = fused_cell._describe(
        cell.train_spec, torch.zeros((1, 1, 24)),
        cell.operands(torch.float32)[0])
    assert fused_cell.dx_outputs(desc) == [fused_cell.DX_ADD, None, None]
    plans = fused_cell.backward_plans(desc, 2, 21, 24, 4, (0, 0, 0), 0)
    assert plans[0][0] == fused_cell.DX_ADD and plans[1:] == [None, None]


# (B, T, G, ci, K, d, plan choice): the fused cell's conv (co = ci) whose
# input gradient goes into an f32 buffer: the cells' asymmetric padding,
# dilation, tap chunks (K=9 in bf16), channel chunks, blocks of several
# units, output tiles in passes (blocks of at most 8 threads)
F32_DX = [
    (2, 13, 3, 4, 5, 1, 'plan'),
    (2, 13, 3, 6, 5, 2, 'chunks'),
    (3, 21, 4, 3, 7, 2, 'span'),
    (2, 11, 3, 4, 9, 1, 'chunks'),
    (3, 20, 2, 14, 5, 1, 'passes'),
]


@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('add', [False, True], ids=['store', 'add'])
@pytest.mark.parametrize('B,T,G,ci,K,d,choice', F32_DX)
def test_f32_dx_emulation_matches_reference(B, T, G, ci, K, d, choice, add,
                                            esize, monkeypatch):
    """The fused backward's conv dx: the grouped dx kernel's body (weights
    staged transposed and tap-reversed, halo mirrored) on dz in the dense
    layout, its f32 sums through an f32 output tile (over the x tile where
    it fits) into an f32 buffer that holds branch adds (``add``: prior +
    dx) or nothing yet (stored), emulated in numpy on flat memory with the
    plan fwd_plan makes for an f32 output, equals prior + conv_dx_reference;
    with the loader's bound on the utterance off, a halo that reads the
    neighbouring utterance shows."""
    if choice == 'passes':
        monkeypatch.setattr(grouped_conv, 'FWD_THREADS', 8)
    co = ci
    rng = np.random.RandomState(B * T + ci + K)
    dz = rng.randn(B, T, G * co)
    w = rng.randn(K, ci, G * co) * 0.3
    prior = rng.randn(B, T, G * ci) if add else np.zeros((B, T, G * ci))
    lpad = conv_padding(K, d, 1)[0]
    zf, zst = _flat(dz, 'dense', G)
    pf, xst = _flat(prior, 'dense', G)
    p = _emulated_plan(B, T, G, co, ci, K, d, esize, zst, xst, choice, 'dx',
                       y_esize=4)
    if choice == 'passes':
        assert p['y_buf'] > 0 and p['threads'] <= 8
    if choice == 'span':
        assert p['span'] > 1
    want = grouped_conv.conv_dx_reference(
        to_split(torch.from_numpy(dz), G), torch.from_numpy(w), lpad, d,
        torch.empty((B, ci, T, G), dtype=torch.float64)).numpy()
    want = want + _unflat(pf, xst, B, ci, T, G)

    def emulate(bounds):
        return _unflat(_emulate_forward(
            zf, zst, w, None, xst, p, B, T, G, co, ci, K, d,
            (K - 1) * d - lpad, esize, bounds=bounds, dx=True, y_esize=4,
            prior=pf if add else None), xst, B, ci, T, G)

    scale = np.abs(want).max()
    # the plain version sums in f32, the emulation in f64
    np.testing.assert_allclose(emulate(True), want, rtol=0, atol=1e-5 * scale)
    assert np.abs(emulate(False) - want).max() > 1e-2 * scale


def _bf16(a):
    """float32 values rounded to bf16 (round to nearest even), as float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _emulate_chunked_dw(src, dz, chunks):
    """The tensor-core dW's sums as the kernels take them, in float32: each
    row chunk's partial (the kernel's k tiles kt0 = k_tiles * chunk /
    chunks of fused_cell.MMA_TILE_K rows, the products exact and the sum in
    row order), then nbasr_linear_dw_reduce's sum of the partials in chunk
    order; the f32 result before the rounding to bf16."""
    rows = src.shape[0]
    bk = fused_cell.MMA_TILE_K
    k_tiles = -(-rows // bk)
    kt = [k_tiles * c // chunks for c in range(chunks + 1)]
    total = None
    for c in range(chunks):
        part = np.zeros((src.shape[1], dz.shape[1]), np.float32)
        for r in range(kt[c] * bk, min(kt[c + 1] * bk, rows)):
            part = part + np.outer(src[r], dz[r]).astype(np.float32)
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize('C,rows', [(24, 200), (24, 1000), (16, 4099),
                                    (64, 777)])
def test_dw_chunked_ordered_sum_matches_float64(C, rows):
    """dW split over the plan's row chunks and summed in chunk order:
    within float32 rounding of the float64 sum of the same bf16 products
    (rows ulps of the summed magnitudes), one bf16 ulp of the float64
    sum's rounding after the one rounding to bf16, and the same bits on two
    emulations (one order per output: no atomics)."""
    g = np.random.default_rng(C * rows)
    src = _bf16(g.standard_normal((rows, C)).astype(np.float32))
    dz = _bf16(g.standard_normal((rows, C)).astype(np.float32))
    chunks = fused_cell.dw_chunks(rows, C)
    assert chunks > 1 or rows < fused_cell.DW_MIN_K_TILES * 2 * 64
    got = _emulate_chunked_dw(src, dz, chunks)
    again = _emulate_chunked_dw(src, dz, chunks)
    assert np.array_equal(got.view(np.uint32), again.view(np.uint32))
    exact = src.astype(np.float64).T @ dz.astype(np.float64)
    mag = np.abs(src.astype(np.float64)).T @ np.abs(dz.astype(np.float64))
    eps = np.finfo(np.float32).eps
    assert (np.abs(got - exact) <= rows * eps * mag).all()
    rounded = _bf16(got)
    want = _bf16(exact.astype(np.float32))
    ulp = np.abs(want) * 2.0 ** -7 + np.finfo(np.float32).tiny
    assert (np.abs(rounded - want) <= ulp).all()
