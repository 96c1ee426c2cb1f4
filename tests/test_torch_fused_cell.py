"""The port's SearchCell (nbasr_torch, plain version of the fused cell kernel
on the CPU) against the JAX SearchCell: the fused Pallas kernel in
interpret mode and the chunked XLA lowering, same inputs, same weights."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import nbasr_tpu.ops.fused_cell as jax_fused_cell
from nbasr_tpu.models.cell import SearchCell as JaxSearchCell

from nbasr_torch.convert import from_flax
from nbasr_torch.models.cell import SearchCell
from nbasr_torch.ops import fused_cell

ARCHS = [
    (('conv5', 0), ('conv5', 0, 0), ('conv5', 0, 0, 0)),     # flagship
    (('conv5d2', 1), ('conv7', 1, 0), ('conv7d2', 0, 1, 1)),  # dilated+branches
    (('linear', 0), ('zero', 1, 1), ('conv5', 1, 0, 1)),      # linear+zero
]
ARCH_IDS = ['flagship', 'dilated', 'zero+lin']

# f32 on both sides, sums in another order: a few ulps of O(1) outputs
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fused_cell, 'INTERPRET', True)
    with jax.default_matmul_precision('highest'), torch.no_grad():
        yield


def _x(B=2, T=21, C=24, seed=0):
    return np.random.RandomState(seed).randn(B, T, C).astype(np.float32)


def _pair(arch, impl, dtype=jnp.float32, seed=0, **kw):
    """JAX cell output and the port's output on the JAX cell's weights."""
    kw = dict(filters=24, arch_desc=arch, groups=4, init_scheme='scaled', **kw)
    cell = JaxSearchCell(dropout_rate=0.0, grouped_impl=impl, **kw)
    x = _x(seed=seed)
    v = cell.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    want = np.asarray(cell.apply(v, jnp.asarray(x, dtype)).astype(jnp.float32))
    port = SearchCell(**kw)
    port.load_state_dict(from_flax(v))
    got = port(torch.from_numpy(x).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))
    return want, got.float().numpy()


@pytest.mark.parametrize('impl', ['fused', 'chunked'])
@pytest.mark.parametrize('arch', ARCHS, ids=ARCH_IDS)
def test_cell_matches_jax(arch, impl):
    want, got = _pair(arch, impl)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_no_norm_variant():
    want, got = _pair(ARCHS[0], 'fused', use_norm=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize('arch', ARCHS[1:], ids=ARCH_IDS[1:])
def test_tf_quirk_toggles_flow_through(arch):
    want, got = _pair(arch, 'fused', seed=2, branch_semantics='tf_inverted',
                      apply_dilation=False, pad_math='tf')
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize('arch', ARCHS, ids=ARCH_IDS)
def test_bf16_rounding_points(arch):
    """bf16 through the TPU kernel's rounding points (node outputs rounded
    to bf16, f32 bias and LayerNorm).  The two sides sum in another order,
    which rarely moves a rounded value by one bf16 ulp; one ulp of the
    output scale (2^-8) bounds that, and a version that skips the node
    roundings misses it (0.5-0.8% of the scale at these inputs)."""
    want, got = _pair(arch, 'fused', dtype=jnp.bfloat16, seed=3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


def test_cpu_runs_the_plain_version():
    fused_cell.reset_launches()
    SearchCell(24, ARCHS[2], groups=4)(torch.from_numpy(_x()))
    assert fused_cell.LAUNCHES == {'kernel': 0, 'plain': 1}


@pytest.mark.parametrize('impl', ['chunked', 'masked_dense', 'native'])
def test_later_impls_are_refused(impl):
    """The JAX package's XLA lowerings, once refused here, now run: the same
    eval output as the fused cell on the same weights (1e-5 of max: f32
    sums in another order), and no fused cell call."""
    fused = SearchCell(24, ARCHS[0], groups=4)
    cell = SearchCell(24, ARCHS[0], groups=4, grouped_impl=impl)
    state = fused.state_dict()
    if impl == 'native':   # nn.Conv's layout: [C, ci, K]
        state = {k.replace('conv_kernel_grouped', 'conv.weight').replace(
            'conv_bias', 'conv.bias'): v.permute(2, 1, 0).contiguous()
                 if k.endswith('conv_kernel_grouped') else v
                 for k, v in state.items()}
    cell.load_state_dict(state)
    x = torch.from_numpy(_x())
    want = fused(x).detach()
    fused_cell.reset_launches()
    got = cell(x).detach()
    assert fused_cell.LAUNCHES == {'kernel': 0, 'plain': 0}
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_forward_refuses_other_devices():
    spec = SearchCell(24, ARCHS[2], groups=4).spec
    with pytest.raises(ValueError, match='cuda or cpu'):
        fused_cell.fused_cell_forward(
            spec, torch.empty((1, 4, 24), device='meta'), [], None)


# ---------------------------------------------------------------------------
# training: dropout and the backward, against fused_cell_apply's VJP
# ---------------------------------------------------------------------------

SEED = np.array([123, 456789], np.int32)
# one bf16 ulp of the scale: the two sides round at the same points and sum
# in another order, which rarely moves a rounded value by one ulp
BF16_ULP = 2.0 ** -8


def _jax_spec(spec, rate, one_group_chunks=False):
    """The JAX kernel's spec of a port spec: its conv weights in one
    block-diagonal chunk, or in one chunk per group."""
    nodes = []
    for n in spec.nodes:
        if n.kind == 'conv':
            nodes.append(jax_fused_cell.ConvNode(
                n.K, n.d, n.lpad, n.rpad, n.groups,
                n.groups if one_group_chunks else 1, n.cin_pg, n.cout_pg,
                n.branches))
        elif n.kind == 'linear':
            nodes.append(jax_fused_cell.LinearNode(n.branches))
        else:
            nodes.append(jax_fused_cell.ZeroNode(n.branches))
    return jax_fused_cell.FusedCellSpec(nodes, dropout_rate=rate, train=True,
                                        ln_eps=spec.ln_eps,
                                        use_norm=spec.use_norm)


def _cell_inputs(spec, zero_rows, C=24, seed=0):
    """x, flat compact (w, b) per node, ln, dy; zeroed rows 8-16 with zero
    biases put whole windows of pre-activations exactly at 0 (ties)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 21, C).astype(np.float32)
    if zero_rows:
        x[:, 8:16] = 0.0
    ws = []
    for n in spec.nodes:
        if n.kind == 'zero':
            continue
        w = (rng.randn(n.K, n.cin_pg, C) * 0.3 if n.kind == 'conv'
             else rng.randn(C, C) * 0.2)
        b = np.zeros(C) if zero_rows else rng.randn(C) * 0.1
        ws += [w.astype(np.float32), b.astype(np.float32)]
    ln = [(1 + 0.1 * rng.randn(C)).astype(np.float32),
          (0.1 * rng.randn(C)).astype(np.float32)]
    dy = rng.randn(2, 21, C).astype(np.float32)
    return x, ws, ln, dy


def _vjp_pair(arch, rate, zero_rows, dtype, C=24, groups=4):
    """(JAX y and VJP, port y and grads) of one training cell on the same
    numpy inputs and seed; JAX's expand_chunked sits inside the function
    under jax.vjp, so its dW comes back compact."""
    spec = SearchCell(C, arch, groups=groups, dropout_rate=rate).train_spec
    x, ws, ln, dy = _cell_inputs(spec, zero_rows, C=C)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jspec = _jax_spec(spec, rate)

    def f(x, ws, ln):
        ops, i = [], 0
        for n in spec.nodes:
            if n.kind == 'zero':
                continue
            w, b = ws[i], ws[i + 1]
            i += 2
            if n.kind == 'conv':
                w = jax_fused_cell.expand_chunked(w, n.groups, 1)
            ops += [w.astype(jdt), b]
        return jax_fused_cell.fused_cell_apply(jspec, x.astype(jdt), ops, ln,
                                               jnp.asarray(SEED))

    y, vjp = jax.vjp(f, jnp.asarray(x), [jnp.asarray(w) for w in ws],
                     [jnp.asarray(v) for v in ln])
    gx, gws, gln = vjp(jnp.asarray(dy).astype(y.dtype))
    want = [y, gx, *gws, *gln]

    with torch.enable_grad():
        xt = torch.tensor(x, requires_grad=True)
        wt = [torch.tensor(w, requires_grad=True) for w in ws]
        lt = [torch.tensor(v, requires_grad=True) for v in ln]
        ops = [w.to(dtype) if i % 2 == 0 else w for i, w in enumerate(wt)]
        yt = fused_cell.fused_cell_forward(spec, xt.to(dtype), ops, lt,
                                           torch.tensor(SEED))
        yt.backward(torch.tensor(dy).to(dtype))
    got = [yt, xt.grad, *(w.grad for w in wt), *(v.grad for v in lt)]
    return ([np.asarray(jnp.asarray(a, jnp.float32)) for a in want],
            [t.detach().float().numpy() for t in got])


@pytest.mark.parametrize('zero_rows', [False, True], ids=['', 'ties'])
@pytest.mark.parametrize('rate', [0.0, 0.5])
@pytest.mark.parametrize('arch', ARCHS, ids=ARCH_IDS)
def test_cell_vjp_matches_jax(arch, rate, zero_rows):
    """Output, dx, every compact dW and db, dscale and dbias within 1e-5 of
    each tensor's scale in f32 (sums in another order); with dropout 0.5
    the masks must be the same, or the outputs differ by O(1)."""
    want, got = _vjp_pair(arch, rate, zero_rows, torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * np.abs(w).max())


@pytest.mark.parametrize('arch', ARCHS, ids=ARCH_IDS)
def test_cell_vjp_bf16_matches_jax(arch):
    want, got = _vjp_pair(arch, 0.5, True, torch.bfloat16)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=BF16_ULP * np.abs(w).max())


@pytest.mark.parametrize('arch', ARCHS[:2], ids=ARCH_IDS[:2])
def test_cell_vjp_wide_groups_matches_jax(arch):
    """Groups of 24 input channels (C=48, 2 groups), wider than 16: the
    plain version against JAX within 1e-5 of each tensor's scale in f32,
    as the narrow groups."""
    want, got = _vjp_pair(arch, 0.5, False, torch.float32, C=48, groups=2)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * np.abs(w).max())


def test_tie_gradient_matches_jax():
    """Regression: with zero biases and zeroed input rows, whole windows of
    pre-activations sit exactly at 0, where the JAX kernel's clip-ReLU gate
    passes half the gradient (jnp.clip's VJP); a cell differentiated
    through torch.clamp passes all of it and gets the bias gradients
    wrong by a fifth of their size."""
    kw = dict(filters=24, arch_desc=ARCHS[0], groups=4, init_scheme='scaled')
    jcell = JaxSearchCell(dropout_rate=0.0, grouped_impl='fused', **kw)
    x = _x()
    x[:, 8:16] = 0.0
    v = jcell.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.grad(lambda p: jnp.sum(jcell.apply(
        {'params': p}, jnp.asarray(x)) ** 2))(v['params'])
    port = SearchCell(**kw)
    port.load_state_dict(from_flax(v))
    with torch.enable_grad():
        (port(torch.from_numpy(x)) ** 2).sum().backward()
    want = from_flax({'params': want})
    for name, p in port.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=ATOL * np.abs(w).max(), err_msg=name)


def test_dropout_bits_are_the_jax_interpret_hash():
    prng = jax_fused_cell._Prng()
    assert prng.interpret
    for pid, s in ((0, (0, 0)), (3, (2147483646, 17)), (1, (-5, 123456789))):
        prng.seed(jnp.int32(s[0]), jnp.int32(s[1]), jnp.int32(pid))
        seed = torch.tensor(s, dtype=torch.int32)
        for counter in (1, 2, 3):
            want = np.asarray(prng.bits((7, 40)))
            got = fused_cell.dropout_bits(seed, counter, pid + 1, 7, 40)[pid]
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_training_cpu_goes_through_fused_cell():
    cell = SearchCell(24, ARCHS[2], groups=4).train()
    x = torch.from_numpy(_x())
    fused_cell.reset_launches()
    with torch.enable_grad():
        y = cell(x, torch.Generator().manual_seed(0))
        assert type(y.grad_fn).__name__ == 'FusedCellBackward'
        y.sum().backward()
    assert fused_cell.LAUNCHES == {'kernel': 0, 'plain': 1}
    assert fused_cell.BACKWARD_LAUNCHES == {'kernel': 0, 'plain': 1}
    assert all(p.grad is not None for p in cell.parameters())


def test_dropout_seed_comes_from_the_callers_generator():
    cell = SearchCell(24, ARCHS[0], groups=4).train()
    x = torch.from_numpy(_x())
    with pytest.raises(ValueError, match='torch.Generator'):
        cell(x)
    a = cell(x, torch.Generator().manual_seed(5))
    b = cell(x, torch.Generator().manual_seed(5))
    c = cell(x, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(cell.eval()(x), cell(x), rtol=0, atol=0)


def test_kernel_launch_refuses_to_detach():
    cell = SearchCell(24, ARCHS[2], groups=4)
    x = torch.from_numpy(_x()).requires_grad_()
    with torch.enable_grad(), pytest.raises(RuntimeError, match='detach'):
        fused_cell._launch(cell.spec, x, *cell.operands(torch.float32),
                           None, save=False)


# (b, t, channel, value) planted in x: NaN, +inf and -inf in the two
# utterances, far enough apart that no conv window holds two of them
NONFINITE = ((0, 3, 5, np.nan), (1, 9, 17, np.inf), (1, 17, 2, -np.inf))


@pytest.mark.parametrize('use_norm', [True, False], ids=['norm', 'no_norm'])
@pytest.mark.parametrize('rate', [0.0, 0.5])
@pytest.mark.parametrize('arch', ARCHS, ids=ARCH_IDS)
def test_nonfinite_inputs_match_jax(arch, rate, use_norm):
    """NaN, +inf and -inf in x: the plain version and the JAX kernel in
    interpret mode put NaN, +inf and -inf in the same places (the clip
    passes NaN, as jnp.clip does; +-inf clip to 20 and 0, and branch adds
    carry them), and their finite values agree within 1e-5 of the finite
    scale, as at finite inputs.  The JAX kernel runs one group per weight
    chunk: with several groups in a chunk its block-diagonal product
    multiplies a NaN or inf by the other groups' zero weights and spreads
    NaN over the chunk, a trait of the TPU layout that neither the port's
    kernel nor its plain version (compact weights) has."""
    spec = SearchCell(24, arch, groups=4, dropout_rate=rate,
                      use_norm=use_norm).train_spec
    x, ws, ln, _ = _cell_inputs(spec, False)
    for b, t, c, v in NONFINITE:
        x[b, t, c] = v
    jspec = _jax_spec(spec, rate, one_group_chunks=True)
    ops, i = [], 0
    for n in spec.nodes:
        if n.kind == 'zero':
            continue
        w = jnp.asarray(ws[i])
        if n.kind == 'conv':
            w = jax_fused_cell.expand_chunked(w, n.groups, n.groups)
        ops += [w, jnp.asarray(ws[i + 1])]
        i += 2
    want = np.asarray(jax_fused_cell.fused_cell_apply(
        jspec, jnp.asarray(x), ops, [jnp.asarray(v) for v in ln],
        jnp.asarray(SEED)))
    got = fused_cell.fused_cell_reference(
        spec, torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(v) for v in ln], torch.tensor(SEED)).numpy()
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want), err_msg=str(test))
    finite = np.isfinite(want)
    assert np.isnan(want).any() and finite.any()
    scale = np.abs(want[finite]).max()
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=ATOL * scale)
