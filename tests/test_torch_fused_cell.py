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


@pytest.mark.parametrize('impl', ['pallas', 'pallas_split', 'chunked',
                                  'masked_dense', 'native'])
def test_later_impls_are_refused(impl):
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        SearchCell(24, ARCHS[0], groups=4, grouped_impl=impl)


def test_forward_refuses_other_devices():
    spec = SearchCell(24, ARCHS[2], groups=4).spec
    with pytest.raises(ValueError, match='cuda or cpu'):
        fused_cell.fused_cell_forward(
            spec, torch.empty((1, 4, 24), device='meta'), [], None)
