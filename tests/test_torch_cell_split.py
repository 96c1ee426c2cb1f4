"""The port's unfused cell paths, ``grouped_impl='pallas'`` and
``'pallas_split'`` (plain versions of the grouped conv kernels on the
CPU), against the JAX package with the same ``grouped_impl``: SearchCell
and a two-block ASRModel (logits and loss gradients, weights through
``convert.from_flax``), one Trainer step, the dropout masks the three
implementations share, and the ``train.py`` twin end to end."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import nbasr_tpu.ops.cell_ops as jax_cell_ops
import nbasr_tpu.ops.grouped_conv as jax_grouped_conv
from nbasr_tpu.data import get_dataloaders as jax_get_dataloaders
from nbasr_tpu.models.asr import ASRModel as JaxASRModel
from nbasr_tpu.models.asr import get_model as jax_get_model
from nbasr_tpu.models.asr import logits_length as jax_logits_length
from nbasr_tpu.models.cell import SearchCell as JaxSearchCell
from nbasr_tpu.training import conv_l2 as jax_conv_l2
from nbasr_tpu.training import get_loss as jax_get_loss
from nbasr_tpu.training import get_trainer as jax_get_trainer

from nbasr_torch.convert import from_flax, to_flax
from nbasr_torch.data.pipeline import get_dataloaders
from nbasr_torch.models.asr import ASRModel, get_model
from nbasr_torch.models.cell import SearchCell
from nbasr_torch.ops import grouped_conv
from nbasr_torch.ops.grouped_conv import from_split, to_split
from nbasr_torch.training import Trainer, get_loss

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMPLS = ['pallas', 'pallas_split']
# tests/test_cell_split.py's archs: linear + dilated + skips; zero + skips
ARCHS = [
    (('conv5', 0), ('conv7d2', 1, 1), ('linear', 0, 1, 1)),
    (('conv5d2', 1), ('zero', 0, 1), ('conv7', 1, 0, 0)),
]
ARCH_IDS = ['linear', 'zero']
# f32 on both sides, sums in another order: logits within 2e-5 of their
# scale, each loss gradient within 1e-4 of its own max
OUT_TOL, GRAD_TOL = 2e-5, 1e-4
# Groups of 2-3 channels: the JAX kernels in interpret mode unroll K*ci*co
# slices per call, and their compile time grows with it; the op tests
# (test_torch_grouped_conv.py) cover the flagship's groups of 6.
GROUPS = 8


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX kernels in interpret mode: cell_ops reads INTERPRET, and the
    'pallas' layer imports grouped_conv1d at call time, which here passes
    interpret=True."""
    monkeypatch.setattr(jax_cell_ops, 'INTERPRET', True)
    conv = jax_grouped_conv.grouped_conv1d
    monkeypatch.setattr(
        jax_grouped_conv, 'grouped_conv1d',
        lambda x, w, groups, lpad, rpad, dilation=1: conv(
            x, w, groups, lpad, rpad, dilation, True))
    with jax.default_matmul_precision('highest'):
        yield


def _close(got, want, tol, name=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('arch', ARCHS, ids=ARCH_IDS)
def test_cell_matches_jax(arch, impl):
    """Output, and the gradients of <output, cot> for the input and every
    parameter; the split cell takes and gives the split layout."""
    B, T, C, G = 2, 19, 24, GROUPS
    rng = np.random.RandomState(2)
    x = rng.randn(B, T, C).astype(np.float32)
    cot = rng.randn(B, T, C).astype(np.float32)
    kw = dict(filters=C, arch_desc=arch, groups=G, init_scheme='scaled',
              grouped_impl=impl)
    jcell = JaxSearchCell(dropout_rate=0.0, **kw)
    split = impl == 'pallas_split'
    wrap = (lambda a: jax_cell_ops.to_split(a, G)) if split else (lambda a: a)
    unwrap = jax_cell_ops.from_split if split else (lambda a: a)
    v = jax.jit(jcell.init)(jax.random.PRNGKey(0), wrap(jnp.asarray(x)))

    def jloss(params, x):
        out = unwrap(jcell.apply({'params': params}, wrap(x)))
        return jnp.sum(out * cot), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(v['params'], jnp.asarray(x))
    port = SearchCell(**kw)
    port.load_state_dict(from_flax(v))
    xt = torch.tensor(x, requires_grad=True)
    out = port(to_split(xt, G) if split else xt)
    out = from_split(out) if split else out
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, want, OUT_TOL)
    _close(xt.grad, gx, GRAD_TOL)
    gp = from_flax({'params': gp})
    assert gp.keys() == dict(port.named_parameters()).keys()
    for name, p in port.named_parameters():
        _close(p.grad, gp[name].numpy(), GRAD_TOL, name)


# tests/test_cell_split.py's two-block model, with narrower groups
MODEL_ARCH = [[1, 0], [3, 0, 1], [0, 1, 0, 0]]
MODEL_KW = dict(num_classes=8, use_rnn=False, dropout_rate=0.0,
                cell_dropout=0.0, block_kernels=(4, 4), block_strides=(1, 2),
                block_filters=(16, 24), cells_per_block=(1, 2),
                cell_groups=GROUPS)


@pytest.mark.parametrize('impl', IMPLS)
def test_model_matches_jax(impl):
    """Logits of a masked batch, then the gradients of <logits, cot> on
    full-length inputs (masked frames make the LayerNorm variance exactly
    0, where any two implementations' bias gradients part, see
    tests/test_cell_split.py), on the port's weights carried to the JAX
    model by ``convert.to_flax``, whose tree must be the JAX model's."""
    jmodel = JaxASRModel.from_arch_vec(MODEL_ARCH, grouped_impl=impl,
                                       **MODEL_KW)
    B, T = 2, 23
    rng = np.random.RandomState(3)
    feats = rng.randn(B, T, 80).astype(np.float32)
    sizes = np.array([T, T - 5], np.int32)
    port = ASRModel.from_arch_vec(MODEL_ARCH, grouped_impl=impl, **MODEL_KW)
    v = to_flax(port.state_dict())
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(1),
                            jnp.asarray(feats), jnp.asarray(sizes))
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(v)
    for leaf, arr in zip(jax.tree_util.tree_leaves(shapes),
                         jax.tree_util.tree_leaves(v)):
        assert leaf.shape == arr.shape
    for name, t in from_flax(v).items():
        torch.testing.assert_close(t, port.state_dict()[name], rtol=0, atol=0)
    want = jax.jit(jmodel.apply)(v, jnp.asarray(feats), jnp.asarray(sizes))
    got = port(torch.from_numpy(feats), torch.from_numpy(sizes))
    _close(got, want, OUT_TOL)

    cot = rng.randn(*want.shape).astype(np.float32)
    full = np.array([T, T], np.int32)
    gp = jax.jit(jax.grad(lambda p: jnp.sum(jmodel.apply(
        {'params': p}, jnp.asarray(feats), jnp.asarray(full)) * cot)))(
            v['params'])
    (port(torch.from_numpy(feats), torch.from_numpy(full))
     * torch.from_numpy(cot)).sum().backward()
    gp = from_flax({'params': gp})
    for name, p in port.named_parameters():
        _close(p.grad, gp[name].numpy(), GRAD_TOL, name)


# tests/test_torch_training.py's trainer, with narrower groups
ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
KW = dict(block_kernels=(4, 4), block_strides=(1, 2), block_filters=(16, 24),
          cells_per_block=(1, 1), cell_groups=GROUPS, rnn_units=16,
          init_scheme='scaled')


@pytest.mark.parametrize('impl', IMPLS)
def test_train_step_matches_jax(impl):
    """One Trainer step at dropout 0 from the same init: the loss and every
    gradient (before clipping) against the JAX Trainer's.  The update that
    follows is the fused path's, held to JAX in test_torch_training.py."""
    jloaders = jax_get_dataloaders('synthetic:12', batch_size=4,
                                   curriculum=())
    jmodel = jax_get_model(ARCH, use_rnn=True, dropout_rate=0.0,
                           cell_dropout=0.0, data_norm=True,
                           grouped_impl=impl, **KW)
    jtr = jax_get_trainer(jloaders, jax_get_loss(), verbose=False,
                          eval_decoder='greedy')
    # the port's init carried over, in place of jtr.init_state, whose
    # eager flax init runs the interpret-mode kernels op by op
    model = get_model(ARCH, use_rnn=True, dropout_rate=0.0, cell_dropout=0.0,
                      data_norm=True, device='cpu', grouped_impl=impl, **KW)
    v = to_flax(model.state_dict())
    jtr._stats = v['stats']
    batch = next(iter(jloaders[1]))
    jb = {k: jnp.asarray(a) for k, a in batch.items()}

    def loss_fn(params):
        feats, fsize = jtr._features(jb)
        logits = jmodel.apply(jtr._variables(params), feats, fsize, train=True)
        lsize = jax_logits_length(fsize, feats.shape[1], logits.shape[1])
        ctc = jtr.loss(logits, lsize, jb['labels'], jb['label_size'],
                       valid=jb['valid'])
        return ctc + jax_conv_l2(params), ctc

    (_, ctc), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v['params'])

    loaders = get_dataloaders('synthetic:12', batch_size=4, curriculum=())
    trainer = Trainer(loaders, get_loss(), device='cpu', verbose=False)
    trainer.init_state(model, seed=0)
    grouped_conv.reset_launches()
    got, m = trainer.gradients(batch)
    assert grouped_conv.LAUNCHES == {k: {'kernel': 0, 'plain': 6}
                                     for k in ('forward', 'dx', 'dw')}
    assert m['ctc_loss'] == pytest.approx(float(ctc), rel=1e-5)
    grads = from_flax({'params': grads})
    assert got.keys() == grads.keys()
    for name, want in grads.items():
        _close(got[name], want.numpy(), GRAD_TOL, name)
    trainer.step(batch, training=True, lr=1e-3)
    assert trainer.step_count == 1 and trainer.nonfinite_steps == 0


def test_dropout_masks_agree_across_impls():
    """Cells in training mode with dropout 0.2, one generator seed: the
    fused cell and both unfused paths drop the same elements (a different
    mask would move the output by O(1)), and the mask is not empty."""
    arch = (('conv5', 0), ('linear', 1, 0), ('conv7d2', 0, 1, 1))
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 21, 24)
                         .astype(np.float32))
    cells = {impl: SearchCell(24, arch, groups=4, init_scheme='scaled',
                              grouped_impl=impl)
             for impl in ['fused'] + IMPLS}
    g = torch.Generator().manual_seed(1)          # biases off zero too
    state = {k: v + 0.1 * torch.randn(v.shape, generator=g)
             for k, v in cells['fused'].state_dict().items()}
    out = {}
    for impl, cell in cells.items():
        cell.load_state_dict(state)
        xin = to_split(x, 4) if impl == 'pallas_split' else x
        y = cell.train()(xin, torch.Generator().manual_seed(7)).detach()
        out[impl] = from_split(y) if impl == 'pallas_split' else y
    for impl in IMPLS:
        torch.testing.assert_close(out[impl], out['fused'], rtol=0, atol=1e-5)
    eval_out = cells['fused'].eval()(x).detach()
    assert float((eval_out - out['fused']).abs().max()) > 0.1


def test_impl_choices():
    """Every ``grouped_impl`` of the JAX package builds; the unfused paths
    at groups=1 hold nn.Conv's ``conv`` parameters and run no split
    layout, as the JAX cell does; an unknown impl is refused."""
    for impl in ('chunked', 'masked_dense', 'native'):
        cell = SearchCell(24, ARCHS[0], groups=4, grouped_impl=impl)
        assert not cell.fused and not cell.split
    assert SearchCell(24, ARCHS[0], groups=4,
                      grouped_impl='fused_aligned').fused
    for impl in ('pallas', 'pallas_split'):
        dense = SearchCell(24, ARCHS[0], groups=1, grouped_impl=impl)
        assert not dense.split
        assert {n for n, _ in dense.named_parameters()} >= {
            'node0_conv5.conv.weight', 'node0_conv5.conv.bias'}
    with pytest.raises(ValueError, match='unknown grouped_impl'):
        SearchCell(24, ARCHS[0], groups=4, grouped_impl='tiled')


def test_get_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        get_model(ARCH, grouped_impl='pallas_split', **KW)
    model = get_model(ARCH, grouped_impl='pallas_split', device='cpu', **KW)
    assert model.grouped_impl == 'pallas_split'


def test_train_twin_runs_pallas_split(tmp_path):
    """``python -m nbasr_torch.train ... --grouped_impl pallas_split`` at the
    flagship's full width on the CPU, one epoch of synthetic data."""
    out = subprocess.run(
        [sys.executable, '-m', 'nbasr_torch.train', '1', '0', '1', '0', '0',
         '1', '0', '0', '0', '--device', 'cpu', '--data', 'synthetic:8',
         '--epochs', '1', '--batch_size', '4', '--exp_folder', str(tmp_path),
         '--exp_name', 'run', '--grouped_impl', 'pallas_split'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert 'Epoch 1: loss' in out.stdout and 'Test:' in out.stdout
    assert (tmp_path / 'torch' / 'run' / 'best.ckpt').exists()
