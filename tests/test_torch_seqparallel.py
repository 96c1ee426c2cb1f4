"""The port's sequence parallelism on the CPU: ``seq_parallel_apply`` on
4 spawned gloo ranks, each with its time shard, against the JAX package's
``seq_parallel_apply`` on its 4-device CPU mesh and against the port's
unsharded forward, on ``tests/test_seqparallel.py``'s model and weights
converted from JAX's init: the logits, and the gradients of a weighted
sum of them (``jax.grad`` on the JAX side); its two errors; the
flagship's halo."""

import numpy as np
import pytest
import jax
import torch
from jax.sharding import Mesh

from nbasr_tpu.models.asr import ASRModel as JaxASRModel
from nbasr_tpu.parallel.seqparallel import \
    seq_parallel_apply as jax_seq_parallel_apply

from nbasr_torch.convert import from_flax
from nbasr_torch.models.asr import ASRModel, get_model
from nbasr_torch.parallel import encoder_halo, mesh
from tests import _torch_tp_worker as worker

# tests/test_seqparallel.py's model: conv5 / conv7 / conv5d2 nodes, halo
# (30, 66), T = 4 x 2 x 48 so that a shard (96 frames) exceeds the halo
ARCH = [[1, 0], [3, 0, 1], [2, 1, 0, 0]]
KW = dict(num_classes=8, dropout_rate=0.0, cell_dropout=0.0,
          block_kernels=(4, 4), block_strides=(1, 2),
          block_filters=(16, 24), cells_per_block=(1, 2), cell_groups=4,
          rnn_units=12, init_scheme='scaled')
T = 4 * 2 * 48
MODES = ((False, 'chain'), (True, 'chain'), (True, 'gather'))
SPAWN_TIMEOUT_S = 300
#: the ranks' gradients (parameters summed over the ranks, features
#: concatenated) against the unsharded model's and JAX's, as a share of
#: each tensor's max: sums in other orders only
GRAD_TOL = 1e-5


def _data(T, B=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 80).astype(np.float32),
            np.asarray([T, T - 13], np.int32))


def _weights(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope='module')
def runs():
    """JAX's sharded and unsharded logits, the port's unsharded ones, and
    the 4 ranks' shards, per mode; the gradients of ``Σ w·logits`` (``w``
    drawn per mode) of JAX's ``seq_parallel_apply`` (``jax.grad``), of the
    port's unsharded model and of the 4 ranks."""
    feats, sizes = _data(T)
    jfeats, jsizes = jax.numpy.asarray(feats), jax.numpy.asarray(sizes)
    jmesh = Mesh(np.asarray(jax.devices()[:4]), ('seq',))
    init, jax_out, plain, weights, jax_grads, plain_grads = ({} for _ in
                                                             range(6))
    for i, (use_rnn, mode) in enumerate(MODES):
        jmodel = JaxASRModel.from_arch_vec(ARCH, use_rnn=use_rnn, **KW)
        variables = jmodel.init(jax.random.PRNGKey(0), jfeats, jsizes)
        apply = lambda v, x, m=jmodel, mode=mode: jax_seq_parallel_apply(
            m, v, x, jsizes, jmesh, lstm_mode=mode)
        # under jit, as test_matches_under_jit: eager shard_map takes ~20 s
        jax_out[(use_rnn, mode)] = np.asarray(jax.jit(apply)(variables,
                                                             jfeats))
        w = weights[(use_rnn, mode)] = _weights(
            jax_out[(use_rnn, mode)].shape, 10 + i)
        gv, gx = jax.jit(jax.grad(
            lambda params, x: (w * apply(dict(variables, params=params), x)
                               ).sum(), argnums=(0, 1)))(
            variables['params'], jfeats)
        jax_grads[(use_rnn, mode)] = dict(
            {k: v.numpy() for k, v in from_flax(
                {'params': jax.tree_util.tree_map(np.asarray, gv)}).items()},
            features=np.asarray(gx))
        init[use_rnn] = {k: v.numpy() for k, v in from_flax(
            jax.tree_util.tree_map(np.asarray, dict(variables))).items()}
        model = get_model(ARCH, use_rnn=use_rnn, device='cpu', **KW)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in init[use_rnn].items()})
        with torch.no_grad():
            plain[(use_rnn, mode)] = model(torch.as_tensor(feats),
                                           torch.as_tensor(sizes)).numpy()
        x = torch.as_tensor(feats).requires_grad_(True)
        (torch.as_tensor(w) * model(x, torch.as_tensor(sizes))).sum() \
            .backward()
        plain_grads[(use_rnn, mode)] = dict(
            {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
            features=x.grad.numpy().copy())
    ranks = mesh.spawn(worker.seq_case, ['cpu'] * 4,
                       (ARCH, KW, init, feats, sizes, MODES, weights),
                       timeout=SPAWN_TIMEOUT_S)
    return dict(jax=jax_out, plain=plain, ranks=ranks, jax_grads=jax_grads,
                plain_grads=plain_grads)


@pytest.mark.parametrize('use_rnn,lstm_mode', MODES)
def test_matches_jax_and_unsharded(runs, use_rnn, lstm_mode):
    """The 4 ranks' logits shards, concatenated in rank order, against
    JAX's ``seq_parallel_apply`` and the port's unsharded forward, at
    rtol/atol 1e-5."""
    ours = np.concatenate([r[(use_rnn, lstm_mode)] for r in runs['ranks']],
                          axis=1)
    want = runs['plain'][(use_rnn, lstm_mode)]
    assert ours.shape == want.shape == runs['jax'][(use_rnn, lstm_mode)].shape
    np.testing.assert_allclose(ours, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, runs['jax'][(use_rnn, lstm_mode)],
                               rtol=1e-5, atol=1e-5)


def _rank_grads(ranks, key):
    """The ranks' parameter gradients summed, their features' gradients
    concatenated in rank order."""
    grads = [r[('grads',) + key] for r in ranks]
    out = {n: sum(g[n] for g in grads) for n in grads[0] if n != 'features'}
    out['features'] = np.concatenate([g['features'] for g in grads], axis=1)
    return out


def _worst(got, want):
    """The largest ``max|got - want| / max|want|`` over the tensors."""
    assert got.keys() == want.keys()
    shares = {n: float(np.abs(got[n] - w).max())
              / max(float(np.abs(w).max()), 1e-30) for n, w in want.items()}
    return max(shares.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize('use_rnn,lstm_mode', MODES)
def test_gradients_match_jax_and_unsharded(runs, use_rnn, lstm_mode):
    """The gradients of ``Σ w·logits`` through the 4 ranks (each rank's
    share of every parameter's gradient, summed over the ranks; the
    features' gradient, its shards concatenated) within 1e-5 of each
    tensor's max of the port's unsharded model's and of ``jax.grad`` of
    JAX's ``seq_parallel_apply``; every parameter gets a gradient."""
    key = (use_rnn, lstm_mode)
    got = _rank_grads(runs['ranks'], key)
    for want in (runs['plain_grads'][key], runs['jax_grads'][key]):
        name, share = _worst(got, want)
        assert share <= GRAD_TOL, (name, share)
    assert all(np.abs(g).max() > 0 for g in got.values())


@pytest.mark.parametrize('error,match', [('stride', 'not divisible'),
                                         ('halo', 'total halo')])
def test_refuses_what_it_cannot_shard(runs, error, match):
    for r in runs['ranks']:
        assert match in r['errors'][error]


def test_encoder_halo_flagship():
    """The flagship's halo, as tests/test_seqparallel.py reads it."""
    model = ASRModel.from_arch_vec([[1, 0], [1, 0, 0], [1, 0, 0, 0]])
    assert encoder_halo(model) == (24, 508)
