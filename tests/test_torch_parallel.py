"""The port's data parallelism on the CPU: the loaders' host sharding
against the unsharded schedule and the JAX package's shards, the mesh's
checks, and ``ParallelTrainer`` in two spawned gloo processes against one
process's ``Trainer`` and the JAX package's ``ParallelTrainer`` at dp=2 on
the same batches and converted weights."""

import pathlib

import numpy as np
import pytest
import jax
import torch

import nbasr_tpu.ops.fused_cell as jax_fused_cell
from nbasr_tpu.data import get_dataloaders as jax_get_dataloaders
from nbasr_tpu.data.pipeline import Loader as JaxLoader
from nbasr_tpu.data.pipeline import make_synthetic_split as jax_synthetic
from nbasr_tpu.models.asr import get_model as jax_get_model
from nbasr_tpu.parallel import ParallelTrainer as JaxParallelTrainer
from nbasr_tpu.parallel import make_mesh as jax_make_mesh
from nbasr_tpu.training import get_loss as jax_get_loss

from nbasr_torch import train as train_twin
from nbasr_torch.convert import from_flax
from nbasr_torch.data.pipeline import Loader, get_dataloaders, \
    make_synthetic_split
from nbasr_torch.models.asr import get_model
from nbasr_torch.parallel import initialize_distributed, make_mesh, mesh
from nbasr_torch.training import Trainer, get_loss
from tests import _torch_ddp_worker

ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
ZERO_ARCH = [[5, 1], [1, 0, 1], [5, 0, 0, 1]]
# test_torch_training.py's widths (filters 24/32, 4 groups, one cell per
# block, LSTM 16), where its 3-step bound against JAX was measured.  At the
# sweep test's 8 channels in 2 groups a 1e-6 relative nudge of the audio
# moves single gradients by 4% of their max (clip gates flip), so there the
# port and the JAX package part by more than that bound after 3 Adam steps
# in one process already; the frontends' features differ by 2.5e-6.
KW = dict(block_kernels=(4, 4), block_strides=(1, 2), block_filters=(24, 32),
          cells_per_block=(1, 1), cell_groups=4, rnn_units=16,
          init_scheme='scaled')
LR = 1e-3
#: seconds the two spawned ranks may take (they take ~15 s alone)
SPAWN_TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# host sharding
# ---------------------------------------------------------------------------

def _concat(batches):
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('num_shards,batch_size', [(2, 12), (3, 12), (4, 12),
                                                   (2, 5)])
def test_loader_shards_concatenate_to_the_unsharded_batch(num_shards,
                                                          batch_size):
    """Every shard walks the same schedule (same steps and shapes); the
    shards' rows, concatenated, equal the unsharded loader's batch at the
    global batch size (``batch_size`` rounded up to ``num_shards``) bit for
    bit, shuffled and partial batches included, and equal the JAX
    Loader's shards."""
    ds = make_synthetic_split(29, seed=0)
    jds = jax_synthetic(29, seed=0)
    global_bs = -(-batch_size // num_shards) * num_shards
    full = Loader(ds, global_bs, shuffle=True, seed=3)
    shards = [Loader(ds, batch_size, shuffle=True, seed=3,
                     num_shards=num_shards, shard_index=s)
              for s in range(num_shards)]
    jax_shards = [JaxLoader(jds, batch_size, shuffle=True, seed=3,
                            num_shards=num_shards, shard_index=s)
                  for s in range(num_shards)]
    assert {s.steps for s in shards} == {full.steps}
    steps = 0
    for _ in range(2):                          # two epochs: two shuffles
        for want, *parts in zip(full, *shards, *jax_shards):
            ours, theirs = parts[:num_shards], parts[num_shards:]
            assert len({len(p['valid']) for p in ours}) == 1
            _assert_equal(_concat(ours), want)
            for a, b in zip(ours, theirs):
                _assert_equal(a, b)
            steps += 1
    assert steps == 2 * full.steps


def test_get_dataloaders_shards_every_split():
    """Train (curriculum stream), val and test are sharded alike."""
    full = get_dataloaders('synthetic:20', batch_size=6)
    shards = [get_dataloaders('synthetic:20', batch_size=6, num_shards=2,
                              shard_index=s) for s in range(2)]
    jax_shards = [jax_get_dataloaders('synthetic:20', batch_size=6,
                                      num_shards=2, shard_index=s)
                  for s in range(2)]
    for split in (1, 2, 3):
        n = 0
        for want, a, b, ja, jb in zip(full[split], shards[0][split],
                                      shards[1][split], jax_shards[0][split],
                                      jax_shards[1][split]):
            _assert_equal(_concat([a, b]), want)
            _assert_equal(a, ja)
            _assert_equal(b, jb)
            n += 1
            if n == 8:
                break
        assert n >= 1
    with pytest.raises(ValueError, match='shard_index'):
        Loader(make_synthetic_split(4), 2, num_shards=2, shard_index=2)


# ---------------------------------------------------------------------------
# the mesh and the twin's flags
# ---------------------------------------------------------------------------

def test_mesh_checks_before_any_group(monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    cpu4 = ['cpu'] * 4
    with pytest.raises(ValueError, match='dp\\*tp'):
        make_mesh(dp=3, tp=1, devices=cpu4)
    with pytest.raises(ValueError, match='not divisible'):
        make_mesh(tp=3, devices=cpu4)
    for call in (lambda: make_mesh(tp=2, devices=cpu4),
                 lambda: mesh.param_spec(None, None, 2),
                 lambda: mesh.param_shardings(None, None)):
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            call()
    assert initialize_distributed(device='cpu') == (0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match='process group'):
        make_mesh(devices=['cpu'])
    assert mesh.backend_for(['cpu', 'cpu']) == 'gloo'
    assert mesh.backend_for(['cuda:0', 'cuda:0']) == 'gloo'
    assert mesh.backend_for(['cuda:0', 'cuda:1']) == 'nccl'


@pytest.mark.parametrize('flags,match', [
    (['--tp', '2'], 'tensor parallelism'),
    (['--dp', '2', '--device', 'cpu'], 'torchrun'),
    (['--dp', '1', '--device', 'cpu'], 'torchrun')], ids=['tp', 'dp', 'dp1'])
def test_train_twin_refuses_what_it_cannot_run(flags, match, monkeypatch,
                                                capsys):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(SystemExit):
        train_twin.main(['1', '0', '1', '0', '0', '1', '0', '0', '0',
                         '--data', 'synthetic:4', *flags])
    assert match in capsys.readouterr().err


def test_parallel_trainer_needs_a_group_and_its_shard(monkeypatch):
    """Without torchrun or an initialised group ``ParallelTrainer`` raises;
    in a group of one, a loader sharded for another world is refused (two
    ranks on unsharded loaders would each step on the whole batch and sum
    twice the gradient), and the whole batch is the one shard."""
    from nbasr_torch.parallel import ParallelTrainer
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    whole = get_dataloaders('synthetic:4', batch_size=2, curriculum=())
    with pytest.raises(RuntimeError, match='process group'):
        ParallelTrainer(whole, device='cpu')
    assert initialize_distributed(
        device='cpu', init_method=f'tcp://127.0.0.1:{mesh.free_port()}',
        world_size=1, rank=0) == (0, 1)
    try:
        assert torch.distributed.get_backend() == 'gloo'
        with pytest.raises(ValueError, match='shard of the data'):
            ParallelTrainer(get_dataloaders(
                'synthetic:4', batch_size=2, curriculum=(), num_shards=2,
                shard_index=1), device='cpu')
        trainer = ParallelTrainer(whole, device='cpu')
        assert (trainer.world, trainer.rank, trainer.is_lead) == (1, 0, True)
        assert trainer.mesh.mesh_dim_names == ('data', 'model')
        batch = {'valid': np.ones(3, np.float32), 'audio': np.zeros((3, 2))}
        assert trainer.shard_batch(batch)['audio'].shape == (3, 2)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# two ranks against one process and against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """The JAX ParallelTrainer at dp=2 (fused cells in interpret mode), its
    init carried to the port; one process's Trainer gradients on the
    global batch; and the two spawned ranks' readings."""
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision('highest'):
        mp.setattr(jax_fused_cell, 'INTERPRET', True)
        jloaders = jax_get_dataloaders('synthetic:12', batch_size=4,
                                       curriculum=())
        jmodel = jax_get_model(ARCH, use_rnn=True, dropout_rate=0.0,
                               cell_dropout=0.0, data_norm=True,
                               grouped_impl='fused', **KW)
        jtr = JaxParallelTrainer(
            jloaders, jax_get_loss(), verbose=False, eval_decoder='greedy',
            mesh=jax_make_mesh(dp=2, devices=jax.devices()[:2]))
        jtr.init_state(jmodel, seed=0)
        init = from_flax(jax.tree_util.tree_map(
            np.asarray, {'params': jtr.state.params, 'stats': jtr._stats}))
        batch = next(iter(jloaders[1]))
        for _ in range(3):
            jtr.step(batch, training=True, lr=LR)
        jax_after = from_flax({'params': jax.tree_util.tree_map(
            np.asarray, jtr.state.params)})

    loaders = get_dataloaders('synthetic:12', batch_size=4, curriculum=())
    _assert_equal(next(iter(loaders[1])), batch)
    model = get_model(ARCH, use_rnn=True, dropout_rate=0.0, cell_dropout=0.0,
                      data_norm=True, device='cpu', **KW)
    model.load_state_dict(init)
    single = Trainer(loaders, get_loss(), device='cpu', verbose=False)
    single.init_state(model, seed=0)
    grads, metrics = single.gradients(batch)

    save_root = tmp_path_factory.mktemp('ranks')
    ranks = mesh.spawn(
        _torch_ddp_worker.data_parallel_checks, ['cpu', 'cpu'],
        (ARCH, KW, {k: v.numpy() for k, v in init.items()}, LR,
         str(save_root), ZERO_ARCH), timeout=SPAWN_TIMEOUT_S)
    return dict(ranks=ranks, grads=grads, metrics=metrics, init=init,
                jax_after=jax_after, save_root=save_root)


def test_two_rank_gradients_match_one_process(two_ranks):
    """Each rank steps on half the global batch; DDP's summed gradients
    before clipping are one process's on the whole batch, within 1e-5 of
    each tensor's max (a world-size factor would read 1)."""
    ranks, want = two_ranks['ranks'], two_ranks['grads']
    assert [r['rows'] for r in ranks] == [2, 2]
    assert all(r['shard_ok'] for r in ranks)        # shard_batch's rows
    for r in ranks:
        assert r['grads'].keys() == want.keys()
        assert r['metrics']['ctc_loss'] == pytest.approx(
            two_ranks['metrics']['ctc_loss'], rel=1e-6)
        for name, w in want.items():
            w = w.numpy()
            err = np.abs(r['grads'][name] - w).max() / np.abs(w).max()
            assert err <= 1e-5, (name, err)


def test_two_ranks_hold_equal_parameters_near_jax(two_ranks):
    """After 3 clipped Adam steps both ranks hold bit-equal parameters,
    within ``test_three_steps_match_jax``'s bound of the JAX
    ParallelTrainer at dp=2: 0.2*lr where the first gradient is above 1e-3
    of its tensor's max, 6*lr elsewhere."""
    r0, r1 = two_ranks['ranks']
    assert r0['steps'] == r1['steps'] == 3
    assert r0['nonfinite'] == r1['nonfinite'] == 0
    assert r0['params'].keys() == r1['params'].keys()
    for name in r0['params']:
        np.testing.assert_array_equal(r0['params'][name], r1['params'][name])
    moved = 0
    for name, want in two_ranks['jax_after'].items():
        g = two_ranks['grads'][name].abs().numpy()
        firm = g > 1e-3 * g.max()
        diff = np.abs(r0['params'][name] - want.numpy())
        assert diff[firm].max(initial=0) <= 0.2 * LR, name
        assert diff.max() <= 2 * LR * 3, name
        moved += int((r0['params'][name] != two_ranks['init'][name].numpy()).sum())
    assert moved > 0


def test_ranks_draw_distinct_dropout(two_ranks):
    """At dropout 0.2 the two ranks' training forwards of one model on one
    input differ: the rank is folded into the dropout seed."""
    a, b = (r['dropout_logits'] for r in two_ranks['ranks'])
    assert a.shape == b.shape and np.isfinite(a).all()
    assert not np.array_equal(a, b)


def test_only_rank_zero_writes_files(two_ranks):
    root = pathlib.Path(two_ranks['save_root'])
    written = {r: sorted(p.relative_to(root / f'rank{r}').as_posix()
                         for p in (root / f'rank{r}').rglob('*')
                         if p.is_file()) for r in (0, 1)}
    assert {'run/latest.ckpt', 'run/best.ckpt', 'run/metrics.jsonl',
            'run/scores.pickle', 'run/test_scores.pickle'} <= set(written[0])
    assert written[1] == []


@pytest.mark.parametrize('case', ['zero_arch', 'remat_cells'])
def test_zero_node_arch_trains(two_ranks, case):
    """An arch with zero nodes, and ``remat_cells`` (the cells recomputed
    in the backward): every parameter still gets a gradient, so DDP needs
    no ``find_unused_parameters``, and the step is finite (a parameter
    left without one would hang the ranks past their timeout)."""
    for r in two_ranks['ranks']:
        assert np.isfinite(r[case]['ctc_loss'])
