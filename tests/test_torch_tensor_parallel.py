"""The port's tensor parallelism on the CPU: ``param_spec`` against the
JAX package's placement, ``ParallelTrainer`` at tp=2 and tp=4 (and dp=2 x
tp=2) in spawned gloo processes against one process's step on the same
masks, against the JAX package's ``ParallelTrainer`` at (dp, tp) = (1, 2),
two planted faults, eval, checkpoints across tp, the channel offset of the
plain dropout, and the trainer's profiler hook; all of it on the fused
cells (``'auto'``) and on the split layout (``'pallas_split'``: the
grouped conv kernels' plain versions on each rank's groups)."""

import numpy as np
import pytest
import jax
import torch

import nbasr_tpu.ops.cell_ops as jax_cell_ops

from torch.distributed.tensor import Replicate, Shard

from nbasr_tpu.data import get_dataloaders as jax_get_dataloaders
from nbasr_tpu.models import get_model as jax_get_model
from nbasr_tpu.models.asr import logits_length as jax_logits_length
from nbasr_tpu.parallel import ParallelTrainer as JaxParallelTrainer
from nbasr_tpu.parallel import batch_shardings as jax_batch_shardings
from nbasr_tpu.parallel import make_mesh as jax_make_mesh
from nbasr_tpu.parallel import param_shardings as jax_param_shardings
from nbasr_tpu.parallel import replicated as jax_replicated
from nbasr_tpu.training import get_loss as jax_get_loss
from nbasr_tpu.training import get_trainer as jax_get_trainer
from nbasr_tpu.training.loss import conv_l2 as jax_conv_l2

from nbasr_torch.convert import flax_key, from_flax
from nbasr_torch.data.pipeline import get_dataloaders
from nbasr_torch.models.asr import get_model, logits_length
from nbasr_torch.models.layers import hash_dropout
from nbasr_torch.ops.fused_cell import dropout_bits
from nbasr_torch.parallel import mesh
from nbasr_torch.parallel.mesh import param_spec
from nbasr_torch.parallel.train_parallel import fold_rank
from nbasr_torch.training import Trainer, get_loss
from nbasr_torch.training.loss import conv_l2
from tests import _torch_tp_worker as worker

# tests/test_parallel.py's model: a linear and a zero node, so every cell
# runs whole; at tp=4 blocks 0-1's convs are replicated (16 < 32) and used
# sliced, blocks 2-3's sharded
TINY_ARCH = [[0, 1], [1, 0, 0], [5, 0, 1, 0]]
TINY_KW = dict(block_filters=(16, 16, 32, 32), cells_per_block=(1, 1, 1, 1),
               cell_groups=4, rnn_units=16, init_scheme='scaled')
# the flagship's cells at 4 groups: every cell channel-parallel at tp=2
FLAG_ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
FLAG_KW = dict(block_filters=(24, 24, 32, 32), cells_per_block=(1, 1, 1, 1),
               cell_groups=4, rnn_units=16, init_scheme='scaled')
SPLIT = dict(grouped_impl='pallas_split')
# 3 groups, which tp=2 does not divide: the blocks stay dense, every cell
# runs whole on the split layout
ODD_KW = dict(FLAG_KW, block_filters=(24, 24, 48, 48), cell_groups=3)
# the JAX ParallelTrainer on 'pallas_split': its kernels in interpret mode
# unroll K*ci*co slices a call and compile slowly, so two blocks of groups
# of 2 channels (8 at tp=2); 16 channels, the narrowest param_spec shards
# at tp=2
JSPLIT_KW = dict(block_kernels=(8, 8), block_strides=(1, 2),
                 block_filters=(16, 16), cells_per_block=(1, 1),
                 cell_groups=8, rnn_units=16, init_scheme='scaled')
#: cell dropout 0.2 (the default) and pre-LSTM dropout 0.2
MODEL = dict(use_rnn=True, dropout_rate=0.2, data_norm=True)
LR = 1e-3
STEPS = 3
SEED = 0
BATCH = 4
#: seconds the spawned ranks of one fixture may take
SPAWN_TIMEOUT_S = 300
GRAD_TOL = 1e-5
#: the port against the JAX package, a whole f32 step's gradients as a
#: share of each tensor's max: the two take their sums in other orders
#: through the frontend, block convs, cells, LSTM and CTC recursion (read
#: 2.6e-5 at tp=2); tests/test_torch_training.py's STEP_TOL
JAX_GRAD_TOL = 1e-4


def _init(arch, kw, model=MODEL, seed=0):
    m = get_model(arch, device='cpu', generator=torch.Generator().manual_seed(
        seed), **model, **kw)
    return {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}


def _case(arch, kw, batch, init, model=None, **extra):
    return dict(dict(arch=arch, model=dict(MODEL, **(model or {}), **kw),
                     init=init, batch=batch, batch_size=len(batch['valid']),
                     seed=SEED, lr=LR, steps=STEPS), **extra)


def _loaders(batch_size):
    return get_dataloaders(worker.DATA, batch_size=batch_size, curriculum=())


def reference(case, dp):
    """One process's gradients before clipping, then its parameters after
    ``case['steps']`` steps, on the data-parallel semantics of ``dp`` data
    ranks: each rank's rows (contiguous) on its own dropout stream
    (``fold_rank``), the CTC sum over the global count of valid rows, the
    conv L2 once; at dp=1 this is ``Trainer.gradients`` and ``step``."""
    model = get_model(case['arch'], device='cpu', **case['model'])
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in case['init'].items()})
    tr = Trainer(_loaders(case['batch_size']), get_loss(), device='cpu',
                 verbose=False)
    tr.init_state(model, seed=case['seed'])
    gens = [torch.Generator().manual_seed(fold_rank(case['seed'] + 1, r))
            for r in range(dp)]
    rows = len(case['batch']['valid'])
    shards = [tr._put_batch({k: v[r * rows // dp:(r + 1) * rows // dp]
                             for k, v in case['batch'].items()})
              for r in range(dp)]
    den = sum(s['valid'].sum() for s in shards)

    def grads():
        model.train()
        for p in model.parameters():
            p.grad = None
        for r, b in enumerate(shards):
            feats, fsize = tr._features(b)
            logits = model(feats, fsize, generator=gens[r])
            lsize = logits_length(fsize, feats.shape[1], logits.shape[1])
            loss = tr.loss(logits, lsize, b['labels'], b['label_size'],
                           valid=b['valid'], denominator=den)
            (loss + conv_l2(model) if r == 0 else loss).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    first = grads()
    for _ in range(case['steps']):
        grads()
        tr._update(case['lr'])
    return first, {n: p.detach().numpy().copy()
                   for n, p in model.named_parameters()}, tr


def shares(got, want):
    """Per tensor, max |got - want| over max |want|."""
    return {n: float(np.abs(got[n] - w.numpy()).max())
            / max(float(w.abs().max()), 1e-30) for n, w in want.items()}


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('tp', [2, 4])
def test_param_spec_marks_what_jax_marks(tp):
    """By flax name, ``param_spec`` shards exactly the parameters the JAX
    package's ``param_shardings`` shards, on the same (flax) axis; the
    head's 49 columns stay replicated."""
    jmodel = jax_get_model(TINY_ARCH, use_rnn=True, **TINY_KW)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jax.numpy.zeros((1, 16, 80)))['params']
    jsh = jax_param_shardings(params, jax_make_mesh(
        dp=8 // tp, tp=tp, devices=jax.devices()[:8]))
    want = {'.'.join(str(getattr(k, 'key', k)) for k in path):
            tuple(sh.spec).index('model') if 'model' in tuple(sh.spec) else None
            for path, sh in jax.tree_util.tree_flatten_with_path(jsh)[0]}
    model = get_model(TINY_ARCH, device='cpu', **MODEL, **TINY_KW)
    got = {}
    for name, p in model.named_parameters():
        key, transposed = flax_key(name)
        pl = param_spec(name, p, tp)[1]
        got[key] = (None if not pl.is_shard() else
                    p.dim() - 1 - pl.dim if transposed else pl.dim)
    assert got == want
    assert got['head.kernel'] is None
    assert any(v is not None for v in got.values())


def _placements(spec):
    """A JAX ``PartitionSpec`` as placements over ``('data', 'model')``:
    ``Shard`` on the array axis that names a mesh axis, else ``Replicate``."""
    axes = tuple(spec)
    return tuple(Shard(axes.index(a)) if a in axes else Replicate()
                 for a in ('data', 'model'))


def test_batch_and_replicated_placements_match_jax():
    """``batch_shardings`` (every batch leaf, whatever its rank) and
    ``replicated`` give the placements of the JAX package's."""
    jmesh = jax_make_mesh(dp=4, tp=2, devices=jax.devices()[:8])
    for shape in ((8,), (8, 3), (8, 16, 80)):
        assert mesh.batch_shardings(None) == _placements(
            jax_batch_shardings(jmesh)(np.zeros(shape)).spec)
    assert mesh.replicated(None) == _placements(jax_replicated(jmesh).spec)
    assert mesh.batch_shardings(None) == (Shard(0), Replicate())


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def batch():
    return next(iter(_loaders(BATCH)[1]))


@pytest.fixture(scope='module')
def jax_step():
    """The JAX ParallelTrainer at (dp, tp) = (1, 2) on two CPU devices: its
    init, batch, one step's loss and parameters.  At tp > 1 it runs the
    'chunked' lowering, whose cells draw flax ``nn.Dropout`` masks, not
    the fused kernel's hash: cell dropout 0 on both sides."""
    with jax.default_matmul_precision('highest'):
        jloaders = jax_get_dataloaders(worker.DATA, batch_size=8,
                                       curriculum=())
        jmodel = jax_get_model(TINY_ARCH, use_rnn=False, dropout_rate=0.0,
                               cell_dropout=0.0, data_norm=True, **TINY_KW)
        par = JaxParallelTrainer(jloaders, jax_get_loss(), verbose=False,
                                 eval_decoder='greedy',
                                 mesh=jax_make_mesh(dp=1, tp=2,
                                                    devices=jax.devices()[:2]))
        par.init_state(jmodel, seed=0)
        assert par.model.grouped_impl == 'chunked'
        init = from_flax(jax.tree_util.tree_map(
            np.asarray, {'params': par.state.params, 'stats': par._stats}))
        jbatch = next(iter(jloaders[1]))
        grads = from_flax({'params': jax.tree_util.tree_map(
            np.asarray, _jax_grads(par, jbatch))})
        loss = par.step(jbatch, training=True, lr=LR)['ctc_loss']
        after = from_flax({'params': jax.tree_util.tree_map(
            np.asarray, par.state.params)})
    return dict(init={k: v.numpy() for k, v in init.items()}, batch=jbatch,
                loss=loss, grads=grads,
                after={k: v.numpy() for k, v in after.items()})


def _jax_grads(par, batch):
    """``jax.grad`` of the JAX ParallelTrainer's training loss (the CTC
    mean plus the conv L2, as its train step takes it) at its placed
    parameters, before clipping.  Every dropout rate is 0, so the rng
    draws nothing that counts."""
    b = par._put_batch(batch)

    def loss(params):
        feats, fsize = par._features(b)
        logits = par.model.apply(par._variables(params), feats, fsize,
                                 train=True,
                                 rngs={'dropout': jax.random.PRNGKey(0)})
        lsize = jax_logits_length(fsize, feats.shape[1], logits.shape[1])
        return par.loss(logits, lsize, b['labels'], b['label_size'],
                        metrics={}, valid=b['valid']) + jax_conv_l2(params)
    return jax.jit(jax.grad(loss))(par.state.params)


@pytest.fixture(scope='module')
def jax_split_step():
    """The JAX ParallelTrainer at (dp, tp) = (1, 2) on 'pallas_split' (it
    runs the split path as it stands: only the fused impls move to
    'chunked'), its Pallas kernels in interpret mode, under GSPMD on two
    CPU devices; every dropout rate 0, as ``jax_step``."""
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision('highest'):
        mp.setattr(jax_cell_ops, 'INTERPRET', True)
        jloaders = jax_get_dataloaders(worker.DATA, batch_size=8,
                                       curriculum=())
        jmodel = jax_get_model(FLAG_ARCH, use_rnn=False, dropout_rate=0.0,
                               cell_dropout=0.0, data_norm=True,
                               grouped_impl='pallas_split', **JSPLIT_KW)
        par = JaxParallelTrainer(jloaders, jax_get_loss(), verbose=False,
                                 eval_decoder='greedy',
                                 mesh=jax_make_mesh(dp=1, tp=2,
                                                    devices=jax.devices()[:2]))
        par.init_state(jmodel, seed=0)
        assert par.model.grouped_impl == 'pallas_split'
        init = from_flax(jax.tree_util.tree_map(
            np.asarray, {'params': par.state.params, 'stats': par._stats}))
        jbatch = next(iter(jloaders[1]))
        grads = from_flax({'params': jax.tree_util.tree_map(
            np.asarray, _jax_grads(par, jbatch))})
        loss = par.step(jbatch, training=True, lr=LR)['ctc_loss']
        after = from_flax({'params': jax.tree_util.tree_map(
            np.asarray, par.state.params)})
    return dict(init={k: v.numpy() for k, v in init.items()}, batch=jbatch,
                loss=loss, grads=grads,
                after={k: v.numpy() for k, v in after.items()})


@pytest.fixture(scope='module')
def two_ranks(batch, jax_step, jax_split_step, tmp_path_factory):
    """Every two-rank reading in one spawn: the tiny model and the
    flagship-arch one at (1, 2) with the planted faults and eval, on the
    fused cells and on the split layout; the JAX comparisons; the
    checkpoints of both."""
    root = tmp_path_factory.mktemp('tp')
    tiny = _case(TINY_ARCH, TINY_KW, batch, _init(TINY_ARCH, TINY_KW),
                 faults=('sliced',), eval=True)
    flag = _case(FLAG_ARCH, FLAG_KW, batch, _init(FLAG_ARCH, FLAG_KW),
                 faults=('sliced', 'c0'))
    jcase = _case(TINY_ARCH, TINY_KW, jax_step['batch'], jax_step['init'],
                  model=dict(use_rnn=False, dropout_rate=0.0,
                             cell_dropout=0.0), steps=1)
    # a one-process checkpoint one step in, for the ranks to resume
    ckpt = _case(TINY_ARCH, TINY_KW, batch, _init(TINY_ARCH, TINY_KW, seed=3),
                 steps=2)
    one = _one_process(ckpt, steps=1)
    one.save(root / 'one.ckpt', epoch=1)
    split = _case(FLAG_ARCH, FLAG_KW, batch, _init(FLAG_ARCH, FLAG_KW),
                  model=SPLIT, faults=('sliced',), eval=True)
    jsplit = _case(FLAG_ARCH, JSPLIT_KW, jax_split_step['batch'],
                   jax_split_step['init'], model=dict(
                       SPLIT, use_rnn=False, dropout_rate=0.0,
                       cell_dropout=0.0), steps=0)
    # the flagship arch: the tiny one's second node feeds nothing, so on
    # the unfused paths its bias gets no gradient and no Adam state
    split_ckpt = _case(FLAG_ARCH, FLAG_KW, batch, _init(FLAG_ARCH, FLAG_KW,
                                                       seed=3),
                       model=SPLIT, steps=2)
    one_split = _one_process(split_ckpt, steps=1)
    one_split.save(root / 'one_split.ckpt', epoch=1)
    # gradients only, as the flagship case: Adam at eps 1e-16 steps a
    # near-zero gradient's element by ~lr in its sign
    split_odd = _case(FLAG_ARCH, ODD_KW, batch, _init(FLAG_ARCH, ODD_KW),
                      model=SPLIT, steps=0)
    (root / 'split').mkdir()
    todo = [('tiny', 'tp_case', (1, 2, tiny)), ('flag', 'tp_case', (1, 2, flag)),
            ('jax', 'tp_case', (1, 2, jcase)),
            ('ckpt', 'tp_checkpoints', (ckpt, str(root / 'one.ckpt'),
                                        str(root))),
            ('split', 'tp_case', (1, 2, split)),
            ('split_odd', 'tp_case', (1, 2, split_odd)),
            ('jax_split', 'tp_case', (1, 2, jsplit)),
            ('split_ckpt', 'tp_checkpoints', (
                split_ckpt, str(root / 'one_split.ckpt'), str(root / 'split')))]
    ranks = mesh.spawn(worker.jobs, ['cpu', 'cpu'], (todo,),
                       timeout=SPAWN_TIMEOUT_S)
    return dict(ranks=ranks, tiny=tiny, flag=flag, ckpt=ckpt, one=one,
                root=root, split=split, jsplit=jsplit, split_odd=split_odd,
                split_ckpt=split_ckpt,
                one_split=one_split)


@pytest.fixture(scope='module')
def four_ranks(batch):
    """dp=2 x tp=2 and dp=1 x tp=4 on four ranks; dp=2 x tp=2 on the split
    layout."""
    case = _case(TINY_ARCH, TINY_KW, batch, _init(TINY_ARCH, TINY_KW))
    split = _case(FLAG_ARCH, FLAG_KW, batch, _init(FLAG_ARCH, FLAG_KW),
                  model=SPLIT)
    ranks = mesh.spawn(worker.jobs, ['cpu'] * 4,
                       ([('2x2', 'tp_case', (2, 2, case)),
                         ('1x4', 'tp_case', (1, 4, case)),
                         ('2x2_split', 'tp_case', (2, 2, split))],),
                       timeout=SPAWN_TIMEOUT_S)
    return dict(ranks=ranks, case=case, split=split)


def _one_process(case, steps):
    model = get_model(case['arch'], device='cpu', **case['model'])
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in case['init'].items()})
    tr = Trainer(_loaders(case['batch_size']), get_loss(), device='cpu',
                 verbose=False, eval_decoder='greedy')
    tr.init_state(model, seed=case['seed'])
    for _ in range(steps):
        tr.step(case['batch'], training=True, lr=case['lr'])
    return tr


def _held(readings, case, dp):
    """The ranks' gradients and 3-step parameters against one process."""
    want, after, _ = reference(case, dp)
    for r in readings:
        worst = shares(r['grads'], want)
        assert max(worst.values()) <= GRAD_TOL, sorted(
            worst.items(), key=lambda kv: -kv[1])[:3]
        assert r['nonfinite'] == 0
        for name, p in after.items():
            np.testing.assert_allclose(r['params'][name], p, rtol=2e-3,
                                       atol=1e-4, err_msg=name)
    return want


@pytest.mark.parametrize('dp,tp', [(1, 2), (2, 2), (1, 4)])
def test_train_step_matches_one_process(two_ranks, four_ranks, dp, tp):
    """Gathered gradients before clipping within 1e-5 of each tensor's max
    of one process's on the same dropout masks (cell and pre-LSTM dropout
    0.2), and parameters after 3 clipped Adam steps within the JAX test's
    rtol 2e-3 / atol 1e-4; every rank the same."""
    if tp == 2 and dp == 1:
        readings = [r['tiny'] for r in two_ranks['ranks']]
        case = two_ranks['tiny']
    else:
        key = f'{dp}x{tp}'
        readings = [r[key] for r in four_ranks['ranks']]
        case = four_ranks['case']
    _held(readings, case, dp)
    layout = readings[0]['layout']
    kinds = {k for k, _ in layout.values()}
    assert kinds == {'shard', 'slice', 'whole'}, kinds
    if tp == 4:     # blocks 0-1 replicated (16 < 32), used sliced
        assert layout['block0_conv.conv.weight'] == ('slice', 0)
        assert layout['block2_conv.conv.weight'] == ('shard', 0)


def test_local_shapes_follow_param_spec(two_ranks, four_ranks):
    """Each rank holds ``C / tp`` of a sharded parameter's sharded axis
    and the whole of every other; the placements the ranks read equal
    ``param_spec``'s."""
    model = get_model(TINY_ARCH, device='cpu', **MODEL, **TINY_KW)
    for readings, tp in (([r['tiny'] for r in two_ranks['ranks']], 2),
                         ([r['1x4'] for r in four_ranks['ranks']], 4)):
        for name, p in model.named_parameters():
            spec = param_spec(name, p, tp)
            for r in readings:
                assert r['placements'][name] == str(spec), name
                want = list(p.shape)
                if spec[1].is_shard():
                    want[spec[1].dim] //= tp
                assert list(r['local_shapes'][name]) == want, name


def test_flagship_cells_run_channel_parallel(two_ranks):
    """The flagship's cells at 4 groups all run channel-parallel (the
    fused cell on 12 or 16 channels, with the dropout offset).  The ranks'
    gradients are held to max(1e-5, 2 x the largest move of that tensor
    in one process under three 1e-7 nudges of the audio and under the
    JAX package's tp > 1 lowering, 'chunked' (the same function, its sums
    in other orders)), of each tensor's max: at these widths each moves a
    tensor by up to ~2e-5 of its max (clip gates flip), where the tiny
    model's moves stay under 1.1e-5.  Both planted faults land far outside
    the bound."""
    case = dict(two_ranks['flag'], steps=0)
    readings = [r['flag'] for r in two_ranks['ranks']]
    assert all(r['channel_cells'] == 4 for r in readings)
    want, bound, _ = _witness_bounds(case, 1, 'chunked')
    for r in readings:
        _within(shares(r['grads'], want), bound)
        for fault in ('sliced', 'c0'):
            bad = shares(r['faults'][fault], want)
            assert max(bad[n] / bound[n] for n in bad) > 100, fault


def _witness_bounds(case, dp, other=None):
    """One process's gradients on ``dp`` data ranks' semantics and its
    parameters after ``case['steps']`` steps, and per tensor max(1e-5, 2 x
    the largest move of its gradient under three 1e-7 nudges of the audio
    and under ``other`` cells if given (the same function, its sums in
    other orders)), of its max."""
    want, after, _ = reference(case, dp)
    case = dict(case, steps=0)
    audio = case['batch']['audio']
    bound = {n: GRAD_TOL for n in want}
    for seed in range(3):
        nudged = dict(case, batch=dict(case['batch'], audio=(audio * (
            1 + 1e-7 * np.random.RandomState(seed).randn(*audio.shape))
        ).astype(np.float32)))
        near = shares({k: v.numpy() for k, v in reference(nudged, dp)[0]
                       .items()}, want)
        bound = {n: max(bound[n], 2 * near[n]) for n in bound}
    if other is not None:
        moved = reference(dict(case, model=dict(case['model'],
                                                grouped_impl=other)), dp)[0]
        near = shares({k: v.numpy() for k, v in moved.items()}, want)
        bound = {n: max(bound[n], 2 * near[n]) for n in bound}
    return want, bound, after


def _within(got, bound):
    assert all(got[n] <= bound[n] for n in got), sorted(
        ((got[n] / bound[n], n) for n in got), reverse=True)[:3]


@pytest.mark.parametrize('key', ['split', '2x2_split', 'split_odd'])
def test_split_layout_matches_one_process(two_ranks, four_ranks, key):
    """``grouped_impl='pallas_split'`` at tp=2 (and dp=2 x tp=2): every
    flagship cell channel-parallel on the split layout of its rank's 2
    groups (the grouped conv kernels' plain versions, the split
    LayerNorm's statistics all-reduced), or, at 3 groups, every cell
    whole on the gathered split layout (gradients only); the gathered
    gradients before
    clipping within max(1e-5, 2 x the largest move of a tensor under three
    1e-7 audio nudges) of its max of one ``'pallas_split'`` process's (no
    other cells witness here: the split path's gate passes nothing at
    exactly 0 or 20, the others half, and zero biases meet those ties on
    every masked frame), the parameters after 3 steps within rtol 2e-3 /
    atol 1e-4; at (1, 2) the planted sliced-gradient fault lands far
    outside the bound."""
    dp = 2 if key == '2x2_split' else 1
    runs = four_ranks if dp == 2 else two_ranks
    readings = [r[key] for r in runs['ranks']]
    case = runs['split'] if dp == 2 else two_ranks[key]
    want, bound, after = _witness_bounds(case, dp)
    for r in readings:
        assert r['channel_cells'] == (0 if key == 'split_odd' else 4)
        assert r['nonfinite'] == 0
        _within(shares(r['grads'], want), bound)
        for name, p in after.items() if case['steps'] else ():
            np.testing.assert_allclose(r['params'][name], p, rtol=2e-3,
                                       atol=1e-4, err_msg=name)
        layout = r['layout']
        assert layout['block0_cell0.node0_conv5.conv_kernel_grouped'] == (
            'shard', 2)
        assert layout['block0_cell0.norm.scale'] == (
            ('whole', None) if key == 'split_odd' else ('slice', 0))
        if key == 'split':
            bad = shares(r['faults']['sliced'], want)
            assert max(bad[n] / bound[n] for n in bad) > 100


def test_planted_sliced_gradient_fault_is_rejected(two_ranks):
    """Leaving the sliced parameters' gradients unsummed over 'model'
    (each rank keeps its slice's share) fails the 1e-5 bound."""
    want, _, _ = reference(dict(two_ranks['tiny'], steps=0), 1)
    for r in two_ranks['ranks']:
        bad = shares(r['tiny']['faults']['sliced'], want)
        assert max(bad.values()) > 100 * GRAD_TOL
        assert bad['block0_norm.scale'] > 0.1


def test_matches_jax_parallel_trainer(two_ranks, jax_step):
    """The port at (1, 2) against the JAX package's ParallelTrainer at
    (1, 2) on the same batch and converted weights: the gathered gradients
    before clipping within 1e-4 of each tensor's max of ``jax.grad`` of the
    JAX trainer's loss (``JAX_GRAD_TOL``), the step's loss to rel 1e-5, the parameters after
    it to rtol 2e-3 / atol 1e-4 (the JAX test's own tolerances; one Adam
    step moves a weight by about lr, so these hold little more than the
    gradients' signs: the gradient check holds their magnitudes)."""
    for r in two_ranks['ranks']:
        worst = shares(r['jax']['grads'], jax_step['grads'])
        assert max(worst.values()) <= JAX_GRAD_TOL, sorted(
            worst.items(), key=lambda kv: -kv[1])[:3]
        assert r['jax']['step_metrics']['ctc_loss'] == pytest.approx(
            jax_step['loss'], rel=1e-5)
        for name, want in jax_step['after'].items():
            np.testing.assert_allclose(r['jax']['params'][name], want,
                                       rtol=2e-3, atol=1e-4, err_msg=name)


def test_split_matches_jax_parallel_trainer(two_ranks, jax_split_step):
    """``'pallas_split'`` at (1, 2) against the JAX ParallelTrainer on
    ``'pallas_split'`` at (1, 2) (its kernels in interpret mode, GSPMD on
    two CPU devices), every cell channel-parallel here: the gathered
    gradients before clipping per tensor within max(1e-4, the nudge bound
    of ``test_split_layout_matches_one_process``) of its max of
    ``jax.grad`` of the JAX trainer's loss (a 1e-7 nudge of the audio
    moves the block LayerNorm's gradients by about as much as one process
    reads against JAX: 2.1e-4 and 2.2e-4 of block0_norm.scale's max, at
    four blocks)."""
    _, bound, _ = _witness_bounds(two_ranks['jsplit'], 1)
    bound = {n: max(JAX_GRAD_TOL, b) for n, b in bound.items()}
    for r in two_ranks['ranks']:
        got = r['jax_split']
        assert got['channel_cells'] == 2
        _within(shares(got['grads'], jax_split_step['grads']), bound)


def _eval_held(two_ranks, key):
    one = _one_process(two_ranks[key], steps=0)
    want = one.evaluate(_loaders(BATCH)[2])
    for r in two_ranks['ranks']:
        got = r[key]['eval']
        assert got['ler'] == want['ler'] and got['wer'] == want['wer']
        assert got['ctc_loss'] == pytest.approx(want['ctc_loss'], rel=1e-5)


def test_eval_matches_one_process(two_ranks):
    _eval_held(two_ranks, 'tiny')


def test_split_eval_matches_one_process(two_ranks):
    _eval_held(two_ranks, 'split')


def _trainer_state(tr):
    out = {'params': {n: p.detach().numpy() for n, p in
                      tr.model.named_parameters()}}
    for key in ('exp_avg', 'exp_avg_sq'):
        out[key] = {n: tr.optimizer.state[p][key].numpy()
                    for n, p in tr.model.named_parameters()}
    return out


def _assert_states_equal(got, want):
    for part in ('params', 'exp_avg', 'exp_avg_sq'):
        assert got[part].keys() == want[part].keys()
        for name in want[part]:
            np.testing.assert_array_equal(got[part][name], want[part][name],
                                          err_msg=f'{part} {name}')


def test_one_process_checkpoint_resumes_at_tp2(two_ranks):
    want = _trainer_state(two_ranks['one'])
    for r in two_ranks['ranks']:
        _assert_states_equal(r['ckpt']['resumed'], want)


def test_split_checkpoint_resumes_at_tp2(two_ranks):
    """A one-process ``'pallas_split'`` checkpoint resumes at tp=2."""
    want = _trainer_state(two_ranks['one_split'])
    for r in two_ranks['ranks']:
        _assert_states_equal(r['split_ckpt']['resumed'], want)


def _tp2_checkpoint_held(two_ranks, key, path):
    case = two_ranks[key]
    saved = two_ranks['ranks'][0][key]['saved']
    one = _one_process(case, steps=0)
    one.load(path)
    _assert_states_equal(_trainer_state(one), saved)
    assert one.step_count == two_ranks['ranks'][0][key]['step']


@pytest.mark.parametrize('name', ['tp.ckpt', 'tp.flax'])
def test_tp2_checkpoint_loads_into_one_process(two_ranks, name):
    """``save`` and ``save_flax`` at tp=2 read back in one process
    bit-equal to the ranks' gathered parameters and Adam moments."""
    _tp2_checkpoint_held(two_ranks, 'ckpt', two_ranks['root'] / name)


@pytest.mark.parametrize('name', ['tp.ckpt', 'tp.flax'])
def test_split_tp2_checkpoint_loads_into_one_process(two_ranks, name):
    """The same on the split layout."""
    _tp2_checkpoint_held(two_ranks, 'split_ckpt',
                         two_ranks['root'] / 'split' / name)


def test_tp2_flax_checkpoint_loads_into_jax(two_ranks):
    """The JAX ``Trainer.load`` takes the tp=2 ``save_flax`` file: its
    parameters are the ranks' gathered ones."""
    saved = two_ranks['ranks'][0]['ckpt']['saved']['params']
    jtr = jax_get_trainer(jax_get_dataloaders(worker.DATA, batch_size=BATCH,
                                              curriculum=()), jax_get_loss(),
                          verbose=False)
    jtr.init_state(jax_get_model(TINY_ARCH, **MODEL, **TINY_KW), seed=0)
    jtr.load(str(two_ranks['root'] / 'tp.flax'))
    got = from_flax({'params': jax.tree_util.tree_map(np.asarray,
                                                      jtr.state.params)})
    assert got.keys() == saved.keys()
    for name, want in saved.items():
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)


# ---------------------------------------------------------------------------
# without spawned ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('c0,width', [(0, 24), (12, 12), (300, 300)])
def test_plain_dropout_offset_is_the_whole_cells_slice(c0, width):
    """``dropout_bits`` and ``hash_dropout`` at channel offset ``c0`` equal
    the whole width's bits and mask on channels ``[c0, c0 + width)``."""
    seed = torch.tensor([12345, -678], dtype=torch.int32)
    whole = dropout_bits(seed, 2, 3, 7, c0 + width)
    np.testing.assert_array_equal(
        dropout_bits(seed, 2, 3, 7, width, c0=c0).numpy(),
        whole[..., c0:].numpy())
    y = torch.rand((3, 7, c0 + width), generator=torch.Generator()
                   .manual_seed(c0))
    np.testing.assert_array_equal(
        hash_dropout(y[..., c0:], 0.2, seed, 2, c0=c0).numpy(),
        hash_dropout(y, 0.2, seed, 2)[..., c0:].numpy())


def test_profiler_hook_writes_a_trace(tmp_path):
    """``profile_dir`` writes a torch.profiler trace of train steps 1..N of
    the first epoch (step 0 left out)."""
    model = get_model(TINY_ARCH, device='cpu', **MODEL, **TINY_KW)
    loaders = get_dataloaders(worker.DATA, batch_size=BATCH, curriculum=())
    assert loaders[1].steps >= 3
    tr = Trainer(loaders, get_loss(), device='cpu', verbose=False,
                 eval_decoder='greedy', profile_dir=tmp_path / 'prof',
                 profile_steps=2)
    tr.train(model, epochs=1, lr=LR)
    traces = list((tmp_path / 'prof').glob('*.pt.trace.json'))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
