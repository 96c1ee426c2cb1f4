"""Rank functions for ``nbasr_torch.parallel.mesh.spawn`` in the port's
tensor- and sequence-parallel tests: each runs in a spawned process, in a
gloo group, and imports nothing of JAX
(``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_seqparallel.py``)."""

import numpy as np
import torch

from nbasr_torch import checkpoint
from nbasr_torch.data.pipeline import get_dataloaders
from nbasr_torch.models.asr import get_model
from nbasr_torch.parallel import ParallelTrainer, make_mesh, tensor
from nbasr_torch.parallel.mesh import param_shardings
from nbasr_torch.parallel.seqparallel import seq_parallel_apply
from nbasr_torch.training import get_loss

DATA = 'synthetic:16'


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def _whole(model, tensors):
    return _numpy(tensor.gather_named(model, tensors))


def _channel_cells(model):
    return [m for m in model.modules() if isinstance(m, tensor.ChannelCell)]


def _set_offset(model, c0=None):
    """Set every channel-parallel cell's dropout offset to ``c0`` (None:
    back to its own); returns the cells' own offsets."""
    own = []
    for cell in _channel_cells(model):
        inner = cell.inner
        own.append(inner.spec.channel_offset)
        c = own[-1] if c0 is None else c0
        inner.spec.channel_offset = inner.train_spec.channel_offset = c
        for m in inner.children():
            if hasattr(m, 'channel_offset'):
                m.channel_offset = c
    return own


def _trainer(dp, tp, device, case, rank, **kwargs):
    mesh = make_mesh(dp=dp, tp=tp)
    loaders = get_dataloaders(DATA, batch_size=case['batch_size'],
                              curriculum=(), num_shards=dp,
                              shard_index=rank // tp)
    model = get_model(case['arch'], device=device, **case['model'])
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in case['init'].items()})
    placements = {n: str(pl) for n, pl in param_shardings(model,
                                                           mesh).items()}
    trainer = ParallelTrainer(loaders, get_loss(), device=device, mesh=mesh,
                              verbose=False, eval_decoder='greedy', **kwargs)
    trainer.init_state(model, seed=case['seed'])
    return trainer, loaders, placements


def tp_case(rank, world, device, dp, tp, case):
    """One (dp, tp) run of ``case`` (arch, model kwargs, init weights, the
    global batch, seed, lr, steps): the placements and local shapes; the
    gathered gradients before clipping and the step's metrics; the same
    gradients with each fault of ``case['faults']`` planted (``'sliced'``:
    the sliced parameters' gradients not summed over ``'model'``;
    ``'c0'``: dropout offset 0 on model rank 1), on the same masks; the
    gathered parameters after ``case['steps']`` steps and, with
    ``case['eval']``, the eval metrics at the start."""
    trainer, loaders, placements = _trainer(dp, tp, device, case, rank)
    model = trainer.model
    batch = trainer.shard_batch(case['batch'])
    out = dict(placements=placements,
               local_shapes={n: tuple(p.shape)
                             for n, p in model.named_parameters()},
               layout=dict(model.tp_layout),
               channel_cells=len(_channel_cells(model)))
    if case.get('eval'):
        out['eval'] = trainer.evaluate(loaders[2])
    masks = trainer.generator.get_state()
    grads, out['metrics'] = trainer.gradients(batch)
    out['grads'] = _whole(model, grads)
    drawn = trainer.generator.get_state()
    out['faults'] = {}
    for fault in case.get('faults', ()):
        trainer.generator.set_state(masks)
        if fault == 'sliced':
            trainer._sum_sliced_grads = lambda: None
        elif rank % tp == 1:
            _set_offset(model, 0)
        grads, _ = trainer.gradients(batch)
        out['faults'][fault] = _whole(model, grads)
        trainer.__dict__.pop('_sum_sliced_grads', None)
        _set_offset(model)
    trainer.generator.set_state(drawn)
    last = None
    for _ in range(case['steps']):
        last = trainer.step(batch, training=True, lr=case['lr'])
    out['params'] = _whole(model, dict(model.named_parameters()))
    out['nonfinite'] = trainer.nonfinite_steps
    out['step_metrics'] = last
    return out


def tp_checkpoints(rank, world, device, case, one_process_ckpt, out_dir):
    """At (dp, tp) = (1, ``world``): resume the one-process checkpoint and
    return the gathered state; take ``case['steps']`` steps; write
    ``save`` and ``save_flax`` files into ``out_dir`` and return the
    gathered state they should hold."""
    trainer, _, _ = _trainer(1, world, device, case, rank)
    model = trainer.model
    trainer.load(one_process_ckpt)
    resumed = _state(trainer)
    batch = trainer.shard_batch(case['batch'])
    for _ in range(case['steps']):
        trainer.step(batch, training=True, lr=case['lr'])
    trainer.save(f'{out_dir}/tp.ckpt', epoch=1)
    checkpoint.save_flax(trainer, f'{out_dir}/tp.flax', epoch=1)
    return dict(resumed=resumed, saved=_state(trainer),
                step=trainer.step_count,
                shapes={n: tuple(p.shape) for n, p in model.named_parameters()})


def _state(trainer):
    """Gathered parameters and Adam moments by name."""
    model = trainer.model
    out = {'params': _whole(model, dict(model.named_parameters()))}
    for key in ('exp_avg', 'exp_avg_sq'):
        out[key] = _whole(model, {n: trainer.optimizer.state[p][key]
                                  for n, p in model.named_parameters()})
    return out


def tp_refusals(rank, world, device, arch, kw):
    """What ``tensor_parallel`` refuses at tp=``world``: the split
    layout."""
    from nbasr_torch.parallel.tensor import tensor_parallel
    model = get_model(arch, device=device, grouped_impl='pallas_split', **kw)
    try:
        tensor_parallel(model, make_mesh(dp=1, tp=world))
    except NotImplementedError as e:
        return str(e)
    return None


def seq_case(rank, world, device, arch, kw, init, feats, sizes, modes):
    """``seq_parallel_apply`` of this rank's time shard of ``feats`` for
    each ``(use_rnn, lstm_mode)`` of ``modes``; the errors it raises for
    a T the ranks and stride do not divide and for shards shorter than
    the halo."""
    out = {}
    feats = torch.as_tensor(feats)
    sizes = torch.as_tensor(sizes)
    L = feats.shape[1] // world
    shard = feats[:, rank * L:(rank + 1) * L]
    for use_rnn, mode in modes:
        model = get_model(arch, use_rnn=use_rnn, device=device, **kw)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in init[use_rnn].items()})
        with torch.no_grad():
            out[(use_rnn, mode)] = seq_parallel_apply(
                model, shard, sizes, lstm_mode=mode).numpy()
    errors = {}
    for name, frames in (('stride', L - 1), ('halo', 8)):
        try:
            seq_parallel_apply(model, torch.zeros((1, frames, 80)),
                               torch.tensor([frames * world]))
        except ValueError as e:
            errors[name] = str(e)
    out['errors'] = errors
    return out


def jobs(rank, world, device, todo):
    """Run ``todo`` (``[(name, function name, args)]``) in order in one
    group; returns ``{name: result}``."""
    return {name: globals()[fn](rank, world, device, *args)
            for name, fn, args in todo}
