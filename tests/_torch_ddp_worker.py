"""Rank functions for ``nbasr_torch.parallel.mesh.spawn`` in the port's
data-parallel tests: each runs in a spawned process, in a gloo group, and
imports nothing of JAX (``tests/test_torch_parallel.py``,
``tests/test_torch_sweep.py``)."""

import numpy as np
import torch

from nbasr_torch.data.pipeline import get_dataloaders
from nbasr_torch.models.asr import get_model
from nbasr_torch.parallel import ParallelTrainer
from nbasr_torch.training import get_loss


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def data_parallel_checks(rank, world, device, arch, kw, init, lr, save_root,
                         zero_arch):
    """Gradients before clipping, then 3 steps, of the model ``init`` on
    this rank's shard of the first train batch; the training forward's
    output at dropout 0.2 on a fixed input; a one-epoch ``train`` into
    ``save_root/rank<r>``; one step of ``zero_arch``, and one of ``arch``
    with ``remat_cells``."""
    loaders = get_dataloaders('synthetic:12', batch_size=4, curriculum=(),
                              num_shards=world, shard_index=rank)
    batch = next(iter(loaders[1]))
    model = get_model(arch, use_rnn=True, dropout_rate=0.0, cell_dropout=0.0,
                      data_norm=True, device=device, **kw)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in init.items()})
    trainer = ParallelTrainer(loaders, get_loss(), device=device,
                              verbose=False, eval_decoder='greedy')
    trainer.init_state(model, seed=0)
    whole = next(iter(get_dataloaders('synthetic:12', batch_size=4,
                                      curriculum=())[1]))
    shard = trainer.shard_batch(whole)
    shard_ok = shard.keys() == batch.keys() and all(
        np.array_equal(shard[k], batch[k]) for k in batch)
    grads, metrics = trainer.gradients(batch)
    for _ in range(3):
        trainer.step(batch, training=True, lr=lr)
    out = dict(rows=len(batch['valid']), shard_ok=shard_ok,
               grads=_numpy(grads), metrics=metrics,
               params=_numpy(trainer.model.state_dict()),
               steps=trainer.step_count, nonfinite=trainer.nonfinite_steps)

    dropping = get_model(arch, use_rnn=True, dropout_rate=0.2, device=device,
                         generator=torch.Generator().manual_seed(1), **kw)
    trainer.init_state(dropping, seed=0)
    feats = torch.as_tensor(np.random.RandomState(0).randn(
        2, 64, 80).astype(np.float32), device=device)
    with torch.no_grad():
        out['dropout_logits'] = dropping.train()(
            feats, generator=trainer.generator).cpu().numpy()

    trainer = ParallelTrainer(loaders, get_loss(), device=device,
                              verbose=False, eval_decoder='greedy',
                              save_dir=f'{save_root}/rank{rank}')
    trainer.train(get_model(arch, use_rnn=True, dropout_rate=0.2,
                            device=device, **kw),
                  epochs=1, lr=lr, seed=0, model_name='run')

    zero = ParallelTrainer(loaders, get_loss(), device=device, verbose=False,
                           eval_decoder='greedy')
    zero.init_state(get_model(zero_arch, use_rnn=True, dropout_rate=0.2,
                              device=device, **kw), seed=0)
    out['zero_arch'] = zero.step(batch, training=True, lr=lr)
    zero.init_state(get_model(arch, use_rnn=True, dropout_rate=0.2,
                              remat_cells=True, device=device, **kw), seed=0)
    out['remat_cells'] = zero.step(batch, training=True, lr=lr)
    return out
