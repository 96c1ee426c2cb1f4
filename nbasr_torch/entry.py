"""Entry points of the port, the twin of ``__graft_entry__.py``: the
full-width flagship's forward on the card, and a multi-process dry run of
the data-parallel train and eval steps.

    python -m nbasr_torch.entry          # the forward, on the card
    python -m nbasr_torch.entry 4        # the dry run, 4 gloo processes

The dry run takes tp=2 where the process count is even, as the JAX
package's does (``__graft_entry__.py:34``), dp = n / tp.
"""

import math

import numpy as np
import torch

__all__ = ['FLAGSHIP', 'entry', 'dryrun_multichip']

#: The README's flagship arch.
FLAGSHIP = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]


def _flagship(device, **model_kwargs):
    from .models.asr import get_model
    return get_model(FLAGSHIP, use_rnn=True, dropout_rate=0.2, data_norm=True,
                     device=device, generator=torch.Generator().manual_seed(0),
                     **model_kwargs)


def entry(device='cuda'):
    """``(forward, example_args)``: the full-width flagship's eval forward
    on ``device`` and a seeded B=2, T=296 batch of features (one row 40
    frames short)."""
    model = _flagship(device).eval()
    B, T = 2, 296
    feats = torch.as_tensor(
        np.random.RandomState(0).randn(B, T, 80).astype(np.float32),
        device=model.head.kernel.device)
    sizes = torch.as_tensor([T, T - 40], dtype=torch.int32,
                            device=feats.device)

    @torch.no_grad()
    def forward(feats, sizes):
        return model(feats, sizes)

    return forward, (feats, sizes)


def _dryrun_rank(rank, world, device, model_kwargs, tp):
    from .data.pipeline import get_dataloaders
    from .parallel.train_parallel import ParallelTrainer
    from .training import get_loss
    dp = world // tp
    loaders = get_dataloaders(f'synthetic:{4 * dp}', batch_size=2 * dp,
                              curriculum=(), num_shards=dp,
                              shard_index=rank // tp)
    trainer = ParallelTrainer(loaders, get_loss(), device=device, dp=dp,
                              tp=tp, eval_decoder='greedy', verbose=False)
    trainer.init_state(_flagship(device, **model_kwargs), seed=0)
    batch = next(iter(loaders[1]))
    return (trainer.step(batch, training=True, lr=1e-4),
            trainer.step(batch, training=False))


def dryrun_multichip(n_devices, model_kwargs=None, timeout=None):
    """``n_devices`` gloo processes on the CPU, one
    :class:`~nbasr_torch.parallel.ParallelTrainer` train step and one eval
    step of the flagship (``model_kwargs`` overrides its widths) over a
    ('data', 'model') mesh with tp=2 where ``n_devices`` is even (else 1),
    dp = n / tp.  Returns rank 0's (train, eval) metrics."""
    from .parallel.mesh import spawn
    tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    train, evaluation = spawn(_dryrun_rank, ['cpu'] * n_devices,
                              (model_kwargs or {}, tp), timeout=timeout)[0]
    if not (math.isfinite(train['ctc_loss'])
            and math.isfinite(evaluation['ctc_loss'])):
        raise FloatingPointError(f'dryrun_multichip({n_devices}): '
                                 f'{train} {evaluation}')
    print(f'dryrun_multichip({n_devices}): mesh {{data: '
          f'{n_devices // tp}, model: {tp}}} train '
          f'ctc_loss={train["ctc_loss"]:.4f} '
          f'eval ler={evaluation["ler"]:.4f}')
    return train, evaluation


if __name__ == '__main__':
    import sys
    if len(sys.argv) > 1:
        dryrun_multichip(int(sys.argv[1]))
    else:
        fn, args = entry()
        print('entry forward:', tuple(fn(*args).shape))
