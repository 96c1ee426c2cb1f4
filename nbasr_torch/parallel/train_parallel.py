"""Data- and tensor-parallel trainer of the port, the counterpart of
``nbasr_tpu/parallel/train_parallel.py``.

One process per device on a ``('data', 'model')`` mesh.  Each data rank
has its shard of the data (the loaders' ``num_shards``/``shard_index``:
each global batch's contiguous rows; the model ranks of one data rank
share it), and the model wrapped in ``DistributedDataParallel`` over the
mesh's ``'data'`` group.  The step keeps the JAX trainer's data-axis
semantics (``nbasr_tpu/training/trainer.py:167-202``):

  - the loss of the global batch: each rank's weighted CTC sum over the
    all-reduced count of valid rows, plus the conv L2 over the world size;
    the gradients are **summed** over the ranks (a DDP communication hook
    that sums: DDP's own averages), so clipping and Adam see the gradient
    one process would compute on the whole batch;
  - the (num, den) metric pairs are all-reduced over ``'data'``, in
    train and eval;
  - the data rank is folded into the dropout seed (data rank 0 keeps the
    single-process stream; the model ranks of one data rank draw alike);
  - only rank 0 writes files; every rank loads on resume.

At tp > 1 the model goes through
:func:`~nbasr_torch.parallel.tensor.tensor_parallel` before DDP, and the
optimizer holds the local shards.  After the backward the gradients of
replicated parameters the compute uses sliced are summed over ``'model'``;
the clip-5 global norm sums the shards' squares over ``'model'`` and counts
each replicated parameter once; the non-finite skip reads the largest
|gradient| over all ranks, so every rank skips together; the conv L2's
value is all-reduced over ``'model'``.  ``save``/``save_flax`` gather the
whole model and Adam's moments (every rank calls them, rank 0 writes) and
``load`` takes the slices, so a tp=2 checkpoint loads into one process and
into the JAX ``Trainer`` unchanged.

The cell kernels stay fused: there is no GSPMD here, so none of the JAX
package's fallback to ``'chunked'`` is needed.  ``grouped_impl=
'pallas_split'`` at tp > 1 raises (:data:`nbasr_torch.parallel.mesh.TP_LATER`).
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..training.loss import conv_l2
from ..training.trainer import Trainer
from . import tensor
from .mesh import initialize_distributed, local_device, make_mesh, \
    model_size

__all__ = ['ParallelTrainer', 'get_parallel_trainer', 'fold_rank']


def fold_rank(seed, rank):
    """A data rank's dropout seed: ``seed`` itself for rank 0, distinct per
    data rank (the JAX trainer's ``fold_in`` of the data-axis index)."""
    return (seed + rank * 0x9E3779B97F4A7C15) % (1 << 63)


def _sum_hook(group, bucket):
    """DDP communication hook: all-reduce a gradient bucket as a sum."""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def _loaders(dataloaders):
    """The three loaders of ``(encoder, train, val, test)``, a curriculum
    stream's full-data loader for the train split."""
    _, train, val, test = dataloaders
    return (getattr(train, 'full', train), val, test)


class ParallelTrainer(Trainer):
    """Trainer over a ``('data', 'model')`` mesh, one process per device,
    in a process group (torchrun's, or one the caller initialised).
    ``dataloaders`` are this data rank's shards (``get_dataloaders(...,
    num_shards=dp, shard_index=rank // tp)``); ``device`` defaults to
    ``cuda:LOCAL_RANK``."""

    def __init__(self, dataloaders, loss=None, mesh=None, dp=None, tp=1,
                 device='cuda', **kwargs):
        device = local_device(device)
        initialize_distributed(device=device)
        super().__init__(dataloaders, loss, device=device, **kwargs)
        self.mesh = mesh if mesh is not None else make_mesh(dp=dp, tp=tp)
        self.group = self.mesh.get_group('data')
        self.rank = dist.get_rank(self.group)
        self.world = dist.get_world_size(self.group)
        self.tp = model_size(self.mesh)
        for loader in _loaders(dataloaders):
            shards = (getattr(loader, 'num_shards', 1),
                      getattr(loader, 'shard_index', 0))
            if loader is not None and shards != (self.world, self.rank):
                raise ValueError(
                    f'rank {self.rank} of {self.world} needs its shard of '
                    f'the data: a loader has (num_shards, shard_index) = '
                    f'{shards}; build it with get_dataloaders(..., '
                    f'num_shards={self.world}, shard_index={self.rank})')

    @property
    def is_lead(self):
        return dist.get_rank() == 0

    def init_state(self, model, seed=0):
        if self.tp > 1 and not hasattr(model, 'tp_layout'):
            tensor.tensor_parallel(model, self.mesh)
        super().init_state(model, seed=seed)
        self.generator.manual_seed(fold_rank(seed + 1, self.rank))
        self.net = DistributedDataParallel(
            model, device_ids=[self.device.index]
            if self.device.type == 'cuda' else None,
            process_group=self.group)
        self.net.register_comm_hook(self.group, _sum_hook)
        return self

    def _all_reduce(self, t):
        """The sum of ``t`` over the ranks, in place (``t`` is a fresh
        tensor)."""
        dist.all_reduce(t, group=self.group)
        return t

    def _objective(self, logits, lsize, batch, m):
        valid = batch['valid']
        den = self._all_reduce(valid.sum())
        ctc = self.loss(logits, lsize, batch['labels'], batch['label_size'],
                        metrics=m, valid=valid, denominator=den)
        l2 = tensor.conv_l2(self.model) if self.tp > 1 else \
            conv_l2(self.model)
        return ctc + l2 / self.world

    def _loss_and_grads(self, batch):
        m = super()._loss_and_grads(batch)
        if self.tp > 1:
            self._sum_sliced_grads()
        return m

    def _sum_sliced_grads(self):
        tensor.sum_sliced_grads(self.model)

    def _grad_norm(self, params):
        if self.tp == 1:
            return super()._grad_norm(params)
        norm = torch.sqrt(tensor.grad_norm_sq(self.model, params))
        peak = torch.stack(torch._foreach_norm(
            [p.grad for p in params], float('inf'))).max()
        return norm, tensor.all_reduce_max(peak)

    # -- checkpoints of the whole model -----------------------------------

    def _moments(self, opt_state, fn):
        """Adam's per-parameter state of ``opt_state`` with ``fn``
        (:func:`tensor.gather_named` or :func:`tensor.shard_named`) applied
        to each moment; the step counts as they are."""
        names = [n for n, _ in self.model.named_parameters()]
        return {i: {k: v if k == 'step' else
                    fn(self.model, {names[i]: v})[names[i]]
                    for k, v in st.items()}
                for i, st in opt_state['state'].items()}

    def full_state(self):
        if self.tp == 1:
            return super().full_state()
        opt_state = self.optimizer.state_dict()
        return (tensor.gather_named(self.model, self.model.state_dict()),
                dict(opt_state, state=self._moments(opt_state,
                                                    tensor.gather_named)))

    def full_shapes(self):
        if self.tp == 1:
            return super().full_shapes()
        return dict(self.model.tp_full_shapes)

    def load_full_state(self, model_state, optimizer_state):
        if self.tp == 1:
            return super().load_full_state(model_state, optimizer_state)
        self.model.load_state_dict(tensor.shard_named(self.model,
                                                      model_state))
        self.optimizer.load_state_dict(dict(
            optimizer_state,
            state=self._moments(optimizer_state, tensor.shard_named)))

    def _sum_metrics(self, m):
        flat = self._all_reduce(torch.stack(
            [torch.stack([n.detach().float(), d.detach().float()])
             for n, d in m.values()]))
        return {k: (flat[i, 0], flat[i, 1]) for i, k in enumerate(m)}

    def shard_batch(self, batch):
        """This rank's rows of a global batch: its rows padded with
        ``valid=0`` rows to a multiple of the world size, then the rank's
        contiguous block (the rows its loader shard gives)."""
        rows = len(batch['valid'])
        pad = (-rows) % self.world
        if pad:
            batch = {k: np.concatenate(
                [np.asarray(v), np.zeros((pad,) + np.shape(v)[1:],
                                         np.asarray(v).dtype)])
                for k, v in batch.items()}
        local = (rows + pad) // self.world
        lo = self.rank * local
        return {k: np.asarray(v)[lo:lo + local] for k, v in batch.items()}


def get_parallel_trainer(dataloaders, loss=None, **kwargs):
    return ParallelTrainer(dataloaders, loss, **kwargs)
