"""Process groups and device meshes of the port, the counterpart of
``nbasr_tpu/parallel/mesh.py``.

JAX runs one SPMD program over a ``Mesh`` of devices; the port runs one
process per device (torchrun's model), so the ranks of a
``torch.distributed`` process group stand where JAX's devices stand, and
:func:`make_mesh` lays them out as a ``DeviceMesh`` with the JAX package's
dims ``('data', 'model')``, ranks laid out ``arange(n).reshape(dp, tp)``
(a ``'model'`` group is ``tp`` consecutive ranks).  Data parallelism runs
on ``'data'``, tensor parallelism on ``'model'``
(:class:`nbasr_torch.parallel.ParallelTrainer`,
:func:`nbasr_torch.parallel.tensor.tensor_parallel`).  :func:`param_spec`
is the JAX package's placement rule, applied to each parameter's flax
shape, and returns DTensor placements over the mesh's two dims as
descriptors: the port's parameters stay plain local tensors, each rank
holding its slice.

:func:`spawn` starts one process per device in one group (NCCL where each
rank has a card of its own, gloo on the CPU and for several ranks on one
card, which NCCL refuses): the sweep's device groups and the multi-process
dry run use it.
"""

import os
import pathlib
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..models.asr import resolve_device

__all__ = ['make_mesh', 'initialize_distributed', 'local_device',
           'backend_for', 'spawn', 'free_port', 'param_spec',
           'param_shardings', 'batch_shardings', 'replicated', 'model_size']

#: Leaves the JAX rule never shards (``nbasr_tpu/parallel/mesh.py:62``).
_REPLICATED_LEAVES = ('bias', 'scale', 'mean', 'variance')


def local_device(device='cuda'):
    """This process's device: ``device``, a CUDA device without an index
    taking torchrun's ``LOCAL_RANK`` (0 outside torchrun)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    return resolve_device(device)


def backend_for(devices):
    """``'nccl'`` where every rank has a card of its own, else ``'gloo'``
    (CPU ranks, or several ranks on one card)."""
    devices = [torch.device(d) for d in devices]
    if (all(d.type == 'cuda' for d in devices)
            and len(set(devices)) == len(devices)):
        return 'nccl'
    return 'gloo'


def initialize_distributed(device='cuda', **kwargs):
    """``init_process_group`` from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or from ``kwargs``
    (``init_method``, ``world_size``, ``rank``): NCCL for a CUDA
    ``device``, gloo for the CPU.  Returns ``(rank, world)``; does nothing
    where a group exists already or the process runs alone (no torchrun
    environment and no ``kwargs``)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not kwargs and 'WORLD_SIZE' not in os.environ:
        return 0, 1
    kwargs.setdefault('init_method', 'env://')
    dist.init_process_group(
        'nccl' if torch.device(device).type == 'cuda' else 'gloo', **kwargs)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(dp=None, tp=1, devices=None):
    """A ``DeviceMesh`` with dims ``('data', 'model')`` over the ranks of
    the process group, one rank per entry of ``devices`` (default: one per
    process; ``devices`` names each rank's device, which sets the mesh's
    device type).  ``dp`` defaults to ``n // tp``; the dims must multiply
    to the device count; each ``'model'`` group is ``tp`` consecutive
    ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if devices is None else len(devices)
    if dp is None:
        if n % tp:
            raise ValueError(f'{n} devices not divisible by tp={tp}')
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f'dp*tp = {dp}*{tp} != {n} devices')
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: run under '
                           'torchrun, or call initialize_distributed')
    if n != world:
        raise ValueError(f'{n} devices for {world} processes: the port '
                         f'runs one process per device')
    if devices is None:
        kind = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    else:
        kind = torch.device(devices[dist.get_rank()]).type
    return DeviceMesh(kind, np.arange(n).reshape(dp, tp).tolist(),
                      mesh_dim_names=('data', 'model'))


def model_size(mesh):
    """The size of the mesh's ``'model'`` dim."""
    return mesh.size(mesh.mesh_dim_names.index('model'))


def param_spec(name, param, tp):
    """The placements over ``('data', 'model')`` of parameter ``name``
    (a state-dict key) of shape ``param.shape``: the JAX package's rule
    (``nbasr_tpu/parallel/mesh.py:56-69``) on its flax shape.  A kernel
    whose flax last (output-feature) axis divides by ``tp`` and is at least
    ``8 * tp`` wide is ``Shard`` on that axis over ``'model'`` (dim 0 of a
    conv's torch ``[cout, cin, K]`` weight, the last dim of everything
    else); ``bias``, ``scale``, ``mean``, ``variance``, 0-d leaves and
    narrower kernels are replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from ..convert import flax_key
    key, transposed = flax_key(name)
    shape = tuple(param.shape)
    if (tp <= 1 or not shape or key.rpartition('.')[2] in _REPLICATED_LEAVES
            or shape[0 if transposed else -1] % tp
            or shape[0 if transposed else -1] < 8 * tp):
        return (Replicate(), Replicate())
    return (Replicate(), Shard(0 if transposed else len(shape) - 1))


def param_shardings(model, mesh):
    """``{name: placements}`` of ``model``'s parameters by
    :func:`param_spec` at the mesh's ``'model'`` size; for a model that
    :func:`~nbasr_torch.parallel.tensor.tensor_parallel` has sharded, on
    the whole shapes it keeps."""
    tp = model_size(mesh)
    shapes = getattr(model, 'tp_full_shapes', None) or {
        n: p.shape for n, p in model.named_parameters()}
    return {n: param_spec(n, torch.empty(s, device='meta'), tp)
            for n, s in shapes.items()}


def batch_shardings(mesh):
    """Placements of every input batch leaf: the batch axis on ``'data'``
    (each data rank's loader gives its rows), replicated over ``'model'``."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


def replicated(mesh):
    """Placements of a value every rank holds whole."""
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


def free_port():
    """A TCP port free on localhost now (for a group's ``tcp://``
    rendezvous)."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawned(rank, fn, devices, backend, port, out_dir, args):
    device = devices[rank]
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    else:                       # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    dist.init_process_group(backend, init_method=f'tcp://127.0.0.1:{port}',
                            world_size=len(devices), rank=rank)
    try:
        out = fn(rank, len(devices), device, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    pathlib.Path(out_dir, f'{rank}.pickle').write_bytes(pickle.dumps(out))


def spawn(fn, devices, args=(), timeout=None):
    """Run ``fn(rank, world, device, *args)`` in one spawned process per
    entry of ``devices``, all in one process group (:func:`backend_for`);
    returns each rank's return value, in rank order.  ``fn`` must be
    importable (a module-level function).  A process that raises or exits
    non-zero makes this raise with its traceback, the others stopped; so
    does ``timeout`` seconds passing (every process is killed)."""
    devices = [resolve_device(d) for d in devices]
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _spawned, args=(fn, devices, backend_for(devices), free_port(),
                            out_dir, tuple(args)),
            nprocs=len(devices), join=False, start_method='spawn')
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(None if deadline is None else
                               max(deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f'{len(devices)} spawned processes '
                                       f'ran past {timeout} s')
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [pickle.loads(pathlib.Path(out_dir, f'{r}.pickle').read_bytes())
                for r in range(len(devices))]
