"""Parallel runtime of the port: process groups and meshes with the JAX
package's placement rule (``mesh``), the data- and tensor-parallel trainer
(``train_parallel``, ``tensor``), sweep orchestration, and sequence
parallelism (``seqparallel``: the encoder's time halo and
``seq_parallel_apply``)."""

from . import tensor
from .mesh import batch_shardings, initialize_distributed, make_mesh, \
    param_shardings, param_spec, replicated
from .seqparallel import encoder_halo, seq_parallel_apply
from .sweep import benchmark_pass, device_groups, run_sweep, \
    static_info_pass, unique_architectures
from .tensor import tensor_parallel
from .train_parallel import ParallelTrainer, get_parallel_trainer

__all__ = [
    'make_mesh', 'initialize_distributed', 'param_spec', 'param_shardings',
    'batch_shardings', 'replicated', 'tensor', 'tensor_parallel',
    'ParallelTrainer', 'get_parallel_trainer', 'encoder_halo',
    'seq_parallel_apply',
    'run_sweep', 'unique_architectures', 'static_info_pass',
    'benchmark_pass', 'device_groups',
]
