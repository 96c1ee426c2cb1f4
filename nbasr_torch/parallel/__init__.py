"""Parallel runtime of the port: process groups and meshes, the
data-parallel trainer, sweep orchestration, and the encoder's time halo
(``seqparallel``).  Tensor parallelism (``param_spec``,
``param_shardings``, ``batch_shardings``, ``replicated``) is the last port
slice of ``ROADMAP.md``."""

from .mesh import initialize_distributed, make_mesh
from .sweep import benchmark_pass, device_groups, run_sweep, \
    static_info_pass, unique_architectures
from .train_parallel import ParallelTrainer, get_parallel_trainer

__all__ = [
    'make_mesh', 'initialize_distributed',
    'ParallelTrainer', 'get_parallel_trainer',
    'run_sweep', 'unique_architectures', 'static_info_pass',
    'benchmark_pass', 'device_groups',
]
