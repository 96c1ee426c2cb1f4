"""nbasr_torch: NAS-Bench-ASR on PyTorch and CUDA (NVIDIA Hopper).

A port of ``nbasr_tpu`` that imports nothing of JAX or of that package.
Its facade mirrors the JAX package's (``nbasr_tpu/__init__.py``, after the
reference's ``nasbench_asr/__init__.py``):

  - dataset query: :func:`from_folder`, :class:`Dataset`,
    :class:`BenchmarkingDataset`, :class:`StaticInfoDataset`;
  - search space and searches: :mod:`.search_space`, :mod:`.graph_utils`,
    :mod:`.search` (zero-cost proxies in :mod:`.models.proxies`);
  - model and training: :func:`get_model`, :func:`get_dataloaders`,
    :func:`get_loss`, :func:`get_trainer`, :func:`set_seed`,
    :func:`prepare_devices`, imported on first call.

``models.get_model`` builds the encoder on a device; ``serving.StreamingASR``
streams audio through it; ``training.Trainer`` (and ``python -m
nbasr_torch.train``, the twin of ``train.py``) trains it and evaluates it
with the beam-search decoder; ``python -m nbasr_torch.cli`` queries, hashes,
draws and scores architectures.  Every SearchCell runs the hand-written CUDA
kernels in ``csrc/fused_cell.cu`` (forward, with dropout) and
``csrc/fused_cell_bwd.cu`` (backward), or those of ``csrc/grouped_conv.cu``
on the unfused paths, and the CTC loss its recursions in ``csrc/ctc.cu``,
on the card.  Entry points default to ``device='cuda'``; the CPU runs only
when asked for, and there the kernels' plain PyTorch versions stand in.
"""

from . import graph_utils, search, search_space
from .dataset import BenchmarkingDataset, Dataset, StaticInfoDataset, \
    from_folder
from .version import __version__


def set_default_backend(backend=None):
    """Compatibility shim: there is exactly one backend ('torch')."""
    if backend not in (None, 'torch'):
        raise ValueError(f'Unknown backend: {backend!r} (this port is '
                         f'PyTorch-only)')
    return 'torch', 'torch'


def get_backend_name():
    """Compatibility shim: always ('torch', 'torch')."""
    return 'torch', 'torch'


def set_seed(seed):
    """Seed Python's, numpy's and torch's RNGs; returns a seeded
    ``torch.Generator`` for model init and dropout."""
    from .training import set_seed as impl
    return impl(seed)


def prepare_devices(devices=None):
    """Validate and return the CUDA devices to use (see training)."""
    from .training import prepare_devices as impl
    return impl(devices)


def get_model(arch_vec, **kwargs):
    """Build the flagship ASR encoder for ``arch_vec`` (see models.asr)."""
    from .models import get_model as impl
    return impl(arch_vec, **kwargs)


def get_dataloaders(timit_root, batch_size=64, **kwargs):
    """Build TIMIT train/val/test loaders (see data.pipeline)."""
    from .training import get_dataloaders as impl
    return impl(timit_root, batch_size=batch_size, **kwargs)


def get_loss():
    """CTC loss closure matching the reference contract (training.loss)."""
    from .training import get_loss as impl
    return impl()


def get_trainer(dataloaders, loss=None, save_dir=None, verbose=True,
                **kwargs):
    """Build a Trainer (see training.trainer)."""
    from .training import get_trainer as impl
    return impl(dataloaders, loss, save_dir=save_dir, verbose=verbose,
                **kwargs)
