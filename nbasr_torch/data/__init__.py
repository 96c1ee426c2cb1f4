"""Data assets of the port; the host input pipeline is
:mod:`nbasr_torch.data.pipeline`."""

import pathlib

import numpy as np

__all__ = ['load_train_stats']


def load_train_stats():
    """Frozen 80-dim mean/variance of TIMIT-train log-mels (the reference's
    ``training/timit_train_stats.npz``; own copy of the JAX package's file)."""
    with np.load(pathlib.Path(__file__).parent / 'timit_train_stats.npz') as s:
        return s['mean'], s['variance']
