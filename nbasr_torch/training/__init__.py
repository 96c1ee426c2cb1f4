"""Training recipe of the port: loss, ratio metrics, the Trainer, seeding
and device preparation."""

import random

import numpy as np
import torch

from ..data.pipeline import get_dataloaders
from ..models.asr import resolve_device
from .loss import L2_COEFF, conv_l2, get_loss
from .metrics import METRIC_KEYS, accumulate, ratios, zeros_like_metrics
from .trainer import Trainer, get_trainer, lr_at_epoch

__all__ = ['L2_COEFF', 'conv_l2', 'get_loss', 'METRIC_KEYS', 'accumulate',
           'ratios', 'zeros_like_metrics', 'Trainer', 'get_trainer',
           'lr_at_epoch', 'set_seed', 'prepare_devices', 'get_dataloaders']


def set_seed(seed):
    """Seed Python's, numpy's and torch's global RNGs; returns a
    ``torch.Generator`` seeded with ``seed`` (the port's model init and
    dropout draw from an explicit generator, as the JAX package's from an
    explicit key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def prepare_devices(devices=None):
    """Validate and return the devices to use as ``torch.device``s.

    ``None`` gives every CUDA device; an int or a list of ints names CUDA
    devices by index; a device or its name (``'cuda:1'``, ``'cpu'``) is
    taken as asked.  A CUDA device the machine lacks raises: nothing falls
    back to the CPU unless the caller names it."""
    if devices is None:
        resolve_device('cuda')
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    if isinstance(devices, (int, str, torch.device)):
        devices = [devices]
    picked = []
    for d in devices:
        d = resolve_device(torch.device('cuda', d) if isinstance(d, int)
                           else d)
        if d.type == 'cuda' and d.index >= torch.cuda.device_count():
            raise ValueError(f'Device index {d.index} out of range '
                             f'({torch.cuda.device_count()} available)')
        picked.append(d)
    return picked
