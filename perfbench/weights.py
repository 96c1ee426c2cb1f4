"""The weights of a run: made on the device from ``--seed`` in one
normal draw, shaped and scaled by the architecture's parameter table, and
handed alike to the program (``install``) and to the reference."""

import math

import torch

from . import archs

__all__ = ['generate', 'install']


def generate(cfg, seed, device):
    """``{name: float32 tensor}`` of every parameter, on ``device``."""
    table = archs.find(cfg).param_table(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in table)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, std, offset in table:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape).mul_(std)
        if offset == 'forget':
            h = shape[0] // 4
            v[h:2 * h] += 1.0
        elif offset:
            v += offset
        out[name] = v
        off += n
    return out


def install(model, weights):
    """Copy ``weights`` into ``model``'s parameters; every parameter must
    be named, and nothing else."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(
            'the model and the weights disagree: model only '
            f'{sorted(set(params) - set(weights))[:5]}, weights only '
            f'{sorted(set(weights) - set(params))[:5]}')
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise RuntimeError(f'{name}: {tuple(p.shape)} against '
                                   f'{tuple(weights[name].shape)}')
            p.copy_(weights[name])
