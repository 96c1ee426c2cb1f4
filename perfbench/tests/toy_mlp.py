"""A toy architecture for the tests: a frame-wise two-layer MLP with a CTC
head, the whole interface of ``perfbench/archs/<model>.py`` in one file.
Its "program" is a small ``nn.Module`` built here, which ``Trainer`` drives
as it drives the port's model; its reference is the same arithmetic in
plain tensor operations.  A configuration names it by handing this module
as its ``model`` and gives ``hidden`` and ``num_classes``."""

import math

import torch
from torch import nn

from perfbench.reference.model import identity, load_stats

NUM_FEATURES = 80
NORM_EPS = 1e-3


def _masked_norm(feats, feature_size, mean, var):
    T = feats.shape[1]
    mask = (torch.arange(T, device=feats.device)[None, :]
            < feature_size[:, None])[..., None]
    x = (feats - mean) / torch.sqrt(var + NORM_EPS)
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


class FramewiseMLP(nn.Module):
    """Normalised log-mel frames -> ReLU(dense) -> dense logits, frame by
    frame: no context, no stride."""

    def __init__(self, hidden, classes):
        super().__init__()
        mean, var = (torch.as_tensor(s, dtype=torch.float32)
                     for s in load_stats())
        self.register_buffer('mean', mean)
        self.register_buffer('var', var)
        self.hidden = nn.Linear(NUM_FEATURES, hidden)
        self.head = nn.Linear(hidden, classes + 1)

    def forward(self, feats, feature_size, generator=None):
        x = _masked_norm(feats, feature_size, self.mean, self.var)
        return self.head(torch.relu(self.hidden(x)))


def build(cfg, mix, device):
    return FramewiseMLP(cfg['hidden'], cfg['num_classes']).to(device)


def param_table(cfg):
    H, K = cfg['hidden'], cfg['num_classes'] + 1
    return [('hidden.weight', (H, NUM_FEATURES), 1 / math.sqrt(NUM_FEATURES),
             0.0),
            ('hidden.bias', (H,), 0.05, 0.0),
            ('head.weight', (K, H), 1 / math.sqrt(H), 0.0),
            ('head.bias', (K,), 0.05, 0.0)]


def forward(p, cfg, feats, feature_size, stats, gen=None, rnd=identity,
            lstm_rate=0.0):
    mean, var = (torch.as_tensor(s, dtype=feats.dtype, device=feats.device)
                 for s in stats)
    x = rnd(_masked_norm(rnd(feats), feature_size, mean, var))
    h = rnd(torch.clamp(x @ rnd(p['hidden.weight']).T + p['hidden.bias'],
                        min=0.0))
    return h @ rnd(p['head.weight']).T + p['head.bias']


def regularised(name):
    return False


def algorithmic_flops(cfg, batch, frames, train=True):
    H, K = cfg['hidden'], cfg['num_classes'] + 1
    fwd = 2.0 * batch * frames * (NUM_FEATURES * H + H * K)
    return fwd * (3.0 if train else 1.0)


def output_stride(cfg):
    return 1


def halo(cfg):
    return 0, 0
