"""A plain PyTorch reference of the Conformer-CTC encoder, for the tests:
float32, no kernel, written from the published description (Gulati et al.
2020, arXiv:2005.08100) and the port's stated departures; it imports
nothing of the port.

``forward(p, cfg, feats, feature_size, stats, gen=None)`` takes the
parameters by the port's names, ``cfg`` (``num_blocks``, ``d_model``,
``num_heads``, ``ffn_dim``, ``conv_kernel``, ``num_classes``,
``dropout``), ``[B, T, 80]`` log-mel features with their frame counts,
the frozen ``(mean, variance)``, and a CPU generator that turns dropout
on.  The attention materialises the ``[B, H, T, 2T - 1]`` position scores
over the offsets in descending order and rel-shifts them by
Transformer-XL's pad-and-reshape; the BatchNorm uses the batch statistics
of the valid frames.
"""

import math

import torch
import torch.nn.functional as F

__all__ = ['forward', 'dropout_bits', 'rel_shift', 'attention',
           'logit_lengths']

_U32 = 0xFFFFFFFF


def dropout_bits(words, counter, B, T, C):
    """``[B, T, C]`` uint32 hash bits (int64) of the seed's two words, the
    site counter, the frame, the channel and the row."""
    s0, s1 = (int(w) & _U32 for w in words)
    const = ((s0 * 0xC2B2AE35) & _U32) ^ ((s1 + 0x27D4EB2F) & _U32) \
        ^ ((counter * 0x5851F42D) & _U32)
    t = torch.arange(T, dtype=torch.int64).view(1, T, 1)
    c = torch.arange(C, dtype=torch.int64).view(1, 1, C)
    b = torch.arange(B, dtype=torch.int64).view(B, 1, 1)
    x = ((t * 0x9E3779B1) & _U32) ^ ((c * 0x85EBCA6B) & _U32) \
        ^ ((b * 0x165667B1) & _U32) ^ const
    for shift in (15, 13, 16):
        x = x ^ (x >> shift)
        x = (x * 0x2545F491) & _U32
    return x ^ (x >> 16)


def _drop(x, seed, counter, rate):
    if seed is None or not rate:
        return x
    B, T, C = x.shape
    thr = min(int((1.0 - rate) * (1 << 32)), _U32)
    keep = (dropout_bits(seed, counter, B, T, C) < thr).to(x.device)
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype))


def rel_shift(x):
    """``[..., T, 2T - 1]`` scores over the offsets ``T - 1 .. -(T - 1)``
    -> ``[..., T, T]`` with ``out[i, j]`` the score of offset ``i - j``."""
    *lead, T, W = x.shape
    padded = torch.cat([x.new_zeros(*lead, T, 1), x], dim=-1)
    padded = padded.view(*lead, W + 1, T)[..., 1:, :].reshape(*lead, T, W)
    return padded[..., :T]


def attention(q, k, v, r, u, vb, lengths):
    """``q``, ``k``, ``v`` ``[B, T, H, D]``, ``r`` ``[2T - 1, H, D]`` over
    the offsets ``T - 1 .. -(T - 1)`` -> ``[B, T, H, D]``; keys at or past
    a row's length masked, those rows' outputs zero."""
    B, T, H, D = q.shape
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # [B, H, T, D]
    ac = (q + u[:, None]) @ k.transpose(-1, -2)
    bd = rel_shift((q + vb[:, None]) @ r.permute(1, 2, 0))
    s = (ac + bd) / math.sqrt(D)
    t = torch.arange(T, device=q.device)
    valid = t[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float('-inf'))
    out = (torch.softmax(s, dim=-1) @ v).transpose(1, 2)
    return torch.where(valid[:, :, None, None], out, 0.0)


def logit_lengths(feature_size, t_in, t_out):
    ratio = torch.tensor(t_in, dtype=torch.float32) \
        / torch.tensor(t_out, dtype=torch.float32)
    return (feature_size.to(torch.float32) / ratio).to(torch.int64)


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + '.weight'],
                        p[name + '.bias'], 1e-5)


def _lin(x, p, name):
    b = p.get(name + '.bias')
    return F.linear(x, p[name + '.weight'], b)


def _positions(T, d, device):
    m = torch.arange(T - 1, -T, -1, dtype=torch.float32, device=device)
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    out = torch.zeros((2 * T - 1, d), device=device)
    out[:, 0::2] = torch.sin(m[:, None] * div)
    out[:, 1::2] = torch.cos(m[:, None] * div)
    return out


def _ffn(p, pre, x, seed, counter, rate):
    h = F.silu(_lin(_ln(x, p, pre + 'norm'), p, pre + 'w1'))
    h = _drop(h, seed, counter, rate)
    return _drop(_lin(h, p, pre + 'w2'), seed, counter + 1, rate)


def _mhsa(p, pre, x, lengths, pos, H, seed, rate):
    B, T, d = x.shape
    h = _ln(x, p, pre + 'norm')
    q, k, v = (_lin(h, p, pre + n).view(B, T, H, d // H) for n in 'qkv')
    r = (pos @ p[pre + 'pos.weight'].T).view(2 * T - 1, H, d // H)
    o = attention(q, k, v, r, p[pre + 'pos_bias_u'], p[pre + 'pos_bias_v'],
                  lengths)
    return _drop(_lin(o.reshape(B, T, d), p, pre + 'out'), seed, 3, rate)


def _conv(p, pre, x, frames, K, seed, rate):
    h = _ln(x, p, pre + 'norm')
    h = F.glu(F.linear(h, p[pre + 'pointwise1.conv.weight'][..., 0],
                       p[pre + 'pointwise1.conv.bias']), dim=-1)
    h = torch.where(frames[..., None], h, 0.0).transpose(1, 2)
    h = F.conv1d(F.pad(h, ((K - 1) // 2, K // 2)),
                 p[pre + 'depthwise.conv.weight'],
                 p[pre + 'depthwise.conv.bias'], groups=h.shape[1])
    m = frames[:, None, :].float()
    n = m.sum()
    mean = (h * m).sum(dim=(0, 2)) / n
    var = ((h - mean[:, None]) ** 2 * m).sum(dim=(0, 2)) / n
    h = (h - mean[:, None]) / torch.sqrt(var + 1e-5)[:, None] \
        * p[pre + 'batch_norm.weight'][:, None] \
        + p[pre + 'batch_norm.bias'][:, None]
    h = F.silu(h).transpose(1, 2)
    h = F.linear(h, p[pre + 'pointwise2.conv.weight'][..., 0],
                 p[pre + 'pointwise2.conv.bias'])
    return _drop(h, seed, 4, rate)


def forward(p, cfg, feats, feature_size, stats, gen=None):
    """``[B, T, 80]`` features -> ``[B, T', num_classes + 1]`` logits."""
    rate = cfg['dropout'] if gen is not None else 0.0
    B, T, _ = feats.shape
    mask = (torch.arange(T)[None, :] < feature_size[:, None])[..., None]
    mean, var = (torch.as_tensor(s, dtype=torch.float32) for s in stats)
    x = torch.where(mask, feats, 0.0)
    x = torch.where(mask, (x - mean) / torch.sqrt(var + 1e-3), 0.0)
    n = cfg['num_blocks']
    seeds = ([torch.randint(0, 2 ** 31 - 1, (2,), generator=gen,
                            dtype=torch.int32).tolist() for _ in range(n + 1)]
             if rate else [None] * (n + 1))
    x = F.relu(F.conv2d(x[:, None], p['subsample.conv1.conv.weight'],
                        p['subsample.conv1.conv.bias'], stride=2))
    x = F.relu(F.conv2d(x, p['subsample.conv2.conv.weight'],
                        p['subsample.conv2.conv.bias'], stride=2))
    _, C, Tp, M = x.shape
    x = _lin(x.permute(0, 2, 1, 3).reshape(B, Tp, C * M), p, 'subsample.out')
    x = _drop(x, seeds[0], 1, rate)
    lengths = logit_lengths(feature_size, T, Tp).clamp(1, Tp)
    frames = torch.arange(Tp)[None, :] < lengths[:, None]
    pos = _positions(Tp, cfg['d_model'], x.device)
    H, K = cfg['num_heads'], cfg['conv_kernel']
    for i in range(n):
        pre, seed = f'blocks.{i}.', seeds[i + 1]
        x = x + 0.5 * _ffn(p, pre + 'ffn1.', x, seed, 1, rate)
        x = x + _mhsa(p, pre + 'mhsa.', x, lengths, pos, H, seed, rate)
        x = x + _conv(p, pre + 'conv_module.', x, frames, K, seed, rate)
        x = x + 0.5 * _ffn(p, pre + 'ffn2.', x, seed, 5, rate)
        x = _ln(x, p, pre + 'norm')
    return _lin(x, p, 'head')
