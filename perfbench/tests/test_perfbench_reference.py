"""The reference against a plain float64 recomputation in numpy at a tiny
width (forward, CTC loss), its gradients against finite differences, its
dropout hash against the program's, and the control: the reference in
the precision below the configuration's reads above the limits."""

import json
import math

import numpy as np
import pytest
import torch

from conftest import ROOT, overrides
from perfbench import calibrate
from perfbench.archs import nas_bench_asr as nas
from perfbench.reference import frontend as fe
from perfbench.reference import model as ref

CFG = dict(arch_vec=[[0, 1], [2, 1, 0], [4, 0, 1, 1]], block_kernels=[8, 8],
           block_strides=[1, 2], block_filters=[8, 8], cells_per_block=[1, 1],
           cell_groups=4, rnn_units=3, num_classes=48, dropout=0.2)


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, std, off in nas.param_table(CFG):
        v = torch.randn(shape, generator=g, dtype=torch.float64) * std
        if off == 'forget':
            v[shape[0] // 4:shape[0] // 2] += 1
        elif off:
            v += off
        out[name] = v
    return out


def _np_log_mel(audio):
    n = (audio.shape[-1] - fe.WINDOW) // fe.HOP + 1
    frames = np.stack([audio[:, i * fe.HOP:i * fe.HOP + fe.WINDOW]
                       for i in range(n)], axis=1)
    hann = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(fe.WINDOW) / fe.WINDOW)
            ).astype(np.float32)
    power = np.abs(np.fft.rfft(frames * hann, axis=-1)) ** 2
    return np.log(power @ fe._mel_matrix().astype(np.float64) + 1e-10)


def _np_conv(x, w, lp, rp, d=1, s=1, groups=1):
    """x [B, T, ci_all], w [co, ci, K] (grouped: ci per group)."""
    B, T, _ = x.shape
    co, ci, K = w.shape
    xp = np.pad(x, ((0, 0), (lp, rp), (0, 0)))
    t_out = (xp.shape[1] - (K - 1) * d - 1) // s + 1
    y = np.zeros((B, t_out, co))
    per = co // groups
    for t in range(t_out):
        for k in range(K):
            xs = xp[:, t * s + k * d]
            for g in range(groups):
                y[:, t, g * per:(g + 1) * per] += \
                    xs[:, g * ci:(g + 1) * ci] @ w[g * per:(g + 1) * per, :, k].T
    return y


def _np_ln(x, scale, bias):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + 1e-3) * scale + bias


def _np_forward(p, audio, fsize):
    p = {k: v.numpy() for k, v in p.items()}
    x = _np_log_mel(audio)
    mask = (np.arange(x.shape[1])[None, :] < fsize[:, None])[..., None]
    mean, var = (s.astype(np.float64) for s in ref.load_stats())
    x = np.where(mask, (np.where(mask, x, 0) - mean) / np.sqrt(var + 1e-3), 0)
    nodes = nas.arch_nodes(CFG['arch_vec'])
    for i, (K, s) in enumerate(zip(CFG['block_kernels'], CFG['block_strides'])):
        lp, rp = nas.conv_padding(K, 1, s)
        x = np.clip(_np_conv(x, p[f'block{i}_conv.conv.weight'], lp, rp, s=s)
                    + p[f'block{i}_conv.conv.bias'], 0, 20)
        x = _np_ln(x, p[f'block{i}_norm.scale'], p[f'block{i}_norm.bias'])
        pre = f'block{i}_cell0.'
        outs = [x]
        for k, (op, branches) in enumerate(nodes):
            src = outs[-1]
            if op == 'linear':
                acc = src @ p[f'{pre}node{k}_linear.dense.kernel'] \
                    + p[f'{pre}node{k}_linear.dense.bias']
            else:
                Kc, d = nas.CONVS[op]
                w = p[f'{pre}node{k}_{op}.conv_kernel_grouped']  # [K, ci, C]
                l2, r2 = nas.conv_padding(Kc, d, 1)
                acc = _np_conv(src, w.transpose(2, 1, 0), l2, r2, d=d,
                               groups=CFG['cell_groups']) \
                    + p[f'{pre}node{k}_{op}.conv_bias']
            total = np.clip(acc, 0, 20)
            for j in branches:
                total = total + outs[j]
            outs.append(total)
        x = _np_ln(outs[-1], p[f'{pre}norm.scale'], p[f'{pre}norm.bias'])
    H = CFG['rnn_units']
    sig = lambda v: 1 / (1 + np.exp(-v))
    xw = x @ p['lstm.kernel'] + p['lstm.bias']
    c = h = np.zeros((x.shape[0], H))
    hs = []
    for t in range(x.shape[1]):
        z = xw[:, t] + h @ p['lstm.recurrent']
        i, f, g, o = (z[:, q * H:(q + 1) * H] for q in range(4))
        c = sig(f) * c + sig(i) * np.tanh(g)
        h = sig(o) * np.tanh(c)
        hs.append(h)
    return np.stack(hs, 1) @ p['head.kernel'] + p['head.bias']


def _np_ctc(logp, labels):
    """-log p(labels | frames) by the alpha recursion."""
    ext = [0]
    for l in labels:
        ext += [int(l), 0]
    S, T = len(ext), logp.shape[0]
    alpha = np.full(S, -np.inf)
    alpha[0], alpha[1] = logp[0, 0], logp[0, ext[1]]
    for t in range(1, T):
        new = np.full(S, -np.inf)
        for s in range(S):
            terms = [alpha[s]] + ([alpha[s - 1]] if s else [])
            if s >= 2 and ext[s] != 0 and ext[s] != ext[s - 2]:
                terms.append(alpha[s - 2])
            new[s] = np.logaddexp.reduce(terms) + logp[t, ext[s]]
        alpha = new
    return -np.logaddexp(alpha[-1], alpha[-2])


def _batch():
    r = np.random.default_rng(3)
    audio = (r.standard_normal((2, 400 + 63 * 160)) * 0.1).astype(np.float64)
    fsize = np.array([64, 41])
    audio[1, 400 + 40 * 160:] = 0
    labels = np.array([[3, 3, 7, 1, 9], [4, 2, 0, 0, 0]])
    return {'audio': torch.as_tensor(audio), 'feature_size':
            torch.as_tensor(fsize), 'labels': torch.as_tensor(labels),
            'label_size': torch.tensor([5, 2]), 'valid': torch.ones(2)}


def test_forward_and_loss_against_float64_numpy():
    p, b = _params(), _batch()
    feats = fe.log_mel(b['audio'])
    got = nas.forward(p, CFG, feats, b['feature_size'],
                      ref.load_stats()).numpy()
    want = _np_forward(p, b['audio'].numpy(), b['feature_size'].numpy())
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    _, ctc, _, _ = ref.train_objective(nas, p, CFG, b, ref.load_stats(),
                                   None)
    llen = b['feature_size'].numpy() // 2
    lp = torch.log_softmax(torch.as_tensor(want), -1).numpy()
    nll = [_np_ctc(lp[i, :llen[i]], b['labels'][i, :b['label_size'][i]])
           for i in range(2)]
    want_ctc = np.mean([n / (l + 1) for n, l in zip(nll, llen)])
    assert float(ctc) == pytest.approx(want_ctc, rel=1e-9)


def test_gradients_against_finite_differences():
    p, b = _params(1), _batch()
    stats = ref.load_stats()
    for v in p.values():
        v.requires_grad_(True)
    loss = ref.train_objective(nas, p, CFG, b, stats, None)[0]
    names = ['block0_cell0.node1_conv5d2.conv_kernel_grouped', 'lstm.recurrent',
             'block1_norm.scale', 'head.bias']
    grads = torch.autograd.grad(loss, [p[n] for n in names])
    eps = 1e-6
    with torch.no_grad():
        for n, g in zip(names, grads):
            idx = tuple(0 for _ in p[n].shape)
            p[n][idx] += eps
            up = float(ref.train_objective(nas, p, CFG, b, stats, None)[0])
            p[n][idx] -= 2 * eps
            down = float(ref.train_objective(nas, p, CFG, b, stats, None)[0])
            p[n][idx] += eps
            assert float(g[idx]) == pytest.approx((up - down) / (2 * eps),
                                                  rel=1e-5, abs=1e-9), n


def test_dropout_hash_is_the_recipes():
    from nbasr_torch.ops.fused_cell import dropout_bits
    for words in ([0, 0], [2 ** 31 - 2, 12345], [987654, 2 ** 30]):
        seed = torch.tensor(words, dtype=torch.int32)
        for counter in (1, 3):
            assert torch.equal(nas.dropout_bits(words, counter, 3, 5, 7, 'cpu'),
                               dropout_bits(seed, counter, 3, 5, 7))


@pytest.mark.parametrize('cell,kind', [('flagship.train', 'train'),
                                       ('flagship.serve', 'serve'),
                                       ('linear-dilated.serve', 'serve')])
def test_control_reads_above_the_limits(cell, kind):
    """The reference in the precision below the configuration's, in the
    program's place, at a reduced width: some number reads above the
    cell's limit."""
    limits = json.loads((ROOT / 'perfbench' / 'limits' /
                         f'{cell}.json').read_text())
    got = calibrate.readings(cell, 2 ** 31 + 3, torch.device('cpu'),
                             'control', overrides(kind))
    assert any(got[k] > v for k, v in limits.items()), got
