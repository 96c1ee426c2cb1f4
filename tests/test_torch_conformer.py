"""The Conformer-CTC encoder of the port (nbasr_torch.models.conformer) on
the CPU at a reduced width, against the plain reference of
tests/conformer_reference.py: the plain relative-position attention
against the materialised rel-shift formula, the hash dropout's masks bit
for bit, the model's logits, loss and every leaf's gradient with dropout
on, two Trainer steps, and Conformer (L)'s parameter count."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import conformer_reference as ref
from nbasr_torch.models.conformer import (ConformerBlock, Subsampling,
                                          get_conformer, relative_positions,
                                          subsampled_length)
from nbasr_torch.ops import hash_dropout, relpos_attention as ra
from nbasr_torch.training import Trainer
from nbasr_torch.training.loss import conv_l2, get_loss

CFG = dict(num_blocks=2, d_model=64, num_heads=4, ffn_dim=128, conv_kernel=8,
           num_classes=48, dropout=0.1)
STATS = (np.linspace(-0.2, 0.2, 80).astype(np.float32),
         np.linspace(0.5, 1.5, 80).astype(np.float32))
FRAMES, SIZES = 61, [61, 40, 20]
NAMES = ('q', 'k', 'v', 'r', 'pos_bias_u', 'pos_bias_v')
ZERO_GRADIENT = ('mhsa.k.bias', 'depthwise.conv.bias')


def _model(dropout=0.1):
    return get_conformer(
        num_classes=CFG['num_classes'], num_blocks=CFG['num_blocks'],
        d_model=CFG['d_model'], num_heads=CFG['num_heads'],
        ffn_dim=CFG['ffn_dim'], conv_kernel=CFG['conv_kernel'],
        dropout_rate=dropout, data_norm=STATS, device='cpu',
        generator=torch.Generator().manual_seed(1))


def _randomise(model, seed=2):
    """Every parameter drawn at random (biases, norms and the position
    biases too), so that no gradient path is trivial."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 1 / math.sqrt(p[0].numel()) if p.dim() > 1 else 0.1
            p.copy_(torch.randn(p.shape, generator=g) * scale
                    + (1.0 if name.endswith('norm.weight') else 0.0))
    return model


@pytest.mark.parametrize('T', [7, 8])
def test_plain_attention_matches_the_rel_shift_formula(T):
    """Values and all six gradients of the port's plain version against
    Transformer-XL's pad-and-reshape rel-shift over descending offsets,
    with a full row, padded rows and a row of length 1."""
    g = torch.Generator().manual_seed(T)
    B, H, D = 3, 2, 8
    leaves = [torch.randn(s, generator=g, dtype=torch.float64)
              for s in [(B, T, H, D)] * 3 + [(2 * T - 1, H, D), (H, D),
                                               (H, D)]]
    lengths = torch.tensor([T, T // 2 + 1, 1])
    dout = torch.randn(B, T, H, D, generator=g, dtype=torch.float64)
    x = [t.clone().requires_grad_(True) for t in leaves]
    y = [t.clone().requires_grad_(True) for t in leaves]
    got = ra.relpos_attention(*x, lengths)
    want = ref.attention(y[0], y[1], y[2], y[3].flip(0), y[4], y[5], lengths)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for name, a, b in zip(NAMES, torch.autograd.grad(got, x, dout),
                          torch.autograd.grad(want, y, dout)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)
    assert (got[1, T // 2 + 1:] == 0).all() and (got[2, 1:] == 0).all()


def _emulate_kernels(q, k, v, r, u, vb, lengths, dout):
    """The three CUDA kernels' tile loops (csrc/relpos_attention.cu) in
    float64: 64-row tiles, the band of r staged from row i0 - j0 - 63, the
    position score read at band column a - b + 63, the online softmax, dS
    gathered back into the band, and dr's band added a tile pair with its
    high half carried to the next query tile.  Returns (out, grads)."""
    n = ra.BLOCK
    B, T, H, D = q.shape
    M = 2 * T - 1
    scale = 1 / math.sqrt(D)
    a_ = torch.arange(n)
    cols = a_[:, None] - a_[None, :] + n - 1          # band column of (a, b)
    key_of = a_[:, None] + n - 1 - torch.arange(2 * n)[None, :]  # dBand[a][c]

    def rows(x, lo, count, hi):
        idx = torch.arange(lo, lo + count)
        ok = (idx >= 0) & (idx < hi)
        out = torch.zeros(count, *x.shape[1:], dtype=x.dtype)
        out[ok] = x[idx[ok]]
        return out

    def gather_keys(ds):                              # dBand[a][c]
        ok = (key_of >= 0) & (key_of < n)
        return torch.where(ok, ds.gather(1, key_of.clamp(0, n - 1)), 0.0)

    out = torch.zeros_like(q)
    lse = torch.zeros(B, H, T, dtype=q.dtype)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    dr = torch.zeros(H, M, D, dtype=q.dtype)
    du, dvb = torch.zeros(H, D, dtype=q.dtype), torch.zeros(H, D,
                                                            dtype=q.dtype)
    tiles = range(0, T, n)
    for b in range(B):
        L = int(lengths[b])
        for h in range(H):
            qb = rows(q[b, :, h], 0, T, L)
            qu_all, qv_all = qb + u[h], qb + vb[h]
            qu_all[L:] = qv_all[L:] = 0
            kb, vbv = rows(k[b, :, h], 0, T, L), rows(v[b, :, h], 0, T, L)
            dob = rows(dout[b, :, h], 0, T, L)

            def score(i0, j0):
                qu, qv = rows(qu_all, i0, n, T), rows(qv_all, i0, n, T)
                kt = rows(kb, j0, n, T)
                band = rows(r[:, h], i0 - j0 - (n - 1) + T - 1, 2 * n, M)
                s = (qu @ kt.T + (qv @ band.T).gather(1, cols)) * scale
                keys = (j0 + a_) < L
                return s.masked_fill(~keys[None, :], float('-inf')), band

            for i0 in tiles:                           # forward, then dq
                m = torch.full((n,), float('-inf'), dtype=q.dtype)
                l = torch.zeros(n, dtype=q.dtype)
                o = torch.zeros(n, D, dtype=q.dtype)
                for j0 in (range(0, L, n) if i0 < L else []):
                    s, _ = score(i0, j0)
                    mx = torch.maximum(m, s.max(1).values)
                    p = torch.exp(s - mx[:, None])
                    alpha = torch.exp(m - mx)
                    l = l * alpha + p.sum(1)
                    o = o * alpha[:, None] + p @ rows(vbv, j0, n, T)
                    m = mx
                ok = (i0 + a_) < L
                o = torch.where(ok[:, None], o / torch.where(ok, l, 1.0)[:,
                                                                        None],
                                0.0)
                lt = torch.where(ok, m + torch.log(torch.where(ok, l, 1.0)),
                                 0.0)
                keep = (i0 + a_) < T
                out[b, i0:i0 + n, h] = o[keep]
                lse[b, h, i0:i0 + n] = lt[keep]
            delta = (dob * out[b, :, h]).sum(1)
            for i0 in tiles:
                dqc = torch.zeros(n, D, dtype=q.dtype)
                dqp = torch.zeros(n, D, dtype=q.dtype)
                ok = (i0 + a_) < L
                for j0 in (range(0, L, n) if i0 < L else []):
                    s, band = score(i0, j0)
                    p = torch.where(ok[:, None], torch.exp(
                        s - rows(lse[b, h], i0, n, T)[:, None]), 0.0)
                    dp = rows(dob, i0, n, T) @ rows(vbv, j0, n, T).T
                    ds = p * (dp - rows(delta, i0, n, T)[:, None])
                    dqc += ds @ rows(kb, j0, n, T)
                    dqp += gather_keys(ds) @ band
                keep = (i0 + a_) < T
                dq[b, i0:i0 + n, h] = ((dqc + dqp) * scale)[keep]
                du[h] += dqc.sum(0) * scale
                dvb[h] += dqp.sum(0) * scale
            for j0 in tiles:                           # dk, dv, dr
                dkt = torch.zeros(n, D, dtype=q.dtype)
                dvt = torch.zeros(n, D, dtype=q.dtype)
                carry = torch.zeros(n, D, dtype=q.dtype)
                base = None
                for i0 in (range(0, L, n) if j0 < L else []):
                    s, band = score(i0, j0)
                    base = i0 - j0 - (n - 1) + T - 1
                    ok = (i0 + a_) < L
                    p = torch.where(ok[:, None], torch.exp(
                        s - rows(lse[b, h], i0, n, T)[:, None]), 0.0)
                    dvt += p.T @ rows(dob, i0, n, T)
                    dp = rows(dob, i0, n, T) @ rows(vbv, j0, n, T).T
                    ds = p * (dp - rows(delta, i0, n, T)[:, None])
                    dkt += ds.T @ rows(qu_all, i0, n, T)
                    dband_t = gather_keys(ds).T       # [128, 64]
                    qv = rows(qv_all, i0, n, T)
                    lo = dband_t[:n] @ qv + carry
                    for c in range(n):
                        if 0 <= base + c < M:
                            dr[h, base + c] += lo[c] * scale
                    carry = dband_t[n:] @ qv
                if base is not None:
                    for c in range(n):
                        if 0 <= base + n + c < M:
                            dr[h, base + n + c] += carry[c] * scale
                keep = (j0 + a_) < T
                dk[b, j0:j0 + n, h] = (dkt * scale)[keep]
                dv[b, j0:j0 + n, h] = dvt[keep]
    return out, (dq, dk, dv, dr.permute(1, 0, 2), du, dvb)


@pytest.mark.parametrize('T', [1, 64, 130])
def test_kernel_tile_loops_match_the_plain_version(T):
    """The kernels' tiling, band offsets, rel-shift reads and dr carry
    (emulated in float64) against the plain version: values and all six
    gradients, with a full row, a padded row and a row of length 1."""
    g = torch.Generator().manual_seed(T)
    B, H, D = 3, 1, 4
    leaves = [torch.randn(s, generator=g, dtype=torch.float64)
              for s in [(B, T, H, D)] * 3 + [(2 * T - 1, H, D), (H, D),
                                               (H, D)]]
    lengths = torch.tensor([T, max(T - 67, 1), 1])
    dout = torch.randn(B, T, H, D, generator=g, dtype=torch.float64)
    x = [t.clone().requires_grad_(True) for t in leaves]
    want = ra.relpos_attention(*x, lengths)
    got, grads = _emulate_kernels(*leaves, lengths, dout)
    torch.testing.assert_close(got, want.detach(), rtol=1e-10, atol=1e-12)
    for name, a, b in zip(NAMES, grads, torch.autograd.grad(want, x, dout)):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-11, msg=name)


@pytest.mark.parametrize('shape,counter', [((2, 5, 7), 1), ((3, 4, 16), 6)])
def test_hash_dropout_masks_are_the_references(shape, counter):
    x = torch.randn(shape).requires_grad_(True)
    words = (123456789, 2 ** 31 - 2)
    y = hash_dropout.hash_dropout(x, words, counter, 0.1)
    want = ref._drop(x.detach(), words, counter, 0.1)
    assert torch.equal(y.detach(), want)
    (gx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert torch.equal(gx, (want != 0).float() * gx.max())


@pytest.fixture(scope='module')
def pair():
    """The port's model and the reference, from the same random weights,
    in training mode with dropout on: their logits, losses (normalised CTC
    plus the conv L2) and gradients of every leaf."""
    torch.manual_seed(0)
    model = _randomise(_model()).train()
    feats = torch.randn(len(SIZES), FRAMES, 80)
    fsize = torch.tensor(SIZES)
    labels = torch.randint(1, 49, (len(SIZES), 5), dtype=torch.int32)
    lsize = torch.tensor([5, 4, 3], dtype=torch.int32)
    logits = model(feats, fsize, generator=torch.Generator().manual_seed(9))
    llen = ref.logit_lengths(fsize, FRAMES, logits.shape[1]).to(torch.int32)
    loss = get_loss()(logits, llen, labels, lsize) + conv_l2(model)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    p = {n: t.detach().clone().requires_grad_(True)
         for n, t in model.named_parameters()}
    r_logits = ref.forward(p, CFG, feats, fsize, STATS,
                           gen=torch.Generator().manual_seed(9))
    lp = torch.log_softmax(r_logits, dim=-1).transpose(0, 1)
    nll = F.ctc_loss(lp, labels.long(), llen.long(), lsize.long(), blank=0,
                     reduction='none', zero_infinity=True)
    r_loss = (nll / (llen + 1)).mean() + 0.01 * sum(
        v.square().sum() for k, v in p.items() if k.endswith('.conv.weight'))
    r_grads = torch.autograd.grad(r_loss, list(p.values()))
    names = [n for n, _ in model.named_parameters()]
    return dict(logits=(logits, r_logits, llen), loss=(loss, r_loss),
                grads=(dict(zip(names, grads)), dict(zip(names, r_grads))))


@pytest.mark.parametrize('what', ['logits', 'loss', 'grads'])
def test_model_matches_the_reference(pair, what):
    if what == 'logits':
        got, want, llen = pair['logits']
        valid = (torch.arange(got.shape[1])[None, :]
                 < llen[:, None])[..., None]
        assert got.shape == want.shape == (3, subsampled_length(FRAMES), 49)
        torch.testing.assert_close(torch.where(valid, got, 0.0),
                                   torch.where(valid, want, 0.0),
                                   rtol=1e-4, atol=1e-5)
    elif what == 'loss':
        got, want = pair['loss']
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        got, want = pair['grads']
        assert got.keys() == want.keys() and len(got) == 82
        # k's bias adds a constant to a row's scores, which the softmax
        # takes away, and the depthwise bias a constant to a channel, which
        # the BatchNorm takes away: their gradients are rounding alone
        top = max(float(g.abs().max()) for g in want.values())
        for name in got:
            if name.endswith(ZERO_GRADIENT):
                assert max(float(got[name].abs().max()),
                           float(want[name].abs().max())) < 1e-6 * top, name
                continue
            scale = float(want[name].abs().max())
            assert scale > 1e-3 * top, name
            torch.testing.assert_close(got[name], want[name], rtol=1e-3,
                                       atol=1e-4 * scale, msg=name)


def test_two_trainer_steps():
    """Two ``Trainer.step`` calls on the model: finite losses, every
    parameter moved, the BatchNorm's running statistics updated, the
    dropout generator advanced by the model's seeds alone."""
    model = _randomise(_model())
    g = torch.Generator().manual_seed(0)
    batch = {'audio': (torch.randn(3, 400 + 99 * 160, generator=g)
                       * 0.1).numpy(),
             'feature_size': np.array([100, 80, 50], np.int32),
             'labels': np.array([[3, 4, 5], [6, 7, 0], [8, 0, 0]], np.int32),
             'label_size': np.array([3, 2, 1], np.int32),
             'valid': np.ones(3, np.float32)}
    tr = Trainer((None, None, None, None), device='cpu', verbose=False,
                 tensorboard=False)
    tr.init_state(model, seed=4)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    bn = model.blocks[0].conv_module.batch_norm.running_mean.clone()
    state = tr.generator.get_state()
    losses = [tr.step(batch)['ctc_loss'] for _ in range(2)]
    assert all(math.isfinite(v) for v in losses) and tr.nonfinite_steps == 0
    assert all(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    assert not torch.equal(bn, model.blocks[0].conv_module.batch_norm
                           .running_mean)
    g = torch.Generator()
    g.set_state(state)
    for _ in range(2 * (1 + CFG['num_blocks'])):
        torch.randint(0, 2 ** 31 - 1, (2,), generator=g, dtype=torch.int32)
    assert torch.equal(g.get_state(), tr.generator.get_state())


def test_conformer_l_has_its_published_parameter_count():
    """Table 1's Conformer (L) with the 49-way CTC head: the encoder the
    paper counts at 118.8 M with its RNN-T decoder has 114,883,121 here."""
    count = lambda m: sum(p.numel() for p in m.parameters())   # noqa: E731
    block = ConformerBlock(512, 8, 2048, 32, 0.1, torch.float32)
    head = 512 * 49 + 49
    assert count(Subsampling(512, 0.1)) + 17 * count(block) + head \
        == 114_883_121
    pos = relative_positions(4, 512, 'cpu')
    assert pos.shape == (7, 512) and torch.equal(pos[3, 0::2],
                                                 torch.zeros(256))
