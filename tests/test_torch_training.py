"""The port's training slice against the JAX package on the CPU: relu20's
gradient, the CTC loss, conv L2, edit distance and greedy eval, the input
pipeline, FLOP counting, and one whole Trainer step (loss and every
gradient, then the parameters after 3 steps) and its eval with either
decoder and the beam-search transcripts, with the JAX cells in the fused
Pallas kernel in interpret mode; plus the port's own Trainer contracts
(TensorBoard scalars among them) and the ``train.py`` twin end to end."""

import itertools
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import nbasr_tpu.ops.fused_cell as jax_fused_cell
from nbasr_tpu.data import get_dataloaders as jax_get_dataloaders
from nbasr_tpu.models.asr import algorithmic_flops as jax_flops
from nbasr_tpu.models.asr import get_model as jax_get_model
from nbasr_tpu.models.asr import logits_length as jax_logits_length
from nbasr_tpu.ops.ctc import normalized_ctc_loss as jax_ctc
from nbasr_tpu.ops.decode import greedy_decode as jax_greedy
from nbasr_tpu.ops.edit_distance import edit_distance as jax_edit_distance
from nbasr_tpu.ops.edit_distance import error_rate as jax_error_rate
from nbasr_tpu.training import conv_l2 as jax_conv_l2
from nbasr_tpu.training import get_loss as jax_get_loss
from nbasr_tpu.training import get_trainer as jax_get_trainer

from nbasr_torch.convert import from_flax
from nbasr_torch.data.pipeline import get_dataloaders
from nbasr_torch.models.asr import algorithmic_flops, get_model
from nbasr_torch.models.layers import relu20
from nbasr_torch.ops import fused_cell
from nbasr_torch.ops.ctc import normalized_ctc_loss
from nbasr_torch.ops.decode import greedy_decode
from nbasr_torch.ops.edit_distance import edit_distance, error_rate
from nbasr_torch.training import Trainer, conv_l2, get_loss, lr_at_epoch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
# small widths: filters 24/32, 4 groups, one cell per block, LSTM 16
KW = dict(block_kernels=(4, 4), block_strides=(1, 2), block_filters=(24, 32),
          cells_per_block=(1, 1), cell_groups=4, rnn_units=16,
          init_scheme='scaled')
LR = 1e-3
# a whole step in f32 on both sides, sums in another order through the
# frontend, two block convs, two cells, the LSTM and the CTC recursion:
# each gradient within 1e-4 of its own max|jax|
STEP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision('highest'):
        yield


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_relu20_gradient_at_the_ends(dtype):
    v = np.array([-1.0, 0.0, 3.0, 20.0, 25.0], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 20.0)))(jnp.asarray(v))
    x = torch.tensor(v, dtype=dtype, requires_grad=True)
    relu20(x).sum().backward()
    np.testing.assert_array_equal(x.grad.float().numpy(), np.asarray(want))
    np.testing.assert_array_equal(want, [0.0, 0.5, 1.0, 0.5, 0.0])


def test_normalized_ctc_matches_jax():
    """Value and gradient, with padded frames and an impossible row (five
    labels in three frames).  That row's loss is 0 on both sides and its
    gradient 0 in the port, as ``zero_infinity`` says; the JAX custom VJP
    gives NaN on its valid frames (``jnp.where`` over a ~1e30 loss), so a
    JAX train step with such a row is skipped whole by apply_if_finite,
    where the port trains on the other rows."""
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 12, 7).astype(np.float32)
    logit_len = np.array([12, 9, 3, 7], np.int32)
    labels = np.array([[1, 2, 2, 0, 0], [3, 0, 0, 0, 0], [1, 2, 3, 4, 5],
                       [6, 6, 1, 0, 0]], np.int32)
    label_len = np.array([3, 1, 5, 3], np.int32)
    weights = rng.rand(4).astype(np.float32)

    def jloss(lg):
        return jnp.sum(jax_ctc(lg, jnp.asarray(logit_len), jnp.asarray(labels),
                               jnp.asarray(label_len)) * weights)

    want = jax_ctc(jnp.asarray(logits), jnp.asarray(logit_len),
                   jnp.asarray(labels), jnp.asarray(label_len))
    want_grad = jax.grad(jloss)(jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    got = normalized_ctc_loss(lt, torch.from_numpy(logit_len),
                              torch.from_numpy(labels),
                              torch.from_numpy(label_len))
    (got * torch.from_numpy(weights)).sum().backward()
    assert float(got[2].detach()) == float(want[2]) == 0.0
    _close(got.detach(), want, 1e-5)
    possible = [0, 1, 3]
    _close(lt.grad[possible], np.asarray(want_grad)[possible], 1e-5)
    assert np.isnan(np.asarray(want_grad)[2, :3]).all()
    assert not lt.grad[2].any() and not lt.grad[1, 9:].any()


def test_conv_l2_matches_jax():
    jmodel = jax_get_model(ARCH, use_rnn=True, **KW)
    v = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)))
    model = get_model(ARCH, use_rnn=True, device='cpu', **KW)
    model.load_state_dict(from_flax(v))
    want = float(jax_conv_l2(v['params']))
    assert want > 0
    assert float(conv_l2(model).detach()) == pytest.approx(want, rel=1e-6)
    assert float(conv_l2({'head.kernel': torch.ones(4, 4)})) == 0.0


def test_edit_distance_and_greedy_eval_match_jax():
    """Greedy decode, then WER on p48 ids and LER on the p39 fold, as the
    eval step computes them, on the same random logits."""
    from nbasr_torch.data.phonemes import PhonemeEncoder
    rng = np.random.RandomState(1)
    logits = rng.randn(5, 30, 49).astype(np.float32) * 3
    lsize = np.array([30, 25, 9, 1, 17], np.int32)
    labels = rng.randint(1, 49, size=(5, 12)).astype(np.int32)
    label_size = np.array([12, 7, 3, 1, 10], np.int32)
    labels[np.arange(12)[None, :] >= label_size[:, None]] = 0
    fold = PhonemeEncoder(48).fold_table(39)
    jhyp, jlen = jax_greedy(jnp.asarray(logits), jnp.asarray(lsize))
    hyp, hlen = greedy_decode(torch.from_numpy(logits), torch.from_numpy(lsize))
    np.testing.assert_array_equal(hyp.numpy(), np.asarray(jhyp))
    np.testing.assert_array_equal(hlen.numpy(), np.asarray(jlen))
    for table in (np.arange(49), fold):
        want = jax_edit_distance(table[np.asarray(jhyp)], jlen, table[labels],
                                 label_size)
        got = edit_distance(torch.from_numpy(table[hyp.numpy()]), hlen,
                            torch.from_numpy(table[labels]),
                            torch.from_numpy(label_size))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax_error_rate(jhyp, jlen, labels, label_size)
    got = error_rate(hyp, hlen, torch.from_numpy(labels),
                     torch.from_numpy(label_size))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_loaders_give_the_jax_packages_batches():
    want = jax_get_dataloaders('synthetic:12', batch_size=4)
    got = get_dataloaders('synthetic:12', batch_size=4)
    assert got[1].steps == want[1].steps
    assert len(list(got[2])) == len(list(want[2]))
    for split in (1, 2):       # the curriculum stream, then the val split
        for bw, bg in itertools.islice(zip(want[split], got[split]), 5):
            assert bw.keys() == bg.keys()
            for k in bw:
                np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)


def test_algorithmic_flops_match_jax():
    for use_rnn in (False, True):
        jmodel = jax_get_model([[0, 1], [2, 1, 0], [4, 0, 1, 1]],
                               use_rnn=use_rnn)
        model = get_model([[0, 1], [2, 1, 0], [4, 0, 1, 1]], use_rnn=use_rnn,
                          device='cpu')
        for train in (False, True):
            assert algorithmic_flops(model, 32, 300, train) == \
                jax_flops(jmodel, 32, 300, train)


def test_lr_schedule_reference_rule():
    assert lr_at_epoch(1e-4, 5) == 1e-4
    assert lr_at_epoch(1e-4, 7) == pytest.approx(8.1e-5)


# ---------------------------------------------------------------------------
# one Trainer step against the JAX Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """JAX trainer (fused cells in interpret mode) and the port's trainer
    from the same init, dropout 0, plus one batch and the JAX step's loss
    and gradients."""
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision('highest'):
        mp.setattr(jax_fused_cell, 'INTERPRET', True)
        jloaders = jax_get_dataloaders('synthetic:12', batch_size=4,
                                       curriculum=())
        jmodel = jax_get_model(ARCH, use_rnn=True, dropout_rate=0.0,
                               cell_dropout=0.0, data_norm=True,
                               grouped_impl='fused', **KW)
        jtr = jax_get_trainer(jloaders, jax_get_loss(), verbose=False,
                              eval_decoder='greedy')
        jtr.init_state(jmodel, seed=0)
        # numpy copies: the JAX train step donates its state
        init = jax.tree_util.tree_map(
            np.asarray, {'params': jtr.state.params, 'stats': jtr._stats})
        batch = next(iter(jloaders[1]))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(params):
            feats, fsize = jtr._features(jb)
            logits = jmodel.apply(jtr._variables(params), feats, fsize,
                                  train=True)
            lsize = jax_logits_length(fsize, feats.shape[1], logits.shape[1])
            ctc = jtr.loss(logits, lsize, jb['labels'], jb['label_size'],
                           valid=jb['valid'])
            return ctc + jax_conv_l2(params), ctc

        (_, ctc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jtr.state.params)
        j_eval = {'greedy': jtr.evaluate(jloaders[2])}
        jtr.eval_decoder = 'beam'
        jtr._build_steps()
        j_eval['beam'], j_transcripts = jtr.evaluate(jloaders[2],
                                                     return_transcripts=3)
        for _ in range(3):
            jtr.step(batch, training=True, lr=LR)
        after = jax.tree_util.tree_map(np.asarray, jtr.state.params)

    loaders = get_dataloaders('synthetic:12', batch_size=4, curriculum=())
    model = get_model(ARCH, use_rnn=True, dropout_rate=0.0, cell_dropout=0.0,
                      data_norm=True, device='cpu', **KW)
    model.load_state_dict(from_flax(init))
    trainer = Trainer(loaders, get_loss(), device='cpu', verbose=False)
    trainer.init_state(model, seed=0)
    return dict(trainer=trainer, loaders=loaders, batch=batch,
                ctc=float(ctc), grads=from_flax({'params': grads}),
                init=from_flax(init), after=from_flax({'params': after}),
                eval=j_eval, transcripts=j_transcripts)


def test_train_step_loss_and_gradients_match_jax(pair):
    grads, m = pair['trainer'].gradients(pair['batch'])
    assert m['ctc_loss'] == pytest.approx(pair['ctc'], rel=1e-5)
    assert grads.keys() == pair['grads'].keys()
    for name, want in pair['grads'].items():
        _close(grads[name], want.numpy(), STEP_TOL)


@pytest.mark.parametrize('decoder', ['greedy', 'beam'])
def test_eval_matches_jax(pair, decoder):
    """Loss, WER (p48) and LER (p39 fold) of an eval pass from the same
    weights, with each decoder (beam search: W=12, the default)."""
    trainer = pair['trainer']
    trainer.model.load_state_dict(pair['init'])
    trainer.eval_decoder = decoder
    try:
        got = trainer.evaluate(pair['loaders'][2])
    finally:
        trainer.eval_decoder = 'beam'
    want = pair['eval'][decoder]
    assert got.keys() == want.keys() == {'ctc_loss', 'wer', 'ler'}
    assert got['ctc_loss'] == pytest.approx(want['ctc_loss'], rel=1e-5)
    assert got['wer'] == pytest.approx(want['wer'], abs=1e-6)
    assert got['ler'] == pytest.approx(want['ler'], abs=1e-6)


def test_transcripts_match_jax(pair):
    """``evaluate(return_transcripts=3)``: the beam-search sentences of the
    first batch's first three utterances, and the same ratios."""
    trainer = pair['trainer']
    trainer.model.load_state_dict(pair['init'])
    assert trainer.eval_decoder == 'beam' and trainer.beam_width == 12
    got, transcripts = trainer.evaluate(pair['loaders'][2],
                                        return_transcripts=3)
    assert transcripts == pair['transcripts']
    assert len(transcripts) == 3 and all(ref for _, ref in transcripts)
    assert got['wer'] == pytest.approx(pair['eval']['beam']['wer'], abs=1e-6)
    batch = next(iter(pair['loaders'][2]))
    assert trainer.transcribe(batch, limit=3) == transcripts


def test_three_steps_match_jax(pair):
    """Parameters after 3 clipped Adam steps (eps 1e-16).  The first update
    is about lr*sign(g), so an element whose gradient is numerical noise
    may move the other way: there the two sides agree within 2*lr per step.
    Where the first gradient is above 1e-3 of its tensor's max they agree
    within 0.2*lr: steps 2 and 3 divide moments of gradients that nearly
    cancel (g2 ~ -g1), which turns 1e-5 relative gradient differences into
    up to 7% of lr (measured); a wrong clip, moment or bias correction moves
    updates by about lr."""
    trainer, init, after = pair['trainer'], pair['init'], pair['after']
    trainer.model.load_state_dict(init)
    trainer.init_state(trainer.model, seed=0)
    for _ in range(3):
        trainer.step(pair['batch'], training=True, lr=LR)
    assert trainer.nonfinite_steps == 0 and trainer.step_count == 3
    state = trainer.model.state_dict()
    moved = 0
    for name, want in after.items():
        g = pair['grads'][name].abs().numpy()
        firm = g > 1e-3 * g.max()
        diff = (state[name] - want).abs().numpy()
        assert diff[firm].max(initial=0) <= 0.2 * LR, name
        assert diff.max() <= 2 * LR * 3, name
        moved += int((state[name] != init[name]).sum())
    assert moved > 0


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_dropout_training_reaches_every_parameter():
    """In training mode with both dropouts the CPU step runs the plain
    fused cell forward and backward and every parameter gets a finite
    gradient; the pre-LSTM mask is shared across time."""
    model = get_model(ARCH, use_rnn=True, dropout_rate=0.5, device='cpu', **KW)
    loaders = get_dataloaders('synthetic:8', batch_size=4, curriculum=())
    trainer = Trainer(loaders, device='cpu')
    trainer.init_state(model, seed=3)
    fused_cell.reset_launches()
    grads, m = trainer.gradients(next(iter(loaders[1])))
    assert fused_cell.BACKWARD_LAUNCHES == {'kernel': 0, 'plain': 2}
    assert np.isfinite(m['ctc_loss'])
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert len(grads) == len(list(model.parameters()))
    from nbasr_torch.models.asr import _time_shared_dropout
    x = torch.ones((3, 10, 16))
    y = _time_shared_dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert bool((y == y[:, :1]).all())


def test_nonfinite_step_is_skipped_and_counted():
    model = get_model(ARCH, use_rnn=False, device='cpu', **KW)
    loaders = get_dataloaders('synthetic:8', batch_size=4, curriculum=())
    trainer = Trainer(loaders, device='cpu')
    trainer.init_state(model, seed=0)
    batch = next(iter(loaders[1]))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bad = dict(batch, audio=batch['audio'].copy())
    bad['audio'][0, :10] = np.inf
    trainer.step(bad, training=True, lr=1e-3)
    assert trainer.nonfinite_steps == 1 and trainer.step_count == 1
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert not trainer.optimizer.state        # Adam did not advance
    trainer.step(batch, training=True, lr=1e-3)
    assert trainer.nonfinite_steps == 1
    assert any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def _optax_chain(clip_norm, eps):
    """The JAX Trainer's optimizer (nbasr_tpu/training/trainer.py:302-307)."""
    import optax
    return optax.apply_if_finite(optax.chain(
        optax.clip_by_global_norm(clip_norm), optax.scale_by_adam(eps=eps),
        optax.scale(-1.0)), max_consecutive_errors=1 << 30)


@pytest.mark.parametrize('case', ['overflowing_norm', 'nan'])
def test_update_skips_as_apply_if_finite(case):
    """``Trainer._update`` against the optax chain on hand-set gradients.
    A first ordinary step gives Adam momentum.  Then: finite gradients
    whose f32 global norm overflows (four entries of 3e19, three of 1) go
    through, clipped by 5/inf to zero, and Adam steps on its momentum; one
    NaN gradient skips the step in both, nothing moves.  Params and the
    moments within 1e-6 relative (the two Adam formulas round apart)."""
    import optax
    rng = np.random.RandomState(0)
    init = [rng.randn(4).astype(np.float32), rng.randn(3).astype(np.float32)]
    first = [rng.randn(4).astype(np.float32), rng.randn(3).astype(np.float32)]
    second = [np.full(4, 3e19, np.float32), np.ones(3, np.float32)]
    if case == 'nan':
        second[1][1] = np.nan

    class Params(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Parameter(torch.tensor(init[0]))
            self.b = torch.nn.Parameter(torch.tensor(init[1]))

    from nbasr_torch.data.phonemes import PhonemeEncoder
    trainer = Trainer((PhonemeEncoder(48), None, None, None), device='cpu')
    trainer.init_state(Params(), seed=0)
    tx = _optax_chain(trainer.clip_norm, trainer.adam_eps)
    params = [jnp.asarray(v) for v in init]
    state = tx.init(params)
    for grads in (first, second):
        for p, g in zip(trainer.model.parameters(), grads):
            p.grad = torch.tensor(g)
        trainer._update(LR)
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   params)
        params = optax.apply_updates(
            params, jax.tree_util.tree_map(lambda u: u * LR, updates))
    adam = state.inner_state[1]
    assert int(state.total_notfinite) == (case == 'nan')
    assert trainer.nonfinite_steps == (case == 'nan')
    for i, p in enumerate(trainer.model.parameters()):
        s = trainer.optimizer.state[p]
        assert int(s['step']) == int(adam.count) == 2 - (case == 'nan')
        for got, want in ((p, params[i]), (s['exp_avg'], adam.mu[i]),
                          (s['exp_avg_sq'], adam.nu[i])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-12)
    if case == 'nan':           # the first step's params, unchanged
        after_first = [v - LR * np.sign(g) for v, g in zip(init, first)]
        for p, want in zip(trainer.model.parameters(), after_first):
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)
    else:                       # moved by the momentum alone
        assert all(not np.allclose(np.asarray(p), v - LR * np.sign(g))
                   for p, v, g in zip(params, init, first))


def test_save_load_round_trip(tmp_path):
    model = get_model(ARCH, use_rnn=True, device='cpu', **KW)
    loaders = get_dataloaders('synthetic:8', batch_size=4, curriculum=())
    trainer = Trainer(loaders, device='cpu')
    trainer.init_state(model, seed=0)
    batch = next(iter(loaders[1]))
    trainer.step(batch, lr=1e-3)
    trainer.save(tmp_path / 'w.ckpt', epoch=3)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    gen = trainer.generator.get_state()
    trainer.step(batch, lr=1e-3)
    assert trainer.load(tmp_path / 'w.ckpt') == {'epoch': 3}
    assert trainer.step_count == 1
    assert torch.equal(trainer.generator.get_state(), gen)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)


def test_meshes_are_refused():
    from nbasr_torch.train import main
    with pytest.raises(SystemExit):
        main(['1', '0', '1', '0', '0', '1', '0', '0', '0', '--dp', '2',
              '--device', 'cpu'])
    with pytest.raises(ValueError, match='eval_decoder'):
        Trainer((None, None, None, None), device='cpu', eval_decoder='prefix')


def test_beam_eval_runs(monkeypatch):
    """The default decoder is the beam search (W=12), in the Trainer as in
    the JAX trainer and in the train twin as in ``train.py``; an eval pass
    runs the CTC forward alone (one alpha recursion per batch, no beta)."""
    import nbasr_torch.train
    from nbasr_torch.ops import ctc_pallas
    seen = {}

    class Recorder:
        def __init__(self, *args, **kwargs):
            seen.update(kwargs)

        def train(self, *args, **kwargs):
            return 'trained'

    monkeypatch.setattr(nbasr_torch.train, 'get_trainer', Recorder)
    assert nbasr_torch.train.main(
        ['1', '0', '1', '0', '0', '1', '0', '0', '0', '--device', 'cpu',
         '--data', 'synthetic:4']) == 'trained'
    assert seen['eval_decoder'] == 'beam'
    model = get_model(ARCH, use_rnn=True, device='cpu', **KW)
    loaders = get_dataloaders('synthetic:8', batch_size=4, curriculum=())
    trainer = Trainer(loaders, device='cpu')
    assert trainer.eval_decoder == 'beam' and trainer.beam_width == 12
    trainer.init_state(model, seed=0)
    batches = len(list(loaders[2]))
    ctc_pallas.reset_launches()
    m = trainer.evaluate(loaders[2])
    assert ctc_pallas.LAUNCHES == {'alpha': {'kernel': 0, 'plain': batches},
                                   'beta': {'kernel': 0, 'plain': 0}}
    assert all(np.isfinite(v) for v in m.values()) and m['wer'] > 0


def _tb_scalars(path):
    """{tag: [(step, value)]} of a TensorBoard event file, parsed from its
    TFRecord framing and the Event / Summary.Value protobuf fields."""
    import struct

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = _varint(buf, i)
            num, wire = key >> 3, key & 7
            if wire == 0:
                val, i = _varint(buf, i)
            elif wire == 1:
                val, i = buf[i:i + 8], i + 8
            elif wire == 5:
                val, i = buf[i:i + 4], i + 4
            else:
                n, i = _varint(buf, i)
                val, i = buf[i:i + n], i + n
            yield num, val

    data, out, i = path.read_bytes(), {}, 0
    while i < len(data):
        (n,) = struct.unpack('<Q', data[i:i + 8])
        record, i = data[i + 12:i + 12 + n], i + 16 + n
        event = dict(fields(record))
        for num, value in fields(event.get(5, b'')):
            v = dict(fields(value))
            out.setdefault(v[1].decode(), []).append(
                (event[2], struct.unpack('<f', v[2])[0]))
    return out


def _varint(buf, i):
    shift = val = 0
    while True:
        b = buf[i]
        val |= (b & 0x7F) << shift
        i, shift = i + 1, shift + 7
        if not b & 0x80:
            return val, i


def test_tensorboard_scalars(tmp_path):
    """``train`` with a ``save_dir`` writes the JAX trainer's scalars: the
    running loss every ``tb_step_interval`` steps, at the global step, and
    the per-epoch metrics, equal to the history."""
    model = get_model(ARCH, use_rnn=False, device='cpu', **KW)
    loaders = get_dataloaders('synthetic:8', batch_size=2, curriculum=())
    trainer = Trainer(loaders, device='cpu', save_dir=tmp_path, verbose=False,
                      eval_decoder='greedy', tb_step_interval=2)
    history, _ = trainer.train(model, epochs=2, lr=1e-3, model_name='run')
    (events,) = (tmp_path / 'run' / 'tb').glob('events.out.tfevents.*')
    scalars = _tb_scalars(events)
    assert set(scalars) == {'batch_ctc_loss', 'epoch_ctc_loss',
                            'epoch_val_ctc_loss', 'epoch_val_wer',
                            'epoch_val_ler', 'lr'}
    steps = loaders[1].steps
    assert steps >= 2
    assert [s for s, _ in scalars['batch_ctc_loss']] == [
        e * steps + i + 1 for e in range(2) for i in range(1, steps, 2)]
    for tag, key in (('epoch_ctc_loss', 'ctc_loss'),
                     ('epoch_val_ler', 'val_ler'), ('lr', 'lr')):
        assert [s for s, _ in scalars[tag]] == [1, 2]
        np.testing.assert_allclose([v for _, v in scalars[tag]], history[key],
                                   rtol=1e-6)


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer((None, None, None, None))


def test_train_twin_runs_end_to_end(tmp_path):
    """``python -m nbasr_torch.train`` at the flagship's full width on the
    CPU, one epoch of synthetic data, writes its artifacts."""
    out = subprocess.run(
        [sys.executable, '-m', 'nbasr_torch.train', '1', '0', '1', '0', '0',
         '1', '0', '0', '0', '--device', 'cpu', '--data', 'synthetic:8',
         '--epochs', '1', '--batch_size', '4', '--exp_folder', str(tmp_path),
         '--exp_name', 'run'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert 'Epoch 1: loss' in out.stdout and 'Test:' in out.stdout
    run = tmp_path / 'torch' / 'run'
    for f in ('scores.pickle', 'test_scores.pickle', 'best.ckpt',
              'latest.ckpt', 'metrics.jsonl'):
        assert (run / f).exists(), f
