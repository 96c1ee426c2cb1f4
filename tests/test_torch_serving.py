"""The port's streaming serving path (nbasr_torch.serving) on the CPU:
against the JAX StreamingASR on the same audio and weights, and against the
port's own offline model (the streaming exactness of tests/test_serving.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nbasr_tpu.models.asr import ASRModel as JaxASRModel
from nbasr_tpu.ops.decode import greedy_decode as jax_greedy_decode
from nbasr_tpu.ops.frontend import log_mel_spectrogram as jax_log_mel
from nbasr_tpu.serving import StreamingASR as JaxStreamingASR
from nbasr_tpu.serving import StreamingGreedyDecoder as JaxGreedyDecoder

from nbasr_torch.convert import from_flax
from nbasr_torch.models.asr import ASRModel
from nbasr_torch.ops.decode import greedy_decode
from nbasr_torch.ops.frontend import log_mel_spectrogram, num_frames
from nbasr_torch.serving import StreamingASR, StreamingGreedyDecoder

ARCH = [[1, 0], [3, 0, 1], [2, 1, 0, 0]]

KW = dict(num_classes=8, block_kernels=(4, 4), block_strides=(1, 2),
          block_filters=(16, 24), cells_per_block=(1, 2), cell_groups=4,
          rnn_units=12, init_scheme='scaled')


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision('highest'), torch.no_grad():
        yield


def _audio(B, n_samples, seed=0):
    return (np.random.RandomState(seed).randn(B, n_samples) * 0.1).astype(
        np.float32)


def _models(use_rnn, audio, valid, seed=0):
    jmodel = JaxASRModel.from_arch_vec(ARCH, use_rnn=use_rnn, dropout_rate=0.0,
                                       cell_dropout=0.0, **KW)
    feats = jax_log_mel(jnp.asarray(audio))
    variables = jmodel.init(jax.random.PRNGKey(seed), feats,
                            jnp.asarray(num_frames(valid)))
    port = ASRModel.from_arch_vec(ARCH, use_rnn=use_rnn, **KW)
    port.load_state_dict(from_flax(variables))
    return jmodel, variables, port


def _run_stream(s, audio, valid_samples, block=1111):
    """Push audio in uneven blocks, flush; return the (logits, valid) chunks."""
    B, S = audio.shape
    chunks = []
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        n_valid = np.clip(np.asarray(valid_samples) - lo, 0, hi - lo)
        chunks += s.push(audio[:, lo:hi], n_valid)
    return chunks + s.flush()


def _cat(chunks):
    return np.concatenate([np.asarray(lg) for lg, _ in chunks], axis=1)


@pytest.mark.parametrize('use_rnn', [False, True])
def test_streaming_matches_jax_streaming(use_rnn):
    B, S = 2, 16000
    audio = _audio(B, S)
    valid = np.array([S, S - 4000])
    jmodel, v, port = _models(use_rnn, audio, valid)
    js = JaxStreamingASR(jmodel, v, chunk_frames=24, batch_size=B)
    s = StreamingASR(port, chunk_frames=24, batch_size=B, device='cpu')
    jchunks, chunks = _run_stream(js, audio, valid), _run_stream(s, audio, valid)
    want, got = _cat(jchunks), _cat(chunks)
    assert got.shape == want.shape and len(chunks) == s.steps
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    np.testing.assert_array_equal(s.logit_lengths, js.logit_lengths)
    jdec, dec = JaxGreedyDecoder(B), StreamingGreedyDecoder(B)
    for (jl, jv), (lg, vl) in zip(jchunks, chunks):
        jdec.push(jl, jv)
        dec.push(lg, vl)
    assert dec.tokens == jdec.tokens


def _offline_logits(model, audio, valid_samples, s):
    """The port's offline forward on the streaming-canonical pad length Tp."""
    feats = log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    f_valid = num_frames(np.asarray(valid_samples))
    tp = max(-(-int(f_valid.max()) // s.C) * s.C, s.Wf)
    pad = tp - feats.shape[1]
    feats = (np.pad(feats, ((0, 0), (0, pad), (0, 0))) if pad > 0
             else feats[:, :tp])
    mask = np.arange(tp)[None, :] < f_valid[:, None]
    return model(torch.from_numpy(feats), mask=torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize('use_rnn', [False, True])
def test_streaming_matches_offline(use_rnn):
    B, S = 2, 16000
    audio = _audio(B, S)
    valid = np.array([S, S - 4000])
    _, _, port = _models(use_rnn, audio, valid)
    s = StreamingASR(port, chunk_frames=24, batch_size=B, device='cpu')
    got = _cat(_run_stream(s, audio, valid))
    ref = _offline_logits(port, audio, valid, s)
    n = got.shape[1]
    assert n >= int(s.logit_lengths.max())
    np.testing.assert_allclose(got, ref[:, :n], rtol=2e-5, atol=2e-5)


def test_streaming_greedy_matches_offline():
    B, S = 2, 12000
    audio = _audio(B, S, seed=1)
    valid = np.array([S, S - 3000])
    _, _, port = _models(True, audio, valid, seed=1)
    s = StreamingASR(port, chunk_frames=16, batch_size=B, device='cpu')
    dec = StreamingGreedyDecoder(B)
    for lg, vl in _run_stream(s, audio, valid, block=800):
        dec.push(lg, vl)
    ref = _offline_logits(port, audio, valid, s)
    ids, lens = greedy_decode(torch.from_numpy(ref),
                              torch.from_numpy(s.logit_lengths))
    for b in range(B):
        assert dec.tokens[b] == ids[b, :int(lens[b])].tolist()


def test_greedy_decode_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 40, 6).astype(np.float32)
    logits[:, ::3, 0] += 3.0          # blanks and repeats to collapse
    lens = np.array([40, 17, 0], np.int32)
    want_ids, want_lens = jax_greedy_decode(jnp.asarray(logits),
                                            jnp.asarray(lens))
    ids, got_lens = greedy_decode(torch.from_numpy(logits),
                                  torch.from_numpy(lens))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


def test_chunk_frames_must_divide_reduction():
    port = ASRModel.from_arch_vec(ARCH, **KW)
    with pytest.raises(ValueError):
        StreamingASR(port, chunk_frames=7, batch_size=1, device='cpu')


def test_latency_reporting():
    port = ASRModel.from_arch_vec(ARCH, **KW)
    s = StreamingASR(port, chunk_frames=24, batch_size=1, device='cpu')
    assert s.latency_frames == s.hr + 24
    assert s.latency_seconds == pytest.approx(s.latency_frames * 0.010)


def test_quantized_serving_is_a_later_slice():
    """Ported now (tests/test_torch_quant.py holds it against JAX): the
    int8 streamer runs, and its logits are within 5% of max of the f32
    streamer's (per-channel int8 weights, random init)."""
    B, S = 2, 16000
    audio = _audio(B, S)
    valid = np.array([S, S - 4000])
    _, _, port = _models(True, audio, valid)
    f32 = _cat(_run_stream(StreamingASR(port, chunk_frames=24, batch_size=B,
                                        device='cpu'), audio, valid))
    s = StreamingASR(port, quantize=True, chunk_frames=24, batch_size=B,
                     device='cpu')
    got = _cat(_run_stream(s, audio, valid))
    assert got.shape == f32.shape and s.qparams is not None
    np.testing.assert_allclose(got, f32, rtol=0,
                               atol=0.05 * np.abs(f32).max())
    assert float(np.abs(got - f32).max()) > 0
