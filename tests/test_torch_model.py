"""The port's ASRModel, frontend and converter against the JAX package: the
same inputs (numpy, seeded) and the same weights (through convert.from_flax)
at reduced widths, in f32."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nbasr_tpu.models.asr import ASRModel as JaxASRModel
from nbasr_tpu.models.asr import get_model as jax_get_model
from nbasr_tpu.ops import frontend as jax_frontend
from nbasr_tpu.parallel.seqparallel import encoder_halo as jax_encoder_halo

from nbasr_torch.convert import from_flax, to_flax
from nbasr_torch.data import load_train_stats as port_stats
from nbasr_torch.models.asr import ASRModel, count_params, get_model
from nbasr_torch.ops import frontend
from nbasr_torch.parallel.seqparallel import encoder_halo

FLAGSHIP = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]

# tests/test_full_model_parity.py's four archs
CASES = [
    (FLAGSHIP, False),
    ([[0, 1], [2, 1, 0], [4, 0, 1, 1]], False),       # linear + dilated + skips
    ([[3, 0], [5, 1, 1], [0, 1, 0, 1]], False),       # zero node + skips
    (FLAGSHIP, True),                                 # with the LSTM head
]
CASE_IDS = ['flagship', 'linear+dilated', 'zero+skips', 'flagship+lstm']

# tests/test_serving.py's reduced widths
KW = dict(num_classes=8, block_kernels=(4, 4), block_strides=(1, 2),
          block_filters=(16, 24), cells_per_block=(1, 2), cell_groups=4,
          rnn_units=12, init_scheme='scaled')


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision('highest'), torch.no_grad():
        yield


def _models(arch, use_rnn, seed=0):
    rng = np.random.RandomState(seed)
    stats = dict(data_mean=tuple(rng.randn(80) * 0.5),
                 data_variance=tuple(rng.rand(80) + 0.5))
    jmodel = JaxASRModel.from_arch_vec(arch, use_rnn=use_rnn, dropout_rate=0.0,
                                       cell_dropout=0.0, **stats, **KW)
    x = rng.randn(2, 37, 80).astype(np.float32)
    sizes = np.array([37, 29], np.int32)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                            jnp.asarray(sizes))
    port = ASRModel.from_arch_vec(arch, use_rnn=use_rnn, **stats, **KW)
    port.load_state_dict(from_flax(variables))
    return jmodel, variables, port, x, sizes


def _close(got, want, tol=1e-5):
    """f32 against f32 with sums in another order: ``tol`` of the scale."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize('arch,use_rnn', CASES, ids=CASE_IDS)
def test_full_logits_match_jax(arch, use_rnn):
    jmodel, v, port, x, sizes = _models(arch, use_rnn)
    want = jmodel.apply(v, jnp.asarray(x), jnp.asarray(sizes))
    got = port(torch.from_numpy(x), torch.from_numpy(sizes))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize('arch,use_rnn', CASES, ids=CASE_IDS)
def test_encode_then_head_with_carry_matches_jax(arch, use_rnn):
    """'encode' on a masked batch, then 'head' over two halves of the
    encoder output with the LSTM carry threaded from one to the other."""
    jmodel, v, port, x, sizes = _models(arch, use_rnn, seed=1)
    mask = np.arange(x.shape[1])[None, :] < sizes[:, None]
    jenc = jmodel.apply(v, jnp.asarray(x), mask=jnp.asarray(mask),
                        stage='encode')
    enc = port(torch.from_numpy(x), mask=torch.from_numpy(mask),
               stage='encode')
    _close(enc, jenc)
    half = enc.shape[1] // 2
    jcarry = carry = None
    for lo, hi in ((0, half), (half, enc.shape[1])):
        jl, jcarry = jmodel.apply(v, jenc[:, lo:hi], stage='head',
                                  rnn_carry=jcarry, return_rnn_carry=True)
        lg, carry = port(enc[:, lo:hi], stage='head', rnn_carry=carry,
                         return_rnn_carry=True)
        _close(lg, jl)
    if use_rnn:
        for a, b in zip(carry, jcarry):
            _close(a, b)
    else:
        assert carry is None and jcarry is None


@pytest.mark.parametrize('arch,use_rnn', CASES, ids=CASE_IDS)
def test_encoder_halo_matches_jax(arch, use_rnn):
    jmodel, _, port, _, _ = _models(arch, use_rnn)
    assert encoder_halo(port) == jax_encoder_halo(jmodel)


@pytest.mark.parametrize('fft_mode', ['rfft', 'dft'])
def test_log_mel_matches_jax(fft_mode):
    audio = (np.random.RandomState(0).randn(2, 5321) * 0.1).astype(np.float32)
    jcfg = jax_frontend.FrontendConfig(fft_mode=fft_mode)
    cfg = frontend.FrontendConfig(fft_mode=fft_mode)
    want = np.asarray(jax_frontend.log_mel_spectrogram(jnp.asarray(audio), jcfg))
    got = frontend.log_mel_spectrogram(torch.from_numpy(audio), cfg).numpy()
    assert got.shape == want.shape == (2, 31, 80)
    # log of f32 power sums: 1e-4 absolute on values of magnitude ~10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        frontend.mel_weight_matrix(), jax_frontend.mel_weight_matrix())


def test_num_frames_matches_jax():
    n = np.array([0, 399, 400, 559, 560, 16000, 123457])
    want = jax_frontend.num_frames(n)
    np.testing.assert_array_equal(frontend.num_frames(n), want)
    np.testing.assert_array_equal(frontend.num_frames(torch.from_numpy(n)).numpy(),
                                  want)
    assert [frontend.num_frames(int(v)) for v in n] == list(want)


def test_flagship_converter_round_trip_and_param_counts():
    """Every parameter kind of the 26M flagship (block conv WIO <-> OIW,
    compact grouped kernels, LSTM, head, MVN stats) crosses both ways
    bit-exactly; the tree's shapes come from jax.eval_shape (no JAX init)."""
    from nbasr_tpu.data.pipeline import load_train_stats
    jmodel = jax_get_model(FLAGSHIP, use_rnn=True, data_norm=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 80)))
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    # the port's own stats file is a copy of the JAX package's
    for a, b in zip(load_train_stats(), port_stats()):
        np.testing.assert_array_equal(a, b)

    port = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device='cpu')
    assert count_params(port) == 26_339_349
    port.load_state_dict(from_flax(tree))       # strict: same keys and shapes
    back = to_flax(port.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    assert port.block0_conv.conv.weight.shape == (600, 80, 8)
    # a 772-frame window at chunk_frames=240
    assert encoder_halo(port) == jax_encoder_halo(jmodel) == (24, 508)
    assert count_params(get_model(FLAGSHIP, use_rnn=False,
                                  device='cpu')) == 22_971_649


def test_bf16_forward_tracks_f32():
    """compute_dtype=bf16 threads through (cells at bf16 with their
    rounding points, LSTM in bf16) and stays near the f32 logits."""
    _, _, port, x, sizes = _models(FLAGSHIP, True)
    f32 = port(torch.from_numpy(x), torch.from_numpy(sizes))
    low = ASRModel.from_arch_vec(
        FLAGSHIP, use_rnn=True, compute_dtype=torch.bfloat16,
        data_mean=port.data_norm.mean, data_variance=port.data_norm.variance,
        **KW)
    low.load_state_dict(port.state_dict())
    enc = low(torch.from_numpy(x), torch.from_numpy(sizes), stage='encode')
    assert enc.dtype == torch.bfloat16
    bf16 = low(torch.from_numpy(x), torch.from_numpy(sizes))
    assert bf16.dtype == torch.float32
    # bf16 keeps 8 bits: a few percent of the scale after 3 cells + LSTM
    assert (bf16 - f32).abs().max() <= 0.05 * f32.abs().max()
