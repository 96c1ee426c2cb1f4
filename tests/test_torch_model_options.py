"""The JAX package's remaining model options in the port, on the CPU and
against the JAX package: the cell convs' XLA lowerings ('chunked',
'masked_dense', 'native') and the dense cell conv at cell_groups=1 on the
unfused paths, logits and gradients through the converter; chunk_count;
the tap-matmul block conv; remat_cells; the rest of the featurizer
library."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nbasr_tpu.models.asr import get_model as jax_get_model
from nbasr_tpu.models.layers import PadConvRelu as JaxPadConvRelu
from nbasr_tpu.ops import frontend as jfe

from nbasr_torch.convert import from_flax, to_flax
from nbasr_torch.models.asr import get_model
from nbasr_torch.models.layers import PadConvRelu, chunk_count
from nbasr_torch.ops import frontend as fe
from nbasr_torch.ops import fused_cell, grouped_conv

ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]           # three conv5 nodes
MIXED = [[4, 1], [0, 1, 0], [2, 0, 1, 1]]          # conv7d2, linear, conv5d2
KW = dict(block_kernels=(4, 4), block_strides=(1, 2), block_filters=(24, 32),
          cells_per_block=(1, 2), cell_groups=4, rnn_units=12,
          init_scheme='scaled')
# f32 on both sides with the sums in other orders through two block convs,
# three cells, the LSTM and the head: logits within 1e-5 of max|jax| and
# each gradient within 1e-4 of its own max|jax| (tests/test_torch_training
# .py's STEP_TOL)
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision('highest'):
        yield


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _inputs(B=2, T=37, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T, 80).astype(np.float32)
    sizes = np.array([T, T - 9], np.int32)
    cot = rng.randn(B, T, 49).astype(np.float32)     # sliced to the output
    return feats, sizes, cot


def _pair(arch, **kw):
    """JAX logits and gradients of sum(logits * cot), and the port's model
    on the converted weights."""
    feats, sizes, cot = _inputs()
    jm = jax_get_model(arch, use_rnn=True, dropout_rate=0.0, cell_dropout=0.0,
                       **{**KW, **kw})
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(sizes))

    def loss(params):
        y = jm.apply({**v, 'params': params}, jnp.asarray(feats),
                     jnp.asarray(sizes))
        return jnp.sum(y * cot[:, :y.shape[1]]), y

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(v['params'])
    model = get_model(arch, use_rnn=True, dropout_rate=0.0, cell_dropout=0.0,
                      device='cpu', **{**KW, **kw})
    model.load_state_dict(from_flax(v))
    return v, np.asarray(want), from_flax({'params': grads}), model


def _port_grads(model):
    feats, sizes, cot = _inputs()
    y = model(torch.from_numpy(feats), torch.from_numpy(sizes))
    model.zero_grad()
    (y * torch.from_numpy(cot[:, :y.shape[1]])).sum().backward()
    return y, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize('arch', [ARCH, MIXED], ids=['conv5', 'mixed'])
@pytest.mark.parametrize('impl', ['chunked', 'masked_dense', 'native'])
def test_cell_lowerings_match_jax(impl, arch):
    """Logits and every gradient of the same JAX impl, weights converted;
    the cells run no kernel wrapper (these are XLA lowerings in JAX)."""
    _, want, jgrads, model = _pair(arch, grouped_impl=impl)
    fused_cell.reset_launches()
    grouped_conv.reset_launches()
    y, grads = _port_grads(model)
    _close(y, want, LOGIT_TOL)
    assert grads.keys() == jgrads.keys()
    for name, g in jgrads.items():
        _close(grads[name], g.numpy(), GRAD_TOL)
    assert fused_cell.LAUNCHES == {'kernel': 0, 'plain': 0}
    assert all(v == {'kernel': 0, 'plain': 0}
               for v in grouped_conv.LAUNCHES.values())
    native = any(k.endswith('conv5.conv.weight') or k.endswith('d2.conv.weight')
                 for k in grads)
    assert native == (impl == 'native')


@pytest.mark.parametrize('impl', ['pallas', 'pallas_split'])
def test_dense_cell_conv_at_one_group_matches_jax(impl):
    """cell_groups=1 on the unfused paths: the JAX cell runs nn.Conv under
    ``node{n}_conv5/conv/{kernel,bias}``; the converter carries it both ways
    (transposed to ``conv.weight [C, C, K]``), and logits and gradients
    match."""
    v, want, jgrads, model = _pair(MIXED, grouped_impl=impl, cell_groups=1)
    kernel = v['params']['block0_cell0']['node0_conv7d2']['conv']['kernel']
    assert kernel.shape == (7, 24, 24)
    assert model.block0_cell0.node0_conv7d2.conv.weight.shape == (24, 24, 7)
    back = to_flax(model.state_dict())
    flat_j = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_p)
    for path, arr in flat_j:
        np.testing.assert_array_equal(flat_p[path], np.asarray(arr))
    y, grads = _port_grads(model)
    _close(y, want, LOGIT_TOL)
    for name, g in jgrads.items():
        _close(grads[name], g.numpy(), GRAD_TOL)


@pytest.mark.parametrize('groups', [1, 4, 50, 100, 128])
def test_chunk_count_matches_jax(groups):
    for cin in (1, 6, 8, 10, 12, 24):
        for cout in (1, 6, 8, 12, 24):
            assert chunk_count(groups, cin, cout) == \
                JaxPadConvRelu.chunk_count(groups, cin, cout), (cin, cout)


@pytest.mark.parametrize('K,stride,T', [
    (8, 1, 33), (8, 2, 33), (8, 2, 34), (8, 2, 1), (5, 2, 17), (2, 2, 33)])
def test_tap_matmul_matches_jax_conv(K, stride, T):
    """The tap-matmul block conv against the JAX ``'conv'`` lowering (and
    the port's own), odd T included, within 1e-5 of max|jax| (f32 sums in
    another order).  K=2, stride 2 is a padding with no slack: JAX's
    ``tap_matmul`` takes ``ceil(T/2)`` frames there, the conv
    ``floor(T/2)``."""
    x = np.random.RandomState(K + T).randn(2, T, 20).astype(np.float32)
    jl = JaxPadConvRelu(16, kernel_size=K, strides=stride, dense_impl='conv',
                        init_scheme='scaled')
    v = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: a + 0.05, v)   # biases off zero
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    state = {k.replace('conv.kernel', 'conv.weight'): t for k, t in
             from_flax({'params': {'conv': v['params']['conv']}}).items()}
    got = {}
    for impl in ('tap_matmul', 'conv'):
        layer = PadConvRelu(20, 16, K, strides=stride, impl=impl)
        layer.load_state_dict(state)
        got[impl] = layer(torch.from_numpy(x)).detach()
    assert got['tap_matmul'].shape == want.shape
    _close(got['tap_matmul'], want, 1e-5)
    _close(got['tap_matmul'], got['conv'].numpy(), 1e-5)


def test_tap_matmul_model_matches_jax():
    """A whole model with ``block_conv_impl='tap_matmul'`` against the JAX
    model with ``'conv'``, logits and gradients."""
    _, want, jgrads, ref = _pair(ARCH, block_conv_impl='conv')
    model = get_model(ARCH, use_rnn=True, dropout_rate=0.0, cell_dropout=0.0,
                      device='cpu', block_conv_impl='tap_matmul', **KW)
    model.load_state_dict(ref.state_dict())
    y, grads = _port_grads(model)
    _close(y, want, LOGIT_TOL)
    for name, g in jgrads.items():
        _close(grads[name], g.numpy(), GRAD_TOL)


@pytest.mark.parametrize('impl', ['auto', 'pallas', 'chunked', 'pallas_split'])
def test_remat_cells_gradients_equal(impl):
    """``remat_cells`` at cell dropout 0.2 and LSTM dropout 0.1: the same
    loss and gradients as without (bit-equal: the recomputation runs the
    same ops on the same masks), the generator at the same state after the
    step, and on the fused path the cell forward run twice per cell."""
    feats, sizes, cot = _inputs(seed=3)
    out = {}
    for remat in (False, True):
        model = get_model(ARCH, use_rnn=True, dropout_rate=0.1,
                          cell_dropout=0.2, device='cpu', grouped_impl=impl,
                          remat_cells=remat,
                          generator=torch.Generator().manual_seed(5), **KW)
        model.train()
        gen = torch.Generator().manual_seed(11)
        fused_cell.reset_launches()
        y = model(torch.from_numpy(feats), torch.from_numpy(sizes),
                  generator=gen)
        (y * torch.from_numpy(cot[:, :y.shape[1]])).sum().backward()
        out[remat] = (y.detach(), {n: p.grad for n, p in
                                   model.named_parameters()},
                      gen.get_state(), dict(fused_cell.LAUNCHES))
    (y0, g0, s0, l0), (y1, g1, s1, l1) = out[False], out[True]
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    assert g0.keys() == g1.keys()
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=0)
    assert torch.equal(s0, s1)
    cells = sum(KW['cells_per_block'])
    if impl == 'auto':
        assert l0['plain'] == cells and l1['plain'] == 2 * cells
    # dropout reached the cells: eval mode gives other logits
    model.eval()
    with torch.no_grad():
        y_eval = model(torch.from_numpy(feats), torch.from_numpy(sizes))
    assert float((y_eval - y1).abs().max()) > 1e-3


def _audio(B=2, n=4000, seed=0):
    return (np.random.RandomState(seed).randn(B, n) * 0.1).astype(np.float32)


# each function against JAX on the same audio, f32: within 1e-5 of the
# JAX output's max|value| (FFTs and sums in other orders; the dB and power
# maps are smooth on these inputs)
FEATURE_TOL = 1e-5


_FEATURES = [
    ('spec', lambda a: fe.magnitude_spectrogram(a, device='cpu'),
     lambda a: jfe.magnitude_spectrogram(a)),
    ('spec_mag', lambda a: fe.magnitude_spectrogram(a, exponent=1.0,
                                                    device='cpu'),
     lambda a: jfe.magnitude_spectrogram(a, exponent=1.0)),
    ('to_db', lambda a: fe.to_db(fe.magnitude_spectrogram(a, device='cpu')),
     lambda a: jfe.to_db(jfe.magnitude_spectrogram(a))),
    ('to_db_noclip', lambda a: fe.to_db(
        fe.magnitude_spectrogram(a, device='cpu'), clip=False),
     lambda a: jfe.to_db(jfe.magnitude_spectrogram(a), clip=False)),
    ('mel', lambda a: fe.mel_spectrogram(a, device='cpu'),
     lambda a: jfe.mel_spectrogram(a)),
    ('pmel', lambda a: fe.power_mel_spectrogram(a, device='cpu'),
     lambda a: jfe.power_mel_spectrogram(a)),
    ('mfcc', lambda a: fe.mfcc(a, device='cpu'), lambda a: jfe.mfcc(a)),
    ('mfcc20', lambda a: fe.mfcc(a, num_coeffs=20, device='cpu'),
     lambda a: jfe.mfcc(a, num_coeffs=20)),
] + [(f'get_feature_{t}',
      (lambda t: lambda a: fe.get_feature(a, feature_type=t, device='cpu'))(t),
      (lambda t: lambda a: jfe.get_feature(a, feature_type=t))(t))
     for t in ('spec', 'spec_dB', 'mel', 'pmel', 'lmel', 'mfcc')]


@pytest.mark.parametrize('name,fn,jfn', [pytest.param(*f, id=f[0])
                                         for f in _FEATURES])
def test_featurizer_matches_jax(name, fn, jfn):
    audio = _audio()
    want = np.asarray(jfn(jnp.asarray(audio)))
    got = fn(audio)
    assert got.device.type == 'cpu' and got.dtype == torch.float32
    assert got.shape == want.shape
    _close(got, want, FEATURE_TOL)


@pytest.mark.parametrize('length', [None, 3990, 4000])
def test_inverse_stft_matches_jax(length):
    """The complex STFT of framed audio back to audio; ``length`` past the
    framed samples zero-pads.  The overlap-add divides by the summed squared
    window, which falls to 4e-9 at the first and last samples and there
    magnifies the inverse FFTs' last-bit differences: samples where it is at
    least 1e-3 are held to FEATURE_TOL, and all samples before the division
    (times the window sum)."""
    cfg = fe.FrontendConfig()
    audio = _audio(n=4000, seed=2)
    frames = jfe.frame_signal(jnp.asarray(audio), cfg.window, cfg.hop)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(cfg.window) / cfg.window)
    stft = np.asarray(jnp.fft.rfft(frames * w, n=cfg.fft_length, axis=-1))
    want = np.asarray(jfe.inverse_stft(jnp.asarray(stft), length=length))
    got = fe.inverse_stft(stft, length=length, device='cpu').numpy()
    assert got.shape == want.shape
    n_frames = stft.shape[-2]
    idx = (np.arange(n_frames)[:, None] * cfg.hop
           + np.arange(cfg.window)[None, :]).reshape(-1)
    norm = np.zeros(want.shape[-1])
    np.add.at(norm, idx, np.tile(w * w, n_frames))
    _close(got * norm, want * norm, FEATURE_TOL)
    inner = norm >= 1e-3
    _close(got[:, inner], want[:, inner], FEATURE_TOL)
    # and the framed samples come back
    _close(got[:, inner], audio[:, :len(norm)][:, inner], 1e-4)


def test_featurizer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        fe.mfcc(_audio())
    x = torch.from_numpy(_audio())       # a CPU tensor stays where it is
    assert fe.mfcc(x).device.type == 'cpu'
