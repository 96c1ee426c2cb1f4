"""int8 PTQ in the port (nbasr_torch.quant) against the JAX package's
(nbasr_tpu.quant) on the CPU: q and s bit for bit, the round trip, the size
accounting, ``.int8.npz`` files both ways, int8 streaming serving, and the
CLI's ``quantize`` on a checkpoint the JAX trainer format holds."""

import gc
import io
import contextlib
import json
import weakref

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import serialization

from nbasr_tpu import cli as jax_cli
from nbasr_tpu import quant as jq
from nbasr_tpu.models.asr import ASRModel as JaxASRModel
from nbasr_tpu.ops.frontend import log_mel_spectrogram as jax_log_mel
from nbasr_tpu.serving import StreamingASR as JaxStreamingASR

from nbasr_torch import cli, quant
from nbasr_torch.convert import from_flax
from nbasr_torch.models.asr import ASRModel
from nbasr_torch.ops.frontend import num_frames
from nbasr_torch.serving import StreamingASR

# conv7d2 + zero, linear, conv5: grouped and dense cell kernels
ARCH = [[4, 1], [0, 1, 0], [1, 0, 1, 1]]
KW = dict(num_classes=8, block_kernels=(4, 4), block_strides=(1, 2),
          block_filters=(16, 24), cells_per_block=(1, 2), cell_groups=4,
          rnn_units=12, init_scheme='scaled')


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision('highest'), torch.no_grad():
        yield


def _audio(B=2, n=16000, seed=0):
    return (np.random.RandomState(seed).randn(B, n) * 0.1).astype(np.float32)


@pytest.fixture(scope='module')
def models():
    """The JAX model and its variables (biases and norms moved off their
    init so that every leaf kind is exercised), and the port's model on
    the converted weights."""
    jm = JaxASRModel.from_arch_vec(ARCH, use_rnn=True, dropout_rate=0.0,
                                   cell_dropout=0.0, **KW)
    audio = _audio()
    v = jm.init(jax.random.PRNGKey(3), jax_log_mel(jnp.asarray(audio)),
                jnp.asarray(num_frames(np.array([16000, 12000]))))
    rng = np.random.RandomState(1)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * rng.randn(*a.shape).astype(
            np.float32), v)
    port = ASRModel.from_arch_vec(ARCH, use_rnn=True, **KW)
    port.load_state_dict(from_flax(v))
    return jm, v, port


def _params(port):
    return dict(port.named_parameters())


# the port's name of one kernel of each kind, and its output axis
KINDS = {'block_conv': ('block1_conv.conv.weight', 0),
         'grouped': ('block1_cell1.node0_conv7d2.conv_kernel_grouped', -1),
         'dense_cell': ('block0_cell0.node1_linear.dense.kernel', -1),
         'head': ('head.kernel', -1),
         'lstm_input': ('lstm.kernel', -1),
         'lstm_recurrent': ('lstm.recurrent', -1)}


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_q_and_s_bit_equal_to_jax(models, kind):
    """Each kernel kind's q and s bit-equal to JAX ``quantize_tree``'s (an
    nn.Conv's in the WIO layout, the port's on axis 0 of ``[cout, cin,
    K]``), every other leaf passed through unchanged."""
    _, v, port = models
    params = _params(port)
    got = quant.quantize_tree(params)
    name, axis = KINDS[kind]
    jname = name.replace('conv.weight', 'conv.kernel')
    jtree = jq.quantize_tree(v['params'])
    node = jtree
    for part in jname.split('.'):
        node = node[part]
    q, s = np.asarray(node['q']), np.asarray(node['s'])
    if axis == 0:
        q, s = q.transpose(2, 1, 0), s.transpose(2, 1, 0)
    assert got[name]['q'].dtype == torch.int8
    np.testing.assert_array_equal(got[name]['q'].numpy(), q)
    assert got[name]['s'].numpy().tobytes() == np.ascontiguousarray(
        s).tobytes()
    assert got[name]['s'].shape[axis] == got[name]['q'].shape[axis]
    quantized = {k for k, t in got.items() if isinstance(t, dict)}
    assert quantized == {k for k in got if k.endswith(
        ('.kernel', 'conv_kernel_grouped', '.recurrent', 'conv.weight'))}
    for k, t in got.items():
        if k not in quantized:
            assert torch.equal(t, params[k]) and t is not params[k], k


def test_round_half_to_even_as_jax():
    """Ties: w / s exactly k + 0.5 rounds to the even neighbour on both
    sides (jnp.round and torch.round)."""
    w = np.array([[127.0, 0.5, 1.5, -2.5, 126.5, -0.5, 0.0]], np.float32).T
    w = np.repeat(w, 3, axis=1)             # [7, 3]: out axis last
    want = jq.quantize_tree({'kernel': jnp.asarray(w)})['kernel']
    got = quant.quantize_tree({'x.kernel': torch.from_numpy(w)})['x.kernel']
    np.testing.assert_array_equal(got['q'].numpy(), np.asarray(want['q']))
    np.testing.assert_array_equal(got['q'][:, 0].numpy(),
                                  [127, 0, 2, -2, 126, 0, 0])
    zero = quant.quantize_tree({'k.kernel': torch.zeros(4, 2)})['k.kernel']
    assert torch.equal(zero['s'], torch.ones(1, 2))


def test_round_trip_within_half_a_step(models):
    """Every dequantized kernel within s/2 of its weight per output channel
    (the JAX test's bound), the rest bit-exact."""
    _, _, port = models
    params = _params(port)
    qtree = quant.quantize_tree(params)
    deq = quant.dequantize_tree(qtree)
    for name, w in params.items():
        if isinstance(qtree[name], dict):
            bound = qtree[name]['s'] * 0.5 + 1e-8
            assert bool(((w - deq[name]).abs() <= bound).all()), name
        else:
            assert torch.equal(deq[name], w), name
    bf16 = quant.dequantize_tree(qtree, torch.bfloat16)
    assert bf16['head.kernel'].dtype == torch.bfloat16


def test_size_bytes_equal_to_jax(models):
    _, v, port = models
    got = quant.quantized_size_bytes(quant.quantize_tree(_params(port)))
    assert got == jq.quantized_size_bytes(jq.quantize_tree(v['params']))
    assert 0.25 < got[0] / got[1] < 0.32


def test_npz_crosses_both_ways(models, tmp_path):
    """A JAX ``.int8.npz`` read by the port equals the port's tree, and the
    port's file read by JAX equals JAX's tree; the files' keys are the
    same."""
    _, v, port = models
    jtree = jq.quantize_tree(v['params'])
    ptree = quant.quantize_tree(_params(port))
    jq.save_quantized(tmp_path / 'jax.int8.npz', jtree)
    quant.save_quantized(tmp_path / 'port.int8.npz', ptree)
    with np.load(tmp_path / 'jax.int8.npz') as a, \
            np.load(tmp_path / 'port.int8.npz') as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = quant.load_quantized(tmp_path / 'jax.int8.npz')
    assert back.keys() == ptree.keys()
    for k, t in ptree.items():
        if isinstance(t, dict):
            assert torch.equal(back[k]['q'], t['q']), k
            assert torch.equal(back[k]['s'], t['s']), k
        else:
            assert torch.equal(back[k], t), k
    jback = jq.load_quantized(tmp_path / 'port.int8.npz')
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(jback)[0])
    assert len(flat_j) == len(flat_b)
    for path, arr in flat_j:
        np.testing.assert_array_equal(flat_b[path], np.asarray(arr))


def test_quantized_apply_is_apply_on_dequantized(models):
    _, _, port = models
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 33, 80).astype(
        np.float32))
    qtree = quant.quantize_tree(_params(port))
    got = quant.quantized_apply(port, qtree, x)
    ref = ASRModel.from_arch_vec(ARCH, use_rnn=True, **KW)
    ref.load_state_dict({**port.state_dict(), **quant.dequantize_tree(qtree)})
    torch.testing.assert_close(got, ref(x), rtol=0, atol=0)


def _stream(s, audio, valid, block=1111):
    chunks = []
    for lo in range(0, audio.shape[1], block):
        hi = min(lo + block, audio.shape[1])
        chunks += s.push(audio[:, lo:hi], np.clip(valid - lo, 0, hi - lo))
    return np.concatenate([np.asarray(lg) for lg, _ in chunks + s.flush()],
                          axis=1)


def test_quantized_streaming_matches_jax(models):
    """``StreamingASR(quantize=True)`` against the JAX streamer's on the same
    weights and audio, within tests/test_torch_serving.py's 2e-5 of max;
    and the int8 stream is not the f32 one."""
    jm, v, port = models
    audio = _audio()
    valid = np.array([16000, 12000])
    js = JaxStreamingASR(jm, v, chunk_frames=24, batch_size=2, quantize=True)
    s = StreamingASR(port, chunk_frames=24, batch_size=2, quantize=True,
                     device='cpu')
    want, got = _stream(js, audio, valid), _stream(s, audio, valid)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    f32 = _stream(StreamingASR(port, chunk_frames=24, batch_size=2,
                               device='cpu'), audio, valid)
    assert float(np.abs(f32 - got).max()) > 1e-4


def test_quantized_streamer_holds_int8_and_no_caller_weight():
    """The streamer keeps its kernels as int8 plus f32 scales, a skeleton
    whose parameters are on the meta device, and no reference to the
    caller's parameters: they are freed once the caller drops its model."""
    port = ASRModel.from_arch_vec(ARCH, use_rnn=True, **KW)
    refs = [weakref.ref(p) for p in port.parameters()]
    s = StreamingASR(port, chunk_frames=24, batch_size=1, quantize=True,
                     device='cpu')
    assert all(p.device.type == 'meta' for p in s.model.parameters())
    kernels = [t for t in s.qparams.values() if isinstance(t, dict)]
    # 2 block convs, 3 cells x 3 kernel nodes, the LSTM's two, the head
    assert len(kernels) == 14 and all(t['q'].dtype == torch.int8
                                      for t in kernels)
    del port
    gc.collect()
    assert all(r() is None for r in refs)
    out = s.push(_audio(1, 8000)) + s.flush()
    assert out and all(np.isfinite(np.asarray(lg)).all() for lg, _ in out)


def test_quantized_streamer_finds_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    port = ASRModel.from_arch_vec(ARCH, use_rnn=True, **KW)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        StreamingASR(port, quantize=True)


def test_cli_quantize_matches_the_jax_cli(models, tmp_path):
    """``python -m nbasr_torch.cli quantize`` on a checkpoint in the JAX
    trainer's format (``flax.serialization.to_bytes`` of params, an
    opt_state stand-in, step and rng): the arrays and the JSON line of the
    JAX CLI's ``quantize``."""
    _, v, _ = models
    ckpt = tmp_path / 'best.ckpt'
    ckpt.write_bytes(serialization.to_bytes({
        'params': v['params'], 'opt_state': {'count': np.int32(3)},
        'step': np.int32(3), 'rng': np.zeros(4, np.uint32)}))
    lines = {}
    for name, main in (('jax', jax_cli.main), ('port', cli.main)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(['quantize', str(ckpt), '--out',
                  str(tmp_path / f'{name}.npz')])
        lines[name] = json.loads(out.getvalue())
    assert lines['port'].pop('out').endswith('port.npz')
    assert lines['jax'].pop('out').endswith('jax.npz')
    assert lines['port'] == lines['jax']
    with np.load(tmp_path / 'jax.npz') as a, \
            np.load(tmp_path / 'port.npz') as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
