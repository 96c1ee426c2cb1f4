"""The JAX trainer's checkpoints in the port (nbasr_torch.checkpoint), on
the CPU: the msgpack reader and writer against flax's, files the JAX
``Trainer.save`` wrote loaded into the port's Trainer (and resumed), and
the port's ``save_flax`` files loaded by the JAX ``Trainer.load``."""

import json
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import serialization

from nbasr_tpu.data import get_dataloaders as jax_get_dataloaders
from nbasr_tpu.models.asr import get_model as jax_get_model
from nbasr_tpu.training import get_loss as jax_get_loss
from nbasr_tpu.training import get_trainer as jax_get_trainer

from nbasr_torch import checkpoint
from nbasr_torch.convert import from_flax
from nbasr_torch.data.pipeline import get_dataloaders
from nbasr_torch.models.asr import get_model
from nbasr_torch.train import adopt_jax_run
from nbasr_torch.training import Trainer, get_loss

ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
KW = dict(block_kernels=(4, 4), block_strides=(1, 2), block_filters=(24, 32),
          cells_per_block=(1, 1), cell_groups=4, rnn_units=16,
          init_scheme='scaled')
LR = 1e-3
DATA = 'synthetic:12'


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision('highest'):
        yield


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """A JAX Trainer (cells on the 'chunked' lowering: the parameter tree
    of every path, and no interpret-mode kernel to compile) after 2 steps
    at dropout 0, its ``latest.ckpt``, and its parameters after 3 more
    steps on the same batch."""
    root = tmp_path_factory.mktemp('jaxrun')
    loaders = jax_get_dataloaders(DATA, batch_size=4, curriculum=())
    jmodel = jax_get_model(ARCH, use_rnn=True, dropout_rate=0.0,
                           cell_dropout=0.0, data_norm=True,
                           grouped_impl='chunked', **KW)
    jtr = jax_get_trainer(loaders, jax_get_loss(), verbose=False,
                          eval_decoder='greedy')
    jtr.init_state(jmodel, seed=0)
    batch = next(iter(loaders[1]))
    for _ in range(2):
        jtr.step(batch, training=True, lr=LR)
    ckpt = root / 'run' / 'latest.ckpt'
    ckpt.parent.mkdir()
    jtr.save(ckpt, epoch=1, best_val=0.75)
    saved = jax.tree_util.tree_map(np.asarray, {
        'params': jtr.state.params, 'opt_state': jtr.state.opt_state})
    for _ in range(3):
        jtr.step(batch, training=True, lr=LR)
    after = from_flax({'params': jax.tree_util.tree_map(
        np.asarray, jtr.state.params)})
    return dict(trainer=jtr, ckpt=ckpt, batch=batch, saved=saved,
                after=after)


def _port_trainer(seed=0):
    loaders = get_dataloaders(DATA, batch_size=4, curriculum=())
    model = get_model(ARCH, use_rnn=True, dropout_rate=0.0, cell_dropout=0.0,
                      data_norm=True, device='cpu',
                      generator=torch.Generator().manual_seed(9), **KW)
    trainer = Trainer(loaders, get_loss(), device='cpu', verbose=False,
                      eval_decoder='greedy')
    return trainer.init_state(model, seed=seed)


def test_reader_matches_flax_on_a_trainer_checkpoint(jax_run):
    """Every leaf (params, the apply_if_finite and Adam state, step, rng)
    equal to ``msgpack_restore``'s, dtype and shape included, the map order
    too; and the writer gives the file's bytes back."""
    data = jax_run['ckpt'].read_bytes()
    want = serialization.msgpack_restore(data)
    got = checkpoint.unpackb(data)
    assert set(got) == {'params', 'opt_state', 'step', 'rng'}
    assert set(got['opt_state']) == {'notfinite_count', 'last_finite',
                                     'total_notfinite', 'inner_state'}
    assert got['opt_state']['inner_state'].keys() == {'0', '1', '2'}
    w, g = _leaves(want), _leaves(got)
    assert list(w) == list(g) and len(w) > 40
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got['rng'].dtype == np.uint32 and got['rng'].shape == (4,)
    assert int(got['step']) == 2
    assert checkpoint.packb(got) == data


def _bf16():
    return np.asarray(jnp.asarray([1.5, -2.25, 3e38], jnp.bfloat16))


# one value of each kind flax's msgpack subset holds
EXT_CASES = {
    'nil': None, 'bool': [True, False],
    'ints': [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 - 1, -1,
             -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63],
    'float': [0.5, -1e300, float('inf')],
    'str': ['', 'x' * 31, 'y' * 32, 'z' * 256, 'é' * 40000],
    'bin': [b'', b'\x00' * 255, b'\x01' * 256, b'\x02' * 65536],
    'array16': list(range(20)), 'map16': {str(i): i for i in range(20)},
    'npscalar': [np.float32(2.5), np.int64(-7), np.bool_(True),
                 np.uint8(200)],
    'complex': complex(3.0, -4.5),
    'ndarray': [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                np.array(3, np.int32), np.zeros((2, 0), np.float16),
                np.array([True, False]), np.arange(5, dtype=np.uint32),
                np.arange(6, dtype=np.float64).reshape(3, 2),
                np.array([1 + 2j], np.complex64)],
    'nested': {'a': {'b': {'c': np.ones((3,), np.int8)}}, 'd': [1, 'e']},
}


def _equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def _flax_bytes(tree):
    """What flax's ``to_bytes`` writes for a tree of dicts, lists and
    leaves: ``msgpack_serialize`` in place (maps in their own order)."""
    return serialization.msgpack_serialize(_copy(tree), in_place=True)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


@pytest.mark.parametrize('case', sorted(EXT_CASES))
def test_every_kind_crosses_with_flax(case):
    """flax's bytes read back equal to what flax reads, and the port's
    bytes equal to flax's, for each kind of the subset."""
    tree = {'v': EXT_CASES[case]}
    data = _flax_bytes(tree)
    want = serialization.msgpack_restore(data)
    _equal(checkpoint.unpackb(data), want)
    assert checkpoint.packb(tree) == data


def test_bfloat16_array_reads_as_torch_bfloat16():
    """flax writes jnp.bfloat16 arrays by that dtype name; numpy has none,
    so the reader gives a torch bfloat16 tensor of the same values."""
    arr = _bf16()
    data = serialization.msgpack_serialize({'w': arr})
    got = checkpoint.unpackb(data)['w']
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), arr.astype(np.float32))


def test_chunked_arrays_cross_with_flax(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes become flax's chunked maps: lowered
    to 64 bytes here (in this test only), a 100-element f32 array is
    written in seven chunks by both writers and joined back by both
    readers."""
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    monkeypatch.setattr(checkpoint, 'MAX_CHUNK_SIZE', 64)
    tree = {'w': np.arange(100, dtype=np.float32).reshape(10, 10),
            'small': np.arange(3, dtype=np.int32)}
    data = _flax_bytes(tree)
    assert checkpoint.packb(tree) == data
    got = checkpoint.unpackb(data)
    _equal(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got['w'], tree['w'])


def _frame(body):
    """A one-entry map {'a': <body bytes>}."""
    return b'\x81\xa1a' + body


def _ndarray_ext(shape, dtype_name, payload):
    """An ext 1 record as flax writes one, for any dtype name."""
    inner = (b'\x93' + bytes((0x90 | len(shape),)) + bytes(shape)
             + bytes((0xa0 | len(dtype_name),)) + dtype_name.encode()
             + b'\xc4' + bytes((len(payload),)) + payload)
    return b'\xc7' + bytes((len(inner),)) + b'\x01' + inner


MALFORMED = {
    'type_c1': _frame(b'\xc1'),
    'ext_code_5': _frame(b'\xd4\x05\x00'),
    'dtype_object': _frame(_ndarray_ext([1], 'object', b'\x00' * 8)),
    'dtype_str': _frame(_ndarray_ext([1], '<U1', b'\x00' * 4)),
    'dtype_size': _frame(_ndarray_ext([2], 'float32', b'\x00')),
    'int_key': b'\x81\x01\xc0',
    'trailing': checkpoint.packb({'a': 1}) + b'\x00',
    'chunks_missing': checkpoint.packb(
        {'a': {'__msgpack_chunked_array__': True, 'shape': {'0': 3}}}),
    'bad_utf8': _frame(b'\xa2\xff\xfe'),
}


@pytest.mark.parametrize('case', sorted(MALFORMED))
def test_malformed_files_raise(case):
    with pytest.raises(ValueError, match='offset'):
        checkpoint.unpackb(MALFORMED[case])


@pytest.mark.parametrize('keep', [0.0, 0.001, 0.5, 0.999])
def test_truncated_files_raise(jax_run, keep):
    data = jax_run['ckpt'].read_bytes()
    with pytest.raises(ValueError, match='truncated.*offset'):
        checkpoint.unpackb(data[:int(len(data) * keep)])


def test_msgpack_witness(jax_run):
    """Where the msgpack package is installed, it reads the port's bytes
    to the same tree (a witness only: the port never imports it)."""
    msgpack = pytest.importorskip('msgpack')
    data = checkpoint.packb(EXT_CASES)
    got = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack,
                          raw=False)
    _equal(got, serialization.msgpack_restore(data))


def test_port_trainer_loads_the_jax_checkpoint(jax_run):
    """``Trainer.load`` tells the flax file by its first byte: parameters,
    Adam's step and moments equal to the JAX state bit for bit, step count
    2, the meta back; then 3 steps equal to the JAX trainer's 3 (the bound
    of tests/test_torch_training.py::test_three_steps_match_jax)."""
    trainer = _port_trainer()
    gen = trainer.generator.get_state()
    assert trainer.load(jax_run['ckpt']) == {'epoch': 1, 'best_val': 0.75}
    first, _ = trainer.gradients(jax_run['batch'])
    assert trainer.step_count == 2 and trainer.nonfinite_steps == 0
    assert torch.equal(trainer.generator.get_state(), gen)
    saved = jax_run['saved']
    params = from_flax({'params': saved['params']})
    adam = saved['opt_state'].inner_state[1]
    mu, nu = from_flax({'params': adam.mu}), from_flax({'params': adam.nu})
    names = dict(trainer.model.named_parameters())
    assert names.keys() == params.keys()
    for name, p in names.items():
        st = trainer.optimizer.state[p]
        assert float(st['step']) == float(adam.count) == 2.0
        torch.testing.assert_close(p.detach(), params[name], rtol=0, atol=0)
        torch.testing.assert_close(st['exp_avg'], mu[name], rtol=0, atol=0)
        torch.testing.assert_close(st['exp_avg_sq'], nu[name], rtol=0, atol=0)
    for _ in range(3):
        trainer.step(jax_run['batch'], training=True, lr=LR)
    assert trainer.step_count == 5
    state = trainer.model.state_dict()
    for name, want in jax_run['after'].items():
        g = first[name].abs()
        firm = g > 1e-3 * g.max()
        diff = (state[name] - want).abs()
        assert float(diff[firm].max()) <= 0.2 * LR, name
        assert float(diff.max()) <= 2 * LR * 3, name


def test_jax_trainer_loads_save_flax(jax_run, tmp_path):
    """The port's ``save_flax`` after a JAX resume and one more step: the
    JAX ``Trainer.load`` restores it, every leaf equal to the port's state
    (rng: the key of seed + 1 in rbg's uint32 [4]), and its ``save`` writes
    the same bytes; then a JAX step runs on it."""
    trainer = _port_trainer(seed=4)
    trainer.load(jax_run['ckpt'])
    trainer.step(jax_run['batch'], training=True, lr=LR)
    path = tmp_path / 'port.ckpt'
    checkpoint.save_flax(trainer, path, epoch=2)
    assert json.loads(path.with_suffix('.ckpt.json').read_text()) == \
        {'epoch': 2}
    jtr = jax_run['trainer']
    assert jtr.load(path) == {'epoch': 2}
    names = dict(trainer.model.named_parameters())
    got = from_flax({'params': jax.tree_util.tree_map(np.asarray,
                                                      jtr.state.params)})
    adam = jtr.state.opt_state.inner_state[1]
    mu, nu = from_flax({'params': adam.mu}), from_flax({'params': adam.nu})
    for name, p in names.items():
        st = trainer.optimizer.state[p]
        torch.testing.assert_close(got[name], p.detach(), rtol=0, atol=0)
        torch.testing.assert_close(mu[name], st['exp_avg'], rtol=0, atol=0)
        torch.testing.assert_close(nu[name], st['exp_avg_sq'], rtol=0, atol=0)
    assert int(adam.count) == 3 and int(jtr.state.step) == 3
    assert int(jtr.state.opt_state.total_notfinite) == 0
    np.testing.assert_array_equal(
        np.asarray(jtr.state.rng),
        np.asarray(jax.random.key_data(jax.random.key(5, impl='rbg'))))
    # the JAX trainer writes the same state back byte for byte
    jtr.save(tmp_path / 'again.ckpt')
    assert (tmp_path / 'again.ckpt').read_bytes() == path.read_bytes()
    m = jtr.step(jax_run['batch'], training=True, lr=LR)
    assert np.isfinite(m['ctc_loss']) and int(jtr.state.step) == 4


@pytest.mark.parametrize('impl', ['threefry2x32', 'rbg', 'unsafe_rbg'])
def test_jax_key_data(impl):
    for seed in (0, 1, 1236, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            checkpoint.jax_key_data(seed, impl),
            np.asarray(jax.random.key_data(jax.random.key(
                np.uint32(seed), impl=impl))))


def test_train_resumes_a_jax_run(jax_run, tmp_path):
    """The twin's ``adopt_jax_run`` copies the JAX run's ``latest.ckpt``
    into the port's run folder; ``train()`` resumes from it at epoch 2 with
    the JAX step count and best LER, then writes its own format."""
    jax_dir = tmp_path / 'jax' / 'run'
    shutil.copytree(jax_run['ckpt'].parent, jax_dir)
    out = tmp_path / 'torch'
    copied = adopt_jax_run(jax_dir, out / 'run')
    assert {p.name for p in copied} == {'latest.ckpt', 'latest.ckpt.json'}
    trainer = _port_trainer()
    trainer.save_dir = out
    trainer.tensorboard = False
    history, _ = trainer.train(trainer.model, epochs=2, lr=LR,
                               model_name='run')
    assert len(history['ctc_loss']) == 1            # epoch 2 only
    assert trainer.step_count == 2 + trainer.data_train.steps
    assert (out / 'run' / 'latest.ckpt').read_bytes()[:2] == b'PK'
    assert adopt_jax_run(jax_dir, out / 'run') == []   # has its own now


def test_load_refuses_other_files(tmp_path):
    path = tmp_path / 'x.ckpt'
    path.write_bytes(b'\x00\x01')
    with pytest.raises(ValueError, match='neither'):
        _port_trainer().load(path)


def test_load_refuses_a_checkpoint_of_another_model(jax_run):
    loaders = get_dataloaders(DATA, batch_size=4, curriculum=())
    model = get_model(ARCH, use_rnn=False, data_norm=True, device='cpu',
                      **KW)
    trainer = Trainer(loaders, device='cpu').init_state(model)
    with pytest.raises(ValueError, match='missing.*unexpected'):
        trainer.load(jax_run['ckpt'])
