"""The port's sweep orchestrator, static-info and latency passes, their CLI
commands and the entry points' dry run, on the CPU at small size, against
the JAX package: its unique architectures, its parameter and FLOP counts,
its ``from_folder`` on the port's files, and its resume log."""

import functools
import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import nbasr_tpu.parallel.sweep as jax_sweep
from nbasr_tpu import dataset as jax_dataset
from nbasr_tpu.models import count_params as jax_count_params
from nbasr_tpu.models import get_model as jax_get_model
from nbasr_tpu.models.asr import algorithmic_flops as jax_flops

from nbasr_torch import cli, dataset, entry
from nbasr_torch.parallel import sweep
from nbasr_torch.search_space import get_model_hash

ARCHS = [[[1, 0], [0, 0, 0], [1, 0, 0, 0]],
         [[0, 0], [1, 0, 1], [2, 0, 0, 1]]]
# tests/test_sweep.py:31's widths
TINY = dict(block_filters=(8, 8, 8, 8), cells_per_block=(1, 1, 1, 1),
            cell_groups=2, rnn_units=8, init_scheme='scaled')
#: seconds a spawned data-parallel job may take (~10 s alone)
SPAWN_TIMEOUT_S = 300


def test_unique_architectures_match_jax():
    got = sweep.unique_architectures(limit=50)
    want = jax_sweep.unique_architectures(limit=50)
    assert list(got.items()) == list(want.items())
    assert all(get_model_hash(a) == h for h, a in got.items())


def test_device_groups(monkeypatch):
    groups = sweep.device_groups(['cpu'] * 4, group_size=2)
    assert groups == [[torch.device('cpu')] * 2] * 2
    assert sweep.device_groups(['cpu'] * 3) == [[torch.device('cpu')] * 3]
    with pytest.raises(ValueError, match='group_size=3'):
        sweep.device_groups(['cpu'] * 4, group_size=3)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sweep.device_groups()            # the default is every card
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sweep.device_groups([0])


def _jax_static(arch, frames):
    model = jax_get_model(arch, use_rnn=False, **TINY)
    params = jax_count_params(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 80))))['params'])
    return params, jax_flops(model, 1, frames, train=False)


@pytest.mark.parametrize('group_size', [2, 1], ids=['spawned', 'threaded'])
def test_micro_sweep_round_trip(tmp_path, monkeypatch, group_size):
    """2 archs x 2 seeds x 2 epochs on ``synthetic:12`` over two CPU
    devices: one group of two (each job data-parallel in two spawned gloo
    processes) or two groups of one (a worker thread each).  Both
    packages' ``from_folder`` read the files; ``params`` and ``flops``
    equal the JAX package's counts."""
    monkeypatch.setattr(sweep, 'SPAWN_TIMEOUT_S', SPAWN_TIMEOUT_S)
    paths = sweep.run_sweep(ARCHS, seeds=(1, 2), data_root='synthetic:12',
                            out_dir=str(tmp_path), batch_size=4, epochs=2,
                            use_rnn=False, eval_decoder='greedy',
                            progress=False, group_size=group_size,
                            model_kwargs=TINY, devices=['cpu', 'cpu'])
    assert [p.name for p in paths] == ['nb-asr-e2-1.pickle',
                                       'nb-asr-e2-2.pickle']
    info = sweep.static_info_pass(ARCHS, out_dir=str(tmp_path), use_rnn=False,
                                  feature_frames=64, model_kwargs=TINY,
                                  device='cpu')
    assert info.exists()
    ours = dataset.from_folder(tmp_path, max_epochs=2,
                               include_static_info=True, devices=False)
    theirs = jax_dataset.from_folder(tmp_path, max_epochs=2,
                                     include_static_info=True, devices=False)
    for d in (ours, theirs):
        assert sorted(d.seeds) == [1, 2]
        for arch in ARCHS:
            for seed in (1, 2):
                row = d.full_info(arch, seed=seed)
                assert len(row['val_per']) == 2 and row['arch_vec'] == arch
                assert all(0 <= v <= 2 for v in row['val_per'])
            params, flops = _jax_static(arch, 64)
            assert d.params(arch) == params
            assert d.flops(arch) == flops


def _fake_train(calls, arch, seed, *args, **kwargs):
    calls.append((str(arch), seed))
    return [0.5, 0.4], 0.45


def _refuse_train(*args, **kwargs):
    raise AssertionError('a finished job was trained again')


def test_resume_replays_its_own_log(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(sweep, '_train_one',
                        functools.partial(_fake_train, calls))
    archs = list(sweep.unique_architectures(limit=2).values())
    kw = dict(seeds=(1, 2), data_root='synthetic:4', out_dir=str(tmp_path),
              epochs=2, progress=False, devices=['cpu'])
    paths = sweep.run_sweep(archs, **kw)
    assert len(calls) == 4 and (tmp_path / 'sweep-e2.jsonl').exists()
    first = [p.read_bytes() for p in paths]
    for p in paths:                 # a crash before the final write
        p.unlink()
    monkeypatch.setattr(sweep, '_train_one', _refuse_train)
    paths = sweep.run_sweep(archs, **kw)
    assert [p.read_bytes() for p in paths] == first
    info = dataset.from_folder(tmp_path, max_epochs=2, seeds=[1, 2],
                               devices=False).full_info(archs[0], seed=1)
    assert info['val_per'] == [0.5, 0.4] and info['test_per'] == 0.45
    # the JAX sweep replays the port's log
    for p in paths:
        p.unlink()
    monkeypatch.setattr(jax_sweep, '_train_one', _refuse_train)
    jax_sweep.run_sweep(archs, seeds=(1, 2), data_root='synthetic:4',
                        out_dir=str(tmp_path), epochs=2, progress=False)
    assert [p.read_bytes() for p in paths] == first


def test_resume_replays_a_jax_log(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(jax_sweep, '_train_one',
                        functools.partial(_fake_train, calls))
    archs = list(sweep.unique_architectures(limit=2).values())
    jax_paths = jax_sweep.run_sweep(archs, seeds=(1, 2),
                                    data_root='synthetic:4',
                                    out_dir=str(tmp_path), epochs=2,
                                    progress=False)
    assert len(calls) == 4
    want = [pathlib.Path(p).read_bytes() for p in jax_paths]
    monkeypatch.setattr(sweep, '_train_one', _refuse_train)
    paths = sweep.run_sweep(archs, seeds=(1, 2), data_root='synthetic:4',
                            out_dir=str(tmp_path), epochs=2, progress=False,
                            devices=['cpu'])
    assert [p.read_bytes() for p in paths] == want


def test_benchmark_pass_writes_a_latency_table(tmp_path, monkeypatch):
    """On the CPU (asked for), under the ``cpu-fp32`` key; the file is read
    by both packages' ``from_folder(devices=...)``."""
    monkeypatch.setattr(sweep, '_train_one',
                        functools.partial(_fake_train, []))
    sweep.run_sweep(ARCHS, seeds=(1,), out_dir=str(tmp_path), epochs=2,
                    progress=False, devices=['cpu'])
    path = sweep.benchmark_pass(ARCHS, out_dir=str(tmp_path), device='cpu',
                                feature_frames=64, repeats=2, use_rnn=False)
    assert path.name == 'nb-asr-bench-cpu-fp32.pickle'
    for d in (dataset.from_folder(tmp_path, max_epochs=2,
                                  devices=['cpu-fp32']),
              jax_dataset.from_folder(tmp_path, max_epochs=2,
                                      devices=['cpu-fp32'])):
        for arch in ARCHS:
            (latency,) = d.latency(arch, devices='cpu-fp32')
            assert 0 < latency[0] < 60
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sweep.benchmark_pass(ARCHS, out_dir=str(tmp_path))


def test_cli_sweep_info_benchpass_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The CLI's three commands with ``--device cpu`` (the models cut to
    the test's widths), exit 0 and their files written."""
    for name in ('run_sweep', 'static_info_pass', 'benchmark_pass'):
        extra = dict(model_kwargs=TINY) if name != 'benchmark_pass' else \
            dict(feature_frames=64, repeats=2)
        monkeypatch.setattr(sweep, name,
                            functools.partial(getattr(sweep, name), **extra))
    out = str(tmp_path)
    cli.main(['sweep', '--archs', '1', '--seeds', '1234', '--data',
              'synthetic:8', '--epochs', '1', '--batch_size', '4',
              '--decoder', 'greedy', '--device', 'cpu', '--out', out])
    cli.main(['info', '--archs', '2', '--device', 'cpu', '--out', out])
    cli.main(['benchpass', '--archs', '2', '--device', 'cpu', '--out', out])
    printed = [w for w in capsys.readouterr().out.split()
               if w.endswith('.pickle')]
    assert [pathlib.Path(p).name for p in printed] == [
        'nb-asr-e1-1234.pickle', 'nb-asr-info.pickle',
        'nb-asr-bench-cpu-fp32.pickle']
    d = dataset.from_folder(tmp_path, max_epochs=1, include_static_info=True,
                            devices=['cpu-fp32'])
    arch = list(sweep.unique_architectures(1).values())[0]
    assert len(d.full_info(arch)['val_per']) == 1
    assert d.params(arch) > 0 and d.latency(arch, devices='cpu-fp32')


def test_entry_forward_and_dryrun(monkeypatch, capsys):
    fn, args = entry.entry(device='cpu')
    logits = fn(*args)
    assert logits.shape[:1] == (2,) and logits.shape[-1] == 49
    assert bool(torch.isfinite(logits).all())
    # two processes: tp=2, as the JAX package's dry run takes it
    train, evaluation = entry.dryrun_multichip(
        2, model_kwargs=TINY, timeout=SPAWN_TIMEOUT_S)
    assert np.isfinite(train['ctc_loss']) and np.isfinite(evaluation['ler'])
    assert 'mesh {data: 1, model: 2}' in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        entry.entry()
