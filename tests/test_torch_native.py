"""The port's native host runtime (``nbasr_torch/native.py``, its own copy
of the C++ source) against its Python paths and the JAX package's native
module, and the thread safety of the port's library builds and launch
counters."""

import os
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nbasr_tpu import native as jax_native

from nbasr_torch import native
from nbasr_torch.data import timit
from nbasr_torch.ops import _build, ctc_pallas, fused_cell
from nbasr_torch.ops.decode import beam_search_decode
from nbasr_torch.ops.edit_distance import edit_distance
from tests.test_pipeline import _write_riff, _write_sphere


@pytest.fixture(scope='module')
def built():
    """The port's library, built here with g++ (host code: where the
    toolchain is missing the port keeps its Python paths)."""
    if not native.available():
        pytest.skip('g++ cannot build the native runtime here')
    return native


def _wav(tmp_path, kind, seed):
    rng = np.random.RandomState(seed)
    audio = (np.sin(np.linspace(0, 300, 8000)) * 0.7
             + rng.randn(8000) * 0.05).astype(np.float32)
    path = tmp_path / f'{kind}.WAV'
    (_write_riff if kind == 'riff' else _write_sphere)(path, audio)
    return path


@pytest.mark.parametrize('kind', ['riff', 'sphere'])
def test_parse_wav_matches_python_and_jax(built, tmp_path, kind):
    path = _wav(tmp_path, kind, seed=3 if kind == 'riff' else 4)
    data = path.read_bytes()
    got, rate = built.parse_wav(data)
    want, want_rate = timit.read_wav(path, use_native=False)
    assert rate == want_rate == 16000 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if jax_native.available():
        jax_audio, jax_rate = jax_native.parse_wav(data)
        assert jax_rate == rate
        np.testing.assert_array_equal(got, jax_audio)


def test_read_wav_takes_the_native_path(built, tmp_path, monkeypatch):
    path = _wav(tmp_path, 'sphere', seed=5)
    calls = []
    parse = built.parse_wav
    monkeypatch.setattr(built, 'parse_wav',
                        lambda data: calls.append(len(data)) or parse(data))
    got, _ = timit.read_wav(path)
    assert calls == [path.stat().st_size]
    np.testing.assert_allclose(got, timit.read_wav(path, use_native=False)[0],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize('data', [b'this is not a wav file at all..',
                                  b'RIFF' + bytes(60), b'NIST_1A' + bytes(10)],
                         ids=['text', 'riff-without-chunks', 'short-sphere'])
def test_parse_wav_rejects_garbage(built, data):
    with pytest.raises(ValueError):
        built.parse_wav(data)


def test_levenshtein_matches_edit_distance(built):
    rng = np.random.RandomState(3)
    B, M, N = 16, 20, 16
    hyp = rng.randint(1, 6, size=(B, M)).astype(np.int32)
    ref = rng.randint(1, 6, size=(B, N)).astype(np.int32)
    hyp_len = rng.randint(0, M + 1, size=B).astype(np.int32)
    ref_len = rng.randint(0, N + 1, size=B).astype(np.int32)
    hyp_len[0] = ref_len[1] = 0
    got = built.levenshtein(hyp, hyp_len, ref, ref_len)
    want = edit_distance(*map(torch.as_tensor, (hyp, hyp_len, ref, ref_len)))
    np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(ValueError):
        built.levenshtein(hyp, hyp_len + M, ref, ref_len)


@pytest.mark.parametrize('seed,B,T,V,width', [(4, 3, 12, 6, 8),
                                              (5, 4, 30, 49, 12)])
def test_beam_search_matches_device_decoder(built, seed, B, T, V, width):
    """The host prefix beam search against the port's beam_search_decode,
    id for id (the JAX package's pair, ``tests/test_native.py``), with
    shorter rows too."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, V) * 3).astype(np.float32)
    lens = np.array([T] + [T - 1 - b for b in range(1, B)], np.int32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels, lengths = built.beam_search(lp, lens, beam_width=width)
    d_labels, d_lens = beam_search_decode(torch.as_tensor(logits),
                                          torch.as_tensor(lens),
                                          beam_width=width)
    for b in range(B):
        assert labels[b, :lengths[b]].tolist() == \
            d_labels[b, :int(d_lens[b])].tolist()


def test_beam_search_single_utterance(built):
    lp = np.log(np.array([[0.35, 0.4, 0.25]] * 2, np.float32))
    labels, length = built.beam_search(lp, beam_width=4)
    assert labels[:length].tolist() == [1]


# ---------------------------------------------------------------------------
# builds and launch counters under threads
# ---------------------------------------------------------------------------

def _race(fn, threads=8):
    """Run ``fn`` on ``threads`` threads started together, the interpreter
    switching threads every microsecond; returns their results."""
    out, errors = [None] * threads, []
    start = threading.Barrier(threads)

    def run(i):
        start.wait()
        try:
            out[i] = fn()
        except Exception as e:          # reported by the assert below
            errors.append(e)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(saved)
    assert not errors, errors
    return out


def test_load_builds_once_under_threads(monkeypatch, tmp_path):
    """8 threads reach ``load`` of one library together: its build runs
    once and every thread gets the same handle."""
    builds = []

    def slow_build(names):
        builds.append(names)
        time.sleep(0.2)
        return {n: (tmp_path / f'lib{n}.so', '') for n in names}

    monkeypatch.setattr(_build, 'build', slow_build)
    monkeypatch.setattr(_build, '_LIBS', {})
    monkeypatch.setattr(_build.ctypes, 'CDLL', lambda path: object())
    handles = _race(lambda: _build.load('stub'))
    assert builds == [('stub',)]
    assert all(h is handles[0] for h in handles)


def test_native_builds_once_under_threads(monkeypatch, tmp_path):
    """The native library shares the lock: 8 threads, one g++ build."""
    builds = []

    def slow_build(target):
        builds.append(target)
        time.sleep(0.2)

    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_tried', False)
    monkeypatch.setattr(native, '_target', lambda: tmp_path / 'libx.so')
    monkeypatch.setattr(native, '_build_lib', slow_build)
    monkeypatch.setattr(native.ctypes, 'CDLL', lambda path: object())
    monkeypatch.setattr(native, '_declare', lambda lib: lib)
    handles = _race(native._load)
    assert builds == [tmp_path / 'libx.so']
    assert all(h is handles[0] and h is not None for h in handles)


def test_build_names_its_temporary_file_by_process_and_thread(
        monkeypatch, tmp_path):
    """A build writes ``<target>.<pid>.<thread id>.tmp`` and renames it:
    no two threads of one process share a temporary file (the nvcc command
    line is read, not run)."""
    outputs = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            outputs.append((cmd[cmd.index('-o') + 1], threading.get_ident()))
            open(outputs[-1][0], 'w').close()

        def poll(self):
            return 0

    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(_build, '_nvcc', lambda: 'nvcc')
    monkeypatch.setattr(_build.subprocess, 'Popen', FakeProc)
    monkeypatch.setattr(_build, '_target',
                        lambda name: tmp_path / f'lib{name}.so')
    out = _race(lambda: _build.build(('fused_cell',)), threads=2)
    assert len(outputs) == 1        # the other thread found it built
    tmp, ident = outputs[0]
    assert tmp == f'{tmp_path}/libfused_cell.so.{os.getpid()}.{ident}.tmp'
    assert [o['fused_cell'][0] for o in out] == [tmp_path / 'libfused_cell.so'] * 2
    assert not pathlib.Path(tmp).exists()


def test_launch_counts_are_exact_under_threads():
    """4 threads of plain calls: the counters add up exactly."""
    g = torch.Generator().manual_seed(0)
    em = torch.randn((3, 1, 5), generator=g)
    skip = torch.tensor([[False, False, True, False, True]])
    final = torch.tensor([[False, False, False, True, True]])
    x = torch.randn((1, 6, 4), generator=g)
    spec = fused_cell.FusedCellSpec([fused_cell.LinearNode((0,))],
                                    use_norm=False)
    weights = [torch.randn((4, 4), generator=g), torch.zeros(4)]
    calls = 40

    def work():
        for _ in range(calls):
            ctc_pallas.alpha_scan_reference(em, skip)
            ctc_pallas.beta_scan_reference(em, skip, final)
            _, outs, mults = fused_cell.fused_cell_reference(
                spec, x, weights, None, save=True)
            fused_cell.fused_cell_backward_reference(
                spec, x, outs, mults, torch.ones_like(x), weights, None)

    ctc_pallas.reset_launches()
    fused_cell.reset_launches()
    _race(work, threads=4)
    n = 4 * calls
    assert ctc_pallas.LAUNCHES == {'alpha': {'kernel': 0, 'plain': n},
                                   'beta': {'kernel': 0, 'plain': n}}
    assert fused_cell.LAUNCHES == {'kernel': 0, 'plain': n}
    assert fused_cell.BACKWARD_LAUNCHES == {'kernel': 0, 'plain': n}
