"""ctypes bindings of the port's native host runtime
(``nbasr_torch/csrc/nbasr_native.cpp``), the counterpart of
``nbasr_tpu/native.py`` with its functions and signatures:

  - :func:`parse_wav`   — the fast path of ``data.timit.read_wav``,
  - :func:`levenshtein` — a host oracle for ``ops.edit_distance``,
  - :func:`beam_search` — a host CTC prefix beam search (ctcdecode's).

The library is built with ``g++ -O3 -march=native`` at first use into
``build/nbasr_torch/`` (git-ignored), named by a hash of the source and the
flags as the CUDA libraries are (:mod:`nbasr_torch.ops._build`), under the
same lock.  This is host code, not a device kernel: where g++ or the build
is missing, :func:`available` is false and the functions return None, and
every caller keeps its pure-Python path.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

from .ops import _build

__all__ = ['available', 'parse_wav', 'levenshtein', 'beam_search',
           'GXX_FLAGS']

_SRC = pathlib.Path(__file__).resolve().parent / 'csrc' / 'nbasr_native.cpp'
GXX_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-std=c++17')
_lib = None
_tried = False


def _target():
    digest = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    return _build.BUILD_DIR / f'libnbasr_native_{digest.hexdigest()[:16]}.so'


def _build_lib(target):
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(
        f'{target.name}.{os.getpid()}.{threading.get_ident()}.tmp')
    subprocess.run(['g++', *GXX_FLAGS, str(_SRC), '-o', str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, target)


def _declare(lib):
    i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    lib.parse_wav_info.restype = ctypes.c_int
    lib.parse_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.parse_wav_fill.restype = ctypes.c_int
    lib.parse_wav_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64, f32p]
    lib.levenshtein_batch.restype = None
    lib.levenshtein_batch.argtypes = [
        i32p, i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, f32p]
    lib.ctc_beam_search.restype = None
    lib.ctc_beam_search.argtypes = [
        f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p]
    return lib


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _build.LOCK:
        if _lib is not None or _tried:
            return _lib
        try:
            target = _target()
            if not target.exists():
                _build_lib(target)
            _lib = _declare(ctypes.CDLL(str(target)))
        except (OSError, subprocess.CalledProcessError):
            _lib = None          # no g++ or a failed build: the Python paths
        _tried = True
        return _lib


def available():
    """True when the native library is built and loadable."""
    return _load() is not None


def parse_wav(data):
    """bytes (RIFF or SPHERE) -> (float32 audio in [-1, 1], sample rate).

    Raises ValueError on malformed input; returns None where the library is
    unavailable (callers then use the Python parser)."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    rate = ctypes.c_int32()
    rc = lib.parse_wav_info(data, len(data), ctypes.byref(n),
                            ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f'Malformed wav data (native rc={rc})')
    out = np.empty(n.value, np.float32)
    rc = lib.parse_wav_fill(data, len(data), out)
    if rc != 0:
        raise ValueError(f'Malformed wav data (native rc={rc})')
    return out, rate.value


def levenshtein(hyp, hyp_len, ref, ref_len):
    """Batched edit distance on the host: ``[B]`` float32, or None where the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    hyp = np.ascontiguousarray(hyp, np.int32)
    ref = np.ascontiguousarray(ref, np.int32)
    hyp_len = np.ascontiguousarray(hyp_len, np.int32)
    ref_len = np.ascontiguousarray(ref_len, np.int32)
    B, M = hyp.shape
    N = ref.shape[1]
    if not (hyp_len.shape == ref_len.shape == (B,) and ref.shape[0] == B
            and (hyp_len <= M).all() and (ref_len <= N).all()
            and (hyp_len >= 0).all() and (ref_len >= 0).all()):
        raise ValueError('levenshtein: lengths must be [B] within the '
                         'padded widths')
    out = np.empty(B, np.float32)
    lib.levenshtein_batch(hyp, hyp_len, ref, ref_len, B, M, N, out)
    return out


def beam_search(log_probs, logit_len=None, beam_width=12, blank=0,
                max_len=None):
    """Host CTC prefix beam search.

    ``log_probs``: ``[T, V]`` (one utterance) or ``[B, T, V]``.  Returns
    (labels, lengths) with labels 0-padded, or None where the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    lp = np.ascontiguousarray(log_probs, np.float32)
    squeeze = lp.ndim == 2
    if squeeze:
        lp = lp[None]
        logit_len = [lp.shape[1]] if logit_len is None else [int(logit_len)]
    elif logit_len is None:
        logit_len = [lp.shape[1]] * lp.shape[0]
    B, T, V = lp.shape
    if any(not 0 <= int(n) <= T for n in logit_len) or len(logit_len) != B:
        raise ValueError(f'beam_search: logit_len must be {B} lengths in '
                         f'[0, {T}]')
    max_len = max_len or T
    labels = np.zeros((B, max_len), np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        out_len = np.zeros(1, np.int32)
        row = np.ascontiguousarray(lp[b, :int(logit_len[b])])
        lib.ctc_beam_search(row, int(logit_len[b]), V, beam_width, blank,
                            max_len, labels[b], out_len)
        lengths[b] = out_len[0]
    if squeeze:
        return labels[0], int(lengths[0])
    return labels, lengths
