"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) at first use into
``build/nbasr_torch/`` beside the package (listed in ``.gitignore``).  The
file name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  :func:`build` starts one
``nvcc`` per source, all at once.  :data:`LOCK` serialises building and
loading across threads (a threaded sweep's trainers reach :func:`load` on
their first step together), and each build writes its own temporary file.

A missing ``nvcc`` or a failed build raises; nothing falls back.

The port's Triton kernel (``ops/hash_dropout.py``) is compiled by Triton at
its first launch; :func:`triton` imports it with its cache in
``build/triton/`` beside the package, unless ``TRITON_CACHE_DIR`` names
another place.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ['build', 'load', 'function', 'check', 'count_launch', 'triton',
           'BUILD_DIR', 'NVCC_FLAGS', 'LOCK', 'TRITON_KERNELS']

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'nbasr_torch'
#: The Triton kernels' names, as the profiler shows them.
TRITON_KERNELS = ('nbasr_hash_dropout',)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS = {}
#: Held while a library is built or loaded (reentrant: :func:`load` builds).
LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


def count_launch(counts, key):
    """``counts[key] += 1`` under a lock: the kernels' launch counters are
    read as exact counts of runs that launch from several threads."""
    with _COUNT_LOCK:
        counts[key] += 1


def _nvcc():
    path = shutil.which('nvcc')
    if path is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        path = '/usr/local/cuda/bin/nvcc'
    if path is None:
        raise RuntimeError('nvcc not found: the CUDA toolkit is needed to '
                           'build the kernels in nbasr_torch/csrc')
    return path


def _target(name):
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob('*.cu*')):     # the source and shared headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'


def build(names=('fused_cell', 'fused_cell_bwd', 'grouped_conv', 'ctc',
                 'lstm', 'relpos_attention')):
    """Compile ``csrc/<name>.cu`` for each name not built yet, in parallel.

    Returns ``{name: (path, compiler log)}``; the log starts with the
    seconds that library's nvcc took and holds ptxas's register and
    shared-memory report, empty for a library found already built.
    """
    with LOCK:
        return _build_locked(names)


def _build_locked(names):
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = (target, '')
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(
            f'{target.name}.{os.getpid()}.{threading.get_ident()}.tmp')
        log = tmp.with_suffix('.log')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(_CSRC / f'{name}.cu')]
        with open(log, 'w') as f:       # a file: ptxas's report may fill a pipe
            procs[name] = (target, tmp, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT))
    failed = []
    while procs:
        done = [n for n, (*_, proc) in procs.items() if proc.poll() is not None]
        if not done:
            time.sleep(0.05)
            continue
        secs = time.perf_counter() - t0
        for name in done:
            target, tmp, log, proc = procs.pop(name)
            text = log.read_text()
            log.unlink()
            if proc.returncode:
                failed.append(f'{name}: nvcc exited {proc.returncode}\n{text}')
                continue
            os.replace(tmp, target)
            out[name] = (target, f'compiled in {secs:.1f} s\n{text}')
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return out


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``'s library, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with LOCK:
            if name not in _LIBS:
                path, _ = build((name,))[name]
                _LIBS[name] = ctypes.CDLL(str(path))
            lib = _LIBS[name]
    return lib


def function(name, fn_name, argtypes, restype=ctypes.c_int):
    """``fn_name`` of ``csrc/<name>.cu``'s library with its ctypes signature
    set before its first call (an unset ``argtypes`` would pass every
    pointer as a 32-bit int)."""
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def check(err, name, what):
    """Raise if ``err``, a cudaError_t returned by ``csrc/<name>.cu``."""
    if err:
        message = function(name, 'nbasr_cuda_error_string', [ctypes.c_int],
                           ctypes.c_char_p)(err)
        raise RuntimeError(f'{what} kernel launch failed: {message.decode()}')


def triton():
    """``(triton, triton.language)``, imported on first use with Triton's
    cache under ``build/triton/`` (a module of the port never imports
    Triton when it is itself imported: the CPU has none)."""
    os.environ.setdefault('TRITON_CACHE_DIR',
                          str(BUILD_DIR.parent / 'triton'))
    import triton as triton_mod
    import triton.language as tl
    return triton_mod, tl
