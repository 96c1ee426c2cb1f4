"""Tensor parallelism's gradient gap at full width, on the CPU: the
flagship's block 3 (C=1200, 100 channel-parallel groups, T=75, six
cells, then the LSTM and head) at tp=2 on two gloo ranks against one
process, in float32 and in float64, and one process's float32 against
its float64.

The plain cell path computes in f32 by construction, so the float64 run
takes a copy of the package, in a temporary directory, with every f32
cast and dtype made f64 and float64 the default dtype.  Agreement to
~1e-14 in float64 says tensor parallelism computes the same function, so
a float32 gap is the float32 rounding of a badly conditioned gradient;
a gap in float64 too would be a fault.  The loss is ``Σ w·logits`` in
training mode (dropout 0.2 on the same masks on both sides).

    python -m nbasr_torch.tools.tp_gap [--json]
"""

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
KW = dict(block_kernels=(8,), block_strides=(1,), block_filters=(1200,),
          cells_per_block=(6,), cell_groups=100, use_rnn=True,
          dropout_rate=0.2, cell_dropout=0.2, init_scheme='scaled')
B, T = 4, 75


def _build(dtype):
    from ..models.asr import get_model
    torch.set_default_dtype(dtype)
    model = get_model(ARCH, device='cpu', compute_dtype=dtype,
                      generator=torch.Generator().manual_seed(0), **KW)
    return model.to(dtype)


def _grads(model, dtype, tp=False):
    model.train()
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(B, T, 80)).to(dtype)
    w = torch.as_tensor(rng.randn(B, T, 49)).to(dtype)
    logits = model(x, torch.full((B,), T),
                   generator=torch.Generator().manual_seed(7))
    (w * logits.to(dtype)).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    if tp:
        from ..parallel import tensor
        tensor.sum_sliced_grads(model)
        grads = tensor.gather_named(model, grads)
    return {n: g.detach().numpy().copy() for n, g in grads.items()}


def _rank(rank, world, device, dtype):
    from ..parallel import make_mesh, tensor
    model = tensor.tensor_parallel(_build(dtype), make_mesh(dp=1, tp=world))
    cells = sum(isinstance(m, tensor.ChannelCell) for m in model.modules())
    if cells != 6:
        raise RuntimeError(f'{cells} channel-parallel cells, not 6')
    return _grads(model, dtype, tp=True)


def _shares(got, want):
    return {n: float(np.abs(got[n] - w).max())
            / max(float(np.abs(w).max()), 1e-300) for n, w in want.items()}


def _worst(shares, k=3):
    return sorted(shares.items(), key=lambda kv: -kv[1])[:k]


def measure(dtype, out):
    """One process's and the two ranks' gradients in ``dtype``, into
    ``out`` (an ``.npz`` path)."""
    from ..parallel import mesh
    one = _grads(_build(dtype), dtype)
    two = mesh.spawn(_rank, ['cpu', 'cpu'], (dtype,), timeout=900)[0]
    np.savez(out, **{f'one/{n}': v for n, v in one.items()},
             **{f'two/{n}': v for n, v in two.items()})


def _f64_copy(root):
    """The package under ``root`` with its f32 casts and dtypes made f64."""
    src = pathlib.Path(__file__).resolve().parents[1]
    dst = pathlib.Path(root, 'nbasr_torch')
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns('__pycache__'))
    for path in dst.rglob('*.py'):
        text = path.read_text()
        path.write_text(text.replace('.float()', '.double()')
                        .replace('torch.float32', 'torch.float64'))
    return root


def _load(path):
    with np.load(path) as z:
        return ({k[4:]: z[k] for k in z.files if k.startswith('one/')},
                {k[4:]: z[k] for k in z.files if k.startswith('two/')})


def main(argv=None):
    p = argparse.ArgumentParser(prog='python -m nbasr_torch.tools.tp_gap')
    p.add_argument('--json', action='store_true')
    p.add_argument('--measure', choices=('float32', 'float64'))
    p.add_argument('--out')
    args = p.parse_args(argv)
    if args.measure:
        return measure(getattr(torch, args.measure), args.out)
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = _f64_copy(pathlib.Path(tmp, 'f64'))
        runs = {}
        for dtype, path in (('float32', None), ('float64', root)):
            out = str(pathlib.Path(tmp, f'{dtype}.npz'))
            env = dict(os.environ)
            if path is not None:
                env['PYTHONPATH'] = str(path)
            subprocess.run([sys.executable, '-m', 'nbasr_torch.tools.tp_gap',
                            '--measure', dtype, '--out', out],
                           cwd=path, env=env, check=True, timeout=1800)
            runs[dtype] = _load(out)
    for dtype, (one, two) in runs.items():
        sh = _shares(two, one)
        readings[f'tp2_vs_one_{dtype}'] = _worst(sh)
    readings['one_f32_vs_f64'] = _worst(_shares(runs['float32'][0],
                                                runs['float64'][0]))
    for k, v in readings.items():
        print(k, ', '.join(f'{n} {s:.3e}' for n, s in v))
    if args.json:
        print(json.dumps(readings))
    return readings


if __name__ == '__main__':
    main()
