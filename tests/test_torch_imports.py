"""Import hygiene of the port: nbasr_torch and chip_smoke.py import neither
JAX, flax, msgpack nor the JAX package, and the port's entry points
default to the card."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / 'nbasr_torch'
FORBIDDEN = ('jax', 'flax', 'msgpack', 'nbasr_tpu')


def _modules():
    for path in sorted(PKG.rglob('*.py')):
        parts = path.relative_to(ROOT).with_suffix('').parts
        yield '.'.join(parts[:-1] if parts[-1] == '__init__' else parts)


def test_every_module_imports_without_jax():
    mods = list(_modules())
    assert {'nbasr_torch.serving', 'nbasr_torch.ops.fused_cell',
            'nbasr_torch.training.trainer', 'nbasr_torch.training.loss',
            'nbasr_torch.training.metrics', 'nbasr_torch.train',
            'nbasr_torch.ops.ctc', 'nbasr_torch.ops.edit_distance',
            'nbasr_torch.ops.ctc_pallas', 'nbasr_torch.ops.decode',
            'nbasr_torch.utils.tbwriter',
            'nbasr_torch.data.pipeline', 'nbasr_torch.data.phonemes',
            'nbasr_torch.data.timit', 'nbasr_torch.utils',
            'nbasr_torch.search_space', 'nbasr_torch.graph_utils',
            'nbasr_torch.dataset', 'nbasr_torch.search', 'nbasr_torch.cli',
            'nbasr_torch.version', 'nbasr_torch.models.proxies',
            'nbasr_torch.checkpoint', 'nbasr_torch.quant'} <= set(mods)
    code = ('import importlib, sys\n'
            f'for m in {mods!r}: importlib.import_module(m)\n'
            f'print(sorted(m for m in sys.modules '
            f'if m.split(".")[0] in {FORBIDDEN!r}))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == '[]', out.stdout


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py'],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_entry_points_default_to_the_card(monkeypatch):
    from nbasr_torch.models.asr import get_model
    from nbasr_torch.serving import StreamingASR
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    arch = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
    small = dict(block_kernels=(4,), block_strides=(1,), block_filters=(16,),
                 cells_per_block=(1,), cell_groups=4, rnn_units=8)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        get_model(arch, **small)
    model = get_model(arch, device='cpu', **small)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        StreamingASR(model, chunk_frames=8)
    with torch.no_grad():      # on the CPU, asked for, it runs
        s = StreamingASR(model, chunk_frames=8, device='cpu')
        s.push(np.zeros(4000, np.float32))
        assert s.flush()
    from nbasr_torch.data.pipeline import get_dataloaders
    from nbasr_torch.train import main
    from nbasr_torch.training import Trainer
    loaders = get_dataloaders('synthetic:4', batch_size=2, curriculum=())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer(loaders)
    Trainer(loaders, device='cpu').init_state(model)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main(['1', '0', '1', '0', '0', '1', '0', '0', '0', '--data',
              'synthetic:4'])
