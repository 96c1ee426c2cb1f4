"""What the benchmark loads: nothing of JAX, flax, optax or the JAX
package anywhere, by top-level module name; nothing of the program in the
reference, nor in an architecture outside its ``build``."""

import ast
import pathlib
import subprocess
import sys

import pytest

from conftest import ROOT
from perfbench.run import FORBIDDEN

BENCH = ROOT / 'perfbench'
SOURCES = sorted(p for p in BENCH.rglob('*.py') if 'out' not in p.parts)


def _imports(path):
    """(top-level name, relative level) of every import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from ((a.name.split('.')[0], 0) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ((node.module or '').split('.')[0], node.level)


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_forbidden(path):
    names = {n for n, level in _imports(path) if level == 0}
    assert not names & set(FORBIDDEN)
    if 'reference' in path.relative_to(BENCH).parts:
        assert 'nbasr_torch' not in names and 'perfbench' not in names
        assert all(level <= 1 for _, level in _imports(path))


@pytest.mark.parametrize(
    'path', sorted((BENCH / 'archs').glob('*.py')),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_an_architecture_imports_the_program_only_in_build(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == 'build':
            inside |= {id(n) for n in ast.walk(node)}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)) and \
                id(node) not in inside:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ''])
            assert not {n.split('.')[0] for n in names} & {'nbasr_torch'}


def _loaded(code):
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_nothing_forbidden():
    code = ('import sys, time, torch\n'
            'sys.path.insert(0, "perfbench/tests")\n'
            'from conftest import overrides\n'
            'from perfbench import run\n'
            "r = run.run_cell('flagship.train', 5, 0.5, 0, "
            "torch.device('cpu'), overrides('train'), t0=time.perf_counter())\n"
            'print(run.forbidden_modules())\n')
    assert _loaded(code) == '[]'


def test_the_reference_loads_nothing_of_the_program():
    code = ('import sys, torch\n'
            'from perfbench.reference import batches, frontend, model\n'
            'from perfbench import archs\n'
            'cfg = dict(model="nas_bench_asr", '
            'arch_vec=[[0, 1], [2, 1, 0], [4, 0, 1, 1]], '
            'block_kernels=[8], block_strides=[1], block_filters=[8], '
            'cells_per_block=[1], cell_groups=4, rnn_units=3, num_classes=48, '
            'dropout=0.2)\n'
            'arch = archs.find(cfg)\n'
            'p = {n: torch.randn(s) * sd for n, s, sd, _ in '
            'arch.param_table(cfg)}\n'
            'x = frontend.log_mel(torch.randn(2, 4000))\n'
            'arch.forward(p, cfg, x, torch.tensor([20, 10]), '
            'model.load_stats(), torch.Generator().manual_seed(1))\n'
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'nbasr_torch', 'jax', 'jaxlib', 'flax', 'optax', 'nbasr_tpu'}))\n")
    assert _loaded(code) == '[]'
