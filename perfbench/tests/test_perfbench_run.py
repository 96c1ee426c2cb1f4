"""Each mix end to end on the CPU at a reduced width: the result line's
keys, a sound run reads ``correct``, every planted fault reads not
correct, and a run without a card prints no result."""

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, overrides
from perfbench import faults, run

KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device'}
CELLS = [('flagship.train', 'train'), ('linear-dilated.train', 'train'),
         ('flagship.serve', 'serve'), ('linear-dilated.serve', 'serve')]
CPU = torch.device('cpu')


def _run(cell, kind, trace=0, seed=2 ** 31 + 17):
    return run.run_cell(cell, seed, 1.0, trace, CPU, overrides(kind),
                        t0=time.perf_counter())


@pytest.mark.parametrize('cell,kind', CELLS)
def test_sound_run_is_correct_and_well_formed(cell, kind):
    r = _run(cell, kind)
    assert KEYS <= set(r) and list(r)[-2] == 'checks', list(r)
    assert r['correct'], r['checks']
    assert r['attempted'] > 0 and r['failed'] == 0
    _, _, _, limits, e2e, _ = run.cell_spec(cell)
    assert set(r['metrics']) == {m['name'] for m in e2e}
    assert set(r['checks']) == set(limits)
    for m in r['metrics'].values():
        assert math.isfinite(m['value']) and m['value'] > 0
    assert set(r['device']) == {'platform', 'kind', 'count',
                                'memory_peak_bytes'}
    json.dumps(r)


@pytest.mark.parametrize('cell,kind', CELLS[::2])
def test_traced_run_reads_the_layers(cell, kind):
    r = _run(cell, kind, trace=1)
    assert r['correct']
    assert {'busy_s', 'window_s'} <= set(r['device'])
    assert set(r['breakdown']) == {'device_ops', 'idle_gaps'}
    # no device here: only the unprofiled stretch has anything to read
    want = {'train': {'mfu.train'}, 'serve': {'mfu.serve', 'serve_step_p95_ms'}}
    assert set(r['metrics']) == want[kind]


@pytest.mark.parametrize('cell,kind,fault', [
    (c, k, f) for c, k in CELLS for f in faults.FAULTS[k]])
def test_planted_fault_is_not_correct(cell, kind, fault):
    with faults.planted(kind, fault):
        r = _run(cell, kind)
    assert not r['correct'], r['checks']


def test_no_card_no_result():
    code = ('import sys, torch\n'
            'torch.cuda.is_available = lambda: False\n'
            'from perfbench import run\n'
            "sys.exit(run.main(['--workload', 'flagship.train', '--seed', "
            "'1', '--seconds', '1']))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ''


def test_checkout_without_the_port_fails(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ has no
    program: the run exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'perfbench', tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('out', '__pycache__'))
    code = ('import sys, torch\n'
            'torch.cuda.is_available = lambda: True\n'
            'torch.cuda.device_count = lambda: 1\n'
            'from perfbench import run\n'
            "sys.exit(run.main(['--workload', 'flagship.train', '--seed', "
            "'1', '--seconds', '1']))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '{' not in out.stdout


@pytest.mark.card
def test_cells_run_on_the_card(card):
    for cell, _ in CELLS:
        out = subprocess.run(
            [sys.executable, '-m', 'perfbench.run', '--workload', cell,
             '--seed', '3000000019', '--seconds', '5', '--trace', '0'],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])['correct']


@pytest.mark.parametrize('shapes,n', [
    ([(64, 1), (64, 1), (48, 2)], 3),
    ([(64, 1), (64, 1), (64, 1), (64, 1), (48, 2)], 5),
    ([(48, 2), (64, 1), (48, 2), (48, 2)], 3),
    ([(64, 1)] * 8, 8),
    ([(64, 1)] * 4, None),
])
def test_checked_steps_cover_every_bucket_shape(shapes, n):
    from perfbench.drivers import train
    assert train.checked_steps(shapes, 2) == n


def test_window_parts_and_profiled_pace():
    from perfbench import common
    marks = [(1.0, 10.0), (2.5, 20.0), (9.9, 50.0)]
    assert common.by_parts(marks, 0.0, 10.0) == '5.0 5.0 0.0 0.0 15.0'
    note = common.profiled_pace(0.2, 0.22, 0.4)
    assert 'x1.100' in note and 'x2.000' in note


def test_stream_knows_its_place_in_the_epoch():
    from nbasr_torch.data.pipeline import ArrayDataset, Loader
    from perfbench import traffic
    from perfbench.drivers import train
    mix = {**json.loads((ROOT / 'perfbench' / 'mixes' / 'timit-recipe.json')
                        .read_text()), 'utterances': 40}
    audio, labels = traffic.deck(mix, 5)
    loader = Loader(ArrayDataset(audio, labels), 8, bucket_batch_caps=(8, 6),
                    shuffle=True, seed=5)
    it = train._Stream(loader)
    assert len(list(loader)) == it.per_epoch
    assert it.left_in_epoch() == 0
    next(it)
    assert it.left_in_epoch() == it.per_epoch - 1
    for _ in range(it.per_epoch):
        next(it)
    assert it.left_in_epoch() == it.per_epoch - 1
