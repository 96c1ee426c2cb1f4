"""Architectures found by name: every configuration's ``model`` gives the
whole interface; NAS-Bench-ASR's module reads, bit for bit, what the
harness read before the architecture had a module of its own; and a
second architecture (``toy_mlp.py``, handed in as a configuration's
``model``) runs a training cell end to end with no harness file edited."""

import hashlib
import json
import time

import numpy as np
import pytest
import torch

import toy_mlp
from conftest import MIXES, ROOT, SMALL
from perfbench import archs, faults, run, traffic, weights
from perfbench.drivers import train as train_driver
from perfbench.reference import frontend as fe
from perfbench.reference import model as ref

CPU = torch.device('cpu')
SEED = 2 ** 31 + 17
INTERFACE = ('build', 'param_table', 'forward', 'regularised',
             'algorithmic_flops', 'output_stride', 'halo')

#: read before the move, on the harness whose reference held the encoder,
#: on the CPU at the tests' reduced width (``SMALL``) and seed ``SEED``;
#: ``table``, ``halo_full`` and ``flops_full`` at the configuration's own
#: widths (FLOPs of a B=64 step of 300 frames, a B=48 step of 784 and a
#: serving step of 960)
PINNED = {
    'flagship': {
        'table': 'a91f074754398ddf', 'halo_full': (24, 508),
        'flops_full': (1373774400000.0, 2692597824000.0, 22896240000.0),
        'weights': 'e28d95f86dadfc35', 'halo': (24, 112),
        'logits': 'cba5401e7ad662ae',
        'loss': (2.9586069583892822, 2.98087215423584, 2.9898273944854736),
        'flops': (120628800.0, 236432448.0, 32167680.0)},
    'linear-dilated': {
        'table': '45c8e51f17bbf485', 'halo_full': (516, 344),
        'flops_full': (2301249600000.0, 4510449216000.0, 38354160000.0),
        'weights': '803744d3b4f7ee7f', 'halo': (120, 80),
        'logits': '50b76f71fb86b3e6',
        'loss': (2.9777801036834717, 3.0109927654266357, 2.9351346492767334),
        'flops': (121896000.0, 238916160.0, 32505600.0)},
}
SHAPES = [(64, 300), (48, 784)]


def _config(name):
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    conf = {c['name']: c for c in bench['configs']}[name]
    return json.loads((ROOT / conf['file']).read_text())


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _flops(arch, cfg, rows):
    return tuple([arch.algorithmic_flops(cfg, b, t) for b, t in rows]
                 + [arch.algorithmic_flops(cfg, 1, 960, train=False)])


def test_every_configuration_names_a_whole_architecture():
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    for conf in bench['configs']:
        arch = archs.find(_config(conf['name']))
        assert all(callable(getattr(arch, f, None)) for f in INTERFACE)
    assert archs.find({'model': toy_mlp}) is toy_mlp


@pytest.mark.parametrize('name', sorted(PINNED))
@pytest.mark.parametrize('what', ['table', 'weights', 'logits', 'loss',
                                  'flops', 'halo'])
def test_readings_are_those_before_the_move(name, what):
    pinned, full = PINNED[name], _config(name)
    cfg = {**full, **SMALL}
    arch = archs.find(cfg)
    if what == 'table':
        table = repr(arch.param_table(full)).encode()
        assert hashlib.sha256(table).hexdigest()[:16] == pinned['table']
    elif what == 'weights':
        w = weights.generate(cfg, SEED, CPU)
        assert _digest(w.values()) == pinned['weights']
    elif what == 'logits':
        r = np.random.default_rng(3)
        audio = (r.standard_normal((2, 400 + 63 * 160)) * 0.1).astype(
            np.float32)
        feats = fe.log_mel(torch.as_tensor(audio))
        logits = arch.forward(weights.generate(cfg, SEED, CPU), cfg, feats,
                              torch.tensor([64, 41]), ref.load_stats())
        assert _digest([logits]) == pinned['logits']
    elif what == 'loss':
        mix = {**run.cell_spec('flagship.train')[2], **MIXES['train']}
        got = train_driver.reference_readings(
            cfg, mix, SEED, CPU, traffic.deck(mix, SEED))
        assert tuple(got['loss']) == pinned['loss']
    elif what == 'flops':
        assert _flops(arch, full, SHAPES) == pinned['flops_full']
        assert _flops(arch, cfg, [(4, 300), (3, 784)]) == pinned['flops']
    else:
        assert tuple(arch.halo(full)) == pinned['halo_full']
        assert tuple(arch.halo(cfg)) == pinned['halo']


#: the toy's own configuration, handed in over a training cell's
TOY = {'name': 'toy-mlp', 'model': toy_mlp, 'hidden': 32, 'num_classes': 48}


def _toy_run(trace=0, seed=2 ** 31 + 29):
    return run.run_cell('flagship.train', seed, 1.0, trace, CPU,
                        {'config': TOY, 'mix': MIXES['train']},
                        t0=time.perf_counter())


@pytest.mark.parametrize('trace', [0, 1])
def test_a_second_architecture_runs_as_files_alone(trace):
    r = _toy_run(trace)
    assert r['correct'], r['checks']
    assert r['attempted'] > 0 and r['failed'] == 0
    want = {0: {'train_audio_s_per_s', 'setup_s'}, 1: {'mfu.train'}}[trace]
    assert set(r['metrics']) == want
    # the comparison reads the toy: its gaps are an f32 rounding's
    assert r['checks']['loss']['value'] < 1e-5, r['checks']


def test_a_second_architecture_is_held_to_the_reference():
    with faults.planted('train', 'unchanged'):
        r = _toy_run()
    assert not r['correct'], r['checks']
