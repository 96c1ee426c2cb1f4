"""The readers of the program's own spans and counters
(``perfbench/program_spans.py``) on a hand-written Chrome trace, whose
ranges lie on two threads and whose kernels join their launches by
correlation id, and on counter snapshots; and the benchmark's runs as they
stand leave the program's tracing off."""

import math
import time

import pytest
import torch

from conftest import overrides
from perfbench import program_spans, run
from perfbench.trace import Trace

MAIN, ENGINE = 1, 2


def _chrome():
    ev = [{'ph': 'X', 'cat': 'user_annotation', 'name': 'perfbench.window',
           'tid': MAIN, 'ts': 0, 'dur': 1000}]
    for name, tid, ts, dur in [('nbasr.lstm', MAIN, 100, 100),
                               ('nbasr.lstm.backward', ENGINE, 500, 100),
                               ('nbasr.block_conv', MAIN, 300, 100)]:
        ev.append({'ph': 'X', 'cat': 'cpu_op', 'name': name, 'tid': tid,
                   'ts': ts, 'dur': dur, 'args': {}})
    # (correlation, launching thread, launch time, kernel start, duration)
    for corr, tid, at, start, dur in [
            (1, MAIN, 110, 120, 10),     # in nbasr.lstm
            (2, MAIN, 150, 160, 20),     # in nbasr.lstm
            (3, ENGINE, 550, 560, 30),   # in nbasr.lstm.backward
            (4, MAIN, 550, 600, 40),     # same time, the other thread: none
            (5, MAIN, 350, 410, 50),     # in nbasr.block_conv
            (6, MAIN, 450, 470, 60)]:    # in no range
        ev.append({'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunch',
                   'tid': tid, 'ts': at, 'dur': 2,
                   'args': {'correlation': corr}})
        ev.append({'ph': 'X', 'cat': 'kernel', 'name': f'k{corr}', 'tid': 7,
                   'ts': start, 'dur': dur, 'args': {'correlation': corr}})
    return {'traceEvents': ev}


def _ctx(**kw):
    ctx = {'spans': Trace(_chrome()),
           'program': {'spans': {'serve.device_step': {
               'calls': 2, 'ns': 1, 'self_ns': 1}},
               'counts': {'lstm.frames': 6}},
           'counted': {'spans': {
               'loader.batch': {'calls': 4, 'ns': 8_000_000,
                                'self_ns': 8_000_000},
               'serve.push': {'calls': 3, 'ns': 9_000_000,
                              'self_ns': 3_000_000},
               'serve.flush': {'calls': 1, 'ns': 2_000_000,
                               'self_ns': 1_000_000}}, 'counts': {}},
           'counted_steps': 4}
    ctx.update(kw)
    return ctx


def test_readers_on_a_hand_written_trace():
    ctx = _ctx()
    assert program_spans.lstm_launches_per_frame(ctx) == 3 / 6
    assert program_spans.lstm_us_per_frame(ctx) == (10 + 20 + 30) / 6
    assert program_spans.block_conv_ms(ctx) == 50 / 1e3 / 2
    assert program_spans.loader_ms(ctx) == 8.0 / 4
    assert program_spans.push_host_ms(ctx) == (3.0 + 1.0) / 4


@pytest.mark.parametrize('missing', ['spans', 'program', 'counted',
                                     'counted_steps'])
def test_readers_find_nothing_without_their_inputs(missing):
    ctx = _ctx(**{missing: None})
    readers = {'spans': ['lstm_launches_per_frame', 'lstm_us_per_frame',
                         'block_conv_ms'],
               'program': ['lstm_launches_per_frame', 'lstm_us_per_frame',
                           'block_conv_ms'],
               'counted': ['loader_ms', 'push_host_ms'],
               'counted_steps': ['loader_ms', 'push_host_ms']}[missing]
    for name in readers:
        assert getattr(program_spans, name)(ctx) is None, name


@pytest.mark.parametrize('cell,kind', [('flagship.train', 'train'),
                                       ('flagship.serve', 'serve')])
def test_benchmark_runs_leave_the_programs_tracing_off(cell, kind,
                                                       monkeypatch):
    """A traced run as the benchmark stands: the program's spans stay off
    through the unprofiled window and both profiled stretches, so none of
    its ``nbasr.`` ranges reach the span-profiled trace."""
    from nbasr_torch.utils import tracing
    tracing.reset()
    traces = []
    real = Trace.__init__

    def keep(self, chrome, window_s=None):
        real(self, chrome, window_s)
        traces.append(self)
    monkeypatch.setattr(Trace, '__init__', keep)
    r = run.run_cell(cell, 2 ** 31 + 5, 1.0, 1, torch.device('cpu'),
                     overrides(kind), t0=time.perf_counter())
    assert r['correct']
    assert not tracing.is_enabled()
    assert tracing.snapshot() == {'spans': {}, 'counts': {}}
    assert traces and not any(n.startswith('nbasr.')
                              for tr in traces for n in tr.ranges)


@pytest.mark.parametrize('cell,kind,host', [
    ('flagship.train', 'train', 'loader_ms'),
    ('flagship.serve', 'serve', 'push_host_ms')])
def test_program_layers_run_reads_the_host_counters(cell, kind, host):
    """``python3 -m perfbench.program_layers`` at a reduced width on the
    CPU: the host-time reader reads a finite positive number, the device
    readers find no kernel and read None, the tracing leaves nothing on,
    and the patched functions are restored afterwards."""
    from nbasr_torch.utils import tracing
    from perfbench import program_layers, trace
    from perfbench.drivers import serve, train
    before = (trace.profile, train._profiled, serve._profiled, train.run,
              serve.run)
    r = program_layers.traced_run(cell, 2 ** 31 + 9, 1.0,
                                  torch.device('cpu'), overrides(kind),
                                  t0=time.perf_counter())
    assert r['correct']
    numbers = r['program_layers']
    assert set(numbers) == set(program_layers.READERS[kind])
    assert math.isfinite(numbers[host]) and numbers[host] > 0
    assert all(v is None for k, v in numbers.items() if k != host)
    assert r['program_counts']['lstm.frames'] > 0
    pace = r['tracing_on']['pace_s']
    assert len(pace['off']) == 4 and len(pace['on']) == 3
    assert not tracing.is_enabled()
    assert (trace.profile, train._profiled, serve._profiled, train.run,
            serve.run) == before
