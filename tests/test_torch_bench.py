"""The port's speed record, ``nbasr_torch/bench.py`` (the twin of
``bench.py``), on the CPU: its last line holds every key of
``BENCH_r05.json``'s result and the port's own, with every device time,
rate, share and memory figure null; its algorithmic FLOPs equal the JAX
package's count at the reduced model and batch shape; the hardware count
of the 'chunked' step covers it, grouped convs' backward counted at their
true cost; it refuses a machine without a card
unless asked for the CPU; and its launch guard refuses a plain launch or a
wrong count."""

import contextlib
import io
import json
import pathlib

import pytest
import torch

from nbasr_tpu.data import get_dataloaders as jax_get_dataloaders
from nbasr_tpu.models.asr import algorithmic_flops as jax_flops
from nbasr_tpu.models.asr import get_model as jax_get_model

from nbasr_torch import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
NEW_KEYS = ('inference_latency_p90', 'inference_samples',
            'train_step_seconds_blocks', 'power_limit_w', 'peak_memory_bytes',
            'launches', 'train_step_kernel_seconds', 'train_device_busy_share')


@pytest.fixture(scope='module')
def reduced():
    # one intra-op thread: the run is thousands of small ops, as fast on
    # one thread alone, and the suite's other workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            bench.main(['--device', 'cpu', '--reduced'])
    finally:
        torch.set_num_threads(threads)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_cpu_run_prints_every_key_and_no_device_number(reduced):
    parsed = json.loads((ROOT / 'BENCH_r05.json').read_text())['parsed']
    assert set(parsed) | set(NEW_KEYS) <= set(reduced)
    assert reduced['device'] == 'cpu' and reduced['reduced'] is True
    assert {k: reduced[k] for k in bench.DEVICE_METRICS} == \
        dict.fromkeys(bench.DEVICE_METRICS)
    assert reduced['metric'] == 'inference_latency' and reduced['unit'] == 's'
    assert reduced['inference_samples'] == bench.CALLS[True]['samples']
    cells = sum(bench.REDUCED_WIDTHS['cells_per_block'])
    plain = lambda n: {'kernel': 0, 'plain': n}
    assert reduced['launches'] == {
        'per_forward': {'fused_forward': plain(cells),
                        'fused_backward': plain(0), 'ctc_alpha': plain(0),
                        'ctc_beta': plain(0)},
        'per_train_step': {'fused_forward': plain(cells),
                           'fused_backward': plain(cells),
                           'ctc_alpha': plain(1), 'ctc_beta': plain(1)}}


def test_algorithmic_flops_are_the_jax_packages(reduced):
    jmodel = jax_get_model(bench.ARCH, use_rnn=True, dropout_rate=0.2,
                           data_norm=True, **bench.REDUCED_WIDTHS)
    loaders = jax_get_dataloaders(bench.TRAIN_DATA, batch_size=bench.TRAIN_B,
                                  curriculum=())
    batch = next(iter(loaders[1]))
    want = jax_flops(jmodel, int(batch['audio'].shape[0]),
                     int(batch['feature_size'].max()))
    assert reduced['algorithmic_tflops'] == want / 1e12


def test_chunked_count_covers_the_algorithmic_one(reduced):
    # the block-diagonal chunks cost at least the true grouped product
    assert reduced['train_step_tflops'] >= reduced['algorithmic_tflops'] > 0


@pytest.mark.parametrize('groups, stride, x_grad', [
    (1, 1, True), (5, 1, True), (5, 2, True), (5, 1, False)])
def test_conv_backward_counts_the_grouped_product(groups, stride, x_grad):
    """dx and dW each cost the forward's multiply-adds; PyTorch's own
    formula counts a grouped conv's dW as if it were dense."""
    x = torch.randn(2, 60, 20, requires_grad=x_grad)
    w = torch.randn(60, 60 // groups, 5, requires_grad=True)
    with bench.flop_counter() as counter:
        y = torch.nn.functional.conv1d(x, w, padding=2, stride=stride,
                                       groups=groups)
        y.sum().backward()
    counts = counter.get_flop_counts()['Global']
    forward = 2 * 2 * y.shape[-1] * 60 * (60 // groups) * 5
    assert counts[torch.ops.aten.convolution] == forward
    assert counts[torch.ops.aten.convolution_backward] == \
        forward * (2 if x_grad else 1)


def test_no_card_and_no_cpu_flag_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bench.main([])


STEP = {'fused_forward': 18, 'fused_backward': 18, 'ctc_alpha': 1,
        'ctc_beta': 1}


def _counts(per_call, calls, route='kernel', **moved):
    counts = {name: {'kernel': 0, 'plain': 0} for name in bench.COUNTERS}
    for name, n in per_call.items():
        counts[name][route] = calls * n
    for name, (route_moved, n) in moved.items():
        counts[name][route_moved] += n
    return counts


FORWARD = {'fused_forward': 18}


GUARD_CASES = [
    ('step', STEP, _counts(STEP, 10), 'kernel', True),
    ('step on the cpu', STEP, _counts(STEP, 10, 'plain'), 'plain', True),
    ('a plain launch', STEP, _counts(STEP, 10, ctc_beta=('plain', 1)),
     'kernel', False),
    ('one kernel short', STEP,
     _counts(STEP, 10, fused_backward=('kernel', -1)), 'kernel', False),
    ('the plain route on the card', STEP, _counts(STEP, 10, 'plain'),
     'kernel', False),
    ('forward', FORWARD, _counts(FORWARD, 10), 'kernel', True),
    ('a forward that ran a backward', FORWARD,
     _counts(FORWARD, 10, fused_backward=('kernel', 10)), 'kernel', False),
]


@pytest.mark.parametrize('case, per_call, counts, route, ok', GUARD_CASES,
                         ids=[c[0] for c in GUARD_CASES])
def test_launch_guard(case, per_call, counts, route, ok):
    if ok:
        got = bench.launch_guard(counts, 10, per_call, route)
        assert got == {name: {'kernel': per_call.get(name, 0)
                              if route == 'kernel' else 0,
                              'plain': per_call.get(name, 0)
                              if route == 'plain' else 0}
                       for name in bench.COUNTERS}
    else:
        with pytest.raises(RuntimeError, match='launches over 10 calls'):
            bench.launch_guard(counts, 10, per_call, route)
