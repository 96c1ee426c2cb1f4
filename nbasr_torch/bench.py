"""The port's speed record: ``bench.py``'s two measurements of the flagship
``[[1,0],[1,0,0],[1,0,0,0]]`` on the card.

    python -m nbasr_torch.bench                           # on a CUDA card
    python -m nbasr_torch.bench --device cpu --reduced    # counts only

1. fp32 inference at B=1, T=500 (LSTM head, ``data_norm=True``, no TF32),
   random weights from seed 0, features from ``np.random.RandomState(0)``:
   one forward plans every cell shape, 10 more warm up, then 100 blocking
   calls, each ended by a synchronize (``value`` is their min, beside their
   median and p90), and 50 pipelined calls ended by one.
2. the bf16 ``grouped_impl='auto'`` train step at B=32 on ``synthetic:64``
   (``Trainer._train_step`` on one batch placed once): 3 warm-up steps,
   then 5 blocks of 10 steps, each block ended by a synchronize
   (``train_step_seconds`` is the median block's mean; host-clock steps
   spread between calls, so every block is reported), the peak memory of
   those steps, and one ``torch.profiler`` window of 3 steps for the
   kernel time a step and the device's busy share in that window.

``train_step_tflops`` counts one step of the same model with
``grouped_impl='chunked'`` under ``FlopCounterMode``: that lowering is
stock PyTorch and runs the block-diagonal chunk matmuls the fused kernels
do, whose work the counter cannot see through ctypes.  That model is
built, counted and freed before anything is timed.
``algorithmic_tflops`` is :func:`~nbasr_torch.models.asr.algorithmic_flops`
at the batch's rows and longest utterance.  Both MFUs divide by 989
TFLOP/s, an H100's dense bf16 peak.

Every cell and CTC recursion on the path must run its kernel: 18 fused
forward launches per inference forward and 18 + 18 + 1 + 1 (forward,
backward, alpha, beta) per train step, counted around the timed windows.
Any other count, a plain version's launch among them, raises, and no
result is printed.  The last line of the output is one JSON object:
``bench.py``'s keys, plus ``inference_latency_p90``, ``inference_samples``,
``train_step_seconds_blocks``, ``power_limit_w``, ``peak_memory_bytes``,
``launches``, ``train_step_kernel_seconds``, ``train_device_busy_share``
and ``reduced``.

The run needs a card unless ``--device cpu`` is given.  On the CPU the
plain versions run every loop and each time, rate, share and memory figure
is ``null``: only counts (FLOPs, launches, samples) are reported.
``--reduced`` takes the CPU tests' widths and few calls.
"""

import argparse
import gc
import json
import math
import subprocess
import time

import numpy as np
import torch

from .data.pipeline import get_dataloaders
from .models.asr import algorithmic_flops, get_model, resolve_device
from .ops import _build, ctc_pallas, fused_cell
from .parallel.sweep import _full_f32
from .training import Trainer, ratios

__all__ = ['main', 'launch_guard', 'launch_counts', 'reset_launches',
           'card_line', 'power_limit_w', 'device_kernels', 'device_seconds',
           'flop_counter', 'ARCH', 'REDUCED_WIDTHS', 'DEVICE_METRICS']

ARCH = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
#: the GTX 1080 Ti's fp32 latency of ARCH (README.md:61, BASELINE.md)
BASELINE_S = 0.04320073127746582
#: an H100's dense bf16 peak (NVIDIA's data sheet, SXM part, 700 W)
PEAK_BF16_FLOPS = 989e12
FRAME_SECONDS = 0.010
INFER_B, INFER_T = 1, 500
TRAIN_DATA, TRAIN_B, LR = 'synthetic:64', 32, 1e-4
#: --reduced: the CPU tests' widths (tests/test_torch_training.py)
REDUCED_WIDTHS = dict(block_kernels=(4, 4), block_strides=(1, 2),
                      block_filters=(24, 32), cells_per_block=(1, 1),
                      cell_groups=4, rnn_units=16)
#: the calls of each loop: bench.py's (the train step's in blocks), and
#: --reduced's
CALLS = {False: dict(warmup=10, samples=100, pipelined=50, train_warmup=3,
                     blocks=5, block_steps=10, profile_steps=3),
         True: dict(warmup=0, samples=2, pipelined=1, train_warmup=0,
                    blocks=1, block_steps=1, profile_steps=1)}
COUNTERS = ('fused_forward', 'fused_backward', 'ctc_alpha', 'ctc_beta')
#: the keys that hold a time, rate, share or memory figure of the device:
#: null on the CPU
DEVICE_METRICS = (
    'value', 'vs_baseline', 'vs_baseline_min', 'inference_latency_median',
    'inference_latency_p90', 'inference_latency_pipelined',
    'train_audio_seconds_per_sec_per_chip', 'train_step_seconds',
    'train_step_seconds_blocks', 'train_mfu', 'algorithmic_mfu',
    'power_limit_w', 'peak_memory_bytes', 'train_step_kernel_seconds',
    'train_device_busy_share')
TOP_KERNELS = 15


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def power_limit_w(card):
    """The watts of a :func:`card_line` (``'NVIDIA H100 80GB HBM3, 700.00
    W'`` -> 700.0)."""
    return float(card.rsplit(',', 1)[1].split()[0])


def device_kernels(prof):
    """The device kernels of a finished ``torch.profiler`` window (rows of
    ``key_averages()``), the most device time first; empty when the
    profiler saw no device time.  A user annotation's range on the device
    (``Optimizer.step#Adam.step``) spans kernels already counted, and is
    left out."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation),
                  key=lambda e: -e.self_device_time_total)


def device_seconds(kernels):
    """The device time of ``kernels`` (:func:`device_kernels`), seconds."""
    return sum(e.self_device_time_total for e in kernels) / 1e6


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **kwargs):
    """``FlopCounterMode``'s formula for ``aten.convolution_backward``, with
    the weight gradient of a grouped conv at its true cost: each of dx and
    dW costs the forward's multiply-adds, which ``w_shape`` (``ci / groups``
    input channels) counts rightly.  PyTorch's own formula counts dW as if
    the conv were dense, ``groups`` times too much."""
    from torch.utils.flop_counter import conv_flop_count
    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def flop_counter():
    """A ``FlopCounterMode`` that counts a grouped conv's dW at its true
    cost."""
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})


def reset_launches():
    """Set the launch counters of the fused cell and CTC kernels to 0."""
    fused_cell.reset_launches()
    ctc_pallas.reset_launches()


def launch_counts():
    """``{counter: {'kernel': n, 'plain': n}}`` of the fused cell forward
    and backward and the CTC alpha and beta since :func:`reset_launches`."""
    return {'fused_forward': dict(fused_cell.LAUNCHES),
            'fused_backward': dict(fused_cell.BACKWARD_LAUNCHES),
            **{f'ctc_{k}': dict(v) for k, v in ctc_pallas.LAUNCHES.items()}}


def launch_guard(counts, calls, per_call, route='kernel'):
    """The launches a call, ``{counter: {'kernel': n, 'plain': n}}``, after
    checking that ``counts`` (the totals of ``calls`` calls by counter) are
    exactly ``calls`` x ``per_call`` (launches a call by counter, 0 where
    absent) on ``route`` and none on the other.  Raises ``RuntimeError``
    otherwise: a run that fell back to a plain version, or launched other
    kernels than its path's, reports no number."""
    want = {name: {k: per_call.get(name, 0) if k == route else 0
                   for k in ('kernel', 'plain')} for name in COUNTERS}
    total = {name: {k: calls * v for k, v in c.items()}
             for name, c in want.items()}
    if counts != total:
        raise RuntimeError(f'launches over {calls} calls: {counts}; the path '
                           f'launches {total}')
    return want


def _measure_inference(device, widths, calls, sync, route):
    """bench.py's inference: seconds of the blocking and pipelined calls,
    the launches a forward."""
    model = get_model(ARCH, use_rnn=True, dropout_rate=0.2, data_norm=True,
                      device=device, generator=torch.Generator().manual_seed(0),
                      **widths).eval()
    feats = torch.as_tensor(np.random.RandomState(0).randn(
        INFER_B, INFER_T, 80).astype(np.float32), device=device)
    sizes = torch.as_tensor([INFER_T] * INFER_B, dtype=torch.int32,
                            device=device)
    with torch.no_grad(), _full_f32():
        for _ in range(1 + calls['warmup']):    # the first plans every cell
            model(feats, sizes)
        sync()
        reset_launches()
        times = []
        for _ in range(calls['samples']):
            t0 = time.perf_counter()
            model(feats, sizes)
            sync()
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(calls['pipelined']):
            logits = model(feats, sizes)
        sync()
        pipelined = (time.perf_counter() - t0) / calls['pipelined']
        launches = launch_guard(
            launch_counts(), calls['samples'] + calls['pipelined'],
            {'fused_forward': sum(model.cells_per_block)}, route)
    if logits.shape[::2] != (INFER_B, model.num_classes + 1) or \
            not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f'inference logits {tuple(logits.shape)}, finite: '
                           f'{bool(torch.isfinite(logits).all())}')
    return times, pipelined, launches


def _measure_train(device, widths, calls, sync, route):
    """bench.py's train step, its FLOP counts, peak memory, launches and
    one profiled window."""
    from torch.profiler import ProfilerActivity, profile
    on_card = device.type == 'cuda'
    loaders = get_dataloaders(TRAIN_DATA, batch_size=TRAIN_B, curriculum=())

    def trainer_of(impl):
        model = get_model(ARCH, use_rnn=True, dropout_rate=0.2,
                          data_norm=True, compute_dtype=torch.bfloat16,
                          grouped_impl=impl, device=device,
                          generator=torch.Generator().manual_seed(0), **widths)
        trainer = Trainer(loaders, device=device, verbose=False,
                          eval_decoder='greedy')
        trainer.init_state(model, seed=0)
        return trainer

    trainer = trainer_of('auto')
    batch = trainer._put_batch(next(iter(loaders[1])))
    rows, frames = int(batch['audio'].shape[0]), int(batch['feature_size'].max())
    audio_seconds = float(batch['feature_size'].sum()) * FRAME_SECONDS
    # the hardware count: one 'chunked' step; its model, Adam state and
    # cuDNN workspaces go before anything is timed
    chunked = trainer_of('chunked')
    with flop_counter() as counter:
        chunked._train_step(batch, LR)
    hardware_flops = float(counter.get_total_flops())
    del chunked, counter
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    algo_flops = algorithmic_flops(trainer.model, rows, frames)
    cells = sum(trainer.model.cells_per_block)

    for _ in range(calls['train_warmup']):          # plans every cell shape
        trainer._train_step(batch, LR)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    blocks = []
    for _ in range(calls['blocks']):
        t0 = time.perf_counter()
        for _ in range(calls['block_steps']):
            trainer._train_step(batch, LR)
        sync()
        blocks.append((time.perf_counter() - t0) / calls['block_steps'])
    launches = launch_guard(
        launch_counts(), calls['blocks'] * calls['block_steps'],
        {'fused_forward': cells, 'fused_backward': cells, 'ctc_alpha': 1,
         'ctc_beta': 1}, route)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls['profile_steps']):
            trainer._train_step(batch, LR)
        sync()
        window = time.perf_counter() - t0
    kernels = device_kernels(prof)
    loss = ratios(trainer.metrics)['ctc_loss']
    if trainer.nonfinite_steps or not math.isfinite(loss):
        raise RuntimeError(f'train steps: running loss {loss}, '
                           f'{trainer.nonfinite_steps} non-finite steps')
    return dict(blocks=blocks, audio_seconds=audio_seconds,
                hardware_flops=hardware_flops, algo_flops=algo_flops, peak=peak,
                launches=launches, kernels=kernels, window=window,
                profile_steps=calls['profile_steps'], rows=rows,
                frames=frames, loss=loss)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m nbasr_torch.bench',
        description="bench.py's measurements of the flagship on the card; "
                    'prints one JSON line last')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu', where only "
                             'counts are reported')
    parser.add_argument('--reduced', action='store_true',
                        help="the CPU tests' widths and few calls")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == 'cuda'
    widths = REDUCED_WIDTHS if args.reduced else {}
    calls = CALLS[args.reduced]
    route = 'kernel' if on_card else 'plain'
    sync = (lambda: torch.cuda.synchronize(device)) if on_card \
        else (lambda: None)
    card = card_line() if on_card else None
    if on_card:
        t0 = time.perf_counter()
        _build.build()
        print(f'build: {time.perf_counter() - t0:.1f} s', flush=True)

    times, pipelined, infer_launches = _measure_inference(
        device, widths, calls, sync, route)
    train = _measure_train(device, widths, calls, sync, route)

    latency, median = float(np.min(times)), float(np.median(times))
    step = float(np.median(train['blocks']))
    kernel_s = device_seconds(train['kernels'])
    if train['kernels']:
        print(f"train profile: {1e3 * kernel_s / train['profile_steps']:.3f} "
              f"ms of kernel time a step, {1e3 * train['window']:.3f} ms wall "
              f"for {train['profile_steps']} steps under the profiler "
              f"(busy {kernel_s / train['window']:.1%}); the "
              f"{TOP_KERNELS} kernels with the most device time:")
        for e in train['kernels'][:TOP_KERNELS]:
            print(f"  {e.self_device_time_total / 1e3 / train['profile_steps']:8.3f}"
                  f' ms a step {e.count:5d}x  {e.key[:100]}')
    else:
        print('train profile: the profiler saw no device time (not measured)')
    result = {
        'metric': 'inference_latency',
        'value': latency,
        'unit': 's',
        'vs_baseline': BASELINE_S / median,
        'vs_baseline_min': BASELINE_S / latency,
        'inference_latency_median': median,
        'inference_latency_p90': float(np.percentile(times, 90)),
        'inference_samples': len(times),
        'inference_latency_pipelined': pipelined,
        'train_audio_seconds_per_sec_per_chip': train['audio_seconds'] / step,
        'train_step_seconds': step,
        'train_step_seconds_blocks': train['blocks'],
        'train_step_tflops': train['hardware_flops'] / 1e12,
        'train_mfu': train['hardware_flops'] / (step * PEAK_BF16_FLOPS),
        'algorithmic_tflops': train['algo_flops'] / 1e12,
        'algorithmic_mfu': train['algo_flops'] / (step * PEAK_BF16_FLOPS),
        'device': torch.cuda.get_device_name(device) if on_card else 'cpu',
        'power_limit_w': power_limit_w(card) if on_card else None,
        'peak_memory_bytes': train['peak'],
        'launches': {'per_forward': infer_launches,
                     'per_train_step': train['launches']},
        'train_step_kernel_seconds': (kernel_s / train['profile_steps']
                                      if train['kernels'] else None),
        'train_device_busy_share': (kernel_s / train['window']
                                    if train['kernels'] else None),
        'reduced': args.reduced,
    }
    if on_card:
        print(f"inference fp32 B={INFER_B} T={INFER_T}: min {1e3 * latency:.3f}"
              f" ms, median {1e3 * median:.3f} ms, p90 "
              f"{1e3 * result['inference_latency_p90']:.3f} ms over "
              f"{len(times)} blocking calls, pipelined {1e3 * pipelined:.3f} "
              f"ms; train bf16 B={train['rows']} (longest {train['frames']} "
              f"frames): {1e3 * step:.3f} ms a step (median of "
              f"{len(train['blocks'])} blocks), "
              f"{result['train_audio_seconds_per_sec_per_chip']:.1f} "
              f"audio-s/s, peak {train['peak'] / 2**30:.3f} GiB [{card}]")
    else:
        result.update({k: None for k in DEVICE_METRICS})
        print('on the CPU: times, rates, shares and memory not measured; '
              f"counts only (running train loss {train['loss']:.4f})")
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
