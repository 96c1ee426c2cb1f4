"""Smoke run of the PyTorch/CUDA port (nbasr_torch) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card (Hopper,
sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. card: its name and power limit, as nvidia-smi reports them;
2. build: nvcc compiles every kernel in nbasr_torch/csrc into build/;
3. kernels: the fused cell kernel against its plain PyTorch version on the
   card, at the four flagship widths (block 0-3 of a serving window), on
   every node kind, in f32 and bf16; then its time per cell beside its bound;
4. serving: the flagship model (26,339,349 parameters, random weights from a
   seed) streams four 8 s streams of seeded audio, one ending 2 s early,
   through StreamingASR at chunk_frames=240 and StreamingGreedyDecoder;
   every SearchCell must go through the kernel (18 launches per device
   step, no call of the plain version);
5. check: the card's f32 logits against the same port run on the CPU, and
   the same stream in bf16 against f32.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import time

import numpy as np
import torch

from nbasr_torch.models.asr import count_params, get_model
from nbasr_torch.models.cell import SearchCell
from nbasr_torch.ops import _build, fused_cell
from nbasr_torch.search_space import arch_vec_to_names
from nbasr_torch.serving import StreamingASR, StreamingGreedyDecoder

SEED = 0
FLAGSHIP = [[1, 0], [1, 0, 0], [1, 0, 0, 0]]
B = 4
# (C, T) of each block's cells in one serving window: 24 + 240 + 508 = 772
# frames at chunk_frames=240, halved by the stride-2 blocks 2 and 3
WIDTHS = ((600, 772), (800, 772), (1000, 386), (1200, 193))
CELLS_PER_BLOCK = (3, 4, 5, 6)
# cell specs that cover every node kind: conv5/conv5d2/conv7/conv7d2,
# linear, zero (with and without branches), skips, and the TF quirks
SPECS = {
    'flagship': dict(arch=FLAGSHIP),
    'linear+dilated': dict(arch=[[0, 1], [2, 1, 0], [4, 0, 1, 1]]),
    'conv7+zero+linear': dict(arch=[[3, 0], [5, 1, 1], [0, 1, 0, 1]]),
    'tf_quirks': dict(arch=[[2, 1], [3, 1, 0], [5, 0, 0, 1]],
                      branch_semantics='tf_inverted', apply_dilation=False,
                      pad_math='tf'),
}
# Kernel against plain version, as a share of max|plain|.  f32: both sum
# in f32, in other orders, over <= 84 (conv) or <= 1200 (linear) terms, so
# they differ by a few ulps (~1e-6) before the LayerNorm divides by the
# row's spread; 1e-4 leaves two decades of margin.  bf16: where the two
# f32 sums straddle a rounding boundary a node output rounds to the
# neighbouring bf16 value (2^-8 relative), and later nodes and the
# LayerNorm carry such flips; 2e-2 is about five bf16 ulps of the scale.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Card against CPU, f32 logits of the whole stream, as a share of max|cpu|:
# cuDNN, oneDNN and the two cell versions sum in other orders in each of
# 22 conv layers and the 60-step LSTM recurrence; 1e-3 bounds that.
SERVE_TOL = 1e-3
# bf16 stream against the f32 stream, as relative L2 error of the logits.
# The random-weight flagship amplifies a perturbation about 1.2x per cell:
# on the CPU the bf16 encoder drifts from f32 by 0.5% (L2) after the first
# block conv and 27% after the last cell, and the logits by ~18%.  0.4
# catches a broken bf16 path (which lands at 100% and more), not that drift.
BF16_SERVE_TOL = 0.4
# H100 SXM peaks (NVIDIA data sheet): HBM3, f32 outside the tensor cores,
# dense bf16 on the tensor cores
MEM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
AUDIO_SECONDS = 8.0
SHORT_BY_SECONDS = 2.0
SAMPLE_RATE = 16000


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def make_cell(C, spec, device):
    """A flagship-width cell with every parameter drawn from the seed (the
    biases and LayerNorm too, so that their indexing is tested)."""
    g = torch.Generator().manual_seed(SEED + C)
    kw = {k: v for k, v in spec.items() if k != 'arch'}
    cell = SearchCell(C, arch_vec_to_names(spec['arch']), groups=100,
                      init_scheme='scaled', generator=g, **kw)
    with torch.no_grad():
        for name, p in cell.named_parameters():
            if name.endswith('bias'):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith('scale'):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
    return cell.to(device)


def cell_bound(cell, B, T, C, dtype):
    """(ms, 'bytes' | 'operations'): the least time for one cell — x read
    and y written once with the weights, against its conv and matmul
    operations at the dtype's peak."""
    size = torch.finfo(dtype).bits // 8
    weights, _ = cell.operands(dtype)
    nbytes = 2 * B * T * C * size + sum(w.numel() * w.element_size()
                                        for w in weights) + 2 * C * 4
    ops = 0
    for node in cell.spec.nodes:
        if node.kind == 'conv':
            ops += 2 * B * T * C * node.K * node.cin_pg
        elif node.kind == 'linear':
            ops += 2 * B * T * C * C
    t_bytes, t_ops = nbytes / MEM_BYTES_S, ops / PEAK_OPS_S[dtype]
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def time_ms(fn, runs=30, warmup=5):
    """Median of ``runs`` CUDA-event timings of ``fn()`` after warm-up.  The
    cell input stays in the 50 MB L2 between runs, as it does in serving,
    where each cell reads what the one before it just wrote."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@torch.inference_mode()
def check_kernels(device):
    """Phase 3: kernel vs plain version at every width, spec and dtype, then
    timings of the flagship cell.  Returns (max errors, timing rows)."""
    errors = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = []
    for C, T in WIDTHS:
        g = torch.Generator().manual_seed(SEED + T)
        x32 = torch.randn((B, T, C), generator=g).to(device)
        for name, spec in SPECS.items():
            cell = make_cell(C, spec, device)
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                weights, ln = cell.operands(dtype)
                got = fused_cell.fused_cell_forward(cell.spec, x, weights, ln)
                want = fused_cell.fused_cell_reference(cell.spec, x, weights, ln)
                torch.cuda.synchronize()
                assert got.shape == want.shape and got.dtype == want.dtype
                assert bool(torch.isfinite(got.float()).all()), (name, C, dtype)
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                print(f'kernel vs plain  {name:18s} C={C:4d} T={T:3d} '
                      f'{str(dtype)[6:]:8s} max_abs_err={err:.3e} '
                      f'max|plain|={scale:.3f} tol={TOL[dtype] * scale:.3e}')
                assert err <= TOL[dtype] * scale, (name, C, dtype, err, scale)
                errors[dtype] = max(errors[dtype], err)
        cell = make_cell(C, SPECS['flagship'], device)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            args = (cell.spec, x, *cell.operands(dtype))
            ms = time_ms(lambda: fused_cell.fused_cell_forward(*args))
            plain_ms = time_ms(lambda: fused_cell.fused_cell_reference(*args))
            bound_ms, bound_by = cell_bound(cell, B, T, C, dtype)
            rows.append(dict(C=C, T=T, dtype=str(dtype)[6:], ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
            print(f'flagship cell  B={B} C={C:4d} T={T:3d} {str(dtype)[6:]:8s} '
                  f'kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  '
                  f'bound {bound_ms:.4f} ms ({bound_by})')
    return errors, rows


def make_audio():
    rng = np.random.RandomState(SEED)
    n = int(AUDIO_SECONDS * SAMPLE_RATE)
    audio = (rng.randn(B, n) * 0.1).astype(np.float32)
    valid = np.full(B, n, np.int64)
    valid[-1] = n - int(SHORT_BY_SECONDS * SAMPLE_RATE)
    audio[-1, valid[-1]:] = 0.0
    return audio, valid


def serve(model, audio, valid, device, block=7919):
    """Stream ``audio`` through StreamingASR in uneven blocks, flush and
    greedy-decode.  Returns (logits [B, n, V] numpy, tokens, lengths,
    device steps, wall seconds)."""
    if device.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = StreamingASR(model, chunk_frames=240, batch_size=B, device=device)
    dec = StreamingGreedyDecoder(B)
    chunks = []
    for lo in range(0, audio.shape[1], block):
        hi = min(lo + block, audio.shape[1])
        n_valid = np.clip(valid - lo, 0, hi - lo)
        chunks += s.push(audio[:, lo:hi], n_valid)
    chunks += s.flush()
    for lg, vl in chunks:
        dec.push(lg, vl)
    logits = torch.cat([lg for lg, _ in chunks], dim=1).cpu().numpy()
    wall = time.perf_counter() - t0
    return logits, dec.tokens, s.logit_lengths, s.steps, wall


def profile_step(s, win, mask, steps=3):
    """Kernel time by name over ``steps`` device steps (torch.profiler), and
    the share of the profiled wall time the card was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            s._device_step(win, mask, s.hl // s.ts, s._init_carry())
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print('profile: the profiler saw no device time (not measured)')
        return
    per_step = lambda es: sum(e.self_device_time_total for e in es) / 1e3 / steps
    busy = per_step(kernels)
    print(f'profile: {busy:.3f} ms of kernel time per device step, '
          f'{wall_ms:.3f} ms wall per step under the profiler '
          f'(busy {busy / wall_ms:.1%}); fused cell kernels '
          f'{per_step([e for e in kernels if "nbasr_" in e.key]):.3f} ms')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f'  {e.self_device_time_total / 1e3 / steps:8.3f} ms '
              f'{e.count // steps:5d}x  {e.key[:100]}')


def check_serving(device):
    """Phases 4-5.  Returns the kernel launches and the timings."""
    g = torch.Generator().manual_seed(SEED)
    model = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=device,
                      generator=g)
    assert count_params(model) == 26_339_349, count_params(model)
    audio, valid = make_audio()

    serve(model, audio, valid, device)                     # warm-up
    fused_cell.reset_launches()
    logits, tokens, lengths, steps, wall = serve(model, audio, valid, device)
    launches = dict(fused_cell.LAUNCHES)
    print(f'serving f32: {steps} device steps, launches {launches}')
    assert launches['kernel'] == 18 * steps, (launches, steps)
    assert launches['plain'] == 0, launches
    assert logits.shape[0] == B and logits.shape[2] == 49, logits.shape
    assert logits.shape[1] >= int(lengths.max()), (logits.shape, lengths)
    assert np.isfinite(logits).all()
    audio_s = float(valid.sum()) / SAMPLE_RATE
    print(f'serving f32: wall {wall:.4f} s, {1e3 * wall / steps:.3f} ms per '
          f'device step (host included), {audio_s / wall:.1f} audio-s/s; '
          f'logit lengths {lengths.tolist()}, tokens per stream '
          f'{[len(t) for t in tokens]}')

    # one device step alone, on the card's clock
    s = StreamingASR(model, chunk_frames=240, batch_size=B, device=device)
    win = torch.randn((B, s.Wf, 80), generator=g).to(device)
    mask = torch.ones((B, s.Wf), dtype=torch.bool, device=device)
    step_ms = time_ms(lambda: s._device_step(win, mask, s.hl // s.ts,
                                             s._init_carry()), runs=20)
    print(f'device step alone: {step_ms:.3f} ms (CUDA events, median of 20)')
    profile_step(s, win, mask)

    cpu = torch.device('cpu')
    cpu_model = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=cpu)
    cpu_model.load_state_dict(model.state_dict())
    want, want_tokens, want_lengths, _, cpu_wall = serve(cpu_model, audio,
                                                         valid, cpu)
    assert want.shape == logits.shape
    np.testing.assert_array_equal(lengths, want_lengths)
    err = float(np.abs(logits - want).max())
    scale = float(np.abs(want).max())
    print(f'card vs cpu f32 logits: max_abs_err={err:.3e} max|cpu|={scale:.3f} '
          f'tol={SERVE_TOL * scale:.3e} (cpu run {cpu_wall:.1f} s)')
    assert err <= SERVE_TOL * scale
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > SERVE_TOL * scale
    agree = logits.argmax(-1) == want.argmax(-1)
    print(f'greedy ids agree on {int(agree[clear].sum())}/{int(clear.sum())} '
          f'frames with a clear top-2 margin; decoded tokens equal: '
          f'{tokens == want_tokens}')
    assert agree[clear].all()

    low = get_model(FLAGSHIP, use_rnn=True, data_norm=True, device=device,
                    compute_dtype=torch.bfloat16)
    low.load_state_dict(model.state_dict())
    fused_cell.reset_launches()
    bf16, _, _, bf16_steps, bf16_wall = serve(low, audio, valid, device)
    assert fused_cell.LAUNCHES == {'kernel': 18 * bf16_steps, 'plain': 0}
    rel_l2 = float(np.linalg.norm(bf16 - logits) / np.linalg.norm(logits))
    print(f'serving bf16: wall {bf16_wall:.4f} s; vs f32 relative L2 '
          f'{rel_l2:.4f} (tol {BF16_SERVE_TOL}), max_abs_err='
          f'{float(np.abs(bf16 - logits).max()):.3e}')
    assert np.isfinite(bf16).all() and rel_l2 <= BF16_SERVE_TOL
    return launches['kernel'], dict(steps=steps, wall=wall, step_ms=step_ms)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device')
    device = torch.device('cuda')
    torch.backends.cudnn.allow_tf32 = False       # f32 means f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f'card: {card} ({torch.cuda.get_device_name(0)})')

    t0 = time.perf_counter()
    built = _build.build()
    print(f'build: {time.perf_counter() - t0:.1f} s')
    for name, (path, log) in built.items():
        print(f'  {name}: {path}')
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print('   ', line.strip())

    errors, rows = check_kernels(device)
    launches, serving = check_serving(device)

    # one serving step's 18 f32 cells, from the per-width timings
    f32_rows = [r for r in rows if r['dtype'] == 'float32']
    step = {k: sum(n * r[k] for n, r in zip(CELLS_PER_BLOCK, f32_rows))
            for k in ('ms', 'plain_ms', 'bound_ms')}
    kernels = [dict(
        name='fused_cell_forward', route='cuda',
        source='nbasr_torch/csrc/fused_cell.cu',
        replaces='nbasr_tpu/ops/fused_cell.py:388',
        launches=launches, max_abs_err=errors[torch.float32],
        ms=step['ms'], plain_ms=step['plain_ms'], bound_ms=step['bound_ms'],
        bound_by='bytes' if all(r['bound_by'] == 'bytes' for r in f32_rows)
        else 'operations',
        library_ms=None,
        max_abs_err_bf16=errors[torch.bfloat16],
        times_cover='the 18 f32 cells of one flagship serving step, B=4, '
                    'T=772/772/386/193',
        per_width=rows)]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
