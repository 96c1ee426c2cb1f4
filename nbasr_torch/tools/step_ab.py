"""A/B of the flagship train step, of its grouped conv kernels, of its
fused cell forward or backward or of its CTC kernels, between checkouts,
on one card.

    python3 nbasr_torch/tools/step_ab.py [--impl auto | --gconv | --fused-fwd | --fused-bwd | --ctc] ROOT_A ROOT_B ROOT_B ROOT_A ...

For each root in the order given (alternate them: host time drifts between
processes), a fresh process imports ``nbasr_torch`` from that root, builds
its kernels there with ``_build.build()``, and runs the train step that
``chip_smoke.py`` times: the full-width flagship in bf16, B=32, dropout 0.2, on the
``synthetic:64`` batches through ``Trainer.step``, ``--impl`` its
``grouped_impl``.  After 3 warm-up steps it times BLOCKS blocks of
STEPS steps on the host clock, each ended by ``torch.cuda.synchronize()``:

- ``step_ms``: the median block's ms per step, and ``step_ms_blocks`` all
  of them;
- ``kernel_ms``: the device time of every kernel in a ``torch.profiler``
  trace of STEPS steps, per step.

With ``--gconv`` it times instead the grouped conv's forward and dx at the
flagship's conv5 nodes as phase 9 of this checkout's ``chip_smoke.py`` does
(its operands, calls and timers, on the root's kernels): bf16, B=32, the
dense layout with the epilogue-free forward ('pallas') and a contiguous
split tensor with the bias + clip-ReLU forward ('pallas_split'); per train
step (9/12/15/18 nodes at the four widths) ``*_events_ms``, the CUDA-event
median of single calls, and ``*_device_ms``, calls queued behind a spin
kernel; per node under ``per_node``; and ``registers``, each grouped conv
kernel's registers and spill-store bytes as ptxas reported them when the
root's library was built (a root's ``grouped_conv.cu`` may be a variant
of another's: put both in one call to see what the compiler made of
each), with ``fused_registers`` and ``bwd_registers`` those of the fused
forward and backward libraries, which include the same header.

With ``--fused-bwd`` it times the fused cell backward of the 18 flagship
cells of one train step (3/4/5/6 cells at C/T = 600/300, 800/300,
1000/150, 1200/75), bf16, B=32, dropout 0.2, on the saved node outputs
and multipliers of each cell's own training forward (the cells, inputs
and timers of this checkout's ``chip_smoke.py``): ``bwd_events_ms``, the
CUDA-event median of single calls per cell, summed over the step;
``bwd_device_ms``, calls queued behind a spin kernel, summed likewise;
``kernels_ms``, the device time of each kernel of the backward library by
name in a ``torch.profiler`` trace, per step; ``launches_per_cell``, the
kernels a cell's backward launches; and ``registers``, the fused backward
library's registers and spills as ptxas reported them.

With ``--fused-fwd`` it times the fused cell forward the same way, on
three sets of 18 flagship cells: ``train``, the training forward
(``fused_cell_train_forward``, which keeps the node outputs and
multipliers) of one train step, bf16, B=32, T 300/300/150/75, dropout 0.2;
``infer_b32``, the serving forward (no dropout, nothing kept) at those
shapes, which leaves out the training epilogue's hash and multipliers;
``serve_f32`` and ``serve_bf16``, the serving forward
(``fused_cell_forward``, nothing kept) of one serving window, B=4, T
772/772/386/193.  For each: ``<set>_events_ms`` and ``<set>_device_ms``
summed over the 18 cells, ``<set>_kernels_ms`` by kernel name and
``<set>_launches_per_cell`` from a profiler trace; ``<set>_digest``, a
SHA-256 of every output of one call per width (the training forward's
node outputs and multipliers too), equal between roots whose kernels
give the same bits; and ``registers``, the forward library's registers
and spills.

With ``--ctc`` it times the CTC alpha and beta kernels at four cases of
phase 12 of this checkout's ``chip_smoke.py`` (its operands, from
``ctc_cases``, and its timers, on the root's kernels through
``ctc_pallas._launch_alpha/_launch_beta``): ``train step`` (the loader's
batch, T=75, B=32, S=65), ``eval`` (T=200, B=16, S=161), ``S=513`` and
``S=8193``.  For each case and recursion under ``ctc``: ``events_ms``, the
CUDA-event median of single calls; ``device_ms``, calls queued behind a
spin kernel; ``us_per_step``, device_ms over T; ``path``, the root's plan
where it has one (``ctc_pallas.device_plan``); and ``digest``, a SHA-256 of
the stack of one call, equal between roots whose kernels give the same
bits.  ``registers``: the ``ctc`` library's registers and spills as ptxas
reported them.

Only the API that every version of the port has is used (``get_model``,
``get_dataloaders``, ``Trainer.init_state/step``, ``_build.build``, the
grouped conv's ``_launch_*`` wrappers, ``fused_cell_train_forward``,
``fused_cell_backward``, ``SearchCell.operands``).  One JSON line per root,
then a summary line.
"""

import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

STEPS = 10
BLOCKS = 3
SMOKE = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', '..',
                     'chip_smoke.py')


def load_smoke():
    """This checkout's chip_smoke.py, imported with the root's nbasr_torch."""
    spec = importlib.util.spec_from_file_location('chip_smoke', SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def gconv_times():
    """Forward and dx times of the root's grouped conv kernels, by this
    checkout's chip_smoke.py (imported with the root's nbasr_torch)."""
    import torch
    smoke = load_smoke()
    dev = torch.device('cuda')
    out = {'per_node': []}
    with torch.no_grad():
        for (C, T), cells in zip(smoke.TRAIN_WIDTHS, smoke.CELLS_PER_BLOCK):
            g = torch.Generator().manual_seed(C)
            x, dz, w, b = smoke._gconv_operands(C, T, smoke.TRAIN_B, 5, 1,
                                                torch.bfloat16, dev, g)
            for layout in smoke.GCONV_LAYOUTS:
                xs, zs, y, dx = smoke._gconv_args(x, dz, layout)
                calls = smoke._gconv_calls(xs, zs, w, b, 2, 1, y, dx,
                                           smoke.KERNEL_FNS)
                fwd = 'forward' if layout == 'dense' else 'forward+bias'
                for name in (fwd, 'dx'):
                    key = name.split('+')[0]
                    row = dict(kernel=key, layout=layout, C=C, T=T,
                               events_ms=smoke.time_ms(calls[name]),
                               device_ms=smoke.device_ms(calls[name]))
                    out['per_node'].append(row)
                    for k in ('events_ms', 'device_ms'):
                        total = f'{key}_{layout}_{k}'
                        out[total] = out.get(total, 0.0) + 3 * cells * row[k]
    return out


def kernel_name(key):
    """A profiler row's kernel as ``nbasr_<name>``, or the row's key (the
    memset)."""
    m = re.search(r'nbasr_\w+?(?=<|\(|$)', key)
    return m.group(0) if m else key[:40]


def fused_bwd_times():
    """The fused backward of the root's kernels at one flagship train
    step's 18 bf16 cells, by this checkout's chip_smoke.py."""
    import torch
    from nbasr_torch.ops import fused_cell
    smoke = load_smoke()
    dev = torch.device('cuda')
    seed = torch.tensor(smoke.TRAIN_SEED, dtype=torch.int32, device=dev)
    out = {'card': smoke.card_line(), 'bwd_events_ms': 0.0,
           'bwd_device_ms': 0.0, 'per_width': []}
    calls = []
    with torch.no_grad():
        for (C, T), cells in zip(smoke.TRAIN_WIDTHS, smoke.CELLS_PER_BLOCK):
            cell = smoke.make_cell(C, smoke.SPECS['flagship'], dev)
            spec = smoke.train_spec(cell, smoke.DROPOUT)
            g = torch.Generator().manual_seed(smoke.SEED + C)
            x = torch.randn((smoke.TRAIN_B, T, C), generator=g).to(
                dev, torch.bfloat16)
            dy = torch.randn((smoke.TRAIN_B, T, C), generator=g).to(
                dev, torch.bfloat16)
            weights, ln = cell.operands(torch.bfloat16)
            _, outs, mults = fused_cell.fused_cell_train_forward(
                spec, x, weights, ln, seed)
            bwd = (lambda a: lambda: fused_cell.fused_cell_backward(*a))(
                (spec, x, outs, mults, dy, weights, ln))
            row = dict(C=C, T=T, cells=cells, events_ms=smoke.time_ms(bwd),
                       device_ms=smoke.device_ms(bwd))
            out['per_width'].append(row)
            out['bwd_events_ms'] += cells * row['events_ms']
            out['bwd_device_ms'] += cells * row['device_ms']
            calls.append((cells, bwd))
    by_name, counts = profile_calls(calls)
    out['kernels_ms'] = by_name
    out['kernels_total_ms'] = sum(by_name.values())
    out['launches_per_cell'] = sum(counts.values()) / 18
    out['launches_by_name_per_step'] = counts
    return out


def fused_fwd_times():
    """The fused forward of the root's kernels at one flagship train step's
    18 bf16 training cells and one serving window's 18 f32 and bf16 cells,
    by this checkout's chip_smoke.py."""
    import torch
    from nbasr_torch.ops import fused_cell
    smoke = load_smoke()
    dev = torch.device('cuda')
    seed = torch.tensor(smoke.TRAIN_SEED, dtype=torch.int32, device=dev)
    sets = (('train', smoke.TRAIN_B, smoke.TRAIN_WIDTHS, torch.bfloat16),
            ('infer_b32', smoke.TRAIN_B, smoke.TRAIN_WIDTHS, torch.bfloat16),
            ('serve_f32', smoke.B, smoke.WIDTHS, torch.float32),
            ('serve_bf16', smoke.B, smoke.WIDTHS, torch.bfloat16))
    out = {'card': smoke.card_line(), 'per_width': []}
    with torch.no_grad():
        for name, Bn, widths, dtype in sets:
            calls, digest = [], hashlib.sha256()
            out[f'{name}_events_ms'] = out[f'{name}_device_ms'] = 0.0
            for (C, T), cells in zip(widths, smoke.CELLS_PER_BLOCK):
                cell = smoke.make_cell(C, smoke.SPECS['flagship'], dev)
                g = torch.Generator().manual_seed(smoke.SEED + C)
                x = torch.randn((Bn, T, C), generator=g).to(dev, dtype)
                weights, ln = cell.operands(dtype)
                if name == 'train':
                    args = (smoke.train_spec(cell, smoke.DROPOUT), x, weights,
                            ln, seed)
                    fn = (lambda a: lambda: fused_cell.fused_cell_train_forward(
                        *a))(args)
                else:
                    fn = (lambda a: lambda: fused_cell.fused_cell_forward(*a))(
                        (cell.spec, x, weights, ln))
                row = dict(set=name, C=C, T=T, cells=cells,
                           events_ms=smoke.time_ms(fn),
                           device_ms=smoke.device_ms(fn))
                got = fn()
                for t in got if isinstance(got, tuple) else (got,):
                    digest.update(t.contiguous().view(torch.uint8).cpu()
                                  .numpy().tobytes())
                out['per_width'].append(row)
                out[f'{name}_events_ms'] += cells * row['events_ms']
                out[f'{name}_device_ms'] += cells * row['device_ms']
                calls.append((cells, fn))
            by_name, counts = profile_calls(calls)
            out[f'{name}_kernels_ms'] = by_name
            out[f'{name}_kernels_total_ms'] = sum(by_name.values())
            out[f'{name}_launches_per_cell'] = sum(counts.values()) / 18
            out[f'{name}_digest'] = digest.hexdigest()[:16]
    return out


CTC_CASES = ('train step', 'eval', 'S=513', 'S=8193')


def ctc_times():
    """The root's CTC alpha and beta kernels at four cases of phase 12 of
    this checkout's chip_smoke.py."""
    import torch
    from nbasr_torch.ops import ctc_pallas
    smoke = load_smoke()
    dev = torch.device('cuda')
    out = {'card': smoke.card_line(), 'ctc': {}}
    cases = smoke.ctc_cases(dev)
    with torch.no_grad():
        for label in CTC_CASES:
            em, skip, final = smoke.ctc_operands(*cases[label])
            T = em.shape[0]
            plan = (ctc_pallas.device_plan(em)['path']
                    if hasattr(ctc_pallas, 'device_plan') else 'block')
            for name, call in smoke.ctc_kernel_calls(em, skip, final).items():
                digest = hashlib.sha256(call().cpu().numpy().tobytes())
                row = dict(T=T, B=em.shape[1], S=em.shape[2], path=plan,
                           events_ms=smoke.time_ms(call),
                           device_ms=smoke.device_ms(call),
                           digest=digest.hexdigest()[:16])
                row['us_per_step'] = 1e3 * row['device_ms'] / T
                out['ctc'][f'{label} {name}'] = row
    return out


def profile_calls(calls):
    """({kernel: device ms per step}, {kernel: launches per step}) of STEPS
    runs of every (cells, fn) in ``calls``, fn called ``cells`` times a
    step, in a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            for cells, fn in calls:
                for _ in range(cells):
                    fn()
        torch.cuda.synchronize()
    by_name, counts = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = kernel_name(e.key)
            by_name[name] = by_name.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / STEPS
            counts[name] = counts.get(name, 0) + e.count / STEPS
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1])), counts


def registers(log):
    """{kernel: [registers, spill-store bytes]} from ptxas's ``-v`` report
    (kernel names mangled, from ``nbasr_`` to the template arguments' end)."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?(nbasr_\w+)'", line)
        if m:
            name, spill = m.group(1).split('EEv')[0], 0
        elif name and (m := re.search(r'(\d+) bytes spill stores', line)):
            spill = int(m.group(1))
        elif name and (m := re.search(r'Used (\d+) registers', line)):
            out[name] = [int(m.group(1)), spill]
            name = None
    return out


def measure(root, impl):
    """The timings of one root, in this process (``impl`` a grouped_impl,
    or ``'gconv'`` for the grouped conv kernels alone)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import nbasr_torch
    from nbasr_torch.data.pipeline import get_dataloaders
    from nbasr_torch.models.asr import get_model
    from nbasr_torch.ops import _build
    from nbasr_torch.training import Trainer
    assert nbasr_torch.__file__.startswith(os.path.abspath(root)), \
        nbasr_torch.__file__
    built = _build.build(('ctc',)) if impl == 'ctc' else _build.build()
    if impl == 'gconv':
        return {'root': root, 'impl': impl, **gconv_times(),
                'registers': registers(built['grouped_conv'][1]),
                'fused_registers': registers(built['fused_cell'][1]),
                'bwd_registers': registers(built['fused_cell_bwd'][1])}
    if impl == 'fused-fwd':
        return {'root': root, 'impl': impl, **fused_fwd_times(),
                'registers': registers(built['fused_cell'][1])}
    if impl == 'fused-bwd':
        return {'root': root, 'impl': impl, **fused_bwd_times(),
                'registers': registers(built['fused_cell_bwd'][1])}
    if impl == 'ctc':
        return {'root': root, 'impl': impl, **ctc_times(),
                'registers': registers(built['ctc'][1])}
    dev = torch.device('cuda')
    model = get_model([[1, 0], [1, 0, 0], [1, 0, 0, 0]], use_rnn=True,
                      dropout_rate=0.2, data_norm=True,
                      compute_dtype=torch.bfloat16, device=dev,
                      grouped_impl=impl,
                      generator=torch.Generator().manual_seed(0))
    loaders = get_dataloaders('synthetic:64', batch_size=32)
    batches = list(loaders[1].full)
    trainer = Trainer(loaders, device=dev)
    trainer.init_state(model, seed=0)
    step = iter(range(1 << 30))

    def run(n):
        for _ in range(n):
            trainer.step(batches[next(step) % len(batches)], lr=1e-4)
        torch.cuda.synchronize()

    run(3)
    blocks = []
    for _ in range(BLOCKS):
        t0 = time.perf_counter()
        run(STEPS)
        blocks.append(1e3 * (time.perf_counter() - t0) / STEPS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(STEPS)
    kernel = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3 / STEPS
    return {'root': root, 'impl': impl, 'step_ms': float(np.median(blocks)),
            'step_ms_blocks': blocks,
            'kernel_ms': kernel if kernel > 0 else None}


def main(argv):
    if argv[:1] == ['--one']:
        print(json.dumps(measure(argv[1], argv[2])))
        return
    impl = 'auto'
    if argv[:1] == ['--impl']:
        impl, argv = argv[1], argv[2:]
    elif argv[:1] in (['--gconv'], ['--fused-fwd'], ['--fused-bwd'],
                      ['--ctc']):
        impl, argv = argv[0][2:], argv[1:]
    if not argv:
        raise SystemExit(__doc__)
    rows = []
    for root in argv:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--one', root, impl], cwd=root, env=env,
                             check=True, capture_output=True, text=True,
                             timeout=600)
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for row in rows:
        for case, r in row.get('ctc', {}).items():
            for k in ('device_ms', 'us_per_step', 'events_ms', 'digest'):
                summary.setdefault(row['root'], {}).setdefault(
                    f'{case} {k}', []).append(r[k])
        for k, v in row.items():
            if k not in ('root', 'impl', 'step_ms_blocks', 'per_node',
                         'registers', 'per_width', 'card',
                         'launches_by_name_per_step', 'fused_registers',
                         'bwd_registers', 'ctc') and \
                    not k.endswith('_kernels_ms'):
                summary.setdefault(row['root'], {}).setdefault(k, []).append(v)
    print(json.dumps({'summary': summary}))


if __name__ == '__main__':
    main(sys.argv[1:])
