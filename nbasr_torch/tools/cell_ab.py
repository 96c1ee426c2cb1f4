"""A/B of the fused cell's serving forward between checkouts, on one card.

    python3 nbasr_torch/tools/cell_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

For each root in the order given (A B B A shows drift between runs), a
fresh process imports ``nbasr_torch`` from that root, builds its kernels
there with ``_build.build()``, and times the 18 flagship cells of one
serving step (B=4, T = 772/772/386/193 at C = 600/800/1000/1200, as
``chip_smoke.py``'s kernel phase) in f32 and bf16:

- ``events_ms``: the CUDA-event median of 30 calls per cell, summed over
  the 18 cells;
- ``kernel_ms``: the device time of the ``nbasr_*`` kernels in a
  ``torch.profiler`` trace of 20 such steps, per step (host time between
  launches does not count);
- ``digest``: a SHA-256 of the 18 cells' outputs, and ``train_digest`` of
  the training forward's outputs and saved multipliers at dropout 0.2 on
  one seed (equal digests: equal bits).

Only the API that every version of the port has is used (``SearchCell``,
``operands``, ``train_spec``, ``fused_cell_forward``,
``fused_cell_train_forward``, ``_build.build``).  One JSON line per root,
then a summary line.
"""

import hashlib
import json
import os
import subprocess
import sys

WIDTHS = ((600, 772), (800, 772), (1000, 386), (1200, 193))
CELLS_PER_BLOCK = (3, 4, 5, 6)
B = 4
STEPS = 20


def measure(root):
    """The timings of one root, in this process."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import nbasr_torch
    from nbasr_torch.models.cell import SearchCell
    from nbasr_torch.ops import _build, fused_cell
    from nbasr_torch.search_space import arch_vec_to_names
    assert nbasr_torch.__file__.startswith(os.path.abspath(root)), \
        nbasr_torch.__file__
    _build.build()
    names = arch_vec_to_names([[1, 0], [1, 0, 0], [1, 0, 0, 0]])
    dev = torch.device('cuda')
    out = {'root': root}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            calls, events = [], 0.0
            digest, train_digest = hashlib.sha256(), hashlib.sha256()
            seed = torch.tensor([1234567, 7654321], dtype=torch.int32,
                                device=dev)
            for (C, T), n in zip(WIDTHS, CELLS_PER_BLOCK):
                g = torch.Generator().manual_seed(C)
                cell = SearchCell(C, names, groups=100, init_scheme='scaled',
                                  generator=g).to(dev)
                x = torch.randn((B, T, C), generator=g).to(dev, dtype)
                args = (cell.spec, x, *cell.operands(dtype))
                call = lambda args=args: fused_cell.fused_cell_forward(*args)
                digest.update(_bytes(call()))
                for t in fused_cell.fused_cell_train_forward(
                        cell.train_spec, x, *cell.operands(dtype), seed)[::2]:
                    train_digest.update(_bytes(t))
                for _ in range(5):
                    call()
                times = []
                for _ in range(30):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    call()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                events += n * float(np.median(times))
                calls += [call] * n
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(STEPS):
                    for call in calls:
                        call()
                torch.cuda.synchronize()
            kernel = sum(e.self_device_time_total for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA
                         and 'nbasr_' in e.key) / 1e3 / STEPS
            key = str(dtype)[6:]
            out[f'{key}_digest'] = digest.hexdigest()
            out[f'{key}_train_digest'] = train_digest.hexdigest()
            out[f'{key}_events_ms'] = events
            out[f'{key}_kernel_ms'] = kernel if kernel > 0 else None
    return out


def _bytes(t):
    import torch
    return t.detach().contiguous().view(-1).view(torch.uint8).cpu() \
        .numpy().tobytes()


def main(argv):
    if argv[:1] == ['--one']:
        print(json.dumps(measure(argv[1])))
        return
    if not argv:
        raise SystemExit(__doc__)
    rows = []
    for root in argv:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--one', root], cwd=root, env=env, check=True,
                             capture_output=True, text=True, timeout=600)
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for row in rows:
        for k, v in row.items():
            if k != 'root':
                summary.setdefault(row['root'], {}).setdefault(k, []).append(v)
    print(json.dumps({'summary': summary}))


if __name__ == '__main__':
    main(sys.argv[1:])
