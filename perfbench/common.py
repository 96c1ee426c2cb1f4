"""What the drivers share: the program's model built from a
configuration by its architecture (:mod:`perfbench.archs`) with the run's
weights, the clock, and the pace lines of a run's note."""

import time

import torch

from . import archs, weights

__all__ = ['now', 'syncer', 'build_model', 'by_parts', 'profiled_pace',
           'DTYPES']

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
now = time.perf_counter


def syncer(device):
    """A function that waits for ``device``'s queued work."""
    if device.type == 'cuda':
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def build_model(cfg, mix, seed, device):
    """The program's model of ``cfg`` through its architecture's ``build``
    (the port's own factory), with the run's weights
    (:mod:`perfbench.weights`) in place of its initialisation; also the
    weights, which the reference takes."""
    model = archs.find(cfg).build(cfg, mix, device)
    w = weights.generate(cfg, seed, device)
    weights.install(model, w)
    return model, w


def by_parts(marks, start, end):
    """The rate in each fifth of ``[start, end]``, from ``marks``, ``(time,
    running total)`` at the end of each step: each step's amount counts in
    the fifth where it ended.  Fifths that differ as much as whole runs do
    show that a longer window would not steady the runs."""
    parts = 5
    width = (end - start) / parts
    sums, last = [0.0] * parts, 0.0
    for t, total in marks:
        sums[min(int((t - start) / width), parts - 1)] += total - last
        last = total
    return ' '.join(f'{v / width:.1f}' for v in sums)


def profiled_pace(unprofiled, d, s):
    """A note on how far profiling slowed the steps: the seconds a step
    unprofiled, profiled on the device alone (``d``) and with the spans
    (``s``), and each profiled pace over the unprofiled one."""
    return (f's a step: unprofiled {unprofiled:.4f}, device-profiled {d:.4f} '
            f'(x{d / unprofiled:.3f}), span-profiled {s:.4f} '
            f'(x{s / unprofiled:.3f})')
