"""One traced run of a cell with the program's own tracing on: the
per-layer numbers of :mod:`perfbench.program_spans` beside the run's
result, and what tracing costs when it is on.

    python3 -m perfbench.program_layers --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with the cell's CUDA card.  It is
``python3 -m perfbench.run ... --trace 1`` with two additions made from
outside ``perfbench/drivers/``, whose files stay as they are:

- the program's tracing (``nbasr_torch.utils.tracing``) is on during the
  span-profiled stretch, so its trace holds the program's ranges, and that
  stretch's snapshot of the program's counters is kept (``program``);
- after the profiled stretches, counter stretches run with no profiler,
  three with tracing on between four with it off: in training, after the
  steps to the end of the ``Loader``'s epoch, one whole epoch each (the
  same batch shapes for every seed); in serving, ``trace_calls`` emitting
  calls from the first group each.  The snapshot of the three with tracing
  on (``counted``) and their steps or emitting calls (``counted_steps``)
  feed the host-time readers; their mean pace against the others' is the
  cost of tracing.

The last line of standard output is the result of :func:`perfbench.run.
run_cell` with ``program_layers`` (each reader's number, None where it
found nothing), ``tracing_on`` (each counter stretch's seconds a step or
emitting call, and the cost of tracing in %), ``program_spans`` (the
spans' calls, inclusive and self host ms a step or emitting call),
``program_kernels`` (the span stretch's kernels launched inside each
range, their count and device ms) and ``program_counts`` added.
"""

import argparse
import contextlib
import json
import sys

from . import run as bench_run
from . import program_spans
from . import trace as bench_trace
from .common import now
from .drivers import serve as serve_driver
from .drivers import train as train_driver

import torch  # noqa: E402  (after perfbench.run has set the thread counts)

__all__ = ['READERS', 'traced_run', 'main']

READERS = {'train': ['lstm_launches_per_frame', 'lstm_us_per_frame',
                     'loader_ms'],
           'serve': ['lstm_launches_per_frame', 'block_conv_ms',
                     'push_host_ms']}
#: counter stretches with tracing on, each between two with it off
TURNS = 3


def _tracing():
    from nbasr_torch.utils import tracing
    return tracing


def _counted(stretch):
    """``stretch()`` (seconds, steps) with tracing off and on in turns, off
    first and last (``TURNS`` on, ``TURNS + 1`` off): the snapshot of the
    stretches with it on, their steps, and each stretch's seconds a
    step."""
    tracing = _tracing()
    tracing.reset()
    pace, steps = {'off': [], 'on': []}, 0
    for i in range(2 * TURNS + 1):
        on = i % 2 == 1
        with tracing.enabled() if on else contextlib.nullcontext():
            seconds, n = stretch()
        pace['on' if on else 'off'].append(seconds / n)
        steps += n if on else 0
    return {'counted': tracing.snapshot(), 'counted_steps': steps,
            'pace': pace}


@contextlib.contextmanager
def _additions(state):
    """The program's tracing in the span-profiled stretch, and the counter
    stretch after the profiled ones; ``state`` receives what they read."""
    real_profile = bench_trace.profile
    real_train, real_serve = train_driver._profiled, serve_driver._profiled

    @contextlib.contextmanager
    def profile(name, sync, spans):
        if not spans:
            with real_profile(name, sync, spans) as holder:
                yield holder
            return
        tracing = _tracing()
        tracing.reset()
        with tracing.enabled(), real_profile(name, sync, spans) as holder:
            yield holder
        state['program'] = tracing.snapshot()

    def train_profiled(trainer, it, name, sync, lr, span_steps):
        out = real_train(trainer, it, name, sync, lr, span_steps)
        for _ in range(it.left_in_epoch()):
            trainer.step(next(it), training=True, lr=lr)

        def epoch():
            t = now()
            for _ in range(it.per_epoch):
                trainer.step(next(it), training=True, lr=lr)
            sync()
            return now() - t, it.per_epoch
        state.update(_counted(epoch))
        return out

    def serve_profiled(model, mix, groups, device, sync, name, calls):
        out = real_serve(model, mix, groups, device, sync, name, calls)

        def stretch():
            book = serve_driver._Calls(limit=calls)
            t = now()
            serve_driver._serve_calls(model, mix, groups, device, book)
            sync()
            return now() - t, len(book.lat)
        state.update(_counted(stretch))
        return out

    bench_trace.profile = profile
    train_driver._profiled = train_profiled
    serve_driver._profiled = serve_profiled
    try:
        yield
    finally:
        bench_trace.profile = real_profile
        train_driver._profiled, serve_driver._profiled = \
            real_train, real_serve


def traced_run(name, seed, seconds, device, overrides=None, t0=None):
    """:func:`perfbench.run.run_cell` with ``--trace 1`` and the additions
    (see the module docstring); the result with the keys the module
    docstring lists added."""
    kind = bench_run.cell_spec(name)[2]['kind']
    state, layers = {}, []
    driver = {'train': train_driver, 'serve': serve_driver}[kind]
    real_run = driver.run

    def keep(*a, **k):
        out = real_run(*a, **k)
        out['layer'].update(state)
        layers.append(out['layer'])
        return out
    driver.run = keep
    try:
        with _additions(state):
            result = bench_run.run_cell(name, seed, seconds, 1, device,
                                        overrides, t0)
    finally:
        driver.run = real_run
    ctx = layers[0]
    result['program_layers'] = {r: getattr(program_spans, r)(ctx)
                                for r in READERS[kind]}
    pace = ctx['pace']
    mean = {k: sum(v) / len(v) for k, v in pace.items()}
    result['tracing_on'] = {'pace_s': pace,
                            'cost_pct': 100.0 * (mean['on'] / mean['off'] - 1)}
    tr, steps = ctx['spans'], ctx['counted_steps']
    result['program_spans'] = {
        n: {'calls': s['calls'] / steps, 'ms': s['ns'] / 1e6 / steps,
            'self_ms': s['self_ns'] / 1e6 / steps}
        for n, s in ctx['counted']['spans'].items()}
    result['program_kernels'] = {
        n: [len(k), sum(e - s for s, e, _ in k) / 1e3]
        for n in sorted(r for r in tr.ranges if r.startswith('nbasr.'))
        for k in [tr.layer_kernels([n])]}
    result['program_counts'] = ctx['program']['counts']
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m perfbench.program_layers',
        description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device('cuda', 0)
    print(f'card: {bench_run._card_line()}', flush=True)
    result = traced_run(args.workload, args.seed, args.seconds, device,
                        t0=bench_run.T0)
    print(result.pop('note'), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
