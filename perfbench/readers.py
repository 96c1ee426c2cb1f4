"""What the per-layer readers (``perfbench/metrics/<name>.py``) share.

A reader takes the run's layer context: ``device`` (the
:class:`perfbench.trace.Trace` of the stretch profiled on the device
alone) and ``steps`` (the device steps in it); ``spans`` (the trace of the
stretch profiled with the host's spans) and ``cell_calls`` (``(B, T, C,
esize)`` of each search-cell call in that one); ``stretch_flops`` and
``stretch_seconds`` (the unprofiled stretch), ``cfg`` and ``esize``.
It returns a number, or None where it finds nothing to read; a share of a
peak or a roofline is never made up as 0.
"""

from . import flops

__all__ = ['idle_share', 'mfu', 'cell_roofline', 'launches_per_step']

CELL_RANGE = 'perfbench.cell'
BACKWARD_NODE = 'FusedCellBackward'


def _trace(ctx, which):
    tr = ctx.get(which)
    return tr if tr is not None and tr.kernels() else None


def idle_share(ctx):
    """% of the device-profiled window in which nothing ran on the
    device."""
    tr = _trace(ctx, 'device')
    if tr is None or tr.window_seconds() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy() / tr.window_seconds())


def mfu(ctx):
    """The unprofiled stretch's algorithmic FLOPs over its seconds, as a %
    of the compute dtype's peak."""
    if not ctx.get('stretch_flops') or not ctx.get('stretch_seconds'):
        return None
    return flops.mfu(ctx['stretch_flops'], ctx['stretch_seconds'],
                     ctx['esize'])


def cell_roofline(ctx, backward=False):
    """The least time of the span-profiled stretch's search-cell calls over
    the device time of the kernels they launched, %: the forward's
    launched inside the cells' spans, the backward's inside the autograd
    engine's ``FusedCellBackward`` nodes."""
    tr = _trace(ctx, 'spans')
    if tr is None or not ctx.get('cell_calls'):
        return None
    names = ([n for n in tr.ranges if BACKWARD_NODE in n] if backward
             else [CELL_RANGE])
    kernels = tr.layer_kernels(names)
    if not kernels:
        return None
    seconds = sum(e - s for s, e, _ in kernels) / 1e6
    least = sum(flops.least_seconds(
        *flops.cell_counts(ctx['cfg'], B, T, C, es, backward), es)
        for B, T, C, es in ctx['cell_calls'])
    return 100.0 * least / seconds


def launches_per_step(ctx):
    """Device kernels launched a device step in the device-profiled
    stretch."""
    tr = _trace(ctx, 'device')
    if tr is None or not ctx.get('steps'):
        return None
    return len(tr.kernels()) / ctx['steps']
