"""Readers of the program's own spans and counters (``nbasr_torch.utils.
tracing``): per-layer numbers of layers the benchmark's outside spans
cannot see into.

They read a run's layer context (see :mod:`perfbench.readers`) with these
keys besides, which a run fills while the program's tracing is on:

- ``spans``: the span-profiled stretch's :class:`perfbench.trace.Trace`,
  holding the program's ``nbasr.<name>`` ranges;
- ``program``: ``tracing.snapshot()`` of that stretch (the counter
  ``lstm.frames``, the spans' calls: ``serve.device_step``'s are its
  device steps);
- ``counted``: ``tracing.snapshot()`` of a stretch run with tracing on and
  no profiler, and ``counted_steps``: its train steps, or its emitting
  serving calls.

Each returns a number, or None where it finds nothing to read.  A kernel
belongs to a layer when its launch lies inside one of the layer's ranges
on the launching thread (the autograd engine's own for a backward range),
never by its name.
"""

__all__ = ['LSTM', 'BLOCK_CONV', 'lstm_launches_per_frame',
           'lstm_us_per_frame', 'loader_ms', 'block_conv_ms', 'push_host_ms']

LSTM = ('nbasr.lstm', 'nbasr.lstm.backward')
BLOCK_CONV = ('nbasr.block_conv',)


def _layer(ctx, names):
    """The span stretch's kernels launched inside ``names``, or None."""
    tr = ctx.get('spans')
    if tr is None:
        return None
    return tr.layer_kernels(list(names)) or None


def _lstm(ctx):
    kernels = _layer(ctx, LSTM)
    frames = ((ctx.get('program') or {}).get('counts') or {}).get(
        'lstm.frames')
    return (kernels, frames) if kernels and frames else (None, None)


def lstm_launches_per_frame(ctx):
    """Kernels launched inside ``FastLSTM``'s forward and backward ranges,
    a frame of its input (the counter ``lstm.frames``)."""
    kernels, frames = _lstm(ctx)
    return None if kernels is None else len(kernels) / frames


def lstm_us_per_frame(ctx):
    """The device microseconds of those kernels a frame."""
    kernels, frames = _lstm(ctx)
    return None if kernels is None else sum(
        e - s for s, e, _ in kernels) / frames


def block_conv_ms(ctx):
    """The device ms, a device step, of the kernels launched inside the
    block convs' ranges (``PadConvRelu``)."""
    kernels = _layer(ctx, BLOCK_CONV)
    spans = (ctx.get('program') or {}).get('spans') or {}
    steps = spans.get('serve.device_step', {}).get('calls')
    if kernels is None or not steps:
        return None
    return sum(e - s for s, e, _ in kernels) / 1e3 / steps


def _counted_ms(ctx, names, key):
    spans = (ctx.get('counted') or {}).get('spans') or {}
    found = [spans[n][key] for n in names if n in spans]
    if not found or not ctx.get('counted_steps'):
        return None
    return sum(found) / 1e6 / ctx['counted_steps']


def loader_ms(ctx):
    """The ``Loader``'s batch assembly (``loader.batch``, inclusive host
    time), ms a train step."""
    return _counted_ms(ctx, ['loader.batch'], 'ns')


def push_host_ms(ctx):
    """``StreamingASR.push`` and ``flush``'s own host time (self time: less
    the frontend and the device steps inside them), ms an emitting call."""
    return _counted_ms(ctx, ['serve.push', 'serve.flush'], 'self_ns')
