"""Spans and counters of the port's layers, on the profiler's clock.

Off by default.  Off, :func:`span` returns one shared null context after a
single test of a module global, :func:`count` returns at once and
:func:`module_span` calls the forward it wraps: no profiler range and no
gradient hook is added.

On (:func:`enable`, or ``with enabled():``), a span is a profiler range
named ``nbasr.<name>`` (``torch._C._profiler._RecordFunctionFast``, the
range ``torch.profiler.record_function`` opens, at a tenth of its host
cost), so a ``torch.profiler`` trace puts every kernel a span launches
inside it, on the launching thread.  A span's ``id`` (a train step's
``step_count``, a streamer's call index) goes into the range's ``args``
when the profiler records shapes.  Each span also adds to in-memory
aggregates of its name: calls, inclusive host ns and self host ns (the
span less what its child spans on the same thread cover); counters add to
totals by name.  :func:`snapshot` reads both, :func:`reset` clears them;
per-call detail lives in the profiler's trace.

:func:`module_span` gives a module's forward a ``nbasr.<name>`` range.
With grad enabled, a pre-hook of its output's autograd node opens
``nbasr.<name>.backward`` and a hook on its input's gradient closes it, so
the module's backward kernels fall inside a range on the thread that
launches them (the autograd engine's own thread on CUDA); no autograd node
is added.  A call whose input needs no gradient (the first block conv and
the Conformer's subsampling, on the features) has its backward range
closed by the gradient of the module's first parameter instead; a module
with no parameter that needs one gets no backward range.

Spans sit at layer boundaries, one per layer call, never inside a
per-frame loop or on a kernel's launch path.
"""

import contextlib
import functools
import threading
import time

import torch
from torch.autograd.graph import get_gradient_edge

__all__ = ['enable', 'disable', 'enabled', 'is_enabled', 'span', 'count',
           'module_span', 'snapshot', 'reset', 'PREFIX']

PREFIX = 'nbasr.'

_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_spans = {}              # name -> [calls, inclusive ns, self ns]
_counts = {}             # name -> total
_local = threading.local()


def enable():
    """Turn tracing on for the whole process."""
    global _on
    _on = True


def disable():
    """Turn tracing off; the aggregates stay until :func:`reset`."""
    global _on
    _on = False


def is_enabled():
    return _on


@contextlib.contextmanager
def enabled():
    """Tracing on inside the block, as it was before after it."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before


def _stack():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One open span: its profiler range and its share of the aggregates."""

    __slots__ = ('name', 'range', 't0', 'child')

    def __init__(self, name, id=None):
        self.name = name
        fast = torch._C._profiler._RecordFunctionFast
        self.range = (fast(PREFIX + name) if id is None
                      else fast(PREFIX + name, (), {'id': int(id)}))

    def __enter__(self):
        self.range.__enter__()
        self.child = 0
        _stack().append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        self.range.__exit__(*exc)
        stack = _stack()
        # spans above this one are left open (a backward span whose closing
        # hook did not fire): drop them with it
        if self in stack:
            del stack[stack.index(self):]
        if stack:
            stack[-1].child += ns
        with _lock:
            agg = _spans.setdefault(self.name, [0, 0, 0])
            agg[0] += 1
            agg[1] += ns
            agg[2] += ns - self.child
        return False


def span(name, id=None):
    """A context manager: the span ``name`` (``nbasr.<name>``) when tracing
    is on, the shared null context when it is off."""
    if not _on:
        return _NULL
    return _Span(name, id)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` when tracing is on."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


class _BackwardSpan(_Span):
    """A module call's backward span, opened and closed by gradient hooks;
    a hook that fires out of turn (a second backward through a retained
    graph) does nothing."""

    __slots__ = ('open', 'closer')

    def __init__(self, name, closer):
        super().__init__(name)
        self.open = False
        self.closer = closer

    def begin(self, grad):
        # a backward pass that will not reach the closing hook (gradients
        # of parameters alone) opens no span
        if not self.open and torch._C._will_engine_execute_node(self.closer):
            self.open = True
            self.__enter__()

    def end(self, grad):
        if self.open:
            self.open = False
            self.__exit__(None, None, None)


def _first_leaf(module):
    return next((p for p in module.parameters() if p.requires_grad), None)


def module_span(name):
    """Decorate a module's ``forward(self, x, ...)``: with tracing on, the
    call runs inside the span ``name`` and, with grad enabled and ``x``
    needing a gradient, its backward inside ``<name>.backward``: a pre-hook
    of the output's autograd node opens that span, and a hook on ``x``'s
    gradient, which is complete once every op of the call has run its
    backward, closes it.  Where one call's output is the next call's input,
    the engine runs the tensor's hook (the next call's close) before the
    node's pre-hook (this call's open), so the spans nest.  A forward that
    returns a tuple has its first item hooked.  A call whose ``x`` needs no
    gradient is closed by a one-shot hook on the gradient of the module's
    first parameter, which its first layer's backward, the call's last,
    computes."""
    def wrap(forward):
        @functools.wraps(forward)
        def traced(self, x, *args, **kwargs):
            if not _on:
                return forward(self, x, *args, **kwargs)
            with _Span(name):
                out = forward(self, x, *args, **kwargs)
            y = out[0] if isinstance(out, tuple) else out
            if not (torch.is_grad_enabled() and y.requires_grad):
                return out
            closer = x if x.requires_grad else _first_leaf(self)
            if closer is None:
                return out
            back = _BackwardSpan(name + '.backward',
                                 get_gradient_edge(closer).node)
            y.grad_fn.register_prehook(back.begin)
            if closer is x:
                x.register_hook(back.end)
            else:
                handle = None

                def end(grad):
                    back.end(grad)
                    handle.remove()
                handle = closer.register_hook(end)
            return out
        return traced
    return wrap


def snapshot():
    """``{'spans': {name: {'calls', 'ns', 'self_ns'}}, 'counts': {name:
    total}}`` of everything recorded since the last :func:`reset`."""
    with _lock:
        return {'spans': {n: {'calls': c, 'ns': ns, 'self_ns': s}
                          for n, (c, ns, s) in _spans.items()},
                'counts': dict(_counts)}


def reset():
    """Clear the aggregates and counters."""
    with _lock:
        _spans.clear()
        _counts.clear()
