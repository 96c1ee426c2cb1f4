"""Spans and the device trace of a profiled stretch of a run.

The benchmark's spans are ``torch.profiler.record_function`` ranges named
``perfbench.<name>``, opened around the calls into each layer: module
hooks (:func:`hook_modules`), wrapped methods of the program's objects
(:func:`wrap_methods`) and the loops of the drivers (:func:`span`).  They
are installed for the profiled stretch only.

:func:`profile` runs a stretch under ``torch.profiler``, exports its
Chrome trace to ``perfbench/out/`` and reads it back as a :class:`Trace`.
A run profiles two stretches of the same work.  The first records the
device alone (``ProfilerActivity.CUDA``, no spans, no hooks), so that its
pace stays near the unprofiled one: busy and idle time, the window's
length by the host clock, the kernels and their count.  The second
records the host too (CPU and CUDA, with the spans): each kernel's launch
on the host (its runtime or driver call, joined by the profiler's
correlation id) and the host ranges, for attribution alone.  A kernel
belongs to a layer when its launch lies inside one of the layer's host
ranges on the launching thread, never by its name.
"""

import bisect
import collections
import contextlib
import json
import math
import pathlib
import time

import torch

__all__ = ['span', 'hook_modules', 'hook_cells', 'wrap_methods', 'profile',
           'Trace', 'OUT_DIR']

OUT_DIR = pathlib.Path(__file__).resolve().parent / 'out'
PREFIX = 'perfbench.'
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
_LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')


def span(name):
    """A host range ``perfbench.<name>``."""
    return torch.profiler.record_function(PREFIX + name)


def hook_modules(modules, name):
    """Open a ``perfbench.<name>`` range around every forward call of
    ``modules``; returns a function that removes the hooks."""
    open_ranges = {}

    def pre(module, args):
        rf = span(name)
        rf.__enter__()
        open_ranges.setdefault(id(module), []).append(rf)

    def post(module, args, out):
        open_ranges[id(module)].pop().__exit__(None, None, None)

    handles = []
    for m in modules:
        handles += [m.register_forward_pre_hook(pre),
                    m.register_forward_hook(post)]
    return lambda: [h.remove() for h in handles]


def hook_cells(model):
    """Open a ``perfbench.cell`` range around every call of ``model``'s
    search cells (its ``block<i>_cell<j>`` modules) and record each call's
    ``(B, T, C, bytes an element)``; returns the record and a function
    that removes the hooks."""
    cells = [m for n, m in model.named_children() if '_cell' in n]
    calls = []
    handles = [c.register_forward_pre_hook(
        lambda m, a: calls.append((*a[0].shape, a[0].element_size())))
        for c in cells]
    unhook = hook_modules(cells, 'cell')

    def undo():
        for h in handles:
            h.remove()
        unhook()
    return calls, undo


def wrap_methods(obj, names):
    """Run each of ``obj``'s methods in ``names`` (``{method: range}``)
    inside its range, by instance attributes that shadow the class's;
    returns a function that removes them."""
    for method, name in names.items():
        bound = getattr(obj, method)

        def wrapped(*a, _bound=bound, _name=name, **k):
            with span(_name):
                return _bound(*a, **k)
        setattr(obj, method, wrapped)
    return lambda: [obj.__dict__.pop(m, None) for m in names]


@contextlib.contextmanager
def profile(name, sync, spans):
    """Profile the body, which starts on an idle device, until ``sync()``
    after it; the body's :class:`Trace` is set on the yielded holder's
    ``trace`` once the block has ended.  With ``spans`` the host is
    recorded too, inside a ``perfbench.window`` range; without, only the
    device, and the window is the body's length by the host clock."""
    from torch.profiler import ProfilerActivity
    holder = type('Profiled', (), {'trace': None})()
    OUT_DIR.mkdir(exist_ok=True)
    want = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if spans
            else [ProfilerActivity.CUDA])
    activities = [a for a in want
                  if a in torch.profiler.supported_activities()]
    recorder = (torch.profiler.profile(activities=activities) if activities
                else contextlib.nullcontext())   # a build without CUDA
    window = span('window') if spans else contextlib.nullcontext()
    with recorder as prof, window:
        t = time.perf_counter()
        yield holder
        sync()
        window_s = time.perf_counter() - t
    chrome = {}
    if activities:
        path = OUT_DIR / f"{name}.{'spans' if spans else 'device'}.json"
        prof.export_chrome_trace(str(path))
        chrome = json.loads(path.read_text())
    holder.trace = Trace(chrome, window_s=None if spans else window_s)


class Trace:
    """The events of one profiled stretch (times in microseconds)."""

    def __init__(self, chrome, window_s=None):
        """``window_s``: the window's length by the host clock, for a
        trace without host ranges; every device event of such a trace is
        inside its window."""
        events = [e for e in chrome.get('traceEvents', [])
                  if e.get('ph') == 'X' and 'ts' in e]
        self.device = []          # (start, end, name, correlation, external)
        launches = {}             # correlation -> (tid, ts)
        ops = {}                  # external id -> (tid, ts)
        ranges = collections.defaultdict(list)   # name -> [(tid, s, e)]
        for e in events:
            cat, ts = e.get('cat'), float(e['ts'])
            end = ts + float(e.get('dur', 0.0))
            args = e.get('args') or {}
            if cat in _DEVICE_CATS:
                self.device.append((ts, end, e['name'], cat,
                                    args.get('correlation'),
                                    args.get('External id')))
            elif cat in _LAUNCH_CATS and 'correlation' in args:
                launches[args['correlation']] = (e.get('tid'), ts)
            elif cat in ('cpu_op', 'user_annotation'):
                if args.get('External id') is not None:
                    ops.setdefault(args['External id'], (e.get('tid'), ts))
                ranges[e['name']].append((e.get('tid'), ts, end))
        self.device.sort()
        self._launch = []
        for *_, corr, ext in self.device:
            where = launches.get(corr)
            if where is None and ext is not None:
                where = ops.get(ext)
            self._launch.append(where)
        self.ranges = {}
        for name, items in ranges.items():
            by_tid = collections.defaultdict(list)
            for tid, s, e in items:
                by_tid[tid].append((s, e))
            self.ranges[name] = {t: sorted(v) for t, v in by_tid.items()}
        self.window_s = window_s
        if window_s is not None:
            self.main_tid, self.window = None, (-math.inf, math.inf)
            return
        win = self.ranges.get(PREFIX + 'window', {})
        self.main_tid, spans = next(iter(win.items()), (None, [(0.0, 0.0)]))
        self.window = spans[0]

    # -- what ran on the device ------------------------------------------
    def kernels(self):
        """``(start, end, name)`` of the kernels inside the window."""
        s0, s1 = self.window
        return [(s, e, n) for s, e, n, cat, *_ in self.device
                if cat == 'kernel' and s >= s0 and e <= s1]

    def _inside(self, where, names):
        if where is None:
            return False
        tid, ts = where
        for name in names:
            spans = self.ranges.get(name, {}).get(tid, [])
            i = bisect.bisect_right(spans, (ts, float('inf'))) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                return True
        return False

    def layer_kernels(self, names):
        """``(start, end, name)`` of the window's kernels launched inside a
        host range of ``names`` (exact range names)."""
        s0, s1 = self.window
        return [(s, e, n) for (s, e, n, cat, *_), where
                in zip(self.device, self._launch)
                if cat == 'kernel' and s >= s0 and e <= s1
                and self._inside(where, names)]

    def busy(self):
        """Seconds in which something ran on the device, in the window."""
        return sum(e - s for s, e in self._union()) / 1e6

    def window_seconds(self):
        if self.window_s is not None:
            return self.window_s
        return (self.window[1] - self.window[0]) / 1e6

    def _union(self):
        s0, s1 = self.window
        merged = []
        for s, e, *_ in self.device:
            s, e = max(s, s0), min(e, s1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def gaps(self):
        """``(start, end)`` of the window's idle stretches."""
        s0, s1 = self.window
        out, t = [], s0
        for s, e in self._union():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if s1 > t:
            out.append((t, s1))
        return out

    def host_range_at(self, t):
        """The innermost ``perfbench.`` range of the main thread at ``t``."""
        best = None
        for name, by_tid in self.ranges.items():
            if not name.startswith(PREFIX) or name == PREFIX + 'window':
                continue
            for s, e in by_tid.get(self.main_tid, []):
                if s <= t <= e and (best is None or s >= best[1]):
                    best = (name[len(PREFIX):], s)
        return best[0] if best else 'other'

    def device_ops(self, top=10):
        """The ``top`` kernels by their summed device seconds."""
        by_name = collections.Counter()
        for s, e, n in self.kernels():
            by_name[n[:120]] += (e - s) / 1e6
        return [[n, v] for n, v in by_name.most_common(top)]

    def idle_gaps(self, top=10):
        """The ``top`` longest idle gaps, each with the host range the
        main thread was in (a trace with host ranges)."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return [[self.host_range_at((s + e) / 2), (e - s) / 1e6]
                for s, e in gaps]
