"""The port's tracer: host-clock spans at layer boundaries and flat
counters, kept in memory.

A span (`span(name)`, a context manager) records its name, its start and
end on `time.perf_counter_ns`, its parent (the innermost span open on the
same thread) and its request: `request(kind)` opens a top-level span
(`serving.request`, `train.step`) whose id every span opened inside it
carries. Closed spans go into a ring of `RING` spans, so a long-running
server does not grow. A span opened while a `torch.profiler` session
records is marked `profiled` and also enters
`record_function("pillarnet.<name>")`, so that it lies on the profiler's
timeline beside the kernels it launched; the profiler's own cost inflates
such a span's host time, and readers of the steady state leave them out.

The level, read from `PILLARNET_TRACE` at import or set by
`configure(level)`:

- `off`: `span` and `request` return one shared no-op context;
- `host` (the default): host-clock spans, a few microseconds each;
- `device`: a CUDA event on the current stream at each end of every span
  as well, for the device ms between them (a request's or a layer's time
  on the card); `tools/dist_test.py --speed_test` and `profile_port.py`
  set it.

Counters (`count(name, n)`) are plain integer adds at the same
boundaries, counted at every level: `serving.requests`, `serving.frames`,
`train.steps`, `host_syncs` (the program's own waits on the card:
`runtime.serving.to_host` and the trainer's metric reads), and the hand
kernels' launches, which `ops/_kernels.py` counts into `LAUNCHES` and
`counters()` shows as `launch.<kernel>`.

While `torch.export` or `torch.compile` traces (`torch.compiler.
is_compiling()`), spans are the no-op and nothing is counted.

Reading: `snapshot()` (every span in the ring and the counters),
`summary(kind)` (the median ms of each span name over the requests of a
kind), `last(name)` (the newest closed span of a name), `reset()`.
"""

import contextlib
import itertools
import os
import statistics
import threading
import time
from collections import deque

import torch

LEVELS = ("off", "host", "device")
RING = 65536
# substrings that the benchmark's profiler reader counts as launch calls
_RESERVED = ("LaunchKernel", "cuLaunch", "Memset", "Memcpy")

LAUNCHES = {}  # hand kernel -> launches; `ops/_kernels.py` fills the keys

_NULL = contextlib.nullcontext()
_spans = deque(maxlen=RING)
_counters = {}
_ids = itertools.count(1)
_local = threading.local()
_names = set()
_level = 1


def configure(level):
    """Set the level (`off`, `host` or `device`); returns the previous
    one."""
    global _level
    if level not in LEVELS:
        raise ValueError(f"trace level {level!r}: expected one of {LEVELS}")
    prev = LEVELS[_level]
    _level = LEVELS.index(level)
    return prev


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _check(name):
    if any(r in name for r in _RESERVED):
        raise ValueError(f"span name {name!r} holds one of {_RESERVED}, "
                         "which profiler readers take for launch calls")
    _names.add(name)


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns",
                 "profiled", "_rf", "_events", "_device_ms")

    def __init__(self, name, top):
        if name not in _names:
            _check(name)
        self.name = name
        self.id = next(_ids)
        self.request = self.id if top else None
        self._rf = self._events = self._device_ms = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.request is None and parent is not None:
            self.request = parent.request
        self.profiled = torch._C._autograd._profiler_enabled()
        if self.profiled:
            self._rf = torch.profiler.record_function("pillarnet." + self.name)
            self._rf.__enter__()
        if _level == 2 and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _spans.append(self)
        return False

    def device_ms(self):
        """Device ms between the span's two events (after a sync), or
        None below the `device` level."""
        if self._events is not None:
            self._events[1].synchronize()
            self._device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None
        return self._device_ms

    def record(self):
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "profiled": self.profiled,
                "device_ms": self.device_ms()}


def span(name):
    """A span named `name` under the innermost open one (a context
    manager); the shared no-op at `off` and under compilation."""
    if _level == 0 or torch.compiler.is_compiling():
        return _NULL
    return _Span(name, False)


def request(kind):
    """A top-level span whose id the spans inside it carry as their
    request."""
    if _level == 0 or torch.compiler.is_compiling():
        return _NULL
    return _Span(kind, True)


def count(name, n=1):
    """Add `n` to counter `name` (nothing under compilation)."""
    if not torch.compiler.is_compiling():
        _counters[name] = _counters.get(name, 0) + n


def counters():
    """Every counter, the kernels' launches as `launch.<kernel>`."""
    out = dict(_counters)
    out.update((f"launch.{k}", v) for k, v in LAUNCHES.items())
    return out


def snapshot():
    """{'spans': a record per span in the ring, oldest closed first
    (name, id, parent, request, start_ns, end_ns, profiled, device_ms),
    'counters': `counters()`}."""
    return {"spans": [s.record() for s in list(_spans)],
            "counters": counters()}


def reset():
    """Drop every span and zero every counter, the launches included."""
    _spans.clear()
    _counters.clear()
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def last(name):
    """The record of the newest closed span named `name`, or None."""
    for s in reversed(_spans):
        if s.name == name:
            return s.record()
    return None


def summary(kind, profiled=False, since_ns=0):
    """The median over the recorded `kind` requests (those opened while a
    profiler recorded, with `profiled`; from `since_ns` on the span
    clock) of each span name's ms in a request, summed over its
    occurrences there; the request's own span is under `kind`. -> {name:
    {'host_ms', 'device_ms' (None below the `device` level), 'requests':
    how many requests held the name}}."""
    per = {}
    for s in list(_spans):
        if s.request is not None and s.profiled == profiled \
                and s.start_ns >= since_ns:
            per.setdefault(s.request, []).append(s)
    acc = {}
    for spans in per.values():
        if not any(s.name == kind and s.id == s.request for s in spans):
            continue
        sums = {}
        for s in spans:
            host, dev = sums.get(s.name, (0.0, 0.0))
            d = s.device_ms()
            sums[s.name] = (host + (s.end_ns - s.start_ns) * 1e-6,
                            None if d is None or dev is None else dev + d)
        for name, v in sums.items():
            acc.setdefault(name, []).append(v)
    return {name: {"host_ms": statistics.median(h for h, _ in v),
                   "device_ms": (statistics.median(d for _, d in v)
                                 if all(d is not None for _, d in v)
                                 else None),
                   "requests": len(v)}
            for name, v in acc.items()}


configure(os.environ.get("PILLARNET_TRACE", "host"))
