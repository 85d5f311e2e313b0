"""The port's spans and counters, held in memory for the last recording window.

A span is one interval of the program at a layer boundary: a stage
dispatch (`parallel/whole_graph.py`), a staged sort or one of its phases,
an evaluator op.  It holds

  name      what ran (`mehp24.cmp`, `direct.construct_rank`, `ev.modup`)
  id        its number in the window; `parent` the id of the span it ran in
  sort      one id per outermost span (one call of a staged sort or of one
            of its phases), shared by every span under it
  start, end   host nanoseconds on the profiler's clock
  device    (start, end) nanoseconds of its device work on the same clock,
            or None where the span was opened without a device
  counts    what the code recorded at the same boundary (a dispatch's
            `kind`, NTT `planes`, K1 to K4 `launches`, `ops`)

Spans are recorded inside `recording()`, an operator's explicit window, and
whenever a `torch.profiler` session is recording: the first span opened in
a session starts a new window (ended by the first span opened after the
session, or by reading it; two sessions with neither between them share
one), and each recorded span also enters the profiler's trace as a
`record_function` annotation of its name.  Outside those, opening a span is
one check that returns a shared empty context: no clock read, no
allocation, no event.  There is no exporter: the profiler's Chrome trace
carries the spans, and `spans()` returns the last window's.

The clock: the profiler's events carry Unix-epoch nanoseconds, which is
`time.time_ns()`.  A span's host interval is taken outside its annotation,
so it holds the annotation's event.

Device intervals: on a CUDA device a span records a timing
`torch.cuda.Event` on the current stream where it opens and another where it
closes (none while that stream is capturing a CUDA graph).  The window's
first such span synchronises the device and records an anchor event
against a host timestamp (`_anchor`); `spans()` places every event on the
host clock by its elapsed time from the anchor.  On a CPU device the ops run
synchronously, and the device interval is the host interval.
"""

from __future__ import annotations

import functools
import itertools
import time
from contextlib import contextmanager, nullcontext

import torch


class Span:
    """One recorded span (see the module docstring)."""

    __slots__ = ("name", "id", "parent", "sort", "start", "end", "device", "counts", "_events")

    def __init__(self, name: str, id: int, parent: int | None, sort: int):
        self.name, self.id, self.parent, self.sort = name, id, parent, sort
        self.start = self.end = None
        self.device = None
        self.counts: dict = {}
        self._events = None

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, sort={self.sort}, "
                f"host_ns={self.end - self.start if self.end else None}, counts={self.counts})")


class _Window:
    def __init__(self):
        self.spans: list[Span] = []
        self.anchor = None          # (event, host ns)
        self.ids = itertools.count()
        self.sorts = itertools.count()


# the span outside a window: enters as None
_NULL = nullcontext()


def _anchor(dev, stream) -> tuple:
    """(event, host ns) of an event the idle device ran at that host time:
    recorded four times, each record bracketed by the host clock, and the
    tightest bracket's start kept.  The first record of a process or of a
    profiler session can take milliseconds, and under a profiler the call
    returns tens of microseconds after the device has run the event."""
    torch.cuda.synchronize(dev)
    best = None
    for _ in range(4):
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.time_ns()
        ev.record(stream)
        t1 = time.time_ns()
        ev.synchronize()
        if best is None or t1 - t0 < best[1]:
            best = (ev, t1 - t0, t0)
    return best[0], best[2]


class _Recorder:
    def __init__(self, tracer: "Tracer", name: str, device):
        self.tracer, self.name, self.device = tracer, name, device

    def __enter__(self) -> Span:
        tr = self.tracer
        w = tr._window
        parent = tr._stack[-1] if tr._stack else None
        sp = Span(self.name, next(w.ids), parent and parent.id,
                  parent.sort if parent else next(w.sorts))
        dev = self.device
        self._cuda = dev is not None and dev.type == "cuda" and \
            not torch.cuda.is_current_stream_capturing()
        sp.start = time.time_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self._cuda:
            self._stream = stream = torch.cuda.current_stream(dev)
            if w.anchor is None:
                # inside the annotation: the device idles while this waits
                w.anchor = _anchor(dev, stream)
            sp._events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            sp._events[0].record(stream)
        w.spans.append(sp)
        tr._stack.append(sp)
        self.span = sp
        return sp

    def __exit__(self, *exc):
        sp = self.span
        if self._cuda:
            sp._events[1].record(self._stream)
        self._rf.__exit__(*exc)
        sp.end = time.time_ns()
        if self.device is not None and self.device.type != "cuda":
            sp.device = (sp.start, sp.end)
        self.tracer._stack.pop()
        return False


class Tracer:
    """The spans of the newest recording window (the module docstring)."""

    def __init__(self):
        self._window: _Window | None = None     # the open window
        self._last: _Window | None = None       # the newest window, open or closed
        self._explicit = 0
        self._stack: list[Span] = []

    def on(self) -> bool:
        """Whether a span opened now is recorded; closes a window its
        profiler session has left."""
        if self._explicit or torch.autograd._profiler_enabled():
            if self._window is None:
                self._window = self._last = _Window()
            return True
        self._window = None
        return False

    def span(self, name: str, device: torch.device | None = None):
        """A context that records the span `name` while recording, and enters
        as its `Span` (None outside a window); `device`, where given, is the
        device whose work the span's device interval brackets."""
        if not self.on():
            return _NULL
        return _Recorder(self, name, device)

    @contextmanager
    def recording(self):
        """An explicit recording window; `spans()` returns its spans after."""
        self._window = self._last = _Window()
        self._explicit += 1
        try:
            yield
        finally:
            self._explicit -= 1
            self._window = None

    def spans(self) -> list[Span]:
        """The newest window's spans in the order they opened, their device
        intervals placed on the host clock (waits for their events).  Outside
        `recording()` the read ends the window: the next span recorded under
        a profiler opens a new one."""
        w = self._last
        if w is None:
            return []
        if not self._explicit:
            self._window = None
        for sp in w.spans:
            if sp._events is not None and sp.end is not None:
                anchor, host_ns = w.anchor
                sp._events[1].synchronize()
                sp.device = tuple(host_ns + round(anchor.elapsed_time(e) * 1e6)
                                  for e in sp._events)
                sp._events = None
        return list(w.spans)


TRACER = Tracer()
span = TRACER.span
recording = TRACER.recording
spans = TRACER.spans


def op(name: str):
    """Decorator: the method runs inside the span `name` while recording
    (host interval only: an op's kernels are attributed by the profiler)."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kw):
            if not TRACER.on():
                return fn(*args, **kw)
            with _Recorder(TRACER, name, None):
                return fn(*args, **kw)
        return traced
    return wrap
