"""The port's one tracer: per-stage totals that are always kept, and
spans and counters recorded process-wide while switched on.

Replaces the reference's ad-hoc TicToc printf timing
(reference: d2common/include/d2common/utils.hpp:282-300 TicToc +
enable_perf_output rolling averages scattered through d2estimator.cpp /
loop_cam.cpp) with:

- ``PerfTracker(layer)``: the named stages of one layer. Each call of
  ``stage(name, key)`` adds its host time to the stage's ``StageStats``
  (count, total and max over every call), always.
- A process-wide recorder, off by default: ``enable()``, ``disable()``,
  ``drain()``. While it is on, every span (a tracker's stage, or
  ``span(name)`` where there is no tracker) records a ``Span``: its name
  ``<layer>.<stage>``, start and end on ``time.perf_counter()``, the
  thread's CPU time over it, the thread, its parent (the span open on
  the same thread when it began) and its key (a frame id, keyframe id
  or replay index; a span given none takes its parent's, so the spans
  of one frame share it). ``interval(name, t0, t1, key)`` records a
  wait that crosses threads, such as a queue's put-to-take time;
  ``count(name, n)`` adds to a counter. Spans stay in memory until
  ``drain()``, at most ``MAX_SPANS`` of them; the counter
  ``perf.dropped_spans`` counts those past the cap.
- While the recorder is on and a ``torch.profiler`` records, each span
  also opens ``record_function("d2:<name>")``: the program's spans then
  sit in the profiler's trace beside the device work they launch, on
  its clock. (The profiler's process-wide flag is read, not
  ``torch.autograd._profiler_enabled()``, which is true only on the
  thread that started the profiler.)

Off, a span costs a flag check (and a tracker's stage its totals): no
profiler range, nothing appended.

    perf.enable()
    ...                      # spans and counters recorded
    perf.disable()
    spans, counts = perf.drain()
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1_000_000    # spans held until drain(); later ones are counted, not kept
PREFIX = "d2:"           # the profiler ranges' prefix
DROPPED = "perf.dropped_spans"


class Span(NamedTuple):
    """One recorded span, or an interval (``cpu_s`` and ``tid`` None)."""
    name: str
    t0: float                 # time.perf_counter() seconds
    t1: float
    cpu_s: Optional[float]    # the thread's CPU time over the span
    tid: Optional[int]        # threading.get_ident() of its thread
    id: int
    parent: Optional[int]     # id of the span open on the thread when it began
    key: Any                  # frame id, keyframe id or replay index


class StageStats:
    """Count, total and max of one stage's host time over every call."""

    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt

    @property
    def mean_ms(self) -> float:
        return self.total_s / max(self.count, 1) * 1e3

    @property
    def max_ms(self) -> float:
        return self.max_s * 1e3


class _Recorder:
    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.lock = threading.Lock()
        self.local = threading.local()   # .stack: the spans open on this thread
        self.ids = itertools.count(1)


_REC = _Recorder()
_OFF = contextlib.nullcontext()


def enable() -> None:
    """Start recording, from an empty buffer."""
    with _REC.lock:
        _REC.spans = []
        _REC.counts = collections.defaultdict(int)
        _REC.on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain()``."""
    _REC.on = False


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The spans and counters recorded since ``enable()`` or the last
    drain, which are then forgotten."""
    with _REC.lock:
        spans, counts = _REC.spans, dict(_REC.counts)
        _REC.spans = []
        _REC.counts = collections.defaultdict(int)
    return spans, counts


def _append(s: Span) -> None:
    with _REC.lock:
        if len(_REC.spans) < MAX_SPANS:
            _REC.spans.append(s)
        else:
            _REC.counts[DROPPED] += 1


def _profiling() -> bool:
    return bool(_autograd_profiler._is_profiler_enabled or torch.autograd._profiler_enabled())


class _Open:
    """A span being timed; adds to ``stats`` (if any) on exit."""

    __slots__ = ("name", "key", "stats", "t0", "c0", "id", "parent", "range")

    def __init__(self, name: str, key, stats: Optional[StageStats]):
        self.name, self.key, self.stats = name, key, stats
        self.id = None

    def __enter__(self):
        if _REC.on:
            stack = getattr(_REC.local, "stack", None)
            if stack is None:
                stack = _REC.local.stack = []
            up = stack[-1] if stack else None
            if self.key is None and up is not None:
                self.key = up.key
            self.parent = None if up is None else up.id
            self.id = next(_REC.ids)
            stack.append(self)
            self.range = None
            if _profiling():
                self.range = torch.profiler.record_function(PREFIX + self.name)
                self.range.__enter__()
            self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.stats is not None:
            self.stats.add(t1 - self.t0)
        if self.id is not None:
            cpu = (time.thread_time_ns() - self.c0) * 1e-9
            if self.range is not None:
                self.range.__exit__(*exc)
            _REC.local.stack.pop()       # spans of one thread close in reverse order
            if _REC.on:
                _append(Span(self.name, self.t0, t1, cpu, threading.get_ident(), self.id,
                             self.parent, self.key))
        return False


def span(name: str, key=None):
    """A span ``name`` (``<layer>.<stage>``) where no tracker is at hand;
    records nothing, and keeps no totals, while the recorder is off."""
    return _Open(name, key, None) if _REC.on else _OFF


def interval(name: str, t0: float, t1: float, key=None) -> None:
    """A wait from ``t0`` to ``t1`` (``time.perf_counter()``) that may
    begin on one thread and end on another; no profiler range."""
    if _REC.on:
        _append(Span(name, t0, t1, None, None, next(_REC.ids), None, key))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if _REC.on:
        with _REC.lock:
            _REC.counts[name] += n


class PerfTracker:
    """The named stages of one layer: ``stage(name, key)`` times a block
    as the span ``<layer>.<name>`` and adds it to the stage's totals."""

    def __init__(self, layer: str = "perf"):
        self.layer = layer
        self.stats: Dict[str, StageStats] = {}
        self._names: Dict[str, str] = {}

    def totals(self, name: str) -> StageStats:
        """The stage's totals (made empty on first use)."""
        st = self.stats.get(name)
        if st is None:
            st = self.stats.setdefault(name, StageStats())
            self._names[name] = f"{self.layer}.{name}"
        return st

    def stage(self, name: str, key=None) -> _Open:
        st = self.totals(name)
        return _Open(self._names[name], key, st)

    def add(self, name: str, ms: float) -> None:
        """A time measured elsewhere, in ms, added to the stage's totals."""
        self.totals(name).add(ms * 1e-3)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {name: {"mean_ms": s.mean_ms, "max_ms": s.max_ms,
                       "total_ms": s.total_s * 1e3, "count": s.count}
                for name, s in self.stats.items() if s.count}

    def summary(self) -> str:
        return "\n".join(
            f"{name:28s} mean {s['mean_ms']:8.2f} ms  max {s['max_ms']:8.2f} ms  "
            f"n={s['count']}  total {s['total_ms'] / 1e3:8.2f} s"
            for name, s in sorted(self.report().items()))
