"""What the harness records around the program while a cell runs:
completions on the host clock, host spans around the calls into each
layer, and named profiler ranges around the kernels' stages.

The harness wraps entry methods on the instances it built, or a name in
one of the program's modules, and edits no file of the program. Spans
and ranges are recorded only while ``active`` (the traced run's window);
completions always.
"""
from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


class Probes:
    def __init__(self, trace: bool):
        self.trace = trace
        self.active = False      # the measured window of a traced run
        self.profiling = False   # the part of it under the profiler
        self.completions: List[float] = []
        self.spans: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
        # per named range, the least time on the card of each call's work
        self.range_work: Dict[str, List[float]] = collections.defaultdict(list)
        self._lock = threading.Lock()

    def complete(self, t: Optional[float] = None) -> None:
        with self._lock:
            self.completions.append(time.perf_counter() if t is None else t)

    def span(self, obj, name: str, label: Optional[str],
             after: Optional[Callable] = None) -> None:
        """Wrap ``obj.name`` with a host span ``label`` (and a profiler
        range of the same label) while active, none with ``label`` None;
        ``after(result, args)`` runs on every call."""
        inner = getattr(obj, name)

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            if not self.active or label is None:
                out = inner(*args, **kwargs)
            else:
                t0 = time.perf_counter()
                with torch.profiler.record_function(f"pb:{label}"):
                    out = inner(*args, **kwargs)
                t1 = time.perf_counter()
                with self._lock:
                    self.spans[label].append((t0, t1))
            if after is not None:
                after(out, args)
            return out

        setattr(obj, name, wrapped)

    def kernel_range(self, module, name: str, label: str, work: Callable) -> None:
        """Wrap the function ``module.name`` (looked up by the program at
        call time) in a profiler range ``label``; ``work(args)`` gives the
        least time the card could take for the call's work."""
        if not self.trace or not hasattr(module, name):
            return
        inner = getattr(module, name)

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            if not self.profiling:
                return inner(*args, **kwargs)
            with torch.profiler.record_function(f"pb:{label}"):
                out = inner(*args, **kwargs)
            with self._lock:
                self.range_work[label].append(work(args))
            return out

        setattr(module, name, wrapped)

    def total(self, label: str, t0: float, t1: float) -> Tuple[float, int]:
        """(seconds, calls) of the spans ``label`` that began in [t0, t1)."""
        s = [(a, b) for a, b in self.spans.get(label, ()) if t0 <= a < t1]
        return sum(b - a for a, b in s), len(s)
