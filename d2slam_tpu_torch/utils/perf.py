"""Structured per-stage performance tracking.

Replaces the reference's ad-hoc TicToc printf timing
(reference: d2common/include/d2common/utils.hpp:282-300 TicToc +
enable_perf_output rolling averages scattered through d2estimator.cpp /
loop_cam.cpp) with one structured tracker: named stages, rolling
statistics, and a report dict suitable for logging or metrics export.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict


class PerfTracker:
    def __init__(self, window: int = 100, enabled: bool = True):
        self.enabled = enabled
        self._samples: Dict[str, collections.deque] = {}
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._window = window

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1000.0
            self._samples.setdefault(
                name, collections.deque(maxlen=self._window)
            ).append(dt)
            self._counts[name] += 1

    def add(self, name: str, ms: float) -> None:
        self._samples.setdefault(
            name, collections.deque(maxlen=self._window)
        ).append(ms)
        self._counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, buf in self._samples.items():
            if not buf:
                continue
            vals = sorted(buf)
            n = len(vals)
            out[name] = {
                "mean_ms": sum(vals) / n,
                "p50_ms": vals[n // 2],
                "p95_ms": vals[min(int(n * 0.95), n - 1)],
                "max_ms": vals[-1],
                "count": self._counts[name],
            }
        return out

    def summary(self) -> str:
        lines = []
        for name, s in sorted(self.report().items()):
            lines.append(
                f"{name:28s} mean {s['mean_ms']:8.2f} ms  "
                f"p95 {s['p95_ms']:8.2f} ms  n={s['count']}"
            )
        return "\n".join(lines)
