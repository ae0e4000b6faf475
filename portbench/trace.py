"""The device trace of a traced run: ``torch.profiler`` over the first
``trace_seconds`` of the window, read back from its Chrome trace.

From it: the device's busy time (the union of every kernel, copy and
set on the card), the device operations counted, the device time of the
work launched inside each harness range (``pb:<label>``: each launch on
the host inside the range, matched to its device operation by the
profiler's correlation id), the device operations that took the most
time, and the idle stretches of the card grouped by the harness spans
open on the host at their middle.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench.stats import gaps, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "pb:window"


class TraceSummary:
    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.n_device_ops = 0
        self.frames = 0
        self.range_device_s: Dict[str, float] = {}
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []


class DeviceTrace:
    """Start with ``start()`` at the window's start; ``stop()`` once
    ``trace_seconds`` have passed, or at the window's end."""

    def __init__(self, probes, seconds: float):
        self.probes = probes
        self.seconds = seconds
        self.prof = None
        self.t_start = self.t_stop = self.t_done = None
        self._window = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        kw = {}
        try:   # record_function ranges on every thread, not only this one
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            pass
        self.prof = torch.profiler.profile(activities=acts, **kw)
        self.prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.probes.profiling = True
        self.t_start = time.perf_counter()

    def due(self) -> bool:
        return self.t_stop is None and time.perf_counter() - self.t_start >= self.seconds

    def stop(self) -> None:
        if self.t_stop is not None or self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.probes.profiling = False
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.t_done = time.perf_counter()

    def summary(self) -> Optional[TraceSummary]:
        """None when nothing ran on a device."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.prof = None
        s = summarize(events)
        if s is not None:
            s.frames = sum(self.t_start <= t < self.t_stop for t in self.probes.completions)
        return s


def summarize(events: List[dict]) -> Optional[TraceSummary]:
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    dev = [e for e in xs if str(e.get("cat", "")).lower() in DEVICE_CATS]
    if not win or not dev:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0].get("dur", 0.0))
    iv = []
    by_corr = collections.defaultdict(float)
    by_name = collections.defaultdict(float)
    for e in dev:
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        iv.append((s, t))
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr[corr] += t - s
        by_name[e.get("name", "?")] += (t - s) * 1e-6
    out = TraceSummary()
    out.window_s = (w1 - w0) * 1e-6
    out.busy_s = union_length(iv) * 1e-6
    out.n_device_ops = len(iv)
    out.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # host launches by thread, in time order
    launches = collections.defaultdict(list)
    for e in xs:
        if str(e.get("cat", "")).lower() in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr in by_corr:
                launches[e.get("tid")].append((float(e["ts"]), corr))
    for v in launches.values():
        v.sort()
    ranges = [e for e in xs if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("pb:") and e.get("name") != WINDOW]
    dev_s = collections.defaultdict(float)
    for r in ranges:
        seq = launches.get(r.get("tid"), [])
        a, b = float(r["ts"]), float(r["ts"]) + float(r.get("dur", 0.0))
        lo = bisect.bisect_left(seq, (a, -1))
        hi = bisect.bisect_right(seq, (b, float("inf")))
        dev_s[r["name"][3:]] += sum(by_corr[c] for _, c in seq[lo:hi]) * 1e-6
    out.range_device_s = dict(dev_s)

    idle = collections.defaultdict(float)
    spans = sorted((float(r["ts"]), float(r["ts"]) + float(r.get("dur", 0.0)), r["name"][3:])
                   for r in ranges)
    nxt, open_ = 0, []
    for s, t in gaps(iv, w0, w1):      # in time order
        mid = (s + t) / 2
        while nxt < len(spans) and spans[nxt][0] <= mid:
            open_.append(spans[nxt])
            nxt += 1
        open_ = [sp for sp in open_ if sp[1] > mid]
        names = sorted({n for _, _, n in open_})
        idle["+".join(names) if names else "other"] += (t - s) * 1e-6
    out.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return out
