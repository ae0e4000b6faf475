"""The program's own spans and counters (``d2slam_tpu_torch.utils.perf``)
in a run of a cell: the per-layer numbers they give, the device trace
read by the program's ``d2:`` ranges, and how they agree with the
harness's outside spans.

    python -m portbench.program_spans --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

runs the cell once as ``portbench.run`` does, with the program's
recorder on from the window's start to its end (the result line of the
harness is unchanged), and prints one JSON object last: ``result`` (the
harness's result line), ``rate`` (the window's completions per second,
with the recorder on), ``metrics`` (below), ``idle_by_span`` and
``device_by_span`` (from the device trace, with ``--trace 1``),
``stages`` (each span name's mean ms and count) and ``agreement`` (the
program's spans beside the harness's). A program
without the recorder gives the result and no program numbers.

Host numbers read the window past the profiled part, as the harness's
host metrics do; device numbers read the profiled part.

| Number | Definition |
| --- | --- |
| ``est_build_ms`` | host ms a solve in ``estimator.build_measurements`` |
| ``est_lm_ms`` | host ms a solve in ``estimator.lm_solve`` |
| ``est_sync_back_ms`` | host ms a solve in ``estimator.sync_back`` |
| ``est_window_ms`` | host ms a keyframe in ``estimator.manage_window`` |
| ``lm_launches`` | device operations launched inside ``d2:estimator.lm_solve`` per solve |
| ``est_host_waits`` | ``estimator.host_waits`` per keyframe, over the whole window |
| ``est_offcpu_ms`` | per keyframe, ``estimator.input_frame``'s wall time less its thread CPU time |
| ``depth_download_ms`` | host ms a frame in ``depth.download`` |
| ``replay_wait_ms`` | ms a frame in ``replay.produce`` + ``replay.queued_raw`` + ``replay.queued_out`` |
| ``depth_offcpu_ms`` | per frame, ``replay.infer``'s wall time less its thread CPU time |
"""
from __future__ import annotations

import argparse
import bisect
import collections
import importlib
import json
import sys
import types
from typing import Dict, List, Optional

from portbench.stats import gaps, rate

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "pb:window"
PREFIX = "d2:"


# --- the device trace by the program's ranges ---------------------------


def read_ranges(events: List[dict]) -> Optional[dict]:
    """From a Chrome trace's events, over the ``pb:window`` range:

    - ``device_by_span``: per ``d2:`` range name, [device seconds, device
      operations] of the work launched inside its ranges (each launch on
      the range's thread matched to its device operation by correlation
      id; a launch counts for every range that holds it);
    - ``idle_by_span``: the card's idle seconds grouped by the innermost
      ``d2:`` range open on each thread at the gap's middle, the names
      of several threads joined by ``+``, ``other`` where none is open;
    - ``ranges``: the number of ranges of each name.

    None where the window or the device work is missing."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    dev = [e for e in xs if str(e.get("cat", "")).lower() in DEVICE_CATS]
    if not win or not dev:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0].get("dur", 0.0))
    iv = []
    by_corr: Dict[object, float] = {}
    for e in dev:
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        iv.append((s, t))
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr[corr] = by_corr.get(corr, 0.0) + t - s
    launches = collections.defaultdict(list)
    for e in xs:
        if str(e.get("cat", "")).lower() in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr in by_corr:
                launches[e.get("tid")].append((float(e["ts"]), corr))
    for v in launches.values():
        v.sort()
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                     e["name"][len(PREFIX):], e.get("tid")) for e in xs
                    if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith(PREFIX))
    device = collections.defaultdict(lambda: [0.0, 0])
    count = collections.Counter()
    for a, b, name, tid in ranges:
        count[name] += 1
        seq = launches.get(tid, [])
        lo = bisect.bisect_left(seq, (a, -1))
        hi = bisect.bisect_right(seq, (b, float("inf")))
        device[name][0] += sum(by_corr[c] for _, c in seq[lo:hi]) * 1e-6
        device[name][1] += hi - lo

    idle = collections.defaultdict(float)
    nxt, open_ = 0, []
    for s, t in gaps(iv, w0, w1):      # in time order
        mid = (s + t) / 2
        while nxt < len(ranges) and ranges[nxt][0] <= mid:
            open_.append(ranges[nxt])
            nxt += 1
        open_ = [r for r in open_ if r[1] > mid]
        inner = {}
        for r in open_:                # in start order: the last is the innermost
            inner[r[3]] = r[2]
        names = sorted(set(inner.values()))
        idle["+".join(names) if names else "other"] += (t - s) * 1e-6
    return {"idle_by_span": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1]),
            "device_by_span": {k: v for k, v in sorted(device.items(), key=lambda kv: -kv[1][0])},
            "ranges": dict(count)}


# --- the numbers ---------------------------------------------------------


def _quiet(run, name: str) -> list:
    """The spans ``name`` that began in the window past the profiled part."""
    return [s for s in run.program_spans
            if s.name == name and run.quiet_t0 <= s.t0 < run.t_end]


def _mean_ms(spans) -> Optional[float]:
    return sum(s.t1 - s.t0 for s in spans) * 1e3 / len(spans) if spans else None


def _ms_per(run, name: str, per: str) -> Optional[float]:
    n = len(_quiet(run, per))
    return sum(s.t1 - s.t0 for s in _quiet(run, name)) * 1e3 / n if n else None


def _offcpu_ms(run, name: str) -> Optional[float]:
    spans = _quiet(run, name)
    return (sum(s.t1 - s.t0 - s.cpu_s for s in spans) * 1e3 / len(spans)) if spans else None


def est_build_ms(run):
    return _ms_per(run, "estimator.build_measurements", "estimator.build_measurements")


def est_lm_ms(run):
    return _ms_per(run, "estimator.lm_solve", "estimator.build_measurements")


def est_sync_back_ms(run):
    return _ms_per(run, "estimator.sync_back", "estimator.build_measurements")


def est_window_ms(run):
    return _ms_per(run, "estimator.manage_window", "estimator.input_frame")


def lm_launches(run):
    t = run.program_trace
    n = t["ranges"].get("estimator.lm_solve", 0) if t else 0
    return t["device_by_span"]["estimator.lm_solve"][1] / n if n else None


def est_host_waits(run):
    keyframes = sum(s.name == "estimator.input_frame" for s in run.program_spans)
    waits = run.program_counts.get("estimator.host_waits")
    return waits / keyframes if keyframes and waits is not None else None


def est_offcpu_ms(run):
    return _offcpu_ms(run, "estimator.input_frame")


def depth_download_ms(run):
    return _mean_ms(_quiet(run, "depth.download"))


def replay_wait_ms(run):
    parts = [_mean_ms(_quiet(run, n))
             for n in ("replay.produce", "replay.queued_raw", "replay.queued_out")]
    return None if None in parts else sum(parts)


def depth_offcpu_ms(run):
    return _offcpu_ms(run, "replay.infer")


METRICS = {f.__name__: f for f in (est_build_ms, est_lm_ms, est_sync_back_ms, est_window_ms,
                                   lm_launches, est_host_waits, est_offcpu_ms,
                                   depth_download_ms, replay_wait_ms, depth_offcpu_ms)}


def stage_means(run) -> Dict[str, list]:
    """Per span name, [mean ms, count] over the window past the profiled
    part: the breakdown behind the numbers."""
    by = collections.defaultdict(list)
    for s in run.program_spans:
        if run.quiet_t0 <= s.t0 < run.t_end:
            by[s.name].append(s.t1 - s.t0)
    return {k: [sum(v) * 1e3 / len(v), len(v)] for k, v in sorted(by.items())}


def children_share(run, name: str) -> Optional[float]:
    """The share of the spans ``name``'s time (window past the profiled
    part) that their direct children cover."""
    roots = {s.id: s for s in _quiet(run, name)}
    if not roots:
        return None
    inside = sum(s.t1 - s.t0 for s in run.program_spans if s.parent in roots)
    return inside / sum(s.t1 - s.t0 for s in roots.values())


def agreement(run, outside: dict, latency_s: list) -> dict:
    """The program's spans beside the harness's outside numbers of the
    same calls (each pair None where either side is missing)."""
    def pair(inner, metric):
        m = outside.get(metric)
        return [inner, None if m is None else m["value"]]

    cell = run.cell.split(".")[-1]
    # frames that entered the replay past the profiled part, as the spans are chosen by start
    lat = [d for t, d in latency_s if t - d >= run.quiet_t0]
    wait, infer, pub = (replay_wait_ms(run), _mean_ms(_quiet(run, "replay.infer")),
                        _mean_ms(_quiet(run, "replay.publish")))
    out = {
        "input_frame_ms_vs_estimator_ms": pair(_mean_ms(_quiet(run, "estimator.input_frame")),
                                               f"estimator_ms.{cell}"),
        "input_frame_children_share": children_share(run, "estimator.input_frame"),
        "pgo_solve_ms_vs_pgo_ms": pair(_mean_ms(_quiet(run, "pgo.solve")), f"pgo_ms.{cell}"),
        "replay_infer_ms_vs_depth_infer_ms": pair(infer, f"depth_infer_ms.{cell}"),
        "replay_path_ms_vs_mean_latency_ms": [
            None if None in (wait, infer, pub) else wait + infer + pub,
            sum(lat) * 1e3 / len(lat) if lat else None],
    }
    t = run.program_trace
    if t:
        idle = dict(t["idle_by_span"])
        total = sum(idle.values())
        out["idle_named_share"] = 1.0 - idle.get("other", 0.0) / total if total else None
    return out


# --- the command ---------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import run as pb_run
    pb_run._host_environment(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark runs only on the card", file=sys.stderr)
        return 1
    from portbench import harness
    from portbench import trace as trace_mod
    try:
        t_start = harness.process_start()
    except (OSError, ValueError, IndexError):
        t_start = pb_run._T_IMPORT
    out, got = run_with_recorder(harness, trace_mod, args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", t_start,
                                 log=lambda s: print(s, flush=True))
    print(json.dumps(dict(result=out, **got)), flush=True)
    return 0


def run_with_recorder(harness, trace_mod, workload, seed, seconds, trace, device, t_start,
                      **kw):
    """``harness.run_cell`` with the program's recorder on through the
    window and the profiler's events kept for ``read_ranges``; returns
    (the harness's result, the program's numbers)."""
    try:
        from d2slam_tpu_torch.utils import perf
    except ImportError:
        perf = None
    if perf is not None and not hasattr(perf, "enable"):
        perf = None
    bench = harness.benchmark()
    entry = harness.cell_entry(bench, workload)
    traffic = harness.load_json(harness.PB_DIR, "traffic", entry["traffic"] + ".json")
    cell_mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    got: dict = {}
    inner_window, inner_summarize, inner_probes = (cell_mod.window, trace_mod.summarize,
                                                   harness.Probes)

    def window(st, secs, dtrace):
        if perf is not None:
            perf.enable()
        try:
            res = inner_window(st, secs, dtrace)
        finally:
            if perf is not None:
                perf.disable()
                got["spans"], got["counts"] = perf.drain()
        got.update(window=res, dtrace=dtrace)
        return res

    def summarize(events):
        got["ranges"] = read_ranges(events)
        return inner_summarize(events)

    class Probes(inner_probes):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            got["probes"] = self

    cell_mod.window, trace_mod.summarize, harness.Probes = window, summarize, Probes
    try:
        out = harness.run_cell(workload, seed, seconds, trace, device, t_start, **kw)
    finally:
        cell_mod.window, trace_mod.summarize, harness.Probes = (inner_window, inner_summarize,
                                                              inner_probes)
    t0 = got["window"]["t0"]
    dtrace = got.get("dtrace")
    run = types.SimpleNamespace(
        cell=workload, t0=t0, t_end=t0 + seconds,
        quiet_t0=dtrace.t_done if dtrace is not None and dtrace.t_done else t0,
        program_spans=got.get("spans", []), program_counts=got.get("counts", {}),
        program_trace=got.get("ranges"))
    done = [t for t in got["probes"].completions if run.t0 <= t <= run.t_end]
    res = {"rate": rate(run.t0, done), "spans": len(run.program_spans),
           "counts": run.program_counts}
    if perf is not None:
        res["metrics"] = {k: f(run) for k, f in METRICS.items()}
        res["stages"] = stage_means(run)
        res["agreement"] = agreement(run, out["metrics"],
                                     got["window"].get("stats", {}).get("latency_s", []))
    if run.program_trace:
        res["idle_by_span"] = run.program_trace["idle_by_span"]
        res["device_by_span"] = run.program_trace["device_by_span"]
    return out, res


if __name__ == "__main__":
    sys.exit(main())
