"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names a configuration (``configs/<config>.json``) and
a traffic mix (``traffic/<traffic>.json``, whose ``driver`` names the
module of ``drivers/`` that drives it); the limits of the check are in
``limits/<cell>.json``; each metric is read by ``metrics/<name>.py``, or
by ``metrics/<base>.py`` for a name ``<base>.<suffix>``.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import resource
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench.probes import Probes
from portbench.trace import DeviceTrace

PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "d2slam_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """The module that reads metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(PB_DIR, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"portbench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} under portbench/metrics/")


def process_start() -> float:
    """Seconds on CLOCK_BOOTTIME at which this process started."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def steal_s(cpus) -> Dict[str, float]:
    """Seconds the hypervisor ran something else on this machine's CPUs,
    over all of them and over ``cpus`` (``/proc/stat``'s steal)."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {"all": 0.0, "own": 0.0}
    try:
        with open("/proc/stat") as f:
            for line in f:
                v = line.split()
                if v and v[0] == "cpu" and len(v) > 8:
                    out["all"] = int(v[8]) / tick
                elif v and v[0].startswith("cpu") and len(v) > 8 and int(v[0][3:]) in cpus:
                    out["own"] += int(v[8]) / tick
    except (OSError, ValueError):
        pass
    return out


def boottime() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


class SetupParts:
    """Seconds of set-up by part, from the process's start."""

    def __init__(self, t_start: float):
        self.t = t_start
        self.parts: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = boottime()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.t
        self.t = now


class Cell:
    """What a driver gets: the cell's data, the seed, the device and the
    probes."""

    def __init__(self, name, config, traffic, seed, device, trace, parts, probes):
        self.name, self.config, self.traffic = name, config, traffic
        self.seed, self.device, self.trace = seed, device, trace
        self.parts, self.probes = parts, probes
        self.root = ROOT
        self.control = False

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)


class Run:
    """What the metric readers read."""

    def __init__(self):
        self.cell = ""
        self.t0 = self.t_end = 0.0
        # where the host-side per-layer metrics start: past the profiler's
        # part of a traced window and the stall of its stop
        self.quiet_t0 = 0.0
        self.completions: List[float] = []
        self.setup_s = 0.0
        self.probes: Optional[Probes] = None
        self.trace = None
        self.stats: dict = {}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: Optional[dict] = None,
             fault: Optional[Callable] = None, control: bool = False,
             log=print) -> dict:
    """One run; returns the result object. ``overrides`` replaces keys of
    the configuration and the traffic (tests shrink a cell with it);
    ``fault(state)`` breaks the program after set-up; ``control`` puts
    the reference at a lower precision in the program's place."""
    bench = benchmark()
    entry = cell_entry(bench, name)
    config = load_json(PB_DIR, "configs", entry["config"] + ".json")
    traffic = load_json(PB_DIR, "traffic", entry["traffic"] + ".json")
    limits = load_json(PB_DIR, "limits", name + ".json")
    for key, d in (("config", config), ("traffic", traffic)):
        d.update((overrides or {}).get(key, {}))
    parts = SetupParts(t_start)
    probes = Probes(trace)
    cell = Cell(name, config, traffic, seed, torch.device(device), trace, parts, probes)
    cell.control = control
    cell.seconds = seconds
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    parts.mark("imports")
    if cell.device.type == "cuda":
        torch.zeros(1, device=cell.device)
        torch.cuda.synchronize(cell.device)
        parts.mark("cuda_context")
    state = driver.setup(cell)
    if fault is not None:
        fault(state)
    run = Run()
    run.cell, run.probes = name, probes
    dtrace = DeviceTrace(probes, traffic.get("trace_seconds", seconds)) if trace else None
    run.setup_s = boottime() - t_start
    cpus = sorted(os.sched_getaffinity(0))
    ru0, st0 = resource.getrusage(resource.RUSAGE_SELF), steal_s(cpus)
    window = driver.window(state, seconds, dtrace)
    ru1, st1 = resource.getrusage(resource.RUSAGE_SELF), steal_s(cpus)
    run.t0, run.t_end = window["t0"], window["t0"] + seconds
    run.quiet_t0 = dtrace.t_done if dtrace is not None and dtrace.t_done else run.t0
    run.completions = [t for t in probes.completions if run.t0 <= t <= run.t_end]
    run.stats = window.get("stats", {})
    for note in window.get("notes", []):
        log(f"note: {note}")
    bins = [0] * max(1, int(seconds // 5))
    for t in run.completions:
        bins[min(int((t - run.t0) // 5), len(bins) - 1)] += 1
    log(f"note: window host CPU {ru1.ru_utime - ru0.ru_utime:.2f} s user, "
        f"{ru1.ru_stime - ru0.ru_stime:.2f} s system, "
        f"{ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary switches; completions per 5 s {bins}")
    log(f"note: window on CPUs {cpus} of {os.cpu_count()}; steal {st1['own'] - st0['own']:.2f} s "
        f"on them, {st1['all'] - st0['all']:.2f} s on all")
    dev = cell.device
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dtrace is not None:
        run.trace = dtrace.summary()
    log("setup_parts " + json.dumps({k: round(v, 4) for k, v in parts.parts.items()}))

    numbers = driver.check(state, window)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = {}
    for k, v in numbers.items():
        if k not in limits:
            raise KeyError(f"no limit for {k!r} in limits/{name}.json")
        checks[k] = {"value": v, "limit": limits[k]}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and set(checks) == set(limits) and window["failed"] == 0)

    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if applies(m, name):
            v = reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                            "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    out["checks"] = checks
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
