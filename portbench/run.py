"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

Set-up (imports, CUDA context, kernel builds, weights, the inputs
rendered from the seed, warm-up frames) is timed from the process's
start; then the cell's traffic runs for ``--seconds``; then what the
window produced is checked against the plain reference. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``checks``: each number compared beside its limit); the last lines
of standard error repeat the checks. The run needs a CUDA card; it
exits with 1 and prints no result without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T_IMPORT = time.clock_gettime(time.CLOCK_BOOTTIME)
PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)


def _host_environment(workload: str) -> None:
    """Before numpy and torch load: the configuration's CPU thread
    counts and the fixed CPUs the process and every thread it starts run
    on, and every compile cache at a fixed directory of the checkout."""
    try:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
        config = next(w["config"] for w in bench["workloads"] if w["name"] == workload)
        with open(os.path.join(PB_DIR, "configs", config + ".json")) as f:
            threads = json.load(f).get("host_threads", {})
    except (OSError, StopIteration, ValueError):
        threads = {}
    if "blas" in threads:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(threads["blas"])
    cpus = int(threads.get("cpus", 0))
    if cpus > 0:
        allowed = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, allowed[-cpus:])
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["_PB_TORCH_THREADS"] = str(threads.get("torch", 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _host_environment(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA card (torch.cuda.is_available() is false); "
              "the benchmark runs only on the card", file=sys.stderr)
        return 1
    n = int(os.environ.pop("_PB_TORCH_THREADS", "0"))
    if n > 0:
        torch.set_num_threads(n)
    from portbench import harness

    try:
        t_start = harness.process_start()
    except (OSError, ValueError, IndexError):
        t_start = _T_IMPORT
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", t_start, log=lambda s: print(s, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: JAX or the JAX package", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r}) {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
