"""The command on the card: each cell runs briefly, correct, with its
metrics. Skips without a card."""
import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell, trace):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                        "--seed", "4294967311", "--seconds", "8", "--trace", str(trace)],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    bench = harness.benchmark()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind] if harness.applies(m, cell)}
    assert set(out["metrics"]) <= want and out["metrics"]
