"""The harness finds every part of a cell by name, and BENCHMARK.json
keeps to the shapes the harness and the checker read."""
import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = harness.cell_entry(BENCH, cell)
    config = harness.load_json(harness.PB_DIR, "configs", entry["config"] + ".json")
    traffic = harness.load_json(harness.PB_DIR, "traffic", entry["traffic"] + ".json")
    limits = harness.load_json(harness.PB_DIR, "limits", cell + ".json")
    assert config["name"] == entry["config"]
    assert os.path.exists(os.path.join(harness.PB_DIR, "drivers", traffic["driver"] + ".py"))
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(harness.applies(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric).read)


def test_reader_falls_back_to_the_base_name():
    assert harness.reader("frontend_ms.some_new_cell").__name__.endswith("frontend_ms")
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.explore")


def test_benchmark_json_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], c)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert len(json.dumps(BENCH)) < 64 * 1024
