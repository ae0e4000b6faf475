"""The port's tracer (``d2slam_tpu_torch/utils/perf.py``) on the CPU:
the recorder off and on, spans on two threads, intervals, counters and
the cap, the profiler ranges in a Chrome trace, and the spans and
counters of a short estimator run and of the threaded depth replay."""
import json
import threading

import numpy as np
import pytest
import torch

from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.depth.quadcam import QuadcamConfig, build_virtual_stereo
from d2slam_tpu_torch.geometry.cameras import KBParams
from d2slam_tpu_torch.runtime.depth_replay import DepthReplay
from d2slam_tpu_torch.utils import perf
from d2slam_tpu_torch.utils.perf import PerfTracker, StageStats
from d2slam_tpu_torch.utils.render import render_cylinder_wall
from d2slam_tpu_torch.utils.sim import CircleSim, fisheye_ring_extrinsics
from d2slam_tpu_torch.vins import estimator as estimator_mod
from d2slam_tpu_torch.vins.estimator import D2Estimator

torch.set_num_threads(1)  # tests run one process per core (xdist)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    perf.disable()
    perf.drain()
    yield
    perf.disable()
    perf.drain()


class CountingRange:
    """Stands in for ``torch.profiler.record_function``; counts opens."""
    opened = []

    def __init__(self, name):
        CountingRange.opened.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def ranges(monkeypatch):
    CountingRange.opened = []
    monkeypatch.setattr(torch.profiler, "record_function", CountingRange)
    return CountingRange.opened


def test_stage_stats_keep_count_total_and_max():
    s = StageStats()
    for dt in (0.002, 0.006, 0.004):
        s.add(dt)
    assert s.count == 3 and s.total_s == pytest.approx(0.012)
    assert s.mean_ms == pytest.approx(4.0) and s.max_ms == pytest.approx(6.0)
    assert StageStats().mean_ms == 0.0
    tr = PerfTracker("layer")
    tr.add("step", 3.0)
    tr.add("step", 5.0)
    rep = tr.report()["step"]
    assert rep == {"mean_ms": pytest.approx(4.0), "max_ms": pytest.approx(5.0),
                   "total_ms": pytest.approx(8.0), "count": 2}
    assert "step" in tr.summary() and "n=2" in tr.summary()


def test_off_records_nothing_and_opens_no_range(ranges):
    tr = PerfTracker("layer")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert perf._profiling()
        for k in range(3):
            with tr.stage("outer", k):
                with perf.span("layer.inner"):
                    pass
        perf.interval("layer.wait", 0.0, 1.0, 0)
        perf.count("layer.things", 5)
    assert ranges == []
    assert perf.drain() == ([], {})
    assert tr.stats["outer"].count == 3 and tr.report()["outer"]["count"] == 3


def test_nested_spans_carry_parent_and_key():
    tr = PerfTracker("est")
    perf.enable()
    with tr.stage("root", 7):
        with tr.stage("child"):
            with perf.span("other.leaf"):
                pass
        with tr.stage("child", 9):
            pass
    perf.interval("q.wait", 1.0, 1.5, 7)
    perf.count("est.waits")
    perf.count("est.waits", 2)
    perf.disable()
    spans, counts = perf.drain()
    by = {(s.name, s.key): s for s in spans}
    root, child = by[("est.root", 7)], by[("est.child", 7)]
    leaf, child9 = by[("other.leaf", 7)], by[("est.child", 9)]
    assert root.parent is None and child.parent == root.id and leaf.parent == child.id
    assert child9.parent == root.id
    assert root.t0 <= child.t0 <= leaf.t0 <= leaf.t1 <= child.t1 <= child9.t0 <= root.t1
    assert root.tid == threading.get_ident() and 0.0 <= root.cpu_s
    wait = by[("q.wait", 7)]
    assert (wait.t0, wait.t1, wait.cpu_s, wait.tid) == (1.0, 1.5, None, None)
    assert counts == {"est.waits": 3}
    assert tr.stats["root"].count == 1 and tr.stats["child"].count == 2
    assert perf.drain() == ([], {})


def test_spans_on_two_threads_keep_their_own_stacks():
    perf.enable()
    go = threading.Barrier(2)

    def worker(name):
        for k in range(20):
            with perf.span(f"{name}.outer", k):
                go.wait(timeout=10)        # both threads inside a span at once
                with perf.span(f"{name}.inner"):
                    pass

    threads = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    perf.disable()
    spans, _ = perf.drain()
    by_id = {s.id: s for s in spans}
    assert len(spans) == 80
    for s in spans:
        layer, part = s.name.split(".")
        if part == "outer":
            assert s.parent is None
        else:
            up = by_id[s.parent]
            assert up.name == f"{layer}.outer" and up.key == s.key and up.tid == s.tid


def test_cap_counts_the_spans_dropped(monkeypatch):
    monkeypatch.setattr(perf, "MAX_SPANS", 3)
    perf.enable()
    for k in range(5):
        with perf.span("x.y", k):
            pass
    perf.interval("x.wait", 0.0, 1.0)
    spans, counts = perf.drain()
    assert [s.key for s in spans] == [0, 1, 2]
    assert counts == {perf.DROPPED: 3}


def test_enable_starts_empty_and_disable_stops_appending():
    perf.enable()
    with perf.span("x.before"):
        pass
    perf.enable()
    with perf.span("x.open"):
        perf.disable()                    # ends while off: not kept
    perf.count("x.n")
    assert perf.drain() == ([], {})


def test_ranges_open_on_every_thread_while_a_profiler_records(ranges):
    perf.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t = threading.Thread(target=lambda: perf.span("w.work").__enter__().__exit__())
        t.start()
        t.join(timeout=10)
        with PerfTracker("m").stage("main"):
            pass
    with perf.span("m.after"):            # no profiler: no range
        pass
    assert sorted(ranges) == ["d2:m.main", "d2:w.work"]
    assert len(perf.drain()[0]) == 3


def test_ranges_land_in_the_chrome_trace(tmp_path):
    perf.enable()
    tr = PerfTracker("est")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.stage("lm_solve", 3):
            with perf.span("est.inner"):
                torch.ones(64).cumsum(0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = {e["name"]: e for e in events
           if e.get("ph") == "X" and str(e.get("name", "")).startswith(perf.PREFIX)}
    assert set(got) == {"d2:est.lm_solve", "d2:est.inner"}
    outer, inner = got["d2:est.lm_solve"], got["d2:est.inner"]
    assert outer["cat"] == inner["cat"] == "user_annotation"
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


# --- the program's spans ------------------------------------------------

N_FRAMES = 11
SIM_KW = dict(seed=5, pix_noise_rad=0.5 / 460.0, acc_noise=0.02, gyr_noise=0.002)
EST_STAGES = {"estimator.ingest", "estimator.build_measurements", "estimator.lm_solve",
              "estimator.sync_back", "estimator.manage_window"}


def _estimator_config():
    cfg = D2Config()
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 64
    e.max_solve_measurements = 256
    e.max_imu_samples = 64
    e.max_solver_iters = 2
    return cfg


def test_estimator_run_records_its_stages_and_host_waits(monkeypatch):
    waits = []
    inner_np = D2Estimator.__dict__["_np"].__func__
    inner_sync = estimator_mod._sync

    def counted_np(x):
        waits.append("np")
        return inner_np(x)

    def counted_sync(device):
        waits.append("sync")
        return inner_sync(device)

    monkeypatch.setattr(D2Estimator, "_np", staticmethod(counted_np))
    monkeypatch.setattr(estimator_mod, "_sync", counted_sync)
    sim = CircleSim(**SIM_KW)
    est = D2Estimator(_estimator_config(), sim.ext, device="cpu")
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    perf.enable()
    t_prev, ids = 0.0, []
    for k in range(N_FRAMES):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        frame = sim.frame(k)
        ids.append(frame.frame_id)
        assert est.input_frame(frame) is not None
    perf.disable()
    spans, counts = perf.drain()
    assert est.margin_count >= 1 and est.solve_count >= 1
    roots = [s for s in spans if s.name == "estimator.input_frame"]
    assert [s.key for s in roots] == ids and all(s.parent is None for s in roots)
    by_id = {s.id: s for s in spans}
    children = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
            assert s.key == by_id[s.parent].key
    seen = set()
    for r in roots:
        names = {c.name for c in children.get(r.id, [])}
        assert names <= EST_STAGES and {"estimator.ingest", "estimator.manage_window"} <= names
        seen |= names
    assert seen == EST_STAGES
    # the fused solve marginalizes inside lm_solve; a separate one, inside manage_window
    margs = [s for s in spans if s.name == "estimator.marginalize"]
    assert all(by_id[s.parent].name == "estimator.manage_window" for s in margs)
    assert counts["estimator.host_waits"] == len(waits) > 0
    assert est.perf.report()["input_frame"]["count"] == N_FRAMES


HF, WF = 120, 160


def test_depth_replay_records_each_frames_stages_and_waits():
    ext = fisheye_ring_extrinsics(0.3)
    fish = [KBParams.make(47.5, 47.5, WF / 2, HF / 2, k2=0.005) for _ in range(4)]
    cfg = QuadcamConfig(out_hw=(60, 80), min_z=1.0, max_z=20.0, max_disp=16, block=5)
    pairs = build_virtual_stereo(fish, ext, cfg, device="cpu")
    frames = [(np.round(np.stack([render_cylinder_wall(fish[i], ext[i], (HF, WF), 5.0, seed=k)
                                  for i in range(4)]) * 255).astype(np.uint8), None)
              for k in range(4)]
    replay = DepthReplay(pairs, cfg, device="cpu")
    perf.enable()
    out = replay.run(iter(frames))
    perf.disable()
    spans, _ = perf.drain()
    assert len(out) == len(frames)
    assert all(replay.stats[s].count == len(frames) for s in ("raw", "inference", "publish"))
    keys = list(range(len(frames)))
    for name in ("replay.produce", "replay.queued_raw", "replay.infer", "replay.queued_out",
                 "replay.publish", "depth.upload", "depth.remap", "depth.disparity",
                 "depth.points", "depth.download"):
        assert sorted(s.key for s in spans if s.name == name) == keys, name
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name.startswith("depth."):
            assert by_id[s.parent].name == "replay.infer" and by_id[s.parent].key == s.key
        if s.name.startswith("replay.queued"):
            assert s.cpu_s is None and s.t1 >= s.t0
    infer = {s.key: s for s in spans if s.name == "replay.infer"}
    queued_out = {s.key: s for s in spans if s.name == "replay.queued_out"}
    assert all(infer[k].t1 <= queued_out[k].t0 for k in keys)
