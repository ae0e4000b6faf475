"""The reading of the program's own spans (``portbench/program_spans.py``):
the device trace by ``d2:`` ranges beside the harness's ``pb:`` reading,
which they leave unchanged, the numbers on synthetic spans, and a tiny
run of each cell on the CPU with the recorder on."""
import types

import pytest

from portbench import harness
from portbench import program_spans as ps
from portbench import trace as trace_mod
from portbench.tests import tiny
from portbench.tests.test_pb_stats import _ev
from portbench.trace import WINDOW, summarize

from d2slam_tpu_torch.utils import perf
from d2slam_tpu_torch.utils.perf import Span

PB = [
    _ev(WINDOW, "user_annotation", 0, 1000),
    _ev("pb:estimator", "user_annotation", 90, 820, tid=1),
    _ev("cudaLaunchKernel", "cuda_runtime", 250, 5, tid=1, corr=1),
    _ev("cudaLaunchKernel", "cuda_runtime", 700, 5, tid=1, corr=2),
    _ev("cudaLaunchKernel", "cuda_runtime", 660, 5, tid=2, corr=3),
    _ev("k_lm", "kernel", 300, 100, corr=1),
    _ev("k_window", "kernel", 750, 50, corr=2),
    _ev("k_track", "kernel", 680, 20, corr=3),
]
D2 = [
    _ev("d2:estimator.input_frame", "user_annotation", 100, 800, tid=1),
    _ev("d2:estimator.lm_solve", "user_annotation", 200, 400, tid=1),
    _ev("d2:frontend.host", "user_annotation", 650, 300, tid=2),
]


def test_program_ranges_leave_the_harness_reading_unchanged():
    plain, both = summarize(PB), summarize(PB + D2)
    assert both.idle_gaps == plain.idle_gaps
    assert both.range_device_s == plain.range_device_s
    assert (both.busy_s, both.n_device_ops, both.device_ops) == (
        plain.busy_s, plain.n_device_ops, plain.device_ops)
    assert dict(plain.idle_gaps) == {"estimator": pytest.approx(830e-6)}


def test_idle_and_device_by_program_span():
    r = ps.read_ranges(PB + D2)
    # gaps [0,300) [400,680) [700,750) [800,1000), each by the innermost
    # range open on each thread at its middle
    assert dict(r["idle_by_span"]) == {
        "estimator.input_frame": pytest.approx(300e-6),
        "estimator.lm_solve": pytest.approx(280e-6),
        "estimator.input_frame+frontend.host": pytest.approx(50e-6),
        "frontend.host": pytest.approx(200e-6)}
    dev = r["device_by_span"]
    assert dev["estimator.input_frame"] == [pytest.approx(150e-6), 2]
    assert dev["estimator.lm_solve"] == [pytest.approx(100e-6), 1]
    assert dev["frontend.host"] == [pytest.approx(20e-6), 1]
    assert r["ranges"] == {"estimator.input_frame": 1, "estimator.lm_solve": 1,
                           "frontend.host": 1}
    assert ps.read_ranges(PB)["idle_by_span"] == [["other", pytest.approx(830e-6)]]
    assert ps.read_ranges([_ev(WINDOW, "user_annotation", 0, 1000)]) is None


def _span(name, t0, t1, cpu=None, sid=0, parent=None, key=None):
    return Span(name, t0, t1, cpu, None if cpu is None else 1, sid, parent, key)


def _run(spans, counts=None, trace=None):
    return types.SimpleNamespace(cell="euroc_stereo.explore", quiet_t0=10.0, t_end=20.0,
                                 program_spans=spans, program_counts=counts or {},
                                 program_trace=trace)


def _keyframe(t, sid, key):
    """A keyframe at ``t``: 1.0 s wall, 0.7 s of it on the CPU."""
    return [_span("estimator.input_frame", t, t + 1.0, 0.7, sid, None, key),
            _span("estimator.ingest", t, t + 0.05, 0.05, sid + 1, sid, key),
            _span("estimator.build_measurements", t + 0.05, t + 0.15, 0.1, sid + 2, sid, key),
            _span("estimator.lm_solve", t + 0.15, t + 0.75, 0.3, sid + 3, sid, key),
            _span("estimator.sync_back", t + 0.75, t + 0.8, 0.05, sid + 4, sid, key),
            _span("estimator.manage_window", t + 0.8, t + 0.96, 0.1, sid + 5, sid, key)]


def _frame(t, k, sid):
    """A replayed frame at ``t``: 10 ms inference (6 ms on the CPU, 2 ms
    downloading), 3 + 4 + 5 ms in the queues."""
    return [_span("replay.produce", t, t + 0.003, 0.0001, sid, None, k),
            _span("replay.queued_raw", t + 0.003, t + 0.007, None, sid + 1, None, k),
            _span("replay.infer", t + 0.007, t + 0.017, 0.006, sid + 2, None, k),
            _span("depth.download", t + 0.015, t + 0.017, 0.002, sid + 3, sid + 2, k),
            _span("replay.queued_out", t + 0.017, t + 0.022, None, sid + 4, None, k),
            _span("replay.publish", t + 0.022, t + 0.023, 0.001, sid + 5, None, k)]


def test_numbers_on_synthetic_spans():
    # one keyframe inside the profiled part (before quiet_t0), two past it
    spans = _keyframe(5.0, 0, 1) + _keyframe(11.0, 10, 2) + _keyframe(13.0, 20, 3)
    trace = {"device_by_span": {"estimator.lm_solve": [0.01, 600]},
             "ranges": {"estimator.lm_solve": 1}, "idle_by_span": []}
    run = _run(spans, {"estimator.host_waits": 45}, trace)
    got = {k: f(run) for k, f in ps.METRICS.items()}
    assert got["est_build_ms"] == pytest.approx(100.0)
    assert got["est_lm_ms"] == pytest.approx(600.0)
    assert got["est_sync_back_ms"] == pytest.approx(50.0)
    assert got["est_window_ms"] == pytest.approx(160.0)
    assert got["est_offcpu_ms"] == pytest.approx(300.0)
    assert got["lm_launches"] == pytest.approx(600.0)
    assert got["est_host_waits"] == pytest.approx(15.0)      # all three keyframes
    assert ps.children_share(run, "estimator.input_frame") == pytest.approx(0.96)
    assert ps.stage_means(run)["estimator.lm_solve"] == [pytest.approx(600.0), 2]
    frames = _frame(12.0, 0, 100) + _frame(12.1, 1, 110)
    run = _run(frames)
    assert ps.depth_download_ms(run) == pytest.approx(2.0)
    assert ps.replay_wait_ms(run) == pytest.approx(12.0)
    assert ps.depth_offcpu_ms(run) == pytest.approx(4.0)
    agree = ps.agreement(run, {"depth_infer_ms.explore": {"value": 10.0}},
                         [(12.022, 0.022), (12.122, 0.022), (9.0, 0.5)])
    assert agree["replay_infer_ms_vs_depth_infer_ms"] == [pytest.approx(10.0), 10.0]
    assert agree["replay_path_ms_vs_mean_latency_ms"] == [pytest.approx(23.0),
                                                          pytest.approx(22.0)]


def test_numbers_are_none_without_their_spans():
    empty = _run([])
    assert all(f(empty) is None for f in ps.METRICS.values())
    depth_only = _run(_frame(12.0, 0, 0))
    assert all(ps.METRICS[k](depth_only) is None for k in (
        "est_build_ms", "est_lm_ms", "est_sync_back_ms", "est_window_ms", "lm_launches",
        "est_host_waits", "est_offcpu_ms"))
    vio_only = _run(_keyframe(11.0, 0, 1), {"estimator.host_waits": 3})
    assert all(ps.METRICS[k](vio_only) is None for k in (
        "depth_download_ms", "replay_wait_ms", "depth_offcpu_ms", "lm_launches"))


@pytest.mark.parametrize("cell, seconds, names", [
    ("quadcam_single.depth_replay", 6.0, ("depth_download_ms", "replay_wait_ms",
                                          "depth_offcpu_ms")),
    ("euroc_stereo.explore", 8.0, ("est_build_ms", "est_lm_ms", "est_sync_back_ms",
                                   "est_window_ms", "est_host_waits", "est_offcpu_ms")),
])
def test_tiny_run_with_the_recorder(cell, seconds, names):
    out, got = ps.run_with_recorder(harness, trace_mod, cell, 2**31 + 5, seconds, True, "cpu",
                                    harness.boottime(), overrides=tiny.OVERRIDES[cell],
                                    log=lambda s: None)
    assert out["correct"] and got["rate"] > 0 and got["spans"] > 0
    assert all(got["metrics"][k] is not None and got["metrics"][k] >= 0 for k in names)
    assert not perf._REC.on and perf.drain() == ([], {})
    agree = got["agreement"]
    inner, outer = agree["replay_infer_ms_vs_depth_infer_ms" if "depth" in cell
                         else "input_frame_ms_vs_estimator_ms"]
    assert inner == pytest.approx(outer, rel=0.05)
