"""The metrics' arithmetic on synthetic completions, spans and traces."""
import pytest

from portbench import stats
from portbench.trace import WINDOW, summarize


def test_rate_is_a_count_over_the_time_to_the_last_completion():
    assert stats.rate(10.0, [10.5, 11.0, 12.0, 14.0]) == pytest.approx(4 / 4.0)
    assert stats.rate(10.0, [9.0, 10.5]) == pytest.approx(1 / 0.5)   # before t0 not counted
    assert stats.rate(10.0, []) is None


def test_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 95) is None


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 10)]
    assert stats.gaps(iv, -1, 1) == [(-1, 0)]


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_summary_on_a_synthetic_trace():
    ev = [
        _ev(WINDOW, "user_annotation", 0, 1000),
        _ev("pb:stem", "user_annotation", 100, 50, tid=1),
        _ev("pb:estimator", "user_annotation", 300, 600, tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 110, 5, tid=1, corr=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 120, 5, tid=1, corr=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 400, 5, tid=2, corr=3),
        _ev("k_stem", "kernel", 130, 40, corr=1),
        _ev("k_pool", "kernel", 160, 20, corr=2),       # overlaps k_stem by 10
        _ev("k_est", "kernel", 500, 100, corr=3),
        _ev("Memcpy DtoH", "gpu_memcpy", 950, 100),     # cut at the window's end
    ]
    s = summarize(ev)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx((50 + 100 + 50) * 1e-6)
    assert s.n_device_ops == 4
    assert s.range_device_s["stem"] == pytest.approx(60e-6)
    assert s.range_device_s["estimator"] == pytest.approx(100e-6)
    idle = dict(s.idle_gaps)
    # idle [0,130) with no span open; [180,500) and [600,950) in the estimator's
    assert idle == {"other": pytest.approx(130e-6), "estimator": pytest.approx(670e-6)}
    assert s.device_ops[0] == ("k_est", pytest.approx(100e-6))


def test_trace_without_device_work_reads_nothing():
    assert summarize([_ev(WINDOW, "user_annotation", 0, 1000)]) is None
