"""Each cell at a tiny size on the CPU with the kernels' plain versions:
a run is correct; the control (the reference at the next lower
precision in the program's place) is not; and a run with the timed path
broken underneath is not, for each fault the cell can have."""
import pytest
import torch

from d2slam_tpu_torch.depth import quadcam
from d2slam_tpu_torch.frontend import superpoint as superpoint_mod
from d2slam_tpu_torch.frontend import tracker as tracker_mod
from d2slam_tpu_torch.frontend.superpoint import SuperPointOutput
from portbench.tests import tiny

CELLS = list(tiny.OVERRIDES)
VIO = ["euroc_stereo.explore"]
DEPTH = "quadcam_single.depth_replay"


def failing(out):
    return sorted(k for k, c in out["checks"].items() if c["value"] > c["limit"])


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell):
    out = tiny.run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    rate = "depth_fps" if cell == DEPTH else "vio_fps"
    assert out["metrics"][rate]["value"] > 0 and out["metrics"]["setup_s"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_tiny_traced_run_reads_the_host_layers():
    # the host metrics read the window past the profiler's stop: leave room
    out = tiny.run(DEPTH, trace=True, seconds=6.0)
    assert out["correct"]
    assert {"depth_infer_ms.depth_replay", "depth_p95_ms.depth_replay"} <= set(out["metrics"])
    # no card: nothing is read from a device trace
    assert "bm_roofline.depth_replay" not in out["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = tiny.run(cell, seed=11, control=True)
    assert not out["correct"]
    assert failing(out)


# --- faults planted under the timed path -------------------------------


def _frozen_state(st):
    """The estimator returns the odometry of the window's first keyframe
    from then on: a step that returns its state unchanged."""
    est = st.system.estimator
    inner, first = est.input_frame, []

    def frozen(ff):
        od = inner(ff)
        if od is not None and not first:
            first.append(od)
        return first[0] if first else od

    est.input_frame = frozen


def _half_batch(monkeypatch):
    """SuperPoint on the first half of a frame's views; the rest copy it."""
    inner = tracker_mod.superpoint_extract

    def half(model, img):
        out = inner(model, img[: max(1, len(img) // 2)])
        n = len(img)
        return SuperPointOutput(*(x.repeat(2, *([1] * (x.dim() - 1)))[:n] for x in out))

    monkeypatch.setattr(tracker_mod, "superpoint_extract", half)


def _altered_keypoints(monkeypatch):
    inner = tracker_mod.superpoint_extract

    def shifted(model, img):
        out = inner(model, img)
        return out._replace(kpts=out.kpts + 2.0)

    monkeypatch.setattr(tracker_mod, "superpoint_extract", shifted)


@pytest.mark.parametrize("cell", VIO)
def test_vio_state_left_unchanged_fails(cell):
    out = tiny.run(cell, fault=_frozen_state)
    assert not out["correct"] and "ate_m" in failing(out)


def _no_nms(monkeypatch):
    """The detector's non-maximum suppression left out."""
    monkeypatch.setattr(superpoint_mod, "simple_nms", lambda scores, radius: scores)


@pytest.mark.parametrize("cell", VIO)
@pytest.mark.parametrize("plant, number", [(_half_batch, "desc_gap"),
                                           (_altered_keypoints, "kp_miss"),
                                           (_no_nms, "kp_miss")])
def test_vio_extraction_faults_fail(cell, plant, number, monkeypatch):
    plant(monkeypatch)
    out = tiny.run(cell)
    assert not out["correct"] and number in failing(out)


def _stale_clouds(st):
    """The replay's inference returns the first frame's clouds again."""
    inner, first = st.replay._infer, []

    def stale(imgs, colors):
        if not first:
            first.append(inner(imgs, colors))
        return first[0]

    st.replay._infer = stale


def _half_pairs(monkeypatch):
    """Disparity on the first two pairs; the others copy them."""
    inner = quadcam.disparity

    def half(left, right, **kw):
        d, v = inner(left[:2].contiguous(), right[:2].contiguous(), **kw)
        return d.repeat(2, 1, 1), v.repeat(2, 1, 1)

    monkeypatch.setattr(quadcam, "disparity", half)


def _altered_depth(monkeypatch):
    inner = quadcam.points_from_disparity

    def scaled(*a, **kw):
        pts, ok = inner(*a, **kw)
        return pts * 1.01, ok

    monkeypatch.setattr(quadcam, "points_from_disparity", scaled)


def test_depth_stale_clouds_fail():
    out = tiny.run(DEPTH, fault=_stale_clouds)
    assert not out["correct"] and failing(out)


@pytest.mark.parametrize("plant", [_half_pairs, _altered_depth])
def test_depth_faults_fail(plant, monkeypatch):
    plant(monkeypatch)
    out = tiny.run(DEPTH)
    assert not out["correct"] and failing(out)


def test_no_card_no_result(capsys):
    """Without a card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    from portbench import run
    assert run.main(["--workload", DEPTH, "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
