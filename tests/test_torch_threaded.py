"""The port's two-thread runtime (``runtime/threaded.py::PipelinedSystem``)
and dataset replay (``runtime/dataset_vio.py``) on the CPU.

- ``PipelinedSystem`` against the serial ``D2SLAMSystem`` at 240x320 over
  8 frames, with NetVLAD fused into the extraction and loop detection
  on: identical keyframe ids, keyframe poses within 1e-9, and every
  keyframe filed in the loop database under its own frame's global
  descriptor (equal to the serial run's and to NetVLAD of that frame,
  1e-6) with its own keyframe descriptors. The JAX package's backend
  reads the tracker's ``last_aux`` when it registers a keyframe, after
  the caller thread has moved on: this is the check that race fails.
- A frame whose extraction cannot be submitted flushes the pending
  lookahead frame first, so frame ids keep their order.
- ``drop_oldest`` keeps the backend on recent frames; backend errors
  surface on the caller thread (``tests/test_threaded_system.py``).
- ``run_dataset_vio`` over a 6-frame EuRoC directory and the same frames
  as a bag, pipelined, against the in-memory serial run (1e-9).
"""
import os

import numpy as np
import pytest
import torch

from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.datasets.rosbag import RosbagWriter
from d2slam_tpu_torch.frontend.loop_detector import LoopDetectorConfig
from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
from d2slam_tpu_torch.frontend.tracker import Extraction, TrackerConfig
from d2slam_tpu_torch.geometry.cameras import PinholeParams
from d2slam_tpu_torch.runtime.dataset_vio import run_dataset_vio
from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
from d2slam_tpu_torch.runtime.threaded import PipelinedSystem
from d2slam_tpu_torch.utils.euroc_writer import write_euroc_dataset
from d2slam_tpu_torch.utils.sim import CircleSim
from d2slam_tpu_torch.utils.synthetic import replay_events, stereo_replay_sequence
from d2slam_tpu_torch.vins.types import FrontendFrame

torch.set_num_threads(1)  # tests run one process per core (xdist)

H, W, FX = 240, 320, 220.0
N_FRAMES, N_DATASET = 8, 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_WEIGHTS = os.path.join(REPO, "weights", "superpoint_synth.npz")
NV_WEIGHTS = os.path.join(REPO, "weights", "netvlad_synth.npz")


def _cfg():
    cfg = D2Config()
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 128
    e.max_solve_measurements = 512
    e.max_imu_samples = 128
    e.max_solver_iters = 5
    e.focal_length = FX
    return cfg


SETUP = dict(sp_cfg=SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4),
             tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
             loop_cfg=LoopDetectorConfig(min_match_per_dir=8, min_inliers=8))


def _system(ext, frame_rate):
    return D2SLAMSystem(_cfg(), SystemConfig(netvlad_weights=NV_WEIGHTS), ext,
                        [PinholeParams.make(FX, FX, W / 2, H / 2) for _ in range(2)],
                        sp_params=load_params(SP_WEIGHTS), frame_rate=frame_rate,
                        device="cpu", **SETUP)


def _replay(node, imu, frames):
    for ev in replay_events(imu, frames):
        if ev[0] == "imu":
            node.input_imu(*ev[1:])
        else:
            node.input_stereo(ev[1], *ev[2])


@pytest.fixture(scope="module")
def runs():
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=150)
    imu, frames, gt = stereo_replay_sequence(sim, N_FRAMES, H, W, FX)
    serial = _system(sim.ext, sim.frame_hz)
    _replay(serial, imu, frames)
    piped = _system(sim.ext, sim.frame_hz)
    node = PipelinedSystem(piped)
    _replay(node, imu, frames)
    node.drain()
    node.close()
    return dict(sim=sim, imu=imu, frames=frames, gt=gt, serial=serial, piped=piped)


def _keyframes(system):
    return [m[1] for m in system._pgo_meta], system.trajectory(optimized=False)[1]


def test_pipelined_matches_serial_with_loop_detection(runs):
    serial, piped = runs["serial"], runs["piped"]
    ids_s, poses_s = _keyframes(serial)
    ids_p, poses_p = _keyframes(piped)
    assert ids_p == ids_s and len(ids_s) >= 6
    np.testing.assert_allclose(poses_p, poses_s, atol=1e-9, rtol=0)
    np.testing.assert_allclose(piped.odometry.pose, serial.odometry.pose, atol=1e-9, rtol=0)
    assert piped.estimator.solve_count == serial.estimator.solve_count >= 3

    ds, dp = serial.detector, piped.detector
    n = len(ds.entries)
    assert n == len(dp.entries) == len(ids_s)
    np.testing.assert_array_equal(dp._db_frame[:n], ds._db_frame[:n])
    np.testing.assert_allclose(dp.gdesc[:n], ds.gdesc[:n], atol=1e-6, rtol=0)
    for a, b in zip(dp.entries, ds.entries):
        np.testing.assert_array_equal(a.lm_ids, b.lm_ids)
        np.testing.assert_allclose(a.kpt_desc, b.kpt_desc, atol=1e-6, rtol=0)
    # each keyframe is filed under NetVLAD of its own left view
    frames = runs["frames"]
    u8 = torch.as_tensor(np.stack([frames[f][1][0] for f in ids_s]))
    with torch.no_grad():
        own = torch.stack([piped.netvlad(u8[k:k + 1].float() / 255.0)[0]
                           for k in range(len(u8))]).numpy()
    np.testing.assert_allclose(dp.gdesc[:n], own, atol=1e-6, rtol=0)


class _OrderTracker:
    """Extraction submittable on even frames only; records the stamps in
    the order frames are associated."""

    def __init__(self):
        self.order = []

    def submit_stereo_extraction(self, left, right):
        if int(left[0, 0]) % 2:
            return None
        return lambda: Extraction(None, None, None, None)

    def process_stereo(self, t, fid, left, right, extracted=None):
        self.order.append((fid, t))
        return FrontendFrame(stamp=t, frame_id=fid, is_keyframe=True, observations=[])


class _FakeEstimator:
    def __init__(self, delay=0.0):
        self.seen, self.delay, self.imu = [], delay, []

    def input_imu(self, t, acc, gyr):
        self.imu.append(t)

    def input_frame(self, ff):
        import time

        time.sleep(self.delay)
        self.seen.append(ff.frame_id)
        return None


class _FakeSys:
    def __init__(self, tracker, estimator):
        self.tracker, self.estimator = tracker, estimator
        self.odometry = None
        self._frame_id = 0

    def keyframe_inputs(self, imgs, aux=None):
        return {}

    def _register_keyframe(self, *a, **k):
        pass


def test_flush_first_when_lookahead_unavailable():
    tracker, est = _OrderTracker(), _FakeEstimator()
    pipe = PipelinedSystem(_FakeSys(tracker, est), depth=2)
    for k in range(7):
        pipe.input_imu(0.1 * k - 0.05, np.zeros(3), np.zeros(3))
        pipe.input_stereo(0.1 * k, np.full((4, 4), k), np.full((4, 4), k))
    pipe.drain()
    pipe.close()
    assert tracker.order == [(k, pytest.approx(0.1 * k)) for k in range(7)]
    assert est.seen == list(range(7))
    # each frame's IMU reached the estimator before it, in order
    assert est.imu == sorted(est.imu) and len(est.imu) == 7


def test_drop_oldest_and_error_surfacing():
    import time

    s = _FakeSys(_OrderTracker(), _FakeEstimator(delay=0.05))
    s.tracker.submit_stereo_extraction = lambda a, b: None
    pipe = PipelinedSystem(s, depth=2, drop_oldest=True)
    for k in range(20):
        pipe.input_imu(0.1 * k, np.zeros(3), np.zeros(3))
        pipe.input_stereo(0.1 * k, np.zeros((4, 4)), np.zeros((4, 4)))
    time.sleep(1.2)
    pipe.close()
    # the backend fell behind; drop-oldest kept it on recent frames, and
    # no IMU sample was lost with the dropped frames
    assert len(s.estimator.seen) < 20
    assert max(s.estimator.seen) == 19
    assert len(s.estimator.imu) == 20

    class Boom(_FakeEstimator):
        def input_frame(self, ff):
            raise RuntimeError("boom")

    s2 = _FakeSys(_OrderTracker(), Boom())
    pipe2 = PipelinedSystem(s2, depth=2)
    pipe2.input_stereo(0.0, np.zeros((4, 4)), np.zeros((4, 4)))
    with pytest.raises(RuntimeError, match="boom"):
        pipe2.drain()
    pipe2.close()
    assert not pipe2._thread.is_alive()


@pytest.mark.parametrize("source", ["euroc", "bag"])
def test_run_dataset_vio_matches_in_memory_run(runs, tmp_path, source):
    frames = runs["frames"][:N_DATASET]
    t_end = frames[-1][0]
    imu = [s for s in runs["imu"] if s[0] <= t_end]
    if source == "euroc":
        root = str(tmp_path / "euroc")
        write_euroc_dataset(root, imu, frames, [g for g in runs["gt"] if g[0] <= t_end])
    else:
        root = str(tmp_path / "seq.bag")
        with RosbagWriter(root) as w:
            for ev in replay_events(imu, frames):
                if ev[0] == "imu":
                    w.write_imu("/imu0", *ev[1:])
                else:
                    for c, img in enumerate(ev[2]):
                        w.write_image(f"/cam{c}/image_raw", ev[1], img)
    sim = runs["sim"]
    res = run_dataset_vio(root, fx=FX, baseline=0.2, sp_weights=SP_WEIGHTS, cfg=_cfg(),
                          sys_cfg=SystemConfig(netvlad_weights=NV_WEIGHTS), device="cpu",
                          pipelined=True, **SETUP)
    assert res["frames"] == N_DATASET
    ids_s, poses_s = _keyframes(runs["serial"])
    keep = [i for i, f in enumerate(ids_s) if f < N_DATASET]
    ids, poses = _keyframes(res["system"])
    assert ids == [ids_s[i] for i in keep]
    np.testing.assert_allclose(res["poses"], poses_s[keep], atol=1e-9, rtol=0)
    np.testing.assert_allclose(poses, poses_s[keep], atol=1e-9, rtol=0)
    if source == "euroc":
        assert np.isfinite(res["ate_m"]) and res["ate_m"] < 0.05
    else:
        assert res["ate_m"] is None


def test_run_dataset_vio_refuses_missing_weights(tmp_path):
    with pytest.raises((FileNotFoundError, ValueError)):
        run_dataset_vio(str(tmp_path), device="cpu")
    root = str(tmp_path / "d")
    write_euroc_dataset(root, [(0.0, np.zeros(3), np.zeros(3))],
                        [(0.0, [np.zeros((16, 16), np.uint8)] * 2)])
    with pytest.raises(ValueError, match="random_weights"):
        run_dataset_vio(root, device="cpu")
    with pytest.raises(FileNotFoundError):
        run_dataset_vio(root, sp_weights=str(tmp_path / "missing.npz"), device="cpu")
