"""The port's RGB-D path (reference PINHOLE_DEPTH) against the JAX
package on the CPU.

A depth image holds z along the optical axis. The JAX package attaches
that z to a keypoint as its depth, while its estimator reads a depth as
the distance along the keypoint's unit ray (inverse-depth seed, depth
residual): off the image centre the two differ by 1 / ray_z, and the
RGB-D odometry drifts (3.3 m over 16 frames of the oracle run below).
The port attaches z / ray_z. The tests hold the port to the JAX package
on that footing, and do not pin the defect:

* ``FeatureTracker.process_rgbd``: SuperPoint (trained weights, float32)
  on rendered mono frames with an aligned depth image; both trackers
  attach depths to the same landmark ids, the port's equal to the JAX
  package's z over the port's ray_z (1e-12 relative), and the port holds
  tests/test_tracker.py::test_rgbd_depth_attachment's checks (the
  measured z in range and equal to a landmark's camera-frame z, >= 20
  depth-carrying keypoints).
* ``D2SLAMSystem.input_rgbd`` with the oracle extractor on the z
  image: the depth residuals enter the estimator, the JAX estimator fed
  the same frames agrees within 1e-6 m (float64), and the port's ATE
  stays under 0.1 m.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tests run one process per core (xdist)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "superpoint_synth.npz")
H, W = 240, 320
FX = FY = 220.0
CX, CY = W / 2, H / 2


def render_depth(pts_w, T_cam, hw=(H, W)):
    """Depth image: each landmark's camera-frame z splatted on a 7x7
    disk around its projection (0 = no measurement)."""
    from d2slam_tpu_torch.utils import np_lie

    h, w = hw
    R = np_lie.quat_to_rotmat(T_cam[3:])
    pc = (pts_w - T_cam[:3]) @ R
    d = np.zeros((h, w))
    for p in pc[pc[:, 2] > 0.5]:
        u = int(round(FX * p[0] / p[2] + CX))
        v = int(round(FY * p[1] / p[2] + CY))
        if 3 <= u < w - 3 and 3 <= v < h - 3:
            d[v - 3: v + 4, u - 3: u + 4] = p[2]
    return d


def _ring_scene():
    rng = np.random.default_rng(1)
    n_lm = 100
    ang = rng.uniform(0, 2 * np.pi, n_lm)
    rad = rng.uniform(9.0, 13.0, n_lm)
    pts_w = np.stack([rad * np.cos(ang), rad * np.sin(ang), rng.uniform(0.5, 3.5, n_lm)], axis=1)
    return pts_w, rng.uniform(0.5, 1.0, n_lm)


def _tracker_run(port: bool):
    if port:
        from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
        from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig
        from d2slam_tpu_torch.geometry.cameras import PinholeParams
        from d2slam_tpu_torch.utils import np_lie
        from d2slam_tpu_torch.utils.render import render_blobs
        from d2slam_tpu_torch.utils.sim import circle_gt_ramp, default_extrinsics
        params, dev, dt = load_params(WEIGHTS), dict(device="cpu"), {}
    else:
        from d2slam_tpu.frontend.superpoint import SuperPointConfig
        from d2slam_tpu.frontend.tracker import FeatureTracker, TrackerConfig
        from d2slam_tpu.frontend.train_frontend import load_weights
        from d2slam_tpu.geometry.cameras import PinholeParams
        from d2slam_tpu.utils import np_lie
        from d2slam_tpu.utils.render import render_blobs
        from d2slam_tpu.utils.sim import circle_gt_ramp, default_extrinsics
        params, dev, dt = load_weights(WEIGHTS), {}, dict(dtype=jnp.float32)
    pts_w, inten = _ring_scene()
    ext = default_extrinsics(baseline=0.2)[:1]
    tracker = FeatureTracker(
        params, SuperPointConfig(max_keypoints=128, threshold=1e-4, nms_radius=4),
        [PinholeParams.make(FX, FY, CX, CY, **dt)],
        TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0, depth_min=0.3,
                      depth_max=20.0),
        extrinsics=ext, **dev)
    out = []
    for k in range(6):
        t = k * 0.25
        p, v, a, q, _ = circle_gt_ramp(t)
        T_cam = np_lie.pose_compose(np.concatenate([p, q]), ext[0])
        img = render_blobs(pts_w, T_cam, FX, FY, CX, CY, H, W, intensities=inten)
        ff = tracker.process_rgbd(t, k, img, render_depth(pts_w, T_cam))
        out.append(None if ff is None else (T_cam, ff.observations))
    return out, pts_w


@pytest.fixture(scope="module")
def tracker_runs():
    return _tracker_run(True), _tracker_run(False)


def test_process_rgbd_attaches_depths_as_jax(tracker_runs):
    (port, pts_w), (jax_run, _) = tracker_runs
    got_depth = checked = 0
    for frame, jframe in zip(port, jax_run):
        assert (frame is None) == (jframe is None)
        if frame is None:
            continue
        T_cam, (co,) = frame
        (jco,) = jframe[1]
        np.testing.assert_array_equal(co.landmark_ids, np.asarray(jco.landmark_ids))
        z = co.depths * co.rays[:, 2]           # the measured z back
        np.testing.assert_allclose(z, np.asarray(jco.depths), rtol=1e-12, atol=0)
        pos = co.depths > 0
        got_depth += int(pos.sum())
        checked += len(co.depths)
        assert (z[pos] > 0.3).all() and (z[pos] < 20).all()
        from d2slam_tpu_torch.utils import np_lie
        z_lms = ((pts_w - T_cam[:3]) @ np_lie.quat_to_rotmat(T_cam[3:]))[:, 2]
        for d in z[pos]:
            assert np.min(np.abs(z_lms - d)) < 1e-6
    assert checked > 0
    assert got_depth >= 20, f"only {got_depth}/{checked} with depth"


# ---------------------------------------------------------------------------
# the system's input_rgbd with the oracle extractor
# ---------------------------------------------------------------------------

N_FRAMES = 12


def _config(D2Config):
    cfg = D2Config()
    cfg.num_cams = 1
    e = cfg.estimator
    e.max_sld_win_size, e.min_solve_frames, e.max_lm_slots = 8, 4, 64
    e.max_solve_measurements, e.max_imu_samples, e.max_solver_iters = 256, 64, 4
    e.focal_length = FX
    return cfg


def rgbd_system_run(n_frames: int = N_FRAMES):
    """The port's ``input_rgbd`` over CircleSim's mono camera: oracle
    keypoints, the aligned z image splatted from the landmarks. Returns
    (stamps, poses [N, 7]) of the odometry, the system and the frames its
    estimator took."""
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.frontend.tracker import TrackerConfig
    from d2slam_tpu_torch.geometry.cameras import PinholeParams
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu_torch.utils import np_lie
    from d2slam_tpu_torch.utils.oracle import OracleExtractor
    from d2slam_tpu_torch.utils.sim import CircleSim

    sim = CircleSim(seed=5, n_landmarks=200)
    ext = sim.ext[:1]
    oracle = OracleExtractor(sim.lms, ext, FX, FY, CX, CY, (H, W), max_keypoints=96)
    system = D2SLAMSystem(
        _config(D2Config), SystemConfig(drone_id=0, enable_loop_detection=False,
                                        enable_pgo=False),
        ext, [PinholeParams.make(FX, FY, CX, CY)], extract_fn=oracle,
        tracker_cfg=TrackerConfig(min_keyframe_parallax=0.0, depth_min=0.3, depth_max=20.0),
        frame_rate=sim.frame_hz, device="cpu")
    taken = []
    est_input = system.estimator.input_frame
    system.estimator.input_frame = lambda ff: (taken.append(ff), est_input(ff))[1]
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    stamps, poses, t_prev = [], [], 0.0
    img = np.zeros((H, W), np.float32)
    for k in range(n_frames):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                system.input_imu(ts, a, g)
        t_prev = t
        pose, _ = sim.gt_pose(t)
        oracle.set_pose(pose)
        od = system.input_rgbd(t, img, render_depth(sim.lms, np_lie.pose_compose(pose, ext[0])))
        if od is not None:
            stamps.append(t)
            poses.append(np.asarray(od.pose, np.float64))
    return np.asarray(stamps), np.stack(poses), system, taken


def jax_estimator_replay(frames):
    """The JAX estimator fed the port tracker's frames (depths as ray
    distances) and the same IMU; its odometry per frame."""
    from d2slam_tpu.config import D2Config as JConfig
    from d2slam_tpu.utils.sim import CircleSim as JSim
    from d2slam_tpu.vins.estimator import D2Estimator as JEstimator
    from d2slam_tpu.vins.types import CameraObservations, FrontendFrame

    sim = JSim(seed=5, n_landmarks=200)
    est = JEstimator(_config(JConfig), sim.ext[:1])
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    poses, t_prev = [], 0.0
    for ff in frames:
        if ff.stamp > 0:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, ff.stamp + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = ff.stamp
        jff = FrontendFrame(stamp=ff.stamp, frame_id=ff.frame_id, is_keyframe=ff.is_keyframe,
                            observations=[CameraObservations(
                                o.cam_id, o.landmark_ids, o.rays, o.ray_vels, o.depths)
                                for o in ff.observations])
        od = est.input_frame(jff)
        if od is not None:
            poses.append(np.asarray(od.pose, np.float64))
    return np.stack(poses), est


def test_input_rgbd_matches_jax():
    """The port's RGB-D system run against the JAX estimator on the same
    frames: odometry within 1e-6 m; the port's ATE under 0.1 m."""
    from d2slam_tpu_torch.utils import np_lie
    from d2slam_tpu_torch.utils.sim import CircleSim

    ts_, tp, system, frames = rgbd_system_run()
    jp, jest = jax_estimator_replay(frames)
    assert len(ts_) >= N_FRAMES - 1 and len(jp) == len(tp)
    assert system.estimator.solve_count == jest.solve_count >= 6
    # measured depths reached the estimator's landmark observations
    n_dep = sum(o.depth > 0 for lm in system.estimator.lmanager.db.values() for o in lm.obs)
    assert n_dep > 100
    np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)
    sim = CircleSim(seed=5, n_landmarks=200)
    gts = [sim.gt_pose(t)[0] for t in ts_]
    T = np_lie.pose_compose(gts[0], np_lie.pose_inverse(tp[0]))
    ate = np.sqrt(np.mean([np.sum((np_lie.pose_compose(T, p)[:3] - g[:3]) ** 2)
                           for p, g in zip(tp, gts)]))
    assert ate < 0.1, ate
