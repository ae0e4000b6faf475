"""The JAX package's golden textured-room tests on the port
(tests/test_golden_textured.py: ``test_golden_textured_vio`` and
``test_golden_textured_quadcam``, with their pins of 0.18 m and 0.2 m),
on the CPU, ``slow`` as the JAX ones are. ``chip_smoke.py`` phase j
runs both on the card. The swarm case waits for the multi-robot slice.

Only public entry points: images and IMU in, trajectories out.
"""
import os

import numpy as np
import pytest
import torch

from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig
from d2slam_tpu_torch.geometry.cameras import PinholeParams
from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.render import TexturedRoom
from d2slam_tpu_torch.utils.sim import CircleSim, quadcam_extrinsics
from d2slam_tpu_torch.vins.estimator import D2Estimator

SP_W = os.path.join(os.path.dirname(__file__), "..", "weights", "superpoint_synth.npz")
H, W = 240, 320
FX = FY = 220.0
CX, CY = W / 2, H / 2
GOLDEN_TEXTURED_VIO_ATE = 0.18      # the JAX package's pins
GOLDEN_TEXTURED_QUADCAM_ATE = 0.2


def _cfg(num_cams=2, lm_slots=128, meas=512):
    cfg = D2Config()
    cfg.num_cams = num_cams
    e = cfg.estimator
    e.max_sld_win_size, e.min_solve_frames, e.max_lm_slots = 8, 4, lm_slots
    e.max_solve_measurements, e.max_imu_samples, e.max_solver_iters = meas, 128, 5
    e.focal_length = FX
    return cfg


def _render(room, pose, ext, t):
    gain = 1.0 + 0.1 * np.sin(2.1 * t)
    return [room.render(np_lie.pose_compose(pose, e), FX, FY, CX, CY, H, W, gain=gain,
                        vignette=0.25) for e in ext]


@pytest.mark.slow
def test_golden_textured_vio():
    room = TexturedRoom(half=14.0, height=7.0, seed=3)
    sim = CircleSim(seed=11, baseline=0.2, n_landmarks=10)
    system = D2SLAMSystem(
        _cfg(), SystemConfig(drone_id=0, enable_loop_detection=False, enable_pgo=False),
        sim.ext, [PinholeParams.make(FX, FY, CX, CY) for _ in range(2)],
        sp_params=load_params(SP_W), sp_cfg=SuperPointConfig(max_keypoints=200, threshold=0.008),
        tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
        frame_rate=sim.frame_hz, device="cpu")
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    t_prev, traj = 0.0, []
    for k in range(26):
        t = k / sim.frame_hz
        if k > 0:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                system.input_imu(ts, a, g)
        t_prev = t
        imgs = _render(room, sim.gt_pose(t)[0], sim.ext, t)
        od = system.input_stereo(t, imgs[0], imgs[1])
        if od is not None:
            traj.append((t, np.asarray(od.pose, np.float64)))
    assert len(traj) >= 15
    T = np_lie.pose_compose(sim.gt_pose(traj[0][0])[0], np_lie.pose_inverse(traj[0][1]))
    errs = [np.linalg.norm(np_lie.pose_compose(T, p)[:3] - sim.gt_pose(t)[0][:3])
            for (t, p) in traj]
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    assert rmse < GOLDEN_TEXTURED_VIO_ATE, rmse


@pytest.mark.slow
def test_golden_textured_quadcam():
    torch.set_num_threads(1)
    ext = quadcam_extrinsics()
    sim = CircleSim(seed=7, n_landmarks=10, extrinsics=ext, fov_cos=0.5)
    room = TexturedRoom(half=14.0, height=7.0, seed=5)
    sp_cfg = SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4)
    tracker = FeatureTracker(load_params(SP_W), sp_cfg,
                             [PinholeParams.make(FX, FY, CX, CY) for _ in range(4)],
                             TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
                             frame_rate=sim.frame_hz, extrinsics=ext, device="cpu")
    est = D2Estimator(_cfg(4, 160, 640), ext, device="cpu")
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    errs, align, t_prev, n_kf = [], None, 0.0, 0
    for k in range(16):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        pose_gt, _ = sim.gt_pose(t)
        ff = tracker.process_quadcam(t, k, _render(room, pose_gt, ext, t))
        od = est.input_frame(ff) if ff is not None else None
        if od is None:
            continue
        n_kf += 1
        if align is None:
            align = np_lie.pose_compose(od.pose.astype(np.float64), np_lie.pose_inverse(pose_gt))
        errs.append(np.linalg.norm(od.pose[:3] - np_lie.pose_compose(align, pose_gt)[:3]))
    assert n_kf >= 10
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    assert rmse < GOLDEN_TEXTURED_QUADCAM_ATE, rmse
