"""Image-level parity of the port's ``D2SLAMSystem`` with the JAX
package's on the CPU: the same rendered stereo pairs (CircleSim seed 7,
240x320, 16 frames) through ``input_stereo`` of both systems, with the
trained SuperPoint (weights/superpoint_synth.npz) and the float32
backbone (the bfloat16 one would split the two at tied NMS maxima, a
JAX defect the port does not copy), loop detection and PGO off.

The two ego (VIO) trajectories must agree keyframe by keyframe: the
same keyframes, positions and quaternions within 1e-6 (float32
SuperPoint on both sides, so keypoints differ in their last bits;
float64 estimator).
"""
import os

import numpy as np
import torch

torch.set_num_threads(1)  # tests run one process per core (xdist)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "superpoint_synth.npz")
H, W, FX = 240, 320, 220.0
N_FRAMES = 16


def image_system_run(port: bool):
    if port:
        from d2slam_tpu_torch.config import D2Config
        from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
        from d2slam_tpu_torch.frontend.tracker import TrackerConfig
        from d2slam_tpu_torch.geometry.cameras import PinholeParams
        from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
        from d2slam_tpu_torch.utils import np_lie
        from d2slam_tpu_torch.utils.render import render_blobs
        from d2slam_tpu_torch.utils.sim import CircleSim
        params, dev, sys_kw = load_params(WEIGHTS), dict(device="cpu"), {}
    else:
        from d2slam_tpu.config import D2Config
        from d2slam_tpu.frontend.superpoint import SuperPointConfig
        from d2slam_tpu.frontend.tracker import TrackerConfig
        from d2slam_tpu.frontend.train_frontend import load_weights
        from d2slam_tpu.geometry.cameras import PinholeParams
        from d2slam_tpu.runtime.system import D2SLAMSystem, SystemConfig
        from d2slam_tpu.utils import np_lie
        from d2slam_tpu.utils.render import render_blobs
        from d2slam_tpu.utils.sim import CircleSim
        params, dev, sys_kw = load_weights(WEIGHTS), {}, dict(broadcast=False)
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=150)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    cfg = D2Config()
    e = cfg.estimator
    e.max_sld_win_size, e.min_solve_frames, e.max_lm_slots = 8, 4, 128
    e.max_solve_measurements, e.max_imu_samples, e.max_solver_iters = 512, 128, 5
    e.focal_length = FX
    system = D2SLAMSystem(
        cfg, SystemConfig(drone_id=0, enable_loop_detection=False, enable_pgo=False, **sys_kw),
        sim.ext, [PinholeParams.make(FX, FX, W / 2, H / 2) for _ in range(2)],
        sp_params=params,
        sp_cfg=SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4,
                                compute_dtype="float32"),
        tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
        frame_rate=sim.frame_hz, **dev)
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    frames, poses, t_prev = [], [], 0.0
    for k in range(N_FRAMES):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                system.input_imu(ts, a, g)
        t_prev = t
        pose_gt, _ = sim.gt_pose(t)
        imgs = [render_blobs(sim.lms, np_lie.pose_compose(pose_gt, sim.ext[c]),
                             FX, FX, W / 2, H / 2, H, W, intensities=inten) for c in range(2)]
        od = system.input_stereo(t, imgs[0], imgs[1])
        if od is not None:
            frames.append(k)
            poses.append(np.asarray(od.pose, np.float64))
    return frames, np.stack(poses), system


def test_image_level_system_matches_jax():
    frames, poses, system = image_system_run(True)
    jframes, jposes, jsystem = image_system_run(False)
    assert frames == jframes and len(frames) >= 12
    assert system.estimator.solve_count == jsystem.estimator.solve_count
    assert system.estimator.margin_count == jsystem.estimator.margin_count >= 1
    np.testing.assert_allclose(poses, jposes, atol=1e-6, rtol=0)
