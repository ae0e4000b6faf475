"""The JAX package's golden textured-room tests on the port
(tests/test_golden_textured.py: ``test_golden_textured_vio``,
``test_golden_textured_quadcam`` and ``test_golden_textured_swarm``, with
their pins: 0.18 m, 0.2 m; at least 3 inter-robot loops, the best with
at least 50 inliers, and a joint RMSE under 0.35 m), on the CPU,
``slow`` as the JAX ones are. ``chip_smoke.py`` phase j runs the first
two on the card, phase m the swarm.

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

WDIR = os.path.join(os.path.dirname(__file__), "..", "weights")
SP_W = os.path.join(WDIR, "superpoint_synth.npz")
NV_W = os.path.join(WDIR, "netvlad_synth.npz")
SG_W = os.path.join(WDIR, "superglue_synth.npz")
H, W = 240, 320
FX = FY = 220.0
CX, CY = W / 2, H / 2
GOLDEN_TEXTURED_VIO_ATE = 0.18      # the JAX package's pins
GOLDEN_TEXTURED_QUADCAM_ATE = 0.2
GOLDEN_TEXTURED_SWARM_RMSE = 0.35
GOLDEN_TEXTURED_SWARM_MIN_BEST_INLIERS = 50


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


@pytest.mark.slow
def test_golden_textured_swarm():
    """Two robots in one textured room on a ``LocalBus``, SuperGlue remote
    with the shipped weights, NetVLAD: inter-robot loops from pixels with
    dozens of PnP inliers, and a consistent joint map.

    The pins hold the graph of the robot that merged into the other's
    reference frame (robot 1), whose peer never changes world: the graph
    the JAX test reads in the JAX package, where robot 0 verifies no
    inter-robot loop itself and robot 1 is the first robot with an
    alignment. Here both robots verify loops. Robot 0's graph chains
    robot 1's keyframes across its merge with an ego edge holding the
    jump, in both packages (ROADMAP Queue 3), and is printed:
    tests/test_torch_image_witness.py::test_textured_swarm_beside_jax
    sets it beside the JAX package's."""
    from d2slam_tpu_torch.comm.transport import LocalBus
    from d2slam_tpu_torch.frontend.loop_detector import LoopDetectorConfig

    room = TexturedRoom(half=14.0, height=7.0, seed=3)
    sims = [CircleSim(seed=7, baseline=0.2, n_landmarks=10, phase=0.0),
            CircleSim(seed=7, baseline=0.2, n_landmarks=10, phase=0.3)]
    sp_params = load_params(SP_W)
    bus = LocalBus()
    systems = []
    for i, sim in enumerate(sims):
        systems.append(D2SLAMSystem(
            _cfg(), SystemConfig(drone_id=i, pgo_every_n_kf=100, netvlad_weights=NV_W,
                                 enable_superglue_remote=True, superglue_weights=SG_W),
            sim.ext, [PinholeParams.make(FX, FY, CX, CY) for _ in range(2)],
            sp_params=sp_params, sp_cfg=SuperPointConfig(max_keypoints=300, threshold=0.008),
            transport=bus.endpoint(i),
            tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
            loop_cfg=LoopDetectorConfig(gdesc_dim=1024, min_gap_frames=2, min_inliers=20,
                                        min_match_per_dir=8, pnp_thresh=16.0 / 460.0),
            frame_rate=sim.frame_hz, device="cpu"))
    for s, sim in zip(systems, sims):
        for (t, a, g) in sim.imu_samples(-0.3, 0.0):
            s.input_imu(t, a, g)
    t_prev = 0.0
    for k in range(26):
        t = k / sims[0].frame_hz
        for s, sim in zip(systems, sims):
            if k > 0:
                for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                    s.input_imu(ts, a, g)
            imgs = _render(room, sim.gt_pose(t)[0], sim.ext, t)
            s.input_stereo(t, imgs[0], imgs[1])
        t_prev = t
        for s in systems:
            s.poll_network(now=t)
    for _ in range(3):
        for s in systems:
            s.poll_network(now=t_prev)

    assert all(s.swarm.alignments for s in systems), "no inter-robot map alignment from images"
    assert [s.ref_frame_id for s in systems] == [0, 0]
    host = systems[1]
    inter = [e for e in host.loop_edges if e.drone_id_a != e.drone_id_b]
    assert len(inter) >= 3, f"only {len(inter)} inter-robot loops"
    best = max(e.inliers for e in inter)
    print(f"textured swarm: {len(inter)} inter loops, inliers {[e.inliers for e in inter]}")
    assert best >= GOLDEN_TEXTURED_SWARM_MIN_BEST_INLIERS, best
    rmse = {}
    for s in systems:
        s.solve_pgo()
        stamps_s, ego_s = s.trajectory(drone_id=s.drone_id, optimized=False)
        T = np_lie.pose_compose(sims[s.drone_id].gt_pose(stamps_s[0])[0],
                                np_lie.pose_inverse(ego_s[0]))
        other = 1 - s.drone_id
        stamps_o, opt_o = s.trajectory(drone_id=other)
        assert len(stamps_o) >= 8
        errs = [np.linalg.norm(np_lie.pose_compose(T, p)[:3] - sims[other].gt_pose(st)[0][:3])
                for st, p in zip(stamps_o, opt_o)]
        rmse[s.drone_id] = float(np.sqrt(np.mean(np.square(errs))))
    print(f"textured swarm joint RMSE {rmse[1]:.3f} m (robot 0's graph: {rmse[0]:.3f} m)")
    assert rmse[1] < GOLDEN_TEXTURED_SWARM_RMSE, rmse
