"""The port's single-robot ``D2SLAMSystem`` against the JAX package's on
the CPU.

* The feature-level scenario of tests/test_system.py (CircleSim seed 3,
  300 landmarks, oracle features, bag-of-landmark global descriptors,
  18 frames, PGO every 6 keyframes) through both packages with the dense
  solver: the same keyframes and PGO solves, the same verified loop
  frame pairs and inlier counts, PGO trajectories within 5 mm (the
  tolerance of tests/test_torch_slice.py). The matrix-free PCG variant is
  tests/test_torch_system_pcg.py.
* An image-level run at 120x160 with NetVLAD (weights/netvlad_synth.npz)
  fused into the tracker's extraction: ``last_aux`` feeds the retrieval
  database, and each stored descriptor equals the JAX package's
  ``netvlad_apply`` on that frame's left image; each landmark enters a
  keyframe's entry once; the PGO runs on the background worker
  (``pgo_async``).
* Every mode builds on the CPU and runs a few frames: the multi-robot
  estimators ("distributed", "server"), DPGO, SuperGlue local and remote,
  a transport, RGB-D; without a card the system needs ``device="cpu"``.
"""
import os

import numpy as np
import pytest
import torch

import tests.test_system as TS

torch.set_num_threads(1)  # tests run one process per core (xdist)

REPO = os.path.join(os.path.dirname(__file__), "..")
SP_WEIGHTS = os.path.join(REPO, "weights", "superpoint_synth.npz")
NV_WEIGHTS = os.path.join(REPO, "weights", "netvlad_synth.npz")
TRAJ_TOL = 0.005  # m


def _modules(port: bool):
    if port:
        from d2slam_tpu_torch.config import D2Config
        from d2slam_tpu_torch.frontend.loop_detector import KeyframeEntry, LoopDetectorConfig
        from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
        from d2slam_tpu_torch.utils.sim import CircleSim
        return D2Config, KeyframeEntry, LoopDetectorConfig, D2SLAMSystem, SystemConfig, CircleSim
    from d2slam_tpu.config import D2Config
    from d2slam_tpu.frontend.loop_detector import KeyframeEntry, LoopDetectorConfig
    from d2slam_tpu.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu.utils.sim import CircleSim
    return D2Config, KeyframeEntry, LoopDetectorConfig, D2SLAMSystem, SystemConfig, CircleSim


def small_config(D2Config):
    cfg = D2Config()
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 128
    e.max_solve_measurements = 512
    e.max_imu_samples = 128
    e.max_solver_iters = 5
    return cfg


def run_feature_level(port: bool, n_frames: int = 18, **sys_kw):
    """tests/test_system.py::make_system + drive, in either package."""
    D2Config, KeyframeEntry, LoopDetectorConfig, D2SLAMSystem, SystemConfig, CircleSim = \
        _modules(port)
    sim = CircleSim(n_landmarks=TS.N_LM, seed=3)
    kw = dict(pgo_every_n_kf=6, pgo_max_poses=64, pgo_max_edges=128, pgo_iters=6)
    kw.update(sys_kw)
    loop_cfg = LoopDetectorConfig(desc_dim=TS.DESC_DIM, gdesc_dim=TS.GDESC_DIM, netvlad_thres=0.5,
                                  min_match_per_dir=10, min_inliers=12, min_gap_frames=6)
    system = D2SLAMSystem(small_config(D2Config), SystemConfig(drone_id=0, **kw), sim.ext,
                          cameras=None, extract_fn=lambda img, cam: None, loop_cfg=loop_cfg,
                          **(dict(device="cpu") if port else {}))
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    t_prev = 0.0
    for k in range(n_frames):
        t = k / sim.frame_hz
        if k > 0:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                system.input_imu(ts, a, g)
        t_prev = t
        ff = sim.frame(k)
        pose = system.odometry.pose if system.odometry is not None else np.eye(1, 7, 6)[0]
        ids = np.asarray(ff.observations[0].landmark_ids, int)
        entry = KeyframeEntry(
            frame_id=ff.frame_id, drone_id=0, stamp=ff.stamp, pose=np.asarray(pose, np.float64),
            kpt_rays=np.asarray(ff.observations[0].rays, np.float64),
            kpt_cam=np.zeros(len(ids), np.int32), kpt_desc=TS.DESC_TABLE[ids],
            kpt_valid=np.ones(len(ids), bool), lm_positions=np.full((len(ids), 3), np.nan))
        system.input_frame(ff, gdesc=TS.bag_gdesc(ids), kf_entry=entry)
    return system


def assert_systems_agree(sj, sp):
    assert sp.estimator.initialized and sj.estimator.initialized
    assert sp.pgo_solve_count == sj.pgo_solve_count >= 2
    st_j, opt_j = sj.trajectory()
    st_p, opt_p = sp.trajectory()
    np.testing.assert_allclose(st_p, st_j)
    assert len(st_p) >= 10
    assert np.abs(opt_p[:, :3] - opt_j[:, :3]).max() < TRAJ_TOL
    _, ego_p = sp.trajectory(optimized=False)
    assert np.max(np.linalg.norm(opt_p[:, :3] - ego_p[:, :3], axis=1)) < 0.2
    od = sp.pgo_odometry()
    assert od is not None and np.isfinite(od.pose).all()


@pytest.fixture(scope="module")
def dense_runs():
    return run_feature_level(False, pgo_solver="dense"), run_feature_level(True, pgo_solver="dense")


def test_feature_level_dense_matches_jax(dense_runs):
    assert_systems_agree(*dense_runs)


def test_feature_level_loops_match_jax(dense_runs):
    """The scenario's verified loops (the JAX package finds nine): the same
    frame pairs and inlier counts, kept by PCM, and the same PGO cost."""
    sj, sp = dense_runs
    pairs_j = [(e.frame_id_a, e.frame_id_b, e.inliers) for e in sj.loop_edges]
    pairs_p = [(e.frame_id_a, e.frame_id_b, e.inliers) for e in sp.loop_edges]
    assert len(pairs_j) >= 1 and pairs_p == pairs_j
    for ej, ep in zip(sj.loop_edges, sp.loop_edges):
        np.testing.assert_allclose(ep.rel_pose, ej.rel_pose, atol=1e-6)
    assert sp.loops_kept == len(pairs_p)
    rj, rp = sj.last_pgo_report, sp.last_pgo_report
    assert rp.final_cost == pytest.approx(float(rj.final_cost), rel=1e-3)


def test_image_level_netvlad_fused():
    """120x160 stereo through the port's system with NetVLAD fused into
    the extraction (so ``last_aux`` feeds the detector) and the PGO on
    its worker thread."""
    import jax
    import jax.numpy as jnp

    from d2slam_tpu.frontend.netvlad import netvlad_apply, netvlad_cfg_from_params
    from d2slam_tpu.frontend.train_frontend import load_weights
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
    from d2slam_tpu_torch.frontend.tracker import TrackerConfig, _img_u8
    from d2slam_tpu_torch.geometry.cameras import PinholeParams
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu_torch.utils import np_lie
    from d2slam_tpu_torch.utils.render import render_blobs
    from d2slam_tpu_torch.utils.sim import CircleSim

    H, W, F = 120, 160, 110.0
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=150)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    cfg = small_config(D2Config)
    cfg.estimator.focal_length = F
    sys_cfg = SystemConfig(netvlad_weights=NV_WEIGHTS, pgo_every_n_kf=3, pgo_async=True)
    system = D2SLAMSystem(
        cfg, sys_cfg, sim.ext, [PinholeParams.make(F, F, W / 2, H / 2)] * 2,
        sp_params=load_params(SP_WEIGHTS),
        sp_cfg=SuperPointConfig(max_keypoints=100, threshold=0.010),
        tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
        frame_rate=sim.frame_hz, device="cpu")
    assert sys_cfg.gdesc_dim == 1024                     # the caller's config is left alone
    assert system.sys.gdesc_dim == system.detector.cfg.gdesc_dim == 1025
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    n_frames, lefts, t_prev = 9, {}, 0.0
    for k in range(n_frames):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                system.input_imu(ts, a, g)
        t_prev = t
        pose_gt, _ = sim.gt_pose(t)
        imgs = [render_blobs(sim.lms, np_lie.pose_compose(pose_gt, sim.ext[c]), F, F, W / 2,
                             H / 2, H, W, intensities=inten) for c in range(2)]
        lefts[k] = imgs[0]
        system.input_stereo(t, imgs[0], imgs[1])
        assert system.tracker.last_aux is not None and system.tracker.last_aux.shape == (1025,)
    system.close()
    assert system.netvlad.calls == n_frames
    entries = system.detector.entries
    assert len(entries) >= 5 and system.pgo_solve_count >= 1
    nv_j = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), load_weights(NV_WEIGHTS))
    for slot, e in enumerate(entries):
        # one keypoint per landmark: a stereo entry lists no descriptor twice
        assert len(np.unique(e.lm_ids)) == len(e.lm_ids) == len(e.kpt_desc)
        u8 = _img_u8(lefts[e.frame_id])
        ref = np.asarray(netvlad_apply(nv_j, jnp.asarray(u8, jnp.float32)[None, ..., None] / 255.0,
                                       netvlad_cfg_from_params(nv_j)))[0]
        assert np.abs(system.detector.gdesc[slot] - ref).max() <= 2e-5
    stamps, opt = system.trajectory()
    assert len(stamps) == len(entries) and np.isfinite(opt).all()


def test_tracker_extract_fn_replaces_superpoint():
    """An oracle extractor of one view (the JAX package's ``extract_fn``
    contract) stands in for SuperPoint: the tracker stacks its views,
    runs no auxiliary pass and tracks from them."""
    from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, SuperPointOutput
    from d2slam_tpu_torch.frontend.tracker import FeatureTracker
    from d2slam_tpu_torch.geometry.cameras import PinholeParams

    rng = np.random.default_rng(0)
    kpts = rng.uniform(20, 140, (30, 2)).astype(np.float32)
    desc = rng.normal(0, 1, (30, 32)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    calls = []

    def oracle(img, cam):
        calls.append(cam)
        shift = np.array([-6.0 * cam, 0.0], np.float32)   # the right view: 6 px disparity
        return SuperPointOutput(kpts=kpts + shift, scores=np.ones(30, np.float32),
                                desc=desc, valid=np.ones(30, bool))

    tracker = FeatureTracker(None, SuperPointConfig(), [PinholeParams.make(100, 100, 80, 60)] * 2,
                             extract_fn=oracle, aux_fn=lambda u8: 1 / 0, device="cpu")
    out, k, v = tracker.extract(np.zeros((2, 120, 160), np.float32))
    assert calls == [0, 1] and out.desc.shape == (2, 30, 32) and v.all()
    np.testing.assert_array_equal(k[1], kpts - [6.0, 0.0])
    assert tracker.last_aux is None
    ff = tracker.process_stereo(0.0, 0, np.zeros((120, 160)), np.zeros((120, 160)))
    assert ff is not None and len(ff.observations[0].landmark_ids) == 30
    assert len(ff.observations[1].landmark_ids) == 30   # every left point found on the right


def oracle_stereo_run(n_frames=6, transports=(None,), loop_cfg=None, img=None, **sys_kw):
    """Port systems on CircleSim stereo frames with oracle 256-d features
    (one system per transport, frame by frame, each polling after every
    frame; the oracle ignores the images, ``img`` for both views, zeros by
    default). Returns the systems."""
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.frontend.tracker import TrackerConfig
    from d2slam_tpu_torch.geometry.cameras import PinholeParams
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu_torch.utils.oracle import OracleExtractor
    from d2slam_tpu_torch.utils.sim import CircleSim

    H, W, F = 120, 160, 110.0
    sims = [CircleSim(seed=5, n_landmarks=200, phase=0.1 * i) for i in range(len(transports))]
    systems, oracles = [], []
    for i, (sim, tr) in enumerate(zip(sims, transports)):
        cfg = small_config(D2Config)
        cfg.estimator.focal_length = F
        oracles.append(OracleExtractor(sim.lms, sim.ext, F, F, W / 2, H / 2, (H, W),
                                       max_keypoints=64, desc_dim=256))
        systems.append(D2SLAMSystem(
            cfg, SystemConfig(drone_id=i, pgo_every_n_kf=3, **sys_kw), sim.ext,
            [PinholeParams.make(F, F, W / 2, H / 2)] * 2, extract_fn=oracles[-1],
            tracker_cfg=TrackerConfig(min_keyframe_parallax=0.0, search_radius=30.0),
            loop_cfg=loop_cfg, transport=tr, frame_rate=sim.frame_hz, device="cpu"))
    for s, sim in zip(systems, sims):
        for (t, a, g) in sim.imu_samples(-0.3, 0.0):
            s.input_imu(t, a, g)
    if img is None:
        img = np.zeros((H, W), np.float32)
    t_prev = 0.0
    for k in range(n_frames):
        t = k / sims[0].frame_hz
        for s, sim, oracle in zip(systems, sims, oracles):
            if k:
                for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                    s.input_imu(ts, a, g)
            oracle.set_pose(sim.gt_pose(t)[0])
            s.input_stereo(t, img, img)
        t_prev = t
        for s in systems:
            s.poll_network(now=t)
    return systems


@pytest.mark.parametrize("change", [
    dict(estimation_mode="distributed"), dict(estimation_mode="server"), dict(enable_dpgo=True),
    dict(enable_superglue_local=True), dict(enable_superglue_remote=True), "transport",
    "input_rgbd"])
def test_modes_build_and_run(change):
    """Each mode builds on the CPU and runs a few frames: the multi-robot
    estimators and DPGO (their depth is tests/test_torch_distributed_system.py),
    RGB-D, SuperGlue local and remote, a transport."""
    from d2slam_tpu_torch.comm.transport import LocalBus

    if change == "input_rgbd":
        # the RGB-D path returns odometry (its parity with the JAX package
        # is tests/test_torch_rgbd.py)
        from tests.test_torch_rgbd import rgbd_system_run

        stamps, poses, _, _ = rgbd_system_run(n_frames=6)
        assert len(stamps) >= 5 and np.isfinite(poses).all()
        return
    if change == "transport":
        # two robots on a LocalBus hear each other's keyframes (the swarm's
        # parity is tests/test_torch_swarm.py)
        bus = LocalBus()
        systems = oracle_stereo_run(transports=(bus.endpoint(0), bus.endpoint(1)))
        for s, peer in zip(systems, (1, 0)):
            assert s.estimator.initialized and len(s.swarm.remote_trajs[peer]) >= 3
            assert len(s.trajectory(drone_id=peer, optimized=False)[0]) >= 3
            assert not s.remote_images   # send_img is off
        return
    if change.get("estimation_mode") == "distributed":
        # robots stepped one after the other: each sub-step waits its short
        # timeout for the peer's copy and averages what arrived
        bus = LocalBus()
        systems = oracle_stereo_run(transports=(bus.endpoint(0), bus.endpoint(1)),
                                    assume_common_world=True, max_drones=2,
                                    consensus_timeout_ms=5, **change)
        for s, peer in zip(systems, (1, 0)):
            assert type(s.estimator).__name__ == "SolveAllEstimator"
            assert s.estimator.initialized and s.estimator._consensus_token >= 1
            assert peer in {f.drone_id for f in s.estimator.frames}
        return
    if change.get("estimation_mode") == "server":
        from d2slam_tpu_torch.config import D2Config
        from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
        from d2slam_tpu_torch.utils.sim import default_extrinsics

        bus = LocalBus()
        server = D2SLAMSystem(D2Config(), SystemConfig(drone_id=9, assume_common_world=True,
                                                       broadcast=False, max_drones=2, **change),
                              default_extrinsics(), None, extract_fn=lambda img, cam: None,
                              transport=bus.endpoint(9), device="cpu")
        oracle_stereo_run(transports=(bus.endpoint(0), bus.endpoint(1)),
                          assume_common_world=True)
        server.poll_network(now=1.0)
        fused = server.solve_server()
        assert set(fused) == {0, 1} and all(np.isfinite(o.pose).all() for o in fused.values())
        return
    if change.get("enable_dpgo"):
        bus = LocalBus()
        systems = oracle_stereo_run(transports=(bus.endpoint(0), bus.endpoint(1)),
                                    assume_common_world=True, **change)
        for s in systems:
            assert s.dpgo is not None and s.dpgo.iteration >= 1 and s.pgo_solve_count >= 1
            assert np.isfinite(s.trajectory()[1]).all()
        return
    # the shipped compact SuperGlue matches the tracker's keyframe gaps
    # (local) or the loop candidates (remote; the retrieval gate is opened
    # so every keyframe is a candidate); parity with the JAX matcher is
    # tests/test_torch_superglue.py
    from d2slam_tpu_torch.frontend.loop_detector import LoopDetectorConfig

    loop_cfg = LoopDetectorConfig(desc_dim=256, gdesc_dim=1024, netvlad_thres=-1.0,
                                  min_gap_frames=1)
    (s,) = oracle_stereo_run(loop_cfg=loop_cfg, superglue_weights=os.path.join(
        REPO, "weights", "superglue_synth.npz"), **change)
    assert s.superglue is not None and s.superglue.cfg.num_layers == 3
    assert s.superglue.calls >= 3 and s.estimator.initialized
    assert (s.tracker.matcher_fn is not None) == bool(change.get("enable_superglue_local"))
    assert (s.detector.matcher_fn is not None) == bool(change.get("enable_superglue_remote"))


def test_system_needs_a_card_or_cpu(monkeypatch):
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu_torch.utils.sim import default_extrinsics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D2SLAMSystem(D2Config(), SystemConfig(), default_extrinsics(), None,
                     extract_fn=lambda img, cam: None)
