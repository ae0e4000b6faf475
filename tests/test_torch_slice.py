"""The port's first slice as a whole, against the JAX package on the CPU,
plus the port's guard rails.

* Golden image-level stereo VIO (the scenario of
  tests/test_golden_image_vio.py: CircleSim seed 7, 240x320, trained
  weights, 16 frames) through both packages, with the float32 backbone
  and with the bfloat16 one (the port's stem in its plain version, the
  JAX package's in XLA): equal keyframe counts, port ATE under the
  0.03 m pin, ATEs within 5 mm of each other, median track length >= 6.
* The port imports neither ``jax`` nor ``d2slam_tpu`` (AST scan of the
  package and of chip_smoke.py).
* Entry points raise without ``device="cpu"`` when no CUDA device is
  available; the stem wrapper raises on inputs its kernel does not take.
"""
import ast
import glob
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tests run one process per core (xdist)

REPO = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(REPO, "weights", "superpoint_synth.npz")
GOLDEN_IMAGE_ATE = 0.03  # m, the JAX package's pin


def _golden(port: bool, compute_dtype: str = "float32"):
    if port:
        from d2slam_tpu_torch.config import D2Config
        from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
        from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig
        from d2slam_tpu_torch.geometry.cameras import PinholeParams
        from d2slam_tpu_torch.utils import np_lie
        from d2slam_tpu_torch.utils.render import render_blobs
        from d2slam_tpu_torch.utils.sim import CircleSim
        from d2slam_tpu_torch.vins.estimator import D2Estimator
        dev = dict(device="cpu")
        sp_params = load_params(WEIGHTS)
    else:
        from d2slam_tpu.config import D2Config
        from d2slam_tpu.frontend.superpoint import SuperPointConfig
        from d2slam_tpu.frontend.tracker import FeatureTracker, TrackerConfig
        from d2slam_tpu.frontend.train_frontend import load_weights
        from d2slam_tpu.geometry.cameras import PinholeParams
        from d2slam_tpu.utils import np_lie
        from d2slam_tpu.utils.render import render_blobs
        from d2slam_tpu.utils.sim import CircleSim
        from d2slam_tpu.vins.estimator import D2Estimator
        dev = {}
        sp_params = load_weights(WEIGHTS)

    H, W = 240, 320
    FX = FY = 220.0
    CX, CY = W / 2, H / 2
    sp_cfg = SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4,
                              compute_dtype=compute_dtype)
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=150)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    cfg = D2Config()
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 128
    e.max_solve_measurements = 512
    e.max_imu_samples = 128
    e.max_solver_iters = 5
    e.focal_length = FX
    cams = [PinholeParams.make(FX, FY, CX, CY) for _ in range(2)]
    tracker = FeatureTracker(
        sp_params, sp_cfg, cams,
        TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
        frame_rate=sim.frame_hz, **dev)
    est = D2Estimator(cfg, sim.ext, **dev)
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
        imgs = [render_blobs(sim.lms, np_lie.pose_compose(pose_gt, sim.ext[c]),
                             FX, FY, CX, CY, H, W, intensities=inten)
                for c in range(2)]
        ff = tracker.process_stereo(t, k, imgs[0], imgs[1])
        if ff is None:
            continue
        od = est.input_frame(ff)
        if od is None:
            continue
        n_kf += 1
        if align is None:
            align = np_lie.pose_compose(od.pose.astype(np.float64),
                                        np_lie.pose_inverse(pose_gt))
        errs.append(np.linalg.norm(od.pose[:3] - np_lie.pose_compose(align, pose_gt)[:3]))
    tl = [lm.track_length() for lm in est.lmanager.db.values()]
    return n_kf, float(np.sqrt(np.mean(np.square(errs)))), float(np.median(tl))


def test_golden_slice_matches_jax():
    n_port, ate_port, track_port = _golden(port=True)
    n_jax, ate_jax, _ = _golden(port=False)
    assert n_port == n_jax >= 12
    assert ate_port < GOLDEN_IMAGE_ATE, f"port ATE {ate_port:.4f} m"
    assert abs(ate_port - ate_jax) < 0.005, (ate_port, ate_jax)
    assert track_port >= 6


def test_golden_slice_bf16_matches_jax():
    """The configuration the card runs: the port's bf16 trunk rounds as
    cuDNN does (conv, then bias), so this run is the card's path with
    the stem kernel's plain version."""
    n_port, ate_port, track_port = _golden(port=True, compute_dtype="bfloat16")
    n_jax, ate_jax, _ = _golden(port=False, compute_dtype="bfloat16")
    assert n_port == n_jax >= 12
    assert ate_port < GOLDEN_IMAGE_ATE, f"port ATE {ate_port:.4f} m"
    assert abs(ate_port - ate_jax) < 0.005, (ate_port, ate_jax)
    assert track_port >= 6


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = glob.glob(os.path.join(REPO, "d2slam_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "d2slam_tpu"), (path, mod)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.frontend.superpoint import SuperPoint, SuperPointConfig, load_params
    from d2slam_tpu_torch.frontend.tracker import FeatureTracker
    from d2slam_tpu_torch.geometry.cameras import PinholeParams
    from d2slam_tpu_torch.utils.sim import default_extrinsics
    from d2slam_tpu_torch.vins.estimator import D2Estimator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = load_params(WEIGHTS)
    cams = [PinholeParams.make(220, 220, 160, 120)] * 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SuperPoint(params, SuperPointConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureTracker(params, SuperPointConfig(), cams)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D2Estimator(D2Config(), default_extrinsics())
    assert D2Estimator(D2Config(), default_extrinsics(), device="cpu").device.type == "cpu"


def test_stem_wrapper_rejects_bad_inputs():
    from d2slam_tpu_torch.ops.superpoint_stem import pack_stem_weights, superpoint_stem

    rng = np.random.default_rng(0)
    w = pack_stem_weights(rng.normal(size=(3, 3, 1, 64)), rng.normal(size=64),
                          rng.normal(size=(3, 3, 64, 64)), rng.normal(size=64),
                          device="cpu")
    good = torch.zeros(1, 16, 16)
    assert superpoint_stem(good, w).shape == (1, 8, 8, 64)
    for bad in (torch.zeros(1, 15, 16), torch.zeros(1, 16, 17),
                torch.zeros(16, 16), torch.zeros(1, 16, 16, dtype=torch.float64),
                torch.zeros(1, 16, 16, dtype=torch.bfloat16)):
        with pytest.raises(ValueError):
            superpoint_stem(bad, w)
    with pytest.raises(ValueError):
        superpoint_stem(good, w._replace(w2=w.w2.float()))
    with pytest.raises(ValueError):
        superpoint_stem(good, w._replace(b1=w.b1[:32]))
