"""The port's multi-view (quadcam) tracker against the JAX package on
the CPU: 4 rendered 240x320 virtual-pinhole views per frame, float32
SuperPoint with the trained weights, ring extrinsics.

Same keyframe decisions; per keyframe and view the same partition of
the observations into landmarks (ids are compared as a partition: two
observations share an id in the port iff they share one in the JAX
package, across views and frames); rays within the equivalent of
0.05 px. The JAX tracker matches on f16-downloaded descriptors and the
port on f32 ones, so a borderline ratio test may flip: at most 2 % of
the observations may differ.
"""
import os

import numpy as np
import pytest
import torch

from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.render import make_signatures, render_blobs
from d2slam_tpu_torch.utils.sim import CircleSim, quadcam_extrinsics

torch.set_num_threads(1)  # tests run one process per core (xdist)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights",
                       "superpoint_synth.npz")
H, W, FX = 240, 320, 220.0


def test_quadcam_extrinsics_and_signatures_match_jax():
    from d2slam_tpu.utils.render import make_signatures as j_sigs
    from d2slam_tpu.utils.render import render_blobs as j_render
    from d2slam_tpu.utils.sim import quadcam_extrinsics as j_ext

    np.testing.assert_array_equal(quadcam_extrinsics(), j_ext())
    np.testing.assert_array_equal(quadcam_extrinsics(3, 0.1), j_ext(3, 0.1))
    sigs = make_signatures(50, seed=9)
    np.testing.assert_array_equal(sigs, j_sigs(50, seed=9))
    sim = CircleSim(seed=7, n_landmarks=50, extrinsics=quadcam_extrinsics(), fov_cos=0.5)
    T = np_lie.pose_compose(sim.gt_pose(0.5)[0], sim.ext[1])
    args = (sim.lms, T, FX, FX, W / 2, H / 2, H, W)
    np.testing.assert_array_equal(render_blobs(*args, signatures=sigs),
                                  j_render(*args, signatures=sigs))


def _fan_extrinsics(n_views=3, step_deg=25.0):
    """Outward views ``step_deg`` apart in yaw: neighbours overlap, so
    cross-view association has something to unify (the 90 deg ring of
    72 deg views does not overlap)."""
    ring = quadcam_extrinsics(int(round(360.0 / step_deg)), 0.05)
    return ring[:n_views]


def _frames(n, ext):
    sim = CircleSim(seed=7, n_landmarks=220, extrinsics=ext, fov_cos=0.5)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    sigs = make_signatures(len(sim.lms), seed=9)
    for k in range(n):
        t = k / sim.frame_hz
        pose, _ = sim.gt_pose(t)
        yield t, k, ext, sim, [
            render_blobs(sim.lms, np_lie.pose_compose(pose, ext[c]), FX, FX,
                         W / 2, H / 2, H, W, intensities=inten, signatures=sigs)
            for c in range(len(ext))]


def _key(ray):
    """An observation's identity: its pixel, rounded to 0.05 px."""
    return (round(FX * ray[0] / ray[2] / 0.05), round(FX * ray[1] / ray[2] / 0.05))


@pytest.mark.parametrize("rig", ["ring4", "fan3"])
def test_process_multiview_matches_jax(rig):
    from d2slam_tpu.frontend.superpoint import SuperPointConfig as JCfg
    from d2slam_tpu.frontend.tracker import FeatureTracker as JTracker
    from d2slam_tpu.frontend.tracker import TrackerConfig as JTrCfg
    from d2slam_tpu.frontend.train_frontend import load_weights
    from d2slam_tpu.geometry.cameras import PinholeParams as JPin
    from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
    from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig
    from d2slam_tpu_torch.geometry.cameras import PinholeParams

    kw = dict(max_keypoints=100, threshold=0.010, nms_radius=4)
    tr = dict(min_keyframe_parallax=4.0, search_radius=30.0)
    jt = tt = None
    # (view, pixel key) -> id, per package, over all keyframes
    j_ids, t_ids = {}, {}
    n_kf = 0
    ext0 = quadcam_extrinsics() if rig == "ring4" else _fan_extrinsics()
    V = len(ext0)
    for t, k, ext, sim, imgs in _frames(3, ext0):
        if jt is None:
            jt = JTracker(load_weights(WEIGHTS), JCfg(**kw),
                          [JPin.make(FX, FX, W / 2, H / 2)] * V, JTrCfg(**tr),
                          frame_rate=sim.frame_hz, extrinsics=ext)
            tt = FeatureTracker(load_params(WEIGHTS), SuperPointConfig(**kw),
                                [PinholeParams.make(FX, FX, W / 2, H / 2)] * V,
                                TrackerConfig(**tr), frame_rate=sim.frame_hz,
                                device="cpu", extrinsics=ext)
        if rig == "ring4":
            jf = jt.process_quadcam(t, k, imgs)
            tf = tt.process_quadcam(t, k, imgs)
        else:
            adj = [(0, 1), (1, 2)]
            jf = jt.process_multiview(t, k, imgs, adj)
            tf = tt.process_multiview(t, k, imgs, adj)
        assert (jf is None) == (tf is None), f"keyframe decision differs at frame {k}"
        if jf is None:
            continue
        n_kf += 1
        assert [o.cam_id for o in jf.observations] == [o.cam_id for o in tf.observations]
        for jo, to in zip(jf.observations, tf.observations):
            for ray, lid in zip(np.asarray(jo.rays), jo.landmark_ids):
                j_ids[(k, jo.cam_id, _key(ray))] = int(lid)
            for ray, lid in zip(np.asarray(to.rays), to.landmark_ids):
                t_ids[(k, to.cam_id, _key(ray))] = int(lid)
    assert n_kf >= 2
    common = sorted(set(j_ids) & set(t_ids))
    # the same observations (points within 0.05 px) on both sides
    assert len(common) >= 0.98 * max(len(j_ids), len(t_ids))
    assert len(common) >= 100
    # the same partition into landmarks: the id maps are one-to-one
    fwd, back, bad = {}, {}, 0
    for key in common:
        a, b = j_ids[key], t_ids[key]
        if fwd.setdefault(a, b) != b or back.setdefault(b, a) != a:
            bad += 1
    assert bad <= 0.02 * len(common), f"{bad} of {len(common)} observations grouped differently"
    # cross-view unification: the overlapping fan shares landmarks
    # between views, the 90 deg ring of 72 deg views cannot
    by_id = {}
    for (k, cam, _), lid in t_ids.items():
        by_id.setdefault((k, lid), set()).add(cam)
    n_shared = sum(len(c) > 1 for c in by_id.values())
    assert (n_shared >= 10) if rig == "fan3" else (n_shared == 0), n_shared
    # temporal tracking happened: some landmark is seen in two frames
    frames_of = {}
    for (k, _, _), lid in t_ids.items():
        frames_of.setdefault(lid, set()).add(k)
    assert any(len(f) > 1 for f in frames_of.values())


def _golden_quadcam(port: bool):
    """The scenario of tests/test_golden_quadcam_image.py through one
    package: 4 views 240x320, num_cams=4, trained weights, 16 frames."""
    if port:
        from d2slam_tpu_torch.config import D2Config
        from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
        from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig
        from d2slam_tpu_torch.geometry.cameras import PinholeParams
        from d2slam_tpu_torch.vins.estimator import D2Estimator
        dev = dict(device="cpu")
        sp_params = load_params(WEIGHTS)
    else:
        from d2slam_tpu.config import D2Config
        from d2slam_tpu.frontend.superpoint import SuperPointConfig
        from d2slam_tpu.frontend.tracker import FeatureTracker, TrackerConfig
        from d2slam_tpu.frontend.train_frontend import load_weights
        from d2slam_tpu.geometry.cameras import PinholeParams
        from d2slam_tpu.vins.estimator import D2Estimator
        dev = {}
        sp_params = load_weights(WEIGHTS)

    cfg = D2Config()
    cfg.num_cams = 4
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 160
    e.max_solve_measurements = 640
    e.max_imu_samples = 128
    e.max_solver_iters = 5
    e.focal_length = FX
    tracker = est = None
    errs, align, t_prev, n_kf = [], None, 0.0, 0
    for t, k, ext, sim, imgs in _frames(16, quadcam_extrinsics()):
        if tracker is None:
            tracker = FeatureTracker(
                sp_params, SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4),
                [PinholeParams.make(FX, FX, W / 2, H / 2) for _ in range(4)],
                TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
                frame_rate=sim.frame_hz, extrinsics=ext, **dev)
            est = D2Estimator(cfg, ext, **dev)
            for (ts, a, g) in sim.imu_samples(-0.3, 0.0):
                est.input_imu(ts, a, g)
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        ff = tracker.process_quadcam(t, k, imgs)
        if ff is None:
            continue
        od = est.input_frame(ff)
        if od is None:
            continue
        n_kf += 1
        pose_gt, _ = sim.gt_pose(t)
        if align is None:
            align = np_lie.pose_compose(np.asarray(od.pose, np.float64),
                                        np_lie.pose_inverse(pose_gt))
        errs.append(np.linalg.norm(od.pose[:3] - np_lie.pose_compose(align, pose_gt)[:3]))
    return n_kf, float(np.sqrt(np.mean(np.square(errs))))


def test_quadcam_vio_slice_matches_jax():
    """The quadcam VIO slice as a whole: the same keyframes as the JAX
    package, the port's ATE under the JAX package's 0.25 m pin
    (GOLDEN_QUADCAM_IMAGE_ATE) and within 3 cm of the JAX run (the
    outward ring has no stereo baseline, so depth comes from motion
    alone and the two float pipelines drift apart more than the stereo
    slice's 5 mm)."""
    n_port, ate_port = _golden_quadcam(port=True)
    n_jax, ate_jax = _golden_quadcam(port=False)
    assert n_port == n_jax >= 10
    assert ate_port < 0.25, f"port ATE {ate_port:.4f} m"
    assert abs(ate_port - ate_jax) < 0.03, (ate_port, ate_jax)


def test_multiview_needs_extrinsics_and_rgbd_is_not_ported():
    from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
    from d2slam_tpu_torch.frontend.tracker import FeatureTracker
    from d2slam_tpu_torch.geometry.cameras import PinholeParams

    tt = FeatureTracker(load_params(WEIGHTS), SuperPointConfig(max_keypoints=32),
                        [PinholeParams.make(FX, FX, 40, 32)] * 2, device="cpu")
    img = np.zeros((64, 80), np.float32)
    img[20:40, 30:50] = 1.0
    with pytest.raises(ValueError):
        tt.process_multiview(0.0, 0, [img, img], [(0, 1)])
    with pytest.raises(NotImplementedError):
        tt.process_rgbd(0.0, 0, img, img)
    # views of different shapes are extracted one by one
    tt.ext = quadcam_extrinsics(2)
    ff = tt.process_multiview(0.0, 0, [img, img[:48]], [])
    assert ff is not None and ff.is_keyframe
