"""The port's monocular initialization (``vins/initialization.py``,
``vins/sfm_init.py``) and the estimator's dynamic start against the JAX
package on the CPU, float64.

- ``solve_relative_pose`` on ``tests/test_init_eval.py``'s data, host and
  device paths (the same hypotheses: both draw them from numpy's
  ``default_rng(seed)``): equal inlier masks, R and t within 1e-6.
- ``solve_gyroscope_bias`` and ``linear_alignment`` on that file's
  scenario, ``sfm_initialize`` and ``align_to_gravity`` on
  ``tests/test_sfm_init.py``'s: within 1e-6.
- ``D2Estimator`` on ``tests/test_estimator.py::test_dynamic_start_sfm_init``'s
  scenario (mono, already moving at the start): the same first
  initialized frame and odometry within 1e-5 m.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.config import D2Config as JConfig
from d2slam_tpu.imu import default_noise_matrix as j_noise
from d2slam_tpu.imu import preintegrate as j_preintegrate
from d2slam_tpu.utils.sim import CircleSim as JSim
from d2slam_tpu.vins import initialization as jinit
from d2slam_tpu.vins import sfm_init as jsfm
from d2slam_tpu.vins.estimator import D2Estimator as JEstimator
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.imu.preintegration import default_noise_matrix, preintegrate
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.sim import CircleSim, default_extrinsics
from d2slam_tpu_torch.utils.synthetic import GRAVITY, circle_gt
from d2slam_tpu_torch.vins import initialization as tinit
from d2slam_tpu_torch.vins import sfm_init as tsfm
from d2slam_tpu_torch.vins.estimator import D2Estimator

torch.set_num_threads(1)  # tests run one process per core (xdist)

TOL = 1e-6
NOISE = (0.1, 0.05, 0.002, 0.0004)


def _axis_angle_quat(w):
    th = np.linalg.norm(w)
    return np.concatenate([np.sin(th / 2) * w / th, [np.cos(th / 2)]])


def essential_data():
    """``tests/test_init_eval.py::test_essential_relative_pose``'s data."""
    rng = np.random.default_rng(0)
    R12 = np_lie.quat_to_rotmat(_axis_angle_quat(np.array([0.05, -0.1, 0.2])))
    t12 = np.array([0.4, 0.1, -0.2])
    pts1 = np.concatenate([rng.uniform(-2, 2, (60, 2)), rng.uniform(4, 10, (60, 1))], axis=1)
    r1 = pts1 / np.linalg.norm(pts1, axis=1, keepdims=True)
    pts2 = (R12 @ pts1.T).T + t12
    r2 = pts2 / np.linalg.norm(pts2, axis=1, keepdims=True)
    r2[:6] = rng.normal(0, 1, (6, 3))
    r2[:6] /= np.linalg.norm(r2[:6], axis=1, keepdims=True)
    return r1, r2, R12, t12


@pytest.mark.parametrize("path", ["host", "device"])
def test_solve_relative_pose_matches_jax(path):
    r1, r2, R12, t12 = essential_data()
    R, t, inl = tinit.solve_relative_pose(r1, r2, thresh=1e-4,
                                          device="cpu" if path == "device" else False)
    Rj, tj, inlj = jinit.solve_relative_pose(r1, r2, thresh=1e-4, device=path == "device")
    np.testing.assert_array_equal(inl, inlj)
    assert inl.sum() >= 50 and not inl[:6].any()
    np.testing.assert_allclose(R, Rj, atol=TOL)
    np.testing.assert_allclose(t, tj, atol=TOL)
    np.testing.assert_allclose(R, R12, atol=1e-3)


def _imu_interval(k, dt_f, imu_hz, bg):
    n = int(dt_f * imu_hz) + 1
    dts, accs, gyrs, mask = np.zeros(n), np.zeros((n, 3)), np.zeros((n, 3)), np.zeros(n, bool)
    for i in range(n):
        t = k * dt_f + i / imu_hz
        _, _, a, q = circle_gt(t)
        accs[i] = np_lie.quat_to_rotmat(q).T @ (a + GRAVITY)
        gyrs[i] = np.array([0, 0, 0.5]) + bg
        dts[i] = 0 if i == 0 else 1.0 / imu_hz
        mask[i] = i > 0
    return dts, accs, gyrs, mask


def _preints(K, dt_f, imu_hz, true_bg, lin_bg):
    """Both packages' preintegrations of the same intervals: (port with
    numpy fields, JAX)."""
    t_noise = default_noise_matrix(*NOISE, dtype=torch.float64)
    port, ref = [], []
    for k in range(K):
        d, a, g, m = _imu_interval(k, dt_f, imu_hz, true_bg)
        p = preintegrate(*(torch.as_tensor(x) for x in (d, a, g, m)),
                         torch.zeros(3, dtype=torch.float64), torch.as_tensor(lin_bg), t_noise)
        port.append(type(p)(*(x.numpy() for x in p)))
        ref.append(j_preintegrate(*(jnp.asarray(x) for x in (d, a, g, m)), jnp.zeros(3),
                                  jnp.asarray(lin_bg), j_noise(*NOISE, dtype=jnp.float64)))
    return port, ref


def test_gyro_bias_and_alignment_match_jax():
    """``tests/test_init_eval.py::test_gyro_bias_and_alignment``'s scenario."""
    true_bg = np.array([0.004, -0.003, 0.002])
    K, dt_f, imu_hz, scale_true = 5, 0.25, 400, 2.5
    poses_vis = [np.concatenate([circle_gt(k * dt_f)[0] / scale_true, circle_gt(k * dt_f)[3]])
                 for k in range(K + 1)]
    q_rel = [np_lie.quat_mul(np_lie.quat_conj(poses_vis[k][3:]), poses_vis[k + 1][3:])
             for k in range(K)]
    port, ref = _preints(K, dt_f, imu_hz, true_bg, np.zeros(3))
    dbg = tinit.solve_gyroscope_bias(q_rel, port)
    np.testing.assert_allclose(dbg, jinit.solve_gyroscope_bias(q_rel, ref), atol=TOL)
    np.testing.assert_allclose(dbg, true_bg, atol=5e-4)
    port, ref = _preints(K, dt_f, imu_hz, true_bg, dbg)
    (vt, gt, st), (vj, gj, sj) = (tinit.linear_alignment(poses_vis, port),
                                  jinit.linear_alignment(poses_vis, ref))
    np.testing.assert_allclose(vt, vj, atol=TOL)
    np.testing.assert_allclose(gt, gj, atol=TOL)
    assert abs(st - sj) < TOL and abs(st - scale_true) < 0.02 * scale_true


def test_sfm_initialize_and_gravity_alignment_match_jax():
    """``tests/test_sfm_init.py::test_sfm_initialize_dynamic_mono``'s scenario."""
    rng = np.random.default_rng(0)
    ext = default_extrinsics()
    S, dt_f, imu_hz = 6, 0.25, 400
    true_bg = np.array([0.003, -0.002, 0.004])
    n = 120
    ang, rad, lz = rng.uniform(0, 2 * np.pi, n), rng.uniform(8, 14, n), rng.uniform(0, 4, n)
    lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), lz], 1)
    frame_obs = []
    for k in range(S):
        p, _, _, q = circle_gt(k * dt_f)
        T = np_lie.pose_compose(np.concatenate([p, q]), ext[0])
        pc = (lms - T[:3]) @ np_lie.quat_to_rotmat(T[3:])
        frame_obs.append({int(i): pc[i] / np.linalg.norm(pc[i])
                          for i in np.flatnonzero(pc[:, 2] > 1.0)})
    port, ref = _preints(S - 1, dt_f, imu_hz, true_bg, np.zeros(3))
    out, outj = tsfm.sfm_initialize(frame_obs, ext[0], port), jsfm.sfm_initialize(frame_obs, ext[0], ref)
    assert out is not None and outj is not None
    np.testing.assert_allclose(out["dbg"], outj["dbg"], atol=TOL)
    np.testing.assert_allclose(out["body_poses_visual"], outj["body_poses_visual"], atol=TOL)
    assert sorted(out["landmarks_visual"]) == sorted(outj["landmarks_visual"])
    port, ref = _preints(S - 1, dt_f, imu_hz, true_bg, out["dbg"])
    la, laj = (tinit.linear_alignment(out["body_poses_visual"], port),
               jinit.linear_alignment(outj["body_poses_visual"], ref))
    for a, b in zip(la, laj):
        np.testing.assert_allclose(a, b, atol=TOL)
    poses, vels = tsfm.align_to_gravity(out["body_poses_visual"], *la)
    posesj, velsj = jsfm.align_to_gravity(outj["body_poses_visual"], *laj)
    np.testing.assert_allclose(poses, posesj, atol=TOL)
    np.testing.assert_allclose(vels, velsj, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(vels, axis=1), 2.5, rtol=0.08)


def _dynamic_config(cls):
    """``test_dynamic_start_sfm_init``'s estimator configuration."""
    cfg = cls()
    cfg.num_cams = 1
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 128
    e.max_solve_measurements = 512
    e.max_imu_samples = 128
    e.max_solver_iters = 5
    return cfg


def _run_dynamic(est, sim, n_frames=16):
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    first, outs, t_prev = None, [], 0.0
    for k in range(n_frames):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        ff = sim.frame(k)
        ff.observations = ff.observations[:1]
        od = est.input_frame(ff)
        if od is not None:
            first = k if first is None else first
            outs.append(np.concatenate([np.asarray(od.pose), np.asarray(od.vel)]))
    return first, np.stack(outs)


def test_dynamic_start_matches_jax():
    jsim, tsim = JSim(dynamic_start=True), CircleSim(dynamic_start=True)
    jest = JEstimator(_dynamic_config(JConfig), jsim.ext[:1])
    test = D2Estimator(_dynamic_config(D2Config), tsim.ext[:1], device="cpu")
    jfirst, j = _run_dynamic(jest, jsim)
    tfirst, t = _run_dynamic(test, tsim)
    assert test.initialized and tfirst == jfirst
    assert len(t) == len(j) >= 8
    np.testing.assert_allclose(t[:, :3], j[:, :3], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t[:, 3:], j[:, 3:], atol=1e-5, rtol=0)
    assert abs(np.linalg.norm(t[-1, 7:]) - 2.5) < 0.3
