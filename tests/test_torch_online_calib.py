"""Online camera-IMU calibration in the port (``estimate_extrinsic``,
``estimate_td``) against the JAX package on the CPU: the four tests of
tests/test_online_calib.py on the port, with their pins, and one run
with both estimates on (perturbed extrinsics, a camera delay) through
both packages on the same features.

Reference: d2vins_params.hpp:17-141 estimate_extrinsic / estimate_td;
the td correction through the ray velocity,
projectionTwoFrameOneCamFactor.cpp:34-76. Tolerance of the comparison:
1e-6 (m, and unit quaternion components) on the estimated extrinsics
and on the odometry, 1e-9 s on the estimated time offset (float64,
sums in another order).
"""
import numpy as np
import torch

from d2slam_tpu.config import D2Config as JConfig
from d2slam_tpu.utils.sim import CircleSim as JSim
from d2slam_tpu.vins.estimator import D2Estimator as JEstimator
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.sim import CircleSim
from d2slam_tpu_torch.vins.estimator import D2Estimator

torch.set_num_threads(1)  # tests run one process per core (xdist)


def _cfg(cls, **kw):
    cfg = cls()
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 128
    e.max_solve_measurements = 512
    e.max_imu_samples = 128
    e.max_solver_iters = 8
    for k, v in kw.items():
        setattr(e, k, v)
    return cfg


def _run(sim, est, n_frames):
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    t_prev, poses = 0.0, []
    for k in range(n_frames):
        t = k / sim.frame_hz
        if k > 0:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        od = est.input_frame(sim.frame(k))
        poses.append(np.asarray(od.pose, np.float64))
    return est, np.stack(poses)


def _rot_err_deg(q_est, q_true):
    dq = np_lie.quat_mul(np_lie.quat_conj(np.asarray(q_true, np.float64)),
                         np.asarray(q_est, np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(dq[:3]))))


def _perturbed_ext(true_ext):
    """3 deg rotation + 2 cm translation error on each camera."""
    rng = np.random.default_rng(7)
    pert = true_ext.copy()
    for c in range(len(pert)):
        axis = rng.normal(0, 1, 3)
        axis /= np.linalg.norm(axis)
        ang = np.radians(3.0)
        dq = np.concatenate([np.sin(ang / 2) * axis, [np.cos(ang / 2)]])
        pert[c, 3:] = np_lie.quat_mul(pert[c, 3:], dq)
        pert[c, :3] += rng.normal(0, 0.02, 3)
    return pert


EXT_SIM = dict(n_landmarks=300, seed=3, baseline=0.2, wobble=0.18)
TD_TRUE = 0.008
TD_SIM = dict(n_landmarks=300, seed=5, baseline=0.2, cam_td=TD_TRUE)


def test_calibration_matches_jax():
    """Both estimates on over 8 frames of a wobbling rig with perturbed
    extrinsics and a 8 ms camera delay: the port's extrinsics, td and
    odometry equal the JAX package's."""
    sim_kw = dict(EXT_SIM, cam_td=TD_TRUE)
    pert = _perturbed_ext(CircleSim(**sim_kw).ext)
    kw = dict(estimate_extrinsic=True, estimate_td=True)
    est, poses = _run(CircleSim(**sim_kw), D2Estimator(_cfg(D2Config, **kw), pert, device="cpu"),
                      8)
    jest, jposes = _run(JSim(**sim_kw), JEstimator(_cfg(JConfig, **kw), pert), 8)
    assert est.solve_count == jest.solve_count >= 4
    np.testing.assert_allclose(est.state.ext.numpy(), np.asarray(jest.state.ext), atol=1e-6,
                               rtol=0)
    assert abs(float(est.state.td) - float(np.asarray(jest.state.td))) < 1e-9
    assert float(est.state.td) != 0.0
    np.testing.assert_allclose(poses, jposes, atol=1e-6, rtol=0)


def test_online_extrinsic_recovery():
    """3 deg rotation + 2 cm translation error on both cameras'
    extrinsics comes back toward the truth (rotation error < 0.35x,
    translation < 0.6x the perturbation)."""
    true_ext = CircleSim(**EXT_SIM).ext
    pert = _perturbed_ext(true_ext)
    est, _ = _run(CircleSim(**EXT_SIM),
                  D2Estimator(_cfg(D2Config, estimate_extrinsic=True), pert, device="cpu"), 24)
    ext = est.state.ext.numpy()
    for c in range(len(true_ext)):
        r0 = _rot_err_deg(pert[c, 3:], true_ext[c, 3:])
        r1 = _rot_err_deg(ext[c, 3:], true_ext[c, 3:])
        t0 = np.linalg.norm(pert[c, :3] - true_ext[c, :3])
        t1 = np.linalg.norm(ext[c, :3] - true_ext[c, :3])
        assert r1 < 0.35 * r0, f"cam{c} rotation {r0:.2f} -> {r1:.2f} deg"
        assert t1 < 0.6 * t0, f"cam{c} translation {t0 * 100:.1f} -> {t1 * 100:.1f} cm"


def test_extrinsic_fixed_when_disabled():
    """With estimate_extrinsic off (the default) a perturbed extrinsic
    stays exactly where it was put."""
    sim = CircleSim(n_landmarks=200, seed=3, baseline=0.2)
    pert = sim.ext.copy()
    pert[1, :3] += [0.01, 0, 0]
    est, _ = _run(sim, D2Estimator(_cfg(D2Config), pert, device="cpu"), 10)
    np.testing.assert_allclose(est.state.ext.numpy(), pert, atol=1e-9)


def test_online_td_recovery():
    """A +8 ms camera delay is recovered by the td state to within 35 %,
    and the odometry stays finite."""
    est, _ = _run(CircleSim(**TD_SIM), D2Estimator(_cfg(D2Config, estimate_td=True),
                                                   CircleSim(**TD_SIM).ext, device="cpu"), 24)
    td = float(est.state.td)
    assert abs(td - TD_TRUE) < 0.35 * TD_TRUE, f"td {td * 1e3:.2f} ms vs {TD_TRUE * 1e3:.1f} ms"
    assert np.isfinite(est.latest_odometry().pose).all()


def test_td_zero_when_synchronized():
    """A synchronized rig with estimate_td on keeps td near zero."""
    sim = CircleSim(n_landmarks=300, seed=5, baseline=0.2, cam_td=1e-9)
    est, _ = _run(sim, D2Estimator(_cfg(D2Config, estimate_td=True), sim.ext, device="cpu"), 16)
    assert abs(float(est.state.td)) < 0.002, f"spurious td {float(est.state.td) * 1e3:.2f} ms"
