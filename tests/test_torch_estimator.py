"""Parity of the port's estimator (static init, frame addition, IMU
factors, triangulation, LM solve, marginalization with the prior
carried across window shifts) with the JAX package on the CPU.

Oracle observations from the circle simulator (seeded pixel and IMU
noise) go through both estimators in float64 over more frames than the
window holds, so the window shifts and marginalizes. Tolerance: 1e-6 m
/ 1e-6 on every odometry output (float64 throughout; sums differ only
in order).
"""
import numpy as np
import torch

from d2slam_tpu.config import D2Config as JConfig
from d2slam_tpu.utils.sim import CircleSim as JSim
from d2slam_tpu.vins.estimator import D2Estimator as JEstimator
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.utils.sim import CircleSim
from d2slam_tpu_torch.vins.estimator import D2Estimator

torch.set_num_threads(1)  # tests run one process per core (xdist)

N_FRAMES = 12
SIM_KW = dict(seed=5, pix_noise_rad=0.5 / 460.0, acc_noise=0.02, gyr_noise=0.002)


def _config(cls):
    cfg = cls()
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 64
    e.max_solve_measurements = 256
    e.max_imu_samples = 64
    e.max_solver_iters = 4
    return cfg


def _run(est, sim):
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    out, t_prev = [], 0.0
    for k in range(N_FRAMES):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        od = est.input_frame(sim.frame(k))
        out.append(np.concatenate([od.pose, od.vel]))
    return np.stack(out)


def test_estimator_matches_jax():
    jsim, tsim = JSim(**SIM_KW), CircleSim(**SIM_KW)
    jest = JEstimator(_config(JConfig), jsim.ext)
    test = D2Estimator(_config(D2Config), tsim.ext, device="cpu")
    j = _run(jest, jsim)
    t = _run(test, tsim)
    assert test.margin_count == jest.margin_count >= 1
    assert test.solve_count == jest.solve_count
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    # the prior stays a (device) tensor: its normal equations match
    jp, tp = jest.prior, test.prior
    Jj = np.asarray(jp.J) * np.asarray(jp.row_valid)[:, None]
    Jt = tp.J.numpy() * tp.row_valid.numpy()[:, None]
    scale = np.abs(Jj.T @ Jj).max()
    np.testing.assert_allclose((Jt.T @ Jt) / scale, (Jj.T @ Jj) / scale, atol=1e-6)
    # IMU-rate prediction past the last frame
    jpred = jest.predict_odometry(N_FRAMES / jsim.frame_hz - 0.05)
    tpred = test.predict_odometry(N_FRAMES / tsim.frame_hz - 0.05)
    np.testing.assert_allclose(tpred.pose, np.asarray(jpred.pose), atol=1e-6)

