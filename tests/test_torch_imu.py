"""Parity of the port's IMU path (buffer, preintegration, propagation,
sqrt-info) with the JAX package on the CPU.

Samples come from the circle simulator with seeded noise and go through
both packages in float64. Tolerance: 1e-9 (relative to each quantity's
scale for the covariance/sqrt-info, whose entries span many decades).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from d2slam_tpu.factors.residuals import imu_sqrt_info as j_sqrt_info
from d2slam_tpu.imu.buffer import IMUBuffer as JBuffer
from d2slam_tpu.imu.preintegration import (
    default_noise_matrix as j_noise,
    imu_propagate_pose as j_propagate,
    preintegrate as j_preintegrate,
)
from d2slam_tpu_torch.factors.residuals import imu_sqrt_info as t_sqrt_info
from d2slam_tpu_torch.imu.buffer import IMUBuffer as TBuffer
from d2slam_tpu_torch.imu.preintegration import (
    default_noise_matrix as t_noise,
    imu_propagate_pose as t_propagate,
    preintegrate as t_preintegrate,
)
from d2slam_tpu_torch.utils.sim import CircleSim

torch.set_num_threads(1)  # tests run one process per core (xdist)

TOL = 1e-9


def _buffers():
    sim = CircleSim(seed=3, acc_noise=0.05, gyr_noise=0.01,
                    acc_bias=(0.02, -0.01, 0.03), gyr_bias=(0.001, 0.0, -0.002))
    jb, tb = JBuffer(), TBuffer()
    for (t, a, g) in sim.imu_samples(0.0, 1.0):
        jb.add(t, a, g)
        tb.add(t, a, g)
    return jb, tb


def _windows(buf, n=64):
    out = [buf.period(0.125 * k, 0.125 * (k + 1), n) for k in range(4)]
    return [np.stack(x) for x in zip(*out)]


def test_buffer_period_matches_jax():
    jb, tb = _buffers()
    for a, b in zip(_windows(jb), _windows(tb)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jb.mean_acc(), tb.mean_acc())


def test_preintegrate_matches_jax():
    _, tb = _buffers()
    dts, accs, gyrs, mask = _windows(tb)
    rng = np.random.default_rng(0)
    ba, bg = rng.normal(0, 0.02, (4, 3)), rng.normal(0, 0.002, (4, 3))
    nz = (0.1, 0.05, 0.002, 0.0004)
    jr = jax.vmap(j_preintegrate, in_axes=(0, 0, 0, 0, 0, 0, None))(
        *[jnp.asarray(x) for x in (dts, accs, gyrs, mask, ba, bg)],
        j_noise(*nz, dtype=jnp.float64))
    tr = t_preintegrate(*[torch.as_tensor(x) for x in (dts, accs, gyrs, mask, ba, bg)],
                        t_noise(*nz, dtype=torch.float64))
    for name in ("delta_p", "delta_q", "delta_v", "jacobian", "sum_dt"):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)), atol=TOL, rtol=0)
    cov_j = np.array(jr.covariance)
    scale = np.abs(cov_j).max()
    np.testing.assert_allclose(tr.covariance.numpy() / scale, cov_j / scale, atol=TOL)

    S_j = np.asarray(jax.vmap(j_sqrt_info)(jnp.asarray(cov_j)))
    S_t = t_sqrt_info(torch.as_tensor(cov_j)).numpy()
    np.testing.assert_allclose(S_t, S_j, rtol=1e-7, atol=1e-9 * np.abs(S_j).max())
    # padded (all-zero) covariances stay finite
    assert np.isfinite(t_sqrt_info(torch.zeros(2, 15, 15, dtype=torch.float64)).numpy()).all()


def test_propagate_pose_matches_jax():
    _, tb = _buffers()
    dts, accs, gyrs, mask = tb.period(0.25, 0.5, 128)
    pose = np.array([5.0, 0.1, 2.0, 0.0, 0.0, 0.7071067811865476, 0.7071067811865476])
    vel, ba, bg = np.array([0.1, 0.5, 0.0]), np.full(3, 0.01), np.full(3, -1e-3)
    grav = np.array([0.0, 0.0, -9.805])
    jp, jv = j_propagate(*[jnp.asarray(x) for x in
                           (pose, vel, ba, bg, dts, accs, gyrs, mask, grav)])
    tp, tv = t_propagate(*[torch.as_tensor(x) for x in
                           (pose, vel, ba, bg, dts, accs, gyrs, mask, grav)])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL, rtol=0)
