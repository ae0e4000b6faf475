"""Parity of the port's geometry (d2slam_tpu_torch.geometry) with the
JAX package on the CPU.

Inputs come from a numpy seed and go through both packages in float64.
Tolerance: 1e-9 absolute (the same closed-form arithmetic; only the
order of float64 operations may differ).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.geometry import cameras as jcam
from d2slam_tpu.geometry import lie as jlie
from d2slam_tpu_torch.geometry import cameras as tcam
from d2slam_tpu_torch.geometry import lie as tlie

torch.set_num_threads(1)  # tests run one process per core (xdist)

TOL = 1e-9


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _poses(rng, n):
    return np.concatenate([rng.normal(size=(n, 3)), _quats(rng, n)], axis=1)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", [
    "quat_mul", "quat_rotate", "pose_compose", "pose_boxplus", "pose_boxminus",
])
def test_binary_ops_match_jax(name):
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    p1, p2 = _poses(rng, 16), _poses(rng, 16)
    v = rng.normal(size=(16, 3))
    d = 0.3 * rng.normal(size=(16, 6))
    args = {
        "quat_mul": (q1, q2), "quat_rotate": (q1, v),
        "pose_compose": (p1, p2), "pose_boxplus": (p1, d),
        "pose_boxminus": (p1, p2),
    }[name]
    t = getattr(tlie, name)(*[torch.as_tensor(a) for a in args])
    j = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    _close(t, j)


@pytest.mark.parametrize("name", [
    "quat_normalize", "quat_to_rotmat", "so3_log_quat", "pose_inverse",
    "yaw_from_quat", "quat_left_matrix", "quat_right_matrix",
    "quat_inverse", "quat_conj", "pose_to_matrix",
])
def test_unary_ops_match_jax(name):
    rng = np.random.default_rng(1)
    x = _poses(rng, 32) if name.startswith("pose") else _quats(rng, 32)
    x[0] = [0, 0, 0, 1] if x.shape[1] == 4 else [0, 0, 0, 0, 0, 0, 1]
    _close(getattr(tlie, name)(torch.as_tensor(x)),
           getattr(jlie, name)(jnp.asarray(x)))


def test_exp_log_rotmat_and_average_match_jax():
    rng = np.random.default_rng(2)
    th = rng.normal(size=(32, 3))
    th[0] = 0.0
    th[1] = 1e-8
    _close(tlie.so3_exp_quat(torch.as_tensor(th)), jlie.so3_exp_quat(jnp.asarray(th)))
    R = np.array(jlie.so3_exp(jnp.asarray(th)))
    _close(tlie.rotmat_to_quat(torch.as_tensor(R)), jlie.rotmat_to_quat(jnp.asarray(R)))
    _close(tlie.skew(torch.as_tensor(th)), jlie.skew(jnp.asarray(th)))
    T = np.array(jlie.pose_to_matrix(jnp.asarray(_poses(rng, 8))))
    _close(tlie.pose_from_matrix(torch.as_tensor(T)), jlie.pose_from_matrix(jnp.asarray(T)))
    yaw = rng.uniform(-3, 3, 8)
    _close(tlie.quat_from_yaw(torch.as_tensor(yaw)), jlie.quat_from_yaw(jnp.asarray(yaw)))
    p, d4 = _poses(rng, 8), rng.normal(size=(8, 4))
    _close(tlie.pose4d_boxplus(torch.as_tensor(p), torch.as_tensor(d4)),
           jlie.pose4d_boxplus(jnp.asarray(p), jnp.asarray(d4)))
    q = _quats(rng, 8)
    w = rng.uniform(0.1, 1.0, 8)
    _close(tlie.quat_average(torch.as_tensor(q), torch.as_tensor(w)),
           jlie.quat_average(jnp.asarray(q), jnp.asarray(w)))


def test_pinhole_project_and_lift_match_jax():
    rng = np.random.default_rng(3)
    k = dict(fx=220.0, fy=221.0, cx=160.0, cy=120.0, k1=-0.1, k2=0.01,
             p1=1e-3, p2=-2e-3)
    pts = np.concatenate([rng.uniform(-1, 1, (64, 2)), rng.uniform(0.5, 4, (64, 1))], 1)
    tp, tv = tcam.pinhole_project(torch.as_tensor(pts), tcam.PinholeParams.make(**k))
    jp, jv = jcam.pinhole_project(jnp.asarray(pts),
                                  jcam.PinholeParams.make(**k, dtype=jnp.float64))
    _close(tp, jp)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    uv = rng.uniform([0, 0], [320, 240], (64, 2))
    _close(tcam.pinhole_lift(torch.as_tensor(uv), tcam.PinholeParams.make(**k)),
           jcam.pinhole_lift(jnp.asarray(uv),
                             jcam.PinholeParams.make(**k, dtype=jnp.float64)))


def test_reverse_mode_jacobians_finite_at_identity():
    """jacrev through the retraction at a zero tangent (the seed every
    factor linearizes at) must not produce NaN (the quaternion-log
    hazard of docs/DESIGN.md section 9)."""
    from torch.func import jacrev

    pose = torch.tensor([0.0, 0, 0, 0, 0, 0, 1], dtype=torch.float64)
    for f in (
        lambda d: tlie.pose_boxplus(pose, d),
        lambda d: tlie.pose_boxminus(tlie.pose_boxplus(pose, d), pose),
        lambda d: tlie.so3_exp_quat(d[3:]),
    ):
        J = jacrev(f)(torch.zeros(6, dtype=torch.float64))
        assert torch.isfinite(J).all()
