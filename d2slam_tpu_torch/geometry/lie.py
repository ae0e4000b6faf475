"""Quaternion / SO(3) / SE(3) operations on torch tensors, batched.

Counterpart of ``d2slam_tpu/geometry/lie.py`` with the same conventions:

* Quaternions are stored ``[x, y, z, w]`` (Hamilton convention).
* A "pose" is a flat tensor ``[..., 7]`` = ``[p(3), q(4)]``.
* The retraction (boxplus) adds the first 3 tangent coordinates to the
  position and right-multiplies the quaternion by ``dq(theta) =
  [theta/2, 1]`` (reference PoseLocalParameterization); tangent layout
  is ``[dp(3), dtheta(3)]``.

Every function broadcasts over leading dimensions and is safe under
``torch.func.vmap``/``jacrev`` (no data-dependent Python branches; the
small-angle branches select with ``torch.where`` on safe operands).
"""
from __future__ import annotations

import torch


def _const(vals, like):
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Quaternions (xyzw)
# ---------------------------------------------------------------------------


def quat_mul(q1, q2):
    """Hamilton product q1 ⊗ q2, both xyzw."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * _const([-1.0, -1.0, -1.0, 1.0], q)


def quat_inverse(q):
    return quat_conj(q) / torch.sum(q * q, dim=-1, keepdim=True)


def quat_normalize(q):
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp_min(n, torch.finfo(q.dtype).tiny)
    # canonicalize sign (w >= 0) so logs/averages are stable
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_to_rotmat(q):
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(R):
    """Shepperd's method, branch-free via selecting the max-trace case."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12)) * 2

    s = root(tr + 1.0)  # s = 4w
    c0 = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], -1)
    s = root(1.0 + m00 - m11 - m22)  # s = 4x
    c1 = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1)
    s = root(1.0 + m11 - m00 - m22)  # s = 4y
    c2 = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], -1)
    s = root(1.0 + m22 - m00 - m11)  # s = 4z
    c3 = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], -1)
    cond0 = tr > 0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None], c0,
        torch.where(cond1[..., None], c1, torch.where(cond2[..., None], c2, c3)),
    )
    return quat_normalize(q)


def quat_from_small_angle(theta):
    """First-order quaternion from a small rotation vector: [theta/2, 1],
    normalized (reference Utility::deltaQ)."""
    half = 0.5 * theta
    one = torch.ones(theta.shape[:-1] + (1,), dtype=theta.dtype, device=theta.device)
    return quat_normalize(torch.cat([half, one], dim=-1))


def so3_exp_quat(theta):
    """Exact exponential map rotation-vector -> quaternion (xyzw)."""
    angle_sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    small = angle_sq < 1e-12
    # sqrt of a safe operand: the gradient of sqrt at 0 is infinite
    angle = torch.sqrt(torch.where(small, torch.ones_like(angle_sq), angle_sq))
    angle = torch.where(small, torch.zeros_like(angle), angle)
    safe = torch.where(small, torch.ones_like(angle), angle)
    half = 0.5 * angle
    # sin(a/2)/a  with Taylor fallback 0.5 - a^2/48
    k = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / safe)
    w = torch.cos(half)
    return torch.cat([k * theta, w], dim=-1)


def so3_log_quat(q):
    """Logarithm map quaternion -> rotation vector, on the w >= 0
    hemisphere (shortest geodesic, angle in [0, pi])."""
    q = quat_normalize(q)
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)
    qv = q[..., :3]
    qw = q[..., 3:4]
    n2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    n = torch.where(small, torch.zeros_like(n), n)
    safe_n = torch.where(small, torch.ones_like(n), n)
    angle = 2.0 * torch.atan2(n, qw)
    k = torch.where(small, 2.0 / torch.clamp_min(qw, 1e-12), angle / safe_n)
    return k * qv


def so3_exp(theta):
    return quat_to_rotmat(so3_exp_quat(theta))


def skew(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_left_matrix(q):
    """Q_L(q) such that Q_L(q) @ p = q ⊗ p (xyzw 4-vectors)."""
    x, y, z, w = q.unbind(-1)
    rows = [
        torch.stack([w, -z, y, x], -1),
        torch.stack([z, w, -x, y], -1),
        torch.stack([-y, x, w, z], -1),
        torch.stack([-x, -y, -z, w], -1),
    ]
    return torch.stack(rows, dim=-2)


def quat_right_matrix(q):
    """Q_R(q) such that Q_R(q) @ p = p ⊗ q."""
    x, y, z, w = q.unbind(-1)
    rows = [
        torch.stack([w, z, -y, x], -1),
        torch.stack([-z, w, x, y], -1),
        torch.stack([y, -x, w, z], -1),
        torch.stack([-x, -y, -z, w], -1),
    ]
    return torch.stack(rows, dim=-2)


def quat_average(qs, weights=None):
    """Weighted quaternion average via the Markley eigenvector method
    (32 power iterations on the 4x4 moment matrix, as the JAX
    package's fori_loop). ``qs`` [..., n, 4], ``weights`` [..., n]:
    leading dims are averaged independently."""
    if weights is None:
        weights = torch.ones(qs.shape[:-1], dtype=qs.dtype, device=qs.device)
    tiny = torch.finfo(qs.dtype).tiny
    w = weights / torch.clamp_min(torch.sum(weights, dim=-1, keepdim=True), tiny)
    M = torch.einsum("...n,...ni,...nj->...ij", w, qs, qs)
    v = torch.sum(M, dim=-1) + 1e-3
    for _ in range(32):
        v = (M @ v[..., None])[..., 0]
        v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), tiny)
    return quat_normalize(v)


# ---------------------------------------------------------------------------
# SE(3) poses as flat [p(3), q(4)] tensors
# ---------------------------------------------------------------------------


def pose_compose(a, b):
    """a ∘ b: apply b then a (T_a @ T_b)."""
    pa, qa = a[..., :3], a[..., 3:]
    pb, qb = b[..., :3], b[..., 3:]
    return torch.cat([pa + quat_rotate(qa, pb), quat_mul(qa, qb)], dim=-1)


def pose_inverse(a):
    p, q = a[..., :3], a[..., 3:]
    qi = quat_conj(quat_normalize(q))
    return torch.cat([-quat_rotate(qi, p), qi], dim=-1)


def pose_apply(a, x):
    """Transform point(s) x by pose a."""
    return quat_rotate(a[..., 3:], x) + a[..., :3]


def pose_boxplus(pose, delta):
    """Retraction: [dp(3), dtheta(3)] applied to [p, q]."""
    p, q = pose[..., :3], pose[..., 3:]
    dp, dth = delta[..., :3], delta[..., 3:6]
    return torch.cat(
        [p + dp, quat_normalize(quat_mul(q, quat_from_small_angle(dth)))], dim=-1
    )


def pose_boxminus(a, b):
    """Tangent difference: delta such that b ⊞ delta ≈ a."""
    dp = a[..., :3] - b[..., :3]
    dq = quat_mul(quat_conj(quat_normalize(b[..., 3:])), quat_normalize(a[..., 3:]))
    return torch.cat([dp, so3_log_quat(dq)], dim=-1)


def pose_to_matrix(pose):
    R = quat_to_rotmat(quat_normalize(pose[..., 3:]))
    p = pose[..., :3]
    top = torch.cat([R, p[..., :, None]], dim=-1)
    bottom = _const([0.0, 0.0, 0.0, 1.0], pose).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def pose_from_matrix(T):
    q = rotmat_to_quat(T[..., :3, :3])
    return torch.cat([T[..., :3, 3], q], dim=-1)


def yaw_from_quat(q):
    """ZYX yaw angle of quaternion (xyzw). The components are sliced with
    their last axis kept: under ``jacfwd`` a 0-d tensor times a Python
    float gets a float64 tangent whatever the tensor's dtype."""
    x, y, z, w = (q[..., k:k + 1] for k in range(4))
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))[..., 0]


def quat_from_yaw(yaw):
    half = 0.5 * yaw[..., None]   # kept axis: see yaw_from_quat
    zero = torch.zeros_like(half)
    return torch.cat([zero, zero, torch.sin(half), torch.cos(half)], dim=-1)


def pose4d_boxplus(pose, delta):
    """4-DoF retraction [dx, dy, dz, dyaw] keeping roll/pitch fixed."""
    p, q = pose[..., :3], pose[..., 3:]
    yaw = yaw_from_quat(q)
    tilt = quat_mul(quat_from_yaw(-yaw), q)  # roll/pitch-only part
    new_q = quat_mul(quat_from_yaw(yaw + delta[..., 3]), tilt)
    return torch.cat([p + delta[..., :3], quat_normalize(new_q)], dim=-1)
