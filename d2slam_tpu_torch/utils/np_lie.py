"""Numpy quaternion/pose helpers for HOST-side code paths.

Host orchestration (scene generation, landmark bookkeeping, window
management) works on small numpy arrays; a device tensor op per
element would cost a kernel launch each. Same conventions as
geometry.lie (quaternions xyzw, pose [p(3), q(4)]).
"""
from __future__ import annotations

import numpy as np


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def quat_conj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def quat_to_rotmat_batch(q):
    """[N, 4] xyzw quaternions -> [N, 3, 3] rotation matrices
    (vectorized quat_to_rotmat for host hot paths)."""
    q = np.asarray(q)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty(q.shape[:1] + (3, 3), q.dtype)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def quat_to_rotmat(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_to_quat(R):
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s, 0.25 * s]
        )
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array(
            [0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[2, 1] - R[1, 2]) / s]
        )
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array(
            [(R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s,
             (R[0, 2] - R[2, 0]) / s]
        )
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array(
            [(R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s,
             (R[1, 0] - R[0, 1]) / s]
        )
    q = q / np.linalg.norm(q)
    return q if q[3] >= 0 else -q


def quat_rotate(q, v):
    qv, qw = q[:3], q[3]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def pose_compose(a, b):
    return np.concatenate(
        [a[:3] + quat_rotate(a[3:], b[:3]), quat_mul(a[3:], b[3:])]
    )


def pose_inverse(a):
    qi = quat_conj(a[3:] / np.linalg.norm(a[3:]))
    return np.concatenate([-quat_rotate(qi, a[:3]), qi])


def pose_apply(a, x):
    return quat_rotate(a[3:], x) + a[:3]


def quat_from_yaw(yaw):
    return np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])


def quat_log(q):
    """Rotation vector (axis*angle) of a unit quaternion (xyzw)."""
    q = q / np.linalg.norm(q)
    if q[3] < 0:
        q = -q
    s = np.linalg.norm(q[:3])
    if s < 1e-12:
        return 2.0 * q[:3]
    return 2.0 * np.arctan2(s, q[3]) * q[:3] / s


def quat_exp(w):
    """Unit quaternion (xyzw) of a rotation vector."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.concatenate([0.5 * w, [1.0]]) / np.linalg.norm(
            np.concatenate([0.5 * w, [1.0]])
        )
    ax = w / th
    return np.concatenate([np.sin(th / 2) * ax, [np.cos(th / 2)]])


def pose_log(p):
    """Tangent [dt(3), dtheta(3)] of a pose (translation part raw, not
    the SE(3) V-matrix coupling — matches the reference Swarm::Pose
    tangentSpace convention of decoupled pos/att)."""
    return np.concatenate([p[:3], quat_log(p[3:])])


def pose_exp(x):
    return np.concatenate([x[:3], quat_exp(x[3:])])


def pose_average(poses):
    """Euclidean position mean + Markley quaternion average of [n, 7]
    (reference Swarm::Pose::averagePoses)."""
    poses = np.asarray(poses, np.float64)
    pos = poses[:, :3].mean(axis=0)
    M = np.zeros((4, 4))
    for q in poses[:, 3:]:
        q = q / np.linalg.norm(q)
        M += np.outer(q, q)
    w, v = np.linalg.eigh(M)
    q = v[:, -1]
    if q[3] < 0:
        q = -q
    return np.concatenate([pos, q / np.linalg.norm(q)])


def yaw_of(q):
    """Yaw (Z euler) of quaternion [x, y, z, w]."""
    x, y, z, w = q
    return float(np.arctan2(2.0 * (w * z + x * y),
                            1.0 - 2.0 * (y * y + z * z)))


def wrap_angle(a):
    return float(np.arctan2(np.sin(a), np.cos(a)))
