"""Rotations and poses for the benchmark's scene generators (numpy).

Poses are [7] arrays: position, then a unit quaternion in x, y, z, w
order, the layout the port's entry points take for extrinsics.
"""
from __future__ import annotations

import numpy as np


def quat_to_rotmat(q) -> np.ndarray:
    """[..., 4] xyzw quaternions -> [..., 3, 3] rotation matrices."""
    q = np.asarray(q, np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rotmat_to_quat(R) -> np.ndarray:
    """[3, 3] rotation -> [4] xyzw unit quaternion (Shepperd's method:
    the largest of w, x, y, z is taken from the diagonal, the others
    from the off-diagonal terms divided by it)."""
    R = np.asarray(R, np.float64)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, s / 4]
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [s / 4, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s, (R[2, 1] - R[1, 2]) / s]
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 1] + R[1, 0]) / s, s / 4, (R[1, 2] + R[2, 1]) / s, (R[0, 2] - R[2, 0]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, s / 4, (R[1, 0] - R[0, 1]) / s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def quat_mul(a, b) -> np.ndarray:
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def pose_compose(a, b) -> np.ndarray:
    """a * b of two [7] poses."""
    return np.concatenate([a[:3] + quat_to_rotmat(a[3:]) @ b[:3], quat_mul(a[3:], b[3:])])


def pose(R, t) -> np.ndarray:
    return np.concatenate([np.asarray(t, np.float64), rotmat_to_quat(R)])


def rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


# a forward-looking camera on a body whose x axis points ahead:
# camera z = body x, camera x = -body y, camera y = -body z
R_BODY_CAM = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])


def stereo_extrinsics(baseline: float) -> np.ndarray:
    """[2, 7] body_T_cam of a forward stereo pair, left camera at +y."""
    return np.stack([pose(R_BODY_CAM, [0.0, baseline / 2, 0.0]),
                     pose(R_BODY_CAM, [0.0, -baseline / 2, 0.0])])


def fisheye_ring_extrinsics(baseline: float) -> np.ndarray:
    """[4, 7] body_T_cam of 4 outward fisheyes at 90 degree steps about
    the camera y axis, each displaced along its optical axis, so that
    adjacent centres sit ``baseline`` apart, perpendicular to the
    direction between the two cameras (a rectified virtual pair)."""
    radius = baseline / np.sqrt(2.0)
    out = []
    for i in range(4):
        R = rot_y(np.deg2rad(90.0 * i))
        out.append(pose(R, R @ np.array([0.0, 0.0, radius])))
    return np.stack(out)
