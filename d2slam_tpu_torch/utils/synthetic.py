"""Ground-truth kinematics shared by the simulators (numpy only)."""
from __future__ import annotations

import numpy as np

GRAVITY = np.array([0.0, 0.0, 9.805])


def circle_gt(t, radius=5.0, omega=0.5, height=2.0):
    """Ground-truth kinematics on a circle, body x along the tangent."""
    c, s = np.cos(omega * t), np.sin(omega * t)
    p = np.array([radius * c, radius * s, height])
    v = np.array([-radius * omega * s, radius * omega * c, 0.0])
    a = np.array([-radius * omega**2 * c, -radius * omega**2 * s, 0.0])
    yaw = omega * t + np.pi / 2
    q = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
    return p, v, a, q
