"""Ground-truth kinematics shared by the simulators (numpy only)."""
from __future__ import annotations

import numpy as np

from d2slam_tpu_torch.pgo.pose_graph import PGOEdges
from d2slam_tpu_torch.utils import np_lie

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


def spiral_pose_graph(n: int, seed: int = 0, pos_noise: float = 0.0):
    """The spiral pose graph of ``examples/bench_pgo_scale.py::big_graph``
    (numpy only): n poses on a rising spiral of 200-pose period, the
    odometry chain plus a loop closure every 10 poses to the same place
    one revolution later, relative poses exact up to Gaussian translation
    noise of ``pos_noise`` m (drawn from ``seed`` as there),
    sqrt-information 10·I. Returns (gt [n, 7], PGOEdges of numpy arrays)."""
    th = 2 * np.pi * np.arange(n) / 200.0
    gt = np.zeros((n, 7))
    gt[:, 0] = 15 * np.cos(th)
    gt[:, 1] = 15 * np.sin(th)
    gt[:, 2] = 0.02 * np.arange(n)
    gt[:, 5] = np.sin(th / 2)
    gt[:, 6] = np.cos(th / 2)
    ii = np.array(list(range(n - 1)) + list(range(0, n - 200, 10)), np.int32)
    jj = np.array([k + 1 for k in range(n - 1)] + [k + 200 for k in range(0, n - 200, 10)],
                  np.int32)
    rel = np.stack([np_lie.pose_compose(np_lie.pose_inverse(gt[i]), gt[j])
                    for i, j in zip(ii, jj)])
    E = len(ii)
    if pos_noise:
        rel[:, :3] += np.random.default_rng(seed).normal(0, pos_noise, (E, 3))
    return gt, PGOEdges(i=ii, j=jj, rel=rel.astype(np.float32),
                        sqrt_info=np.tile(np.eye(6, dtype=np.float32) * 10.0, (E, 1, 1)),
                        valid=np.ones(E, bool))
