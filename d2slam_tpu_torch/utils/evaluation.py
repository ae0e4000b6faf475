"""Trajectory evaluation: ATE / RPE with alignment, trajectory CSVs.

Counterpart of ``d2slam_tpu/utils/evaluation.py`` (the reference's
evaluation notebooks, data_analysis/local_plot.py:217-280: relative and
absolute RMSE against ground truth, as library functions). Host numpy.
``retrieval_pr_aliasing`` waits for the port of the frontend trainer
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from d2slam_tpu_torch.utils import np_lie


def associate(t_est, t_gt, max_dt=0.02):
    """Match estimate timestamps to ground-truth timestamps."""
    idx_gt = np.searchsorted(t_gt, t_est)
    idx_gt = np.clip(idx_gt, 0, len(t_gt) - 1)
    left = np.clip(idx_gt - 1, 0, len(t_gt) - 1)
    use_left = np.abs(t_gt[left] - t_est) < np.abs(t_gt[idx_gt] - t_est)
    idx = np.where(use_left, left, idx_gt)
    ok = np.abs(t_gt[idx] - t_est) <= max_dt
    return idx, ok


def align_umeyama_4dof(p_est, p_gt, q_est, q_gt):
    """4-DoF (yaw + translation) alignment of the estimate to GT —
    appropriate for VIO where roll/pitch are observable."""
    yaw_err = []
    for qe, qg in zip(q_est, q_gt):
        dq = np_lie.quat_mul(qg, np_lie.quat_conj(qe))
        yaw_err.append(np.arctan2(
            2 * (dq[3] * dq[2] + dq[0] * dq[1]),
            1 - 2 * (dq[1] ** 2 + dq[2] ** 2),
        ))
    # circular mean of yaw error
    yaw = np.arctan2(np.mean(np.sin(yaw_err)), np.mean(np.cos(yaw_err)))
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    t = p_gt.mean(axis=0) - (R @ p_est.T).T.mean(axis=0)
    return R, t


def ate_rmse(
    t_est, poses_est, t_gt, poses_gt, align_4dof=True
) -> Tuple[float, np.ndarray]:
    """Absolute trajectory error RMSE (meters) after alignment.

    poses_*: [N, 7] (p, q_xyzw). Returns (rmse, per-pose errors)."""
    idx, ok = associate(np.asarray(t_est), np.asarray(t_gt))
    pe = np.asarray(poses_est)[ok, :3]
    qe = np.asarray(poses_est)[ok, 3:]
    pg = np.asarray(poses_gt)[idx[ok], :3]
    qg = np.asarray(poses_gt)[idx[ok], 3:]
    if len(pe) == 0:
        return np.inf, np.zeros(0)
    if align_4dof:
        R, t = align_umeyama_4dof(pe, pg, qe, qg)
        pe = (R @ pe.T).T + t
    err = np.linalg.norm(pe - pg, axis=1)
    return float(np.sqrt(np.mean(err**2))), err


def rpe_rmse(
    t_est, poses_est, t_gt, poses_gt, delta: int = 10
) -> float:
    """Relative pose error RMSE over a fixed frame delta."""
    idx, ok = associate(np.asarray(t_est), np.asarray(t_gt))
    pe = np.asarray(poses_est)[ok]
    pg = np.asarray(poses_gt)[idx[ok]]
    errs = []
    for i in range(len(pe) - delta):
        rel_e = np_lie.pose_compose(
            np_lie.pose_inverse(pe[i]), pe[i + delta]
        )
        rel_g = np_lie.pose_compose(
            np_lie.pose_inverse(pg[i]), pg[i + delta]
        )
        errs.append(np.linalg.norm(rel_e[:3] - rel_g[:3]))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else np.inf


def write_trajectory_csv(path: str, stamps, poses) -> None:
    """TUM-format trajectory dump (reference CSV outputs,
    d2pgo_node.cpp:68-80 / D2Visualization paths)."""
    with open(path, "w") as f:
        f.write("#timestamp x y z qx qy qz qw\n")
        for t, p in zip(stamps, poses):
            f.write(f"{t:.6f} " + " ".join(f"{v:.6f}" for v in p) + "\n")


def read_trajectory_csv(path: str):
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            stamps.append(vals[0])
            poses.append(vals[1:8])
    return np.asarray(stamps), np.asarray(poses)
