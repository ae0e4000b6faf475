"""Trajectory evaluation: ATE / RPE with alignment, trajectory CSVs.

Counterpart of ``d2slam_tpu/utils/evaluation.py`` (the reference's
evaluation notebooks, data_analysis/local_plot.py:217-280: relative and
absolute RMSE against ground truth, as library functions). Host numpy,
but for ``retrieval_pr_aliasing``, which runs NetVLAD on a device.
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


def retrieval_pr_aliasing(
    nv_params,
    n_places: int = 20,
    n_alias: int = 12,
    seed: int = 3,
    hw=(120, 160),
    thresholds=None,
    device=None,
):
    """Precision/recall of NetVLAD place retrieval under perceptual
    aliasing (the reference's retrieval gates,
    d2frontend/src/loop_detector.cpp:254-330).

    The database holds ``n_places`` distinct synthetic scenes. Queries
    are (a) revisits of each database place (viewpoint + photometric
    change) and (b) revisits of ``n_alias`` held-out scenes from the
    same generator, which are not in the map: one of those retrieved
    above threshold is a false positive, the failure that injects false
    loops into PGO. ``nv_params`` is a NetVLAD parameter dict
    (``frontend.netvlad.load_params``); the network and the warps run on
    ``device`` (default ``cuda``).

    Returns per-threshold precision/recall arrays and the operating
    point values at the reference's 0.8 gate and at the best F1.
    """
    import torch

    from d2slam_tpu_torch.frontend.netvlad import NetVLAD
    from d2slam_tpu_torch.frontend.train_frontend import (
        make_batch,
        random_homography,
        warp_image,
    )
    from d2slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    H, W = hw
    rng = np.random.default_rng(seed)
    base, _ = make_batch(rng, n_places, H, W)

    def variant(img, strength):
        Hm = random_homography(rng, H, W, max_angle=0.35 * strength,
                               max_trans=0.15 * strength)
        v = warp_image(torch.as_tensor(img, device=dev), Hm.astype(np.float32))
        gain = rng.uniform(1 - 0.3 * strength, 1 + 0.3 * strength)
        return np.clip(v.cpu().numpy() * gain, 0, 1).astype(np.float32)

    held_out, _ = make_batch(rng, n_alias, H, W)
    queries = [variant(base[i], strength=0.5) for i in range(n_places)]
    queries += [variant(held_out[k], strength=0.5) for k in range(n_alias)]
    # query k < n_places should retrieve place k; the rest should stay
    # below threshold (their place is not in the map)
    gt = np.concatenate([np.arange(n_places), -np.ones(n_alias, int)])

    net = NetVLAD(nv_params, device=dev)
    with torch.no_grad():
        db = net(torch.as_tensor(base, device=dev)).cpu().numpy()
        q = net(torch.as_tensor(np.stack(queries), device=dev)).cpu().numpy()
    sims = q @ db.T                       # [n_q, n_places]
    best = np.argmax(sims, axis=1)
    best_sim = sims[np.arange(len(queries)), best]
    correct = best == gt                  # held-out rows always False

    if thresholds is None:
        thresholds = np.linspace(0.5, 0.99, 25)
    prec, rec = [], []
    for th in thresholds:
        fired = best_sim >= th
        tp = int(np.sum(fired & correct))
        prec.append(tp / max(int(fired.sum()), 1))
        rec.append(tp / n_places)
    prec, rec = np.asarray(prec), np.asarray(rec)
    f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-9)
    k = int(np.argmax(f1))
    return {
        "thresholds": np.asarray(thresholds),
        "precision": prec,
        "recall": rec,
        "precision_at_0p8": float(np.interp(0.8, thresholds, prec)),
        "recall_at_0p8": float(np.interp(0.8, thresholds, rec)),
        # self-calibrated operating point (the detector's auto_thres
        # plays the same role at runtime): best-F1 threshold
        "op_threshold": float(thresholds[k]),
        "op_precision": float(prec[k]),
        "op_recall": float(rec[k]),
    }
