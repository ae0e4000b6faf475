"""Visual-inertial SFM initialization for dynamic (non-static) starts.

Counterpart of ``d2slam_tpu/vins/sfm_init.py``; host numpy in float64,
as there.

The estimator path of the reference's VINS-Mono-style initialization
(reference: d2vins/src/estimator/d2vinsstate.cpp:763-1040 solveGyroscope
Bias + LinearAlignment on an SFM of the pending window): given a buffer
of pre-init frames with tracked observations and the raw IMU stream,

  1. pick the first/last frames with enough common parallax and solve
     the up-to-scale relative pose (essential RANSAC);
  2. triangulate the common landmarks; PnP every intermediate frame
     against them -> up-to-scale visual poses;
  3. solve the gyroscope bias from visual relative rotations vs
     preintegrated rotations (linear LS);
  4. linear alignment -> per-frame velocities, gravity in the visual
     frame, metric scale;
  5. rotate the visual frame onto gravity, apply the scale, and emit
     metric window states.

All steps reuse the port's building blocks (vins/initialization.py,
frontend/pnp.py, imu/preintegration.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from d2slam_tpu_torch.frontend.pnp import ransac_pnp
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.vins.initialization import solve_gyroscope_bias, solve_relative_pose


def _common_tracks(obs_a: Dict[int, np.ndarray], obs_b: Dict[int, np.ndarray]):
    ids = sorted(set(obs_a) & set(obs_b))
    ra = np.stack([obs_a[i] for i in ids]) if ids else np.zeros((0, 3))
    rb = np.stack([obs_b[i] for i in ids]) if ids else np.zeros((0, 3))
    return ids, ra, rb


def _triangulate_two_view(r1, r2, R12, t12):
    """Triangulate in frame 1: x2_dir ~ R12 x1_dir scale relation;
    point = d1 * r1 with [r1_rot | -r2] lstsq (frame-2 convention
    x2 = R12 x1 + t12)."""
    pts = np.zeros((len(r1), 3))
    good = np.zeros(len(r1), bool)
    for k in range(len(r1)):
        A = np.stack([R12 @ r1[k], -r2[k]], axis=1)
        sol, res, *_ = np.linalg.lstsq(A, -t12, rcond=None)
        d1, d2 = sol
        if d1 > 0.05 and d2 > 0.05:
            pts[k] = d1 * r1[k]
            good[k] = True
    return pts, good


def sfm_initialize(
    frame_obs: List[Dict[int, np.ndarray]],  # per frame: lm_id -> unit ray (cam0)
    cam0_ext: np.ndarray,                    # [7] body_T_cam0
    pre_list,                                # K PreintegrationResults (between frames)
    g_norm: float = 9.805,
    min_common: int = 20,
    min_parallax: float = 0.015,             # mean ray angle (rad)
) -> Optional[dict]:
    """Returns dict(poses [S,7] body poses in a gravity-aligned metric
    world anchored at frame 0, vels [S,3] world velocities, bg [3]) or
    None if initialization is not yet possible."""
    S = len(frame_obs)
    if S < 3:
        return None
    ids, r0, rN = _common_tracks(frame_obs[0], frame_obs[-1])
    if len(ids) < min_common:
        return None
    parallax = np.mean(np.linalg.norm(r0 - rN, axis=1))
    if parallax < min_parallax:
        return None

    # --- 1. relative pose first->last (camera frames) ---
    R_0N, t_0N, inl = solve_relative_pose(r0, rN, thresh=2e-3)
    if R_0N is None or inl.sum() < min_common:
        return None

    # --- 2. triangulate + PnP intermediate frames (visual frame =
    # camera-0-at-frame-0, translation scale |t_0N| = 1) ---
    pts0, good = _triangulate_two_view(r0[inl], rN[inl], R_0N, t_0N)
    ids_inl = [i for i, m in zip(np.asarray(ids)[inl], good) if m]
    pts_of = {i: p for i, p, m in zip(np.asarray(ids)[inl], pts0, good) if m}
    if len(pts_of) < min_common // 2:
        return None

    cam_poses = []  # world(=cam0 frame0) _T_ cam_k
    for k in range(S):
        if k == 0:
            cam_poses.append(np.array([0, 0, 0, 0, 0, 0, 1.0]))
            continue
        obs = frame_obs[k]
        use = [i for i in pts_of if i in obs]
        if len(use) < 8:
            return None
        rays = np.stack([obs[i] for i in use])
        pts = np.stack([pts_of[i] for i in use])
        T, inl_k = ransac_pnp(rays, pts, thresh=4e-3, min_inliers=8)
        if T is None:
            return None
        cam_poses.append(T)
    cam_poses = np.stack(cam_poses)

    # --- body poses in the visual frame ---
    inv_ext = np_lie.pose_inverse(cam0_ext.astype(np.float64))
    body_poses = np.stack([
        np_lie.pose_compose(T, inv_ext) for T in cam_poses
    ])

    # --- 3. gyro bias ---
    q_rel = [
        np_lie.quat_mul(np_lie.quat_conj(body_poses[k][3:]),
                        body_poses[k + 1][3:])
        for k in range(S - 1)
    ]
    dbg = solve_gyroscope_bias(q_rel, pre_list)

    return dict(
        body_poses_visual=body_poses,
        dbg=dbg,
        landmarks_visual=pts_of,
    )


def align_to_gravity(body_poses_visual, vels_body, g_visual, scale,
                     g_norm=9.805):
    """Rotate the visual frame so gravity points along -z (factor
    convention: G positive up) and apply the metric scale. Returns
    (poses [S,7], world velocities [S,3])."""
    g = np.asarray(g_visual, np.float64)
    g_dir = g / np.linalg.norm(g)
    up = np.array([0.0, 0.0, 1.0])
    v = np.cross(g_dir, up)
    s = np.linalg.norm(v)
    c = float(g_dir @ up)
    if s < 1e-9:
        R_w_vis = np.eye(3) if c > 0 else -np.eye(3)
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R_w_vis = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
    q_w_vis = np_lie.rotmat_to_quat(R_w_vis)

    S = len(body_poses_visual)
    poses = np.zeros((S, 7))
    vels = np.zeros((S, 3))
    p0 = None
    for k in range(S):
        bp = body_poses_visual[k].astype(np.float64)
        p = scale * (R_w_vis @ bp[:3])
        q = np_lie.quat_mul(q_w_vis, bp[3:])
        if p0 is None:
            p0 = p.copy()
        poses[k, :3] = p - p0
        poses[k, 3:] = q / np.linalg.norm(q)
        # velocities come in body frames from linear_alignment
        R_b = np_lie.quat_to_rotmat(poses[k, 3:])
        vels[k] = R_b @ vels_body[k]
    return poses, vels
