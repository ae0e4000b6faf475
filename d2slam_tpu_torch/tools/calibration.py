"""Camera calibration tools.

Counterpart of ``d2slam_tpu/tools/calibration.py`` (reference
quadcam_tools/ — stereo_calib.py fisheye calibration, photometric /
vignette calibration): checkerboard intrinsic calibration as an LM over
(intrinsics, per-view poses) whose residuals and Jacobian
(``torch.func.jacfwd``) are computed on the device in float64, with the
host deciding each step from one read of the new cost; the stereo
extrinsic the same way; and radial vignette fitting by least squares on
the device.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from d2slam_tpu_torch.factors.linearize import _FORWARD_AD
from d2slam_tpu_torch.frontend.pnp import ransac_pnp
from d2slam_tpu_torch.geometry.cameras import KBParams, PinholeParams, kb_project, pinhole_project
from d2slam_tpu_torch.geometry.lie import pose_boxplus, quat_rotate
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device


def _init_poses(board_pts, img_pts_list, f_guess, cx, cy):
    """Rough per-view pose init: planar homography-free PnP via our DLT
    on normalized points (board z=0, points well-spread), on the host."""
    poses = []
    for img_pts in img_pts_list:
        rays = np.concatenate(
            [(img_pts - [cx, cy]) / f_guess, np.ones((len(img_pts), 1))], axis=1)
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        T, _ = ransac_pnp(rays, board_pts, thresh=0.05, iters=50, min_inliers=6)
        if T is None:
            T = np.array([0, 0, -0.5, 0, 0, 0, 1.0])   # board 0.5 m in front
        poses.append(np_lie.pose_inverse(T))  # cam_T_world
    return np.stack(poses)


def _lm_calibrate(residual_fn, x0, n_iters=30, lam0=1e-3):
    """Small dense LM on a flat parameter vector: residual, Jacobian,
    normal equations and the step on the device; one host read per
    iteration (the trial cost and the solve's status) decides the step.
    torch's forward-mode AD levels are process-wide, so ``jacfwd`` holds
    the lock ``factors/linearize.py`` holds around its own."""
    jac = jacfwd(residual_fn)
    x = x0
    lam = lam0
    cost = float(torch.sum(residual_fn(x) ** 2))
    for _ in range(n_iters):
        r = residual_fn(x)
        with _FORWARD_AD:
            J = jac(x)
        H = J.T @ J
        g = J.T @ r
        Hd = H + lam * torch.diag(torch.clamp_min(torch.diagonal(H), 1e-9))
        dx, info = torch.linalg.solve_ex(Hd, -g)
        x_new = x + dx
        c_new, ok = torch.stack([torch.sum(residual_fn(x_new) ** 2),
                                 (info == 0).to(x.dtype)]).cpu().tolist()
        if not ok:
            lam *= 10
            continue
        if c_new < cost:
            x, cost, lam = x_new, c_new, lam * 0.5
        else:
            lam *= 4
    return x, cost


def _board_residual(project, params, board, poses, obs):
    """Reprojection residuals of every view: poses [V, 7] cam_T_world,
    board [K, 3], obs [V, K, 2] -> [V * K * 2] (0 where not valid)."""
    pc = quat_rotate(poses[:, None, 3:], board[None]) + poses[:, None, :3]
    uv, valid = project(pc, params)
    return ((uv - obs) * valid[..., None]).reshape(-1)


def _calibrate_intrinsics(project, make, board_pts, img_pts_list, f0, cx0, cy0, device):
    dev = resolve_device(device)
    V = len(img_pts_list)
    poses0 = torch.as_tensor(_init_poses(board_pts, img_pts_list, f0, cx0, cy0),
                             dtype=torch.float64).to(dev)
    board = torch.as_tensor(np.asarray(board_pts), dtype=torch.float64).to(dev)
    obs = torch.as_tensor(np.stack(img_pts_list), dtype=torch.float64).to(dev)

    def residual(x):
        params = make(*x[:8].unbind(0))
        poses = pose_boxplus(poses0, x[8:].reshape(V, 6))
        return _board_residual(project, params, board, poses, obs)

    x0 = torch.cat([torch.tensor([f0, f0, cx0, cy0, 0, 0, 0, 0], dtype=torch.float64),
                    torch.zeros(V * 6, dtype=torch.float64)]).to(dev)
    x, cost = _lm_calibrate(residual, x0)
    n = sum(len(p) for p in img_pts_list)
    return make(*[float(v) for v in x[:8].cpu()]), float(np.sqrt(cost / n))


def calibrate_pinhole(
    board_pts: np.ndarray,            # [K, 3] board-frame corners (z=0)
    img_pts_list: List[np.ndarray],   # V x [K, 2] detected pixels
    img_size: Tuple[int, int],
    f_guess: float | None = None,
    device=None,
) -> Tuple[PinholeParams, float]:
    """Calibrate fx, fy, cx, cy, k1, k2, p1, p2. Returns (params,
    RMS reprojection error in px)."""
    W, H = img_size
    f0 = f_guess or 1.2 * max(W, H) / 2.0
    return _calibrate_intrinsics(pinhole_project, PinholeParams, board_pts, img_pts_list,
                                 f0, W / 2.0, H / 2.0, device)


def calibrate_kb(
    board_pts: np.ndarray,
    img_pts_list: List[np.ndarray],
    img_size: Tuple[int, int],
    f_guess: float | None = None,
    device=None,
) -> Tuple[KBParams, float]:
    """Calibrate a Kannala-Brandt fisheye (fx, fy, cx, cy, k2..k5)."""
    W, H = img_size
    f0 = f_guess or 0.6 * max(W, H) / 2.0
    return _calibrate_intrinsics(kb_project, KBParams, board_pts, img_pts_list,
                                 f0, W / 2.0, H / 2.0, device)


def calibrate_stereo_extrinsic(
    board_pts: np.ndarray,             # [K, 3] board-frame corners (z=0)
    img_pts0_list: List[np.ndarray],   # V x [K, 2] pixels in camera 0
    img_pts1_list: List[np.ndarray],   # V x [K, 2] pixels in camera 1
    project0,                          # pts_cam [..., 3] -> (uv [..., 2], valid [...])
    project1,
    intr0_f: float,
    intr0_c: Tuple[float, float],
    intr1_f: float,
    intr1_c: Tuple[float, float],
    device=None,
) -> Tuple[np.ndarray, float]:
    """Stereo extrinsic calibration: cam1_T_cam0 from joint checkerboard
    views (reference: quadcam_tools/stereo_calib.py, calib_stereos.py —
    cv2.stereoCalibrate over the camera chain). Intrinsics are fixed
    (calibrate per-camera first); the LM jointly refines the relative
    pose and the per-view board poses.

    project0/project1: intrinsic projection closures on torch tensors
    (e.g. ``lambda pc: pinhole_project(pc, params0)``).
    Returns (rel_pose [7] cam1_T_cam0, RMS reprojection error px).
    """
    dev = resolve_device(device)
    V = len(img_pts0_list)
    if len(img_pts1_list) != V:
        raise ValueError("both cameras need the same views")
    poses0 = _init_poses(board_pts, img_pts0_list, intr0_f, *intr0_c)
    poses1 = _init_poses(board_pts, img_pts1_list, intr1_f, *intr1_c)
    # per-view relative estimates cam1_T_cam0 = pose1 o pose0^-1; average
    rels = np.stack([np_lie.pose_compose(poses1[v], np_lie.pose_inverse(poses0[v]))
                     for v in range(V)])
    rel0 = rels[0].copy()
    rel0[:3] = rels[:, :3].mean(0)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64).to(dev)

    board, obs0, obs1 = t(board_pts), t(np.stack(img_pts0_list)), t(np.stack(img_pts1_list))
    poses0_t, rel0_t = t(poses0), t(rel0)

    def residual(x):
        rel = pose_boxplus(rel0_t, x[:6])
        poses = pose_boxplus(poses0_t, x[6:].reshape(V, 6))   # cam0_T_world
        pc0 = quat_rotate(poses[:, None, 3:], board[None]) + poses[:, None, :3]
        uv0, v0 = project0(pc0)
        uv1, v1 = project1(quat_rotate(rel[3:], pc0) + rel[:3])
        return torch.cat([((uv0 - obs0) * v0[..., None]).reshape(V, -1),
                          ((uv1 - obs1) * v1[..., None]).reshape(V, -1)], dim=1).reshape(-1)

    x, cost = _lm_calibrate(residual, torch.zeros(6 + V * 6, dtype=torch.float64, device=dev))
    rel = pose_boxplus(rel0_t, x[:6]).cpu().numpy()
    n = 2 * sum(len(p) for p in img_pts0_list)
    return rel, float(np.sqrt(cost / n))


def calibrate_vignette(mean_image, cx=None, cy=None, degree: int = 3, device=None):
    """Fit a radial attenuation polynomial v(r) = 1 + a1 r^2 + ... from
    a mean flat-field image (reference photometric calibration), by
    least squares on the device in float64. Returns (coeffs [degree]
    numpy, correction image [H, W] on the device)."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(mean_image), dtype=torch.float64).to(dev)
    H, W = img.shape
    cx = W / 2.0 if cx is None else cx
    cy = H / 2.0 if cy is None else cy
    ys = torch.arange(H, dtype=torch.float64, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float64, device=dev)[None, :]
    r2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (max(H, W) / 2.0) ** 2
    center = img[int(cy) - 5:int(cy) + 5, int(cx) - 5:int(cx) + 5].reshape(-1)
    center_val = torch.clamp_min(torch.quantile(center, 0.5), 1e-9)   # np.median
    ratio = img.reshape(-1) / center_val
    A = torch.stack([r2.reshape(-1) ** (k + 1) for k in range(degree)], dim=1)
    coeffs = torch.linalg.lstsq(A, (ratio - 1.0)[:, None]).solution[:, 0]
    vignette = 1.0 + A @ coeffs
    correction = (1.0 / torch.clamp_min(vignette, 0.05)).reshape(H, W)
    return coeffs.cpu().numpy(), correction
