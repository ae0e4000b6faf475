"""Tiny synthetic image renderer for frontend integration tests.

Projects a world point cloud into pinhole cameras and splats Gaussian
blobs, giving the image pipeline (SuperPoint/LK/tracker) real pixels
with exact ground truth — the dataset-free stand-in for the
reference's rosbag-driven validation.
"""
from __future__ import annotations

import numpy as np
import torch

from d2slam_tpu_torch.geometry.cameras import KBParams, kb_lift
from d2slam_tpu_torch.utils import np_lie


def render_blobs(
    pts_w: np.ndarray,          # [N, 3]
    T_w_cam: np.ndarray,        # [7]
    fx: float, fy: float, cx: float, cy: float,
    H: int, W: int,
    sigma: float = 1.5,
    intensities: np.ndarray | None = None,
    signatures: np.ndarray | None = None,
) -> np.ndarray:
    """Returns [H, W] float image in [0, 1].

    signatures: optional [N, 6] per-landmark appearance coefficients
    (3 amplitudes, 3 phases) painting an angular-harmonic ring AROUND
    each corner. Without them every landmark renders the same
    checkerboard corner, and matching by appearance alone is degenerate
    (the ratio test rejects every match); cross-view association needs
    distinctive features, so pass ``make_signatures(n, seed)``.
    """
    R = np_lie.quat_to_rotmat(T_w_cam[3:])
    pc = (pts_w - T_w_cam[:3]) @ R
    vis = pc[:, 2] > 0.5
    u = fx * pc[vis, 0] / pc[vis, 2] + cx
    v = fy * pc[vis, 1] / pc[vis, 2] + cy
    if intensities is None:
        inten = np.ones(vis.sum())
    else:
        inten = intensities[vis]
    sigs = signatures[vis] if signatures is not None else None
    img = np.zeros((H, W), np.float64)
    r = int(np.ceil((5 if sigs is not None else 3) * sigma))
    for k, (ui, vi, ii) in enumerate(zip(u, v, inten)):
        x0, y0 = int(round(ui)), int(round(vi))
        if not (r <= x0 < W - r and r <= y0 < H - r):
            continue
        ys, xs = np.mgrid[y0 - r : y0 + r + 1, x0 - r : x0 + r + 1]
        # checkerboard saddle centered EXACTLY at the subpixel
        # projection: sign(dx)*sign(dy) smoothed — a true corner that
        # detectors/LK localize consistently across viewpoints (plain
        # Gaussian blobs give viewpoint-dependent peak bias)
        dxs = (xs - ui) / sigma
        dys = (ys - vi) / sigma
        sx = np.tanh(2.0 * dxs)
        sy = np.tanh(2.0 * dys)
        env = np.exp(-(dxs**2 + dys**2) / 4.0)
        patch = ii * 0.5 * (sx * sy + 1.0) * env
        if sigs is not None:
            # unique angular ring at ~3 sigma: the center corner stays
            # clean (localization), the surround disambiguates identity
            rr = np.sqrt(dxs**2 + dys**2)
            phi = np.arctan2(dys, dxs)
            ring = 0.5 + (
                sigs[k, 0] * np.cos(2 * phi + sigs[k, 3])
                + sigs[k, 1] * np.cos(3 * phi + sigs[k, 4])
                + sigs[k, 2] * np.cos(4 * phi + sigs[k, 5])
            ) / max(np.abs(sigs[k, :3]).sum(), 1e-6) * 0.5
            ring_env = np.exp(-((rr - 3.0) ** 2) / 2.0)
            patch = patch + ii * 0.9 * ring * ring_env
        img[y0 - r : y0 + r + 1, x0 - r : x0 + r + 1] += patch
    return np.clip(img, 0.0, 1.0)


def make_signatures(n: int, seed: int = 0) -> np.ndarray:
    """Per-landmark appearance coefficients for ``render_blobs``."""
    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.3, 1.0, (n, 3)) * rng.choice([-1, 1], (n, 3))
    phases = rng.uniform(0, 2 * np.pi, (n, 3))
    return np.concatenate([amps, phases], axis=1)


def render_cylinder_wall(fisheye: KBParams, T_body_cam: np.ndarray, hw,
                         r_wall: float = 5.0, seed: int = 0,
                         return_points: bool = False):
    """[Hf, Wf] float32 view of a textured cylinder wall (axis along the
    body y axis, radius ``r_wall`` around the body center) through a
    Kannala-Brandt fisheye at body pose ``T_body_cam`` [7], by ray
    casting. The texture is a smoothed random 64x512 map drawn from
    ``seed``. With ``return_points`` also the [Hf, Wf, 3] hit points in
    the body frame (exact depth ground truth)."""
    from numpy.lib.stride_tricks import sliding_window_view

    Hf, Wf = hw
    tex = np.random.default_rng(seed).uniform(0, 1, (64, 512))
    tex = (sliding_window_view(np.pad(tex, 2, mode="wrap"), (5, 5)) / 25).sum(axis=(2, 3))
    ys, xs = np.meshgrid(np.arange(Hf), np.arange(Wf), indexing="ij")
    uv = torch.as_tensor(np.stack([xs, ys], -1).reshape(-1, 2), dtype=torch.float32)
    rays_b = kb_lift(uv, fisheye).numpy() @ np_lie.quat_to_rotmat(T_body_cam[3:]).T
    c = T_body_cam[:3]
    # intersect x^2 + z^2 = r_wall^2
    dx, dz = rays_b[:, 0], rays_b[:, 2]
    a = dx * dx + dz * dz
    b = 2 * (c[0] * dx + c[2] * dz)
    cc = c[0] ** 2 + c[2] ** 2 - r_wall ** 2
    t = (-b + np.sqrt(np.maximum(b * b - 4 * a * cc, 0.0))) / np.maximum(2 * a, 1e-9)
    pts = c + rays_b * t[:, None]
    theta = np.arctan2(pts[:, 0], pts[:, 2])
    ui = ((theta + np.pi) / (2 * np.pi) * 512).astype(int) % 512
    vi = np.clip(((pts[:, 1] + 2.0) / 4.0 * 64).astype(int), 0, 63)
    img = tex[vi, ui].reshape(Hf, Wf).astype(np.float32)
    return (img, pts.reshape(Hf, Wf, 3)) if return_points else img


def cylinder_wall_disparity(focal: float, baseline: float, T_body_cam: np.ndarray,
                            hw, r_wall: float = 5.0, yaw_deg: float = 45.0) -> np.ndarray:
    """Analytic [H, W] disparity of the cylinder wall of
    ``render_cylinder_wall`` in a virtual pinhole view (focal ``focal``,
    principal point at the centre) that is the camera at ``T_body_cam``
    yawed by ``yaw_deg`` about its y axis, for a rectified partner
    ``baseline`` away: focal * baseline / depth along the optical axis."""
    H, W = hw
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays_v = np.stack([(xs - W / 2.0) / focal, (ys - H / 2.0) / focal,
                       np.ones_like(xs, np.float64)], axis=-1)
    a = np.deg2rad(yaw_deg)
    R = np_lie.quat_to_rotmat(T_body_cam[3:]) @ np_lie.quat_to_rotmat(
        np.array([0, np.sin(a / 2), 0, np.cos(a / 2)]))
    rays_b = rays_v @ R.T
    c = T_body_cam[:3]
    dx, dz = rays_b[..., 0], rays_b[..., 2]
    qa = dx * dx + dz * dz
    qb = 2 * (c[0] * dx + c[2] * dz)
    qc = c[0] ** 2 + c[2] ** 2 - r_wall ** 2
    t = (-qb + np.sqrt(np.maximum(qb * qb - 4 * qa * qc, 0.0))) / np.maximum(2 * qa, 1e-9)
    return focal * baseline / np.maximum(t * rays_v[..., 2], 1e-6)
