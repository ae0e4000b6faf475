"""Tiny synthetic image renderer for frontend integration tests.

Projects a world point cloud into pinhole cameras and splats Gaussian
blobs, giving the image pipeline (SuperPoint/LK/tracker) real pixels
with exact ground truth — the dataset-free stand-in for the
reference's rosbag-driven validation.
"""
from __future__ import annotations

import numpy as np

from d2slam_tpu_torch.utils import np_lie


def render_blobs(
    pts_w: np.ndarray,          # [N, 3]
    T_w_cam: np.ndarray,        # [7]
    fx: float, fy: float, cx: float, cy: float,
    H: int, W: int,
    sigma: float = 1.5,
    intensities: np.ndarray | None = None,
) -> np.ndarray:
    """Returns [H, W] float image in [0, 1]."""
    R = np_lie.quat_to_rotmat(T_w_cam[3:])
    pc = (pts_w - T_w_cam[:3]) @ R
    vis = pc[:, 2] > 0.5
    u = fx * pc[vis, 0] / pc[vis, 2] + cx
    v = fy * pc[vis, 1] / pc[vis, 2] + cy
    if intensities is None:
        inten = np.ones(vis.sum())
    else:
        inten = intensities[vis]
    img = np.zeros((H, W), np.float64)
    r = int(np.ceil(3 * sigma))
    for ui, vi, ii in zip(u, v, inten):
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
        img[y0 - r : y0 + r + 1, x0 - r : x0 + r + 1] += ii * 0.5 * (sx * sy + 1.0) * env
    return np.clip(img, 0.0, 1.0)
