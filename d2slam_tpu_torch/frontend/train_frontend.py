"""Synthetic scenes for the learned frontend, matcher evaluation and
weight files.

Counterpart of the scene generators of
``d2slam_tpu/frontend/train_frontend.py`` (MagicPoint-style synthetic
shapes, arXiv:1712.07629): ``synth_corners_image``, ``cell_labels``,
``make_batch``, ``random_homography`` and ``warp_image``, under the
same names; of its matcher evaluation (``_gt_assignment``,
``eval_matcher_pr``) and of ``load_weights``. Data generation is host
numpy, with the shapes drawn by Pillow as the JAX package draws them
(imported where it is used, so the rest of the port never needs it);
the warp and the evaluation run on the image's device. The training
half of that module is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from d2slam_tpu_torch.frontend.superpoint import SuperPoint, superpoint_extract


# ---------------------------------------------------------------------------
# synthetic geometry with exact corner ground truth
# ---------------------------------------------------------------------------


def synth_corners_image(rng: np.random.Generator, H: int, W: int):
    """One synthetic image [H, W] float in [0,1] + corner list [N, 2]
    (x, y). Shapes: random convex quads, triangles, line junctions,
    checkerboard patches — the MagicPoint synthetic-shapes recipe."""
    from PIL import Image, ImageDraw, ImageFilter

    img = Image.new("L", (W, H), int(rng.uniform(25, 128)))
    dr = ImageDraw.Draw(img)
    corners = []

    def poly(n_pts, min_r=8, max_r=40):
        cx, cy = rng.uniform(10, W - 10), rng.uniform(10, H - 10)
        angs = np.sort(rng.uniform(0, 2 * np.pi, n_pts))
        rad = rng.uniform(min_r, max_r, n_pts)
        pts = np.stack([cx + rad * np.cos(angs), cy + rad * np.sin(angs)],
                       axis=1)
        return pts

    for _ in range(rng.integers(3, 7)):
        kind = rng.integers(0, 4)
        shade = int(rng.uniform(0, 255))
        if kind == 0:      # filled convex polygon
            pts = poly(int(rng.integers(3, 7)))
            dr.polygon([tuple(p) for p in pts], fill=shade)
            corners.extend(pts)
        elif kind == 1:    # line segment (endpoints are corners)
            p = rng.uniform([0, 0], [W, H], (2, 2))
            dr.line([tuple(p[0]), tuple(p[1])], fill=shade,
                    width=int(rng.integers(1, 4)))
            corners.extend(p)
        elif kind == 2:    # rectangle (axis-aligned, 4 corners)
            x0, y0 = rng.uniform(5, W - 30), rng.uniform(5, H - 30)
            w, h = rng.uniform(10, 50), rng.uniform(10, 50)
            x1, y1 = min(x0 + w, W - 2), min(y0 + h, H - 2)
            dr.rectangle([x0, y0, x1, y1], fill=shade)
            corners.extend([[x0, y0], [x1, y0], [x0, y1], [x1, y1]])
        else:              # checkerboard patch
            x0, y0 = rng.uniform(5, W - 50), rng.uniform(5, H - 50)
            cell = rng.uniform(8, 16)
            nx, ny = rng.integers(2, 4), rng.integers(2, 4)
            for i in range(nx):
                for j in range(ny):
                    if (i + j) % 2 == 0:
                        dr.rectangle(
                            [x0 + i * cell, y0 + j * cell,
                             x0 + (i + 1) * cell, y0 + (j + 1) * cell],
                            fill=shade,
                        )
            for i in range(nx + 1):
                for j in range(ny + 1):
                    corners.append([x0 + i * cell, y0 + j * cell])

    if rng.uniform() < 0.7:
        img = img.filter(ImageFilter.GaussianBlur(rng.uniform(0.3, 1.2)))
    a = np.asarray(img, np.float32) / 255.0
    # checkerboard-saddle splats at EXACT subpixel positions — the
    # corner appearance of utils/render.py's render_blobs (what the
    # synthetic SLAM benchmarks feed the detector); PIL shapes alone
    # left the net with a systematic ~2 px localization bias on them
    if rng.uniform() < 0.6:
        for _ in range(rng.integers(4, 12)):
            x, y = rng.uniform(7, W - 8), rng.uniform(7, H - 8)
            sig = rng.uniform(1.0, 2.2)
            amp = rng.uniform(0.4, 1.0)
            r = int(np.ceil(3 * sig))
            x0, y0 = int(round(x)), int(round(y))
            ys2, xs2 = np.mgrid[y0 - r:y0 + r + 1, x0 - r:x0 + r + 1]
            dxs = (xs2 - x) / sig
            dys = (ys2 - y) / sig
            env = np.exp(-(dxs ** 2 + dys ** 2) / 4.0)
            a[y0 - r:y0 + r + 1, x0 - r:x0 + r + 1] += (
                amp * 0.5 * (np.tanh(2 * dxs) * np.tanh(2 * dys) + 1.0)
                * env
            )
            corners.append([x, y])
    a = a + rng.normal(0, rng.uniform(0.01, 0.05), a.shape)
    a = np.clip(a, 0.0, 1.0)
    c = np.asarray(corners, np.float64).reshape(-1, 2)
    keep = (c[:, 0] > 2) & (c[:, 0] < W - 3) & (c[:, 1] > 2) & (c[:, 1] < H - 3)
    return a.astype(np.float32), c[keep]


def cell_labels(corners: np.ndarray, H: int, W: int) -> np.ndarray:
    """[Hc, Wc] int32 65-way labels: position (0..63) of a corner
    inside its 8x8 cell, 64 (dustbin) for empty cells. Multiple
    corners per cell: last one wins (as in the original training)."""
    Hc, Wc = H // 8, W // 8
    lab = np.full((Hc, Wc), 64, np.int32)
    for (x, y) in corners:
        cx, cy = int(x) // 8, int(y) // 8
        if 0 <= cx < Wc and 0 <= cy < Hc:
            lab[cy, cx] = (int(y) % 8) * 8 + (int(x) % 8)
    return lab


def make_batch(rng: np.random.Generator, B: int, H: int, W: int):
    imgs = np.zeros((B, H, W), np.float32)
    labs = np.zeros((B, H // 8, W // 8), np.int32)
    for b in range(B):
        img, c = synth_corners_image(rng, H, W)
        imgs[b] = img
        labs[b] = cell_labels(c, H, W)
    return imgs, labs


def random_homography(rng: np.random.Generator, H: int, W: int,
                      max_angle=0.5, max_scale=0.25, max_trans=0.1,
                      max_persp=3e-4) -> np.ndarray:
    """Random in-plane rotation + scale + translation + perspective,
    mapping DESTINATION pixel coords to SOURCE pixel coords."""
    a = rng.uniform(-max_angle, max_angle)
    s = np.exp(rng.uniform(-max_scale, max_scale))
    tx = rng.uniform(-max_trans, max_trans) * W
    ty = rng.uniform(-max_trans, max_trans) * H
    c, sn = np.cos(a), np.sin(a)
    cx, cy = W / 2.0, H / 2.0
    A = np.array([[s * c, -s * sn, 0], [s * sn, s * c, 0], [0, 0, 1.0]])
    P = np.eye(3)
    P[2, 0] = rng.uniform(-max_persp, max_persp)
    P[2, 1] = rng.uniform(-max_persp, max_persp)
    T0 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    T1 = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1.0]])
    return T1 @ P @ A @ T0


# ---------------------------------------------------------------------------
# homographies + device warping
# ---------------------------------------------------------------------------


def warp_image(img: torch.Tensor, Hmat) -> torch.Tensor:
    """Bilinear warp on ``img``'s device: out[y, x] = img(Hmat [x, y, 1])
    with ``Hmat`` mapping DESTINATION pixels to SOURCE pixels (as
    ``random_homography`` returns it). Out-of-range samples are 0.
    img [H, W] float32."""
    Himg, Wimg = img.shape
    dev = img.device
    Hmat = torch.as_tensor(Hmat, dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(torch.arange(Himg, dtype=torch.float32, device=dev),
                            torch.arange(Wimg, dtype=torch.float32, device=dev),
                            indexing="ij")
    src = torch.einsum("ij,jhw->ihw", Hmat, torch.stack([xs, ys, torch.ones_like(xs)]))
    den = torch.clamp_min(torch.abs(src[2]), 1e-9)
    sx = src[0] / den * torch.sign(src[2])
    sy = src[1] / den * torch.sign(src[2])
    inb = (sx >= 0) & (sx <= Wimg - 1.001) & (sy >= 0) & (sy <= Himg - 1.001)
    sx = torch.clamp(sx, 0.0, Wimg - 1.001)
    sy = torch.clamp(sy, 0.0, Himg - 1.001)
    x0 = torch.floor(sx).long()
    y0 = torch.floor(sy).long()
    wx = sx - x0
    wy = sy - y0
    v = (img[y0, x0] * (1 - wx) * (1 - wy)
         + img[y0, x0 + 1] * wx * (1 - wy)
         + img[y0 + 1, x0] * (1 - wx) * wy
         + img[y0 + 1, x0 + 1] * wx * wy)
    return torch.where(inb, v, torch.zeros_like(v))


# ---------------------------------------------------------------------------
# matcher evaluation on homography pairs
# ---------------------------------------------------------------------------


def _gt_assignment(kptsA, validA, kptsB, validB, Hinv, px_thresh=3.0):
    """Ground-truth A -> B match index from the homography (``Hinv`` maps
    A pixels to B pixels). Returns (gt [N] int64: an index into B, or M
    for the dustbin; matched [N] bool)."""
    N, M = kptsA.shape[0], kptsB.shape[0]
    ph = torch.cat([kptsA, torch.ones((N, 1), dtype=kptsA.dtype, device=kptsA.device)], dim=1)
    dst = ph @ Hinv.T
    pB = dst[:, :2] / torch.clamp_min(dst[:, 2:3], 1e-9)
    d2 = torch.sum((pB[:, None, :] - kptsB[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(validB[None, :], d2, torch.full_like(d2, 1e12))
    dmin, j = torch.min(d2, dim=1)
    matched = validA & (dmin < px_thresh ** 2)
    return torch.where(matched, j, torch.full_like(j, M)), matched


def eval_matcher_pr(match_fn, model: SuperPoint, hw, n_pairs=20, seed=123, px_thresh=3.0):
    """Precision and recall of a matcher on held-out homography pairs
    (the JAX package's ``eval_matcher_pr``, with the port's SuperPoint
    ``model`` for the JAX package's ``sp_params, sp_cfg``).

    match_fn(a, b) -> (idx [N], ok [N]), with a and b one image's
    ``SuperPointOutput`` each. Returns (precision, recall, n_correct,
    n_pred, n_gt)."""
    H, W = hw
    rng = np.random.default_rng(seed)
    dev = model.device
    tp = pred = gt_n = 0
    for _ in range(n_pairs):
        imgs, _ = make_batch(rng, 1, H, W)
        Hm = random_homography(rng, H, W).astype(np.float32)
        img = torch.as_tensor(imgs[0], device=dev)
        warped = warp_image(img, Hm)
        out = superpoint_extract(model, torch.stack([img, warped]))
        a, b = (type(out)(*(f[i] for f in out)) for i in (0, 1))
        gt, matched = _gt_assignment(
            a.kpts, a.valid, b.kpts, b.valid,
            torch.linalg.inv(torch.as_tensor(Hm, device=dev)), px_thresh)
        idx, ok = match_fn(a, b)
        idx = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx)
        ok = np.asarray(ok.cpu() if torch.is_tensor(ok) else ok) & a.valid.cpu().numpy()
        gt, matched = gt.cpu().numpy(), matched.cpu().numpy()
        tp += int(np.sum(ok & matched & (idx == gt)))
        pred += int(np.sum(ok))
        gt_n += int(np.sum(matched))
    return tp / max(pred, 1), tp / max(gt_n, 1), tp, pred, gt_n


# ---------------------------------------------------------------------------
# weight files
# ---------------------------------------------------------------------------


def load_weights(path: str) -> Dict:
    """An ``.npz`` written by the JAX package's ``save_weights`` (keys such
    as ``cross0/k/w``) as a nested dict of numpy arrays."""
    raw = np.load(path)
    out: Dict = {}
    for name in raw.files:
        parts = name.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = np.asarray(raw[name])
    return out
