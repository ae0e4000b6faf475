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
the warp and the evaluation run on the image's device.

The training half: the SuperPoint detector cross-entropy and descriptor
hinge over homography pairs, NetVLAD's NT-Xent contrastive training,
its PCA fit and gate calibration, and SuperGlue on frozen SuperPoint
features, each with ``torch.optim.Adam`` (the formula of the JAX
package's ``optax.adam``: eps outside the square root). Parameters are
trained as float32 tensors in the JAX layout; each step builds the
network from them (``SuperPoint`` / ``NetVLAD`` / ``SuperGlue`` keep a
tensor's autograd graph), so gradients reach them, and the result is
the same parameter dict (numpy) that ``save_weights`` writes and both
packages' ``load_weights`` read. SuperPoint trains its float32 trunk:
the bf16 stem kernel has no backward.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from d2slam_tpu_torch.frontend.superpoint import (
    SuperPoint,
    SuperPointConfig,
    random_params,
    superpoint_extract,
    superpoint_raw,
)
from d2slam_tpu_torch.utils.device import cudnn_fp32, resolve_device


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
# trainable parameter trees
# ---------------------------------------------------------------------------


def _trainable(params: Dict, device: torch.device) -> Dict:
    """The JAX-layout tree as float32 leaf tensors on ``device`` that
    require grad."""
    if isinstance(params, dict):
        return {k: _trainable(v, device) for k, v in params.items()}
    t = params.detach() if torch.is_tensor(params) else torch.as_tensor(np.asarray(params, np.float32))
    return t.to(device, torch.float32).clone().requires_grad_(True)


def _leaves(tree: Dict) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _export(tree: Dict) -> Dict:
    """The trained tree as numpy (the JAX layout)."""
    if isinstance(tree, dict):
        return {k: _export(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _record(perf, name: str, t0: float) -> None:
    if perf is not None:
        perf.add(name, (time.perf_counter() - t0) * 1000.0)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def detector_loss(semi: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """65-way cell cross-entropy (dustbin down-weighted so corner cells
    dominate — synthetic scenes are mostly empty). semi [B, Hc, Wc, 65]
    logits, labels [B, Hc, Wc] integer."""
    logp = torch.log_softmax(semi, dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    w = torch.where(labels == 64, 0.2, 1.0).to(semi.dtype)
    return torch.sum(ce * w) / torch.sum(w)


def descriptor_loss(descA, descB, Hmat, img_hw=None, pos_margin=1.0, neg_margin=0.2,
                    lam=250.0):
    """SuperPoint hinge loss: cells whose centers correspond under the
    homography (within 8 px) should match, others not.

    descA/descB: [..., Hc, Wc, D] normalized; Hmat [..., 3, 3] maps B
    pixels -> A pixels (the warp matrix used to produce image B). With
    leading batch dims, the mean over pairs of each pair's loss."""
    Hc, Wc, D = descA.shape[-3:]
    dev, dt = descA.device, descA.dtype
    ys, xs = torch.meshgrid(torch.arange(Hc, dtype=dt, device=dev),
                            torch.arange(Wc, dtype=dt, device=dev), indexing="ij")
    centers = torch.stack([xs * 8 + 3.5, ys * 8 + 3.5, torch.ones_like(xs)])   # B grid
    src = torch.einsum("...ij,jhw->...ihw", Hmat.to(dt), centers)               # -> A pixels
    z = src[..., 2, :, :]
    zabs, zsign = torch.clamp_min(torch.abs(z), 1e-9), torch.sign(z)
    ax = (src[..., 0, :, :] / zabs * zsign).flatten(-2)
    ay = (src[..., 1, :, :] / zabs * zsign).flatten(-2)
    cAx, cAy = (xs * 8 + 3.5).reshape(-1), (ys * 8 + 3.5).reshape(-1)
    d2 = (cAx[:, None] - ax[..., None, :]) ** 2 + (cAy[:, None] - ay[..., None, :]) ** 2
    s = (d2 <= 64.0).to(dt)
    dot = descA.reshape(descA.shape[:-3] + (-1, D)) @ \
        descB.reshape(descB.shape[:-3] + (-1, D)).transpose(-1, -2)
    loss = lam * s * F.relu(pos_margin - dot) + (1.0 - s) * F.relu(dot - neg_margin)
    return torch.mean(loss)


def _warped_labels(labs: np.ndarray, Hms: np.ndarray, H: int, W: int) -> np.ndarray:
    """Cell labels of the warped views: each corner-cell center of view A
    carried into view B by the inverse warp (the JAX trainer's host
    loop)."""
    labs_w = np.zeros_like(labs)
    Hinv = np.linalg.inv(Hms)
    for b in range(len(labs)):
        cy, cx = np.nonzero(labs[b] != 64)
        if not len(cy):
            continue
        sub = labs[b, cy, cx]
        px = cx * 8 + (sub % 8)
        py = cy * 8 + (sub // 8)
        pts = np.stack([px, py, np.ones_like(px)]).astype(np.float64)
        dst = Hinv[b] @ pts      # A pixels -> B pixels
        dx = dst[0] / dst[2]
        dy = dst[1] / dst[2]
        ok = (dx > 2) & (dx < W - 3) & (dy > 2) & (dy < H - 3)
        labs_w[b] = cell_labels(np.stack([dx[ok], dy[ok]], 1), H, W)
    return labs_w


def superpoint_batch(rng: np.random.Generator, batch: int, H: int, W: int):
    """One SuperPoint training batch on the host: images, their cell
    labels, the homographies of the second views and those views'
    labels."""
    imgs, labs = make_batch(rng, batch, H, W)
    Hms = np.stack([random_homography(rng, H, W) for _ in range(batch)])
    return imgs, labs, Hms.astype(np.float32), _warped_labels(labs, Hms, H, W)


def superpoint_loss(params: Dict, imgs, labs, Hmats, labs_w, cfg: SuperPointConfig,
                    desc_weight: float = 1.0):
    """The JAX trainer's step loss on device tensors: detector CE of both
    views + the descriptor hinge. Returns (loss, (det, dsc))."""
    model = SuperPoint(params, cfg, device=imgs.device)
    warped = torch.stack([warp_image(im, h) for im, h in zip(imgs, Hmats)])
    semiA, descA = superpoint_raw(model, imgs[..., None])
    semiB, descB = superpoint_raw(model, warped[..., None])
    det = detector_loss(semiA, labs) + detector_loss(semiB, labs_w)
    dsc = descriptor_loss(descA, descB, Hmats)
    return det + desc_weight * dsc, (det, dsc)


def _adam_step(opt, loss):
    opt.zero_grad(set_to_none=True)
    with cudnn_fp32():   # the backward convolutions in float32 too
        loss.backward()
    opt.step()


# ---------------------------------------------------------------------------
# SuperPoint training
# ---------------------------------------------------------------------------


def train_superpoint(
    steps: int = 2000,
    batch: int = 16,
    hw: Tuple[int, int] = (120, 160),
    lr: float = 1e-3,
    desc_weight: float = 1.0,
    seed: int = 0,
    cfg: SuperPointConfig = SuperPointConfig(),
    log_every: int = 200,
    params: Optional[Dict] = None,
    device=None,
    perf=None,
):
    """Returns (params, losses). Detector CE on synthetic corners +
    descriptor hinge across random homography pairs. ``params`` (the JAX
    layout) defaults to ``random_params(seed)``; training runs the
    float32 trunk. ``perf`` (a ``utils.perf.PerfTracker``) gets the host
    batch time of every step as "batch"."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    H, W = hw
    rng = np.random.default_rng(seed)
    p = _trainable(random_params(seed, cfg) if params is None else params, dev)
    opt = torch.optim.Adam(_leaves(p), lr=lr)
    losses = []
    for it in range(steps):
        t0 = time.perf_counter()
        imgs, labs, Hms, labs_w = superpoint_batch(rng, batch, H, W)
        _record(perf, "batch", t0)
        loss, (det, dsc) = superpoint_loss(
            p, torch.as_tensor(imgs).to(dev), torch.as_tensor(labs).to(dev),
            torch.as_tensor(Hms).to(dev), torch.as_tensor(labs_w).to(dev), cfg, desc_weight)
        _adam_step(opt, loss)
        losses.append(loss.detach())   # fetched once at the end
        if log_every and it % log_every == 0:
            print(f"  sp step {it}: loss {float(loss):.4f} "
                  f"(det {float(det):.4f} desc {float(dsc):.4f})", flush=True)
    return _export(p), torch.stack(losses).cpu().tolist()


# ---------------------------------------------------------------------------
# NetVLAD contrastive training
# ---------------------------------------------------------------------------


def netvlad_batch(rng: np.random.Generator, batch: int, H: int, W: int):
    """One NetVLAD training batch on the host: scenes, two homographies
    and a gain and bias per scene and view."""
    imgs, _ = make_batch(rng, batch, H, W)
    Hs = [np.stack([random_homography(rng, H, W, max_angle=0.4, max_trans=0.15)
                    for _ in range(batch)]).astype(np.float32) for _ in range(2)]
    gains = rng.uniform(0.6, 1.4, (batch, 2, 1, 1)).astype(np.float32)
    biases = rng.uniform(-0.15, 0.15, (batch, 2, 1, 1)).astype(np.float32)
    return imgs, Hs[0], Hs[1], gains, biases


def netvlad_loss(params: Dict, imgs, Ha, Hb, gains, biases, temperature: float = 0.1,
                 pos_margin: float = 0.0, neg_margin: float = 0.0,
                 margin_weight: float = 1.0):
    """NT-Xent over the two views of each scene (positives on the
    diagonal), with the optional absolute score hinges."""
    from d2slam_tpu_torch.frontend.netvlad import NetVLAD

    model = NetVLAD(params, device=imgs.device)
    a = torch.stack([warp_image(im, h) for im, h in zip(imgs, Ha)])
    b = torch.stack([warp_image(im, h) for im, h in zip(imgs, Hb)])
    a = torch.clamp(a * gains[:, 0] + biases[:, 0], 0, 1)
    b = torch.clamp(b * gains[:, 1] + biases[:, 1], 0, 1)
    raw = model(a) @ model(b).T                  # [B, B] cosine
    sim = raw / temperature
    labels = torch.arange(sim.shape[0], device=sim.device)
    loss = 0.5 * (F.cross_entropy(sim, labels) + F.cross_entropy(sim.T, labels))
    if pos_margin > 0.0:
        eye = torch.eye(raw.shape[0], dtype=torch.bool, device=raw.device)
        loss = loss + margin_weight * (
            torch.mean(F.relu(pos_margin - torch.diagonal(raw)))
            + torch.mean(torch.where(eye, torch.zeros_like(raw), F.relu(raw - neg_margin))))
    return loss


def train_netvlad(
    steps: int = 1000,
    batch: int = 16,
    hw: Tuple[int, int] = (120, 160),
    lr: float = 1e-3,
    temperature: float = 0.1,
    seed: int = 1,
    netvlad_cfg=None,
    log_every: int = 100,
    params: Optional[Dict] = None,
    pos_margin: float = 0.0,
    neg_margin: float = 0.0,
    margin_weight: float = 1.0,
    device=None,
    perf=None,
):
    """NT-Xent contrastive training of the compact NetVLAD: two random
    homography + photometric views of each scene are positives.

    ``pos_margin``/``neg_margin`` (when > 0) add absolute score-shaping
    hinges on the raw cosine similarities: positives are pushed ABOVE
    ``pos_margin`` and negatives BELOW ``neg_margin`` (the reference's
    fixed 0.8 retrieval gate assumes same-place similarity near 1).
    ``params`` defaults to ``netvlad_init`` from a ``torch.Generator``
    seeded with ``seed``. Returns (params, losses)."""
    from d2slam_tpu_torch.frontend.netvlad import NetVLADConfig, netvlad_init

    dev = resolve_device(device)
    cfg = netvlad_cfg or NetVLADConfig()
    H, W = hw
    rng = np.random.default_rng(seed)
    if params is None:
        params = netvlad_init(torch.Generator().manual_seed(seed), cfg)
    p = _trainable(params, dev)
    opt = torch.optim.Adam(_leaves(p), lr=lr)
    losses = []
    for it in range(steps):
        t0 = time.perf_counter()
        batch_np = netvlad_batch(rng, batch, H, W)
        _record(perf, "batch", t0)
        loss = netvlad_loss(p, *(torch.as_tensor(x).to(dev) for x in batch_np),
                            temperature=temperature, pos_margin=pos_margin,
                            neg_margin=neg_margin, margin_weight=margin_weight)
        _adam_step(opt, loss)
        losses.append(loss.detach())
        if log_every and it % log_every == 0:
            print(f"  nv step {it}: loss {float(loss):.4f}", flush=True)
    return _export(p), torch.stack(losses).cpu().tolist()


@torch.no_grad()
def fit_netvlad_pca(params: Dict, netvlad_cfg=None, pca_dim: int = 1024,
                    n_samples: int = 1600, batch: int = 32,
                    hw: Tuple[int, int] = (120, 160), seed: int = 7, device=None):
    """Fit the PCA projection (reference netvlad_pca_dims: 4096 -> 1024
    with renormalization, mobilenetvlad_onnx.h:49-74) on descriptors of
    freshly generated scenes and attach it to ``params``: the top
    ``pca_dim`` principal directions, orthogonal and unwhitened, so
    cosine similarity in the reduced space tracks the full one."""
    from d2slam_tpu_torch.frontend.netvlad import NetVLAD

    dev = resolve_device(device)
    H, W = hw
    rng = np.random.default_rng(seed)
    model = NetVLAD({k: v for k, v in params.items() if k != "pca"}, device=dev)
    descs = []
    for _ in range(0, n_samples, batch):
        imgs, _ = make_batch(rng, batch, H, W)
        descs.append(model(torch.as_tensor(imgs).to(dev)).cpu().numpy())
    X = np.concatenate(descs)[:n_samples]
    mean = X.mean(axis=0)
    _, _, Vt = np.linalg.svd(X - mean, full_matrices=False)
    d = min(pca_dim, Vt.shape[0])
    out = dict(params)
    out["pca"] = {"mean": mean.astype(np.float32), "proj": Vt[:d].T.astype(np.float32)}
    return out


@torch.no_grad()
def calibrate_netvlad_gate(params: Dict, netvlad_cfg=None, target: float = 0.8,
                           min_precision: float = 0.96, n_places: int = 32,
                           n_alias: int = 20, seed: int = 13,
                           hw: Tuple[int, int] = (120, 160), device=None) -> Dict:
    """Map the embedding's empirical operating point onto the
    reference's fixed retrieval gate (loop_detection_netvlad_thres 0.8):
    find the smallest similarity threshold t* whose retrieval precision
    on a calibration set (fresh scenes + held-out aliases) is >=
    ``min_precision``, then append a constant unit-sphere component so
    cosine similarity maps as s' = alpha^2 s + (1 - alpha^2) with
    alpha^2 = (1 - target) / (1 - t*). Needs a fitted PCA."""
    from d2slam_tpu_torch.frontend.netvlad import NetVLAD

    if "pca" not in params:
        raise ValueError("calibrate after fit_netvlad_pca")
    dev = resolve_device(device)
    H, W = hw
    rng = np.random.default_rng(seed)
    base, _ = make_batch(rng, n_places, H, W)
    held, _ = make_batch(rng, n_alias, H, W)

    def variant(img, strength=0.5):
        Hm = random_homography(rng, H, W, max_angle=0.35 * strength,
                               max_trans=0.15 * strength)
        v = warp_image(torch.as_tensor(img).to(dev), Hm.astype(np.float32)).cpu().numpy()
        return np.clip(v * rng.uniform(0.7, 1.3), 0, 1).astype(np.float32)

    model = NetVLAD(params, device=dev)

    def embed(x):
        return model(torch.as_tensor(x).to(dev)).cpu().numpy()

    db = embed(base)
    q = np.concatenate([embed(np.stack([variant(base[i]) for i in range(n_places)])),
                        embed(np.stack([variant(held[k]) for k in range(n_alias)]))])
    gt = np.concatenate([np.arange(n_places), -np.ones(n_alias, int)])
    sims = q @ db.T
    best = sims.argmax(1)
    score = sims.max(1)
    t_star = None
    for t in np.linspace(0.3, 0.95, 131):
        acc = score >= t
        tp = int(((gt >= 0) & acc & (best == np.maximum(gt, 0))).sum())
        fp = int(acc.sum()) - tp
        if tp + fp == 0:
            break
        if tp / (tp + fp) >= min_precision:
            t_star = float(t)
            break
    if t_star is None or t_star >= target:
        return params  # already calibrated (or hopeless): no-op
    alpha2 = (1.0 - target) / (1.0 - t_star)
    out = dict(params)
    out["pca"] = dict(params["pca"])
    out["pca"]["alpha"] = np.asarray(math.sqrt(alpha2), np.float32)
    out["pca"]["beta"] = np.asarray(math.sqrt(1.0 - alpha2), np.float32)
    return out


# ---------------------------------------------------------------------------
# SuperGlue matcher training (frozen SuperPoint features)
# ---------------------------------------------------------------------------


@torch.no_grad()
def superglue_bank(model: SuperPoint, rng: np.random.Generator, n_pairs: int,
                   hw: Tuple[int, int]):
    """The frozen-SuperPoint pair bank on the model's device: both
    views' keypoints, descriptors, scores and validity, and each A
    keypoint's ground-truth match in B (M for the dustbin), in chunks
    of 32 pairs."""
    H, W = hw
    dev = model.device
    chunks = []
    for _ in range(0, n_pairs, 32):
        imgs, _ = make_batch(rng, 32, H, W)
        Hms = np.stack([random_homography(rng, H, W) for _ in range(32)]).astype(np.float32)
        imgs_t = torch.as_tensor(imgs).to(dev)
        Hms_t = torch.as_tensor(Hms).to(dev)
        warped = torch.stack([warp_image(im, h) for im, h in zip(imgs_t, Hms_t)])
        a = superpoint_extract(model, imgs_t)
        b = superpoint_extract(model, warped)
        Hinv = torch.linalg.inv(Hms_t)
        gt = torch.stack([_gt_assignment(a.kpts[i], a.valid[i], b.kpts[i], b.valid[i],
                                         Hinv[i])[0] for i in range(32)])
        chunks.append((a, b, gt))
    a = type(chunks[0][0])(*(torch.cat([c[0][f] for c in chunks]) for f in range(4)))
    b = type(chunks[0][1])(*(torch.cat([c[1][f] for c in chunks]) for f in range(4)))
    return a, b, torch.cat([c[2] for c in chunks])


def superglue_loss(params: Dict, bank, sel, hw: Tuple[int, int], sg_cfg):
    """Mean over the selected pairs of the NLL of the optimal-transport
    assignment at the ground-truth matches (unmatched valid keypoints
    supervise the dustbin column)."""
    from d2slam_tpu_torch.frontend.superglue import SuperGlue

    a, b, gt = bank
    model = SuperGlue(params, sg_cfg, device=gt.device)
    out = []
    for i in sel.tolist():
        P = model.logP(a.kpts[i], a.desc[i], a.scores[i], a.valid[i],
                       b.kpts[i], b.desc[i], b.scores[i], b.valid[i], hw)
        n = a.kpts.shape[1]
        row = P[torch.arange(n, device=P.device), gt[i]]
        w = a.valid[i].to(P.dtype)
        out.append(-torch.sum(row * w) / torch.clamp_min(torch.sum(w), 1.0))
    return torch.stack(out).mean()


def train_superglue(
    steps: int = 1200,
    batch: int = 8,
    hw: Tuple[int, int] = (120, 160),
    lr: float = 1e-3,
    seed: int = 2,
    sp_params: Optional[Dict] = None,
    sp_cfg: Optional[SuperPointConfig] = None,
    sg_cfg=None,
    n_kpts: int = 96,
    n_pairs: int = 256,
    log_every: int = 100,
    params: Optional[Dict] = None,
    device=None,
    perf=None,
):
    """Train a compact SuperGlue on synthetic homography pairs with
    frozen trained-SuperPoint features (``sp_params``); ground-truth
    correspondences come from the homography. Gradients clipped to a
    global norm of 5 and a cosine-decayed learning rate (to 5 %), as the
    JAX trainer's optax chain. ``params`` defaults to ``superglue_init``
    from a ``torch.Generator`` seeded with ``seed``. Returns (params,
    losses)."""
    from d2slam_tpu_torch.frontend.superglue import SuperGlueConfig, superglue_init

    if sp_params is None:
        raise ValueError("train_superglue needs trained SuperPoint weights")
    dev = resolve_device(device)
    H, W = hw
    sg_cfg = sg_cfg or SuperGlueConfig(num_layers=3, num_heads=4, sinkhorn_iters=20)
    sp_cfg = (SuperPointConfig(max_keypoints=n_kpts, threshold=0.010, nms_radius=4)
              if sp_cfg is None else dataclasses.replace(sp_cfg, max_keypoints=n_kpts))
    rng = np.random.default_rng(seed)
    if params is None:
        params = superglue_init(torch.Generator().manual_seed(seed), sg_cfg)
    bank = superglue_bank(SuperPoint(sp_params, sp_cfg, device=dev), rng, n_pairs, hw)
    p = _trainable(params, dev)
    leaves = _leaves(p)
    opt = torch.optim.Adam(leaves, lr=lr)
    losses = []
    for it in range(steps):
        t0 = time.perf_counter()
        sel = rng.integers(0, n_pairs, batch)
        _record(perf, "batch", t0)
        for group in opt.param_groups:   # optax.cosine_decay_schedule(lr, steps, 0.05)
            group["lr"] = lr * (0.95 * 0.5 * (1 + math.cos(math.pi * min(it, steps) / steps))
                                + 0.05)
        loss = superglue_loss(p, bank, sel, hw, sg_cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(leaves, 5.0)
        opt.step()
        losses.append(loss.detach())
        if log_every and it % log_every == 0:
            print(f"  sg step {it}: loss {float(loss):.4f}", flush=True)
    return _export(p), torch.stack(losses).cpu().tolist()


# ---------------------------------------------------------------------------
# weight files
# ---------------------------------------------------------------------------


def save_weights(path: str, params: Dict) -> None:
    """Write a parameter tree as ``.npz`` with "/"-joined keys (e.g.
    ``cross0/k/w``): the layout of the JAX package's ``save_weights``,
    which both packages' ``load_weights`` read."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = (node.detach().cpu().numpy() if torch.is_tensor(node)
                            else np.asarray(node))

    walk("", params)
    np.savez_compressed(path, **flat)


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
