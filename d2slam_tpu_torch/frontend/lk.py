"""Pyramidal Lucas-Kanade tracking: native C++ on the host, and batched
on a device.

Counterpart of ``d2slam_tpu/frontend/lk.py`` (reference OpenCV /
CUDA SparsePyrLKOpticalFlow with forward-backward check,
d2frontend/src/opticaltrack_utils.cpp:44-170).

* ``lk_track_images``: the port keeps its own copy of the C++ source
  (``frontend/native/lk.cpp``), builds it with ``g++`` into the ignored
  ``_build/`` directory at first use, and binds it with ctypes. The
  tracker uses it, as the JAX tracker uses the JAX package's: it works
  on the cached float images the tracker already holds.
* ``build_pyramid`` / ``lk_track_pyramidal``: the same algorithm on
  tensors on the caller's device, every point of a level in one batch
  of ``[N, win*win]`` gathers; the level and iteration loops read
  nothing back to the host.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np
import torch

from d2slam_tpu_torch.utils.device import resolve_device
from d2slam_tpu_torch.utils.native import PKG_DIR, build_shared_lib

SOURCE = os.path.join(PKG_DIR, "frontend", "native", "lk.cpp")

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build_shared_lib("lk", SOURCE, ["g++"],
                               ["-O3", "-fPIC", "-shared"], ["-lpthread"])
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.lk_pyr_track.restype = ctypes.c_int
        lib.lk_pyr_track.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int, f32p, u8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, f32p, u8p,
        ]
        _LIB = lib
    return _LIB


def build() -> None:
    """Compile and load the native library now (it is otherwise built
    at its first call)."""
    _lib()


def lk_track_images(img_prev, img_next, pts, valid, levels: int = 3,
                    win: int = 21, iters: int = 10, fb_thresh: float = 0.5):
    """Track ``pts`` [N, 2] (x, y) from ``img_prev`` to ``img_next``
    (full-resolution [H, W] float images) with a 2x2-average pyramid of
    ``levels`` levels, ``iters`` fixed-Hessian iterations in a
    ``win`` x ``win`` window, and a forward-backward check of
    ``fb_thresh`` px. Returns (new_pts [N, 2] f32, ok [N] bool)."""
    lib = _lib()
    a = np.ascontiguousarray(img_prev, np.float32)
    b = np.ascontiguousarray(img_next, np.float32)
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"LK wants two [H, W] images, got {a.shape}, {b.shape}")
    p = np.ascontiguousarray(pts, np.float32).reshape(-1, 2)
    v = np.ascontiguousarray(np.asarray(valid, bool).astype(np.uint8))
    n = p.shape[0]
    if v.shape != (n,):
        raise ValueError("valid must have one entry per point")
    out_p = np.empty((n, 2), np.float32)
    out_ok = np.empty(n, np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.lk_pyr_track(
        a.ctypes.data_as(f32p), b.ctypes.data_as(f32p),
        a.shape[0], a.shape[1],
        p.ctypes.data_as(f32p), v.ctypes.data_as(u8p), n,
        levels, win, iters, fb_thresh,
        min(os.cpu_count() or 1, 4),
        out_p.ctypes.data_as(f32p), out_ok.ctypes.data_as(u8p),
    )
    if rc != 0:
        raise ValueError(f"lk_pyr_track rejected its arguments (rc={rc})")
    return out_p, out_ok.astype(bool)


# ---------------------------------------------------------------------------
# Pyramidal LK on a device, batched over points
# ---------------------------------------------------------------------------


def build_pyramid(img, levels: int = 3, device=None) -> List[torch.Tensor]:
    """[H, W] float image -> list of ``levels + 1`` float32 images, each
    the 2x2 average of the one before (an odd last row or column is
    dropped). A tensor stays on its device; an array goes to ``device``
    (default ``cuda``)."""
    if not torch.is_tensor(img):
        img = torch.as_tensor(np.asarray(img), device=resolve_device(device))
    x = img.to(torch.float32)
    pyr = [x]
    for _ in range(levels):
        h, w = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2
        x = (x[0:h:2, 0:w:2] + x[0:h:2, 1:w:2] + x[1:h:2, 0:w:2] + x[1:h:2, 1:w:2]) * 0.25
        pyr.append(x)
    return pyr


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img`` at (x, y), any shape; the cell is
    clipped to the image and the weights to [0, 1]."""
    H, W = img.shape
    x0 = torch.clamp(torch.floor(x), 0, W - 2)
    y0 = torch.clamp(torch.floor(y), 0, H - 2)
    wx = torch.clamp(x - x0, 0.0, 1.0)
    wy = torch.clamp(y - y0, 0.0, 1.0)
    # the index clamp again: a NaN coordinate stays in the image
    i00 = y0.long().clamp(0, H - 2) * W + x0.long().clamp(0, W - 2)
    v00, v01, v10, v11 = img.reshape(-1)[torch.stack([i00, i00 + 1, i00 + W, i00 + W + 1])]
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def _lk_level(prev, nxt, pts_prev, guess, win: int, iters: int):
    """One pyramid level for all points: ``pts_prev`` [N, 2] at this
    level's scale, ``guess`` [N, 2] the flow so far. Returns (flow
    [N, 2], good [N]: the window's structure tensor is invertible)."""
    r = win // 2
    o = torch.arange(-r, r + 1, dtype=prev.dtype, device=prev.device)
    ox = o[None, :].expand(win, win).reshape(-1)   # x runs fastest
    oy = o[:, None].expand(win, win).reshape(-1)
    px = pts_prev[:, 0:1] + ox                     # [N, win*win]
    py = pts_prev[:, 1:2] + oy
    # the template and its four neighbours (central differences) in one batch
    I, xp, xm, yp, ym = _bilinear(prev, torch.stack([px, px + 1, px - 1, px, px]),
                                  torch.stack([py, py, py, py + 1, py - 1]))
    Ix = 0.5 * (xp - xm)
    Iy = 0.5 * (yp - ym)
    A11 = (Ix * Ix).sum(1)
    A12 = (Ix * Iy).sum(1)
    A22 = (Iy * Iy).sum(1)
    det = A11 * A22 - A12 * A12
    inv_det = 1.0 / torch.clamp_min(det, 1e-9)
    gx, gy = guess[:, 0], guess[:, 1]
    for _ in range(iters):
        err = _bilinear(nxt, px + gx[:, None], py + gy[:, None]) - I
        b1 = (err * Ix).sum(1)
        b2 = (err * Iy).sum(1)
        gx = gx - (A22 * b1 - A12 * b2) * inv_det
        gy = gy - (-A12 * b1 + A11 * b2) * inv_det
    return torch.stack([gx, gy], 1), det > 1e-6


def _lk_pyramid(pyr_a, pyr_b, p0, win: int, iters: int):
    guess = torch.zeros_like(p0)
    good = torch.ones(p0.shape[0], dtype=torch.bool, device=p0.device)
    for lvl in range(len(pyr_a) - 1, -1, -1):
        scale = 2.0 ** lvl
        g, ok = _lk_level(pyr_a[lvl], pyr_b[lvl], p0 / scale, guess / scale, win, iters)
        guess = g * scale
        good = good & ok
    return p0 + guess, good


def lk_track_pyramidal(pyr_prev: List[torch.Tensor], pyr_next: List[torch.Tensor],
                       pts, valid, win: int = 21, iters: int = 10,
                       fb_thresh: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track ``pts`` [N, 2] (x, y, full resolution) from ``pyr_prev`` to
    ``pyr_next`` (``build_pyramid``'s, on one device) coarse to fine,
    ``iters`` fixed-Hessian steps per level in a ``win`` x ``win``
    window, then back again: a point is ``ok`` where it is ``valid``,
    both directions' windows are invertible at every level, it returns
    within ``fb_thresh`` px and it lands at least 1 px inside the image.
    Returns (new_pts [N, 2] float32, ok [N] bool) on the pyramids'
    device."""
    dev = pyr_prev[0].device
    p0 = torch.as_tensor(pts, dtype=torch.float32, device=dev).reshape(-1, 2)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev).reshape(-1)
    fwd, ok_f = _lk_pyramid(pyr_prev, pyr_next, p0, win, iters)
    back, ok_b = _lk_pyramid(pyr_next, pyr_prev, fwd, win, iters)
    fb_err = torch.linalg.vector_norm(back - p0, dim=-1)
    H, W = pyr_prev[0].shape
    inb = (fwd[:, 0] >= 1) & (fwd[:, 0] < W - 1) & (fwd[:, 1] >= 1) & (fwd[:, 1] < H - 1)
    return fwd, valid & ok_f & ok_b & (fb_err < fb_thresh) & inb
