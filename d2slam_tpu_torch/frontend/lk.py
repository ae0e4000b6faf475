"""Pyramidal Lucas-Kanade tracking on the host, native C++.

Counterpart of the native path of ``d2slam_tpu/frontend/lk.py``
(reference OpenCV SparsePyrLKOpticalFlow with forward-backward check,
d2frontend/src/opticaltrack_utils.cpp:44-170). The port keeps its own
copy of the C++ source (``frontend/native/lk.cpp``), builds it with
``g++`` into the ignored ``_build/`` directory at first use, and binds
it with ctypes. LK stays on the host, as in the JAX package: it works
on the cached float images the tracker already holds.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

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
