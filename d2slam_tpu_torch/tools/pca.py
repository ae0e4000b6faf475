"""Descriptor PCA fitting.

The port's own copy of ``d2slam_tpu/tools/pca.py`` (numpy only; the
same arithmetic, so the same bits).

Equivalent of the reference's offline PCA computation
(reference: quadcam_tools/pca_decomp.ipynb producing the projections
consumed at runtime — SuperPoint 256->64 `superpoint_pca_dims`,
superpoint_common.cpp:89-104, and NetVLAD 4096->1024,
mobilenetvlad_onnx.h:49-74). Fits on a matrix of sampled descriptors
and emits the (mean, proj) pair in the exact format the runtime params
expect (`params["pca"] = {"mean", "proj"}` for superpoint_extract /
the `pca=` argument of netvlad_from_onnx).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def fit_pca(samples: np.ndarray, out_dim: int,
            whiten: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Fit a PCA projection on row-vector descriptor samples.

    Returns (mean [D], proj [D, out_dim]); apply as
    ``(x - mean) @ proj`` followed by L2 renormalization (both runtime
    paths renormalize after projecting).
    """
    X = np.asarray(samples, np.float64)
    if X.ndim != 2:
        raise ValueError("samples must be [N, D]")
    n, d = X.shape
    if out_dim > min(n, d):
        raise ValueError(f"out_dim {out_dim} > min(N, D) = {min(n, d)}")
    mean = X.mean(axis=0)
    Xc = X - mean
    # SVD of the centered matrix: principal axes = right singular vectors
    _, s, vt = np.linalg.svd(Xc, full_matrices=False)
    proj = vt[:out_dim].T  # [D, out_dim]
    if whiten:
        scale = np.sqrt(max(n - 1, 1)) / np.maximum(s[:out_dim], 1e-12)
        proj = proj * scale[None, :]
    return mean.astype(np.float32), proj.astype(np.float32)


def explained_variance_ratio(samples: np.ndarray, out_dim: int) -> float:
    X = np.asarray(samples, np.float64)
    Xc = X - X.mean(axis=0)
    s = np.linalg.svd(Xc, compute_uv=False)
    var = s * s
    return float(var[:out_dim].sum() / max(var.sum(), 1e-18))


def pca_params(samples: np.ndarray, out_dim: int,
               whiten: bool = False) -> Dict:
    """`params["pca"]` entry for superpoint_extract / netvlad_apply."""
    mean, proj = fit_pca(samples, out_dim, whiten)
    return {"mean": mean, "proj": proj}


def save_pca(path: str, mean: np.ndarray, proj: np.ndarray) -> None:
    np.savez(path, pca_mean=mean, pca_proj=proj)


def load_pca(path: str) -> Dict:
    raw = np.load(path)
    return {"mean": raw["pca_mean"], "proj": raw["pca_proj"]}
