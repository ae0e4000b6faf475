"""Pairwise Consistency Maximization (PCM) loop-outlier rejection.

Counterpart of ``d2slam_tpu/pgo/pcm.py`` (reference
swarm_outlier_rejection.cpp:199-201 + third_party/fast_max-clique_finder):
two loop edges are consistent when the cycle formed by the two loops and
the two odometry segments between their endpoints has a small
Mahalanobis norm; the accepted set is the maximum clique of the
consistency graph.

The [L, L] cycle evaluation is one broadcast on the device; the clique
search is an exact Bron-Kerbosch with pivoting on the host (clique sizes
here are tens of loops).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from d2slam_tpu_torch.geometry.lie import pose_boxminus, pose_compose, pose_inverse
from d2slam_tpu_torch.utils.device import resolve_device


def pairwise_consistency(loops_rel, poses_a, poses_b, sqrt_info_diag):
    """Consistency distance matrix [L, L] of tensors [L, 7]:

    d(k, l) = || (T_ak^-1 T_al) * rel_l * (T_bk^-1 T_bl)^-1  vs  rel_k ||
    in the tangent space, weighted by ``sqrt_info_diag`` [6]."""
    ak, al = poses_a[:, None], poses_a[None, :]
    bk, bl = poses_b[:, None], poses_b[None, :]
    T_ak_al = pose_compose(pose_inverse(ak), al)
    T_bk_bl = pose_compose(pose_inverse(bk), bl)
    pred_rel_k = pose_compose(pose_compose(T_ak_al, loops_rel[None, :]), pose_inverse(T_bk_bl))
    d = pose_boxminus(pred_rel_k, loops_rel[:, None].expand_as(pred_rel_k))
    return torch.linalg.norm(d * sqrt_info_diag, dim=-1)


def max_clique(adj: np.ndarray) -> List[int]:
    """Exact max clique via Bron-Kerbosch with pivoting (host-side)."""
    n = adj.shape[0]
    best: List[int] = []
    neighbors = [set(np.flatnonzero(adj[i]).tolist()) - {i} for i in range(n)]

    def bk(r: set, p: set, x: set):
        nonlocal best
        if not p and not x:
            if len(r) > len(best):
                best = sorted(r)
            return
        if len(r) + len(p) <= len(best):
            return  # bound
        pivot = max(p | x, key=lambda v: len(neighbors[v] & p))
        for v in list(p - neighbors[pivot]):
            bk(r | {v}, p & neighbors[v], x & neighbors[v])
            p = p - {v}
            x = x | {v}

    bk(set(), set(range(n)), set())
    return best


def pcm_filter(loops_rel, poses_a, poses_b, thres: float = 1.5,
               sqrt_info_diag=None, device=None) -> np.ndarray:
    """Boolean keep-mask over loops (reference OutlierRejectionLoopEdges
    with pcm_thres). Inputs are [L, 7] arrays; the distance matrix is
    computed in float64 on ``device`` (default ``cuda``)."""
    L = len(loops_rel)
    if L == 0:
        return np.zeros(0, bool)
    if L == 1:
        return np.ones(1, bool)
    dev = resolve_device(device)
    if sqrt_info_diag is None:
        sqrt_info_diag = [1.0, 1, 1, 3, 3, 3]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    D = pairwise_consistency(t(loops_rel), t(poses_a), t(poses_b), t(sqrt_info_diag))
    D = D.cpu().numpy()
    adj = (np.maximum(D, D.T) < thres) & ~np.eye(L, dtype=bool)
    mask = np.zeros(L, bool)
    mask[max_clique(adj.astype(np.uint8))] = True
    return mask
