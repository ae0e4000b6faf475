"""Descriptor matching on torch tensors.

Counterpart of the host entry points of ``d2slam_tpu/frontend/matching.py``
(reference kNN ratio matching with radius gating,
d2frontend/src/d2featuretracker.cpp:1077-1294 matchLocalFeatures, and
the epipolar stereo association, :658-753): one masked similarity
GEMM, top-2 per row, Lowe's ratio test on the implied L2 distances and
a mutual-nearest cross check. Runs on the descriptors' device (the
tracker keeps them on the card); returns (idx [N] long, ok [N] bool)
tensors on that device.
"""
from __future__ import annotations

import torch

NEG = -1e9


def _as(x, like, dtype=None):
    return torch.as_tensor(x, dtype=dtype or like.dtype, device=like.device)


def _ratio_match(sim, mask, valid_a, ratio, min_similarity, cross_check):
    """Ratio test on unit descriptors: d^2 = 2 - 2 s, so
    d1 < ratio * d2  <=>  (1 - s1) < ratio^2 * (1 - s2)."""
    n, m = sim.shape
    if n == 0 or m == 0:
        return (torch.zeros(n, dtype=torch.long, device=sim.device),
                torch.zeros(n, dtype=torch.bool, device=sim.device))
    sim = torch.where(mask, sim, torch.full_like(sim, NEG))
    s1, i1 = torch.max(sim, dim=1)
    s2 = torch.max(sim.scatter(1, i1[:, None], NEG), dim=1).values if m > 1 \
        else torch.full_like(s1, NEG)
    ok = s1 > min_similarity
    ok &= (1.0 - s1) < ratio * ratio * torch.clamp_min(1.0 - s2, 0.0)
    if cross_check:
        back = torch.argmax(sim, dim=0)
        ok &= back[i1] == torch.arange(n, device=sim.device)
    return i1, ok & valid_a


def match_descriptors(desc_a, desc_b, valid_a, valid_b, ratio: float = 0.8,
                      min_similarity: float = -1.0, cross_check: bool = True):
    """Mutual nearest descriptor matching with Lowe's ratio test.
    desc_a [N, D], desc_b [M, D] L2-normalized."""
    valid_a = _as(valid_a, desc_a, torch.bool)
    valid_b = _as(valid_b, desc_a, torch.bool)
    sim = desc_a @ _as(desc_b, desc_a).T
    mask = valid_a[:, None] & valid_b[None, :]
    return _ratio_match(sim, mask, valid_a, ratio, min_similarity, cross_check)


def match_descriptors_radius(desc_a, desc_b, pts_pred_a, pts_b, valid_a,
                             valid_b, radius: float, ratio: float = 0.8,
                             cross_check: bool = True):
    """Ratio matching restricted to candidates within ``radius`` px of
    the motion-predicted location."""
    valid_a = _as(valid_a, desc_a, torch.bool)
    valid_b = _as(valid_b, desc_a, torch.bool)
    pa = _as(pts_pred_a, desc_a, torch.float32)
    pb = _as(pts_b, desc_a, torch.float32)
    sim = desc_a @ _as(desc_b, desc_a).T
    # |a-b|^2 via the GEMM identity, as the JAX host path
    d2 = ((pa ** 2).sum(1)[:, None] + (pb ** 2).sum(1)[None, :]
          - 2.0 * (pa @ pb.T))
    mask = valid_a[:, None] & valid_b[None, :] & (d2 <= radius * radius)
    return _ratio_match(sim, mask, valid_a, ratio, NEG / 2, cross_check)


def match_stereo_epipolar(desc_l, desc_r, pts_l, pts_r, valid_l, valid_r,
                          max_disparity: float = 80.0, band_px: float = 2.5,
                          ratio: float = 0.8):
    """Left->right matching in the rectified epipolar band:
    |y_l - y_r| < band and 0 <= x_l - x_r <= max_disparity."""
    valid_l = _as(valid_l, desc_l, torch.bool)
    valid_r = _as(valid_r, desc_l, torch.bool)
    pl = _as(pts_l, desc_l, torch.float32)
    pr = _as(pts_r, desc_l, torch.float32)
    sim = desc_l @ _as(desc_r, desc_l).T
    dy = torch.abs(pl[:, None, 1] - pr[None, :, 1])
    disp = pl[:, None, 0] - pr[None, :, 0]
    mask = (valid_l[:, None] & valid_r[None, :]
            & (dy < band_px) & (disp >= 0.0) & (disp <= max_disparity))
    return _ratio_match(sim, mask, valid_l, ratio, NEG / 2, True)


def retrieval_topk(query, database, db_valid, k: int):
    """Inner-product retrieval over the keyframe database — the FAISS
    IndexFlatIP equivalent as one GEMM + top-k (reference
    queryIndexFromDatabase, loop_detector.cpp:300-360). query [Q, D],
    database [N, D], db_valid [N] bool; returns (scores [Q, k],
    idx [Q, k]) on the inputs' device."""
    sim = query @ database.T
    sim = torch.where(db_valid[None, :], sim, torch.full_like(sim, NEG))
    return torch.topk(sim, k, dim=1)
