"""Dense stereo disparity and point-cloud assembly.

Counterpart of ``d2slam_tpu/depth/stereo.py`` (reference virtual-stereo
depth path, quadcam_depth_est/src/virtual_stereo.cpp: disparity, then
disparity -> 3D points). Two block matchers:

* ``backend="auto"`` (the default): the streaming matcher of
  ``ops/stereo_bm.py`` — the hand-written CUDA kernel on a CUDA tensor,
  its plain version on a CPU tensor — with the uniqueness, left-right
  and border checks on its outputs;
* ``backend="volume"``: the cost-volume matcher, which builds the
  [D, H, W] cost volume with stock tensor ops (the JAX package's XLA
  path). Its box filter zero-pads and masks before filtering, so its
  costs differ from the streaming matcher's near the borders.

All functions take one pair [H, W] or a batch [N, H, W].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from d2slam_tpu_torch.ops.stereo_bm import block_match_disparity_fused


def _box_filter(x, k: int):
    """Mean filter with window k over the last two dims of [..., H, W],
    zeros outside the image (the sum over the window divided by k*k)."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape(-1, 1, *x.shape[-2:]), k, stride=1,
                     padding=k // 2, count_include_pad=True)
    return y.reshape(*lead, *x.shape[-2:])


def disparity(left, right, max_disp: int = 64, block: int = 9,
              lr_thresh: float = 1.5, uniqueness: float = 0.95,
              backend: str = "auto"):
    """(disparity, valid) of rectified pairs; see the module docstring
    for the two backends."""
    if backend == "auto":
        return block_match_disparity_fused(
            left, right, max_disp, block, lr_thresh, uniqueness)
    if backend == "volume":
        return block_match_disparity(
            left, right, max_disp, block, lr_thresh, uniqueness)
    raise ValueError(f"unknown disparity backend {backend!r}")


def _cost_volume(a, b, max_disp: int, block: int, sign: int):
    """[D, ..., H, W] box-filtered SAD of ``a`` against ``b`` shifted by
    ``sign * d``; shifted-in columns cost 1e3 before filtering."""
    W = a.shape[-1]
    col = torch.arange(W, device=a.device)
    costs = []
    for d in range(max_disp):
        sad = (a - torch.roll(b, sign * d, dims=-1)).abs()
        ok = (col >= d) if sign > 0 else (col < W - d)
        costs.append(torch.where(ok, sad, torch.full_like(sad, 1e3)))
    return _box_filter(torch.stack(costs), block)


def block_match_disparity(left, right, max_disp: int = 64, block: int = 9,
                          lr_thresh: float = 1.5, uniqueness: float = 0.95):
    """Cost-volume block matching. Returns (disparity float, valid bool).

    Matching convention: left pixel x corresponds to right pixel x - d,
    d in [0, max_disp)."""
    W = left.shape[-1]
    D = max_disp
    costs = _cost_volume(left, right, D, block, +1)      # [D, ..., H, W]
    cmin, best = torch.min(costs, dim=0)

    # uniqueness: second-best sufficiently worse (excluding neighbours)
    didx = torch.arange(D, device=left.device).reshape(D, *[1] * left.dim())
    near = (didx - best[None]).abs() <= 1
    second = torch.min(costs.masked_fill(near, float("inf")), dim=0).values
    unique_ok = cmin < uniqueness * second

    # parabolic sub-pixel refinement
    bm = torch.clamp(best, 1, D - 2)
    c0 = torch.gather(costs, 0, (bm - 1)[None])[0]
    c1 = torch.gather(costs, 0, bm[None])[0]
    c2 = torch.gather(costs, 0, (bm + 1)[None])[0]
    denom = torch.clamp_min(c0 - 2 * c1 + c2, 1e-6)
    delta = torch.clamp(0.5 * (c0 - c2) / denom, -1.0, 1.0)
    disp = best.to(left.dtype) + torch.where(best == bm, delta,
                                             torch.zeros_like(delta))

    # left-right consistency: the disparity of the right image
    best_r = torch.argmin(_cost_volume(right, left, D, block, -1), dim=0)
    xs = torch.arange(W, device=left.device).expand_as(best)
    xr = torch.clamp(xs - best, 0, W - 1)
    d_r_at = torch.gather(best_r, -1, xr)
    lr_ok = (best - d_r_at).abs() <= lr_thresh

    valid = unique_ok & lr_ok & (best > 0) & (best < D - 1) & (xs >= max_disp)
    return disp, valid


def points_from_disparity(disp, valid, fx: float, baseline: float,
                          cx: float, cy: float,
                          min_z: float = 0.3, max_z: float = 30.0):
    """Disparity [..., H, W] -> camera-frame 3D points [..., H, W, 3]
    and their validity. ``fx`` and ``baseline`` are floats, or tensors
    that broadcast against ``disp`` (one value per pair of a batch)."""
    H, W = disp.shape[-2:]
    z = fx * baseline / torch.clamp_min(disp, 1e-6)
    ok = valid & (z > min_z) & (z < max_z)
    ys = torch.arange(H, dtype=disp.dtype, device=disp.device)[:, None]
    xs = torch.arange(W, dtype=disp.dtype, device=disp.device)[None, :]
    x = (xs - cx) / fx * z
    y = (ys - cy) / fx * z
    return torch.stack([x, y, z], dim=-1), ok
