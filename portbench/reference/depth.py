"""Plain quadcam depth: the depth cell's reference.

What the reference quadcam_depth_est computes for a frame of four
fisheye images (virtual_stereo.cpp): for each adjacent pair (i, i+1 mod
4) two virtual pinhole views facing between the cameras (the left one
yawed +45 degrees, the right one -45 degrees, so the pair is rectified),
sampled from the fisheyes by bilinear interpolation (0 outside the
image); SAD block matching over ``max_disp`` disparities with a
``block`` x ``block`` box mean (rows replicated at the top and bottom,
columns circular, cost 1e3 where a shift has no match), the best and
second-best cost, a parabolic sub-pixel step, the uniqueness test, the
left-right check and the border mask; then points ``z = f B / d``.

All of it is worked out here again from the fisheye parameters and the
extrinsics: the remap tables, the baselines and the focal. ``dtype``
float32 is the reference; bfloat16 is its control.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.yardstick.geometry import rot_y
from portbench.yardstick.render import kb_project


class Pair(NamedTuple):
    map_left: torch.Tensor    # [H, W, 2] source pixel in fisheye i
    map_right: torch.Tensor   # [H, W, 2] source pixel in fisheye i + 1
    cam_left: int
    cam_right: int
    baseline: float
    focal: float


def virtual_pairs(fisheyes, extrinsics: np.ndarray, out_hw, fov_deg: float, device) -> List[Pair]:
    H, W = out_hw
    f = (W / 2.0) / math.tan(math.radians(fov_deg / 2.0))
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    rays = torch.stack([(xs - W / 2.0) / f, (ys - H / 2.0) / f, torch.ones_like(xs)], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)

    def table(cam, yaw_deg):
        R = torch.as_tensor(rot_y(np.deg2rad(yaw_deg)), dtype=torch.float32, device=device)
        uv, ok = kb_project(rays @ R.T, cam)
        return torch.where(ok[..., None], uv, torch.full_like(uv, -1.0))

    ext = np.asarray(extrinsics, np.float64)
    pairs = []
    for i in range(4):
        j = (i + 1) % 4
        pairs.append(Pair(table(fisheyes[i], 45.0), table(fisheyes[j], -45.0), i, j,
                          float(np.linalg.norm(ext[i, :3] - ext[j, :3])), float(f)))
    return pairs


def remap(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """img [N, H, W], map [N, Ho, Wo, 2] -> [N, Ho, Wo]."""
    N, H, W = img.shape
    x, y = map_xy[..., 0], map_xy[..., 1]
    inb = (x >= 0) & (x <= W - 1.001) & (y >= 0) & (y <= H - 1.001)
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    wx, wy = (x - x0).to(img.dtype), (y - y0).to(img.dtype)
    flat = img.reshape(N, H * W)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * W + xi).reshape(N, -1)).reshape(yi.shape)

    v = (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x0 + 1) * wx * (1 - wy)
         + at(y0 + 1, x0) * (1 - wx) * wy + at(y0 + 1, x0 + 1) * wx * wy)
    return torch.where(inb, v, torch.zeros_like(v))


def block_match(left, right, max_disp: int, block: int, reverse: bool = False):
    """One SAD pass over [N, H, W] pairs: (disp with sub-pixel, best,
    cost, second), each [N, H, W]; the lowest disparity wins a tie."""
    N, H, W = left.shape
    dt = left.dtype
    r = block // 2
    Lp = F.pad(left[:, None].float(), (0, 0, r, r), mode="replicate")[:, 0].to(dt)
    Rp = F.pad(right[:, None].float(), (0, 0, r, r), mode="replicate")[:, 0].to(dt)
    col = torch.arange(W, device=left.device).expand(N, H, W)
    big = torch.full((N, H, W), 1e9, dtype=dt, device=left.device)
    best_c, second_c, cm1, cp1, c_prev = big, big, big, big, big
    best_d = torch.full((N, H, W), -2, dtype=torch.int32, device=left.device)
    no_match = torch.full_like(big, 1e3)
    inv = 1.0 / (block * block)
    for d in range(max_disp):
        sad = (Lp - torch.roll(Rp, -d if reverse else d, dims=-1)).abs()
        vs = sad[:, 0:H]
        for dy in range(1, block):
            vs = vs + sad[:, dy:dy + H]
        hs = vs
        for dx in range(1, r + 1):
            hs = hs + torch.roll(vs, dx, dims=-1) + torch.roll(vs, -dx, dims=-1)
        invalid = (col >= W - d) if reverse else (col < d)
        c = torch.where(invalid, no_match, hs * inv)
        take = c < best_c
        far_old = (best_d - d).abs() > 1
        cm1 = torch.where(take, c_prev, cm1)
        cp1 = torch.where(take, big, torch.where(best_d + 1 == d, c, cp1))
        second_c = torch.where(far_old, torch.minimum(second_c, torch.where(take, best_c, c)),
                               second_c)
        best_c = torch.where(take, c, best_c)
        best_d = torch.where(take, torch.full_like(best_d, d), best_d)
        c_prev = c
    have_nb = (cm1 < 0.5e9) & (cp1 < 0.5e9)
    denom = torch.clamp_min(cm1 - 2.0 * best_c + cp1, 1e-6)
    delta = torch.clamp(0.5 * (cm1 - cp1) / denom, -1.0, 1.0)
    disp = best_d.to(dt) + torch.where(have_nb, delta, torch.zeros_like(delta))
    return disp, best_d, best_c, second_c


def disparity(left, right, max_disp: int, block: int, lr_thresh: float = 1.5,
              uniqueness: float = 0.95):
    W = left.shape[-1]
    disp, best, cost, second = block_match(left, right, max_disp, block)
    _, best_r, _, _ = block_match(right, left, max_disp, block, reverse=True)
    unique = cost < uniqueness * second
    xs = torch.arange(W, device=left.device).expand_as(best)
    d_r = torch.gather(best_r, -1, torch.clamp(xs - best, 0, W - 1))
    lr = (best - d_r).abs() <= lr_thresh
    return disp.float(), unique & lr & (best > 0) & (best < max_disp - 1) & (xs >= max_disp)


def frame_depth(images_u8: np.ndarray, pairs: List[Pair], max_disp: int, block: int,
                min_z: float, max_z: float, device, dtype=torch.float32):
    """One frame [4, Hf, Wf] uint8 -> (z [P, H, W] float32, valid [P, H, W]).
    Points follow from z and the pixel: x = (u - W/2) z / f."""
    imgs = torch.as_tensor(np.asarray(images_u8), device=device).to(dtype)
    li = [p.cam_left for p in pairs]
    ri = [p.cam_right for p in pairs]
    left = remap(imgs[li], torch.stack([p.map_left for p in pairs]))
    right = remap(imgs[ri], torch.stack([p.map_right for p in pairs]))
    disp, valid = disparity(left.contiguous(), right.contiguous(), max_disp, block)
    fb = torch.tensor([p.focal * p.baseline for p in pairs], device=device)[:, None, None]
    z = fb / torch.clamp_min(disp, 1e-6)
    return z, valid & (z > min_z) & (z < max_z)
