"""Pinhole camera model with batched project (space->plane) and lift
(plane->ray) on torch tensors.

Counterpart of the pinhole part of ``d2slam_tpu/geometry/cameras.py``
(reference camodocal PinholeCamera). The other six camera models of the
JAX package are not ported yet (ROADMAP.md, Queue 1).

Conventions: camera frame z forward; pixel coords (u, v); intrinsics
(fx, fy, cx, cy); radial/tangential plumb-bob distortion k1, k2, p1, p2.
Intrinsics are host floats: they are configuration, not state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeParams(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @staticmethod
    def make(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0):
        return PinholeParams(*[float(v) for v in
                               (fx, fy, cx, cy, k1, k2, p1, p2)])


def _distort(p, params: PinholeParams):
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    rad = params.k1 * r2 + params.k2 * r2 * r2
    dx = x * rad + 2 * params.p1 * x * y + params.p2 * (r2 + 2 * x * x)
    dy = y * rad + params.p1 * (r2 + 2 * y * y) + 2 * params.p2 * x * y
    return torch.stack([x + dx, y + dy], dim=-1)


def pinhole_project(pts3, params: PinholeParams):
    """[..., 3] camera-frame points -> ([..., 2] pixels, [...] valid)."""
    z = pts3[..., 2]
    valid = z > 1e-6
    zs = torch.where(valid, z, torch.ones_like(z))
    p = pts3[..., :2] / zs[..., None]
    pd = _distort(p, params)
    u = params.fx * pd[..., 0] + params.cx
    v = params.fy * pd[..., 1] + params.cy
    return torch.stack([u, v], dim=-1), valid


def pinhole_lift(uv, params: PinholeParams, iters: int = 20):
    """[..., 2] pixels -> [..., 3] unit rays (fixed-point undistortion,
    reference PinholeCamera::liftProjective)."""
    mx = (uv[..., 0] - params.cx) / params.fx
    my = (uv[..., 1] - params.cy) / params.fy
    target = torch.stack([mx, my], dim=-1)
    p = target
    for _ in range(iters):
        p = target - (_distort(p, params) - p)
    ray = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
