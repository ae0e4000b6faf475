"""Fisheye-to-virtual-view undistortion as precomputed gather maps.

Counterpart of ``d2slam_tpu/depth/fisheye_undist.py`` (reference
FisheyeUndist, d2common/include/d2common/fisheye_undistort.h:30-200:
remap tables from any camodocal model to virtual pinhole views). A map
is built once by lifting each output pixel through the ideal virtual
camera, rotating into the fisheye camera, and projecting through the
fisheye model; applying it is a batched bilinear gather, so the views
of a quadcam frame remap in one call.
"""
from __future__ import annotations

import math

import torch

from d2slam_tpu_torch.geometry import cameras as _cam
from d2slam_tpu_torch.utils.device import resolve_device


def _pixel_grid(H: int, W: int, dev):
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    return xs, ys


def _project_rays(fisheye, rays, R_fisheye_virtual):
    if R_fisheye_virtual is not None:
        R = torch.as_tensor(R_fisheye_virtual, dtype=torch.float32,
                            device=rays.device)
        rays = rays @ R.T
    uv, valid = _cam.project(fisheye, rays)
    return torch.where(valid[..., None], uv, torch.full_like(uv, -1.0))


def build_undistort_map(fisheye, R_fisheye_virtual, out_hw,
                        virtual_fov_deg: float = 90.0, device=None):
    """Returns (map_xy [H, W, 2] f32, virtual_focal): the source pixel
    of each pixel of a virtual pinhole view; samples that do not project
    map to (-1, -1).

    fisheye: a camera parameter struct or an object with ``.project``
    (KalibrCamera). R_fisheye_virtual: [3, 3] rotation virtual->fisheye
    camera. ``device=None`` means the card."""
    dev = resolve_device(device)
    H, W = out_hw
    f = (W / 2.0) / math.tan(math.radians(virtual_fov_deg / 2.0))
    xs, ys = _pixel_grid(H, W, dev)
    rays = torch.stack(
        [(xs - W / 2.0) / f, (ys - H / 2.0) / f, torch.ones_like(xs)], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    return _project_rays(fisheye, rays, R_fisheye_virtual), f


def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    return torch.tensor([[1.0, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    return torch.tensor([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])


def build_pinhole5_maps(fisheye, out_hw, side_angle_deg: float = 90.0,
                        virtual_fov_deg: float = 90.0, device=None):
    """Center + 4 side virtual-pinhole remap targets (reference
    FisheyeUndist Pinhole5 mode: one forward view plus up/down/left/right
    views rotated by ``side_angle_deg``, jointly covering the fisheye
    FOV). Returns (maps [5, H, W, 2], virtual_focal) with view order
    [center, left, up, right, down] (the reference's photo order)."""
    a = math.radians(side_angle_deg)
    Rs = [
        torch.eye(3),
        _rot_y(-a),   # left:  forward ray -> [-sin a, 0, cos a]
        _rot_x(a),    # up:    forward ray -> [0, -sin a, cos a]
        _rot_y(a),    # right: forward ray -> [ sin a, 0, cos a]
        _rot_x(-a),   # down:  forward ray -> [0,  sin a, cos a]
    ]
    built = [build_undistort_map(fisheye, R, out_hw, virtual_fov_deg, device)
             for R in Rs]
    return torch.stack([m for m, _ in built]), built[0][1]


def build_cylindrical_map(fisheye, out_hw, fov_deg: float = 180.0,
                          v_range: float = 1.0, R_fisheye_virtual=None,
                          device=None):
    """Cylindrical-panorama remap target (reference FisheyeUndist
    cylindrical mode). An output pixel lifts through the cylindrical
    camera (u -> azimuth, v -> height on the unit cylinder), rotates
    into the fisheye frame and projects through the fisheye model.

    Returns (map_xy [H, W, 2], CylindricalParams of the virtual camera).
    ``fov_deg`` is the horizontal azimuth span; ``v_range`` the vertical
    half-extent in cylinder-height units."""
    dev = resolve_device(device)
    H, W = out_hw
    fx = W / math.radians(fov_deg)          # pixels per radian of azimuth
    fy = (H / 2.0) / v_range
    params = _cam.CylindricalParams.make(fx, fy, W / 2.0, H / 2.0)
    xs, ys = _pixel_grid(H, W, dev)
    rays = _cam.cylindrical_lift(torch.stack([xs, ys], dim=-1), params)
    return _project_rays(fisheye, rays, R_fisheye_virtual), params


def remap_bilinear(img, map_xy, photometric=None):
    """Sample ``img`` [..., H, W] at ``map_xy`` [..., Ho, Wo, 2]
    (leading dims broadcast: a batch of images through a batch of maps,
    or through one map); positions outside the image give 0.

    ``photometric`` is an optional [..., H, W] gain map (vignette
    correction) applied to the source image before sampling, the
    reference FisheyeUndist's photometric-correction path."""
    if photometric is not None:
        img = img * photometric
    H, W = img.shape[-2:]
    lead = torch.broadcast_shapes(img.shape[:-2], map_xy.shape[:-3])
    Ho, Wo = map_xy.shape[-3:-1]
    img = img.expand(*lead, H, W)
    map_xy = map_xy.expand(*lead, Ho, Wo, 2)
    x, y = map_xy[..., 0], map_xy[..., 1]
    inb = (x >= 0) & (x <= W - 1.001) & (y >= 0) & (y <= H - 1.001)
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    wx = x - x0
    wy = y - y0
    flat = img.reshape(*lead, H * W)

    def at(yi, xi):
        idx = (yi * W + xi).reshape(*lead, Ho * Wo)
        return torch.gather(flat, -1, idx).reshape(*lead, Ho, Wo)

    v = (
        at(y0, x0) * (1 - wx) * (1 - wy)
        + at(y0, x0 + 1) * wx * (1 - wy)
        + at(y0 + 1, x0) * (1 - wx) * wy
        + at(y0 + 1, x0 + 1) * wx * wy
    )
    return torch.where(inb, v, torch.zeros_like(v))
