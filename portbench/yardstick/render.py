"""Image generators of the benchmark, on the device, in bulk.

``render_blobs`` is the port's ``utils/render.py::render_blobs`` (a
checkerboard saddle at each landmark's projection) computed for many camera poses at once with
tensor operations instead of a loop over landmarks. ``cylinder_wall`` is
``render_cylinder_wall`` (a textured cylinder around the body seen
through Kannala-Brandt fisheyes) with the rays lifted once per camera
and a new texture per frame. Both give float images in [0, 1]; ``to_u8``
quantizes them as the dataset writers do.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.yardstick.geometry import quat_to_rotmat


def render_blobs(landmarks, intensity, T_w_cam: np.ndarray, fx: float,
                 H: int, W: int, device, sigma: float = 1.5, chunk: int = 32) -> torch.Tensor:
    """[M, H, W] float32 images of the landmarks seen from the M camera
    poses ``T_w_cam`` [M, 7] through a pinhole of focal ``fx`` with its
    principal point at the image centre."""
    lms = torch.as_tensor(np.asarray(landmarks), dtype=torch.float32, device=device)
    inten = torch.as_tensor(np.asarray(intensity), dtype=torch.float32, device=device)
    T = np.asarray(T_w_cam, np.float64)
    Rs = torch.as_tensor(quat_to_rotmat(T[:, 3:]), dtype=torch.float32, device=device)
    ts = torch.as_tensor(T[:, :3], dtype=torch.float32, device=device)
    r = int(math.ceil(3 * sigma))
    off = torch.arange(-r, r + 1, device=device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    oy, ox = oy.reshape(-1), ox.reshape(-1)                     # [P]
    cx, cy = W / 2.0, H / 2.0
    out = []
    for s in range(0, len(T), chunk):
        R, t = Rs[s:s + chunk], ts[s:s + chunk]
        pc = torch.einsum("mnk,mkj->mnj", lms[None] - t[:, None], R)   # [m, N, 3]
        z = pc[..., 2]
        vis = z > 0.5
        zs = torch.where(vis, z, torch.ones_like(z))
        u = fx * pc[..., 0] / zs + cx
        v = fx * pc[..., 1] / zs + cy
        x0, y0 = torch.round(u), torch.round(v)
        ok = vis & (x0 >= r) & (x0 < W - r) & (y0 >= r) & (y0 < H - r)
        xs = x0[..., None] + ox                                  # [m, N, P]
        ys = y0[..., None] + oy
        dxs = (xs - u[..., None]) / sigma
        dys = (ys - v[..., None]) / sigma
        env = torch.exp(-(dxs ** 2 + dys ** 2) / 4.0)
        patch = 0.5 * (torch.tanh(2.0 * dxs) * torch.tanh(2.0 * dys) + 1.0) * env
        patch = patch * inten[None, :, None] * ok[..., None]
        idx = (ys.clamp(0, H - 1) * W + xs.clamp(0, W - 1)).long()
        img = torch.zeros((len(R), H * W), dtype=torch.float32, device=device)
        img.scatter_add_(1, idx.reshape(len(R), -1), patch.reshape(len(R), -1))
        out.append(img.reshape(len(R), H, W).clamp_(0.0, 1.0))
    return torch.cat(out)


def to_u8(img: torch.Tensor, rounding: str = "floor") -> torch.Tensor:
    """[0, 1] floats -> uint8, by truncation (the EuRoC writers) or by
    rounding."""
    x = img * 255.0
    x = torch.floor(x) if rounding == "floor" else torch.round(x)
    return x.clamp_(0, 255).to(torch.uint8)


class Fisheye(NamedTuple):
    """Kannala-Brandt (equidistant) fisheye: theta * (1 + k2 theta^2 +
    k3 theta^4 + k4 theta^6 + k5 theta^8) is the distance from the
    principal point in focal units."""
    fx: float
    fy: float
    cx: float
    cy: float
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0


def kb_poly(theta, p: Fisheye):
    t2 = theta * theta
    return theta * (1 + t2 * (p.k2 + t2 * (p.k3 + t2 * (p.k4 + t2 * p.k5))))


def kb_lift(uv: torch.Tensor, p: Fisheye, iters: int = 10) -> torch.Tensor:
    """Pixels [..., 2] -> unit rays [..., 3] (Newton on the polynomial)."""
    mx = (uv[..., 0] - p.cx) / p.fx
    my = (uv[..., 1] - p.cy) / p.fy
    d = torch.sqrt(mx * mx + my * my)
    theta = d
    for _ in range(iters):
        t2 = theta * theta
        f = kb_poly(theta, p) - d
        df = 1 + t2 * (3 * p.k2 + t2 * (5 * p.k3 + t2 * (7 * p.k4 + t2 * 9 * p.k5)))
        theta = theta - f / torch.clamp_min(df, 1e-9)
    safe_d = torch.clamp_min(d, 1e-9)
    s = torch.sin(theta)
    ray = torch.stack([s * mx / safe_d, s * my / safe_d, torch.cos(theta)], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def kb_project(pts: torch.Tensor, p: Fisheye):
    """Camera-frame points [..., 3] -> (pixels [..., 2], valid)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = torch.sqrt(x * x + y * y)
    d = kb_poly(torch.atan2(r, z), p)
    safe_r = torch.clamp_min(r, 1e-9)
    uv = torch.stack([p.fx * d * x / safe_r + p.cx, p.fy * d * y / safe_r + p.cy], dim=-1)
    return uv, ~((r < 1e-9) & (z <= 0))


def wall_texture(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """[n, 64, 512] random textures, each smoothed by a 5 x 5 box that
    wraps at the edges."""
    tex = torch.rand((n, 1, 64, 512), generator=gen, device=device)
    tex = F.pad(tex, (2, 2, 2, 2), mode="circular")
    return F.avg_pool2d(tex, 5, stride=1)[:, 0]


def cylinder_wall(fisheyes, T_body_cam: np.ndarray, hw, textures: torch.Tensor,
                  r_wall: float = 5.0) -> torch.Tensor:
    """[F, C, Hf, Wf] float32 views of a cylinder wall (axis along the
    body y axis, radius ``r_wall``) carrying texture f in frame f,
    through the C fisheyes at ``T_body_cam`` [C, 7]."""
    Hf, Wf = hw
    dev = textures.device
    ys, xs = torch.meshgrid(torch.arange(Hf, dtype=torch.float32, device=dev),
                            torch.arange(Wf, dtype=torch.float32, device=dev), indexing="ij")
    uv = torch.stack([xs, ys], -1).reshape(-1, 2)
    flat = []
    for cam, T in zip(fisheyes, np.asarray(T_body_cam, np.float64)):
        R = torch.as_tensor(quat_to_rotmat(T[3:]), dtype=torch.float32, device=dev)
        c = torch.as_tensor(T[:3], dtype=torch.float32, device=dev)
        rays = kb_lift(uv, cam) @ R.T
        dx, dz = rays[:, 0], rays[:, 2]
        a = dx * dx + dz * dz
        b = 2 * (c[0] * dx + c[2] * dz)
        cc = c[0] ** 2 + c[2] ** 2 - r_wall ** 2
        t = (-b + torch.sqrt(torch.clamp_min(b * b - 4 * a * cc, 0.0))) / torch.clamp_min(2 * a, 1e-9)
        pts = c + rays * t[:, None]
        theta = torch.atan2(pts[:, 0], pts[:, 2])
        ui = ((theta + math.pi) / (2 * math.pi) * 512).long() % 512
        vi = torch.clamp(((pts[:, 1] + 2.0) / 4.0 * 64).long(), 0, 63)
        flat.append(vi * 512 + ui)
    idx = torch.stack(flat)                                      # [C, Hf*Wf]
    tex = textures.reshape(len(textures), -1)
    return tex[:, idx].reshape(len(textures), len(flat), Hf, Wf)
