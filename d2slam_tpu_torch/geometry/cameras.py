"""Camera models with batched project (space->plane) and lift
(plane->ray) on torch tensors.

Counterpart of ``d2slam_tpu/geometry/cameras.py`` (reference camodocal
fork, camera_models/include/camodocal/camera_models/*.h): pinhole with
plumb-bob distortion, Kannala-Brandt equidistant fisheye, MEI unified
catadioptric, the 8-parameter pinhole, cylindrical, Scaramuzza's
omnidirectional polynomial and the forward-polynomial fisheye. Pure
functions over [..., 3] points and [..., 2] pixels; iterative inversions
run a fixed number of steps.

Conventions: camera frame z forward; pixel coords (u, v). Intrinsics are
host floats: they are configuration, not state. The tensors' dtype and
device are those of the points or pixels given.
"""
from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# Kannala-Brandt equidistant fisheye (reference EquidistantCamera)
# ---------------------------------------------------------------------------


class KBParams(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k2: float = 0.0  # theta^3 coefficient (camodocal naming k2..k5)
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0

    @staticmethod
    def make(fx, fy, cx, cy, k2=0.0, k3=0.0, k4=0.0, k5=0.0):
        return KBParams(*[float(v) for v in (fx, fy, cx, cy, k2, k3, k4, k5)])


def _kb_theta_poly(theta, p: KBParams):
    t2 = theta * theta
    return theta * (1 + t2 * (p.k2 + t2 * (p.k3 + t2 * (p.k4 + t2 * p.k5))))


def kb_project(pts3, params: KBParams):
    x, y, z = pts3[..., 0], pts3[..., 1], pts3[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    d = _kb_theta_poly(theta, params)
    safe_r = torch.clamp_min(r, 1e-9)
    u = params.fx * d * x / safe_r + params.cx
    v = params.fy * d * y / safe_r + params.cy
    # valid everywhere except points at the optical center behind camera
    valid = ~((r < 1e-9) & (z <= 0))
    return torch.stack([u, v], dim=-1), valid


def kb_lift(uv, params: KBParams, iters: int = 10):
    """Invert the theta polynomial by Newton iterations
    (reference EquidistantCamera::backprojectSymmetric)."""
    mx = (uv[..., 0] - params.cx) / params.fx
    my = (uv[..., 1] - params.cy) / params.fy
    d = torch.sqrt(mx * mx + my * my)
    theta = d
    for _ in range(iters):
        t2 = theta * theta
        f = _kb_theta_poly(theta, params) - d
        df = 1 + t2 * (3 * params.k2 + t2 * (5 * params.k3 + t2 * (
            7 * params.k4 + t2 * 9 * params.k5)))
        theta = theta - f / torch.clamp_min(df, 1e-9)
    safe_d = torch.clamp_min(d, 1e-9)
    sin_t = torch.sin(theta)
    ray = torch.stack(
        [sin_t * mx / safe_d, sin_t * my / safe_d, torch.cos(theta)], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# MEI / unified catadioptric model (reference CataCamera)
# ---------------------------------------------------------------------------


class MEIParams(NamedTuple):
    xi: float  # mirror parameter
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @staticmethod
    def make(xi, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0):
        return MEIParams(*[float(v) for v in
                           (xi, fx, fy, cx, cy, k1, k2, p1, p2)])


def _mei_pinhole(params: MEIParams) -> PinholeParams:
    return PinholeParams(params.fx, params.fy, params.cx, params.cy,
                         params.k1, params.k2, params.p1, params.p2)


def mei_project(pts3, params: MEIParams):
    """Unified sphere projection + distortion (reference
    CataCamera::spaceToPlane)."""
    norm = torch.linalg.norm(pts3, dim=-1)
    z = pts3[..., 2] + params.xi * norm
    valid = z > 1e-6
    zs = torch.where(valid, z, torch.ones_like(z))
    p = pts3[..., :2] / zs[..., None]
    pd = _distort(p, _mei_pinhole(params))
    u = params.fx * pd[..., 0] + params.cx
    v = params.fy * pd[..., 1] + params.cy
    return torch.stack([u, v], dim=-1), valid


def mei_lift(uv, params: MEIParams, iters: int = 20):
    """reference CataCamera::liftProjective: undistort, then invert the
    sphere projection."""
    mx = (uv[..., 0] - params.cx) / params.fx
    my = (uv[..., 1] - params.cy) / params.fy
    target = torch.stack([mx, my], dim=-1)
    pp = _mei_pinhole(params)
    p = target
    for _ in range(iters):
        p = target - (_distort(p, pp) - p)
    mx, my = p[..., 0], p[..., 1]
    rho2 = mx * mx + my * my
    xi = params.xi
    # z for the unit-sphere point (camodocal formula)
    disc = torch.clamp_min(1.0 + (1.0 - xi * xi) * rho2, 0.0)
    factor = (xi + torch.sqrt(disc)) / (1.0 + rho2)
    ray = torch.stack([factor * mx, factor * my, factor - xi], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# PinholeFull (8-parameter plumb bob: k1..k6, p1, p2; reference
# PinholeFullCamera)
# ---------------------------------------------------------------------------


class PinholeFullParams(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    k6: float = 0.0

    @staticmethod
    def make(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
             k3=0.0, k4=0.0, k5=0.0, k6=0.0):
        return PinholeFullParams(*[float(v) for v in
                                   (fx, fy, cx, cy, k1, k2, p1, p2,
                                    k3, k4, k5, k6)])


def _distort_full(p, c: PinholeFullParams):
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    num = 1 + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3))
    den = 1 + r2 * (c.k4 + r2 * (c.k5 + r2 * c.k6))
    rad = num / den
    xd = x * rad + 2 * c.p1 * x * y + c.p2 * (r2 + 2 * x * x)
    yd = y * rad + c.p1 * (r2 + 2 * y * y) + 2 * c.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def pinhole_full_project(pts3, params: PinholeFullParams):
    z = pts3[..., 2]
    valid = z > 1e-6
    zs = torch.where(valid, z, torch.ones_like(z))
    p = pts3[..., :2] / zs[..., None]
    pd = _distort_full(p, params)
    u = params.fx * pd[..., 0] + params.cx
    v = params.fy * pd[..., 1] + params.cy
    return torch.stack([u, v], dim=-1), valid


def pinhole_full_lift(uv, params: PinholeFullParams, iters: int = 25):
    mx = (uv[..., 0] - params.cx) / params.fx
    my = (uv[..., 1] - params.cy) / params.fy
    target = torch.stack([mx, my], dim=-1)
    p = target
    for _ in range(iters):
        p = target - (_distort_full(p, params) - p)
    ray = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Cylindrical projection (reference CylindricalCamera; the panoramic
# virtual view of an undistorted fisheye)
# ---------------------------------------------------------------------------


class CylindricalParams(NamedTuple):
    fx: float  # radians->px horizontally
    fy: float
    cx: float
    cy: float

    @staticmethod
    def make(fx, fy, cx, cy):
        return CylindricalParams(*[float(v) for v in (fx, fy, cx, cy)])


def cylindrical_project(pts3, params: CylindricalParams):
    """u = fx * atan2(x, z); v = fy * y / sqrt(x^2 + z^2)."""
    x, y, z = pts3[..., 0], pts3[..., 1], pts3[..., 2]
    rho = torch.sqrt(x * x + z * z)
    u = params.fx * torch.atan2(x, z) + params.cx
    v = params.fy * y / torch.clamp_min(rho, 1e-9) + params.cy
    valid = rho > 1e-9
    return torch.stack([u, v], dim=-1), valid


def cylindrical_lift(uv, params: CylindricalParams):
    theta = (uv[..., 0] - params.cx) / params.fx
    h = (uv[..., 1] - params.cy) / params.fy
    ray = torch.stack([torch.sin(theta), h, torch.cos(theta)], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Scaramuzza omnidirectional polynomial model (reference
# ScaramuzzaCamera / OCamCalib convention)
# ---------------------------------------------------------------------------


class ScaramuzzaParams(NamedTuple):
    """Backward poly (lift): z = a0 + a2 rho^2 + a3 rho^3 + a4 rho^4
    with the OCam sign convention; affine [c d; e 1] + center."""

    a0: float
    a2: float
    a3: float
    a4: float
    c: float
    d: float
    e: float
    cx: float
    cy: float

    @staticmethod
    def make(a0, a2, a3, a4, cx, cy, c=1.0, d=0.0, e=0.0):
        return ScaramuzzaParams(*[float(v) for v in
                                  (a0, a2, a3, a4, c, d, e, cx, cy)])


def scaramuzza_lift(uv, params: ScaramuzzaParams):
    """OCamCalib cam2world: invert the affine, evaluate the poly."""
    up = uv[..., 0] - params.cx
    vp = uv[..., 1] - params.cy
    det = params.c - params.d * params.e
    xs = (up - params.d * vp) / det
    ys = (-params.e * up + params.c * vp) / det
    rho = torch.sqrt(xs * xs + ys * ys)
    z = params.a0 + rho * rho * (
        params.a2 + rho * (params.a3 + rho * params.a4))
    ray = torch.stack([xs, ys, -z], dim=-1)  # OCam z-axis convention
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def scaramuzza_project(pts3, params: ScaramuzzaParams, iters: int = 30):
    """world2cam by Newton inversion of rho(theta) (no stored forward
    poly needed)."""
    x, y, z = pts3[..., 0], pts3[..., 1], pts3[..., 2]
    r = torch.sqrt(x * x + y * y)
    safe_r = torch.clamp_min(r, 1e-9)
    # solve a0 + a2 rho^2 + a3 rho^3 + a4 rho^4 = -z/r * rho  for rho
    m = -z / safe_r
    rho = torch.full_like(m, 100.0)
    for _ in range(iters):
        f = (params.a0 + rho * rho * (params.a2 + rho * (params.a3
             + rho * params.a4))) - m * rho
        df = (2 * params.a2 * rho + 3 * params.a3 * rho * rho
              + 4 * params.a4 * rho**3) - m
        df = torch.where(df.abs() < 1e-9, torch.full_like(df, 1e-9), df)
        rho = torch.clamp(rho - f / df, 0.0, 2000.0)
    xs = x / safe_r * rho
    ys = y / safe_r * rho
    u = xs * params.c + ys * params.d + params.cx
    v = xs * params.e + ys + params.cy
    valid = r > 1e-9
    return torch.stack([u, v], dim=-1), valid


# ---------------------------------------------------------------------------
# Forward-polynomial fisheye (reference camodocal PolyFisheyeCamera)
# ---------------------------------------------------------------------------


class PolyFisheyeParams(NamedTuple):
    """r(theta) = theta + k2 theta^2 + ... + k7 theta^7,
    pixel = [A11 A12; 0 A22] r(theta)[cos phi, sin phi] + [u0, v0]
    (camera_models/src/camera_models/PolyFisheyeCamera.cc:93-137)."""

    k2: float
    k3: float
    k4: float
    k5: float
    k6: float
    k7: float
    p1: float     # tangential (kept for parity; the reference rarely uses)
    p2: float
    A11: float
    A12: float
    A22: float
    u0: float
    v0: float

    @staticmethod
    def make(A11, A22, u0, v0, k2=0.0, k3=0.0, k4=0.0, k5=0.0, k6=0.0,
             k7=0.0, p1=0.0, p2=0.0, A12=0.0):
        return PolyFisheyeParams(*[float(v) for v in
                                   (k2, k3, k4, k5, k6, k7, p1, p2,
                                    A11, A12, A22, u0, v0)])


def _polyfish_r(theta, p: PolyFisheyeParams):
    """r(theta) with coeff0=0, coeff1=1 (PolyFisheyeCamera.cc:24-25)."""
    return theta * (1.0 + theta * (p.k2 + theta * (p.k3 + theta * (
        p.k4 + theta * (p.k5 + theta * (p.k6 + theta * p.k7))))))


def _polyfish_dr(theta, p: PolyFisheyeParams):
    return (1.0 + theta * (2 * p.k2 + theta * (3 * p.k3 + theta * (
        4 * p.k4 + theta * (5 * p.k5 + theta * (6 * p.k6
        + theta * 7 * p.k7))))))


def polyfisheye_project(pts3, params: PolyFisheyeParams):
    """spaceToPlane: theta = acos(z/|P|), phi = atan2(y, x)."""
    x, y, z = pts3[..., 0], pts3[..., 1], pts3[..., 2]
    n = torch.sqrt(x * x + y * y + z * z)
    theta = torch.acos(torch.clamp(z / torch.clamp_min(n, 1e-12), -1.0, 1.0))
    phi = torch.atan2(y, x)
    r = _polyfish_r(theta, params)
    xd = r * torch.cos(phi)
    yd = r * torch.sin(phi)
    u = params.A11 * xd + params.A12 * yd + params.u0
    v = params.A22 * yd + params.v0
    valid = theta < math.pi / 2 * 1.1
    return torch.stack([u, v], dim=-1), valid


def polyfisheye_lift(uv, params: PolyFisheyeParams, iters: int = 12):
    """liftProjective: invert the affine, then Newton-solve
    r(theta) = r_meas (the reference uses a backward poly / lookup
    table, FastCalcTABLE)."""
    vd = (uv[..., 1] - params.v0) / params.A22
    xd = (uv[..., 0] - params.u0 - params.A12 * vd) / params.A11
    r_meas = torch.sqrt(xd * xd + vd * vd)
    phi = torch.atan2(vd, xd)
    theta = torch.clamp(r_meas, 0.0, math.pi)
    for _ in range(iters):
        f = _polyfish_r(theta, params) - r_meas
        df = _polyfish_dr(theta, params)
        df = torch.where(df.abs() < 1e-9, torch.full_like(df, 1e-9), df)
        theta = torch.clamp(theta - f / df, 0.0, math.pi)
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


PROJECT_OF = {
    PinholeParams: pinhole_project,
    KBParams: kb_project,
    MEIParams: mei_project,
    PinholeFullParams: pinhole_full_project,
    CylindricalParams: cylindrical_project,
    ScaramuzzaParams: scaramuzza_project,
    PolyFisheyeParams: polyfisheye_project,
}


def project(camera, pts3):
    """(pixels, valid) of camera-frame points for any parameter struct
    of this module, or for an object with a ``project`` method
    (``geometry.kalibr.KalibrCamera``)."""
    if hasattr(camera, "project"):
        return camera.project(pts3)
    return PROJECT_OF[type(camera)](pts3, camera)
