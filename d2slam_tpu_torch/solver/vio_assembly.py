"""Per-factor linearization helpers and the landmark-free row blocks.

Counterpart of the parts of ``d2slam_tpu/solver/vio_assembly.py`` that
the normal-equation assembly uses: the unified projection residual,
the Huber weighting, the IMU rows and the prior rows. Jacobians come
from ``torch.func.jacrev`` of each factor under ``torch.func.vmap``, as
the JAX package uses ``jax.jacrev`` under ``vmap``. Where the JAX code
places blocks with one-hot matmuls (a TPU workaround for serializing
scatters), this module indexes and scatters directly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacrev, vmap

from d2slam_tpu_torch.factors.residuals import imu_residual
from d2slam_tpu_torch.geometry.lie import (
    pose_boxminus,
    pose_boxplus,
    quat_conj,
    quat_normalize,
    quat_rotate,
)
from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.state import ImuMeas, PriorBlock, VIOState


class RowBlock(NamedTuple):
    """Weighted rows of a landmark-free factor group.

    J: [N, D_pad]; r: [N]; cost: [N] robust cost contribution.
    """

    J: torch.Tensor
    r: torch.Tensor
    cost: torch.Tensor


def _huber_weight(sq_norm, delta):
    """sqrt(rho'(s)) for Huber, and rho(s) (Ceres HuberLoss semantics:
    rho(s)=s for s<=d^2, else 2 d sqrt(s) - d^2)."""
    d2 = delta * delta
    big = sq_norm > d2
    safe = torch.clamp_min(sq_norm, 1e-18)
    w = torch.where(big, torch.sqrt(d2 / safe), torch.ones_like(sq_norm))
    rho = torch.where(big, 2.0 * delta * torch.sqrt(safe) - d2, sq_norm)
    return torch.sqrt(w), rho


def _proj_residual_unified(pose_i, pose_j, ext_i, ext_j, inv_dep, td, m):
    """3-row unified projection residual [tangent(2), depth(1)] covering
    the reference's four projection kinds (see ProjMeas)."""
    pts_i_td = m["ray_i"] - (td - m["td_i"]) * m["vel_i"]
    pts_j_td = m["ray_j"] - (td - m["td_j"]) * m["vel_j"]
    pts_cam_i = pts_i_td / torch.clamp_min(inv_dep, 1e-6)
    pts_imu_i = quat_rotate(ext_i[3:], pts_cam_i) + ext_i[:3]
    pts_w = quat_rotate(pose_i[3:], pts_imu_i) + pose_i[:3]
    pts_imu_j = quat_rotate(quat_conj(quat_normalize(pose_j[3:])), pts_w - pose_j[:3])
    pts_cam_j = quat_rotate(quat_conj(quat_normalize(ext_j[3:])), pts_imu_j - ext_j[:3])

    norm_j = torch.linalg.norm(pts_cam_j)
    pred = pts_cam_j / torch.clamp_min(norm_j, 1e-12)
    obs = pts_j_td / torch.clamp_min(torch.linalg.norm(pts_j_td), 1e-12)
    r2 = m["tb"] @ (pred - obs)
    r_dep = norm_j - m["dep_j"]
    return torch.cat([r2, r_dep[None]])


def _tangent_base(ray):
    """2x3 tangent basis at a ray (one ray; vmap for batches)."""
    a = ray / torch.clamp_min(torch.linalg.norm(ray), 1e-12)
    tmp = torch.where(
        torch.abs(a[2]) > 0.999,
        torch.tensor([1.0, 0.0, 0.0], dtype=ray.dtype, device=ray.device),
        torch.tensor([0.0, 0.0, 1.0], dtype=ray.dtype, device=ray.device),
    )
    b1 = tmp - a * torch.dot(a, tmp)
    b1 = b1 / torch.clamp_min(torch.linalg.norm(b1), 1e-12)
    b2 = torch.linalg.cross(a, b1, dim=-1)
    return torch.stack([b1, b2])


def place_cols(J, col0, D):
    """Scatter per-factor blocks J [K, R, k] at column offsets
    ``col0`` [K] into dense rows [K, R, D] (coincident blocks sum)."""
    K, R, k = J.shape
    cols = col0[:, None] + torch.arange(k, device=J.device)[None, :]
    out = torch.zeros((K, R, D), dtype=J.dtype, device=J.device)
    return out.scatter_add_(2, cols[:, None, :].expand(K, R, k), J)


# ---------------------------------------------------------------------------
# IMU rows
# ---------------------------------------------------------------------------


def _imu_linearize_one(pose_i, sb_i, pose_j, sb_j, pre, gravity):
    def f(d_pi, d_si, d_pj, d_sj):
        r = imu_residual(
            pose_boxplus(pose_i, d_pi), sb_i + d_si,
            pose_boxplus(pose_j, d_pj), sb_j + d_sj,
            pre, gravity,
        )
        return r, r

    z6 = pose_i.new_zeros(6)
    z9 = pose_i.new_zeros(9)
    jac, r = jacrev(f, argnums=(0, 1, 2, 3), has_aux=True)(z6, z9, z6, z9)
    return (r,) + jac


def build_imu_rows(layout: VIOLayout, state: VIOState, imu: ImuMeas,
                   gravity) -> RowBlock:
    D = layout.D_pad
    fi, fj = imu.frame_i, imu.frame_j
    r, J_pi, J_si, J_pj, J_sj = vmap(
        _imu_linearize_one, in_dims=(0, 0, 0, 0, 0, None)
    )(state.poses[fi], state.sb[fi], state.poses[fj], state.sb[fj],
      imu.pre, gravity)

    S = imu.sqrt_info
    r_w = (S @ r[..., None])[..., 0]
    Ji = S @ torch.cat([J_pi, J_si], dim=2)  # [K, 15, 15]
    Jj = S @ torch.cat([J_pj, J_sj], dim=2)
    rows = place_cols(Ji, 15 * fi, D) + place_cols(Jj, 15 * fj, D)

    valid = imu.valid & state.frame_valid[fi] & state.frame_valid[fj]
    w = valid.to(r.dtype)[:, None]
    N = fi.shape[0] * 15
    r_w = r_w * w
    return RowBlock(
        J=(rows * w[:, :, None]).reshape(N, D),
        r=r_w.reshape(N),
        cost=0.5 * (r_w ** 2).reshape(N),
    )


# ---------------------------------------------------------------------------
# Prior rows
# ---------------------------------------------------------------------------


def state_boxminus(layout: VIOLayout, a: VIOState, b: VIOState) -> torch.Tensor:
    """Blockwise tangent difference a [-] b in the solver column layout
    (landmarks excluded), shape [D_pad]."""
    W, C = layout.W, layout.C
    dx = a.poses.new_zeros(layout.D_pad)
    dposes = pose_boxminus(a.poses, b.poses)  # [W, 6]
    dx[: 15 * W] = torch.cat([dposes, a.sb - b.sb], dim=-1).reshape(-1)
    dx[15 * W: 15 * W + 6 * C] = pose_boxminus(a.ext, b.ext).reshape(-1)
    dx[layout.td_col] = a.td - b.td
    return dx


def build_prior_rows(layout: VIOLayout, state: VIOState,
                     prior: PriorBlock) -> RowBlock:
    dx = state_boxminus(layout, state, prior.lin)
    r = prior.r + prior.J @ dx
    w = prior.row_valid.to(r.dtype)
    r_w = r * w
    return RowBlock(J=prior.J * w[:, None], r=r_w, cost=0.5 * r_w ** 2)
