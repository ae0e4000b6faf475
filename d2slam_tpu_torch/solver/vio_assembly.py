"""Per-factor linearization helpers and dense row blocks.

Counterpart of ``d2slam_tpu/solver/vio_assembly.py``: the unified
projection residual and the pos3d one, the Huber weighting, the IMU
rows and the prior rows that the normal-equation assembly folds in, and
the dense projection rows (``build_proj_rows``, ``build_proj_rows_pos3d``,
``assemble_full_rows``) that serve as the independent check of both
normal assemblies. Jacobians come
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
from d2slam_tpu_torch.solver.state import ImuMeas, PriorBlock, ProjMeas, VIOState


class RowBlock(NamedTuple):
    """Weighted rows of the linearized system.

    J: [N, D_pad]; r: [N]; cost: [N] robust cost contribution. Rows of
    projection factors also carry their landmark column: Jl [N] (inverse
    depth) or [N, 3] (pos3d), lm [N] landmark slot, lm_used [N] bool;
    landmark-free groups (IMU, prior) leave them None.
    """

    J: torch.Tensor
    r: torch.Tensor
    cost: torch.Tensor
    Jl: torch.Tensor = None
    lm: torch.Tensor = None
    lm_used: torch.Tensor = None


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


def _proj_linearize_one(pose_i, pose_j, ext_i, ext_j, inv_dep, td, m):
    def f(d_pi, d_pj, d_ei, d_ej, d_l, d_td):
        r = _proj_residual_unified(
            pose_boxplus(pose_i, d_pi),
            pose_boxplus(pose_j, d_pj),
            pose_boxplus(ext_i, d_ei),
            pose_boxplus(ext_j, d_ej),
            inv_dep + d_l[0],
            td + d_td[0],
            m,
        )
        return r, r

    z6 = pose_i.new_zeros(6)
    z1 = pose_i.new_zeros(1)
    (J_pi, J_pj, J_ei, J_ej, J_l, J_td), r = jacrev(
        f, argnums=(0, 1, 2, 3, 4, 5), has_aux=True
    )(z6, z6, z6, z6, z1, z1)
    Jm = torch.cat([J_pi, J_pj, J_ei, J_ej, J_td], dim=1)  # [3, 25]
    return r, Jm, J_l[:, 0]


def _pos3d_residual(pose_j, ext_j, p, td, m):
    """3-row residual [tangent(2), depth(1)] of a world point ``p``
    seen from one camera (reference reprojection3d.h)."""
    pts_j_td = m["ray_j"] - (td - m["td_j"]) * m["vel_j"]
    pts_imu_j = quat_rotate(quat_conj(quat_normalize(pose_j[3:])), p - pose_j[:3])
    pts_cam_j = quat_rotate(quat_conj(quat_normalize(ext_j[3:])), pts_imu_j - ext_j[:3])
    norm_j = torch.linalg.norm(pts_cam_j)
    pred = pts_cam_j / torch.clamp_min(norm_j, 1e-12)
    obs = pts_j_td / torch.clamp_min(torch.linalg.norm(pts_j_td), 1e-12)
    r2 = m["tb"] @ (pred - obs)
    return torch.cat([r2, (norm_j - m["dep_j"])[None]])


def _pos3d_linearize_one(pose_j, ext_j, pw, td, m):
    def f(d_pj, d_ej, d_l, d_td):
        r = _pos3d_residual(pose_boxplus(pose_j, d_pj),
                            pose_boxplus(ext_j, d_ej), pw + d_l,
                            td + d_td[0], m)
        return r, r

    z6 = pose_j.new_zeros(6)
    (J_pj, J_ej, J_l, J_td), r = jacrev(
        f, argnums=(0, 1, 2, 3), has_aux=True
    )(z6, z6, pose_j.new_zeros(3), pose_j.new_zeros(1))
    return r, torch.cat([J_pj, J_ej, J_td], dim=1), J_l  # [3], [3, 13], [3, 3]


def _proj_row_weights(r, valid, has_dep, proj_sqrt_info, dep_sqrt_info,
                      huber_delta):
    """Per-row weights [M, 3] and per-row costs [M, 3] of projection
    residuals r [M, 3] (Huber on the weighted 2-dof part)."""
    dtype = r.dtype
    validf = valid.to(dtype)[:, None]
    has_dep = has_dep.to(dtype)
    w2, w3 = proj_sqrt_info, dep_sqrt_info
    hw, rho = _huber_weight(torch.sum((w2 * r[:, :2]) ** 2, dim=-1), huber_delta)
    row_w = torch.stack([hw * w2, hw * w2, w3 * has_dep], dim=-1) * validf
    cost3 = torch.stack([0.5 * rho, torch.zeros_like(rho),
                         0.5 * (w3 * r[:, 2]) ** 2 * has_dep], dim=-1) * validf
    return row_w, cost3


def _scatter_rows(Jm, cols, D):
    """Blocks Jm [M, R, k] at global columns ``cols`` [M, k] into dense
    rows [M, R, D] (coincident columns sum)."""
    M_, R, k = Jm.shape
    out = torch.zeros((M_, R, D), dtype=Jm.dtype, device=Jm.device)
    return out.scatter_add_(2, cols[:, None, :].expand(M_, R, k), Jm)


def build_proj_rows(layout: VIOLayout, state: VIOState, meas: ProjMeas,
                    proj_sqrt_info: float, dep_sqrt_info: float,
                    huber_delta: float) -> RowBlock:
    """All projection measurements (inverse-depth landmarks) as dense
    weighted rows [3M, D_pad] with their landmark column."""
    D, W = layout.D_pad, layout.W
    fi, fj, ci, cj, lm = (meas.frame_i, meas.frame_j,
                          meas.cam_i, meas.cam_j, meas.lm)
    m_data = {
        "ray_i": meas.ray_i, "ray_j": meas.ray_j,
        "vel_i": meas.vel_i, "vel_j": meas.vel_j,
        "td_i": meas.td_i, "td_j": meas.td_j,
        "dep_j": meas.dep_j, "tb": vmap(_tangent_base)(meas.ray_j),
    }
    r, Jm, Jl = vmap(_proj_linearize_one, in_dims=(0, 0, 0, 0, 0, None, 0))(
        state.poses[fi], state.poses[fj], state.ext[ci], state.ext[cj],
        state.inv_dep[lm], state.td, m_data)
    valid = (meas.valid & state.lm_valid[lm]
             & state.frame_valid[fi] & state.frame_valid[fj])
    row_w, cost3 = _proj_row_weights(r, valid, meas.has_dep, proj_sqrt_info,
                                     dep_sqrt_info, huber_delta)
    ar6 = torch.arange(6, device=fi.device)
    ext0 = 15 * W
    cols = torch.cat([
        (15 * fi)[:, None] + ar6, (15 * fj)[:, None] + ar6,
        (ext0 + 6 * ci)[:, None] + ar6, (ext0 + 6 * cj)[:, None] + ar6,
        torch.full_like(fi[:, None], layout.td_col),
    ], dim=1)  # [M, 25]
    N = fi.shape[0] * 3
    return RowBlock(
        J=_scatter_rows(Jm * row_w[:, :, None], cols, D).reshape(N, D),
        r=(r * row_w).reshape(N),
        cost=cost3.reshape(N),
        Jl=(Jl * row_w).reshape(N),
        lm=torch.repeat_interleave(lm, 3),
        lm_used=torch.repeat_interleave(valid, 3),
    )


def build_proj_rows_pos3d(layout: VIOLayout, state: VIOState, meas: ProjMeas,
                          proj_sqrt_info: float, dep_sqrt_info: float,
                          huber_delta: float) -> RowBlock:
    """Projection rows for 3-dof world-position landmarks (reference
    landmark_param LM_POS, factors/reprojection3d.h): each observation,
    the anchor's included, is a residual of (pose_j, ext_j, lm_pos);
    frame_i / ray_i are ignored. Jl is [N, 3]."""
    D, W = layout.D_pad, layout.W
    fj, cj, lm = meas.frame_j, meas.cam_j, meas.lm
    m_data = {
        "ray_j": meas.ray_j, "vel_j": meas.vel_j, "td_j": meas.td_j,
        "dep_j": meas.dep_j, "tb": vmap(_tangent_base)(meas.ray_j),
    }
    r, Jm, Jl = vmap(_pos3d_linearize_one, in_dims=(0, 0, 0, None, 0))(
        state.poses[fj], state.ext[cj], state.lm_pos[lm], state.td, m_data)
    valid = meas.valid & state.lm_valid[lm] & state.frame_valid[fj]
    row_w, cost3 = _proj_row_weights(r, valid, meas.has_dep, proj_sqrt_info,
                                     dep_sqrt_info, huber_delta)
    ar6 = torch.arange(6, device=fj.device)
    cols = torch.cat([
        (15 * fj)[:, None] + ar6, (15 * W + 6 * cj)[:, None] + ar6,
        torch.full_like(fj[:, None], layout.td_col),
    ], dim=1)  # [M, 13]
    N = fj.shape[0] * 3
    return RowBlock(
        J=_scatter_rows(Jm * row_w[:, :, None], cols, D).reshape(N, D),
        r=(r * row_w).reshape(N),
        cost=cost3.reshape(N),
        Jl=(Jl * row_w[:, :, None]).reshape(N, 3),
        lm=torch.repeat_interleave(lm, 3),
        lm_used=torch.repeat_interleave(valid, 3),
    )


def assemble_full_rows(blocks) -> RowBlock:
    """Concatenate row blocks; landmark-free blocks get zero landmark
    columns ([N], or [N, 3] when a block carries pos3d columns)."""
    pos3d = any(b.Jl is not None and b.Jl.ndim == 2 for b in blocks)

    def lm_cols(b):
        n = b.r.shape[0]
        if b.Jl is not None:
            return b.Jl, b.lm, b.lm_used
        shape = (n, 3) if pos3d else (n,)
        return (b.r.new_zeros(shape),
                torch.zeros(n, dtype=torch.long, device=b.r.device),
                torch.zeros(n, dtype=torch.bool, device=b.r.device))

    Jl, lm, used = zip(*(lm_cols(b) for b in blocks))
    return RowBlock(
        J=torch.cat([b.J for b in blocks]), r=torch.cat([b.r for b in blocks]),
        cost=torch.cat([b.cost for b in blocks]),
        Jl=torch.cat(Jl), lm=torch.cat(lm), lm_used=torch.cat(used),
    )


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
