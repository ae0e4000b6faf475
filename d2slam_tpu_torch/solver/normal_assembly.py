"""Direct block-sparse assembly of the VIO normal equations.

Counterpart of ``d2slam_tpu/solver/normal_assembly.py``: the same sums
as forming H = rows^T rows over dense rows, without materializing the
[N, D] projection rows.

* Each projection measurement is linearized (``jacrev`` under ``vmap``)
  into a compact [3, 25] Jacobian over its five touched blocks
  (pose_i 6 | pose_j 6 | ext_i 6 | ext_j 6 | td 1) plus one landmark
  column.
* The compact Jacobians scatter into [3M, G] rows over the pose-only
  column space G = 6W + 6C + 1; H_G = J_G^T J_G is one GEMM, embedded
  into the global interleaved [D, D] layout by index (``compact_cols``).
* Landmark couplings (hll, gl, Hpl) are segment sums over the landmark
  slot (``index_add_``); Hpl stays in the compact G layout.

Reference semantics: Ceres CRS + Schur ordering
(d2vins/src/estimator/marginalization/marginalization.cpp:17-76);
unit-sphere + td projection factors
(d2vins/src/factors/projectionTwoFrameOneCamFactor.cpp:34-120).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacrev, vmap

from d2slam_tpu_torch.geometry.lie import pose_boxplus
from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.state import ImuMeas, PriorBlock, ProjMeas, VIOState
from d2slam_tpu_torch.solver.vio_assembly import (
    RowBlock,
    _huber_weight,
    _proj_residual_unified,
    _tangent_base,
    build_imu_rows,
    build_prior_rows,
)


class Normal(NamedTuple):
    """Normal equations of the window, inverse-depth landmarks kept
    separate: H [D, D]; g [D]; cost []; hll [L]; gl [L]; Hpl [L, G] in
    the compact pose space (see ``compact_cols``)."""

    H: torch.Tensor
    g: torch.Tensor
    hll: torch.Tensor
    gl: torch.Tensor
    Hpl: torch.Tensor
    cost: torch.Tensor


def compact_cols(layout: VIOLayout, device=None) -> torch.Tensor:
    """[G] global column of each compact pose-space column
    (6W poses | 6C ext | td) — the index form of the JAX package's
    one-hot ``compact_placement``."""
    cols = [15 * w + u for w in range(layout.W) for u in range(6)]
    cols += [layout.ext_col(c) + u for c in range(layout.C) for u in range(6)]
    cols.append(layout.td_col)
    return torch.tensor(cols, dtype=torch.long, device=device)


def embed_cols(x, cols, D):
    """Scatter the last dimension of ``x`` (compact G) into D columns."""
    out = x.new_zeros(x.shape[:-1] + (D,))
    out[..., cols] = x
    return out


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


def build_proj_normal(
    layout: VIOLayout,
    state: VIOState,
    meas: ProjMeas,
    proj_sqrt_info: float,
    dep_sqrt_info: float,
    huber_delta: float,
) -> Normal:
    """Projection factors' contribution to the normal equations."""
    dtype = state.poses.dtype
    W, C, L, D = layout.W, layout.C, layout.L, layout.D_pad
    G = 6 * W + 6 * C + 1
    fi, fj, ci, cj, lm = (meas.frame_i, meas.frame_j,
                          meas.cam_i, meas.cam_j, meas.lm)

    m_data = {
        "ray_i": meas.ray_i, "ray_j": meas.ray_j,
        "vel_i": meas.vel_i, "vel_j": meas.vel_j,
        "td_i": meas.td_i, "td_j": meas.td_j,
        "dep_j": meas.dep_j, "tb": vmap(_tangent_base)(meas.ray_j),
    }
    r, Jm, Jl = vmap(
        _proj_linearize_one, in_dims=(0, 0, 0, 0, 0, None, 0)
    )(state.poses[fi], state.poses[fj], state.ext[ci], state.ext[cj],
      state.inv_dep[lm], state.td, m_data)  # r [M,3], Jm [M,3,25], Jl [M,3]

    valid = (meas.valid & state.lm_valid[lm]
             & state.frame_valid[fi] & state.frame_valid[fj])
    validf = valid.to(dtype)
    has_dep = meas.has_dep.to(dtype)
    w2, w3 = proj_sqrt_info, dep_sqrt_info

    sq = torch.sum((w2 * r[:, :2]) ** 2, dim=-1)
    hw, rho = _huber_weight(sq, huber_delta)
    row_w = torch.stack([hw * w2, hw * w2, w3 * has_dep], dim=-1) * validf[:, None]
    dep_cost = (w3 * r[:, 2]) ** 2 * has_dep
    cost = torch.sum((0.5 * rho + 0.5 * dep_cost) * validf)

    Jm_w = Jm * row_w[:, :, None]       # [M, 3, 25]
    r_w = r * row_w                     # [M, 3]
    Jl_w = Jl * row_w                   # [M, 3]

    # compact [M, 3, G] rows: each block lands at its slot's columns
    M_ = Jm.shape[0]
    ar6 = torch.arange(6, device=fi.device)
    col = torch.cat([
        (6 * fi)[:, None] + ar6,
        (6 * fj)[:, None] + ar6,
        (6 * W + 6 * ci)[:, None] + ar6,
        (6 * W + 6 * cj)[:, None] + ar6,
        torch.full((M_, 1), G - 1, dtype=fi.dtype, device=fi.device),
    ], dim=1)  # [M, 25]
    J79m = torch.zeros((M_, 3, G), dtype=dtype, device=fi.device)
    J79m.scatter_add_(2, col[:, None, :].expand(M_, 3, 25), Jm_w)
    J79 = J79m.reshape(M_ * 3, G)

    H79 = J79.T @ J79
    g79 = J79.T @ r_w.reshape(M_ * 3)
    cols = compact_cols(layout, fi.device)
    H = torch.zeros((D, D), dtype=dtype, device=fi.device)
    H[cols[:, None], cols[None, :]] = H79
    g = embed_cols(g79, cols, D)

    # landmark couplings: contract the 3 residual rows per measurement
    # first, then segment-sum by landmark slot
    hpvec = torch.einsum("mr,mrg->mg", Jl_w, J79m)   # [M, G]
    hll = r.new_zeros(L).index_add_(0, lm, torch.sum(Jl_w * Jl_w, dim=-1))
    gl = r.new_zeros(L).index_add_(0, lm, torch.sum(Jl_w * r_w, dim=-1))
    Hpl = r.new_zeros((L, G)).index_add_(0, lm, hpvec)
    return Normal(H=H, g=g, hll=hll, gl=gl, Hpl=Hpl, cost=cost)


def fold_rows(n: Normal, rb: RowBlock) -> Normal:
    """Add a landmark-free row block (IMU, prior) as rows^T rows."""
    return n._replace(
        H=n.H + rb.J.T @ rb.J,
        g=n.g + rb.J.T @ rb.r,
        cost=n.cost + torch.sum(rb.cost),
    )


def build_window_normal(
    layout: VIOLayout,
    state: VIOState,
    imu: ImuMeas,
    proj: ProjMeas,
    prior: Optional[PriorBlock],
    *,
    gravity,
    proj_sqrt_info: float,
    dep_sqrt_info: float,
    huber_delta: float,
    landmark_param: str = "inv_dep",
) -> Normal:
    """Full window: projection + IMU + prior normal equations."""
    if landmark_param != "inv_dep":
        raise NotImplementedError(
            "landmark_param='pos3d' is not ported yet (see ROADMAP.md)")
    n = build_proj_normal(layout, state, proj, proj_sqrt_info,
                          dep_sqrt_info, huber_delta)
    n = fold_rows(n, build_imu_rows(layout, state, imu, gravity))
    if prior is not None:
        n = fold_rows(n, build_prior_rows(layout, state, prior))
    return n
