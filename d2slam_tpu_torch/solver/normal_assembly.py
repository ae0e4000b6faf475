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
* ``landmark_param="pos3d"`` (``build_proj_normal_pos3d``): every
  observation is a residual of (pose_j, ext_j, world point), compact
  blocks (pose_j 6 | ext_j 6 | td 1) and 3x3 landmark blocks.

Reference semantics: Ceres CRS + Schur ordering
(d2vins/src/estimator/marginalization/marginalization.cpp:17-76);
unit-sphere + td projection factors
(d2vins/src/factors/projectionTwoFrameOneCamFactor.cpp:34-120).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.state import ImuMeas, PriorBlock, ProjMeas, VIOState
from d2slam_tpu_torch.solver.vio_assembly import (
    RowBlock,
    _huber_weight,
    _pos3d_linearize_one,
    _proj_linearize_one,
    _tangent_base,
    build_imu_rows,
    build_prior_rows,
)


class Normal(NamedTuple):
    """Normal equations of the window, landmarks kept separate: H
    [D, D]; g [D]; cost []; and in the compact pose space (see
    ``compact_cols``) for inverse-depth landmarks hll [L], gl [L],
    Hpl [L, G], for pos3d landmarks hll [L, 3, 3], gl [L, 3],
    Hpl [L, 3, G]."""

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
    W, C, L = layout.W, layout.C, layout.L
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

    ar6 = torch.arange(6, device=fi.device)
    col = torch.cat([
        (6 * fi)[:, None] + ar6,
        (6 * fj)[:, None] + ar6,
        (6 * W + 6 * ci)[:, None] + ar6,
        (6 * W + 6 * cj)[:, None] + ar6,
        torch.full((fi.shape[0], 1), G - 1, dtype=fi.dtype, device=fi.device),
    ], dim=1)  # [M, 25]
    H, g, J79m = _compact_normal(layout, Jm_w, r_w, col)

    # landmark couplings: contract the 3 residual rows per measurement
    # first, then segment-sum by landmark slot
    hpvec = torch.einsum("mr,mrg->mg", Jl_w, J79m)   # [M, G]
    hll = r.new_zeros(L).index_add_(0, lm, torch.sum(Jl_w * Jl_w, dim=-1))
    gl = r.new_zeros(L).index_add_(0, lm, torch.sum(Jl_w * r_w, dim=-1))
    Hpl = r.new_zeros((L, G)).index_add_(0, lm, hpvec)
    return Normal(H=H, g=g, hll=hll, gl=gl, Hpl=Hpl, cost=cost)


def _compact_normal(layout: VIOLayout, Jm_w, r_w, col):
    """Scatter weighted compact blocks Jm_w [M, 3, k] at the compact
    columns ``col`` [M, k] into [M, 3, G] rows; returns the global
    (H [D, D], g [D]) and the compact rows."""
    M_, _, k = Jm_w.shape
    G = 6 * layout.W + 6 * layout.C + 1
    D, dev = layout.D_pad, Jm_w.device
    J79m = torch.zeros((M_, 3, G), dtype=Jm_w.dtype, device=dev)
    J79m.scatter_add_(2, col[:, None, :].expand(M_, 3, k), Jm_w)
    J79 = J79m.reshape(M_ * 3, G)
    H79 = J79.T @ J79
    g79 = J79.T @ r_w.reshape(M_ * 3)
    cols = compact_cols(layout, dev)
    H = torch.zeros((D, D), dtype=Jm_w.dtype, device=dev)
    H[cols[:, None], cols[None, :]] = H79
    return H, embed_cols(g79, cols, D), J79m


def build_proj_normal_pos3d(
    layout: VIOLayout,
    state: VIOState,
    meas: ProjMeas,
    proj_sqrt_info: float,
    dep_sqrt_info: float,
    huber_delta: float,
) -> Normal:
    """pos3d variant (reference landmark_param LM_POS,
    d2vins_params.hpp:70-73): each observation is an independent
    residual of (pose_j, ext_j, lm_pos); compact blocks are
    (pose_j 6 | ext_j 6 | td 1) and the landmark column is a 3-block."""
    dtype = state.poses.dtype
    W, C, L = layout.W, layout.C, layout.L
    G = 6 * W + 6 * C + 1
    fj, cj, lm = meas.frame_j, meas.cam_j, meas.lm
    m_data = {
        "ray_j": meas.ray_j, "vel_j": meas.vel_j, "td_j": meas.td_j,
        "dep_j": meas.dep_j, "tb": vmap(_tangent_base)(meas.ray_j),
    }
    r, Jm, Jl = vmap(_pos3d_linearize_one, in_dims=(0, 0, 0, None, 0))(
        state.poses[fj], state.ext[cj], state.lm_pos[lm], state.td, m_data)

    valid = meas.valid & state.lm_valid[lm] & state.frame_valid[fj]
    validf = valid.to(dtype)
    has_dep = meas.has_dep.to(dtype)
    w2, w3 = proj_sqrt_info, dep_sqrt_info
    sq = torch.sum((w2 * r[:, :2]) ** 2, dim=-1)
    hw, rho = _huber_weight(sq, huber_delta)
    row_w = torch.stack([hw * w2, hw * w2, w3 * has_dep], dim=-1) * validf[:, None]
    dep_cost = (w3 * r[:, 2]) ** 2 * has_dep
    cost = torch.sum((0.5 * rho + 0.5 * dep_cost) * validf)

    Jm_w = Jm * row_w[:, :, None]       # [M, 3, 13]
    r_w = r * row_w                     # [M, 3]
    Jl_w = Jl * row_w[:, :, None]       # [M, 3, 3] (rows x lm dims)

    ar6 = torch.arange(6, device=fj.device)
    col = torch.cat([
        (6 * fj)[:, None] + ar6,
        (6 * W + 6 * cj)[:, None] + ar6,
        torch.full((fj.shape[0], 1), G - 1, dtype=fj.dtype, device=fj.device),
    ], dim=1)  # [M, 13]
    H, g, J79m = _compact_normal(layout, Jm_w, r_w, col)

    M_ = fj.shape[0]
    hll = r.new_zeros((L, 9)).index_add_(
        0, lm, torch.einsum("mri,mrj->mij", Jl_w, Jl_w).reshape(M_, 9))
    gl = r.new_zeros((L, 3)).index_add_(0, lm, torch.einsum("mri,mr->mi", Jl_w, r_w))
    Hpl = r.new_zeros((L, 3 * G)).index_add_(
        0, lm, torch.einsum("mri,mrg->mig", Jl_w, J79m).reshape(M_, 3 * G))
    return Normal(H=H, g=g, hll=hll.reshape(L, 3, 3), gl=gl,
                  Hpl=Hpl.reshape(L, 3, G), cost=cost)


def fold_rows(n: Normal, rb: RowBlock) -> Normal:
    """Add a landmark-free row block (IMU, prior, consensus) as rows^T rows."""
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
    consensus=None,
) -> Normal:
    """Full window: projection + IMU + prior (+ consensus) normal
    equations. ``consensus``: ``(ref_poses [W, 7], tilde [W, 6], active
    [W], rho_T, rho_theta)``, the ADMM penalty rows of
    ``parallel.consensus.build_consensus_rows``."""
    build = (build_proj_normal_pos3d if landmark_param == "pos3d"
             else build_proj_normal)
    n = build(layout, state, proj, proj_sqrt_info, dep_sqrt_info, huber_delta)
    n = fold_rows(n, build_imu_rows(layout, state, imu, gravity))
    if prior is not None:
        n = fold_rows(n, build_prior_rows(layout, state, prior))
    if consensus is not None:
        from d2slam_tpu_torch.parallel.consensus import build_consensus_rows

        n = fold_rows(n, build_consensus_rows(layout, state, *consensus))
    return n
