"""Sliding-window marginalization producing a dense prior, with FEJ.

Counterpart of ``d2slam_tpu/solver/marginalization.py`` (reference
d2vins/src/estimator/marginalization/marginalization.cpp:173-254 and
filterResiduals:78-118):

* only residuals touching removed frames enter the marginalization;
* landmarks those rows touch are Schur-eliminated first (diagonal),
  then the removed frames' 15-dim blocks (masked dense Schur step);
* the (H, g) result becomes prior rows J, r through an eigenvalue
  square root (rows below ``eig_eps`` are masked out);
* FEJ: kept params carried by the old prior linearize at its stored
  points.

Observer-removed rows of kept-anchor landmarks follow the reference's
``remove_base_when_margin_remote`` modes (d2vins_params.hpp:108): mode 0
drops them, mode 2 (default) includes them and eliminates every landmark
they touch.

The prior is a device tensor from one keyframe to the next: the
window-shift permutation is applied to it on the device
(``permute_prior_device``) at the start of the next solve.
"""
from __future__ import annotations

from typing import Optional

import torch

from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.normal_assembly import (
    build_window_normal,
    compact_cols,
    embed_cols,
)
from d2slam_tpu_torch.solver.state import (
    ImuMeas,
    PriorBlock,
    ProjMeas,
    VIOState,
)


def marginalize(
    layout: VIOLayout,
    state: VIOState,
    imu: ImuMeas,
    proj: ProjMeas,
    prior: Optional[PriorBlock],
    remove_frames: torch.Tensor,  # [W] bool
    *,
    gravity,
    proj_sqrt_info: float,
    dep_sqrt_info: float = 20.0,
    huber_delta: float = 1.0,
    eig_eps: float = 1e-8,
    landmark_param: str = "inv_dep",
    remove_base_mode: int = 2,
) -> PriorBlock:
    """Marginalize the frames marked in ``remove_frames`` into a new
    prior. ``state`` already holds the FEJ linearization values."""
    dtype, dev = state.poses.dtype, state.poses.device
    D, L = layout.D_pad, layout.L

    # --- row selection -----------------------------------------------------
    imu_touch = remove_frames[imu.frame_i] | remove_frames[imu.frame_j]
    if remove_base_mode == 0:
        # drop observer-removed rows of kept-anchor landmarks entirely
        anchor_rm = (remove_frames[proj.frame_i] & proj.valid).to(dtype)
        lm_anchor_removed = anchor_rm.new_zeros(L).index_add_(
            0, proj.lm, anchor_rm) > 0
        proj_touch = lm_anchor_removed[proj.lm]
    else:
        proj_touch = remove_frames[proj.frame_i] | remove_frames[proj.frame_j]
    proj_sel = proj._replace(valid=proj.valid & proj_touch)
    imu_sel = imu._replace(valid=imu.valid & imu_touch)

    n = build_window_normal(
        layout, state, imu_sel, proj_sel, prior,
        gravity=gravity, proj_sqrt_info=proj_sqrt_info,
        dep_sqrt_info=dep_sqrt_info, huber_delta=huber_delta,
        landmark_param=landmark_param,
    )

    # --- eliminate touched landmarks (diagonal Schur) ----------------------
    Hdl = embed_cols(n.Hpl, compact_cols(layout, dev), D)  # [L, D]
    hll_safe = torch.where(n.hll > 0, n.hll, torch.ones_like(n.hll))
    H1 = n.H - (Hdl / hll_safe[:, None]).T @ Hdl
    g1 = n.g - Hdl.T @ (n.gl / hll_safe)

    # --- eliminate removed frame dims (masked dense Schur) -----------------
    m_r = _frame_col_mask(layout, remove_frames, dtype)
    m_k = 1.0 - m_r
    # A = H over the removed block, identity elsewhere: invertible
    A = H1 * m_r[:, None] * m_r[None, :] + torch.diag(m_k) + 1e-10 * torch.diag(m_r)
    A_inv = torch.linalg.inv(A)
    Hkr = H1 * m_k[:, None] * m_r[None, :]
    H_new = H1 * m_k[:, None] * m_k[None, :] - Hkr @ A_inv @ Hkr.T
    g_new = g1 * m_k - Hkr @ (A_inv @ (g1 * m_r))

    # --- square root -> prior rows ----------------------------------------
    H_new = 0.5 * (H_new + H_new.T)
    evals, evecs = torch.linalg.eigh(H_new)
    good = evals > eig_eps
    s = torch.sqrt(torch.where(good, evals, torch.ones_like(evals)))
    zero = torch.zeros_like(s)
    J_prior = (evecs * torch.where(good, s, zero)[None, :]).T  # [D, D] rows
    # linear residual model r(x) = J (x [-] x0) + r0 with J^T r0 = g
    r_prior = torch.where(good, (evecs.T @ g_new) / s, zero)
    return PriorBlock(J=J_prior, r=r_prior, lin=state, row_valid=good)


def _frame_col_mask(layout: VIOLayout, remove_frames, dtype):
    """[D_pad] float mask: 1.0 on columns of removed frames."""
    m = torch.zeros(layout.D_pad, dtype=dtype, device=remove_frames.device)
    m[: 15 * layout.W] = torch.repeat_interleave(remove_frames.to(dtype), 15)
    return m


def zero_prior(layout: VIOLayout, dtype, device=None) -> PriorBlock:
    """An inert PriorBlock (all rows invalid)."""
    D = layout.D_pad
    return PriorBlock(
        J=torch.zeros((D, D), dtype=dtype, device=device),
        r=torch.zeros((D,), dtype=dtype, device=device),
        lin=VIOState.zeros(layout, dtype, device),
        row_valid=torch.zeros((D,), dtype=torch.bool, device=device),
    )


def make_pose_prior(layout: VIOLayout, state: VIOState, frame: int,
                    pos_sqrt_info: float = 100.0,
                    rot_sqrt_info: float = 100.0) -> PriorBlock:
    """Stiff pose prior pinning one frame — the gauge anchor (reference
    d2vinsstate.cpp:503-555 createPriorFactor4FirstFrame)."""
    dtype, dev = state.poses.dtype, state.poses.device
    D = layout.D_pad
    c0 = 15 * frame
    J = torch.zeros((D, D), dtype=dtype, device=dev)
    w = torch.tensor([pos_sqrt_info] * 3 + [rot_sqrt_info] * 3,
                     dtype=dtype, device=dev)
    J[c0: c0 + 6, c0: c0 + 6] = torch.diag(w)
    row_valid = torch.zeros((D,), dtype=torch.bool, device=dev)
    row_valid[c0: c0 + 6] = True
    return PriorBlock(J=J, r=torch.zeros((D,), dtype=dtype, device=dev),
                      lin=state, row_valid=row_valid)


def solve_and_marginalize(
    layout: VIOLayout,
    state: VIOState,
    imu: ImuMeas,
    proj: ProjMeas,
    prior: PriorBlock,
    remove_frames,      # [W] bool tensor — frames to marginalize after solving
    do_marg: bool,      # False: pass the old prior through
    enable_fej: bool,   # linearize kept params at prior.lin
    *,
    gravity,
    col_free,
    proj_sqrt_info: float,
    dep_sqrt_info: float = 20.0,
    huber_delta: float = 1.0,
    max_iters: int = 8,
    landmark_param: str = "inv_dep",
    method: str = "lm",
    refine_steps: int = 0,
    remove_base_mode: int = 2,
    eig_eps: float = 1e-8,
):
    """The keyframe's backend step: the sliding-window LM solve, then
    (when ``do_marg``) marginalizing ``remove_frames`` into a fresh
    prior. Returns (new_state, report, new_prior)."""
    from d2slam_tpu_torch.solver.lm import lm_solve_vio

    new_state, report = lm_solve_vio(
        layout, state, imu, proj, prior,
        gravity=gravity, col_free=col_free,
        proj_sqrt_info=proj_sqrt_info, dep_sqrt_info=dep_sqrt_info,
        huber_delta=huber_delta, max_iters=max_iters,
        landmark_param=landmark_param, method=method,
        refine_steps=refine_steps,
    )
    if not do_marg:
        return new_state, report, prior

    marg_state = new_state
    if enable_fej:
        # prior-carried frames linearize at prior.lin (reference
        # replacetoPrevLinearizedPoints, prior_factor.cpp:183+)
        carried = prior.lin.frame_valid[:, None]
        marg_state = new_state._replace(
            poses=torch.where(carried, prior.lin.poses, new_state.poses),
            sb=torch.where(carried, prior.lin.sb, new_state.sb),
        )
    new_prior = marginalize(
        layout, marg_state, imu, proj, prior, remove_frames,
        gravity=gravity, proj_sqrt_info=proj_sqrt_info,
        dep_sqrt_info=dep_sqrt_info, huber_delta=huber_delta,
        eig_eps=eig_eps, landmark_param=landmark_param,
        remove_base_mode=remove_base_mode,
    )
    return new_state, report, new_prior


def permute_prior_device(layout: VIOLayout, prior: PriorBlock,
                         perm) -> PriorBlock:
    """Re-map prior columns and linearization state after window slots
    move, on the prior's device. ``perm[new] = old`` ([W] ints, -1
    resets a slot); extrinsic/td columns are unchanged."""
    W, D = layout.W, layout.D_pad
    dev = prior.J.device
    perm = torch.as_tensor(perm, dtype=torch.long, device=dev)
    keep = perm >= 0
    src = torch.clamp(perm, 0, W - 1)
    col_idx = (src[:, None] * 15 + torch.arange(15, device=dev)[None, :]).reshape(-1)
    col_src = torch.cat([col_idx, torch.arange(15 * W, D, device=dev)])
    col_keep = torch.cat([
        torch.repeat_interleave(keep, 15),
        torch.ones((D - 15 * W,), dtype=torch.bool, device=dev),
    ])
    J = prior.J[:, col_src] * col_keep.to(prior.J.dtype)[None, :]

    lin = prior.lin
    unit = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=lin.poses.dtype, device=dev)
    poses = torch.where(keep[:, None], lin.poses[src], unit[None, :])
    sb = torch.where(keep[:, None], lin.sb[src], torch.zeros_like(lin.sb))
    fv = keep & lin.frame_valid[src]
    return prior._replace(J=J, lin=lin._replace(poses=poses, sb=sb, frame_valid=fv))


def solve_and_marginalize_carry(
    layout: VIOLayout,
    prior: PriorBlock,
    state: VIOState,
    imu: ImuMeas,
    proj: ProjMeas,
    perm,               # [W] pending window-shift slot map
    remove_frames,
    do_marg: bool,
    enable_fej: bool,
    **kw,
):
    """``solve_and_marginalize`` with the prior as the carry: the
    pending window-shift permutation is applied to it first, and the
    new prior is returned as the carry. Returns
    ``(new_prior, (new_state, report))``."""
    prior = permute_prior_device(layout, prior, perm)
    new_state, report, new_prior = solve_and_marginalize(
        layout, state, imu, proj, prior, remove_frames, do_marg,
        enable_fej, **kw,
    )
    return new_prior, (new_state, report)
