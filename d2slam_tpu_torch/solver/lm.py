"""Damped Gauss-Newton (Levenberg-Marquardt) solve of the VIO window.

Counterpart of ``d2slam_tpu/solver/lm.py`` (reference Ceres LM loop,
d2vins/src/estimator/d2estimator.cpp:604-685 solveNonDistrib, at most
8 iterations). Linearization, normal equations, diagonal Schur
elimination of inverse-depth landmarks, Cholesky of the reduced camera
system and the accept/reject select all stay on the tensors' device:
the loop always runs ``max_iters`` iterations (as ``lax.scan`` does)
and accepts with ``torch.where``, so no iteration waits on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from d2slam_tpu_torch.geometry.lie import pose_boxplus
from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.normal_assembly import (
    Normal,
    build_window_normal,
    compact_cols,
    embed_cols,
)
from d2slam_tpu_torch.solver.state import (
    ImuMeas,
    PriorBlock,
    ProjMeas,
    VIOState,
    tree_where,
)


class SolveReport(NamedTuple):
    iterations: int
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    accepted: torch.Tensor      # number of accepted steps
    state_change: torch.Tensor  # norm of the total accepted tangent update


def _apply_delta(layout: VIOLayout, state: VIOState, dx, dlm) -> VIOState:
    W, C = layout.W, layout.C
    per_frame = dx[: 15 * W].reshape(W, 15)
    return state._replace(
        poses=pose_boxplus(state.poses, per_frame[:, :6]),
        sb=state.sb + per_frame[:, 6:],
        ext=pose_boxplus(state.ext, dx[15 * W: 15 * W + 6 * C].reshape(C, 6)),
        td=state.td + dx[layout.td_col],
        inv_dep=state.inv_dep + dlm,
    )


def lm_solve_vio(
    layout: VIOLayout,
    state: VIOState,
    imu: ImuMeas,
    proj: ProjMeas,
    prior: Optional[PriorBlock],
    *,
    gravity,
    col_free,
    proj_sqrt_info: float,
    dep_sqrt_info: float = 20.0,
    huber_delta: float = 1.0,
    max_iters: int = 8,
    lambda_init: float = 1e-6,
    lambda_scale_up: float = 10.0,
    lambda_scale_down: float = 0.25,
    landmark_param: str = "inv_dep",
    method: str = "lm",
    refine_steps: int = 0,
):
    """Run LM on the sliding window. Returns (new_state, SolveReport).

    col_free: [D_pad] bool mask of free tangent columns (gauge fixing,
    disabled extrinsic/td estimation, padding); fixed columns get an
    identity diagonal so the system stays positive definite.

    refine_steps: iterative-refinement passes on the Cholesky solve
    (useful with float32 normal equations).
    """
    if method != "lm":
        raise NotImplementedError(
            f"solver method {method!r} is not ported yet (see ROADMAP.md)")
    if landmark_param != "inv_dep":
        raise NotImplementedError(
            "landmark_param='pos3d' is not ported yet (see ROADMAP.md)")
    dtype, dev = state.poses.dtype, state.poses.device
    D = layout.D_pad
    Dt = layout.D  # true tangent dim; cols Dt..D_pad-1 are pure padding
    col_free_f = col_free.to(dtype)
    cols = compact_cols(layout, dev)
    cf79 = col_free_f[cols]  # compact-space free mask
    eye = torch.eye(D, dtype=dtype, device=dev)

    def build(s: VIOState) -> Normal:
        return build_window_normal(
            layout, s, imu, proj, prior,
            gravity=gravity, proj_sqrt_info=proj_sqrt_info,
            dep_sqrt_info=dep_sqrt_info, huber_delta=huber_delta,
        )

    def chol_solve_neg(H_red, g_red):
        """dx = -H_red^{-1} g_red, factoring only the true [Dt, Dt]
        block (the padding columns are identity rows with zero
        gradient). A failed factorization yields NaN, which the cost
        comparison then rejects — as the JAX package's cho_factor."""
        Hc = H_red[:Dt, :Dt]
        gc = g_red[:Dt, None]
        L, info = torch.linalg.cholesky_ex(Hc)
        dxc = -torch.cholesky_solve(gc, L)
        for _ in range(refine_steps):
            dxc = dxc - torch.cholesky_solve(Hc @ dxc + gc, L)
        dxc = torch.where(info == 0, dxc, torch.full_like(dxc, float("nan")))
        dx = g_red.new_zeros(D)
        dx[:Dt] = dxc[:, 0]
        return dx

    def solve_step(n: Normal, lam):
        """Schur-eliminate the inverse-depth landmarks (diagonal hll),
        solve the reduced camera system, back-substitute."""
        H = n.H * (col_free_f[:, None] * col_free_f[None, :])
        g = n.g * col_free_f
        H_d = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye
        H_d = H_d + torch.diag(1.0 - col_free_f)  # identity on fixed cols

        Hpl = n.Hpl * cf79[None, :]  # [L, G]
        hll_d = n.hll * (1.0 + lam) + 1e-8
        Sc = (Hpl / hll_d[:, None]).T @ Hpl  # [G, G]
        H_red = H_d.clone()
        H_red[cols[:, None], cols[None, :]] -= Sc
        g_red = g - embed_cols(Hpl.T @ (n.gl / hll_d), cols, D)

        dx = chol_solve_neg(H_red, g_red) * col_free_f
        dlm = -(n.gl + Hpl @ dx[cols]) / hll_d
        return dx, dlm

    n = build(state)
    cost0 = n.cost
    s, cost = state, cost0
    lam = torch.tensor(lambda_init, dtype=dtype, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    change = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(max_iters):
        # carry the linearization: the accepted candidate's normal
        # equations double as the next iteration's
        dx, dlm = solve_step(n, lam)
        cand = _apply_delta(layout, s, dx, dlm)
        nc = build(cand)
        accept = nc.cost < cost
        s = tree_where(accept, cand, s)
        n = tree_where(accept, nc, n)
        cost = torch.where(accept, nc.cost, cost)
        lam = torch.where(accept, lam * lambda_scale_down, lam * lambda_scale_up)
        step_norm = torch.sqrt(torch.sum(dx * dx) + torch.sum(dlm * dlm))
        change = change + torch.where(accept, step_norm, torch.zeros_like(step_norm))
        accepted = accepted + accept.to(torch.int64)
    return s, SolveReport(
        iterations=max_iters, initial_cost=cost0, final_cost=cost,
        accepted=accepted, state_change=change,
    )
