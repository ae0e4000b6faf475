"""Large-scale pose-graph optimization: matrix-free LM + PCG.

Counterpart of ``d2slam_tpu/pgo/pcg.py`` (the reference's sparse Ceres
path for large graphs, d2pgo/src/d2pgo.cpp:155-328). Per LM iteration
only the per-edge residuals and the two [dof, dof] Jacobian blocks are
kept; the damped normal equations

    (J^T J + lam * diag) dx = -J^T r

are solved by preconditioned conjugate gradients:

- Hessian-vector products are two batched block matvecs: gather the
  pose blocks by edge endpoints, apply Ja / Jb, scatter the transposes
  back with ``index_add_`` (the JAX package's ``segment_sum``).
- The preconditioner is the block-Jacobi inverse of the [N, dof, dof]
  diagonal blocks.

CG runs a fixed trip count and freezes its iterate once converged, so a
solve never reads a value back to the host. Cost: O(E·dof²) per CG
step, O(E + N) memory.

``solve_pgo_pcg_anchored`` adds unary anchor blocks pulling poses toward
ARock dual poses: the local solve of distributed PGO once its graph
outgrows the dense path.
"""
from __future__ import annotations

import math

import torch
from torch.func import vmap

from d2slam_tpu_torch.factors.linearize import linearize_factor
from d2slam_tpu_torch.factors.residuals import consensus_pose_residual
from d2slam_tpu_torch.geometry.lie import yaw_from_quat

from d2slam_tpu_torch.pgo.pose_graph import (
    PGOEdges,
    PGOLayout,
    PGOReport,
    PGOState,
    boxplus_of,
    edge_cost,
    edge_linearize,
    grad,
    to_device,
)


def _block_diag_hessian(Ja, Jb, idx_i, idx_j, N: int):
    """[N, dof, dof] diagonal blocks of J^T J."""
    dof = Ja.shape[-1]
    Hd = torch.zeros((N, dof, dof), dtype=Ja.dtype, device=Ja.device)
    Hd.index_add_(0, idx_i, Ja.transpose(1, 2) @ Ja)
    Hd.index_add_(0, idx_j, Jb.transpose(1, 2) @ Jb)
    return Hd


def _pcg(hvp, Minv_apply, b, iters: int, rtol: float):
    """PCG on hvp(x) = b over a fixed trip count; once the residual norm
    is under ``rtol·|b|`` every later step leaves the iterate as it is."""
    x = torch.zeros_like(b)
    r = b
    z = Minv_apply(r)
    p = z
    rz = torch.sum(r * z)
    tol2 = (rtol * torch.sqrt(torch.sum(b * b))) ** 2
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    for _ in range(iters):
        Ap = hvp(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-30)
        x2 = x + alpha * p
        r2 = r - alpha * Ap
        z2 = Minv_apply(r2)
        rz2 = torch.sum(r2 * z2)
        beta = rz2 / torch.clamp_min(rz, 1e-30)
        p2 = z2 + beta * p
        done2 = done | (torch.sum(r2 * r2) < tol2)
        x = torch.where(done, x, x2)
        r = torch.where(done, r, r2)
        p = torch.where(done, p, p2)
        rz = torch.where(done, rz, rz2)
        done = done2
    return x


def solve_pgo_pcg(
    layout: PGOLayout,
    state: PGOState,
    edges: PGOEdges,
    fixed_mask,  # [N] bool: poses held constant (gauge)
    *,
    max_iters: int = 10,
    cg_iters: int = 60,
    cg_rtol: float = 1e-5,
    huber_delta: float = 0.5,
    lambda_init: float = 1e-6,
    device=None,
):
    """Matrix-free LM pose-graph solve; same contract as
    ``pose_graph.solve_pgo`` but O(E) memory, for graphs beyond a few
    thousand poses. Runs on ``device`` (default ``cuda``)."""
    state, edges, fixed = to_device(state, edges, fixed_mask, device)
    dof, N = layout.pose_dof, layout.N
    dtype = state.poses.dtype
    boxplus = boxplus_of(dof)
    free = state.valid & ~fixed
    fr = free.to(dtype)
    eye = torch.eye(dof, dtype=dtype, device=fr.device)
    ei, ej = edges.i, edges.j

    cost = edge_cost(state, edges, dof, huber_delta)
    cost0 = cost
    lam = torch.full((), lambda_init, dtype=dtype, device=cost.device)
    accepted = torch.zeros((), dtype=torch.long, device=cost.device)
    poses = state.poses
    for _ in range(max_iters):
        s = state._replace(poses=poses)
        r, Ja, Jb, _ = edge_linearize(s, edges, dof, huber_delta, free)
        g = grad(r, Ja, Jb, ei, ej, N)
        Hd = _block_diag_hessian(Ja, Jb, ei, ej, N)
        damp = lam * torch.diagonal(Hd, dim1=1, dim2=2) + 1e-9
        JaT, JbT = Ja.transpose(1, 2), Jb.transpose(1, 2)

        def hvp(v, Ja=Ja, Jb=Jb, JaT=JaT, JbT=JbT, damp=damp):
            u = (Ja @ v[ei][:, :, None] + Jb @ v[ej][:, :, None])
            out = damp * v
            out = out.index_add(0, ei, (JaT @ u)[:, :, 0])
            return out.index_add(0, ej, (JbT @ u)[:, :, 0])

        # block-Jacobi preconditioner (identity on fixed/invalid blocks)
        M = Hd + torch.diag_embed(damp)
        Minv = torch.linalg.inv_ex(torch.where(free[:, None, None], M, eye))[0]

        def Minv_apply(v, Minv=Minv):
            return (Minv @ v[:, :, None])[:, :, 0]

        dx = _pcg(hvp, Minv_apply, -g, cg_iters, cg_rtol) * fr[:, None]
        cand = boxplus(poses, dx)
        cand_cost = edge_cost(s._replace(poses=cand), edges, dof, huber_delta)
        accept = cand_cost < cost
        poses = torch.where(accept, cand, poses)
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.where(accept, lam * 0.25, lam * 10.0)
        accepted = accepted + accept.long()
    return state._replace(poses=poses), PGOReport(cost0, cost, accepted)


# ---------------------------------------------------------------------------
# anchored variant (the local solves of distributed PGO at scale)
# ---------------------------------------------------------------------------


def anchor_residual_fn(dof: int, rho_T: float, rho_theta: float):
    """Residual of one consensus anchor pulling a pose toward a dual pose:
    ConsenusPoseFactor with zero tilde for 6-DoF graphs, the 4-DoF
    x / y / z / yaw form (ConsenusPoseFactor4D) for 4-DoF ones (reference
    setDualStateFactors, ARock.cpp:256-314)."""
    if dof == 6:
        def f(pose, ref):
            z = torch.zeros(3, dtype=pose.dtype, device=pose.device)
            return consensus_pose_residual(pose, ref, z, z, rho_T, rho_theta)
        return f
    sT, sth = math.sqrt(rho_T), math.sqrt(rho_theta)

    def f4(pose, ref):
        dyaw = yaw_from_quat(pose[3:]) - yaw_from_quat(ref[3:])
        dyaw = torch.atan2(torch.sin(dyaw), torch.cos(dyaw))
        return torch.cat([sT * (pose[:3] - ref[:3]), sth * dyaw[None]])
    return f4


def anchor_linearize(poses, valid, anchor_idx, anchor_pose, anchor_active, dof: int,
                     rho_T: float, rho_theta: float):
    """Anchor residuals [K, dof] and Jacobians [K, dof, dof] through the
    graph's retraction, zero for inactive anchors and invalid poses."""
    f = anchor_residual_fn(dof, rho_T, rho_theta)
    kind = "pose" if dof == 6 else "pose4d"
    r, (J,) = vmap(lambda p, ref: linearize_factor(f, (kind,), (p,), ref))(
        poses[anchor_idx], anchor_pose)
    w = (anchor_active & valid[anchor_idx]).to(r.dtype)
    return r * w[:, None], J * w[:, None, None]


def anchor_cost(poses, valid, anchor_idx, anchor_pose, anchor_active, dof: int,
                rho_T: float, rho_theta: float):
    """0.5 |r|^2 of the active anchors (no Jacobians)."""
    r = vmap(anchor_residual_fn(dof, rho_T, rho_theta))(poses[anchor_idx], anchor_pose)
    w = (anchor_active & valid[anchor_idx]).to(r.dtype)
    return 0.5 * torch.sum((r * w[:, None]) ** 2)


def solve_pgo_pcg_anchored(
    layout: PGOLayout,
    state: PGOState,
    edges: PGOEdges,
    fixed_mask,
    anchor_idx,      # [K] pose slots
    anchor_pose,     # [K, 7] dual poses to anchor at
    anchor_active,   # [K] bool
    *,
    rho_T: float = 0.1,
    rho_theta: float = 2.0,
    max_iters: int = 6,
    cg_iters: int = 60,
    cg_rtol: float = 1e-5,
    huber_delta: float = 1.0,
    lambda_init: float = 1e-6,
    device=None,
):
    """``dpgo_transport.solve_pgo_anchored`` at ``solve_pgo_pcg`` scale:
    the anchors enter the matrix-free normal equations as unary blocks,
    O(E + N + K) memory. Returns (new_state, (initial_cost, final_cost,
    accepted))."""
    state, edges, fixed = to_device(state, edges, fixed_mask, device)
    dev = state.poses.device
    dof, N = layout.pose_dof, layout.N
    dtype = state.poses.dtype
    ai = torch.as_tensor(anchor_idx, dtype=torch.long, device=dev)
    ap = torch.as_tensor(anchor_pose, dtype=dtype, device=dev)
    aa = torch.as_tensor(anchor_active, dtype=torch.bool, device=dev)
    boxplus = boxplus_of(dof)
    free = state.valid & ~fixed
    fr = free.to(dtype)
    eye = torch.eye(dof, dtype=dtype, device=dev)
    ei, ej = edges.i, edges.j

    def anchors(poses):
        return anchor_linearize(poses, state.valid, ai, ap, aa, dof, rho_T, rho_theta)

    def total_cost(poses):
        return (edge_cost(state._replace(poses=poses), edges, dof, huber_delta)
                + anchor_cost(poses, state.valid, ai, ap, aa, dof, rho_T, rho_theta))

    cost = total_cost(state.poses)
    cost0 = cost
    lam = torch.full((), lambda_init, dtype=dtype, device=dev)
    accepted = torch.zeros((), dtype=torch.long, device=dev)
    poses = state.poses
    for _ in range(max_iters):
        s = state._replace(poses=poses)
        r, Ja, Jb, _ = edge_linearize(s, edges, dof, huber_delta, free)
        ra, Jan = anchors(poses)
        JanT = Jan.transpose(1, 2)
        g = grad(r, Ja, Jb, ei, ej, N).index_add(0, ai, (JanT @ ra[:, :, None])[:, :, 0])
        Hd = _block_diag_hessian(Ja, Jb, ei, ej, N).index_add(0, ai, JanT @ Jan)
        damp = lam * torch.diagonal(Hd, dim1=1, dim2=2) + 1e-9
        JaT, JbT = Ja.transpose(1, 2), Jb.transpose(1, 2)

        def hvp(v, Ja=Ja, Jb=Jb, JaT=JaT, JbT=JbT, Jan=Jan, JanT=JanT, damp=damp):
            u = (Ja @ v[ei][:, :, None] + Jb @ v[ej][:, :, None])
            out = damp * v
            out = out.index_add(0, ei, (JaT @ u)[:, :, 0])
            out = out.index_add(0, ej, (JbT @ u)[:, :, 0])
            return out.index_add(0, ai, (JanT @ (Jan @ v[ai][:, :, None]))[:, :, 0])

        M = Hd + torch.diag_embed(damp)
        Minv = torch.linalg.inv_ex(torch.where(free[:, None, None], M, eye))[0]

        def Minv_apply(v, Minv=Minv):
            return (Minv @ v[:, :, None])[:, :, 0]

        dx = _pcg(hvp, Minv_apply, -g, cg_iters, cg_rtol) * fr[:, None]
        cand = boxplus(poses, dx)
        cand_cost = total_cost(cand)
        accept = cand_cost < cost
        poses = torch.where(accept, cand, poses)
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.where(accept, lam * 0.25, lam * 10.0)
        accepted = accepted + accept.long()
    return state._replace(poses=poses), (cost0, cost, accepted)
