"""Distributed pose-graph optimization with the robots as a batch dimension.

Counterpart of ``d2slam_tpu/pgo/distributed.py``, the bulk-synchronous
form of the reference's ARock asynchronous ADMM PGO
(d2common/src/solver/ARock.cpp:140-190, d2pgo/src/ARockPGO.cpp): each
robot estimates a set of poses (its own and those it shares edges with),
owns a subset of the edges, and the robots reconcile the poses they
share through an averaged consensus pose and eta_k-relaxed duals.

All robots' local problems are one batched program on the device: the
poses are [R, N, 7], the masks [R, N] / [R, E], every robot's normal
equations are assembled from per-edge blocks in one pass and factored by
one batched Cholesky, and the LM accepts or rejects each robot's step
with ``torch.where``. The rotation initialization's convergence latch is
a ``torch.where`` too: no round reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from d2slam_tpu_torch.factors.linearize import linearize_factor
from d2slam_tpu_torch.factors.residuals import consensus_pose_residual
from d2slam_tpu_torch.geometry.lie import pose_boxminus, pose_boxplus, quat_normalize
from d2slam_tpu_torch.parallel.consensus import consensus_average, dual_update
from d2slam_tpu_torch.parallel.mesh import pmax, psum
from d2slam_tpu_torch.pgo.pose_graph import (
    PGOEdges,
    PGOLayout,
    PGOState,
    edge_costs,
    edge_linearize,
)


class ARockPGOCarry(NamedTuple):
    state: PGOState       # poses [R, N, 7], valid [N] or [R, N]
    tilde: torch.Tensor   # [R, N, 6] dual per pose


def _valid(state: PGOState, R: int):
    v = state.valid
    return v if v.dim() == 2 else v[None].expand(R, -1)


def arock_pgo_round(
    layout: PGOLayout,
    carry: ARockPGOCarry,
    edges: PGOEdges,
    *,
    est_mask,    # [R, N] bool: poses each robot estimates (own + boundary)
    own_mask,    # [R, N] bool: poses each robot owns (its output)
    fixed_mask,  # [N] bool: global gauge poses
    edge_mask,   # [R, E] bool: the edges each robot holds; every edge
                 # belongs to exactly one robot (double assignment would
                 # count its information twice in the consensus)
    eta: float = 0.9,     # reference ARockSolverConfig eta_k relaxation
    rho: float = 100.0,
    max_iters: int = 4,
    huber_delta: float = 0.5,
):
    """One bulk-synchronous ARock / ADMM round of every robot. Returns
    the new carry and (initial_cost [R], final_cost [R], accepted [R])."""
    state, tilde = carry.state, carry.tilde
    global_poses = consensus_average(state.poses, est_mask)
    # poses estimated by >= 2 robots are the consensus variables; the
    # penalty applies to EVERY copy (the owner's too), or information from
    # the neighbours' edges could never flow back to the owner
    n_est = psum(est_mask.to(state.poses.dtype))
    shared = est_mask & (n_est >= 2.0)[None]
    # eta_k relaxation: new duals blend with the old (reference
    # updateDualStates, ARock.cpp:24-84)
    tilde = eta * dual_update(state.poses, global_poses, tilde, shared) + (1.0 - eta) * tilde
    new_state, report = _solve_with_consensus(
        layout, state, edges, fixed_mask, global_poses, tilde, shared, rho=rho,
        max_iters=max_iters, huber_delta=huber_delta, est_mask=est_mask, edge_mask=edge_mask)
    return ARockPGOCarry(state=new_state, tilde=tilde), report


def distributed_pgo_solve(
    layout: PGOLayout,
    state: PGOState,
    edges: PGOEdges,
    *,
    est_mask,
    own_mask,
    fixed_mask,
    edge_mask,
    rounds: int = 8,
    rot_init: bool = True,
    gravity_body=None,
    gravity_weight: float = 0.0,
    rot_init_rounds: int = 2,
    rot_init_eps: float = 1e-4,
    **round_kw,
):
    """The reference's far-field sequence (d2pgo.cpp:155-328 solve_multi:
    RotInit -> waitForRotInitFinish -> ARockPGO): chordal rotation and
    linear position initialization on each robot's known graph, averaged
    across the robots so all start the rounds from one attitude field,
    repeated until the largest change over all robots is under
    ``rot_init_eps`` (the reference's convergence detection,
    d2pgo.cpp:350-360; the averaging stands in for the ROT_INIT_FINISH
    barrier); then ``rounds`` ARock rounds. ``gravity_body`` /
    ``gravity_weight``: the per-frame attitude priors of the rotation
    initialization (rotation_initialization_base.hpp:131-144). Returns
    (state, the last round's report)."""
    from d2slam_tpu_torch.pgo.rot_init import chordal_rotation_init, linear_translation_init

    poses = state.poses
    R = poses.shape[0]
    valid = _valid(state, R)
    if rot_init:
        # the initialization uses every edge the robot knows: the per-robot
        # edge split only matters to the consensus objective
        act = edges.valid[None] & est_mask[:, edges.i] & est_mask[:, edges.j]
        fixed = fixed_mask[None].expand(R, -1)
        converged = torch.zeros((), dtype=torch.bool, device=poses.device)
        vf = valid[..., None].to(poses.dtype)
        for _ in range(max(rot_init_rounds, 1)):
            prev = poses
            new = chordal_rotation_init(
                poses, valid, edges.i, edges.j, quat_normalize(edges.rel[:, 3:]), act, fixed,
                gravity_body=gravity_body, gravity_weight=gravity_weight)
            new = linear_translation_init(new, valid, edges.i, edges.j, edges.rel[:, :3],
                                          act, fixed)
            poses = torch.where(converged, prev, consensus_average(new, est_mask))
            change = pmax(torch.amax(torch.abs(pose_boxminus(poses, prev)) * vf, dim=(1, 2)))
            converged = converged | (change < rot_init_eps)
        state = state._replace(poses=poses)

    carry = ARockPGOCarry(state=state, tilde=poses.new_zeros((R, layout.N, 6)))
    report = None
    for _ in range(rounds):
        carry, report = arock_pgo_round(
            layout, carry, edges, est_mask=est_mask, own_mask=own_mask, fixed_mask=fixed_mask,
            edge_mask=edge_mask, **round_kw)
    return carry.state, report


def _solve_with_consensus(layout, state, edges, fixed_mask, ref_poses, tilde, active, *,
                          rho, max_iters, huber_delta, est_mask, edge_mask):
    """Every robot's LM pose-graph solve with its consensus penalty rows
    (6-DoF), batched: the R local graphs are one graph of R·N poses and
    R·E edges (each robot's copy of the edges, masked to its own and to
    poses it estimates), the normal equations [R, 6N, 6N] come from the
    per-edge and per-pose blocks, one batched Cholesky solves them, and
    each robot accepts or rejects its step on its own cost."""
    if layout.pose_dof != 6:
        raise ValueError("distributed PGO's consensus rows are 6-DoF")
    poses0 = state.poses
    R, N = poses0.shape[:2]
    E = edges.i.shape[0]
    dof = 6
    dtype, dev = poses0.dtype, poses0.device
    valid = _valid(state, R)
    free = valid & est_mask & ~fixed_mask[None]                       # [R, N]
    col_free = free.to(dtype).repeat_interleave(dof, dim=1)           # [R, 6N]
    base = torch.arange(R, device=dev)[:, None]
    gi = (edges.i[None] + base * N).reshape(-1)                       # [R*E]
    gj = (edges.j[None] + base * N).reshape(-1)
    edge_act = edge_mask & est_mask[:, edges.i] & est_mask[:, edges.j]   # [R, E]
    flat_edges = PGOEdges(i=gi, j=gj, rel=edges.rel.repeat(R, 1),
                          sqrt_info=edges.sqrt_info.repeat(R, 1, 1),
                          valid=(edges.valid[None] & edge_act).reshape(-1))
    ij = (base * N * N + edges.i[None] * N + edges.j[None]).reshape(-1)
    ii = (base * N * N + edges.i[None] * (N + 1)).reshape(-1)
    jj = (base * N * N + edges.j[None] * (N + 1)).reshape(-1)
    ji = (base * N * N + edges.j[None] * N + edges.i[None]).reshape(-1)
    nn = (base * N * N + torch.arange(N, device=dev)[None] * (N + 1)).reshape(-1)
    act = (active & valid).to(dtype)                                  # [R, N]
    fixed_diag = torch.diag_embed(1.0 - col_free) + 1e-9 * torch.eye(dof * N, dtype=dtype,
                                                                       device=dev)

    def res(pose, ref, t):
        return consensus_pose_residual(pose, ref, t[:3], t[3:], rho, rho)

    def linearize_consensus(poses):
        r, (J,) = vmap(lambda p, ref, t: linearize_factor(res, ("pose",), (p,), ref, t))(
            poses.reshape(R * N, 7), ref_poses.reshape(R * N, 7), tilde.reshape(R * N, 6))
        w = act.reshape(-1)
        return r * w[:, None], J * (w * free.reshape(-1).to(dtype))[:, None, None]

    def costs(poses):
        flat = PGOState(poses=poses.reshape(R * N, 7), valid=valid.reshape(-1))
        c = edge_costs(flat, flat_edges, dof, huber_delta)
        rc = vmap(res)(poses.reshape(R * N, 7), ref_poses.reshape(R * N, 7),
                       tilde.reshape(R * N, 6)) * act.reshape(-1, 1)
        return c.view(R, E).sum(1) + 0.5 * (rc * rc).view(R, N * dof).sum(1)

    cost = costs(poses0)
    cost0 = cost
    lam = torch.full((R,), 1e-6, dtype=dtype, device=dev)
    accepted = torch.zeros(R, dtype=torch.long, device=dev)
    poses = poses0
    for _ in range(max_iters):
        flat = PGOState(poses=poses.reshape(R * N, 7), valid=valid.reshape(-1))
        r, Ja, Jb, _ = edge_linearize(flat, flat_edges, dof, huber_delta, free.reshape(-1))
        rc, Jc = linearize_consensus(poses)
        JaT, JbT, JcT = Ja.transpose(1, 2), Jb.transpose(1, 2), Jc.transpose(1, 2)
        H4 = poses.new_zeros((R * N * N, dof, dof))
        H4.index_add_(0, ii, JaT @ Ja)
        H4.index_add_(0, ij, JaT @ Jb)
        H4.index_add_(0, ji, JbT @ Ja)
        H4.index_add_(0, jj, JbT @ Jb)
        H4.index_add_(0, nn, JcT @ Jc)
        H = H4.view(R, N, N, dof, dof).permute(0, 1, 3, 2, 4).reshape(R, N * dof, N * dof)
        g = poses.new_zeros((R * N, dof))
        g.index_add_(0, gi, (JaT @ r[:, :, None])[:, :, 0])
        g.index_add_(0, gj, (JbT @ r[:, :, None])[:, :, 0])
        g = (g + (JcT @ rc[:, :, None])[:, :, 0]).view(R, N * dof)
        H = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=1, dim2=2)) + fixed_diag
        L, info = torch.linalg.cholesky_ex(H)
        dx = -torch.cholesky_solve(g[:, :, None], L)[:, :, 0] * col_free
        cand = pose_boxplus(poses, dx.view(R, N, dof))
        cand_cost = costs(cand)
        # a failed factorization is a rejected step
        accept = (cand_cost < cost) & (info == 0)
        poses = torch.where(accept[:, None, None], cand, poses)
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.where(accept, lam * 0.25, lam * 10.0)
        accepted = accepted + accept.long()
    return state._replace(poses=poses), (cost0, cost, accepted)
