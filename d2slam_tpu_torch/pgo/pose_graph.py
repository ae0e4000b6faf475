"""Pose-graph optimization, dense Levenberg-Marquardt.

Counterpart of ``d2slam_tpu/pgo/pose_graph.py`` (reference D2PGO Ceres
solve, d2pgo/src/d2pgo.cpp:155-328): ego-motion and loop-closure edges,
6-DoF or 4-DoF, are one padded edge array; each edge is linearized by
forward-mode AD through the retraction (``factors.linearize`` under
``vmap``); LM runs a fixed number of iterations with accept/reject by
``torch.where``, so a solve never waits on the host.

The JAX package places every edge's Jacobian into a dense
``[E·dof, D_pad]`` row block and forms ``J.T @ J``. Here the normal
equations are summed from each edge's [dof, dof] blocks with
``index_add_`` (the same H up to the order of summation) and factored
by Cholesky on the true ``D = N·dof``; J is never formed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from d2slam_tpu_torch.factors.linearize import linearize_factor
from d2slam_tpu_torch.factors.residuals import relpose4d_residual, relpose_residual
from d2slam_tpu_torch.geometry.lie import pose4d_boxplus, pose_boxplus, pose_compose, pose_inverse
from d2slam_tpu_torch.utils.device import resolve_device


class PGOLayout(NamedTuple):
    N: int              # max poses
    E: int              # max edges
    pose_dof: int = 6   # 6 or 4 (reference PGO_POSE_DOF)

    @property
    def D(self) -> int:
        return self.N * self.pose_dof


class PGOState(NamedTuple):
    """Poses of the graph (numpy or tensors; padded slots invalid)."""

    poses: torch.Tensor  # [N, 7]
    valid: torch.Tensor  # [N] bool


class PGOEdges(NamedTuple):
    """Padded relative-pose edges (odometry + loops), numpy or tensors."""

    i: torch.Tensor          # [E] int
    j: torch.Tensor          # [E] int
    rel: torch.Tensor        # [E, 7] measured i_T_j
    sqrt_info: torch.Tensor  # [E, 6, 6] (only [:4, :4] used in 4-DoF mode)
    valid: torch.Tensor      # [E] bool


class PGOReport(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    accepted: torch.Tensor


def to_device(state, edges, fixed_mask, device):
    """(state, edges, fixed) from numpy or tensors onto ``device``; the
    pose dtype follows ``state.poses`` (float32 unless it is float64)."""
    dev = resolve_device(device)
    poses = torch.as_tensor(state.poses, device=dev)
    dtype = poses.dtype
    st = PGOState(poses=poses, valid=torch.as_tensor(state.valid, dtype=torch.bool, device=dev))
    ed = PGOEdges(
        i=torch.as_tensor(edges.i, dtype=torch.long, device=dev),
        j=torch.as_tensor(edges.j, dtype=torch.long, device=dev),
        rel=torch.as_tensor(edges.rel, dtype=dtype, device=dev),
        sqrt_info=torch.as_tensor(edges.sqrt_info, dtype=dtype, device=dev),
        valid=torch.as_tensor(edges.valid, dtype=torch.bool, device=dev),
    )
    return st, ed, torch.as_tensor(fixed_mask, dtype=torch.bool, device=dev)


def _relpose4d(pa, pb, rel, sqrt_info):
    return relpose4d_residual(pa, pb, rel, sqrt_info[:4, :4])


def _edge_factor(dof: int):
    """(residual of one edge, retraction kinds of its two poses)."""
    return (relpose_residual, ("pose", "pose")) if dof == 6 else (_relpose4d, ("pose4d", "pose4d"))


def boxplus_of(dof: int):
    return pose_boxplus if dof == 6 else pose4d_boxplus


def _huber(r, valid, huber_delta: float):
    """Per-edge Huber row weight and cost (masked by ``valid``)."""
    sq = torch.sum(r * r, dim=-1)
    d2 = huber_delta * huber_delta
    big = sq > d2
    root = torch.sqrt(torch.clamp_min(sq, 1e-18))
    hw = torch.where(big, torch.sqrt(d2 / torch.clamp_min(sq, 1e-18)), torch.ones_like(sq))
    rho = torch.where(big, 2 * huber_delta * root - d2, sq)
    v = valid.to(r.dtype)
    return hw * v, 0.5 * rho * v


def edge_linearize(state: PGOState, edges: PGOEdges, dof: int, huber_delta: float, free):
    """Per-edge residuals and Jacobian blocks, Huber-weighted and masked.

    Returns (r [E, dof], Ja [E, dof, dof], Jb [E, dof, dof], cost [E]).
    Columns of fixed or invalid poses (``free`` false) are zero, so those
    poses never move."""
    res, kinds = _edge_factor(dof)
    poses = state.poses
    r, (Ja, Jb) = vmap(lambda pa, pb, rel, si: linearize_factor(res, kinds, (pa, pb), rel, si))(
        poses[edges.i], poses[edges.j], edges.rel, edges.sqrt_info)
    valid = edges.valid & state.valid[edges.i] & state.valid[edges.j]
    w, cost = _huber(r, valid, huber_delta)
    fr = free.to(poses.dtype)
    Ja = Ja * (w * fr[edges.i])[:, None, None]
    Jb = Jb * (w * fr[edges.j])[:, None, None]
    return r * w[:, None], Ja, Jb, cost


def edge_cost(state: PGOState, edges: PGOEdges, dof: int, huber_delta: float):
    """Total robust cost of the graph at ``state``."""
    poses = state.poses
    r = vmap(_edge_factor(dof)[0])(poses[edges.i], poses[edges.j], edges.rel, edges.sqrt_info)
    valid = edges.valid & state.valid[edges.i] & state.valid[edges.j]
    return torch.sum(_huber(r, valid, huber_delta)[1])


def grad(r, Ja, Jb, idx_i, idx_j, N: int):
    """J^T r per pose, [N, dof]."""
    g = torch.zeros((N, r.shape[-1]), dtype=r.dtype, device=r.device)
    g.index_add_(0, idx_i, torch.einsum("eki,ek->ei", Ja, r))
    g.index_add_(0, idx_j, torch.einsum("eki,ek->ei", Jb, r))
    return g


def predicted_odometry(optimized_pose, ego_pose_at_opt, ego_pose_now):
    """Extrapolate an optimized pose with the ego-motion accumulated
    since (reference D2PGO::getPredictedOdoms, d2pgo.cpp:663-700: the
    realtime output between PGO updates). All args [..., 7] tensors."""
    rel = pose_compose(pose_inverse(ego_pose_at_opt), ego_pose_now)
    return pose_compose(optimized_pose, rel)


def _normal_equations(r, Ja, Jb, edges: PGOEdges, N: int):
    """Dense H [N·dof, N·dof] and g [N·dof] from the edges' blocks."""
    dof = r.shape[-1]
    H4 = torch.zeros((N * N, dof, dof), dtype=r.dtype, device=r.device)
    i, j = edges.i, edges.j
    JaT = Ja.transpose(1, 2)
    JbT = Jb.transpose(1, 2)
    H4.index_add_(0, i * N + i, JaT @ Ja)
    H4.index_add_(0, i * N + j, JaT @ Jb)
    H4.index_add_(0, j * N + i, JbT @ Ja)
    H4.index_add_(0, j * N + j, JbT @ Jb)
    H = H4.view(N, N, dof, dof).permute(0, 2, 1, 3).reshape(N * dof, N * dof)
    return H, grad(r, Ja, Jb, i, j, N).reshape(-1)


def solve_pgo(
    layout: PGOLayout,
    state: PGOState,
    edges: PGOEdges,
    fixed_mask,  # [N] bool: poses held constant (gauge, e.g. first frame)
    *,
    max_iters: int = 10,
    huber_delta: float = 0.5,
    lambda_init: float = 1e-6,
    device=None,
):
    """LM pose-graph solve. ``state``, ``edges`` and ``fixed_mask`` may be
    numpy or tensors; they go to ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``). Returns (new_state,
    PGOReport), tensors on that device."""
    state, edges, fixed = to_device(state, edges, fixed_mask, device)
    dof, N = layout.pose_dof, layout.N
    D = layout.D
    dtype = state.poses.dtype
    boxplus = boxplus_of(dof)
    free = state.valid & ~fixed
    col_free = free.to(dtype).repeat_interleave(dof)
    fixed_diag = torch.diag(1.0 - col_free) + 1e-9 * torch.eye(D, dtype=dtype, device=col_free.device)

    cost = edge_cost(state, edges, dof, huber_delta)
    cost0 = cost
    lam = torch.full((), lambda_init, dtype=dtype, device=cost.device)
    accepted = torch.zeros((), dtype=torch.long, device=cost.device)
    poses = state.poses
    for _ in range(max_iters):
        s = state._replace(poses=poses)
        r, Ja, Jb, _ = edge_linearize(s, edges, dof, huber_delta, free)
        H, g = _normal_equations(r, Ja, Jb, edges, N)
        H = H + lam * torch.diag(torch.diagonal(H)) + fixed_diag
        L, info = torch.linalg.cholesky_ex(H)
        dx = -torch.cholesky_solve(g[:, None], L)[:, 0] * col_free
        cand = boxplus(poses, dx.reshape(N, dof))
        cand_cost = edge_cost(s._replace(poses=cand), edges, dof, huber_delta)
        # a failed factorization (XLA's NaN factor) is a rejected step
        accept = (cand_cost < cost) & (info == 0)
        poses = torch.where(accept, cand, poses)
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.where(accept, lam * 0.25, lam * 10.0)
        accepted = accepted + accept.long()
    return state._replace(poses=poses), PGOReport(cost0, cost, accepted)
