"""Chordal rotation and linear position initialization of a pose graph.

Counterpart of ``d2slam_tpu/pgo/rot_init.py`` (reference
d2pgo/src/rot_init/rotation_initialization_base.hpp:89-245):
relative-rotation measurements give linear constraints
``R_a @ R_ab - R_b = 0`` on the 9 entries of each pose's rotation
matrix, fixed poses add prior rows; the solution is projected back to
SO(3) (solveLinearRot:178-215). Given the rotations, positions are
linear too (solveLinearPose6d).

Every function takes one graph (``poses`` [N, 7]) or a batch of them
sharing the edge list (``poses`` [B, N, 7] with masks [B, N] / [B, E]:
the robots of ``pgo.distributed``), and solves all of them in one batched
program: dense Cholesky of the [3N, 3N] normal matrix, or block-Jacobi
PCG over the edges. Iterative loops run a fixed trip count and freeze
with ``torch.where`` once converged, so nothing is read back to the host.
"""
from __future__ import annotations

import torch

from d2slam_tpu_torch.geometry.lie import quat_to_rotmat, rotmat_to_quat


def _batch(poses, *masks):
    """(poses [B, N, 7], masks with a batch dim, had_batch)."""
    had = poses.dim() == 3
    if not had:
        poses = poses[None]
    B = poses.shape[0]
    out = [None if m is None else (m if m.dim() == 2 else m[None]).expand(B, -1)
           for m in masks]
    return poses, out, had


def _seg(x, idx, N: int):
    """Segment sum over dim 1: x [B, E, ...] into [B, N, ...] at ``idx`` [E]."""
    out = x.new_zeros((x.shape[0], N) + tuple(x.shape[2:]))
    return out.index_add_(1, idx, x)


def _blocks_to_dense(blocks, N: int):
    """[B, N*N, k, k] blocks (row-major pose pairs) -> [B, N*k, N*k]."""
    B, _, k, _ = blocks.shape
    return blocks.view(B, N, N, k, k).permute(0, 1, 3, 2, 4).reshape(B, N * k, N * k)


def _project_so3(R_sol, gravity_aware: bool):
    """Project linear-solution matrices [..., 3, 3] back to SO(3): by SVD
    with the determinant fixed (reference solveLinearRot), or, with
    gravity priors, by Gram-Schmidt holding the prior-pinned third row
    (the plain SVD would smear the other rows' tilt into it)."""
    if not gravity_aware:
        U, _, Vh = torch.linalg.svd(R_sol)
        det = torch.linalg.det(U @ Vh)
        U = torch.cat([U[..., :2], U[..., 2:] * det[..., None, None]], dim=-1)
        return U @ Vh
    r2 = R_sol[..., 2, :]
    r2 = r2 / torch.clamp_min(torch.linalg.norm(r2, dim=-1, keepdim=True), 1e-12)
    r0 = R_sol[..., 0, :]
    r0 = r0 - torch.sum(r0 * r2, dim=-1, keepdim=True) * r2
    r0 = r0 / torch.clamp_min(torch.linalg.norm(r0, dim=-1, keepdim=True), 1e-12)
    return torch.stack([r0, torch.linalg.cross(r2, r0), r2], dim=-2)


def _finish_rotations(poses, valid, R_sol, gravity_aware, had_batch):
    q_new = rotmat_to_quat(_project_so3(R_sol, gravity_aware))
    q_out = torch.where(valid[..., None], q_new, poses[..., 3:])
    out = torch.cat([poses[..., :3], q_out], dim=-1)
    return out if had_batch else out[0]


def chordal_rotation_init(
    poses,            # [N, 7] or [B, N, 7] initial poses (rotations may be garbage)
    valid,            # [N] / [B, N] bool
    edge_i, edge_j,   # [E] long
    rel_q,            # [E, 4] measured relative rotations (xyzw)
    edge_valid,       # [E] / [B, E] bool
    fixed_mask,       # [N] / [B, N] bool: rotations held at their current value
    fix_weight: float = 100.0,
    gravity_body=None,   # [N, 3] / [B, N, 3] body-frame gravity direction per frame
    gravity_weight: float = 0.0,
):
    """Poses with the rotations replaced by the chordal least-squares
    solution (positions untouched), by a dense Cholesky of the [3N, 3N]
    normal matrix shared by the three row systems.

    ``gravity_body`` / ``gravity_weight`` add the reference's gravity-prior
    rows (rotation_initialization_base.hpp:131-144): the third row of each
    R_n, the body-frame direction of world z, is pinned to the VIO
    attitude's, so noisy loop edges cannot tilt the attitudes out of the
    gravity-aligned gauge. Only that row system changes; yaw stays free.
    """
    poses, (valid, edge_valid, fixed_mask), had = _batch(poses, valid, edge_valid, fixed_mask)
    dtype, dev = poses.dtype, poses.device
    B, N = poses.shape[:2]
    gravity = gravity_weight > 0.0 and gravity_body is not None

    A = quat_to_rotmat(rel_q.to(dtype)).transpose(-1, -2)          # [E, 3, 3] = R_ab^T
    w_e = (edge_valid & valid[:, edge_i] & valid[:, edge_j]).to(dtype)   # [B, E]
    ww = w_e[..., None, None]
    AtA = (A.transpose(-1, -2) @ A) * ww                             # [B, E, 3, 3]
    At = A.transpose(-1, -2) * ww
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    blocks = poses.new_zeros((B, N * N, 3, 3))
    blocks.index_add_(1, edge_i * N + edge_i, AtA)
    blocks.index_add_(1, edge_j * N + edge_j, eye3 * ww)
    blocks.index_add_(1, edge_i * N + edge_j, -At)
    blocks.index_add_(1, edge_j * N + edge_i, -At.transpose(-1, -2))
    H = _blocks_to_dense(blocks, N)

    # priors on fixed rotations: weight * || u_{n,r} - R_n[r] ||^2, the
    # unknown X[3n+i, r] = R_n[r, i]
    R0 = quat_to_rotmat(poses[..., 3:])
    wf = (fixed_mask & valid).to(dtype) * fix_weight
    b = (R0.transpose(-1, -2) * wf[..., None, None]).reshape(B, 3 * N, 3)
    # tiny regularization of invalid or unconstrained poses
    inactive = 1.0 - valid.to(dtype).repeat_interleave(3, dim=1)
    H = H + torch.diag_embed(wf.repeat_interleave(3, dim=1) + inactive + 1e-9)

    L = torch.linalg.cholesky(H)
    if gravity:
        # the gravity prior touches the r=2 row system only, which gets a
        # factorization of its own
        wg = valid.to(dtype) * gravity_weight
        gb = gravity_body.to(dtype)
        gb = gb if gb.dim() == 3 else gb[None].expand(B, -1, -1)
        L2 = torch.linalg.cholesky(H + torch.diag_embed(wg.repeat_interleave(3, dim=1)))
        b2 = b[..., 2] + (gb * wg[..., None]).reshape(B, 3 * N)
        X = torch.cat([torch.cholesky_solve(b[..., :2], L),
                       torch.cholesky_solve(b2[..., None], L2)], dim=-1)
    else:
        X = torch.cholesky_solve(b, L)
    R_sol = X.reshape(B, N, 3, 3).transpose(-1, -2)
    return _finish_rotations(poses, valid, R_sol, gravity, had)


def _cg(hvp, Minv_apply, X, b, iters: int, tol2):
    """Preconditioned CG from ``X`` over a fixed trip count, one system
    per batch row (inner products over all other dims); a row whose
    squared residual fell under ``tol2`` [B] keeps its iterate."""
    def dot(u, v):
        return torch.sum(u * v, dim=tuple(range(1, u.dim())))

    def bc(s):
        return s.reshape((-1,) + (1,) * (X.dim() - 1))

    r = b - hvp(X)
    z = Minv_apply(r)
    p = z
    rz = dot(r, z)
    done = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
    for _ in range(iters):
        Ap = hvp(p)
        alpha = rz / torch.clamp_min(dot(p, Ap), 1e-30)
        X2 = X + bc(alpha) * p
        r2 = r - bc(alpha) * Ap
        z2 = Minv_apply(r2)
        rz2 = dot(r2, z2)
        p2 = z2 + bc(rz2 / torch.clamp_min(rz, 1e-30)) * p
        done2 = done | (dot(r2, r2) < tol2)
        keep = bc(done)
        X = torch.where(keep, X, X2)
        r = torch.where(keep, r, r2)
        p = torch.where(keep, p, p2)
        rz = torch.where(done, rz, rz2)
        done = done2
    return X


def chordal_rotation_init_pcg(
    poses, valid, edge_i, edge_j, rel_q, edge_valid, fixed_mask,
    fix_weight: float = 100.0,
    cg_iters: int = 150,
    cg_rtol: float = 1e-7,
    gravity_body=None,
    gravity_weight: float = 0.0,
):
    """Matrix-free ``chordal_rotation_init`` for large graphs: the [3N, 3N]
    normal matrix is never formed; its products are batched 3x3 block
    matvecs over the edges (``index_add_``), block-Jacobi preconditioned
    (reference solveLinear with SimplicialLLT,
    rotation_initialization_base.hpp:146-176). The three row systems are
    solved jointly (Frobenius inner product). CG starts from the poses'
    current rotations: information travels about one graph hop per step,
    so odometry-chained rotations converge in tens of steps; arbitrary
    input rotations need ``cg_iters`` beyond the graph's diameter."""
    poses, (valid, edge_valid, fixed_mask), had = _batch(poses, valid, edge_valid, fixed_mask)
    dtype, dev = poses.dtype, poses.device
    B, N = poses.shape[:2]
    gravity = gravity_weight > 0.0 and gravity_body is not None

    A = quat_to_rotmat(rel_q.to(dtype)).transpose(-1, -2)           # [E, 3, 3] = R_ab^T
    w_e = (edge_valid & valid[:, edge_i] & valid[:, edge_j]).to(dtype)
    ww = w_e[..., None, None]
    Aw = A * ww                                                      # [B, E, 3, 3]
    AtA = A.transpose(-1, -2) @ Aw

    R0 = quat_to_rotmat(poses[..., 3:])
    wf = (fixed_mask & valid).to(dtype) * fix_weight
    diag_w = (wf + (1.0 - valid.to(dtype)) + 1e-9)[..., None, None]
    b = R0.transpose(-1, -2) * wf[..., None, None]                  # V[n, i, r] = R_n[r, i]
    grav_diag = poses.new_zeros((B, N, 1, 3))
    if gravity:
        wg = valid.to(dtype) * gravity_weight
        gb = gravity_body.to(dtype)
        gb = gb if gb.dim() == 3 else gb[None].expand(B, -1, -1)
        b = torch.cat([b[..., :2], b[..., 2:] + (gb * wg[..., None])[..., None]], dim=-1)
        grav_diag[..., 0, 2] = wg

    def hvp(V):
        Va, Vb = V[:, edge_i], V[:, edge_j]
        out_a = AtA @ Va - Aw.transpose(-1, -2) @ Vb
        out_b = Vb * ww - Aw @ Va
        return _seg(out_a, edge_i, N) + _seg(out_b, edge_j, N) + (diag_w + grav_diag) * V

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hd = _seg(AtA, edge_i, N) + _seg(eye3 * ww, edge_j, N) + diag_w * eye3
    Minv = torch.linalg.inv(Hd)

    X = R0.transpose(-1, -2)
    r0 = b - hvp(X)
    tol2 = cg_rtol ** 2 * torch.sum(r0 * r0, dim=(1, 2, 3))
    X = _cg(hvp, lambda V: Minv @ V, X, b, cg_iters, tol2)
    return _finish_rotations(poses, valid, X.transpose(-1, -2), gravity, had)


def linear_translation_init(
    poses,           # [N, 7] / [B, N, 7] poses with initialized rotations
    valid,
    edge_i, edge_j,
    rel_t,           # [E, 3] measured relative translations (in frame a)
    edge_valid,
    fixed_mask,      # positions held at their current value
    fix_weight: float = 100.0,
    method: str = "dense",   # dense | cg
    cg_iters: int = 200,
    cg_rtol: float = 1e-8,
):
    """Linear position initialization given the rotations (reference
    solveLinearPose6d(finetune_rot=false), rotation_initialization_base.hpp:
    217-245, 331-360): each edge's residual ``p_b - p_a - R_a t_ab`` is
    linear in the positions, fixed frames add prior rows, and the normal
    matrix is a scalar [N, N] weighted graph Laplacian with 3 right-hand
    sides: one Cholesky (``dense``) or Jacobi-preconditioned CG (``cg``).
    Returns the poses with positions replaced (rotations untouched)."""
    if method not in ("dense", "cg"):
        raise ValueError(f"unknown method {method!r}")
    poses, (valid, edge_valid, fixed_mask), had = _batch(poses, valid, edge_valid, fixed_mask)
    dtype = poses.dtype
    B, N = poses.shape[:2]

    Ra = quat_to_rotmat(poses[:, edge_i, 3:])
    t_world = (Ra @ rel_t.to(dtype)[None, :, :, None])[..., 0]     # R_a t_ab [B, E, 3]
    w_e = (edge_valid & valid[:, edge_i] & valid[:, edge_j]).to(dtype)
    wf = (fixed_mask & valid).to(dtype) * fix_weight ** 2
    diag_extra = wf + (1.0 - valid.to(dtype)) + 1e-9
    wt = w_e[..., None] * t_world
    b = _seg(-wt, edge_i, N) + _seg(wt, edge_j, N) + wf[..., None] * poses[..., :3]
    diag = _seg(w_e, edge_i, N) + _seg(w_e, edge_j, N) + diag_extra

    if method == "dense":
        H = poses.new_zeros((B, N * N))
        H.index_add_(1, edge_i * N + edge_j, -w_e)
        H.index_add_(1, edge_j * N + edge_i, -w_e)
        H = H.view(B, N, N) + torch.diag_embed(diag)
        p_new = torch.cholesky_solve(b, torch.linalg.cholesky(H))
    else:
        def hvp(x):
            d = w_e[..., None] * (x[:, edge_i] - x[:, edge_j])
            return _seg(d, edge_i, N) - _seg(d, edge_j, N) + diag_extra[..., None] * x

        Minv = (1.0 / diag)[..., None]
        tol2 = cg_rtol ** 2 * torch.clamp_min(torch.sum(b * b, dim=(1, 2)), 1e-30)
        p_new = _cg(hvp, lambda x: Minv * x, poses[..., :3], b, cg_iters, tol2)

    p_out = torch.where(valid[..., None], p_new, poses[..., :3])
    out = torch.cat([p_out, poses[..., 3:]], dim=-1)
    return out if had else out[0]
