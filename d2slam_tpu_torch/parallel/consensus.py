"""Consensus-ADMM multi-robot VIO with the robots as a batch dimension.

Counterpart of ``d2slam_tpu/parallel/consensus.py`` (the reference's
synchronous ConsensusSolver, d2common/src/solver/ConsensusSolver.cpp:
39-228). One ADMM round on every robot at once:

  1. **global averaging** of each shared frame pose across the robots
     that estimate it: the masked mean of the positions, the Markley
     average of the quaternions (reference updateGlobal / average_pose
     :166-228);
  2. **dual update** ``tilde += (1+alpha) * (local [-] global)`` in the
     tangent space (reference updateTilde :108-164);
  3. **local solve** of every robot's window with per-frame consensus
     penalty rows (reference ConsenusPoseFactor).

The JAX package runs one robot per slice of a device mesh and averages
with collectives; here the robots are dim 0 of ``[R, W, ...]`` tensors
and the collectives are reductions over it (``parallel.mesh``), on the
device. The local LM solves run one robot after another (the window LM
carries in-place updates that do not batch), each with no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from d2slam_tpu_torch.factors.linearize import linearize_factor
from d2slam_tpu_torch.factors.residuals import consensus_pose_residual
from d2slam_tpu_torch.geometry.lie import (
    quat_average,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
)
from d2slam_tpu_torch.parallel.mesh import all_gather, psum
from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.state import VIOState, tree_map
from d2slam_tpu_torch.solver.vio_assembly import RowBlock, place_cols


def consensus_average(poses, est_mask):
    """Average pose estimates across the robots.

    poses: [R, W, 7] every robot's estimates of the shared frames;
    est_mask: [R, W] bool, True where a robot estimates that frame.
    Returns [R, W, 7]: the consensus ("global") poses, the same for
    every robot; a frame nobody estimates keeps each robot's own value.
    """
    w = est_mask.to(poses.dtype)
    n = psum(w)                                              # [W]
    p_avg = psum(poses[..., :3] * w[..., None]) / torch.clamp_min(n, 1.0)[:, None]
    qs = all_gather(poses[..., 3:]).transpose(0, 1)          # [W, R, 4]
    q_avg = quat_average(qs, all_gather(w).transpose(0, 1))  # [W, 4]
    avg = torch.cat([p_avg, q_avg], dim=-1)
    return torch.where((n > 0)[None, :, None], avg[None], poses)


def dual_update(local_poses, global_poses, tilde, est_mask, alpha=0.0):
    """ADMM scaled-dual update in the tangent space (reference
    updateTilde: tilde += (1+alpha) * logm(global^-1 * local)), split into
    the translation in the reference frame and the rotation, as
    ``consensus_pose_residual`` measures them. Any leading dims."""
    q_ref = quat_normalize(global_poses[..., 3:])
    dt_ref = quat_rotate(quat_conj(q_ref), local_poses[..., :3] - global_poses[..., :3])
    q_err = quat_mul(quat_conj(q_ref), quat_normalize(local_poses[..., 3:]))
    # the hemisphere flip of consensus_pose_residual, exactly: otherwise the
    # accumulated dual measures another quantity than the penalty it feeds
    q_err = q_err * torch.where(q_err[..., 3:] < 0, -1.0, 1.0).to(q_err.dtype)
    new = tilde + (1.0 + alpha) * torch.cat([dt_ref, 2.0 * q_err[..., :3]], dim=-1)
    return torch.where(est_mask[..., None], new, tilde)


def build_consensus_rows(layout: VIOLayout, state: VIOState, ref_poses, tilde, active,
                         rho_T: float, rho_theta: float) -> RowBlock:
    """Per-frame consensus penalty rows of ONE robot's window (the LM's
    layout): ref_poses [W, 7], tilde [W, 6], active [W] bool. Rows of
    inactive or invalid frames are zero."""
    def res(pose, ref, t):
        return consensus_pose_residual(pose, ref, t[:3], t[3:], rho_T, rho_theta)

    r, (J,) = vmap(lambda p, ref, t: linearize_factor(res, ("pose",), (p,), ref, t))(
        state.poses, ref_poses, tilde)                       # [W, 6], [W, 6, 6]
    W = layout.W
    wgt = (active & state.frame_valid).to(r.dtype)
    col0 = 15 * torch.arange(W, device=r.device)
    rows = place_cols(J * wgt[:, None, None], col0, layout.D_pad)   # [W, 6, D]
    r = (r * wgt[:, None]).reshape(6 * W)
    return RowBlock(J=rows.reshape(6 * W, layout.D_pad), r=r, cost=0.5 * r * r)


class ConsensusCarry(NamedTuple):
    state: VIOState       # every field [R, ...]
    tilde: torch.Tensor   # [R, W, 6]


def _robot(x, r: int):
    """Robot ``r``'s share of a per-robot sequence, or the shared value."""
    return x[r] if isinstance(x, list) else x


def admm_vio_round(
    layout: VIOLayout,
    carry: ConsensusCarry,
    imu,
    proj,
    prior,
    *,
    est_mask,            # [R, W] bool: frames each robot estimates
    gravity,
    col_free,
    proj_sqrt_info: float,
    rho_T: float = 100.0,
    rho_theta: float = 100.0,
    alpha: float = 0.0,
    max_iters: int = 4,
    dep_sqrt_info: float = 20.0,
    huber_delta: float = 1.0,
    comm: bool = True,
):
    """One synchronous ADMM round over all robots (reference
    ConsensusSolver::solve, ConsensusSolver.cpp:39-75): average -> dual
    update -> each robot's local LM solve with consensus penalties.

    ``imu``, ``proj``, ``prior`` and ``col_free`` are shared by every
    robot, or lists with one per robot. ``comm=False`` replaces the
    cross-robot average with each robot's own poses: no solver mode, a
    way to time the local solves apart from the averaging. Returns the
    new carry and the robots' reports (``SolveReport`` of [R] tensors).
    """
    from d2slam_tpu_torch.solver.lm import SolveReport, lm_solve_vio

    state = carry.state
    global_poses = consensus_average(state.poses, est_mask) if comm else state.poses
    tilde = dual_update(state.poses, global_poses, carry.tilde, est_mask, alpha)
    states, reports = [], []
    for r in range(state.poses.shape[0]):
        s, rep = lm_solve_vio(
            layout, tree_map(lambda x: x[r], state), _robot(imu, r), _robot(proj, r),
            _robot(prior, r), gravity=gravity, col_free=_robot(col_free, r),
            proj_sqrt_info=proj_sqrt_info, dep_sqrt_info=dep_sqrt_info,
            huber_delta=huber_delta, max_iters=max_iters,
            consensus=(global_poses[r], tilde[r], est_mask[r], rho_T, rho_theta),
        )
        states.append(s)
        reports.append(rep)
    new_state = tree_map(lambda *xs: torch.stack(xs), *states)
    report = SolveReport(
        iterations=max_iters,
        **{k: torch.stack([getattr(rep, k) for rep in reports])
           for k in ("initial_cost", "final_cost", "accepted", "state_change")})
    return ConsensusCarry(state=new_state, tilde=tilde), report
