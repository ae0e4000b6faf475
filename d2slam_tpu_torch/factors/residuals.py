"""Residual functions for the VIO / PGO factor library.

Counterpart of ``d2slam_tpu/factors/residuals.py``. Each function maps
(parameter blocks..., measurement data...) -> residual vector for ONE
factor; they are pure and ``torch.func.vmap``/``jacrev``-able.

Reference semantics:
* IMU factor: d2vins/src/factors/imu_factor.h (15-dof residual,
  sqrt-info from LLT of the preintegration covariance inverse).
* Projection family: unit-sphere (tangent-base) reprojection with
  time-offset correction (d2vins/src/factors/
  projectionTwoFrameOneCamFactor.cpp:34-120 and siblings).
* Consensus factor: d2common/src/solver/consenus_factor.cpp.
* Relative pose factors: d2common/include/d2common/solver/RelPoseFactor.hpp.
"""
from __future__ import annotations

import torch

from d2slam_tpu_torch.geometry.lie import (
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    so3_log_quat,
    yaw_from_quat,
)

# ---------------------------------------------------------------------------
# IMU factor
# ---------------------------------------------------------------------------


def imu_residual(pose_i, sb_i, pose_j, sb_j, pre, gravity):
    """15-dof preintegration residual ordered [r_p, r_theta, r_v, r_ba,
    r_bg]. pose: [7]; sb: [9] = [v, ba, bg]; pre: PreintegrationResult
    of one interval; gravity: [3], positive-up convention."""
    Pi, Qi = pose_i[:3], quat_normalize(pose_i[3:])
    Pj, Qj = pose_j[:3], quat_normalize(pose_j[3:])
    Vi, Bai, Bgi = sb_i[:3], sb_i[3:6], sb_i[6:9]
    Vj, Baj, Bgj = sb_j[:3], sb_j[3:6], sb_j[6:9]
    dt = pre.sum_dt
    J = pre.jacobian
    dba = Bai - pre.linearized_ba
    dbg = Bgi - pre.linearized_bg

    dp_dba, dp_dbg = J[0:3, 9:12], J[0:3, 12:15]
    dq_dbg = J[3:6, 12:15]
    dv_dba, dv_dbg = J[6:9, 9:12], J[6:9, 12:15]

    theta_corr = dq_dbg @ dbg
    one = torch.ones(1, dtype=pre.delta_q.dtype, device=pre.delta_q.device)
    corrected_dq = quat_normalize(
        quat_mul(pre.delta_q, torch.cat([0.5 * theta_corr, one]))
    )
    corrected_dv = pre.delta_v + dv_dba @ dba + dv_dbg @ dbg
    corrected_dp = pre.delta_p + dp_dba @ dba + dp_dbg @ dbg

    Qi_inv = quat_conj(Qi)
    r_p = quat_rotate(Qi_inv, 0.5 * gravity * dt * dt + Pj - Pi - Vi * dt) - corrected_dp
    q_err = quat_mul(quat_conj(corrected_dq), quat_mul(Qi_inv, Qj))
    r_theta = 2.0 * q_err[:3]
    r_v = quat_rotate(Qi_inv, gravity * dt + Vj - Vi) - corrected_dv
    return torch.cat([r_p, r_theta, r_v, Baj - Bai, Bgj - Bgi])


def imu_sqrt_info(covariance, jitter=1e-12):
    """Lower-triangular S with S^T S = covariance^{-1} (any square root
    serves least squares; reference imu_factor.h:40-44), batched over
    leading dimensions. The jitter scales with the covariance's trace so
    all-zero (padded) covariances stay finite. The factorization reports
    no error (as the JAX version, which yields NaN): callers mask
    invalid intervals."""
    n = covariance.shape[-1]
    eye = torch.eye(n, dtype=covariance.dtype, device=covariance.device)
    scale = torch.diagonal(covariance, dim1=-2, dim2=-1).sum(-1) / n + 1e-12
    L, _ = torch.linalg.cholesky_ex(covariance + jitter * scale[..., None, None] * eye)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


# ---------------------------------------------------------------------------
# Visual projection factors (unit-sphere + time offset)
# ---------------------------------------------------------------------------


def tangent_base_of(pt_unit):
    """2x3 tangent basis at a unit-sphere point (reference
    projectionTwoFrameOneCamFactor.cpp:35-43)."""
    a = pt_unit / torch.linalg.norm(pt_unit)
    tmp = torch.where(
        torch.abs(a[2]) > 0.999,
        torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device),
        torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device),
    )
    b1 = tmp - a * torch.dot(a, tmp)
    b1 = b1 / torch.linalg.norm(b1)
    b2 = torch.linalg.cross(a, b1, dim=-1)
    return torch.stack([b1, b2])


def projection_residual(pts_cam_j, pts_j_td, tangent_base):
    """Unit-sphere reprojection error of a predicted camera-frame point
    against the (td-corrected) observed ray."""
    pred = pts_cam_j / torch.clamp_min(torch.linalg.norm(pts_cam_j), 1e-12)
    obs = pts_j_td / torch.clamp_min(torch.linalg.norm(pts_j_td), 1e-12)
    return tangent_base @ (pred - obs)


def _point_world_from_anchor(pose_i, ext_i, inv_dep, pt_i_td):
    pts_cam_i = pt_i_td / torch.clamp_min(inv_dep, 1e-6)
    pts_imu_i = quat_rotate(ext_i[3:], pts_cam_i) + ext_i[:3]
    return quat_rotate(pose_i[3:], pts_imu_i) + pose_i[:3]


def _point_cam_from_world(pose_j, ext_j, pts_w):
    pts_imu_j = quat_rotate(quat_conj(quat_normalize(pose_j[3:])), pts_w - pose_j[:3])
    return quat_rotate(quat_conj(quat_normalize(ext_j[3:])), pts_imu_j - ext_j[:3])


def projection_two_frame_one_cam(
    pose_i, pose_j, ext, inv_dep, td,
    pts_i, pts_j, vel_i, vel_j, td_i, td_j, tangent_base,
):
    """Landmark seen by the same camera in frames i (anchor) and j."""
    pts_i_td = pts_i - (td - td_i) * vel_i
    pts_j_td = pts_j - (td - td_j) * vel_j
    pts_w = _point_world_from_anchor(pose_i, ext, inv_dep, pts_i_td)
    pts_cam_j = _point_cam_from_world(pose_j, ext, pts_w)
    return projection_residual(pts_cam_j, pts_j_td, tangent_base)


def projection_two_frame_two_cam(
    pose_i, pose_j, ext_i, ext_j, inv_dep, td,
    pts_i, pts_j, vel_i, vel_j, td_i, td_j, tangent_base,
):
    """Anchor camera in frame i, a different camera in frame j."""
    pts_i_td = pts_i - (td - td_i) * vel_i
    pts_j_td = pts_j - (td - td_j) * vel_j
    pts_w = _point_world_from_anchor(pose_i, ext_i, inv_dep, pts_i_td)
    pts_cam_j = _point_cam_from_world(pose_j, ext_j, pts_w)
    return projection_residual(pts_cam_j, pts_j_td, tangent_base)


def projection_one_frame_two_cam(
    ext_i, ext_j, inv_dep, td,
    pts_i, pts_j, vel_i, vel_j, td_i, td_j, tangent_base,
):
    """Stereo observation within one frame: the pose cancels."""
    pts_i_td = pts_i - (td - td_i) * vel_i
    pts_j_td = pts_j - (td - td_j) * vel_j
    pts_cam_i = pts_i_td / torch.clamp_min(inv_dep, 1e-6)
    pts_imu = quat_rotate(ext_i[3:], pts_cam_i) + ext_i[:3]
    pts_cam_j = quat_rotate(quat_conj(quat_normalize(ext_j[3:])), pts_imu - ext_j[:3])
    return projection_residual(pts_cam_j, pts_j_td, tangent_base)


def projection_depth_residual(
    pose_i, pose_j, ext, inv_dep, td,
    pts_i, pts_j, vel_i, vel_j, td_i, td_j, tangent_base, dep_j,
):
    """Two-frame projection + measured depth in frame j: 3-dof residual
    [unit-sphere(2), depth error(1)]."""
    pts_i_td = pts_i - (td - td_i) * vel_i
    pts_j_td = pts_j - (td - td_j) * vel_j
    pts_w = _point_world_from_anchor(pose_i, ext, inv_dep, pts_i_td)
    pts_cam_j = _point_cam_from_world(pose_j, ext, pts_w)
    r2 = projection_residual(pts_cam_j, pts_j_td, tangent_base)
    r_dep = torch.linalg.norm(pts_cam_j) - dep_j
    return torch.cat([r2, r_dep[None]])


# ---------------------------------------------------------------------------
# Consensus / relative-pose factors (ADMM, PGO)
# ---------------------------------------------------------------------------


def consensus_pose_residual(pose, pose_ref, t_tilde, theta_tilde, rho_T, rho_theta):
    """ADMM consensus penalty on a pose vs the averaged reference plus
    accumulated scaled dual (reference consenus_factor.cpp:20-52)."""
    q_ref = quat_normalize(pose_ref[3:])
    q_err = quat_mul(quat_conj(q_ref), quat_normalize(pose[3:]))
    q_err = q_err * torch.where(q_err[3] < 0, -1.0, 1.0).to(q_err.dtype)
    r_theta = rho_theta * (2.0 * q_err[:3] + theta_tilde)
    r_t = rho_T * (quat_rotate(quat_conj(q_ref), pose[:3] - pose_ref[:3]) + t_tilde)
    return torch.cat([r_t, r_theta])


def relpose_residual(pose_a, pose_b, rel_pose_meas, sqrt_info):
    """6-DoF relative pose factor weighted by a [6, 6] sqrt-info."""
    qa = quat_normalize(pose_a[3:])
    dp_est = quat_rotate(quat_conj(qa), pose_b[:3] - pose_a[:3])
    dq_est = quat_mul(quat_conj(qa), quat_normalize(pose_b[3:]))
    dq_err = quat_mul(quat_conj(quat_normalize(rel_pose_meas[3:])), dq_est)
    r = torch.cat([dp_est - rel_pose_meas[:3], so3_log_quat(dq_err)])
    return sqrt_info @ r


def relpose4d_residual(pose_a, pose_b, rel_pose_meas, sqrt_info_4):
    """4-DoF (x, y, z, yaw) relative pose factor."""
    yaw_a = yaw_from_quat(pose_a[3:])
    yaw_b = yaw_from_quat(pose_b[3:])
    c, s = torch.cos(-yaw_a), torch.sin(-yaw_a)
    d = pose_b[:3] - pose_a[:3]
    dp_est = torch.stack([c * d[0] - s * d[1], s * d[0] + c * d[1], d[2]])
    dyaw_meas = yaw_from_quat(quat_normalize(rel_pose_meas[3:]))
    dyaw = yaw_b - yaw_a - dyaw_meas
    dyaw = torch.atan2(torch.sin(dyaw), torch.cos(dyaw))  # wrap
    r = torch.cat([dp_est - rel_pose_meas[:3], dyaw[None]])
    return sqrt_info_4 @ r


def gravity_prior_residual(pose, gravity_body_meas, sqrt_info_3):
    """Deviation of the body-frame gravity direction from the observed
    one (reference GravityPrior.hpp)."""
    g_world = torch.tensor([0.0, 0.0, -1.0], dtype=pose.dtype, device=pose.device)
    g_body = quat_rotate(quat_conj(quat_normalize(pose[3:])), g_world)
    return sqrt_info_3 @ (g_body - gravity_body_meas)
