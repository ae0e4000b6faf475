"""IMU midpoint preintegration on the manifold, batched over intervals.

Counterpart of ``d2slam_tpu/imu/preintegration.py`` (VINS-Mono-style,
reference d2common/include/d2common/integration_base.h:95-227). The
JAX package scans one interval and vmaps over the window; here every
function takes any number of leading batch dimensions directly and
the scan is a Python loop over the padded samples, so one step is one
batched update for the whole window.

State ordering (StateOrder): P(0:3), R(3:6), V(6:9), BA(9:12),
BG(12:15). Noise ordering: AN(0:3), GN(3:6), AN1(6:9), GN1(9:12),
AW(12:15), GW(15:18).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from d2slam_tpu_torch.geometry.lie import (
    quat_from_small_angle,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_rotmat,
    skew,
)

# StateOrder offsets
O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


class PreintegrationResult(NamedTuple):
    """Preintegrated IMU quantities between two frames (leading batch
    dimensions allowed on every field)."""

    delta_p: torch.Tensor  # [..., 3]
    delta_q: torch.Tensor  # [..., 4] xyzw
    delta_v: torch.Tensor  # [..., 3]
    jacobian: torch.Tensor  # [..., 15, 15] d(state)/d(bias at linearization)
    covariance: torch.Tensor  # [..., 15, 15]
    sum_dt: torch.Tensor  # [...]
    linearized_ba: torch.Tensor  # [..., 3]
    linearized_bg: torch.Tensor  # [..., 3]


def default_noise_matrix(acc_n, gyr_n, acc_w, gyr_w, dtype=torch.float32,
                         device=None):
    """18x18 diagonal noise matrix (reference integration_base noise)."""
    d = []
    for v in (acc_n, gyr_n, acc_n, gyr_n, acc_w, gyr_w):
        d += [v ** 2] * 3
    return torch.diag(torch.tensor(d, dtype=dtype, device=device))


def preintegrate(dts, accs, gyrs, mask, linearized_ba, linearized_bg,
                 noise) -> PreintegrationResult:
    """Preintegrate padded IMU intervals.

    Args:
      dts: [..., N] time deltas; ``dts[i]`` is the gap between samples
        i-1 and i.
      accs, gyrs: [..., N, 3]. Sample 0 is the seed: it only initializes
        acc_0/gyr_0 and is never integrated.
      mask: [..., N] bool, True for samples that advance the integration.
      linearized_ba/bg: [..., 3] biases at linearization.
      noise: [18, 18] from :func:`default_noise_matrix`.
    """
    dtype, dev = accs.dtype, accs.device
    batch = accs.shape[:-2]
    I3 = torch.eye(3, dtype=dtype, device=dev)
    noise = noise.to(dtype)
    ba = linearized_ba
    bg = linearized_bg

    dp = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    dq = torch.zeros(batch + (4,), dtype=dtype, device=dev)
    dq[..., 3] = 1.0
    dv = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    J = torch.eye(15, dtype=dtype, device=dev).expand(batch + (15, 15)).clone()
    P = torch.zeros(batch + (15, 15), dtype=dtype, device=dev)
    acc0, gyr0 = accs[..., 0, :], gyrs[..., 0, :]
    sum_dt = torch.zeros(batch, dtype=dtype, device=dev)

    for i in range(1, accs.shape[-2]):
        dt, acc1, gyr1, valid = dts[..., i], accs[..., i, :], gyrs[..., i, :], mask[..., i]
        dt1 = dt[..., None]
        dt2 = dt[..., None, None]

        un_acc_0 = quat_rotate(dq, acc0 - ba)
        un_gyr = 0.5 * (gyr0 + gyr1) - bg
        result_dq = quat_normalize(quat_mul(dq, quat_from_small_angle(un_gyr * dt1)))
        un_acc_1 = quat_rotate(result_dq, acc1 - ba)
        un_acc = 0.5 * (un_acc_0 + un_acc_1)
        result_dp = dp + dv * dt1 + 0.5 * un_acc * dt1 * dt1
        result_dv = dv + un_acc * dt1

        # Jacobian/covariance propagation (integration_base.h:114-167)
        R_w_x = skew(un_gyr)
        R_a_0_x = skew(acc0 - ba)
        R_a_1_x = skew(acc1 - ba)
        R0 = quat_to_rotmat(dq)
        R1 = quat_to_rotmat(result_dq)
        R1a1 = R1 @ R_a_1_x
        wdt = I3 - R_w_x * dt2

        F = torch.zeros(batch + (15, 15), dtype=dtype, device=dev)
        F[..., O_P:O_P+3, O_P:O_P+3] = I3
        F[..., O_P:O_P+3, O_R:O_R+3] = (
            -0.25 * (R0 @ R_a_0_x) * dt2 * dt2
            + -0.25 * (R1a1 @ wdt) * dt2 * dt2
        )
        F[..., O_P:O_P+3, O_V:O_V+3] = I3 * dt2
        F[..., O_P:O_P+3, O_BA:O_BA+3] = -0.25 * (R0 + R1) * dt2 * dt2
        F[..., O_P:O_P+3, O_BG:O_BG+3] = -0.25 * R1a1 * dt2 * dt2 * -dt2
        F[..., O_R:O_R+3, O_R:O_R+3] = wdt
        F[..., O_R:O_R+3, O_BG:O_BG+3] = -I3 * dt2
        F[..., O_V:O_V+3, O_R:O_R+3] = (
            -0.5 * (R0 @ R_a_0_x) * dt2
            + -0.5 * (R1a1 @ wdt) * dt2
        )
        F[..., O_V:O_V+3, O_V:O_V+3] = I3
        F[..., O_V:O_V+3, O_BA:O_BA+3] = -0.5 * (R0 + R1) * dt2
        F[..., O_V:O_V+3, O_BG:O_BG+3] = -0.5 * R1a1 * dt2 * -dt2
        F[..., O_BA:O_BA+3, O_BA:O_BA+3] = I3
        F[..., O_BG:O_BG+3, O_BG:O_BG+3] = I3

        V = torch.zeros(batch + (15, 18), dtype=dtype, device=dev)
        V[..., O_P:O_P+3, 0:3] = 0.25 * R0 * dt2 * dt2
        v03 = 0.25 * -R1a1 * dt2 * dt2 * 0.5 * dt2
        V[..., O_P:O_P+3, 3:6] = v03
        V[..., O_P:O_P+3, 6:9] = 0.25 * R1 * dt2 * dt2
        V[..., O_P:O_P+3, 9:12] = v03
        V[..., O_R:O_R+3, 3:6] = 0.5 * I3 * dt2
        V[..., O_R:O_R+3, 9:12] = 0.5 * I3 * dt2
        V[..., O_V:O_V+3, 0:3] = 0.5 * R0 * dt2
        v63 = 0.5 * -R1a1 * dt2 * 0.5 * dt2
        V[..., O_V:O_V+3, 3:6] = v63
        V[..., O_V:O_V+3, 6:9] = 0.5 * R1 * dt2
        V[..., O_V:O_V+3, 9:12] = v63
        V[..., O_BA:O_BA+3, 12:15] = I3 * dt2
        V[..., O_BG:O_BG+3, 15:18] = I3 * dt2

        result_J = F @ J
        result_P = F @ P @ F.transpose(-1, -2) + V @ noise @ V.transpose(-1, -2)

        # freeze state for padded samples
        v1 = valid[..., None]
        v2 = valid[..., None, None]
        dp = torch.where(v1, result_dp, dp)
        dq = torch.where(v1, result_dq, dq)
        dv = torch.where(v1, result_dv, dv)
        J = torch.where(v2, result_J, J)
        P = torch.where(v2, result_P, P)
        acc0 = torch.where(v1, acc1, acc0)
        gyr0 = torch.where(v1, gyr1, gyr0)
        sum_dt = torch.where(valid, sum_dt + dt, sum_dt)

    return PreintegrationResult(
        delta_p=dp, delta_q=dq, delta_v=dv, jacobian=J, covariance=P,
        sum_dt=sum_dt, linearized_ba=linearized_ba,
        linearized_bg=linearized_bg,
    )


def imu_propagate_pose(pose, vel, ba, bg, dts, accs, gyrs, mask, gravity):
    """Euler-propagate odometry through raw IMU samples (reference
    IMUBuffer::propagation, d2estimator.cpp:978-996 getMotionPredict).

    pose: [7]; vel, ba, bg: [3]; dts/mask: [N]; accs/gyrs: [N, 3];
    gravity: [3] world gravity vector (e.g. [0, 0, -9.805]).
    Returns (pose [7], vel [3]) after the valid samples.
    """
    p, q, v = pose[:3], pose[3:], vel
    for i in range(dts.shape[0]):
        dt, acc, gyr, valid = dts[i], accs[i], gyrs[i], mask[i]
        # midpoint on rotation, euler on velocity
        q_new = quat_normalize(quat_mul(q, quat_from_small_angle((gyr - bg) * dt)))
        acc_w = quat_rotate(q, acc - ba) + gravity
        v_new = v + acc_w * dt
        p_new = p + v * dt + 0.5 * acc_w * dt * dt
        p = torch.where(valid, p_new, p)
        q = torch.where(valid, q_new, q)
        v = torch.where(valid, v_new, v)
    return torch.cat([p, q]), v
