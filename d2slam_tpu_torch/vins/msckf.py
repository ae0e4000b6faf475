"""MSCKF: Multi-State-Constraint Kalman Filter on torch tensors.

Counterpart of ``d2slam_tpu/vins/msckf.py`` (the reference's
experimental MSCKF, d2vins/src/MSCKF/, completed there): IMU error-state
propagation, fixed-size FIFO camera-clone augmentation, and the landmark
update with left-nullspace projection of the feature Jacobian,
Mahalanobis gating and a Joseph-form EKF update. Shapes are static
(clone count C and landmark batch L fixed, masked), so every step is the
same sequence of batched ops on the state's device; no step reads a
value back to the host.

Error-state layout (15 + 6C):
    [dtheta(3), dp(3), dv(3), dbg(3), dba(3), (dtheta_c, dp_c) x C]
Rotation errors are right-perturbations: q <- q (x) exp(dtheta/2).

The left null space of a landmark's feature Jacobian comes from a
complete QR; LAPACK, cuSOLVER and XLA pick different bases of it, so the
projected rows differ between devices while the update (and the gate)
does not: compare states and covariances, not the projected rows.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from d2slam_tpu_torch.geometry.lie import (
    quat_from_small_angle,
    quat_mul,
    quat_normalize,
    quat_to_rotmat,
    skew,
    so3_exp_quat,
)
from d2slam_tpu_torch.utils.device import resolve_device

GRAVITY_Z = -9.805


def gravity(like: torch.Tensor) -> torch.Tensor:
    """World gravity on ``like``'s device and dtype."""
    return torch.tensor([0.0, 0.0, GRAVITY_Z], dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class MSCKFConfig:
    num_clones: int = 10          # C: sliding camera states
    max_landmarks: int = 32       # L: landmark tracks per update batch
    gyr_n: float = 2.5e-3
    acc_n: float = 2.6e-2
    gyr_w: float = 2.7e-5
    acc_w: float = 2.0e-4
    pix_sigma: float = 1.5e-3     # noise on normalized image coords
    chi2_per_dof: float = 7.0     # Mahalanobis gate
    init_att_sigma: float = 1e-3
    init_pos_sigma: float = 1e-6
    init_vel_sigma: float = 1e-2
    init_bg_sigma: float = 1e-3
    init_ba_sigma: float = 1e-2


class MSCKFState(NamedTuple):
    q: torch.Tensor            # [4] world<-body (xyzw)
    p: torch.Tensor            # [3]
    v: torch.Tensor            # [3]
    bg: torch.Tensor           # [3]
    ba: torch.Tensor           # [3]
    clone_q: torch.Tensor      # [C, 4]
    clone_p: torch.Tensor      # [C, 3]
    clone_valid: torch.Tensor  # [C] bool
    clone_stamp: torch.Tensor  # [C] float (for debugging / association)
    next_slot: torch.Tensor    # [] int64 FIFO insertion cursor
    P: torch.Tensor            # [15+6C, 15+6C]


def msckf_init(cfg: MSCKFConfig, q0=None, p0=None, v0=None,
               dtype=torch.float64, device=None) -> MSCKFState:
    """Initial state; every tensor on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    C = cfg.num_clones
    diag = torch.tensor(
        [cfg.init_att_sigma**2] * 3 + [cfg.init_pos_sigma**2] * 3
        + [cfg.init_vel_sigma**2] * 3 + [cfg.init_bg_sigma**2] * 3
        + [cfg.init_ba_sigma**2] * 3 + [0.0] * (6 * C), dtype=dtype, device=dev)

    def vec(x, default):
        return (torch.tensor(default, dtype=dtype, device=dev) if x is None
                else torch.as_tensor(x, dtype=dtype).to(dev))

    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=dev)
    return MSCKFState(
        q=vec(q0, [0.0, 0.0, 0.0, 1.0]),
        p=vec(p0, [0.0] * 3),
        v=vec(v0, [0.0] * 3),
        bg=torch.zeros(3, dtype=dtype, device=dev),
        ba=torch.zeros(3, dtype=dtype, device=dev),
        clone_q=ident.repeat(C, 1),
        clone_p=torch.zeros((C, 3), dtype=dtype, device=dev),
        clone_valid=torch.zeros(C, dtype=torch.bool, device=dev),
        clone_stamp=torch.zeros(C, dtype=dtype, device=dev),
        next_slot=torch.zeros((), dtype=torch.int64, device=dev),
        P=torch.diag(diag),
    )


# ---------------------------------------------------------------------------
# propagation
# ---------------------------------------------------------------------------


def msckf_propagate(state: MSCKFState, cfg: MSCKFConfig,
                    dts, gyrs, accs, mask=None) -> MSCKFState:
    """Propagate through a (padded) window of IMU samples, one sample
    after another on the device.

    dts [N], gyrs [N, 3], accs [N, 3], mask [N] (False = padding).
    """
    P = state.P
    dtype, dev = P.dtype, P.device
    dts = torch.as_tensor(dts).to(device=dev, dtype=dtype)
    gyrs = torch.as_tensor(gyrs).to(device=dev, dtype=dtype)
    accs = torch.as_tensor(accs).to(device=dev, dtype=dtype)
    if mask is not None:
        dts = torch.where(torch.as_tensor(mask).to(dev), dts, torch.zeros_like(dts))
    g = gravity(P)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    # the noise pattern: Qd = diag(pattern) * dt
    qn = torch.zeros(15, dtype=dtype, device=dev)
    qn[0:3] = cfg.gyr_n**2
    qn[6:9] = cfg.acc_n**2
    qn[9:12] = cfg.gyr_w**2
    qn[12:15] = cfg.acc_w**2
    Qn = torch.diag(qn)
    q, p, v, bg, ba = state.q, state.p, state.v, state.bg, state.ba
    for dt, w_m, a_m in zip(dts.unbind(0), gyrs.unbind(0), accs.unbind(0)):
        w = w_m - bg
        a = a_m - ba
        R = quat_to_rotmat(q)

        # nominal midpoint-free Euler step (dt ~ 2.5 ms at 400 Hz)
        q_new = quat_normalize(quat_mul(q, so3_exp_quat(w * dt)))
        acc_w = R @ a + g
        p = p + v * dt + 0.5 * acc_w * dt * dt
        v = v + acc_w * dt
        q = q_new

        # error-state transition for [dth, dp, dv, dbg, dba]
        F = torch.eye(15, dtype=dtype, device=dev)
        F[0:3, 0:3] = I3 - skew(w) * dt
        F[0:3, 9:12] = -I3 * dt
        F[3:6, 6:9] = I3 * dt
        F[6:9, 0:3] = -(R @ skew(a)) * dt
        F[6:9, 12:15] = -R * dt

        FPsc = F @ P[:15, 15:]
        P_new = P.clone()
        P_new[:15, :15] = F @ P[:15, :15] @ F.T + Qn * dt
        P_new[:15, 15:] = FPsc
        P_new[15:, :15] = FPsc.T
        P = 0.5 * (P_new + P_new.T)
    return state._replace(q=q, p=p, v=v, P=P)


# ---------------------------------------------------------------------------
# clone augmentation
# ---------------------------------------------------------------------------


def msckf_augment(state: MSCKFState, cfg: MSCKFConfig,
                  stamp=0.0) -> Tuple[MSCKFState, torch.Tensor]:
    """Clone the current body pose into the FIFO slot. Returns
    (new_state, slot_index as a 0-d tensor). The clone error is
    [dth_c, dp_c] = [dth, dp], so the augmentation Jacobian rows are
    identity blocks: the clone's rows of P are the body's (dth, dp)
    rows."""
    C = cfg.num_clones
    P = state.P
    slot = state.next_slot % C
    cq = state.clone_q.clone()
    cq[slot] = state.q
    cp = state.clone_p.clone()
    cp[slot] = state.p
    cv = state.clone_valid.clone()
    cv[slot] = True
    cs = state.clone_stamp.clone()
    cs[slot] = torch.as_tensor(stamp, dtype=P.dtype).to(P.device)

    new_rows = P[:6]                                        # [6, D]
    idx = 15 + 6 * slot + torch.arange(6, device=P.device)  # the slot's rows
    P = P.clone()
    P[idx] = new_rows
    P[:, idx] = new_rows.T
    P[idx[:, None], idx[None, :]] = new_rows[:, :6]
    return state._replace(clone_q=cq, clone_p=cp, clone_valid=cv,
                          clone_stamp=cs, next_slot=state.next_slot + 1,
                          P=P), slot


# ---------------------------------------------------------------------------
# landmark triangulation + update
# ---------------------------------------------------------------------------


def _triangulate_dlt(rays_w, centers, w):
    """Weighted linear triangulation: point minimizing distance to the
    world-frame rays (I - d d^T) (pf - c) = 0. rays_w [..., C, 3] unit,
    centers [C, 3], w [..., C] weights; batched over leading dims."""
    I = torch.eye(3, dtype=rays_w.dtype, device=rays_w.device)
    A = w[..., None, None] * (I - rays_w[..., :, None] * rays_w[..., None, :])
    AtA = A.sum(-3)
    Atb = torch.einsum("...cij,cj->...i", A, centers)
    return torch.linalg.solve(AtA + 1e-9 * I, Atb[..., None])[..., 0]


def msckf_update(state: MSCKFState, cfg: MSCKFConfig,
                 obs_uv, obs_mask, T_cam_body=None) -> MSCKFState:
    """Batched landmark update.

    obs_uv  [L, C, 2]: normalized image coords (x/z, y/z) of landmark l
            observed from clone c; obs_mask [L, C] validity.
    T_cam_body: optional [7] body->camera extrinsic ([p, q]); identity
            (camera = body, z forward) when None.
    """
    P = state.P
    dtype, dev = P.dtype, P.device
    C = cfg.num_clones
    obs_uv = torch.as_tensor(obs_uv).to(device=dev, dtype=dtype)
    L = obs_uv.shape[0]
    D = 15 + 6 * C
    m = torch.as_tensor(obs_mask).to(dev) & state.clone_valid[None, :]

    if T_cam_body is None:
        R_cb = torch.eye(3, dtype=dtype, device=dev)
        p_cb = torch.zeros(3, dtype=dtype, device=dev)
    else:
        T = torch.as_tensor(T_cam_body).to(device=dev, dtype=dtype)
        p_cb, R_cb = T[:3], quat_to_rotmat(T[3:])

    # camera poses for each clone: R_wc = R_wb R_bc, p_wc = p_wb + R_wb p_bc
    R_wb = quat_to_rotmat(state.clone_q)                    # [C, 3, 3]
    R_bc = R_cb.T
    p_bc = -R_bc @ p_cb
    R_wc = torch.einsum("cij,jk->cik", R_wb, R_bc)
    p_wc = state.clone_p + torch.einsum("cij,j->ci", R_wb, p_bc)

    # back-projected world rays from the measurements, per landmark
    wgt = m.to(dtype)
    rays_c = torch.cat([obs_uv, torch.ones((L, C, 1), dtype=dtype, device=dev)], -1)
    rays_c = rays_c / torch.linalg.norm(rays_c, dim=-1, keepdim=True)
    rays_w = torch.einsum("cij,lcj->lci", R_wc, rays_c)
    pf = _triangulate_dlt(rays_w, p_wc, wgt)                # [L, 3]

    # residuals + jacobians per landmark and clone
    pf_c = torch.einsum("cji,lcj->lci", R_wc, pf[:, None] - p_wc)   # [L, C, 3]
    z_hat = pf_c[..., :2] / torch.clamp_min(pf_c[..., 2:3], 1e-6)
    r = obs_uv - z_hat                                      # [L, C, 2]
    wrow = (m & (pf_c[..., 2] > 0.05)).to(dtype)

    z = torch.clamp_min(pf_c[..., 2], 1e-6)
    zero = torch.zeros_like(z)
    Jproj = torch.stack([
        torch.stack([1.0 / z, zero, -pf_c[..., 0] / z**2], -1),
        torch.stack([zero, 1.0 / z, -pf_c[..., 1] / z**2], -1),
    ], dim=-2)                                              # [L, C, 2, 3]
    R_cw = R_wc.transpose(1, 2)
    # d pf_c / d pf = R_cw ; d pf_c / d dp_clone = -R_cw
    Hf_c = torch.einsum("lcij,cjk->lcik", Jproj, R_cw)      # [L, C, 2, 3]
    # d pf_c / d dth_clone (right perturbation of q_wb):
    #   pf_c = R_bc^T R_wb^T (pf - p_wb) => d pf_c / d dth = R_bc^T skew(R_wb^T (pf - p_wb))
    pf_b = torch.einsum("cji,lcj->lci", R_wb, pf[:, None] - state.clone_p)
    dth_blk = torch.einsum("ij,lcjk->lcik", R_bc.T, skew(pf_b))     # [L, C, 3, 3]
    Hth_c = torch.einsum("lcij,lcjk->lcik", Jproj, dth_blk)         # [L, C, 2, 3]

    # rows [2C, D] per landmark: clone c's (dth, dp) block in its columns
    blk = torch.cat([Hth_c, -Hf_c], -1) * wrow[..., None, None]     # [L, C, 2, 6]
    eye_c = torch.eye(C, dtype=dtype, device=dev)
    Hx = torch.einsum("lcik,cd->lcidk", blk, eye_c).reshape(L, 2 * C, 6 * C)
    Hx = torch.cat([torch.zeros((L, 2 * C, 15), dtype=dtype, device=dev), Hx], -1)
    Hf = (Hf_c * wrow[..., None, None]).reshape(L, 2 * C, 3)
    rvec = (r * wrow[..., None]).reshape(L, 2 * C)

    # left-nullspace projection of Hf: Q2^T Hx, Q2^T r
    Qm, _ = torch.linalg.qr(Hf, mode="complete")            # [L, 2C, 2C]
    N = Qm[..., 3:]                                         # [L, 2C, 2C-3]
    H0 = N.transpose(1, 2) @ Hx                             # [L, rows, D]
    r0 = torch.einsum("lkr,lk->lr", N, rvec)
    nvalid = wrow.sum(-1)
    rows = 2 * C - 3

    # Mahalanobis gate per landmark: r0^T (H0 P H0^T + s I)^-1 r0
    sig2 = cfg.pix_sigma**2
    eye_r = torch.eye(rows, dtype=dtype, device=dev)
    S = H0 @ P @ H0.transpose(1, 2) + sig2 * eye_r
    gamma = torch.einsum("lr,lrs,ls->l", r0, torch.linalg.inv(S), r0)
    dof = torch.clamp_min(2 * nvalid - 3, 1.0)
    keep = (gamma < cfg.chi2_per_dof * dof) & (nvalid >= 2)

    wl = keep.to(dtype)
    Hbig = (H0 * wl[:, None, None]).reshape(L * rows, D)
    rbig = (r0 * wl[:, None]).reshape(L * rows)

    # EKF update (Joseph form)
    HP = Hbig @ P
    S_big = HP @ Hbig.T + sig2 * torch.eye(L * rows, dtype=dtype, device=dev)
    K = torch.linalg.solve(S_big, HP).T                     # [D, L*rows]
    dx = K @ rbig
    IKH = torch.eye(D, dtype=dtype, device=dev) - K @ Hbig
    P = IKH @ P @ IKH.T + sig2 * (K @ K.T)
    P = 0.5 * (P + P.T)
    return _inject(state, cfg, dx)._replace(P=P)


def _inject(state: MSCKFState, cfg: MSCKFConfig, dx) -> MSCKFState:
    C = cfg.num_clones
    q = quat_normalize(quat_mul(state.q, quat_from_small_angle(dx[0:3])))
    dclone = dx[15:].reshape(C, 6)
    cq = quat_normalize(quat_mul(state.clone_q, quat_from_small_angle(dclone[:, :3])))
    return state._replace(q=q, p=state.p + dx[3:6], v=state.v + dx[6:9],
                          bg=state.bg + dx[9:12], ba=state.ba + dx[12:15],
                          clone_q=cq, clone_p=state.clone_p + dclone[:, 3:])
