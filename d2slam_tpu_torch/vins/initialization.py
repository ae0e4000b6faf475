"""Monocular visual-inertial initialization.

Counterpart of ``d2slam_tpu/vins/initialization.py`` (the reference's
VINS-Mono-style SFM initialization, d2vins/src/estimator/
d2vinsstate.cpp:763-1040: 5-pt relative pose + solveGyroscopeBias +
LinearAlignment + RefineGravity; d2vins/src/utils/solve_5pts.cpp
MotionEstimator), used when no stereo or depth gives the scale:

* relative rotation/translation between two keyframes from the
  essential matrix (normalized 8-point + cheirality, RANSAC); the
  hypothesis search runs on the host or, with ``device=``, as one
  batched torch program;
* gyroscope bias from preintegrated rotation residuals (linear LS);
* velocity / gravity / scale from the linear alignment system.

The linear algebra of the last two is small and stays on the host in
float64, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import torch

from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# Essential matrix (normalized 8-point, RANSAC)
# ---------------------------------------------------------------------------


def _essential_from_8pt(r1, r2):
    """r1, r2: [N>=8, 3] unit bearings. Returns E (3x3) or None."""
    A = np.stack([
        r2[:, 0] * r1[:, 0], r2[:, 0] * r1[:, 1], r2[:, 0] * r1[:, 2],
        r2[:, 1] * r1[:, 0], r2[:, 1] * r1[:, 1], r2[:, 1] * r1[:, 2],
        r2[:, 2] * r1[:, 0], r2[:, 2] * r1[:, 1], r2[:, 2] * r1[:, 2],
    ], axis=1)
    _, _, Vt = np.linalg.svd(A)
    E = Vt[-1].reshape(3, 3)
    U, S, Vt2 = np.linalg.svd(E)
    s = (S[0] + S[1]) / 2
    return U @ np.diag([s, s, 0.0]) @ Vt2


def _decompose_essential(E, r1, r2):
    """Pick the (R, t) with max cheirality. Returns 1_T_2 = (R, t unit)
    convention: r2 ~ R^T (p - t)?? We use: x2 = R x1 + t up to scale."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    candidates = []
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            candidates.append((R, t))

    def depth_count(R, t):
        # triangulate each pair: x2 ~ R x1 + t (scale-free)
        n_good = 0
        for a, b in zip(r1, r2):
            # solve [a -b'] [d1 d2]^T = -t with b' = R a? Standard:
            # d2 * b = R (d1 * a) + t
            Ra = R @ a
            M = np.stack([Ra, -b], axis=1)  # [3, 2]
            rhs = -t
            sol, *_ = np.linalg.lstsq(M, rhs, rcond=None)
            if sol[0] > 0 and sol[1] > 0:
                n_good += 1
        return n_good

    best = max(candidates, key=lambda c: depth_count(*c))
    return best  # (R, t): x2_dir = R x1_dir ... with translation t


def _sampson_like_err(E, r1, r2):
    Ex1 = (E @ r1.T).T
    x2E = (r2 @ E)
    num = np.abs(np.sum(r2 * Ex1, axis=1))
    den = np.sqrt(
        Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + x2E[:, 0] ** 2 + x2E[:, 1] ** 2
    )
    return num / np.maximum(den, 1e-12)


def _essential_ransac_device(rays1, rays2, thresh, iters, seed, device):
    """All 8-point hypotheses as one batched torch program on ``device``
    (SURVEY §7 batched-hypothesis RANSAC): [K, 8, 9] coefficient
    matrices -> batched SVD -> rank-2 projection -> one [K, N]
    Sampson gate. Returns the best hypothesis's inlier mask and count.
    The samples come from the host generator of the JAX package's
    device path, so both draw the same hypotheses; N is padded to a
    power of two (at least 128) as there."""
    n = len(rays1)
    N_pad = max(128, int(2 ** np.ceil(np.log2(n))))
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, 8, replace=False) for _ in range(iters)])
    r1 = np.zeros((N_pad, 3), np.float32)
    r2 = np.zeros((N_pad, 3), np.float32)
    r1[:n], r2[:n] = rays1, rays2
    va = np.zeros(N_pad, bool)
    va[:n] = True
    r1, r2, va, idx = (torch.as_tensor(x, device=device) for x in (r1, r2, va, idx))

    a, b = r1[idx], r2[idx]                                   # [K, 8, 3]
    A = torch.einsum("kni,knj->knij", b, a).reshape(-1, 8, 9)
    E = torch.linalg.svd(A)[2][:, -1, :].reshape(-1, 3, 3)
    U, S, Vt2 = torch.linalg.svd(E)
    s = (S[:, 0] + S[:, 1]) / 2
    D = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    E = (U * D[:, None, :]) @ Vt2                             # rank-2 projection
    Ex1 = torch.einsum("kij,nj->kni", E, r1)                  # [K, N, 3]
    x2E = torch.einsum("ni,kij->knj", r2, E)
    num = torch.abs(torch.sum(r2[None] * Ex1, dim=-1))
    den = torch.sqrt(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + x2E[..., 0] ** 2 + x2E[..., 1] ** 2)
    errs = num / torch.clamp_min(den, 1e-12)                  # [K, N]
    counts = torch.sum((errs < thresh) & va[None, :], dim=1)
    best = torch.argmax(counts)
    inl = ((errs[best] < thresh) & va).cpu().numpy()
    return inl[:n], int(counts[best])


def solve_relative_pose(
    rays1: np.ndarray, rays2: np.ndarray,
    thresh: float = 1e-3, iters: int = 100, seed: int = 0,
    device=False,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], np.ndarray]:
    """RANSAC essential-matrix relative pose (reference
    MotionEstimator::solveRelativeRT). Returns (R [3,3], t unit [3],
    inlier mask) with x2 ~ R x1 + t (translation scale free).

    ``device=False`` runs the numpy host loop. Otherwise the hypothesis
    search is one batched torch program on ``device``: ``True`` means
    the CUDA card (raises without one), or a torch device / name such
    as ``"cpu"``. The final fit and decomposition stay on the host."""
    n = len(rays1)
    if n < 10:
        return None, None, np.zeros(n, bool)
    best_inl = np.zeros(n, bool)
    best_E = None
    if device is not False:
        dev = resolve_device(None if device is True else device)
        inl, cnt = _essential_ransac_device(rays1, rays2, thresh, iters, seed, dev)
        if cnt >= 8:
            best_inl = inl
            best_E = _essential_from_8pt(rays1[inl], rays2[inl])
    else:
        rng = np.random.default_rng(seed)
        for _ in range(iters):
            idx = rng.choice(n, 8, replace=False)
            E = _essential_from_8pt(rays1[idx], rays2[idx])
            if E is None:
                continue
            inl = _sampson_like_err(E, rays1, rays2) < thresh
            if inl.sum() > best_inl.sum():
                best_inl, best_E = inl, E
    if best_E is None or best_inl.sum() < 10:
        return None, None, best_inl
    E = _essential_from_8pt(rays1[best_inl], rays2[best_inl])
    R, t = _decompose_essential(E, rays1[best_inl], rays2[best_inl])
    return R, t, best_inl


# ---------------------------------------------------------------------------
# Gyroscope bias from preintegrated rotations
# ---------------------------------------------------------------------------


def solve_gyroscope_bias(rel_rots_visual, pre_list):
    """Linear LS for the gyro bias (reference solveGyroscopeBias):
    for each interval: dq_dbg @ dbg ≈ 2 * vec(pre_dq^{-1} ⊗ q_visual).

    rel_rots_visual: list of [4] visual relative rotations i->j (xyzw).
    pre_list: list of PreintegrationResult (numpy-converted fields).
    Returns [3] bias increment.
    """
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for q_vis, pre in zip(rel_rots_visual, pre_list):
        J = np.asarray(pre.jacobian)[3:6, 12:15]
        dq = np_lie.quat_mul(
            np_lie.quat_conj(np.asarray(pre.delta_q)), np.asarray(q_vis)
        )
        r = 2.0 * dq[:3]
        A += J.T @ J
        b += J.T @ r
    return np.linalg.solve(A + 1e-9 * np.eye(3), b)


# ---------------------------------------------------------------------------
# Linear alignment: velocities, gravity, scale
# ---------------------------------------------------------------------------


def linear_alignment(poses_visual, pre_list, g_norm=9.805):
    """Solve velocities, gravity vector and metric scale from the
    up-to-scale visual poses + preintegrations (reference
    LinearAlignment + RefineGravity, d2vinsstate.cpp:763-1040).

    poses_visual: [K+1, 7] camera/body poses in an arbitrary-scale
    visual frame. pre_list: K preintegrations between them.
    Returns (velocities [K+1, 3] in body frames, gravity_visual [3],
    scale) or None.
    """
    K = len(pre_list)
    n_state = 3 * (K + 1) + 3 + 1  # velocities, gravity, scale
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)
    for k, pre in enumerate(pre_list):
        dt = float(pre.sum_dt)
        Ri = np_lie.quat_to_rotmat(poses_visual[k][3:])
        Rj = np_lie.quat_to_rotmat(poses_visual[k + 1][3:])
        pi, pj = poses_visual[k][:3], poses_visual[k + 1][:3]

        H = np.zeros((6, n_state))
        z = np.zeros(6)
        vi = 3 * k
        vj = 3 * (k + 1)
        gcol = 3 * (K + 1)
        scol = gcol + 3
        # position rows: Ri^T(s*(pj-pi)) = dp + vi*dt*?? (body-frame):
        # dp = Ri^T (s(pj - pi) - vi_w dt + 0.5 g dt^2)
        # with vi expressed in body i: vi_w = Ri vi_b
        H[0:3, vi:vi + 3] = -dt * np.eye(3)
        H[0:3, gcol:gcol + 3] = 0.5 * Ri.T @ np.eye(3) * dt * dt
        H[0:3, scol] = Ri.T @ (pj - pi)
        z[0:3] = np.asarray(pre.delta_p)
        # velocity rows: dv = Ri^T (vj_w - vi_w + g dt)
        H[3:6, vi:vi + 3] = -np.eye(3)
        H[3:6, vj:vj + 3] = Ri.T @ Rj
        H[3:6, gcol:gcol + 3] = Ri.T * dt
        z[3:6] = np.asarray(pre.delta_v)
        A += H.T @ H
        b += H.T @ z
    try:
        x = np.linalg.solve(A + 1e-8 * np.eye(n_state), b)
    except np.linalg.LinAlgError:
        return None
    vels = x[: 3 * (K + 1)].reshape(K + 1, 3)
    g = x[3 * (K + 1): 3 * (K + 1) + 3]
    s = x[-1]
    if s <= 0:
        return None
    g = g / np.linalg.norm(g) * g_norm
    # RefineGravity (reference d2vinsstate.cpp RefineGravity): re-solve
    # with |g| constrained to the sphere — g = g_norm*g_hat + B(g) w,
    # w in the 2-dof tangent — iterating a few times. This removes the
    # scale/gravity-magnitude correlation of the unconstrained solve.
    for _ in range(4):
        g_hat = g / np.linalg.norm(g)
        tmp = np.array([0.0, 0.0, 1.0])
        if abs(g_hat[2]) > 0.9:
            tmp = np.array([1.0, 0.0, 0.0])
        b1 = np.cross(g_hat, tmp); b1 /= np.linalg.norm(b1)
        b2 = np.cross(g_hat, b1)
        B = np.stack([b1, b2], axis=1)  # [3, 2]
        n2 = 3 * (K + 1) + 2 + 1
        A2 = np.zeros((n2, n2))
        r2 = np.zeros(n2)
        for k, pre in enumerate(pre_list):
            dt = float(pre.sum_dt)
            Ri = np_lie.quat_to_rotmat(poses_visual[k][3:])
            Rj = np_lie.quat_to_rotmat(poses_visual[k + 1][3:])
            pi, pj = poses_visual[k][:3], poses_visual[k + 1][:3]
            H = np.zeros((6, n2))
            z = np.zeros(6)
            vi = 3 * k
            vj = 3 * (k + 1)
            wc = 3 * (K + 1)
            sc = wc + 2
            H[0:3, vi:vi + 3] = -dt * np.eye(3)
            H[0:3, wc:wc + 2] = 0.5 * Ri.T @ B * dt * dt
            H[0:3, sc] = Ri.T @ (pj - pi)
            z[0:3] = np.asarray(pre.delta_p) \
                - 0.5 * (Ri.T @ (g_norm * g_hat)) * dt * dt
            H[3:6, vi:vi + 3] = -np.eye(3)
            H[3:6, vj:vj + 3] = Ri.T @ Rj
            H[3:6, wc:wc + 2] = Ri.T @ B * dt
            z[3:6] = np.asarray(pre.delta_v) - (Ri.T @ (g_norm * g_hat)) * dt
            A2 += H.T @ H
            r2 += H.T @ z
        try:
            x2 = np.linalg.solve(A2 + 1e-9 * np.eye(n2), r2)
        except np.linalg.LinAlgError:
            break
        vels = x2[: 3 * (K + 1)].reshape(K + 1, 3)
        w = x2[3 * (K + 1): 3 * (K + 1) + 2]
        s = x2[-1]
        g = g_norm * g_hat + B @ w
        g = g / np.linalg.norm(g) * g_norm
    if s <= 0:
        return None
    return vels, g, float(s)
