"""Perspective-n-Point RANSAC on bearing vectors.

Counterpart of ``d2slam_tpu/frontend/pnp.py``; the host path is its
numpy code unchanged, so both give the same result for a seed.

Replaces the reference's OpenCV solvePnPRansac / OpenGV non-central
RANSAC PnP (reference: d2frontend/src/pnp_utils.cpp:11-93
computeRelativePosePnP / computePosePnPnonCentral + acceptance gates).
Minimal solver: 6-point DLT on the projection matrix; consensus by
angular reprojection error on the unit sphere; refinement by
Gauss-Newton on the inlier set. Multi-camera ("non-central") input is
handled by rotating each bearing into the body frame and estimating
the body pose directly when camera extrinsics are given.

``ransac_pnp(..., device=...)`` runs the hypothesis search instead as
one batched torch program (``_ransac_pnp_device_kernel``): batched SVDs
and a [K, N] scoring pass on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device


def _dlt_pose(rays: np.ndarray, pts_w: np.ndarray) -> Optional[np.ndarray]:
    """Linear PnP from >=6 correspondences.

    rays: [N, 3] unit bearings in CAMERA frame; pts_w: [N, 3] world.
    Returns T_w_cam [7] or None.
    """
    n = len(rays)
    A = np.zeros((2 * n, 12))
    for i in range(n):
        X = np.append(pts_w[i], 1.0)
        x, y, z = rays[i]
        # two independent rows of [ray]_x P X = 0
        A[2 * i, 0:4] = -z * X
        A[2 * i, 8:12] = x * X
        A[2 * i + 1, 4:8] = -z * X
        A[2 * i + 1, 8:12] = y * X
    _, _, Vt = np.linalg.svd(A)
    P = Vt[-1].reshape(3, 4)
    R_raw, t_raw = P[:, :3], P[:, 3]
    # project to rotation
    U, S, Vt2 = np.linalg.svd(R_raw)
    det = np.linalg.det(U @ Vt2)
    R = U @ np.diag([1.0, 1.0, det]) @ Vt2
    scale = np.mean(S) * det
    if abs(scale) < 1e-12:
        return None
    t = t_raw / scale
    # cheirality: most points in front
    depth = (R @ pts_w.T + t[:, None])[2]
    if np.median(depth) < 0:
        R = U @ np.diag([1.0, 1.0, -det]) @ Vt2
        t = -t
    # T_cam_w -> T_w_cam
    q = np_lie.rotmat_to_quat(R.T)
    return np.concatenate([-(R.T @ t), q])


def _planar_pose(rays: np.ndarray, pts_w: np.ndarray
                 ) -> Optional[np.ndarray]:
    """Pose from >=4 COPLANAR correspondences via plane homography.

    The 6-point DLT above is degenerate when the world points lie on a
    plane (rank-deficient null space) — but planar scenes are exactly
    what corridor/wall loop closures see, and the reference's
    cv::solvePnPRansac / OpenGV solvers handle them
    (d2frontend/src/pnp_utils.cpp:11-93). Strategy: build an in-plane
    frame, estimate the ray<-plane homography H = [R e1, R e2, R c + t]
    by DLT, and decompose with orthonormalization.
    Returns T_w_cam [7] or None.
    """
    n = len(rays)
    if n < 4:
        return None
    c = pts_w.mean(axis=0)
    Q = pts_w - c
    _, S, Vt = np.linalg.svd(Q, full_matrices=False)
    xy = Q @ Vt[:2].T                      # plane coordinates [N, 2]
    m = np.concatenate([xy, np.ones((n, 1))], axis=1)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y, z = rays[i]
        A[2 * i, 0:3] = -z * m[i]
        A[2 * i, 6:9] = x * m[i]
        A[2 * i + 1, 3:6] = -z * m[i]
        A[2 * i + 1, 6:9] = y * m[i]
    _, _, VtA = np.linalg.svd(A)
    H = VtA[-1].reshape(3, 3)
    lam = np.sqrt(np.linalg.norm(H[:, 0]) * np.linalg.norm(H[:, 1]))
    if lam < 1e-12:
        return None
    # plane frame rows [e1; e2; e1 x e2] (guaranteed right-handed)
    F = np.stack([Vt[0], Vt[1], np.cross(Vt[0], Vt[1])])
    for sign in (1.0, -1.0):
        G = sign * H / lam
        g3 = np.cross(G[:, 0], G[:, 1])
        Gm = np.stack([G[:, 0], G[:, 1], g3], axis=1)
        U, _, Vt2 = np.linalg.svd(Gm)
        G_orth = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt2)]) @ Vt2
        R = G_orth @ F      # camera-from-world: G maps plane coords
        t = sign * H[:, 2] / lam - R @ c
        depth = (R @ pts_w.T + t[:, None])[2]
        if np.median(depth) > 0:
            q = np_lie.rotmat_to_quat(R.T)
            return np.concatenate([-(R.T @ t), q])
    return None


def _pose_hypotheses(rays: np.ndarray, pts_w: np.ndarray) -> list:
    """Candidate poses from one minimal sample: the 6-point DLT, plus
    the planar decomposition when the sample is (near-)coplanar.

    np.linalg.svd can raise LinAlgError on non-convergence for a
    degenerate sample — treat that as "no hypothesis from this sample"
    instead of crashing the caller (e.g. LoopDetector.detect)."""
    out = []
    try:
        T = _dlt_pose(rays, pts_w)
        if T is not None:
            out.append(T)
        Q = pts_w - pts_w.mean(axis=0)
        S = np.linalg.svd(Q, compute_uv=False)
        if S[0] > 1e-9 and S[2] / S[0] < 0.1:  # flat sample: DLT unreliable
            T = _planar_pose(rays, pts_w)
            if T is not None:
                out.append(T)
    except np.linalg.LinAlgError:
        pass
    return out


def _angular_errors(T_w_cam, rays, pts_w):
    R = np_lie.quat_to_rotmat(T_w_cam[3:])
    pc = (pts_w - T_w_cam[:3]) @ R
    norms = np.linalg.norm(pc, axis=1)
    pc_unit = pc / np.maximum(norms[:, None], 1e-12)
    behind = pc[:, 2] < 0
    err = np.linalg.norm(pc_unit - rays, axis=1)
    err[behind] = np.inf
    return err


def _svd_null(A):
    """Right singular vector of the smallest singular value, per batch."""
    return torch.linalg.svd(A)[2][:, -1, :]


def _rot_from_svd(U, Vt, sign):
    """U diag(1, 1, sign) Vt, batched."""
    D = torch.ones(U.shape[:-1], dtype=U.dtype, device=U.device)
    D = torch.cat([D[:, :2], sign[:, None]], dim=-1)
    return (U * D[:, None, :]) @ Vt


def _median(x):
    """Median over the last axis, the mean of the two middle values for an
    even count (numpy's and jnp.median's convention; torch.median takes the
    lower one)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def _ransac_pnp_device_kernel(rays, pts_w, valid, idx, thresh):
    """All RANSAC hypotheses as one batched torch program: K 6-point
    DLTs are a [K, 12, 12] batched SVD, consensus scoring one [K, N]
    batched angular check. ``rays``/``pts_w`` padded to a fixed N with
    ``valid``; ``idx`` [K, 6] sample indices. Each sample gives a
    6-point-DLT hypothesis and a planar-homography hypothesis (the
    batched ``_planar_pose``); the pose returned per sample is whichever
    scored more inliers. Returns (R_cw [K, 3, 3], t [K, 3], n_inliers [K]).

    Singular vectors are defined up to sign, and LAPACK, cuSOLVER and
    XLA pick differently: the determinant fix-up (a proper rotation,
    scale signed by det) and the cheirality flip below make the
    hypothesis independent of that choice."""
    X = torch.cat([pts_w[idx], torch.ones_like(pts_w[idx][..., :1])], dim=-1)  # [K, 6, 4]
    r = rays[idx]
    x, y, z = r[..., 0:1], r[..., 1:2], r[..., 2:3]
    zero = torch.zeros_like(X)
    rows1 = torch.cat([-z * X, zero, x * X], dim=-1)
    rows2 = torch.cat([zero, -z * X, y * X], dim=-1)
    P = _svd_null(torch.cat([rows1, rows2], dim=1)).reshape(-1, 3, 4)  # A: [K, 12, 12]
    R_raw, t_raw = P[:, :, :3], P[:, :, 3]
    U, S, Vt2 = torch.linalg.svd(R_raw)
    det = torch.linalg.det(U @ Vt2)
    R = _rot_from_svd(U, Vt2, det)
    scale = S.mean(dim=-1) * det
    ok = scale.abs() > 1e-12
    t = t_raw / torch.where(ok, scale, torch.ones_like(scale))[:, None]

    def score(R, t):
        pc = torch.einsum("kij,nj->kni", R, pts_w) + t[:, None, :]  # [K, N, 3]
        nrm = torch.clamp_min(torch.linalg.norm(pc, dim=-1, keepdim=True), 1e-12)
        err = torch.linalg.norm(pc / nrm - rays, dim=-1)
        inl = (err < thresh) & (pc[..., 2] > 0) & valid
        med_z = _median(torch.where(valid, pc[..., 2], torch.ones_like(pc[..., 2])))
        return inl.sum(dim=-1), med_z

    # cheirality: if most points are behind, flip (the second SVD sign)
    n_inl, med_z = score(R, t)
    flip = med_z < 0
    R = torch.where(flip[:, None, None], _rot_from_svd(U, Vt2, -det), R)
    t = torch.where(flip[:, None], -t, t)
    n_inl = torch.where(flip, score(R, t)[0], n_inl) * ok

    # ---- planar-homography hypotheses (batched _planar_pose) ----
    pts_s = pts_w[idx]                                        # [K, 6, 3]
    c = pts_s.mean(dim=1)
    Q = pts_s - c[:, None]
    Vtp = torch.linalg.svd(Q, full_matrices=False)[2]         # [K, 3, 3]
    xy = torch.einsum("knj,kij->kni", Q, Vtp[:, :2])          # [K, 6, 2]
    m = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    zero3 = torch.zeros_like(m)
    hrows1 = torch.cat([-z * m, zero3, x * m], dim=-1)
    hrows2 = torch.cat([zero3, -z * m, y * m], dim=-1)
    H = _svd_null(torch.cat([hrows1, hrows2], dim=1)).reshape(-1, 3, 3)  # Ah: [K, 12, 9]
    lam = torch.sqrt(torch.linalg.norm(H[:, :, 0], dim=-1) * torch.linalg.norm(H[:, :, 1], dim=-1))
    ok_h = lam > 1e-12
    Hn = H / torch.where(ok_h, lam, torch.ones_like(lam))[:, None, None]
    F = torch.stack([Vtp[:, 0], Vtp[:, 1], torch.linalg.cross(Vtp[:, 0], Vtp[:, 1], dim=-1)],
                    dim=1)

    def planar(sign):
        g1, g2 = sign * Hn[:, :, 0], sign * Hn[:, :, 1]
        Gm = torch.stack([g1, g2, torch.linalg.cross(g1, g2, dim=-1)], dim=-1)
        Ug, _, Vg = torch.linalg.svd(Gm)
        Rp = _rot_from_svd(Ug, Vg, torch.linalg.det(Ug @ Vg)) @ F
        tp = sign * Hn[:, :, 2] - torch.einsum("kij,kj->ki", Rp, c)
        return Rp, tp, score(Rp, tp)[0]

    Rp1, tp1, np1 = planar(1.0)
    Rp2, tp2, np2 = planar(-1.0)
    use2 = np2 > np1
    Rp = torch.where(use2[:, None, None], Rp2, Rp1)
    tp = torch.where(use2[:, None], tp2, tp1)
    npl = torch.where(use2, np2, np1) * ok_h

    better = npl > n_inl
    R = torch.where(better[:, None, None], Rp, R)
    t = torch.where(better[:, None], tp, t)
    return R, t, torch.where(better, npl, n_inl)


def _ransac_pnp_device(rays, pts_w, thresh, iters, seed, device):
    """Batched hypothesis search on ``device``. Returns T_w_cam or None.
    The samples come from the host generator of the JAX package's device
    path, so both draw the same hypotheses."""
    n = len(rays)
    N_pad = max(128, int(2 ** np.ceil(np.log2(n))))
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, 6, replace=False) for _ in range(iters)])
    rp = np.zeros((N_pad, 3), np.float32)
    pp = np.zeros((N_pad, 3), np.float32)
    rp[:n], pp[:n] = rays, pts_w
    va = np.zeros(N_pad, bool)
    va[:n] = True
    R, t, n_inl = _ransac_pnp_device_kernel(
        torch.as_tensor(rp, device=device), torch.as_tensor(pp, device=device),
        torch.as_tensor(va, device=device), torch.as_tensor(idx, device=device), thresh)
    best = int(torch.argmax(n_inl))
    if int(n_inl[best]) == 0:
        return None
    Rb = R[best].double().cpu().numpy()
    tb = t[best].double().cpu().numpy()
    return np.concatenate([-(Rb.T @ tb), np_lie.rotmat_to_quat(Rb.T)])


def ransac_pnp(
    rays: np.ndarray,        # [N, 3] unit bearings in camera frame
    pts_w: np.ndarray,       # [N, 3] world points
    thresh: float = 8.0 / 460.0,   # angular gate (~px / focal)
    iters: int = 100,
    min_inliers: int = 15,
    refine_iters: int = 5,
    seed: int = 0,
    device=False,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Returns (T_w_cam [7] or None, inlier mask [N]).

    ``device=False`` runs the numpy host loop. Otherwise the hypothesis
    search is one batched torch program (N padded to a power of two) on
    ``device``: ``True`` means the CUDA card (raises without one), or a
    torch device / name such as ``"cpu"``. Refinement stays on the host."""
    n = len(rays)
    if n < 8:
        return None, np.zeros(n, bool)
    best_T, best_inl = None, np.zeros(n, bool)
    if device is not False:
        dev = resolve_device(None if device is True else device)
        T = _ransac_pnp_device(rays, pts_w, thresh, iters, seed, dev)
        if T is not None:
            best_T = T
            best_inl = _angular_errors(T, rays, pts_w) < thresh
    else:
        rng = np.random.default_rng(seed)
        for _ in range(iters):
            idx = rng.choice(n, 6, replace=False)
            for T in _pose_hypotheses(rays[idx], pts_w[idx]):
                err = _angular_errors(T, rays, pts_w)
                inl = err < thresh
                if inl.sum() > best_inl.sum():
                    best_T, best_inl = T, inl
    if best_T is None or best_inl.sum() < min_inliers:
        return None, best_inl
    # refine on inliers: re-fit (DLT or planar) on the consensus set
    T = best_T
    for _ in range(refine_iters):
        improved = False
        for T_new in _pose_hypotheses(rays[best_inl], pts_w[best_inl]):
            err = _angular_errors(T_new, rays, pts_w)
            new_inl = err < thresh
            if new_inl.sum() >= best_inl.sum():
                T, best_inl, improved = T_new, new_inl, True
        if not improved:
            break
    return T, best_inl


def ransac_pnp_body(
    rays_cam: np.ndarray,     # [N, 3] unit bearings in each obs camera
    cam_idx: np.ndarray,      # [N] which camera
    extrinsics: np.ndarray,   # [C, 7] body_T_cam
    pts_w: np.ndarray,
    **kw,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Non-central PnP: estimate the BODY pose from multi-camera
    bearings (reference computePosePnPnonCentral). Strategy: solve
    single-camera PnP on the dominant camera, map to body, then refine
    the inlier set across all cameras by angular gating in each camera.
    """
    cams, counts = np.unique(cam_idx, return_counts=True)
    main_cam = int(cams[np.argmax(counts)])
    sel = cam_idx == main_cam
    T_w_cam, _ = ransac_pnp(rays_cam[sel], pts_w[sel], **kw)
    if T_w_cam is None:
        return None, np.zeros(len(rays_cam), bool)
    T_w_body = np_lie.pose_compose(
        T_w_cam, np_lie.pose_inverse(extrinsics[main_cam])
    )
    # global inlier mask across all cameras
    thresh = kw.get("thresh", 8.0 / 460.0)
    inl = np.zeros(len(rays_cam), bool)
    for c in cams:
        m = cam_idx == c
        T_wc = np_lie.pose_compose(T_w_body, extrinsics[int(c)])
        inl[m] = _angular_errors(T_wc, rays_cam[m], pts_w[m]) < thresh
    return T_w_body, inl


def ransac_homography(pts_a: np.ndarray, pts_b: np.ndarray,
                      thresh: float, iters: int = 100,
                      seed: int = 0) -> np.ndarray:
    """Inlier mask of a RANSAC plane homography b -> a on normalized
    image-plane points [N, 2].

    Match-pruning gate of the reference loop matcher
    (enable_homography_test: cv::findHomography(..., RANSAC, 10.0),
    d2frontend/src/loop_detector.cpp:610-617 — matches inconsistent
    with the dominant planar motion are dropped before PnP). Hypothesis
    fitting is 4-point DLT; all hypotheses are scored vectorized.
    ``thresh`` is in normalized-plane units (pixels / focal length).
    """
    n = len(pts_a)
    if n < 4:
        return np.ones(n, bool)
    rng = np.random.default_rng(seed)
    one = np.ones((n, 1))
    hb = np.concatenate([pts_b, one], axis=1)            # [N, 3]
    best_mask = np.ones(n, bool)
    best_inl = -1
    for _ in range(iters):
        sel = rng.choice(n, 4, replace=False)
        A = np.zeros((8, 9))
        for k, i in enumerate(sel):
            x, y = pts_b[i]
            u, v = pts_a[i]
            A[2 * k] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
            A[2 * k + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
        try:
            _, s, vt = np.linalg.svd(A)
        except np.linalg.LinAlgError:
            continue  # degenerate sample: skip this hypothesis
        H = vt[-1].reshape(3, 3)
        proj = hb @ H.T                                   # [N, 3]
        w = proj[:, 2]
        ok_w = np.abs(w) > 1e-8
        uv = proj[:, :2] / np.where(ok_w, w, 1.0)[:, None]
        err = np.linalg.norm(uv - pts_a, axis=1)
        mask = ok_w & (err < thresh)
        if mask.sum() > best_inl:
            best_inl = int(mask.sum())
            best_mask = mask
    return best_mask
