"""Ground-truth kinematics and synthetic inputs shared by the simulators
and the smoke run (numpy), and the synthetic circle window of the JAX
package's ``utils/synthetic.make_circle_scene`` packed into the port's
solver containers."""
from __future__ import annotations

import numpy as np
import torch

from d2slam_tpu_torch.factors.residuals import imu_sqrt_info
from d2slam_tpu_torch.imu.preintegration import default_noise_matrix, preintegrate
from d2slam_tpu_torch.pgo.pose_graph import PGOEdges
from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.state import ImuMeas, ProjMeas, VIOState
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.render import render_blobs

GRAVITY = np.array([0.0, 0.0, 9.805])


def circle_gt(t, radius=5.0, omega=0.5, height=2.0):
    """Ground-truth kinematics on a circle, body x along the tangent."""
    c, s = np.cos(omega * t), np.sin(omega * t)
    p = np.array([radius * c, radius * s, height])
    v = np.array([-radius * omega * s, radius * omega * c, 0.0])
    a = np.array([-radius * omega**2 * c, -radius * omega**2 * s, 0.0])
    yaw = omega * t + np.pi / 2
    q = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
    return p, v, a, q


def spiral_pose_graph(n: int, seed: int = 0, pos_noise: float = 0.0):
    """The spiral pose graph of ``examples/bench_pgo_scale.py::big_graph``
    (numpy only): n poses on a rising spiral of 200-pose period, the
    odometry chain plus a loop closure every 10 poses to the same place
    one revolution later, relative poses exact up to Gaussian translation
    noise of ``pos_noise`` m (drawn from ``seed`` as there),
    sqrt-information 10·I. Returns (gt [n, 7], PGOEdges of numpy arrays)."""
    th = 2 * np.pi * np.arange(n) / 200.0
    gt = np.zeros((n, 7))
    gt[:, 0] = 15 * np.cos(th)
    gt[:, 1] = 15 * np.sin(th)
    gt[:, 2] = 0.02 * np.arange(n)
    gt[:, 5] = np.sin(th / 2)
    gt[:, 6] = np.cos(th / 2)
    ii = np.array(list(range(n - 1)) + list(range(0, n - 200, 10)), np.int32)
    jj = np.array([k + 1 for k in range(n - 1)] + [k + 200 for k in range(0, n - 200, 10)],
                  np.int32)
    rel = np.stack([np_lie.pose_compose(np_lie.pose_inverse(gt[i]), gt[j])
                    for i, j in zip(ii, jj)])
    E = len(ii)
    if pos_noise:
        rel[:, :3] += np.random.default_rng(seed).normal(0, pos_noise, (E, 3))
    return gt, PGOEdges(i=ii, j=jj, rel=rel.astype(np.float32),
                        sqrt_info=np.tile(np.eye(6, dtype=np.float32) * 10.0, (E, 1, 1)),
                        valid=np.ones(E, bool))


def stereo_replay_sequence(sim, n_frames: int, H: int, W: int, fx: float,
                           t_offset: float = 1.0, imu_lead: float = 0.3):
    """A ``CircleSim`` stereo scene as a dataset holds it: the sim's IMU
    from ``imu_lead`` s before the first frame, ``n_frames`` pairs
    rendered with ``render_blobs`` (focal ``fx``, principal point at the
    image centre, the intensities drawn next from ``sim.rng``) and
    quantized to ``uint8`` by truncation as the EuRoC writers do, and the
    ground-truth poses. Stamps are the sim's times plus ``t_offset`` (ROS
    time is unsigned) on the nanosecond grid of EuRoC files, so a
    dataset written from this sequence reads back exactly these stamps.

    Returns (imu [(t, acc, gyr)], frames [(t, [left, right])],
    gt [(t, pose7)])."""
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))

    def stamp(t):
        return int(round((t + t_offset) * 1e9)) * 1e-9

    imu = [(stamp(t), a, g) for (t, a, g)
           in sim.imu_samples(-imu_lead, (n_frames - 1) / sim.frame_hz + 1e-6)]
    frames, gt = [], []
    for k in range(n_frames):
        t = k / sim.frame_hz
        pose, _ = sim.gt_pose(t)
        imgs = [np.clip(render_blobs(sim.lms, np_lie.pose_compose(pose, sim.ext[c]),
                                     fx, fx, W / 2, H / 2, H, W, intensities=inten) * 255.0,
                        0, 255).astype(np.uint8)
                for c in range(2)]
        frames.append((stamp(t), imgs))
        gt.append((stamp(t), pose))
    return imu, frames, gt


def replay_events(imu, frames):
    """Merge IMU samples and frames into the time-ordered event stream of
    ``EuRoCDataset.play``: ('imu', t, acc, gyr) for each sample up to a
    frame's stamp, then ('frame', t, images); the rest of the IMU last."""
    i = 0
    for (t, imgs) in frames:
        while i < len(imu) and imu[i][0] <= t:
            yield ("imu", *imu[i])
            i += 1
        yield ("frame", t, imgs)
    for s in imu[i:]:
        yield ("imu", *s)


def make_circle_scene(layout: VIOLayout, n_frames: int, n_landmarks: int, dt_frame: float = 0.25,
                      imu_hz: int = 400, pix_noise_rad: float = 0.0, imu_acc_noise: float = 0.0,
                      imu_gyr_noise: float = 0.0, acc_n: float = 0.1, gyr_n: float = 0.05,
                      acc_w: float = 0.002, gyr_w: float = 0.0004, baseline: float = 0.1,
                      seed: int = 0, dtype=torch.float64, device=None):
    """Ground-truth state and measurement containers of an ``n_frames``
    stereo window on ``circle_gt`` (the JAX package's make_circle_scene:
    the same seeded draws in the same order, so the same scene). Returns
    dict(gt_state, imu, proj, landmarks_w, gravity, times)."""
    rng = np.random.default_rng(seed)
    if n_frames > layout.W:
        raise ValueError(f"{n_frames} frames do not fit a window of {layout.W}")
    times = np.arange(n_frames) * dt_frame
    poses = np.tile([0, 0, 0, 0, 0, 0, 1.0], (layout.W, 1))
    sb = np.zeros((layout.W, 9))
    for k, t in enumerate(times):
        p, v, _, q = circle_gt(t)
        poses[k, :3], poses[k, 3:] = p, q
        sb[k, :3] = v
    frame_valid = np.arange(layout.W) < n_frames
    # camera z forward == body x, two cameras ``baseline`` apart
    q_bc = np_lie.rotmat_to_quat(np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]]))
    ext = np.zeros((layout.C, 7))
    ext[0] = np.concatenate([[0.0, baseline / 2, 0.0], q_bc])
    ext[1] = np.concatenate([[0.0, -baseline / 2, 0.0], q_bc])

    # landmarks scattered outside the trajectory's ring
    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(8.0, 14.0, n_landmarks)
    lz = rng.uniform(0.0, 4.0, n_landmarks)
    lms_w = np.stack([rad * np.cos(ang), rad * np.sin(ang), lz], axis=1)

    def ray(fk, ck, pw):
        T = np_lie.pose_compose(poses[fk], ext[ck])
        pc = np_lie.quat_to_rotmat(T[3:]).T @ (pw - T[:3])
        d = np.linalg.norm(pc)
        return pc / d, d, pc[2] > 0.5

    obs = []   # (fi, fj, ci, cj, lm slot, ray_i, ray_j, depth_j)
    inv_dep = np.full(layout.L, 0.2)
    lm_valid = np.zeros(layout.L, bool)
    for lm in range(min(n_landmarks, layout.L)):
        views = [(f, c) + ray(f, c, lms_w[lm])[:2] for f in range(n_frames) for c in range(2)
                 if ray(f, c, lms_w[lm])[2]]
        if len(views) < 4:
            continue
        f0, c0, r0, d0 = views[0]
        inv_dep[lm] = 1.0 / d0
        lm_valid[lm] = True
        for (f, c, rv, d) in views[1:]:
            if pix_noise_rad > 0:
                n2 = rng.normal(0, pix_noise_rad, 3)
                rv = rv + n2 - rv * (rv @ n2)
                rv = rv / np.linalg.norm(rv)
            obs.append((f0, f, c0, c, lm, r0, rv, d))
    M = layout.M
    if len(obs) > M:
        obs = [obs[i] for i in sorted(rng.choice(len(obs), M, replace=False))]
    pm = dict(frame_i=np.zeros(M, np.int64), frame_j=np.zeros(M, np.int64),
              cam_i=np.zeros(M, np.int64), cam_j=np.zeros(M, np.int64), lm=np.zeros(M, np.int64),
              ray_i=np.tile([0.0, 0, 1], (M, 1)), ray_j=np.tile([0.0, 0, 1], (M, 1)),
              vel_i=np.zeros((M, 3)), vel_j=np.zeros((M, 3)), td_i=np.zeros(M), td_j=np.zeros(M),
              dep_j=np.zeros(M), has_dep=np.zeros(M, bool), valid=np.zeros(M, bool))
    for m, (fi, fj, ci, cj, lm, ri, rj, dj) in enumerate(obs):
        pm["frame_i"][m], pm["frame_j"][m], pm["cam_i"][m], pm["cam_j"][m] = fi, fj, ci, cj
        pm["lm"][m], pm["ray_i"][m], pm["ray_j"][m], pm["dep_j"][m] = lm, ri, rj, dj
        pm["valid"][m] = True

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    proj = ProjMeas(**{k: t(v, dtype if v.dtype == np.float64 else
                            torch.long if v.dtype == np.int64 else torch.bool)
                       for k, v in pm.items()})

    # IMU between consecutive frames
    n_samp, K = layout.N_IMU_SAMPLES, layout.W - 1
    dts = np.zeros((K, n_samp))
    accs = np.zeros((K, n_samp, 3))
    gyrs = np.zeros((K, n_samp, 3))
    mask = np.zeros((K, n_samp), bool)
    nk = int(dt_frame * imu_hz)
    if nk + 1 > n_samp:
        raise ValueError(f"{nk + 1} IMU samples per interval exceed N_IMU_SAMPLES={n_samp}")
    for k in range(max(n_frames - 1, 0)):
        for i in range(nk + 1):
            _, _, a, q = circle_gt(times[k] + i / imu_hz)
            acc_b = np_lie.quat_to_rotmat(q).T @ (a + GRAVITY)   # specific force
            gyr_b = np.array([0.0, 0.0, 0.5])
            if imu_acc_noise > 0:
                acc_b = acc_b + rng.normal(0, imu_acc_noise, 3)
            if imu_gyr_noise > 0:
                gyr_b = gyr_b + rng.normal(0, imu_gyr_noise, 3)
            accs[k, i], gyrs[k, i] = acc_b, gyr_b
            dts[k, i] = 0.0 if i == 0 else 1.0 / imu_hz
            mask[k, i] = i > 0
    zeros3 = torch.zeros((K, 3), dtype=dtype, device=device)
    pre = preintegrate(t(dts), t(accs), t(gyrs), t(mask, torch.bool), zeros3, zeros3,
                       default_noise_matrix(acc_n, gyr_n, acc_w, gyr_w, dtype=dtype,
                                            device=device))
    imu = ImuMeas(frame_i=torch.arange(K, device=device),
                  frame_j=torch.arange(1, K + 1, device=device),
                  valid=t(np.arange(K) < n_frames - 1, torch.bool), pre=pre,
                  sqrt_info=imu_sqrt_info(pre.covariance))
    lm_pos = np.zeros((layout.L, 3))
    lm_pos[:min(len(lms_w), layout.L)] = lms_w[:layout.L]
    gt_state = VIOState(poses=t(poses), sb=t(sb), ext=t(ext), td=t(0.0), inv_dep=t(inv_dep),
                        frame_valid=t(frame_valid, torch.bool), lm_valid=t(lm_valid, torch.bool),
                        lm_pos=t(lm_pos))
    return dict(gt_state=gt_state, imu=imu, proj=proj, landmarks_w=lms_w,
                gravity=t(GRAVITY), times=times)


def default_col_free(layout: VIOLayout, state: VIOState, fix_first_pose: bool = True,
                     fix_ext: bool = True, fix_td: bool = True) -> torch.Tensor:
    """Free-column mask: valid frames free, the gauge on the first valid
    frame's pose."""
    fv = state.frame_valid.cpu().numpy()
    free = np.zeros(layout.D_pad, bool)
    for w in np.flatnonzero(fv):
        free[15 * w: 15 * w + 15] = True
    if fix_first_pose:
        first = int(np.argmax(fv)) if fv.any() else 0
        free[15 * first: 15 * first + 6] = False
    if not fix_ext:
        free[15 * layout.W: 15 * layout.W + 6 * layout.C] = True
    if not fix_td:
        free[layout.td_col] = True
    return torch.as_tensor(free, device=state.frame_valid.device)
