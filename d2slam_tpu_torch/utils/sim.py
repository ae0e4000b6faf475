"""Full synthetic sequence simulator feeding the estimator like a
frontend would: IMU stream + per-frame landmark observations with ids.

Serves as the dataset-free integration harness (the reference validates
against rosbag datasets; this provides exact ground truth instead).
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.synthetic import GRAVITY
from d2slam_tpu_torch.vins.types import CameraObservations, FrontendFrame


def circle_gt_ramp(t, radius=5.0, omega=0.5, height=2.0, tau=1.0):
    """Circle trajectory starting from REST at t=0 (physically
    consistent with a static-IMU initialization): angular position
    theta(t) = omega*(t - tau*(1-exp(-t/tau))), so theta'(0)=0.

    Returns (p, v, a, q, gyro_z)."""
    if t <= 0:
        th, dth, ddth = 0.0, 0.0, 0.0
    else:
        e = np.exp(-t / tau)
        th = omega * (t - tau * (1.0 - e))
        dth = omega * (1.0 - e)
        ddth = omega / tau * e
    c, s = np.cos(th), np.sin(th)
    p = np.array([radius * c, radius * s, height])
    v = radius * dth * np.array([-s, c, 0.0])
    a = radius * ddth * np.array([-s, c, 0.0]) - radius * dth * dth * np.array(
        [c, s, 0.0]
    )
    yaw = th + np.pi / 2
    q = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
    return p, v, a, q, dth


def quadcam_extrinsics(n_views: int = 4, radius: float = 0.05) -> np.ndarray:
    """Ring of outward-facing cameras at equal yaw steps: the virtual
    pinhole views of a FOURCORNER_FISHEYE rig (reference quadcam:
    4 fisheyes at 90 deg, undistorted to pinholes by FisheyeUndist)."""
    R_bc = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])  # fwd-facing
    out = []
    for v in range(n_views):
        yaw = 2 * np.pi * v / n_views
        c, s = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0, 0, 1.0]])
        q = np_lie.rotmat_to_quat(Rz @ R_bc)
        p = Rz @ np.array([radius, 0.0, 0.0])
        out.append(np.concatenate([p, q]))
    return np.stack(out)


def fisheye_ring_extrinsics(baseline: float = 0.3) -> np.ndarray:
    """[4, 7] body_T_cam of 4 outward fisheyes at 90 deg yaw steps about
    the camera-frame y axis, each displaced ALONG its optical axis (the
    quadrotor-arm geometry): adjacent centers then sit ``baseline``
    apart, perpendicular to the pair's virtual view direction, which is
    the rectified-pair condition the disparity model (disp = f*B/z)
    assumes."""
    radius = baseline / np.sqrt(2.0)
    ext = np.zeros((4, 7))
    for i in range(4):
        yaw = np.deg2rad(90.0 * i)
        q = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)])
        R = np_lie.quat_to_rotmat(q)
        ext[i] = np.concatenate([R @ [0.0, 0.0, radius], np_lie.rotmat_to_quat(R)])
    return ext


def default_extrinsics(baseline=0.1) -> np.ndarray:
    R_bc = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    q_bc = np_lie.rotmat_to_quat(R_bc)
    return np.stack([
        np.concatenate([[0.0, baseline / 2, 0.0], q_bc]),
        np.concatenate([[0.0, -baseline / 2, 0.0], q_bc]),
    ])


class CircleSim:
    """Drone on a circle observing a ring of landmarks."""

    def __init__(
        self,
        n_landmarks=300,
        frame_hz=8.0,
        imu_hz=400,
        pix_noise_rad=0.0,
        acc_noise=0.0,
        gyr_noise=0.0,
        acc_bias=(0.0, 0.0, 0.0),
        gyr_bias=(0.0, 0.0, 0.0),
        max_obs_per_frame=60,
        seed=0,
        baseline=0.1,
        dynamic_start=False,
        phase=0.0,
        extrinsics=None,
        fov_cos=0.7,
        cam_td=0.0,
        wobble=0.0,
        wobble_hz=0.7,
    ):
        self.rng = np.random.default_rng(seed)
        ang = self.rng.uniform(0, 2 * np.pi, n_landmarks)
        rad = self.rng.uniform(8.0, 14.0, n_landmarks)
        lz = self.rng.uniform(0.0, 4.0, n_landmarks)
        self.lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), lz], axis=1)
        self.frame_hz = frame_hz
        self.imu_hz = imu_hz
        self.pix_noise = pix_noise_rad
        self.acc_noise = acc_noise
        self.gyr_noise = gyr_noise
        self.acc_bias = np.asarray(acc_bias)
        self.gyr_bias = np.asarray(gyr_bias)
        self.max_obs = max_obs_per_frame
        self.fov_cos = fov_cos  # cos(half FOV) visibility gate
        # default stereo rig; pass [C, 7] body_T_cam for other rigs
        # (e.g. a 4-view quadcam ring, reference FOURCORNER_FISHEYE)
        self.ext = (np.asarray(extrinsics, np.float64)
                    if extrinsics is not None else default_extrinsics(baseline))
        self.omega = 0.5
        self.dynamic_start = dynamic_start
        # rigid world-yaw offset of the whole trajectory (multi-drone
        # sims put each drone at a different circle phase; body-frame
        # IMU readings are invariant under world yaw, so the same
        # generator stays physically consistent)
        self.phase = phase
        c, s = np.cos(phase), np.sin(phase)
        self._Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        self._qz = np.array([0.0, 0.0, np.sin(phase / 2), np.cos(phase / 2)])
        # camera-IMU time offset: images are CAPTURED at stamp + cam_td
        # but published with the IMU-clock stamp (the td the reference's
        # projection factors estimate online, projectionTwoFrameOneCam
        # Factor.cpp:34-76); frames then carry FD ray velocities so the
        # td correction has a lever arm
        self.cam_td = cam_td
        # attitude wobble (roll/pitch sinusoid) for extrinsic-calibration
        # observability — yaw-only motion leaves extrinsic directions
        # unobservable; gyro follows by finite difference of q(t)
        self.wobble = wobble
        self.wobble_hz = wobble_hz

    def _gt(self, t):
        if self.dynamic_start:
            from d2slam_tpu_torch.utils.synthetic import circle_gt

            p, v, a, q = circle_gt(t)
        else:
            p, v, a, q, _ = circle_gt_ramp(t)
        if self.phase != 0.0:
            p = self._Rz @ p
            v = self._Rz @ v
            a = self._Rz @ a
            q = np_lie.quat_mul(self._qz, q)
        if self.wobble > 0.0:
            w = 2 * np.pi * self.wobble_hz * max(t, 0.0)
            roll = self.wobble * np.sin(w)
            pitch = self.wobble * np.cos(w) * (1 - np.exp(-max(t, 0.0)))
            qr = np.array([np.sin(roll / 2), 0, 0, np.cos(roll / 2)])
            qp = np.array([0, np.sin(pitch / 2), 0, np.cos(pitch / 2)])
            q = np_lie.quat_mul(q, np_lie.quat_mul(qr, qp))
        if self.dynamic_start:
            return p, v, a, q, self.omega
        e = np.exp(-max(t, 0.0) / 1.0)
        return p, v, a, q, self.omega * (1.0 - e)

    def gt_pose(self, t):
        p, v, _, q, _ = self._gt(t)
        return np.concatenate([p, q]), v

    def imu_samples(self, t0, t1) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        out = []
        n0 = int(np.ceil(t0 * self.imu_hz - 1e-9))
        n1 = int(np.floor(t1 * self.imu_hz + 1e-9))
        for i in range(n0, n1 + 1):
            t = i / self.imu_hz
            p, v, a, q, gyro_z = self._gt(t)
            R = np_lie.quat_to_rotmat(q)
            acc_b = R.T @ (a + GRAVITY) + self.acc_bias
            if self.wobble > 0.0:
                # body rates by central difference of the wobbled q(t)
                h = 1e-5
                qm = self._gt(t - h)[3]
                qp = self._gt(t + h)[3]
                dq = np_lie.quat_mul(np_lie.quat_conj(qm), qp)
                gyr_b = dq[:3] * (2.0 / (2 * h) * np.sign(dq[3]))
                gyr_b = gyr_b + self.gyr_bias
            else:
                gyr_b = np.array([0.0, 0.0, gyro_z]) + self.gyr_bias
            if self.acc_noise > 0:
                acc_b = acc_b + self.rng.normal(0, self.acc_noise, 3)
            if self.gyr_noise > 0:
                gyr_b = gyr_b + self.rng.normal(0, self.gyr_noise, 3)
            out.append((t, acc_b, gyr_b))
        return out

    def _rays_at(self, t: float, cam: int, vis=None):
        """Unit rays of (a subset of) landmarks from camera ``cam`` at
        time ``t``; with ``vis`` None, also computes the visibility
        subset."""
        pose, _ = self.gt_pose(t)
        T = np_lie.pose_compose(pose, self.ext[cam])
        R = np_lie.quat_to_rotmat(T[3:])
        pc = (self.lms - T[:3]) @ R  # [N,3] in camera frame
        d = np.linalg.norm(pc, axis=1)
        if vis is None:
            infront = pc[:, 2] > 1.0
            # field of view gate (cos half-angle; default ~45 deg)
            fov = pc[:, 2] / np.maximum(d, 1e-9) > self.fov_cos
            vis = np.where(infront & fov)[0]
            if len(vis) > self.max_obs:
                # deterministic subset by id so tracks persist
                vis = vis[np.argsort(vis)][: self.max_obs]
        return pc[vis] / d[vis][:, None], vis

    def frame(self, frame_id: int) -> FrontendFrame:
        t = frame_id / self.frame_hz
        t_cap = t + self.cam_td  # capture instant on the camera clock
        obs = []
        for cam in range(len(self.ext)):
            rays, vis = self._rays_at(t_cap, cam)
            if self.cam_td != 0.0:
                # FD ray velocities (the lever arm of the reference's
                # online-td projection correction)
                dt = 1e-3
                rays2, _ = self._rays_at(t_cap + dt, cam, vis)
                vels = (rays2 - rays) / dt
            else:
                vels = np.zeros_like(rays)
            if self.pix_noise > 0:
                n = self.rng.normal(0, self.pix_noise, rays.shape)
                rays = rays + n - rays * np.sum(rays * n, axis=1, keepdims=True)
                rays /= np.linalg.norm(rays, axis=1, keepdims=True)
            obs.append(
                CameraObservations(
                    cam_id=cam,
                    landmark_ids=vis.astype(np.int64),
                    rays=rays,
                    ray_vels=vels,
                )
            )
        return FrontendFrame(
            stamp=t, frame_id=frame_id, is_keyframe=True, observations=obs
        )
