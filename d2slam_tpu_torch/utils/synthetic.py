"""Ground-truth kinematics and synthetic inputs shared by the simulators
and the smoke run (numpy)."""
from __future__ import annotations

import numpy as np

from d2slam_tpu_torch.pgo.pose_graph import PGOEdges
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
