"""A seeded flight for the VIO cells: a drone on a circle, starting
from rest, among a ring of landmarks, with the exact IMU it would read.

The trajectory is the port's ``utils/sim.py`` circle (``circle_gt_ramp``:
angular position ``omega * (t - tau * (1 - exp(-t / tau)))``, yaw along
the tangent, gravity 9.805 m/s^2 along -z), with its radius and angular
rate as parameters, so that a flight can be given one that does not
come back to a place it saw within the frames a run holds. The seed
draws the landmarks (angle, distance 8-14 m, height 0-4 m), their
intensities; the trajectory itself is the same for
every seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from portbench.yardstick.geometry import quat_to_rotmat

GRAVITY = np.array([0.0, 0.0, 9.805])


@dataclasses.dataclass(frozen=True)
class Circle:
    radius: float = 5.0      # m
    omega: float = 0.5       # rad/s once up to speed
    height: float = 2.0      # m
    tau: float = 1.0         # s, the ramp from rest

    def state(self, t: float):
        """(position, velocity, acceleration, quaternion xyzw, yaw rate)."""
        if t <= 0:
            th, dth, ddth = 0.0, 0.0, 0.0
        else:
            e = np.exp(-t / self.tau)
            th = self.omega * (t - self.tau * (1.0 - e))
            dth = self.omega * (1.0 - e)
            ddth = self.omega / self.tau * e
        c, s = np.cos(th), np.sin(th)
        r = self.radius
        p = np.array([r * c, r * s, self.height])
        v = r * dth * np.array([-s, c, 0.0])
        a = r * ddth * np.array([-s, c, 0.0]) - r * dth * dth * np.array([c, s, 0.0])
        yaw = th + np.pi / 2
        q = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
        return p, v, a, q, dth

    def pose(self, t: float) -> np.ndarray:
        p, _, _, q, _ = self.state(t)
        return np.concatenate([p, q])

    def angle(self, t: float) -> float:
        """How far round the circle the drone is at ``t`` (rad)."""
        if t <= 0:
            return 0.0
        return self.omega * (t - self.tau * (1.0 - np.exp(-t / self.tau)))

    def imu(self, t0: float, t1: float, hz: float):
        """[(t, acc_body, gyr_body)] at every multiple of 1 / hz in
        [t0, t1]: specific force and body rates, noise-free."""
        out = []
        for i in range(int(np.ceil(t0 * hz - 1e-9)), int(np.floor(t1 * hz + 1e-9)) + 1):
            t = i / hz
            _, _, a, q, dth = self.state(t)
            R = quat_to_rotmat(q)
            out.append((t, R.T @ (a + GRAVITY), np.array([0.0, 0.0, dth])))
        return out


@dataclasses.dataclass
class Scene:
    landmarks: np.ndarray     # [N, 3] world points
    intensity: np.ndarray     # [N] in [0.5, 1]


def make_scene(seed: int, n_landmarks: int) -> Scene:
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(8.0, 14.0, n_landmarks)
    z = rng.uniform(0.0, 4.0, n_landmarks)
    lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], axis=1)
    return Scene(lms, rng.uniform(0.5, 1.0, n_landmarks))
