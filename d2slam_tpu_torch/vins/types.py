"""Host-side data types at the frontend/backend boundary.

Equivalents of the reference's VisualImageDescArray / VINSFrame
(reference: d2common/include/d2common/d2frontend_types.h:85-527,
d2common/include/d2common/d2vinsframe.h:12-36) stripped to the fields
the estimator consumes; descriptors live in the frontend's own types.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# Remote frame/landmark ids are folded with the drone id into one
# collision-free 64-bit key (the reference keeps per-drone maps keyed
# by FrameIdType instead; its frame ids are already globally unique
# because they embed a random per-run base — d2frontend generates them
# from a random generator seeded per drone).
GID_SHIFT = 1 << 40


def global_frame_id(drone_id: int, frame_id: int) -> int:
    """Collision-free swarm-wide frame key."""
    return int(drone_id) * GID_SHIFT + (int(frame_id) & (GID_SHIFT - 1))


def split_global_id(gid: int) -> "tuple[int, int]":
    """Inverse of :func:`global_frame_id`: ``(drone_id, frame_id)``."""
    return int(gid) // GID_SHIFT, int(gid) % GID_SHIFT


@dataclasses.dataclass
class CameraObservations:
    """Per-camera landmark observations of one frame."""

    cam_id: int
    landmark_ids: np.ndarray       # [N] int64
    rays: np.ndarray               # [N, 3] unit rays in camera frame
    ray_vels: np.ndarray           # [N, 3] ray velocity (for td correction)
    depths: Optional[np.ndarray] = None  # [N] measured depth or <=0


@dataclasses.dataclass
class FrontendFrame:
    """One keyframe from the (real or synthetic) frontend."""

    stamp: float
    frame_id: int
    drone_id: int = 0
    is_keyframe: bool = True
    observations: List[CameraObservations] = dataclasses.field(default_factory=list)
    # optional pose hints (remote frames carry their ego estimates,
    # reference VisualImageDescArray pose_drone)
    ego_pose: Optional[np.ndarray] = None  # [7]


@dataclasses.dataclass
class Odometry:
    stamp: float
    pose: np.ndarray  # [7]
    vel: np.ndarray   # [3]

    def __repr__(self):
        p = self.pose
        return (
            f"Odometry(t={self.stamp:.3f}, p=[{p[0]:.3f},{p[1]:.3f},{p[2]:.3f}],"
            f" q=[{p[3]:.3f},{p[4]:.3f},{p[5]:.3f},{p[6]:.3f}])"
        )
