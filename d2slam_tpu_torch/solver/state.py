"""Fixed-shape containers for the sliding-window VIO problem.

Counterpart of ``d2slam_tpu/solver/state.py``: NamedTuples of tensors
with static shapes and validity masks (reference d2common d2state.hpp,
d2vins d2vinsstate.hpp). Host code keeps the id<->slot tables; device
code sees only slots and masks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from d2slam_tpu_torch.imu.preintegration import PreintegrationResult
from d2slam_tpu_torch.solver.layout import VIOLayout


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over NamedTuples of tensors (nested
    NamedTuples recurse, ``None`` leaves stay ``None``)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple):
        return type(t0)(*[tree_map(fn, *leaves) for leaves in zip(*trees)])
    return fn(*trees)


def tree_where(cond, a, b):
    """Leafwise ``torch.where(cond, a, b)`` with a scalar bool tensor."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


class VIOState(NamedTuple):
    """Optimizable state of one robot's sliding window."""

    poses: torch.Tensor      # [W, 7] world_T_imu per keyframe slot
    sb: torch.Tensor         # [W, 9] [v(3), ba(3), bg(3)]
    ext: torch.Tensor        # [C, 7] imu_T_cam extrinsics
    td: torch.Tensor         # [] time offset (image vs IMU clock)
    inv_dep: torch.Tensor    # [L] inverse depth per landmark slot
    frame_valid: torch.Tensor  # [W] bool
    lm_valid: torch.Tensor     # [L] bool

    @staticmethod
    def zeros(layout: VIOLayout, dtype=torch.float32, device=None) -> "VIOState":
        unit = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
        return VIOState(
            poses=unit.repeat(layout.W, 1),
            sb=torch.zeros((layout.W, 9), dtype=dtype, device=device),
            ext=unit.repeat(layout.C, 1),
            td=torch.zeros((), dtype=dtype, device=device),
            inv_dep=torch.full((layout.L,), 0.2, dtype=dtype, device=device),
            frame_valid=torch.zeros((layout.W,), dtype=torch.bool, device=device),
            lm_valid=torch.zeros((layout.L,), dtype=torch.bool, device=device),
        )


class ImuMeas(NamedTuple):
    """Preintegrated IMU factors between window slots (padded to W-1)."""

    frame_i: torch.Tensor    # [K] int64 window slot of earlier frame
    frame_j: torch.Tensor    # [K] int64 window slot of later frame
    valid: torch.Tensor      # [K] bool
    pre: PreintegrationResult  # batched [K, ...]
    sqrt_info: torch.Tensor  # [K, 15, 15]


class ProjMeas(NamedTuple):
    """Visual landmark observations, padded to layout.M.

    One record covers the reference's four projection factor kinds:
    same-camera factors set cam_i == cam_j, same-frame (stereo) factors
    set frame_i == frame_j, depth measurements set has_dep.
    """

    frame_i: torch.Tensor  # [M] int64 anchor frame slot
    frame_j: torch.Tensor  # [M] int64 observing frame slot
    cam_i: torch.Tensor    # [M] int64 anchor camera
    cam_j: torch.Tensor    # [M] int64 observing camera
    lm: torch.Tensor       # [M] int64 landmark slot
    ray_i: torch.Tensor    # [M, 3] unit ray in anchor camera
    ray_j: torch.Tensor    # [M, 3] unit ray in observing camera
    vel_i: torch.Tensor    # [M, 3] ray velocity (for td correction)
    vel_j: torch.Tensor    # [M, 3]
    td_i: torch.Tensor     # [M] per-measurement capture time offset
    td_j: torch.Tensor     # [M]
    dep_j: torch.Tensor    # [M] measured depth in frame j (0 if none)
    has_dep: torch.Tensor  # [M] bool
    valid: torch.Tensor    # [M] bool


class PriorBlock(NamedTuple):
    """Dense marginalization prior: residual = r + J @ (x [-] x_lin).

    J columns live in the solver layout (D_pad); ``lin`` is a full
    VIOState snapshot; ``row_valid`` masks live rows (reference
    PriorFactor, d2vins/src/factors/prior_factor.cpp).
    """

    J: torch.Tensor        # [P, D_pad]
    r: torch.Tensor        # [P]
    lin: VIOState          # linearization point
    row_valid: torch.Tensor  # [P] bool
