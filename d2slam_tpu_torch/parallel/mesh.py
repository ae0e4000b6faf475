"""The swarm's robot axis on one device.

Counterpart of ``d2slam_tpu/parallel/mesh.py``. The JAX package lays one
robot on each slice of a ``robot`` mesh axis and exchanges consensus
state by collectives (``psum``, ``all_gather``, ``pmax``). On one GPU the
robots are a batch dimension instead: every tensor of a multi-robot
program carries the robots on dim 0 (``[R, ...]``), and the collectives
become reductions over that dimension. They stay on the device: no
reduction reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from d2slam_tpu_torch.utils.device import resolve_device


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the robots: [R, ...] -> [...]."""
    return x.sum(dim=0)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every robot's copy, robots first: [R, ...] is already the gather."""
    return x


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Max over the robots: [R, ...] -> [...]."""
    return x.amax(dim=0)


class RobotMesh(NamedTuple):
    """R robots batched on one device, with the robot-axis reductions."""

    n_robots: int
    device: torch.device

    psum = staticmethod(psum)
    all_gather = staticmethod(all_gather)
    pmax = staticmethod(pmax)


def robot_mesh(n_robots: int, device=None) -> RobotMesh:
    """R robots on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``)."""
    if n_robots < 1:
        raise ValueError(f"need at least one robot, got {n_robots}")
    return RobotMesh(int(n_robots), resolve_device(device))

