"""Manifold-aware factor linearization via forward-mode AD.

Counterpart of ``d2slam_tpu/factors/linearize.py``. Jacobians are those
of the residual **through the retraction at delta = 0** (the reference's
tangent-space Jacobians composed with its PoseLocalParameterization),
computed exactly with ``torch.func.jacfwd``.

Forward mode, as the JAX package uses for pose-graph edges: the
quaternion log of an edge's error is taken at (or near) the identity,
where reverse mode through the JAX package's log gives NaN
(docs/DESIGN.md §9). The port's log takes its square roots of safe
operands, so reverse mode stays finite there too; forward mode is kept
because an edge has few tangent directions (6 or 4 per pose).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch.func import jacfwd

from d2slam_tpu_torch.geometry.lie import pose4d_boxplus, pose_boxplus


def _euclidean_retract(x, d):
    return x + d


def _scalar_retract(x, d):
    # scalar params carried as shape-() or shape-(1,) tensors; tangent dim 1
    return x + d.reshape(x.shape) if x.dim() else x + d[0]


RETRACT = {
    "pose": (pose_boxplus, 6),       # [7] pose, 6-dof tangent
    "pose4d": (pose4d_boxplus, 4),   # [7] pose, (x, y, z, yaw) tangent
    "vec": (_euclidean_retract, None),  # euclidean block, dim = len(x)
    "scalar": (_scalar_retract, 1),
}


def linearize_factor(
    res_fn: Callable,
    kinds: Sequence[str],
    params: Tuple[torch.Tensor, ...],
    *args,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Residual and tangent-space Jacobians of one factor.

    ``res_fn(*params, *args) -> [R]``; ``kinds`` names the retraction of
    each parameter block ("pose", "pose4d", "vec", "scalar"). Returns
    (residual [R], one [R, tangent_dim] Jacobian per parameter block).
    Works under ``torch.func.vmap``.
    """
    dtype = params[0].dtype
    for p in params[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    retracts, zeros = [], []
    for kind, p in zip(kinds, params):
        fn, dim = RETRACT[kind]
        retracts.append(fn)
        zeros.append(torch.zeros(p.shape[-1] if dim is None else dim,
                                 dtype=dtype, device=p.device))

    def res_of_deltas(*deltas):
        return res_fn(*(r(p, d) for r, p, d in zip(retracts, params, deltas)), *args)

    residual = res_fn(*params, *args)
    jacs = jacfwd(res_of_deltas, argnums=tuple(range(len(params))))(*zeros)
    return residual, jacs
