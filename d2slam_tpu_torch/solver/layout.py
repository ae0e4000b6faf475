"""Tangent-space column layout of the sliding-window VIO problem.

The reduced ("camera") system stacks, per window slot, a 6-dof pose
perturbation and a 9-dof speed/bias block, then camera extrinsics and
the time offset:

    [ frame0: pose(6) sb(9) | frame1: ... | ext0(6) ... | td(1) | pad ]

Inverse-depth landmarks are NOT in this layout — they are kept as
separate scalar columns and Schur-eliminated (the reference does the
same elimination inside Ceres via its Schur ordering; here it is an
explicit batched dense step, reference: d2common utils.hpp:132-158
schurComplement and marginalization.cpp:173-254).
"""
from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class VIOLayout:
    """Static shape/offset bookkeeping for one robot's window."""

    W: int = 11          # max sliding-window keyframes (max_sld_win_size)
    C: int = 2           # number of cameras
    L: int = 256         # max landmarks in a solve (tau_l, padded)
    M: int = 1024        # max projection measurements (tau_m, padded)
    N_IMU_SAMPLES: int = 64  # max IMU samples per interval (400Hz / 8Hz + pad)
    pad_to: int = 128    # column padding granularity (kept from the JAX layout)

    def ext_col(self, c):
        return 15 * self.W + 6 * c

    @property
    def td_col(self) -> int:
        return 15 * self.W + 6 * self.C

    @property
    def D(self) -> int:
        """True tangent dimension."""
        return 15 * self.W + 6 * self.C + 1

    @property
    def D_pad(self) -> int:
        """Padded tangent dimension (multiple of pad_to)."""
        return _round_up(self.D, self.pad_to)
