"""Host-side IMU sample buffer.

Equivalent of the reference IMUBuffer
(reference: d2common/include/d2common/d2imu.h:15-113): a growable host
ring of timestamped samples with time-range slicing that emits
**fixed-shape padded arrays + mask** ready for
:func:`d2slam_tpu_torch.imu.preintegration.preintegrate`.

Everything here is plain numpy on the host — device code only ever sees
the padded arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class IMUBuffer:
    def __init__(self, capacity: int = 100000):
        self._t = np.zeros(capacity, np.float64)
        self._acc = np.zeros((capacity, 3), np.float64)
        self._gyr = np.zeros((capacity, 3), np.float64)
        self._n = 0
        self._capacity = capacity

    def __len__(self) -> int:
        return self._n

    def add(self, t: float, acc, gyr) -> None:
        if self._n == self._capacity:
            # drop oldest half to bound memory (frames only ever look back
            # a sliding-window's worth of time)
            half = self._capacity // 2
            self._t[:half] = self._t[half : 2 * half]
            self._acc[:half] = self._acc[half : 2 * half]
            self._gyr[:half] = self._gyr[half : 2 * half]
            self._n = half
        i = self._n
        self._t[i] = t
        self._acc[i] = acc
        self._gyr[i] = gyr
        self._n += 1

    @property
    def t_last(self) -> float:
        return float(self._t[self._n - 1]) if self._n else -np.inf

    def available(self, t: float) -> bool:
        """True once samples at/after time t have arrived."""
        return self._n > 0 and self.t_last >= t

    def search_closest(self, t: float) -> int:
        """Index of the sample closest in time to t (reference searchClosest)."""
        idx = int(np.searchsorted(self._t[: self._n], t))
        if idx == 0:
            return 0
        if idx >= self._n:
            return self._n - 1
        before, after = self._t[idx - 1], self._t[idx]
        return idx - 1 if (t - before) <= (after - t) else idx

    def mean_acc(self) -> np.ndarray:
        return self._acc[: self._n].mean(axis=0)

    def mean_gyro(self) -> np.ndarray:
        return self._gyr[: self._n].mean(axis=0)

    def samples_between(
        self, t0: float, t1: float
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Raw samples with t0 < t <= t1 as (ts, accs, gyrs) — the
        payload of the keyframe wire packet's IMU block (reference
        VisualImageDescArray imu_buf, d2frontend_types.h:85-527)."""
        ts = self._t[: self._n]
        i0 = int(np.searchsorted(ts, t0, side="right"))
        i1 = int(np.searchsorted(ts, t1, side="right"))
        return (ts[i0:i1].copy(), self._acc[i0:i1].copy(),
                self._gyr[i0:i1].copy())

    def period(
        self, t0: float, t1: float, pad_to: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Samples in (t0, t1], padded to ``pad_to``, for preintegration.

        Returns ``(dts, accs, gyrs, mask)`` each with leading dim
        ``pad_to``. Slot 0 is the *seed* sample (the last sample at or
        before t0, dt=0, mask False); slots 1..k carry the integration
        samples with their dt to the previous slot; the final valid slot
        is clamped so the total integrated time is exactly ``t1 - t0``.

        Matches the reference semantics where the interval's IMUBuffer
        slice seeds acc_0/gyr_0 from the first sample
        (reference: integration_base.h:50-59, d2imu.cpp periodIMU).
        """
        ts = self._t[: self._n]
        i0 = int(np.searchsorted(ts, t0, side="right"))
        i1 = int(np.searchsorted(ts, t1, side="right"))
        seed = max(i0 - 1, 0)
        idxs = np.arange(seed, min(i1, self._n))
        k = len(idxs)
        if k > pad_to:
            # too many samples for the static shape: stride-subsample,
            # always keeping first and last
            keep = np.unique(
                np.round(np.linspace(0, k - 1, pad_to)).astype(int)
            )
            idxs = idxs[keep]
            k = len(idxs)

        dts = np.zeros(pad_to, np.float64)
        accs = np.zeros((pad_to, 3), np.float64)
        gyrs = np.zeros((pad_to, 3), np.float64)
        mask = np.zeros(pad_to, bool)
        if k == 0:
            return dts, accs, gyrs, mask
        accs[:k] = self._acc[idxs]
        gyrs[:k] = self._gyr[idxs]
        # pad the tail with the last sample so scan reads are harmless
        accs[k:] = accs[k - 1]
        gyrs[k:] = gyrs[k - 1]
        tt = ts[idxs]
        # clamp integration to [t0, t1]
        tt = np.clip(tt, t0, t1)
        dts[1:k] = np.diff(tt)
        if k >= 2:
            mask[1:k] = True
        # integrate the tail gap between the last sample and t1 by
        # extending with a zero-order-hold virtual sample at t1
        tail = t1 - tt[-1] if k >= 1 else 0.0
        if tail > 1e-9:
            if k < pad_to:
                dts[k] = tail
                mask[k] = True
            else:
                dts[k - 1] += tail
        return dts, accs, gyrs, mask
