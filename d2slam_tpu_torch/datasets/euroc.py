"""EuRoC-ASL format dataset reader (EuRoC MAV, TUM-VI, and compatible).

Counterpart of ``d2slam_tpu/datasets/euroc.py``: rosbag-free ingestion
of the directory layout of the reference's evaluation datasets:

    <root>/mav0/imu0/data.csv              t[ns], wx, wy, wz, ax, ay, az
    <root>/mav0/cam0/data.csv              t[ns], filename
    <root>/mav0/cam0/data/<filename>       grayscale images
    <root>/mav0/cam0/sensor.yaml           intrinsics + T_BS (optional)
    <root>/mav0/state_groundtruth_estimate0/data.csv   (optional)

``play()`` merges IMU and frames into one time-ordered event stream,
what the estimator node's callbacks consume. PNGs decode through the
port's native decoder (``runtime.pipeline.decode_png``), not Pillow;
``play(prefetch=True)`` decodes them ahead on native threads.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from d2slam_tpu_torch.runtime.pipeline import ImagePrefetcher, decode_png


def gray_u8(img: np.ndarray) -> np.ndarray:
    """A decoded 8-bit image as grayscale ``uint8``: gray passes, RGB(A)
    converts with the ITU-R 601-2 luma weights in the fixed point Pillow's
    ``convert("L")`` uses. 16-bit images raise."""
    if img.dtype != np.uint8:
        raise ValueError(f"expected an 8-bit image, got {img.dtype}")
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:       # gray + alpha
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


class EuRoCDataset:
    def __init__(self, root: str, cams: Tuple[str, ...] = ("cam0", "cam1")):
        self.root = root
        mav = os.path.join(root, "mav0")
        self.cams = [c for c in cams if os.path.exists(os.path.join(mav, c, "data.csv"))]
        self.imu = self._read_imu(os.path.join(mav, "imu0", "data.csv"))
        self.frames: List[Tuple[float, List[str]]] = self._read_frames(mav)
        self.ground_truth = self._read_gt(
            os.path.join(mav, "state_groundtruth_estimate0", "data.csv"))
        self.calib = {c: self._read_sensor_yaml(os.path.join(mav, c, "sensor.yaml"))
                      for c in self.cams}

    @staticmethod
    def _read_imu(path):
        if not os.path.exists(path):
            return np.zeros((0, 7))
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                rows.append([float(x) for x in row[:7]])
        arr = np.asarray(rows)
        if len(arr):
            arr[:, 0] *= 1e-9  # ns -> s
        return arr  # [N, 7]: t, wx, wy, wz, ax, ay, az

    def _read_frames(self, mav):
        per_cam: Dict[str, Dict[int, str]] = {}
        for c in self.cams:
            per_cam[c] = {}
            with open(os.path.join(mav, c, "data.csv")) as f:
                for row in csv.reader(f):
                    if not row or row[0].startswith("#"):
                        continue
                    per_cam[c][int(row[0])] = os.path.join(mav, c, "data", row[1].strip())
        if not self.cams:
            return []
        # frames synchronized on cam0 timestamps; other cams matched
        # within 1 ms (approx-time sync like the reference's
        # message_filters, d2frontend.cpp:354-389)
        out = []
        for t_ns, path0 in sorted(per_cam[self.cams[0]].items()):
            paths = [path0]
            for c in self.cams[1:]:
                cand = min(per_cam[c].keys(), key=lambda k: abs(k - t_ns), default=None)
                if cand is None or abs(cand - t_ns) > 1_000_000:
                    break
                paths.append(per_cam[c][cand])
            else:
                out.append((t_ns * 1e-9, paths))
        return out

    @staticmethod
    def _read_gt(path):
        if not os.path.exists(path):
            return None
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                rows.append([float(x) for x in row[:8]])
        arr = np.asarray(rows)
        if not len(arr):
            return None
        arr[:, 0] *= 1e-9
        # EuRoC order: t, px, py, pz, qw, qx, qy, qz -> our xyzw
        out = np.zeros((len(arr), 8))
        out[:, 0] = arr[:, 0]
        out[:, 1:4] = arr[:, 1:4]
        out[:, 4:7] = arr[:, 5:8]
        out[:, 7] = arr[:, 4]
        return out  # [N, 8]: t, p(3), q_xyzw(4)

    @staticmethod
    def _read_sensor_yaml(path) -> Optional[dict]:
        """The camera's ``sensor.yaml``, or None when it is missing, when
        PyYAML is not installed or when the file does not parse (as the
        JAX reader)."""
        if not os.path.exists(path):
            return None
        try:
            import yaml
        except ImportError:
            return None
        try:
            with open(path) as f:
                return yaml.safe_load(f)
        except yaml.YAMLError:
            return None

    # ------------------------------------------------------------------

    def load_image_u8(self, path: str) -> np.ndarray:
        """One image file as grayscale [H, W] ``uint8``."""
        with open(path, "rb") as f:
            return gray_u8(decode_png(f.read()))

    def load_image(self, path: str) -> np.ndarray:
        """One image file as grayscale [H, W] float32 in [0, 1]."""
        return self.load_image_u8(path).astype(np.float32) / 255.0

    def play(self, frame_stride: int = 1, prefetch: bool = False,
             prefetch_threads: int = 2, as_uint8: bool = False) -> Iterator[tuple]:
        """Yield ('imu', t, acc, gyr) and ('frame', t, [images]) events
        in time order (acc/gyro in EuRoC convention: gyro then acc in
        the csv; acc comes first here). Images are float32 in [0, 1], or
        the decoded ``uint8`` with ``as_uint8``.

        prefetch=True decodes the PNGs ahead on the native loader's
        threads (``ImagePrefetcher``): the reference's threaded image
        ingestion. A file the loader does not decode goes through
        :meth:`load_image_u8`, so both paths give the same pixels."""
        imu_idx = 0
        n_imu = len(self.imu)
        kept = [(t, paths) for k, (t, paths) in enumerate(self.frames)
                if k % frame_stride == 0]
        if prefetch:
            flat = [p for _, paths in kept for p in paths]
            fetch = iter(ImagePrefetcher(flat, n_threads=prefetch_threads))

            def images_for(paths):
                out = []
                for p in paths:
                    a = next(fetch)
                    out.append(self.load_image_u8(p) if a is None or a.dtype != np.uint8
                               else gray_u8(a))
                return out
        else:
            def images_for(paths):
                return [self.load_image_u8(p) for p in paths]

        for (t, paths) in kept:
            while imu_idx < n_imu and self.imu[imu_idx, 0] <= t:
                row = self.imu[imu_idx]
                yield ("imu", row[0], row[4:7], row[1:4])
                imu_idx += 1
            imgs = images_for(paths)
            if not as_uint8:
                imgs = [im.astype(np.float32) / 255.0 for im in imgs]
            yield ("frame", t, imgs)
        while imu_idx < n_imu:
            row = self.imu[imu_idx]
            yield ("imu", row[0], row[4:7], row[1:4])
            imu_idx += 1

    def gt_pose_at(self, t: float) -> Optional[np.ndarray]:
        if self.ground_truth is None:
            return None
        i = int(np.searchsorted(self.ground_truth[:, 0], t))
        i = min(max(i, 0), len(self.ground_truth) - 1)
        return self.ground_truth[i, 1:8]
