"""Oracle feature extractor for pipeline tests.

Counterpart of ``d2slam_tpu/utils/oracle.py``. Stands in for a trained
SuperPoint: returns the true landmark projections (plus optional pixel
noise) with unique, repeatable descriptors per landmark, as the port's
``SuperPointOutput`` of host tensors. It fits the tracker's
``extract_fn=`` contract (``f(img, cam_id)``); the rest of the pipeline
— matching, LK, stereo association, the tracker's state machine, the
estimator — runs unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from d2slam_tpu_torch.frontend.superpoint import SuperPointOutput
from d2slam_tpu_torch.utils import np_lie


class OracleExtractor:
    def __init__(self, pts_w, extrinsics, fx, fy, cx, cy, img_hw,
                 max_keypoints=128, desc_dim=64, pix_noise=0.0, seed=0):
        self.pts_w = np.asarray(pts_w)
        self.ext = np.asarray(extrinsics)
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.H, self.W = img_hw
        self.K = max_keypoints
        self.noise = pix_noise
        rng = np.random.default_rng(seed)
        d = rng.normal(0, 1, (len(self.pts_w), desc_dim))
        self.descs = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        self.rng = np.random.default_rng(seed + 1)
        self.body_pose = None  # set before each frame

    def set_pose(self, pose7):
        self.body_pose = np.asarray(pose7, np.float64)

    def __call__(self, img, cam_id) -> SuperPointOutput:
        if self.body_pose is None:
            raise RuntimeError("call set_pose() before extracting")
        T = np_lie.pose_compose(self.body_pose, self.ext[cam_id])
        R = np_lie.quat_to_rotmat(T[3:])
        pc = (self.pts_w - T[:3]) @ R
        u = self.fx * pc[:, 0] / np.maximum(pc[:, 2], 1e-6) + self.cx
        v = self.fy * pc[:, 1] / np.maximum(pc[:, 2], 1e-6) + self.cy
        vis = ((pc[:, 2] > 1.0)
               & (u > 4) & (u < self.W - 4) & (v > 4) & (v < self.H - 4))
        idx = np.flatnonzero(vis)[: self.K]
        K, n = self.K, len(idx)
        kpts = np.zeros((K, 2), np.float32)
        desc = np.zeros((K, self.descs.shape[1]), np.float32)
        scores = np.zeros(K, np.float32)
        valid = np.zeros(K, bool)
        kpts[:n, 0] = u[idx]
        kpts[:n, 1] = v[idx]
        if self.noise > 0:
            kpts[:n] += self.rng.normal(0, self.noise, (n, 2))
        desc[:n] = self.descs[idx]
        scores[:n] = 1.0
        valid[:n] = True
        return SuperPointOutput(kpts=torch.from_numpy(kpts), scores=torch.from_numpy(scores),
                                desc=torch.from_numpy(desc), valid=torch.from_numpy(valid))
