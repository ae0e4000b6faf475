"""Host-side landmark database for the VIO backend.

Equivalent of the reference's D2LandmarkManager
(reference: d2vins/src/estimator/landmark_manager.cpp): keeps per-id
observation tracks, assigns fixed landmark slots for the solver,
triangulates new landmarks, and rejects outliers after each solve.
Device code only ever sees the padded ProjMeas arrays this class emits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# landmark flags (reference d2landmarks.h LandmarkFlag)
UNINITIALIZED, INITIALIZED, ESTIMATED, OUTLIER = 0, 1, 2, 3


@dataclasses.dataclass
class Observation:
    frame_id: int
    cam_id: int
    ray: np.ndarray      # [3] unit ray
    ray_vel: np.ndarray  # [3]
    depth: float = -1.0  # measured depth (<=0: none)


@dataclasses.dataclass
class Landmark:
    lm_id: int
    obs: List[Observation] = dataclasses.field(default_factory=list)
    flag: int = UNINITIALIZED
    inv_dep: float = 0.2       # in anchor camera
    position: Optional[np.ndarray] = None  # world, after estimation

    @property
    def anchor(self) -> Observation:
        return self.obs[0]

    def track_length(self) -> int:
        return len(self.obs)


class LandmarkManager:
    def __init__(self, min_depth=0.3, max_depth=150.0,
                 min_baseline=0.02, tri_max_err=0.03):
        self.db: Dict[int, Landmark] = {}
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.min_baseline = min_baseline
        self.tri_max_err = tri_max_err

    def add_observation(self, lm_id, frame_id, cam_id, ray, ray_vel, depth=-1.0):
        lm = self.db.get(lm_id)
        if lm is None:
            lm = Landmark(lm_id)
            self.db[lm_id] = lm
        lm.obs.append(Observation(frame_id, cam_id, np.asarray(ray, np.float64),
                                  np.asarray(ray_vel, np.float64), depth))

    def pop_frame(self, frame_id: int, cam_pose_of=None):
        """Remove all observations of a frame. Landmarks anchored at the
        removed frame are re-anchored to their next observation with the
        depth transferred from the estimated world position (VINS
        removeBackShiftDepth semantics; the reference's popFrame +
        re-anchor path in landmark_manager.cpp)."""
        dead = []
        for lm in self.db.values():
            anchored_here = bool(lm.obs) and lm.anchor.frame_id == frame_id
            lm.obs = [o for o in lm.obs if o.frame_id != frame_id]
            if not lm.obs:
                dead.append(lm.lm_id)
                continue
            if anchored_here:
                if (
                    lm.position is not None
                    and cam_pose_of is not None
                    and (T := cam_pose_of(lm.anchor.frame_id, lm.anchor.cam_id))
                    is not None
                ):
                    d = np.linalg.norm(lm.position - T[:3])
                    if self.min_depth < d < self.max_depth:
                        lm.inv_dep = 1.0 / d
                    else:
                        lm.flag = UNINITIALIZED
                else:
                    lm.flag = UNINITIALIZED
        for lid in dead:
            del self.db[lid]

    # ------------------------------------------------------------------
    # triangulation (reference landmark_manager.cpp:150-283, 485-510)
    # ------------------------------------------------------------------

    def triangulate(self, lm: Landmark, cam_pose_of) -> bool:
        """Multi-view DLT triangulation with baseline & reprojection
        gates. cam_pose_of(frame_id, cam_id) -> [7] world_T_cam or None."""
        rows = []
        cams = []
        for o in lm.obs:
            T = cam_pose_of(o.frame_id, o.cam_id)
            if T is None:
                continue
            R = _rotmat(T[3:])
            t = T[:3]
            # world-to-cam projection matrix P = [R^T | -R^T t]
            P = np.hstack([R.T, (-R.T @ t)[:, None]])
            rows.append(o.ray[0] * P[2] - o.ray[2] * P[0])
            rows.append(o.ray[1] * P[2] - o.ray[2] * P[1])
            cams.append((P, o.ray))
        if len(cams) < 2:
            return False
        # baseline gate
        centers = []
        for o in lm.obs:
            T = cam_pose_of(o.frame_id, o.cam_id)
            if T is not None:
                centers.append(T[:3])
        centers = np.asarray(centers)
        if np.linalg.norm(centers.max(0) - centers.min(0)) < self.min_baseline:
            return False
        A = np.asarray(rows)
        _, _, Vt = np.linalg.svd(A)
        Xh = Vt[-1]
        if abs(Xh[3]) < 1e-12:
            return False
        X = Xh[:3] / Xh[3]
        # reprojection gate on unit sphere
        errs = []
        depths = []
        for P, ray in cams:
            pc = P @ np.append(X, 1.0)
            d = np.linalg.norm(pc)
            if pc[2] < 0.01:
                return False
            depths.append(d)
            errs.append(np.linalg.norm(pc / d - ray))
        if max(errs) > self.tri_max_err:
            return False
        anchor_T = cam_pose_of(lm.anchor.frame_id, lm.anchor.cam_id)
        d_anchor = np.linalg.norm(X - anchor_T[:3])
        if not (self.min_depth < d_anchor < self.max_depth):
            return False
        lm.inv_dep = 1.0 / d_anchor
        lm.position = X
        lm.flag = INITIALIZED
        return True

    def initial_landmarks(self, cam_pose_of, min_tracks: int):
        """Triangulate all landmarks with enough tracks (reference
        initialLandmarks)."""
        for lm in self.db.values():
            if lm.flag == OUTLIER:
                continue
            has_depth = lm.anchor.depth > 0
            if lm.flag == UNINITIALIZED:
                if has_depth:
                    lm.inv_dep = 1.0 / np.clip(
                        lm.anchor.depth, self.min_depth, self.max_depth
                    )
                    lm.flag = INITIALIZED
                elif lm.track_length() >= min_tracks:
                    self.triangulate(lm, cam_pose_of)

    # ------------------------------------------------------------------
    # outlier rejection (reference landmark_manager.cpp:324-429)
    # ------------------------------------------------------------------

    def outlier_rejection(self, cam_pose_of, focal: float, thres_px: float):
        """Mark landmarks whose mean reprojection error exceeds the gate.

        Vectorized over every (landmark, observation) pair: one numpy
        batch instead of a per-observation Python walk (the reference
        walks landmark-by-landmark, landmark_manager.cpp:324-429 — at
        ~200 landmarks x ~5 obs that loop dominated sync-back time)."""
        lms = [lm for lm in self.db.values()
               if lm.flag in (INITIALIZED, ESTIMATED)
               and lm.position is not None]
        if not lms:
            return 0
        li, fids, cids, rays, pos = [], [], [], [], []
        for k, lm in enumerate(lms):
            for o in lm.obs:
                li.append(k)
                fids.append(o.frame_id)
                cids.append(o.cam_id)
                rays.append(o.ray)
                pos.append(lm.position)
        li = np.asarray(li)
        rays = np.asarray(rays)
        pos = np.asarray(pos)
        if hasattr(cam_pose_of, "lookup"):
            T, ok = cam_pose_of.lookup(fids, np.asarray(cids))
        else:  # plain closure (tests): per-item fallback
            T = np.zeros((len(li), 7))
            ok = np.zeros(len(li), bool)
            for n, (f, c) in enumerate(zip(fids, cids)):
                t = cam_pose_of(f, c)
                if t is not None:
                    T[n], ok[n] = t, True
        from d2slam_tpu_torch.utils.np_lie import quat_to_rotmat_batch

        R = quat_to_rotmat_batch(T[:, 3:])
        pc = np.einsum("nji,nj->ni", R, pos - T[:, :3])  # R^T (p - t)
        d = np.linalg.norm(pc, axis=1)
        BIG = 1e9  # stands in for the old inf (keeps the mean finite)
        bad = (d < 1e-6) | (pc[:, 2] < 0)
        err = np.where(
            bad, BIG,
            np.linalg.norm(
                pc / np.maximum(d, 1e-12)[:, None] - rays, axis=1
            ) * focal,
        )
        n_lm = len(lms)
        cnt = np.bincount(li, weights=ok.astype(np.float64),
                          minlength=n_lm)
        tot = np.bincount(li, weights=np.where(ok, err, 0.0),
                          minlength=n_lm)
        mean_err = np.where(cnt > 0, tot / np.maximum(cnt, 1), 0.0)
        out = np.flatnonzero((cnt > 0) & (mean_err > thres_px))
        for k in out:
            lms[k].flag = OUTLIER
        return len(out)

    def estimated_landmarks(self, min_tracks: int) -> List[Landmark]:
        return [
            lm
            for lm in self.db.values()
            if lm.flag in (INITIALIZED, ESTIMATED)
            and lm.track_length() >= min_tracks
        ]


def _rotmat(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
