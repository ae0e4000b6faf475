"""Loop-closure detection: NetVLAD retrieval + geometric verification.

Counterpart of ``d2slam_tpu/frontend/loop_detector.py`` (reference
LoopDetector, d2frontend/src/loop_detector.cpp). The retrieval database
(the reference's FAISS IndexFlatIP, loop_detector.h:71-72) is a host
matrix: one query is one matvec, which costs less on the host than
an upload of the database. Descriptor matching of a retrieved pair runs
on ``device`` (``matching.match_descriptors``), per camera-direction pair
for multi-view entries (``LoopDetector._match_views``); non-central PnP
verification with the gravity/yaw/position acceptance gates (computeLoop
:622-720, pnp_utils.cpp:66-93) runs on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from d2slam_tpu_torch.frontend.matching import match_descriptors
from d2slam_tpu_torch.frontend.pnp import ransac_homography, ransac_pnp_body
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class LoopDetectorConfig:
    netvlad_thres: float = 0.8          # reference loop_detection_netvlad_thres
    min_match_per_dir: int = 15
    min_inliers: int = 25               # reference inter_drone MIN_LOOP_NUM-ish
    max_yaw_deg: float = 10.0           # reference odometry consistency gates
    max_pos_m: float = 1.0
    min_gap_frames: int = 8             # don't match very recent frames
    max_db: int = 2048
    pnp_thresh: float = 8.0 / 460.0
    desc_dim: int = 256
    gdesc_dim: int = 4096
    pos_cov: float = 0.01               # loop edge covariance (reference
    yaw_cov: float = 0.01               # loop_cov_pos / loop_cov_ang)
    # adaptive retrieval gate: netvlad_thres 0.8 is tuned for the
    # reference's trained MobileNetVLAD; any other global descriptor
    # (the weight-free downsample default, a re-trained net, PCA dims)
    # has a different impostor-similarity scale. When on, the gate
    # becomes mu + k*sigma of the running best-match score of non-loop
    # queries (after a warm-up that keeps the configured constant), so
    # the detector self-calibrates to whatever embedding is running
    # instead of silently using a mistuned constant
    auto_thres: bool = False
    auto_thres_sigma: float = 3.0
    auto_thres_min_samples: int = 20
    # prune descriptor matches with a RANSAC plane homography before
    # PnP (reference enable_homography_test,
    # loop_detector.cpp:610-617: findHomography RANSAC @ 10 px; skipped
    # when a learned matcher is in use, matching the reference's
    # `&& !enable_superglue` guard). Threshold in normalized-plane
    # units = pixels / focal.
    enable_homography_test: bool = False
    homography_thresh: float = 10.0 / 460.0
    # reject loops whose PnP attitude disagrees with the frame's ego
    # roll/pitch — gravity is observable in VIO, so a verified loop
    # cannot tilt it (reference gravityCheck + gravity_check_thres,
    # pnp_utils.cpp:66-93: sin of the angle between the two
    # body-frame gravity directions). Applies to inter-drone loops too.
    gravity_check_thres: float = 0.06
    # RANSAC hypothesis budget for loop PnP. With ~50% usable
    # correspondences a 6-point sample is all-inlier with p ~ 1.6%, so
    # 100 iterations expects <2 clean hypotheses — the consensus (and
    # the verified-inlier count the reference gates on,
    # loop_inlier_feature_num 50) grows directly with this budget.
    pnp_iters: int = 300
    # inlier-count-scaled loop covariance: the PnP pose variance
    # shrinks ~1/N_inliers, so a 15-inlier loop should pull the graph
    # ~3x more weakly than the reference's 50-inlier operating point
    # (loop_inlier_feature_num). cov_eff = cov * max(1, ref/inliers);
    # 0 disables (fixed covariance, the reference's behavior).
    cov_inlier_ref: int = 50


class LoopEdge(NamedTuple):
    frame_id_a: int
    frame_id_b: int
    drone_id_a: int
    drone_id_b: int
    rel_pose: np.ndarray   # [7] a_T_b
    pos_cov: float
    yaw_cov: float
    inliers: int


class KeyframeEntry(NamedTuple):
    frame_id: int
    drone_id: int
    stamp: float
    pose: np.ndarray          # [7] ego (VIO) pose at insertion
    kpt_rays: np.ndarray      # [K, 3] unit rays cam0 (body frame not applied)
    kpt_cam: np.ndarray       # [K] camera index
    kpt_desc: np.ndarray      # [K, D]
    kpt_valid: np.ndarray     # [K]
    lm_positions: np.ndarray  # [K, 3] world landmark positions (nan if none)
    lm_ids: np.ndarray = np.zeros(0, np.int64)  # [K] landmark ids (for
    #                           cross-drone unification; empty = unknown)


class LoopDetector:
    def __init__(self, cfg: LoopDetectorConfig, extrinsics: np.ndarray,
                 matcher_fn=None, lm_pos_fn=None, kf_pose_fn=None, device=None):
        """device: where the descriptor matching of a retrieved pair runs
        (default ``cuda``; raises without a card unless ``device="cpu"``).

        matcher_fn: optional learned matcher ``f(desc_a, rays_a,
        valid_a, desc_b, rays_b, valid_b) -> (idx, ok)`` replacing the
        nearest-neighbor descriptor matching (reference
        enable_superglue_remote; wire frontend.superglue here).

        lm_pos_fn: optional ``f(drone_id, lm_ids [K]) -> [K, 3]``
        returning the CURRENT landmark position estimates (nan where
        unknown). DB entries snapshot positions at insertion, but most
        landmarks triangulate/refine AFTER their keyframe was inserted
        — verifying old loops against stale nan positions starves the
        PnP of correspondences (measured: 51-69 raw matches per
        inter-robot loop collapse to 26-44 with 3D). The reference
        verifies against its live landmark DB
        (d2frontend/src/loop_detector.cpp:254-330 uses current
        estimates), which this hook reproduces."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ext = np.asarray(extrinsics)
        self.matcher_fn = matcher_fn
        self.lm_pos_fn = lm_pos_fn
        # optional ``f(drone_id, frame_id) -> [7] | None``: the CURRENT
        # best estimate of a DB keyframe's pose. The PnP pose solves in
        # the refreshed landmark positions' (current-map) frame, so
        # composing it with the stale insertion-time snapshot pose
        # mixes frames across VIO drift; the reference keeps keyframe
        # poses live (moveAllPoses / getFrame current state)
        self.kf_pose_fn = kf_pose_fn
        self.entries: List[KeyframeEntry] = []
        self.gdesc = np.zeros((cfg.max_db, cfg.gdesc_dim), np.float32)
        self.valid = np.zeros(cfg.max_db, bool)
        # columnar (drone_id, frame_id) of each slot so the per-query
        # recency mask is one vectorized compare, not a python loop
        # over the whole DB every keyframe
        self._db_drone = np.full(cfg.max_db, -1, np.int64)
        self._db_frame = np.zeros(cfg.max_db, np.int64)
        self._next_evict = 0
        # Welford running stats of impostor (non-loop) best-match scores
        self._imp_n = 0
        self._imp_mean = 0.0
        self._imp_m2 = 0.0

    def _record_impostor(self, score: float) -> None:
        self._imp_n += 1
        d = score - self._imp_mean
        self._imp_mean += d / self._imp_n
        self._imp_m2 += d * (score - self._imp_mean)

    def effective_netvlad_thres(self) -> float:
        """The retrieval gate in force: the configured constant, or —
        with ``auto_thres`` and enough impostor samples — the running
        mu + k*sigma of non-loop best-match similarities, calibrated to
        the embedding actually running."""
        cfg = self.cfg
        if not cfg.auto_thres or self._imp_n < cfg.auto_thres_min_samples:
            return cfg.netvlad_thres
        sigma = float(np.sqrt(self._imp_m2 / max(self._imp_n - 1, 1)))
        return min(self._imp_mean + cfg.auto_thres_sigma * sigma, 0.999)

    def add_keyframe(self, entry: KeyframeEntry, gdesc: np.ndarray) -> None:
        """Insert into the retrieval DB; when full, evict FIFO (the
        reference's FAISS IndexFlatIP grows unbounded — a bounded ring
        keeps long missions from overflowing the fixed database matrix,
        at the cost of forgetting the oldest places first)."""
        if len(self.entries) < self.cfg.max_db:
            i = len(self.entries)
            self.entries.append(entry)
        else:
            i = self._next_evict
            self._next_evict = (i + 1) % self.cfg.max_db
            self.entries[i] = entry
        self.gdesc[i] = gdesc
        self.valid[i] = True
        self._db_drone[i] = entry.drone_id
        self._db_frame[i] = entry.frame_id

    def query_score(self, gdesc: np.ndarray) -> float:
        """Best retrieval similarity of a global descriptor against the
        DB — the header-only place-recognition gate of the lazy
        broadcast protocol (reference getMatchedPrevKeyframe NetVLAD
        dot-product gate, d2featuretracker.cpp:166-235)."""
        n = len(self.entries)
        if n == 0:
            return -1.0
        sims = self.gdesc[:n] @ np.asarray(gdesc, np.float32)
        sims = np.where(self.valid[:n], sims, -1.0)
        return float(sims.max())

    # ------------------------------------------------------------------

    def _refresh_positions(self, idx: int, old: KeyframeEntry
                           ) -> KeyframeEntry:
        """Fill nan landmark positions of a DB entry from the live
        estimate source (lm_pos_fn docstring). Finite positions are
        kept — refreshes only ADD correspondences, so a reference-frame
        shift on the source side can never corrupt already-consistent
        entries. The refreshed entry is written back to the DB."""
        if self.lm_pos_fn is None or len(old.lm_ids) != len(old.kpt_valid):
            return old
        missing = ~np.isfinite(old.lm_positions).all(axis=1)
        if not missing.any():
            return old
        fresh = np.asarray(
            self.lm_pos_fn(old.drone_id, old.lm_ids), np.float64
        ).reshape(-1, 3)
        got = missing & np.isfinite(fresh).all(axis=1)
        if not got.any():
            return old
        pos = old.lm_positions.copy()
        pos[got] = fresh[got]
        old = old._replace(lm_positions=pos)
        self.entries[idx] = old
        return old

    def _current_pose(self, e: KeyframeEntry) -> np.ndarray:
        if self.kf_pose_fn is not None:
            p = self.kf_pose_fn(e.drone_id, e.frame_id)
            if p is not None:
                return np.asarray(p, np.float64)
        return np.asarray(e.pose, np.float64)

    def detect(self, entry: KeyframeEntry, gdesc: np.ndarray
               ) -> Optional[LoopEdge]:
        """Query the DB for a loop closure for this keyframe. Queries
        that do not end in a verified loop feed the impostor-score
        statistics behind ``effective_netvlad_thres``."""
        n = len(self.entries)
        if n == 0:
            return None
        # mask out frames too recent from the same drone (reference skips
        # neighbors in time)
        valid = self.valid & ~(
            (self._db_drone == entry.drone_id)
            & (np.abs(self._db_frame - entry.frame_id)
               < self.cfg.min_gap_frames)
        )
        if not valid[:n].any():
            return None
        # single-query retrieval stays numpy on the host: one [n, D]
        # matvec is microseconds, while an upload of the DB matrix
        # every keyframe copies max_db x D floats per call
        sims = self.gdesc[:n] @ np.asarray(gdesc, np.float32).ravel()
        sims = np.where(valid[:n], sims, -1e9)
        best = int(np.argmax(sims))
        score = float(sims[best])
        edge = self._detect_verified(entry, score, best)
        if edge is None:
            self._record_impostor(score)
        return edge

    def _match(self, a: KeyframeEntry, sel_a: np.ndarray, b: KeyframeEntry,
               sel_b: np.ndarray, knn: bool = False):
        """Descriptor matches of records ``sel_a`` of ``a`` against records
        ``sel_b`` of ``b``: ``(idx into sel_b, ok)``, by ``matcher_fn``
        unless ``knn``, else by the mutual ratio test on ``device``."""
        if self.matcher_fn is not None and not knn:
            midx, mok = self.matcher_fn(
                a.kpt_desc[sel_a], a.kpt_rays[sel_a], a.kpt_valid[sel_a],
                b.kpt_desc[sel_b], b.kpt_rays[sel_b], b.kpt_valid[sel_b])
            return np.asarray(midx), np.asarray(mok)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        midx, mok = match_descriptors(
            t(a.kpt_desc[sel_a]), t(b.kpt_desc[sel_b]),
            t(a.kpt_valid[sel_a], torch.bool), t(b.kpt_valid[sel_b], torch.bool))
        return midx.cpu().numpy(), mok.cpu().numpy()

    def _match_pairs(self, entry: KeyframeEntry, old: KeyframeEntry, n_views: int,
                     knn: bool = False):
        """Per camera-direction pair, as the reference's
        computeCorrespondFeaturesOnImageArray (loop_detector.cpp:443-537):
        for each offset k, query view c against view (c + k) mod n of the
        candidate, each pair in its own matcher call; the offset with the
        most matches wins. Within one view a landmark appears once, so the
        ratio test never compares it with its own copy from another view,
        and a learned matcher sees each view's whole keypoint set."""
        cam_a, cam_b = np.asarray(entry.kpt_cam), np.asarray(old.kpt_cam)
        best = None
        for k in range(n_views):
            midx = np.zeros(len(cam_a), np.int64)
            mok = np.zeros(len(cam_a), bool)
            for c in range(n_views):
                sa = np.flatnonzero(cam_a == c)
                sb = np.flatnonzero(cam_b == (c + k) % n_views)
                if len(sa) and len(sb):
                    i, ok = self._match(entry, sa, old, sb, knn)
                    midx[sa], mok[sa] = sb[i], ok
            if best is None or mok.sum() > best[1].sum():
                best = (midx, mok)
        return best

    def _match_views(self, entry: KeyframeEntry, old: KeyframeEntry, knn: bool = False):
        """Matches ``(idx into old, ok)`` of every record of ``entry``. A
        single-view pair is one matcher call. A multi-view pair matches
        per camera-direction pair (``_match_pairs``) and needs both
        entries' landmark ids: a query landmark whose views match
        different candidate landmarks loses all its matches (at most one
        of them can be right, and the views cannot say which), and one
        that keeps several keeps only that of its lowest view (its first
        view, whose keypoint the entry's descriptor of the landmark was
        taken from), so the PnP and its inlier count take each landmark
        once. These two rules are the port's own: the reference matches
        each direction pair and keeps every match.

        ``knn``: the ratio test even where ``matcher_fn`` is set."""
        cam_a, cam_b = np.asarray(entry.kpt_cam), np.asarray(old.kpt_cam)
        n_views = int(max(cam_a.max(initial=0), cam_b.max(initial=0))) + 1
        if n_views == 1:
            return self._match(entry, np.arange(len(cam_a)), old, np.arange(len(cam_b)), knn)
        ids_a, ids_b = np.asarray(entry.lm_ids), np.asarray(old.lm_ids)
        if len(ids_a) != len(cam_a) or len(ids_b) != len(cam_b):
            raise ValueError("multi-view keyframe entries need one landmark id per record "
                             f"(got {len(ids_a)} ids for {len(cam_a)} records and "
                             f"{len(ids_b)} for {len(cam_b)})")
        midx, mok = self._match_pairs(entry, old, n_views, knn)
        if not mok.any():
            return midx, mok
        sel = np.flatnonzero(mok)
        pairs = np.unique(np.stack([ids_a[sel], ids_b[midx[sel]]], 1), axis=0)
        lids, n_targets = np.unique(pairs[:, 0], return_counts=True)
        sel = sel[~np.isin(ids_a[sel], lids[n_targets > 1])]
        order = sel[np.lexsort((cam_a[sel], ids_a[sel]))]
        first = np.zeros_like(mok)
        first[order[np.unique(ids_a[order], return_index=True)[1]]] = True
        return midx, first

    def _detect_verified(self, entry: KeyframeEntry, score: float,
                         best: int) -> Optional[LoopEdge]:
        if score < self.effective_netvlad_thres():
            return None
        old = self.entries[best]
        old = self._refresh_positions(best, old)

        midx, mok = self._match_views(entry, old)

        # optional planar-consistency pruning (reference
        # enable_homography_test; only for the plain descriptor
        # matcher, as in the reference). The reference fits one
        # homography PER camera-direction pair
        # (computeCorrespondFeatures called per dir inside
        # computeCorrespondFeaturesOnImageArray) — in multi-direction
        # fisheye loops each view pair obeys a different plane-induced
        # homography, so fit per entry-camera group and union inliers.
        if (self.cfg.enable_homography_test and self.matcher_fn is None
                and mok.sum() >= 4):
            sel_h = np.flatnonzero(mok)
            mok = mok.copy()
            for cam in np.unique(entry.kpt_cam[sel_h]):
                grp = sel_h[entry.kpt_cam[sel_h] == cam]
                ra = entry.kpt_rays[grp]
                rb = old.kpt_rays[midx[grp]]
                fwd = (ra[:, 2] > 0.1) & (rb[:, 2] > 0.1)
                if fwd.sum() < 4:
                    continue
                pa = ra[fwd, :2] / ra[fwd, 2:3]
                pb = rb[fwd, :2] / rb[fwd, 2:3]
                hmask = ransac_homography(
                    pa, pb, self.cfg.homography_thresh)
                mok[grp[fwd][~hmask]] = False

        if mok.sum() < self.cfg.min_match_per_dir:
            return None

        # geometric verification: PnP of the NEW frame against the OLD
        # frame's landmark positions (reference computeLoop direction)
        sel = np.flatnonzero(mok)
        pts_w = old.lm_positions[midx[sel]]
        has3d = np.isfinite(pts_w).all(axis=1)
        sel = sel[has3d]
        if len(sel) < self.cfg.min_inliers:
            return None
        T_w_body, inl = ransac_pnp_body(
            entry.kpt_rays[sel], entry.kpt_cam[sel], self.ext,
            old.lm_positions[midx[sel]],
            thresh=self.cfg.pnp_thresh,
            min_inliers=self.cfg.min_inliers,
            iters=self.cfg.pnp_iters,
        )
        if T_w_body is None or inl.sum() < self.cfg.min_inliers:
            return None

        # gravity-consistency gate (reference gravityCheck,
        # pnp_utils.cpp:85-93): body-frame gravity implied by the PnP
        # attitude must match the one implied by the frame's ego
        # attitude — VIO observes roll/pitch, so any verified loop
        # agrees on them. Applies to intra- AND inter-drone loops.
        g_pnp = np_lie.quat_to_rotmat(T_w_body[3:]).T @ np.array([0, 0, 1.0])
        g_ego = np_lie.quat_to_rotmat(
            np.asarray(entry.pose, np.float64)[3:]).T @ np.array([0, 0, 1.0])
        if np.linalg.norm(np.cross(g_pnp, g_ego)) > \
                self.cfg.gravity_check_thres:
            return None

        # acceptance gates vs ego-motion odometry (yaw/pos gating): the
        # PnP pose is in OLD's world frame; the implied relative pose
        # old_T_new must be consistent for intra-drone loops
        old_pose_now = self._current_pose(old)
        rel = np_lie.pose_compose(
            np_lie.pose_inverse(old_pose_now), T_w_body
        )
        if entry.drone_id == old.drone_id:
            odo_rel = np_lie.pose_compose(
                np_lie.pose_inverse(old.pose), entry.pose
            )
            dp = np.linalg.norm(rel[:3] - odo_rel[:3])
            qd = np_lie.quat_mul(np_lie.quat_conj(rel[3:]), odo_rel[3:])
            dyaw = abs(2 * np.arctan2(abs(qd[2]), abs(qd[3])))
            # drift-scaled gate (odometry drifts; allow generous bounds)
            if dp > max(self.cfg.max_pos_m * 5, 1.0) or \
               dyaw > np.deg2rad(self.cfg.max_yaw_deg * 5):
                return None

        n_inl = int(inl.sum())
        cov_scale = (max(1.0, self.cfg.cov_inlier_ref / max(n_inl, 1))
                     if self.cfg.cov_inlier_ref else 1.0)
        return LoopEdge(
            frame_id_a=old.frame_id,
            frame_id_b=entry.frame_id,
            drone_id_a=old.drone_id,
            drone_id_b=entry.drone_id,
            rel_pose=rel,
            pos_cov=self.cfg.pos_cov * cov_scale,
            yaw_cov=self.cfg.yaw_cov * cov_scale,
            inliers=n_inl,
        )
