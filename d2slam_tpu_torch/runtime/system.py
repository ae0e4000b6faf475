"""One robot's full stack in one object: frontend, VIO, loop closure, PGO.

Counterpart of ``d2slam_tpu/runtime/system.py`` in its single-robot mode
(``estimation_mode="single"``, no transport). The reference runs
``d2vins_node`` (CNN frontend, tracking, VIO) and ``d2pgo_node``
(pose-graph backend) as processes joined by ROS topics
(d2vins/src/d2vins_node.cpp:29, 128-303; d2pgo/src/d2pgo_node.cpp:15-230);
here they are one library object:

    images + IMU ──► FeatureTracker (SuperPoint + fused NetVLAD) ──► D2Estimator
                          │                                             │ odometry
                          └─► global descriptor ─► LoopDetector ─► LoopEdge
                                                                        ▼
                                                   pose-graph solve (PCM, LM / PCG)

The tensors of the frontend, the estimator and the pose-graph solve live
on ``device`` (default ``cuda``); this class is the host-side conductor:
ids, the retrieval database, the pose-graph tables. With ``pgo_async``
the pose-graph solve runs on one worker thread and its own CUDA stream.

Not ported yet, and raising ``NotImplementedError``: the multi-robot
modes (``estimation_mode`` "distributed" / "server", a ``transport``,
``enable_dpgo``: the comm and multi-robot slices) and the learned
matcher (``enable_superglue_local`` / ``_remote``: the SuperGlue slice).
Dropped as TPU placement
workarounds with no counterpart on a local card: ``host_glue_on_cpu`` /
``default_to_cpu`` and the ``PackedAccelFn`` wrappers of the extraction,
NetVLAD and PGO calls.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import threading
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.frontend import netvlad
from d2slam_tpu_torch.frontend import superpoint
from d2slam_tpu_torch.frontend.loop_detector import (
    KeyframeEntry,
    LoopDetector,
    LoopDetectorConfig,
    LoopEdge,
)
from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig, _img_u8
from d2slam_tpu_torch.pgo import PGOEdges, PGOLayout, PGOReport, PGOState, solve_pgo, solve_pgo_pcg
from d2slam_tpu_torch.pgo.pcm import pcm_filter
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device
from d2slam_tpu_torch.utils.perf import PerfTracker
from d2slam_tpu_torch.vins.estimator import D2Estimator
from d2slam_tpu_torch.vins.types import FrontendFrame, Odometry


@dataclasses.dataclass
class SystemConfig:
    """Knobs of the integrated node (reference launch/YAML equivalents)."""

    drone_id: int = 0
    enable_loop_detection: bool = True   # reference enable_loop
    enable_pgo: bool = True
    pgo_every_n_kf: int = 5              # d2pgo solver_timer_freq analog
    pgo_max_poses: int = 256             # initial capacity (the table
    pgo_max_edges: int = 1024            # doubles when full, up to
    pgo_hard_max_poses: int = 32768      # this ceiling)
    # skip PGO keyframes closer than this to the drone's previous one
    # (graph-density gate for hovering missions; 0 = keep all)
    pgo_min_kf_dist: float = 0.0
    # ignore loop edges with implausibly large relative translation
    # (reference loop_distance_threshold gate, d2pgo.cpp:46-52)
    loop_distance_threshold: float = 100.0
    pgo_pose_dof: int = 6                # PGO_POSE_DOF {4, 6}
    pgo_iters: int = 10
    # dense | pcg | auto: auto picks the matrix-free PCG solver once the
    # pose budget outgrows the dense path (pgo/pcg.py)
    pgo_solver: str = "auto"
    # run PGO updates on a background worker thread and CUDA stream (the
    # reference runs PGO in its own process); explicit solve_pgo() calls
    # stay synchronous
    pgo_async: bool = False
    pgo_pcg_threshold: int = 2048
    pgo_cg_iters: int = 100
    # ego-motion edge covariance, distance-scaled (reference
    # setupEgoMotionFactors, d2pgo.cpp:468-528)
    ego_pos_cov_per_m: float = 0.01
    ego_yaw_cov_per_m: float = 0.01
    ego_cov_min: float = 1e-4
    pcm_thres: float = 1.5               # PCM gate on loop edges
    gdesc_dim: int = 1024
    # reference ESTIMATION_MODE; only "single" is ported
    estimation_mode: str = "single"
    enable_dpgo: bool = False
    enable_superglue_local: bool = False
    enable_superglue_remote: bool = False
    # trained frontend weights (npz, the JAX package's layout): SuperPoint
    # weights replace the sp_params argument; NetVLAD weights replace the
    # weight-free global descriptor and run fused into the extraction
    superpoint_weights: str = ""
    netvlad_weights: str = ""


def image_embedding_gdesc(img: np.ndarray, dim: int = 1024) -> np.ndarray:
    """Weight-free global descriptor: L2-normalized, mean-removed
    downsample of the image. Stands in for NetVLAD when no trained
    weights are given; same retrieval contract (unit vector, dot-product
    similarity)."""
    H, W = img.shape[:2]
    side = int(np.sqrt(dim))
    ys = np.linspace(0, H - 1, side).astype(int)
    xs = np.linspace(0, W - 1, side).astype(int)
    v = np.asarray(img, np.float32)[np.ix_(ys, xs)].reshape(-1)
    out = np.zeros(dim, np.float32)
    out[: v.size] = v - v.mean()
    n = np.linalg.norm(out)
    return out / n if n > 1e-9 else out


def _not_ported(what: str, where: str):
    raise NotImplementedError(f"{what} is not ported yet ({where})")


class D2SLAMSystem:
    """One robot's full stack (frontend + VIO + loop closure + PGO).

    cfg: estimator config (``D2Config``); sys_cfg: ``SystemConfig``;
    extrinsics: [C, 7] body_T_cam; cameras: per camera a
    ``PinholeParams`` (or None in feature-level mode); sp_params /
    sp_cfg: SuperPoint weights (numpy, JAX layout) and config.
    extract_fn: optional ``f(img, cam_id) -> SuperPointOutput`` replacing
    SuperPoint. gdesc_fn: optional ``f(img) -> [G]`` global descriptor
    for frames whose tracker computed none. device: default ``cuda``;
    raises without a card unless ``device="cpu"``.
    """

    def __init__(
        self,
        cfg: D2Config,
        sys_cfg: SystemConfig,
        extrinsics: np.ndarray,
        cameras,
        sp_params=None,
        sp_cfg=None,
        *,
        extract_fn=None,
        gdesc_fn=None,
        transport=None,
        tracker_cfg: Optional[TrackerConfig] = None,
        loop_cfg: Optional[LoopDetectorConfig] = None,
        frame_rate: float = 8.0,
        device=None,
    ):
        if sys_cfg.estimation_mode != "single":
            _not_ported(f"estimation_mode={sys_cfg.estimation_mode!r}", "the multi-robot slice")
        if transport is not None:
            _not_ported("a transport (keyframe broadcast, remote ingestion)", "the comm slice")
        if sys_cfg.enable_dpgo:
            _not_ported("enable_dpgo (distributed PGO)", "the multi-robot slice")
        if sys_cfg.enable_superglue_local or sys_cfg.enable_superglue_remote:
            _not_ported("the SuperGlue matcher", "the SuperGlue slice")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ext = np.asarray(extrinsics, np.float64)
        self.drone_id = sys_cfg.drone_id
        self.perf = PerfTracker()

        if sp_cfg is None:
            sp_cfg = superpoint.SuperPointConfig(max_keypoints=200, threshold=1e-4)
        if sys_cfg.superpoint_weights and sp_params is None:
            sp_params = superpoint.load_params(sys_cfg.superpoint_weights)

        aux_fn = None
        self.netvlad = None
        if sys_cfg.netvlad_weights and gdesc_fn is None:
            nv = netvlad.NetVLAD(netvlad.load_params(sys_cfg.netvlad_weights), device=self.device)
            self.netvlad = nv
            # the descriptor's size is the loaded network's (PCA dims plus
            # the gate component), as the reference reads it from its model
            sys_cfg = dataclasses.replace(sys_cfg, gdesc_dim=nv.output_dim)

            def aux_fn(imgs_u8):   # view 0 of the frame's uploaded views
                return nv(imgs_u8[:1].float() / 255.0)[0]

            def gdesc_fn(img):     # feature-level inputs: one upload of its own
                u8 = torch.as_tensor(_img_u8(img), device=self.device)
                return nv(u8[None].float() / 255.0)[0].cpu().numpy()
        self.sys = sys_cfg

        self.tracker = FeatureTracker(
            sp_params, sp_cfg, cameras, tracker_cfg or TrackerConfig(),
            frame_rate=frame_rate, device=self.device, extrinsics=self.ext,
            extract_fn=extract_fn, aux_fn=aux_fn,
        )
        self.gdesc_fn = gdesc_fn or (lambda img: image_embedding_gdesc(img, sys_cfg.gdesc_dim))

        lc = loop_cfg or LoopDetectorConfig(gdesc_dim=sys_cfg.gdesc_dim)
        if self.netvlad is not None and lc.gdesc_dim != sys_cfg.gdesc_dim:
            lc = dataclasses.replace(lc, gdesc_dim=sys_cfg.gdesc_dim)

        def lm_pos_fn(drone_id: int, lm_ids) -> np.ndarray:
            out = np.full((len(lm_ids), 3), np.nan)
            if drone_id == self.drone_id:
                db = self.estimator.lmanager.db
                for k, lid in enumerate(lm_ids):
                    lm = db.get(int(lid))
                    if lm is not None and lm.position is not None:
                        out[k] = lm.position
            return out

        def kf_pose_fn(drone_id: int, frame_id: int):
            # current best estimate of one of our keyframes: the sliding
            # window first (most recent), then the optimized PGO table
            if drone_id != self.drone_id:
                return None
            est = self.estimator
            for w, fr in enumerate(est.frames):
                if fr.frame_id == frame_id and fr.drone_id in (-1, drone_id):
                    return est.state.poses[w].cpu().numpy().astype(np.float64)
            slot = self._pgo_slot.get((drone_id, frame_id))
            if slot is not None and self.pgo_solve_count and self._pgo_poses is not None:
                with self._pgo_lock:
                    return self._pgo_poses[slot].copy()
            return None

        self.detector = LoopDetector(lc, self.ext, lm_pos_fn=lm_pos_fn, kf_pose_fn=kf_pose_fn,
                                     device=self.device)
        self.estimator = D2Estimator(cfg, self.ext, device=self.device)

        # ---- PGO graph bookkeeping (host side) ----
        self._pgo_slot: Dict[Tuple[int, int], int] = {}   # (drone, frame) -> slot
        # per slot: drone_id, frame_id, stamp, ego pose at insertion
        self._pgo_meta: List[Tuple[int, int, float, np.ndarray]] = []
        self._last_kf_of: Dict[int, int] = {}  # drone -> last slot
        self._ego_edges: List[Tuple[int, int, np.ndarray, float]] = []
        self.loop_edges: List[LoopEdge] = []
        self._loop_keys: set = set()          # dedup (a, b) loop pairs
        self._pgo_poses: Optional[np.ndarray] = None  # optimized [N, 7]
        self._pgo_capacity = sys_cfg.pgo_max_poses
        self._pgo_edge_capacity = sys_cfg.pgo_max_edges
        self._kf_since_pgo = 0
        self.pgo_solve_count = 0
        self.loops_kept = 0                   # loops the last solve's PCM kept
        self._frame_id = 0
        # the mutex guards the PGO tables against the async worker
        # (snapshot and write-back); the epoch drops a solve whose input
        # poses were rewritten while it ran (in the JAX package a
        # multi-robot map merge does that; nothing in single mode does)
        self._pgo_lock = threading.RLock()
        self._pgo_solve_lock = threading.Lock()
        self._pgo_epoch = 0
        self._pgo_executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pgo_future: Optional[concurrent.futures.Future] = None
        self._pgo_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                            else None)

        self.odometry: Optional[Odometry] = None
        self.last_loop: Optional[LoopEdge] = None
        self.last_pgo_report: Optional[PGOReport] = None

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def input_imu(self, t: float, acc, gyr, want_odometry: bool = False) -> Optional[Odometry]:
        """Feed one IMU sample; with ``want_odometry`` also return the
        IMU-rate propagated odometry."""
        self.estimator.input_imu(t, acc, gyr)
        if want_odometry:
            return self.estimator.predict_odometry(t)
        return None

    def input_stereo(self, t: float, img_left: np.ndarray,
                     img_right: np.ndarray) -> Optional[Odometry]:
        """Process one stereo pair. Returns VIO odometry on keyframes."""
        ff = self.tracker.process_stereo(t, self._frame_id, img_left, img_right)
        return self._after_tracking(ff, [img_left, img_right])

    def input_quadcam(self, t: float, imgs: List[np.ndarray]) -> Optional[Odometry]:
        """Process one 4-view frame of undistorted virtual-pinhole views."""
        ff = self.tracker.process_quadcam(t, self._frame_id, imgs)
        return self._after_tracking(ff, list(imgs))

    def input_rgbd(self, t: float, img: np.ndarray, depth: np.ndarray
                   ) -> Optional[Odometry]:
        """Process one mono image + aligned metric depth image (the
        reference's PINHOLE_DEPTH configuration, e.g. a RealSense D435).
        Keypoints inside the accepted depth range carry a measured depth
        that the estimator turns into depth residuals."""
        ff = self.tracker.process_rgbd(t, self._frame_id, img, depth)
        return self._after_tracking(ff, [img])

    def _after_tracking(self, ff: Optional[FrontendFrame], imgs) -> Optional[Odometry]:
        self._frame_id += 1
        if ff is None:
            return None
        od = self.estimator.input_frame(ff)
        if od is not None:
            self.odometry = od
            self._register_keyframe(ff, od, imgs)
        return od

    def input_frame(self, ff: FrontendFrame, gdesc: Optional[np.ndarray] = None,
                    kf_entry: Optional[KeyframeEntry] = None) -> Optional[Odometry]:
        """Feature-level input (oracle frontends / replayed tracks)."""
        od = self.estimator.input_frame(ff)
        if od is not None:
            self.odometry = od
            self._register_keyframe(ff, od, None, gdesc=gdesc, entry=kf_entry)
        return od

    # ------------------------------------------------------------------
    # keyframe fan-out: loop detection, PGO graph
    # ------------------------------------------------------------------

    def _frame_gdesc(self, imgs, aux: Optional[torch.Tensor] = None) -> np.ndarray:
        """A keyframe's global descriptor: ``aux`` (the network fused into
        the extraction), else the tracker's ``last_aux``, else
        ``gdesc_fn`` of view 0, else zeros."""
        if aux is None:
            aux = self.tracker.last_aux
        if aux is not None:
            return aux.cpu().numpy()
        if imgs is not None:
            return np.asarray(self.gdesc_fn(imgs[0]), np.float32)
        return np.zeros(self.sys.gdesc_dim, np.float32)

    def keyframe_inputs(self, imgs, aux: Optional[torch.Tensor] = None) -> Dict:
        """What a keyframe's registration reads from the frontend, taken
        now, as host arrays: ``gdesc`` (see ``_frame_gdesc``) and, with
        loop detection, ``desc_of``, the tracker's last keyframe
        descriptors by landmark id. The pipelined runtime takes them on
        its frontend thread, before the tracker moves on, and passes them
        to ``_register_keyframe``."""
        desc_of = self._entry_descriptors() if self.sys.enable_loop_detection else None
        return dict(gdesc=self._frame_gdesc(imgs, aux), desc_of=desc_of)

    def _register_keyframe(self, ff: FrontendFrame, od: Odometry, imgs,
                           gdesc: Optional[np.ndarray] = None,
                           entry: Optional[KeyframeEntry] = None,
                           desc_of: Optional[Dict[int, np.ndarray]] = None) -> None:
        pose = np.asarray(od.pose, np.float64)
        self._add_pgo_node(self.drone_id, ff.frame_id, ff.stamp, pose)

        gdesc = np.asarray(self._frame_gdesc(imgs) if gdesc is None else gdesc, np.float32)

        if self.sys.enable_loop_detection:
            if entry is None:
                entry = self._make_entry(ff, pose, desc_of)
            else:
                # refresh caller-provided entries with the post-solve pose
                # and current landmark estimates (ids from the entry when
                # it carries them, else cam0 order)
                if len(entry.lm_ids) == len(entry.kpt_valid):
                    ids = [int(i) for i in entry.lm_ids]
                else:
                    obs0 = next((o for o in ff.observations if o.cam_id == 0), None)
                    ids = [int(i) for i in obs0.landmark_ids] if obs0 is not None else []
                entry = entry._replace(pose=pose, lm_positions=self._lm_positions_of(ff, ids))
            if entry is not None:
                with self.perf.stage("loop_detect"):
                    edge = self.detector.detect(entry, gdesc)
                self.detector.add_keyframe(entry, gdesc)
                if edge is not None:
                    self.add_loop_edge(edge)

        self._kf_since_pgo += 1
        if (self.sys.enable_pgo and self._kf_since_pgo >= self.sys.pgo_every_n_kf
                and len(self._pgo_meta) >= 3):
            if self.sys.pgo_async:
                self._solve_pgo_background()
            else:
                self.solve_pgo()

    def _solve_pgo_background(self) -> None:
        """Kick a PGO update on the worker thread. If the previous update
        is still running, only reset the cadence counter: the running
        solve covers most of the graph and the next cadence point picks
        up the rest."""
        self._kf_since_pgo = 0
        fut = self._pgo_future
        if fut is not None and not fut.done():
            return
        if fut is not None:
            fut.result()  # surface worker exceptions
        if self._pgo_executor is None:
            self._pgo_executor = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="pgo")
        self._pgo_future = self._pgo_executor.submit(self.solve_pgo)

    def wait_pgo(self) -> None:
        """Block until any in-flight background PGO update finishes."""
        if self._pgo_future is not None:
            self._pgo_future.result()

    def close(self) -> None:
        """Finish the background PGO update, if any, and stop its worker."""
        self.wait_pgo()
        if self._pgo_executor is not None:
            self._pgo_executor.shutdown()
            self._pgo_executor = None

    def _entry_descriptors(self) -> Dict[int, np.ndarray]:
        """Host copies of the tracker's last keyframe descriptors (of each
        view, for a multi-view rig) by landmark id, the first view's where
        several see a landmark."""
        desc_of = {}
        kfs = [self.tracker.last_kf] if self.tracker.last_kf else list(
            self.tracker.last_kf_mv.values())
        for kf in kfs:
            if kf and "desc" in kf:
                desc = kf["desc"].cpu().numpy()
                for lid, d, v in zip(kf["ids"], desc, kf["valid"]):
                    if v and lid >= 0:
                        desc_of.setdefault(int(lid), d)
        return desc_of

    def _make_entry(self, ff: FrontendFrame, pose: np.ndarray,
                    desc_of: Optional[Dict[int, np.ndarray]] = None) -> Optional[KeyframeEntry]:
        """A retrieval-DB entry from all views' observations and the
        current landmark estimates (quadcam entries carry the camera
        index of each keypoint for multi-direction matching).
        ``desc_of``: the keyframe's descriptors by landmark id, taken when
        the frame was tracked (default: ``_entry_descriptors()`` now).

        Each landmark enters once, from the first view that sees it. The
        JAX package enters it once per view with the same descriptor
        (its descriptors are looked up by landmark id), so a stereo
        entry holds every descriptor twice and the ratio test of the loop
        matcher, which compares a keypoint's two nearest neighbours,
        rejects almost every match."""
        if desc_of is None:
            desc_of = self._entry_descriptors()
        ids, cams, rays, seen = [], [], [], set()
        for o in ff.observations:
            for lid, ray in zip(o.landmark_ids, np.asarray(o.rays, np.float64)):
                if int(lid) in seen:
                    continue
                seen.add(int(lid))
                ids.append(int(lid))
                cams.append(o.cam_id)
                rays.append(ray)
        if not ids:
            return None
        D = self.detector.cfg.desc_dim
        zero = np.zeros(D, np.float32)
        desc = np.stack([desc_of.get(lid, zero) for lid in ids])
        return KeyframeEntry(
            frame_id=ff.frame_id, drone_id=self.drone_id, stamp=ff.stamp,
            pose=pose, kpt_rays=np.asarray(rays).reshape(-1, 3),
            kpt_cam=np.asarray(cams, np.int32), kpt_desc=desc,
            kpt_valid=np.ones(len(ids), bool), lm_positions=self._lm_positions_of(ff, ids),
            lm_ids=np.asarray(ids, np.int64),
        )

    def _lm_positions_of(self, ff: FrontendFrame, ids=None) -> np.ndarray:
        """World positions of landmarks from the estimator's DB (nan where
        not yet estimated); ``ids`` defaults to every view's landmark ids
        in observation order."""
        if ids is None:
            ids = [int(i) for o in ff.observations for i in o.landmark_ids]
        lm_pos = np.full((len(ids), 3), np.nan)
        for k, lid in enumerate(ids):
            lm = self.estimator.lmanager.db.get(int(lid))
            if lm is not None and lm.position is not None:
                lm_pos[k] = lm.position
        return lm_pos

    # ------------------------------------------------------------------
    # pose-graph backend (the d2pgo_node role)
    # ------------------------------------------------------------------

    def _grow_pgo_table(self) -> bool:
        """Double the pose and edge capacity (up to ``pgo_hard_max_poses``)
        so long missions keep extending the graph; past
        ``pgo_pcg_threshold`` the "auto" solver routes to PCG."""
        new_cap = min(self._pgo_capacity * 2, self.sys.pgo_hard_max_poses)
        if new_cap <= self._pgo_capacity:
            return False
        poses = np.zeros((new_cap, 7))
        poses[:, 6] = 1.0
        if self._pgo_poses is not None:
            poses[: self._pgo_capacity] = self._pgo_poses
        self._pgo_poses = poses
        self._pgo_capacity = new_cap
        self._pgo_edge_capacity = min(self._pgo_edge_capacity * 2,
                                      self.sys.pgo_hard_max_poses * 8)
        return True

    def _add_pgo_node(self, drone_id: int, frame_id: int, stamp: float,
                      ego_pose: np.ndarray) -> None:
        key = (drone_id, frame_id)
        if key in self._pgo_slot:
            return
        if self.sys.pgo_min_kf_dist > 0:
            prev = self._last_kf_of.get(drone_id)
            if prev is not None and (np.linalg.norm(np.asarray(ego_pose[:3])
                                                    - self._pgo_meta[prev][3][:3])
                                     < self.sys.pgo_min_kf_dist):
                return  # the next inserted node chains prev -> it directly
        with self._pgo_lock:
            if len(self._pgo_meta) >= self._pgo_capacity and not self._grow_pgo_table():
                warnings.warn(f"PGO graph at pgo_hard_max_poses={self.sys.pgo_hard_max_poses}; "
                              f"dropping keyframe ({drone_id}, {frame_id})")
                return
            slot = len(self._pgo_meta)
            self._pgo_slot[key] = slot
            self._pgo_meta.append((drone_id, frame_id, stamp, np.asarray(ego_pose, np.float64)))
            if self._pgo_poses is None:
                self._pgo_poses = np.zeros((self._pgo_capacity, 7))
                self._pgo_poses[:, 6] = 1.0
            self._pgo_poses[slot] = ego_pose
            prev = self._last_kf_of.get(drone_id)
            if prev is not None:
                # ego-motion edge with distance-scaled covariance
                rel = np_lie.pose_compose(np_lie.pose_inverse(self._pgo_meta[prev][3]), ego_pose)
                self._ego_edges.append((prev, slot, rel, float(np.linalg.norm(rel[:3]))))
            self._last_kf_of[drone_id] = slot

    def add_loop_edge(self, edge: LoopEdge) -> None:
        key = (edge.drone_id_a, edge.frame_id_a, edge.drone_id_b, edge.frame_id_b)
        if key in self._loop_keys:
            return
        if np.linalg.norm(np.asarray(edge.rel_pose[:3])) > self.sys.loop_distance_threshold:
            return  # implausible loop (reference d2pgo.cpp:46-52)
        self._loop_keys.add(key)
        self.loop_edges.append(edge)
        self.last_loop = edge

    def solve_pgo(self) -> Optional[np.ndarray]:
        """One PGO update over the accumulated graph. Returns optimized
        poses [n, 7]. Serialized against the background worker by
        ``_pgo_solve_lock``; the input snapshot is taken under
        ``_pgo_lock`` and the write-back is dropped if ``_pgo_epoch``
        moved while the solve ran."""
        with self._pgo_solve_lock, self.perf.stage("pgo_solve"):
            return self._solve_pgo_impl()

    def _solve_pgo_impl(self) -> Optional[np.ndarray]:
        self._kf_since_pgo = 0
        with self._pgo_lock:
            n = len(self._pgo_meta)
            if n < 3:
                return None
            epoch0 = self._pgo_epoch
            # grow edge capacity ahead of assembly so no edge is dropped
            needed = len(self._ego_edges) + len(self.loop_edges)
            cap_max = self.sys.pgo_hard_max_poses * 8
            while needed > self._pgo_edge_capacity and self._pgo_edge_capacity < cap_max:
                self._pgo_edge_capacity = min(self._pgo_edge_capacity * 2, cap_max)
            layout = PGOLayout(self._pgo_capacity, self._pgo_edge_capacity, self.sys.pgo_pose_dof)
            E = layout.E
            ei = np.zeros(E, np.int64)
            ej = np.zeros(E, np.int64)
            rel = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (E, 1))
            si = np.tile(np.eye(6), (E, 1, 1))
            valid = np.zeros(E, bool)
            k = 0
            for (a, b, r, dist) in self._ego_edges[:E]:
                cov_p = max(self.sys.ego_cov_min, self.sys.ego_pos_cov_per_m * dist)
                cov_y = max(self.sys.ego_cov_min, self.sys.ego_yaw_cov_per_m * dist)
                ei[k], ej[k], rel[k] = a, b, r
                si[k] = np.diag([1 / np.sqrt(cov_p)] * 3 + [1 / np.sqrt(cov_y)] * 3)
                valid[k] = True
                k += 1
            loops = self._usable_loops()
            mask = self._pcm_mask(loops) if len(loops) > 1 else np.ones(len(loops), bool)
            self.loops_kept = int(mask.sum())
            for keep, (sa, sb, e) in zip(mask, loops):
                if k >= E or not keep:
                    continue
                ei[k], ej[k], rel[k] = sa, sb, e.rel_pose
                si[k] = np.diag([1 / np.sqrt(e.pos_cov)] * 3 + [1 / np.sqrt(e.yaw_cov)] * 3)
                valid[k] = True
                k += 1
            poses = np.array(self._pgo_poses)
        v = np.zeros(layout.N, bool)
        v[:n] = True
        fixed = np.zeros(layout.N, bool)
        fixed[0] = True  # gauge: first frame (reference main_id first kf)
        use_pcg = self.sys.pgo_solver == "pcg" or (
            self.sys.pgo_solver == "auto"
            and (layout.N > self.sys.pgo_pcg_threshold or layout.E > 4 * self.sys.pgo_pcg_threshold))
        # float32, as the JAX system passes the graph to its solver
        state = PGOState(poses=poses.astype(np.float32), valid=v)
        edges = PGOEdges(i=ei, j=ej, rel=rel.astype(np.float32),
                         sqrt_info=si.astype(np.float32), valid=valid)
        stream = self._pgo_stream
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            if use_pcg:
                out, rep = solve_pgo_pcg(layout, state, edges, fixed, max_iters=self.sys.pgo_iters,
                                         cg_iters=self.sys.pgo_cg_iters, device=self.device)
            else:
                out, rep = solve_pgo(layout, state, edges, fixed, max_iters=self.sys.pgo_iters,
                                     device=self.device)
        if stream is not None:
            stream.synchronize()   # the result is complete before it is read back
        opt = out.poses.cpu().numpy().astype(np.float64)
        opt[:, 3:] /= np.linalg.norm(opt[:, 3:], axis=1, keepdims=True)
        with self._pgo_lock:
            if self._pgo_epoch == epoch0:
                self._pgo_poses[:n] = opt[:n]
            else:
                opt = self._pgo_poses[:n].copy()
            self.pgo_solve_count += 1
            self.last_pgo_report = PGOReport(float(rep.initial_cost), float(rep.final_cost),
                                             int(rep.accepted))
        return opt[:n]

    def _usable_loops(self) -> List[Tuple[int, int, LoopEdge]]:
        out = []
        for e in self.loop_edges:
            sa = self._pgo_slot.get((e.drone_id_a, e.frame_id_a))
            sb = self._pgo_slot.get((e.drone_id_b, e.frame_id_b))
            if sa is not None and sb is not None:
                out.append((sa, sb, e))
        return out

    def _pcm_mask(self, loops) -> np.ndarray:
        """PCM consistency gate on loop edges (reference
        OutlierRejectionLoopEdges). A failure raises: keeping every loop
        would hide it."""
        rels = np.stack([e.rel_pose for (_, _, e) in loops])
        pa = np.stack([self._pgo_meta[sa][3] for (sa, _, _) in loops])
        pb = np.stack([self._pgo_meta[sb][3] for (_, sb, _) in loops])
        return pcm_filter(rels, pa, pb, thres=self.sys.pcm_thres, device=self.device)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def pgo_odometry(self) -> Optional[Odometry]:
        """PGO-corrected realtime pose: the last optimized pose
        extrapolated by the ego-motion since (reference getPredictedOdoms)."""
        if self.odometry is None:
            return None
        slot = self._last_kf_of.get(self.drone_id)
        if slot is None or self._pgo_poses is None or not self.pgo_solve_count:
            return self.odometry
        _, _, _, ego_at = self._pgo_meta[slot]
        with self._pgo_lock:
            opt = self._pgo_poses[slot].copy()
        rel = np_lie.pose_compose(np_lie.pose_inverse(ego_at),
                                  np.asarray(self.odometry.pose, np.float64))
        return Odometry(self.odometry.stamp, np_lie.pose_compose(opt, rel), self.odometry.vel)

    def trajectory(self, drone_id: Optional[int] = None, optimized: bool = True):
        """(stamps, poses [7]) of a drone's keyframes from the pose graph
        (optimized) or the raw ego poses."""
        did = self.drone_id if drone_id is None else drone_id
        stamps, poses = [], []
        with self._pgo_lock:
            for slot, (d, _, t, ego) in enumerate(self._pgo_meta):
                if d != did:
                    continue
                stamps.append(t)
                if optimized and self._pgo_poses is not None and self.pgo_solve_count:
                    poses.append(self._pgo_poses[slot].copy())
                else:
                    poses.append(ego.copy())
        return np.asarray(stamps), np.asarray(poses)
