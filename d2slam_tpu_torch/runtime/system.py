"""One robot's full stack in one object: frontend, VIO, loop closure, PGO,
and the swarm link.

Counterpart of ``d2slam_tpu/runtime/system.py``. The reference runs
``d2vins_node`` (CNN frontend, tracking, VIO, keyframe broadcast),
``d2pgo_node`` (pose-graph backend) and ``d2comm_node`` as processes
joined by ROS topics (d2vins/src/d2vins_node.cpp:29, 128-303;
d2pgo/src/d2pgo_node.cpp:15-230);
here they are one library object:

    images + IMU ──► FeatureTracker (SuperPoint + fused NetVLAD) ──► D2Estimator
        │                                                               │ odometry
        ├─► global descriptor ─► LoopDetector ─► LoopEdge ──────────────┤
        │                                                               ▼
        └─► LoopNet broadcast (UDP / LocalBus)          pose-graph solve (PCM, LM / PCG)
                       ▲
            remote keyframes ─► SwarmManager ─► inter-robot loops, map alignment,
                                                reference-frame merge

The tensors of the frontend, the estimator, SuperGlue and the pose-graph
solve live on ``device`` (default ``cuda``); this class is the host-side
conductor: ids, the retrieval database, the pose-graph tables, the
packets. With ``pgo_async`` the pose-graph solve runs on one worker
thread and its own CUDA stream.

With a ``transport`` each robot broadcasts its keyframes (greedy, or
lazily as headers that a peer's retrieval gate pulls in full), receives
its peers' keyframes and loop edges (``poll_network``), detects
inter-robot loops, aligns the peers' maps, merges reference frames
toward the lowest drone id and solves one pose graph over every robot's
keyframes. ``enable_superglue_local`` / ``_remote`` route the tracker's
and the loop detector's matching through SuperGlue.

Multi-robot estimation (``estimation_mode``): "single" solves the own
window; "distributed" (DISTRIBUTED_CAMERA_CONSENUS) ingests the peers'
keyframes into a pooled window (``vins.solve_all``) and runs consensus
sub-steps with them over the transport at every solve, the robots
stepping in lockstep on the consensus tokens; "server" is a ground
station that estimates every drone from their packets alone
(``solve_server``). ``enable_dpgo`` replaces the local pose-graph solve
with ARock rounds over the transport (``pgo.dpgo_transport``).
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

from d2slam_tpu_torch.comm.codec import RemoteKeyframePacket
from d2slam_tpu_torch.comm.consensus_transport import TransportConsensus
from d2slam_tpu_torch.comm.loopnet import CH_KF_REQUEST, LoopNet, nearby_drones_from_pgo
from d2slam_tpu_torch.comm.transport import (
    CH_DISTRIB_VINS,
    CH_PGO_DATA,
    CH_SWARM_LOOP,
    CH_VIOKF_HEADER,
    CH_VIOKF_IMG,
    CH_VIOKF_LANDMARKS,
    ChannelRouter,
)
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.frontend import netvlad
from d2slam_tpu_torch.frontend import superpoint
from d2slam_tpu_torch.frontend.loop_detector import (
    KeyframeEntry,
    LoopDetector,
    LoopDetectorConfig,
    LoopEdge,
)
from d2slam_tpu_torch.frontend.superglue import (
    COMPACT,
    SuperGlue,
    SuperGlueConfig,
    make_loop_matcher,
    make_tracker_matcher,
    superglue_init,
)
from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig, _img_u8
from d2slam_tpu_torch.frontend.train_frontend import load_weights
from d2slam_tpu_torch.pgo import PGOEdges, PGOLayout, PGOReport, PGOState, solve_pgo, solve_pgo_pcg
from d2slam_tpu_torch.pgo.dpgo_transport import DPGOTransportConfig, TransportDPGO
from d2slam_tpu_torch.pgo.pcm import pcm_filter
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device
from d2slam_tpu_torch.utils.perf import PerfTracker
from d2slam_tpu_torch.vins.estimator import D2Estimator
from d2slam_tpu_torch.vins.solve_all import SolveAllEstimator
from d2slam_tpu_torch.vins.swarm import SwarmManager
from d2slam_tpu_torch.vins.types import FrontendFrame, Odometry, global_frame_id


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
    lazy_broadcast: bool = False         # lazy_broadcast_keyframe
    broadcast: bool = True               # send keyframes when a transport is set
    # ship the PNG-compressed camera view(s) with every keyframe
    # (reference send_img -> VIOKF_IMG_ARRAY; debug and visualization)
    send_img: bool = False
    # reference ESTIMATION_MODE (d2basetypes.h): "single" solves only our
    # own window; "distributed" is DISTRIBUTED_CAMERA_CONSENUS: remote
    # keyframes join our window (addFrameRemote) and every solve runs
    # consensus-ADMM sub-steps with the peers, shared poses matched by
    # frame id on the wire; "server" estimates every drone from their
    # packets, with no sensors of its own
    estimation_mode: str = "single"
    max_drones: int = 3                  # windows in the pooled estimator
    consensus_timeout_ms: int = 100      # wait for the peers' copies per sub-step
    # ingest remote frames before a map alignment exists (a swarm launched
    # in a shared world frame, e.g. from a common takeoff calibration;
    # otherwise frames wait for the first inter-drone loop)
    assume_common_world: bool = False
    # transport-based distributed PGO: ARock rounds over CH_PGO_DATA
    # (reference ARockPGO -> d2comm -> PGO_Sync_Data) in place of the
    # local pose-graph solve
    enable_dpgo: bool = False
    dpgo_rho_T: float = 0.1              # pgo_rho_frame_T
    dpgo_rho_theta: float = 2.0          # pgo_rho_frame_theta
    dpgo_eta_k: float = 0.9              # pgo_eta_k
    dpgo_iters: int = 6                  # LM iterations per ARock step
    broadcast_loops: bool = True         # share loops on SWARM_LOOP_CONN
    # nearby-drone gate of the lazy broadcast's full-frame escalation
    # (reference getNearbyDronesbyPGOData, d2estimator.cpp:931-976)
    nearby_distance: float = 5.0
    nearby_max_age: float = 10.0
    # learned matcher (reference enable_superglue_local / _remote): the
    # tracker's local matching and / or the loop detector's matching go
    # through SuperGlue, with the weights of the superglue_params argument
    # or superglue_weights (random init, with a warning, without either)
    enable_superglue_local: bool = False
    enable_superglue_remote: bool = False
    superglue_img_hw: tuple = (480, 640)
    # trained frontend weights (npz, the JAX package's layout): SuperPoint
    # weights replace the sp_params argument; NetVLAD weights replace the
    # weight-free global descriptor and run fused into the extraction;
    # SuperGlue weights (the compact 3-layer recipe) feed the matchers
    superpoint_weights: str = ""
    netvlad_weights: str = ""
    superglue_weights: str = ""


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


class D2SLAMSystem:
    """One robot's full stack (frontend + VIO + loop closure + PGO).

    cfg: estimator config (``D2Config``); sys_cfg: ``SystemConfig``;
    extrinsics: [C, 7] body_T_cam; cameras: per camera a
    ``PinholeParams`` (or None in feature-level mode); sp_params /
    sp_cfg: SuperPoint weights (numpy, JAX layout) and config.
    extract_fn: optional ``f(img, cam_id) -> SuperPointOutput`` replacing
    SuperPoint. gdesc_fn: optional ``f(img) -> [G]`` global descriptor
    for frames whose tracker computed none. transport: optional swarm
    transport (``comm.transport.UDPMulticastTransport``, a ``LocalBus``
    endpoint, anything with ``send`` / ``recv``). matcher_fn /
    loop_matcher_fn: learned matchers of the tracker and the loop
    detector (they win over ``enable_superglue_*``); superglue_params /
    superglue_cfg: SuperGlue weights (JAX layout) and configuration for
    those flags. device: default ``cuda``; raises without a card unless
    ``device="cpu"``.
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
        matcher_fn=None,
        loop_matcher_fn=None,
        superglue_params=None,
        superglue_cfg: Optional[SuperGlueConfig] = None,
        device=None,
    ):
        if sys_cfg.estimation_mode not in ("single", "distributed", "server"):
            raise ValueError(f"unknown estimation_mode {sys_cfg.estimation_mode!r} "
                             "(expected single | distributed | server)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ext = np.asarray(extrinsics, np.float64)
        self.drone_id = sys_cfg.drone_id
        # the world frame our poses live in: our own drone id at the start
        # (0 in a common world), merged toward the lowest id in the swarm
        # (reference D2State reference_frame_id and moveAllPoses,
        # d2estimator.cpp:274-281)
        self.ref_frame_id = 0 if sys_cfg.assume_common_world else self.drone_id
        self.perf = PerfTracker("system")
        self.pgo_perf = PerfTracker("pgo")

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

        # config-driven SuperGlue matchers (explicit matcher_fn arguments win)
        self.superglue: Optional[SuperGlue] = None
        if sys_cfg.enable_superglue_local or sys_cfg.enable_superglue_remote:
            if superglue_params is None and sys_cfg.superglue_weights:
                superglue_params = load_weights(sys_cfg.superglue_weights)
                superglue_cfg = superglue_cfg or COMPACT
            superglue_cfg = superglue_cfg or SuperGlueConfig()
            if superglue_params is None:
                warnings.warn(
                    "enable_superglue_local/remote is set but no trained weights were given "
                    "(superglue_params / superglue_weights): running a random-init SuperGlue, "
                    "which matches worse than the default nearest-neighbour matcher")
                superglue_params = superglue_init(torch.Generator().manual_seed(0),
                                                  superglue_cfg)
            self.superglue = SuperGlue(superglue_params, superglue_cfg, device=self.device)
            if sys_cfg.enable_superglue_local and matcher_fn is None:
                matcher_fn = make_tracker_matcher(self.superglue, tuple(sys_cfg.superglue_img_hw))
            if sys_cfg.enable_superglue_remote and loop_matcher_fn is None:
                loop_matcher_fn = make_loop_matcher(self.superglue)

        self.tracker = FeatureTracker(
            sp_params, sp_cfg, cameras, tracker_cfg or TrackerConfig(),
            frame_rate=frame_rate, device=self.device, extrinsics=self.ext,
            extract_fn=extract_fn, aux_fn=aux_fn, matcher_fn=matcher_fn,
        )
        self.gdesc_fn = gdesc_fn or (lambda img: image_embedding_gdesc(img, sys_cfg.gdesc_dim))

        lc = loop_cfg or LoopDetectorConfig(gdesc_dim=sys_cfg.gdesc_dim)
        if self.netvlad is not None and lc.gdesc_dim != sys_cfg.gdesc_dim:
            lc = dataclasses.replace(lc, gdesc_dim=sys_cfg.gdesc_dim)
        # the latest wire-reported position of each remote landmark: loop
        # verification against a remote keyframe gets fresh 3D even where
        # the entry predates the landmark's triangulation
        self._remote_lm_pos: Dict[Tuple[int, int], np.ndarray] = {}

        def lm_pos_fn(drone_id: int, lm_ids) -> np.ndarray:
            out = np.full((len(lm_ids), 3), np.nan)
            if drone_id == self.drone_id:
                db = self.estimator.lmanager.db
                for k, lid in enumerate(lm_ids):
                    lm = db.get(int(lid))
                    if lm is not None and lm.position is not None:
                        out[k] = lm.position
            else:
                for k, lid in enumerate(lm_ids):
                    p = self._remote_lm_pos.get((drone_id, int(lid)))
                    if p is not None:
                        out[k] = p
            return out

        def kf_pose_fn(drone_id: int, frame_id: int):
            # current best estimate of one of our keyframes: the sliding
            # window first (most recent), then the optimized PGO table.
            # Remote entries return None: their landmark refreshes are in
            # the sender's frame, which the entry's pose already matches
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

        self.detector = LoopDetector(lc, self.ext, matcher_fn=loop_matcher_fn,
                                     lm_pos_fn=lm_pos_fn, kf_pose_fn=kf_pose_fn,
                                     device=self.device)
        self.swarm = SwarmManager(self.drone_id, self.detector)
        if sys_cfg.estimation_mode == "single":
            self.estimator = D2Estimator(cfg, self.ext, device=self.device)
        else:
            # "server" is the reference's ESTIMATION_MODE SERVER
            # (d2basetypes.h:38-44): the same pooled estimator fed only
            # remote frames
            cfg.self_id = self.drone_id
            self._lm_key_pin: Dict[int, int] = {}
            self.estimator = SolveAllEstimator(
                cfg, self.ext, max_drones=sys_cfg.max_drones,
                server_mode=sys_cfg.estimation_mode == "server", lm_id_map=self._lm_key,
                device=self.device)

        self.loopnet: Optional[LoopNet] = None
        self._last_bcast_t = 0.0
        # whole-image attachments of send_img peers, a small ring for
        # debugging and visualization (nothing in the estimation reads it)
        self.remote_images: Dict[Tuple[int, int, int], np.ndarray] = {}
        self._remote_img_order: List[Tuple[int, int, int]] = []
        if transport is not None:
            router = ChannelRouter(transport)
            self.loopnet = LoopNet(
                router.route({CH_VIOKF_HEADER, CH_VIOKF_LANDMARKS, CH_KF_REQUEST,
                              CH_SWARM_LOOP, CH_VIOKF_IMG}),
                self.drone_id, lazy=sys_cfg.lazy_broadcast, send_img=sys_cfg.send_img)
            self.loopnet.on_keyframe = self._on_remote_keyframe
            self.loopnet.on_loop_edge = self._on_loop_edge_msg
            self.loopnet.on_image = self._on_image
            # lazy-mode pull gate: request the full frame when the header's
            # global descriptor hits our retrieval database (reference
            # onImgDescHeaderRecevied -> getMatchedPrevKeyframe NetVLAD gate)
            self.loopnet.want_full = lambda pkt: (
                self.detector.query_score(pkt.gdesc) > self.detector.effective_netvlad_thres())
        self.dpgo: Optional[TransportDPGO] = None
        if transport is not None and sys_cfg.enable_dpgo:
            self.dpgo = TransportDPGO(
                router.route({CH_PGO_DATA}), self.drone_id,
                DPGOTransportConfig(
                    max_poses=sys_cfg.pgo_max_poses, max_edges=sys_cfg.pgo_max_edges,
                    max_anchors=sys_cfg.pgo_max_poses, rho_T=sys_cfg.dpgo_rho_T,
                    rho_theta=sys_cfg.dpgo_rho_theta, eta_k=sys_cfg.dpgo_eta_k,
                    iters_per_step=sys_cfg.dpgo_iters),
                ref_frame_id=self.ref_frame_id, device=self.device)
        if transport is not None and sys_cfg.estimation_mode == "distributed":
            self.estimator.attach_consensus(
                TransportConsensus(router.route({CH_DISTRIB_VINS}), self.drone_id,
                                   ref_frame_id=self.ref_frame_id),
                expected_peers=sys_cfg.max_drones - 1, timeout_ms=sys_cfg.consensus_timeout_ms)

        # ---- PGO graph bookkeeping (host side) ----
        self._pgo_slot: Dict[Tuple[int, int], int] = {}   # (drone, frame) -> slot
        # per slot: drone_id, frame_id, stamp, ego pose at insertion
        self._pgo_meta: List[Tuple[int, int, float, np.ndarray]] = []
        self._last_kf_of: Dict[int, int] = {}  # drone -> last slot
        self._ego_edges: List[Tuple[int, int, np.ndarray, float]] = []
        self.loop_edges: List[LoopEdge] = []
        self._loop_keys: set = set()          # dedup (a, b) loop pairs
        self._dpgo_ego_synced = 0             # ego edges pushed to the DPGO endpoint
        self._dpgo_loops_added: set = set()   # loop pairs pushed to it
        self._pgo_poses: Optional[np.ndarray] = None  # optimized [N, 7]
        self._pgo_capacity = sys_cfg.pgo_max_poses
        self._pgo_edge_capacity = sys_cfg.pgo_max_edges
        self._kf_since_pgo = 0
        self.pgo_solve_count = 0
        self.loops_kept = 0                   # loops the last solve's PCM kept
        self._frame_id = 0
        # the mutex guards the PGO tables against the async worker
        # (snapshot and write-back); the epoch drops a solve whose input
        # poses were rewritten while it ran (a reference-frame merge or
        # the first alignment of a peer's nodes)
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
        self._aligned_drones: set = set()

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

    def poll_network(self, now: float, timeout_ms: int = 0) -> int:
        """Drain the transport: remote keyframes, loop edges, pull requests
        and images. Returns the number of messages handled."""
        if self.loopnet is None:
            return 0
        return self.loopnet.poll(now, timeout_ms)

    def solve_server(self) -> Dict[int, Odometry]:
        """SERVER mode's solve: jointly optimize every ingested drone's
        window from their packets and return each drone's latest fused
        odometry (reference SERVER solve path, d2estimator.cpp:700-736;
        the reference triggers it from the solver timer). Call it
        periodically after ``poll_network``."""
        if self.sys.estimation_mode != "server":
            raise RuntimeError("solve_server needs estimation_mode='server'")
        self.estimator.solve_remote_only()
        out: Dict[int, Odometry] = {}
        for d in self.estimator.drone_ids():
            od = self.estimator.drone_odometry(d)
            if od is not None:
                out[d] = od
        return out

    def _lm_key(self, d: int, lid: int) -> int:
        """The pooled estimator's key of drone ``d``'s landmark ``lid``.
        A landmark unified with one of ours collapses to our raw id, so
        own and remote observations fuse (reference trackRemote id
        unification); tracks established before a merge keep their key.
        Once decided, a key is pinned: testing the live database again
        would flip once the landmark is marginalized out and split its
        observations over two tracks."""
        orig = lid if d == self.drone_id else global_frame_id(d, lid)
        pinned = self._lm_key_pin.get(orig)
        if pinned is not None:
            return pinned
        od, oid = self.swarm.unified_id(d, lid)
        uni = oid if od == self.drone_id else global_frame_id(od, oid)
        key = orig if uni != orig and orig in self.estimator.lmanager.db else uni
        self._lm_key_pin[orig] = key
        return key

    # ------------------------------------------------------------------
    # keyframe fan-out: loop detection, PGO graph, broadcast
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
                with self.perf.stage("loop_detect", ff.frame_id):
                    edge = self.detector.detect(entry, gdesc)
                self.swarm.add_local_keyframe(entry, gdesc, ff.stamp)
                if edge is not None:
                    self.add_loop_edge(edge)

        if self.loopnet is not None and self.sys.broadcast:
            pkt = self._make_packet(ff, pose, gdesc, entry, desc_of)
            if pkt is not None:
                # lazy-mode escalation: drones the pose graph says are near
                # get the full frame (reference getNearbyDronesbyPGOData,
                # d2vins_node.cpp:177-199)
                nearby = self.nearby_drones(ff.stamp) if self.sys.lazy_broadcast else None
                imgs = list(imgs) if self.sys.send_img and imgs is not None else None
                self.loopnet.broadcast_keyframe(pkt, nearby_drones=nearby, images=imgs)

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
        current landmark estimates: one record per observation, each with
        the camera index of its view, so a landmark that two views see
        enters twice with the same descriptor. The loop detector matches
        view against view (``LoopDetector._match_views``), so the ratio
        test never meets a landmark's own copy. ``desc_of``: the
        keyframe's descriptors by landmark id, taken when the frame was
        tracked (default: ``_entry_descriptors()`` now)."""
        if desc_of is None:
            desc_of = self._entry_descriptors()
        ids, cams, rays = [], [], []
        for o in ff.observations:
            ids.extend(int(i) for i in o.landmark_ids)
            cams.extend([o.cam_id] * len(o.landmark_ids))
            rays.extend(np.asarray(o.rays, np.float64))
        if not ids:
            return None
        zero = np.zeros(self.detector.cfg.desc_dim, np.float32)
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
    # the swarm link: packets, remote keyframes, map merge
    # ------------------------------------------------------------------

    def _make_packet(self, ff: FrontendFrame, pose: np.ndarray, gdesc: np.ndarray,
                     entry: Optional[KeyframeEntry],
                     desc_of: Optional[Dict[int, np.ndarray]] = None
                     ) -> Optional[RemoteKeyframePacket]:
        """The keyframe's wire packet: the records of an entry built from
        every view (``_make_entry``'s), else camera 0's observations (a
        caller's entry, as the oracle-frontend scenarios give)."""
        if entry is None:
            entry = self._make_entry(ff, pose, desc_of)
        if entry is None:
            return None
        est = self.estimator
        n_obs = sum(len(o.landmark_ids) for o in ff.observations)
        if len(entry.lm_ids) == len(entry.kpt_valid) == n_obs:
            lm_ids = np.asarray(entry.lm_ids, np.int64)
            lm_cam = np.asarray(entry.kpt_cam, np.uint8)
            lm_rays = np.asarray(entry.kpt_rays, np.float32)
            vel_of = {(o.cam_id, int(lid)): v for o in ff.observations
                      for lid, v in zip(o.landmark_ids, np.asarray(o.ray_vels, np.float32))}
            vels = np.asarray([vel_of[(int(c), int(i))] for c, i in zip(lm_cam, lm_ids)],
                              np.float32).reshape(-1, 3)
        else:
            obs0 = next((o for o in ff.observations if o.cam_id == 0), None)
            if obs0 is None:
                return None
            lm_ids = np.asarray(obs0.landmark_ids, np.int64)
            lm_cam = np.zeros(len(lm_ids), np.uint8)
            lm_rays = np.asarray(obs0.rays, np.float32)
            vels = np.asarray(obs0.ray_vels, np.float32)
        # the state block (reference VisualImageDescArray imu_buf, Ba/Bg and
        # sld_win_status) that peers' multi-robot estimators ingest
        imu_t, imu_acc, imu_gyr = est.imubuf.samples_between(self._last_bcast_t, ff.stamp + 1e-9)
        self._last_bcast_t = ff.stamp
        sb = est.state.sb[est._last_self_slot()].cpu().numpy().astype(np.float64)
        vel = self.odometry.vel if self.odometry is not None else sb[:3]
        return RemoteKeyframePacket(
            drone_id=self.drone_id, frame_id=ff.frame_id, stamp=ff.stamp, is_keyframe=True,
            pose=pose.astype(np.float32), gdesc=gdesc,
            # landmark positions in our world (reference LandmarkPerFrame
            # pt3d): receivers verify loops by PnP against our geometry
            lm_pos3d=self._lm_positions_of(ff, [int(i) for i in lm_ids]).astype(np.float32),
            lm_ids=lm_ids, lm_cam=lm_cam, lm_rays=lm_rays, lm_vels=vels,
            lm_desc=np.asarray(entry.kpt_desc, np.float32),
            ba=sb[3:6].astype(np.float32), bg=sb[6:9].astype(np.float32),
            vel=np.asarray(vel, np.float32),
            imu_t=imu_t, imu_acc=imu_acc.astype(np.float32), imu_gyr=imu_gyr.astype(np.float32),
            sld_win=np.asarray([f.frame_id for f in est.frames if f.drone_id < 0], np.int64),
            ref_frame_id=self.ref_frame_id,
        )

    def _on_image(self, dec: tuple) -> None:
        did, fid, view, _n, img = dec
        key = (did, fid, view)
        if key not in self.remote_images:
            self._remote_img_order.append(key)
            if len(self._remote_img_order) > 64:
                self.remote_images.pop(self._remote_img_order.pop(0), None)
        self.remote_images[key] = img

    def _on_remote_keyframe(self, pkt: RemoteKeyframePacket) -> None:
        if len(pkt.lm_pos3d) == len(pkt.lm_ids):
            fin = np.isfinite(pkt.lm_pos3d).all(axis=1)
            for lid, p in zip(np.asarray(pkt.lm_ids)[fin],
                              np.asarray(pkt.lm_pos3d, np.float64)[fin]):
                self._remote_lm_pos[(pkt.drone_id, int(lid))] = p
        d = pkt.drone_id
        with self.perf.stage("remote_keyframe"):
            edge = self.swarm.on_remote_keyframe(pkt)
        # map merge toward the lower reference frame (reference
        # addFrameRemote, d2estimator.cpp:274-281: yaw-only, moveAllPoses,
        # adopt the remote reference_frame_id)
        a = self.swarm.alignments.get(d)
        if a is not None and pkt.ref_frame_id < self.ref_frame_id:
            self._merge_reference_frame(pkt.ref_frame_id, np_lie.pose_inverse(a.transform))
        if (self.sys.estimation_mode != "single" and len(pkt.lm_ids)
                and pkt.ref_frame_id == self.ref_frame_id):
            # a packet in our reference frame holds poses in our world
            # already (reference addFrameRemote takes pose_drone as it is
            # when reference_frame_id matches)
            with self.perf.stage("remote_frame"):
                self.estimator.input_remote_frame(pkt)
        # remote keyframes extend the pose graph in the remote drone's ego
        # frame, seeded aligned once an alignment exists (packets in our
        # reference frame need none). A peer that merges its map sends its
        # later poses in the new world: its ego edge across the merge holds
        # the jump, as in the JAX package (ROADMAP Queue 3)
        pose = pkt.pose.astype(np.float64)
        aligned = (pose.copy() if pkt.ref_frame_id == self.ref_frame_id
                   else self.swarm.transform_remote_pose(d, pose))
        self._add_pgo_node(d, pkt.frame_id, pkt.stamp, pose, init_pose=aligned)
        if edge is not None:
            self.add_loop_edge(edge)
        # the first alignment of a drone re-seeds its graph nodes into our
        # world (reference map merge moveAllPoses)
        a = self.swarm.alignments.get(d)
        if a is not None and d not in self._aligned_drones:
            self._aligned_drones.add(d)
            with self._pgo_lock:
                self._pgo_epoch += 1
                for slot, (dd, _, _, ego) in enumerate(self._pgo_meta):
                    if dd == d:
                        self._pgo_poses[slot] = np_lie.pose_compose(a.transform, ego)

    def _merge_reference_frame(self, new_ref: int, T: np.ndarray) -> None:
        """Shift this robot's whole world by the (yaw-only) transform ``T``
        and adopt reference frame ``new_ref`` (reference moveAllPoses on a
        map merge, d2estimator.cpp:274-281). Everything in our old world
        moves: the estimator's window, prior and landmarks, the pose-graph
        nodes and our stored ego poses, our retrieval entries, the
        alignments and the odometry. A solve in flight is dropped."""
        self.estimator.move_all_poses(T)
        self.ref_frame_id = new_ref
        cons = self.estimator._consensus
        if cons is not None:
            cons.ref_frame_id = new_ref
            self.estimator._consensus_tilde.clear()
        with self._pgo_lock:
            self._pgo_epoch += 1
            for slot, (d, fid, stamp, ego) in enumerate(self._pgo_meta):
                self._pgo_poses[slot] = np_lie.pose_compose(T, self._pgo_poses[slot])
                if d == self.drone_id:
                    self._pgo_meta[slot] = (d, fid, stamp, np_lie.pose_compose(T, ego))
        self.detector.entries = [
            e._replace(
                pose=np_lie.pose_compose(T, e.pose),
                lm_positions=np.asarray(
                    [np_lie.pose_apply(T, p) if np.isfinite(p).all() else p
                     for p in e.lm_positions]).reshape(-1, 3),
            ) if e.drone_id == self.drone_id else e
            for e in self.detector.entries
        ]
        for did, al in list(self.swarm.alignments.items()):
            self.swarm.alignments[did] = al._replace(
                transform=np_lie.pose_compose(T, al.transform))
        if self.dpgo is not None:
            for slot in range(len(self.dpgo.keys)):
                self.dpgo.poses[slot] = np_lie.pose_compose(T, self.dpgo.poses[slot])
            self.dpgo.ref_frame_id = new_ref
            self.dpgo.dual_local.clear()
            self.dpgo.dual_remote.clear()
        if self.odometry is not None:
            self.odometry = self.estimator.latest_odometry()

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
                      ego_pose: np.ndarray, init_pose: Optional[np.ndarray] = None) -> None:
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
            self._pgo_poses[slot] = ego_pose if init_pose is None else init_pose
            prev = self._last_kf_of.get(drone_id)
            if prev is not None:
                # ego-motion edge with distance-scaled covariance
                rel = np_lie.pose_compose(np_lie.pose_inverse(self._pgo_meta[prev][3]), ego_pose)
                self._ego_edges.append((prev, slot, rel, float(np.linalg.norm(rel[:3]))))
            self._last_kf_of[drone_id] = slot

    def add_loop_edge(self, edge: LoopEdge, broadcast: bool = True) -> None:
        """Add a loop edge to the pose graph (once per frame pair) and, with
        a transport and ``broadcast_loops``, share it with the swarm
        (reference SWARM_LOOP_CONN, loop_net.cpp:10-22)."""
        key = (edge.drone_id_a, edge.frame_id_a, edge.drone_id_b, edge.frame_id_b)
        if key in self._loop_keys:
            return
        if np.linalg.norm(np.asarray(edge.rel_pose[:3])) > self.sys.loop_distance_threshold:
            return  # implausible loop (reference d2pgo.cpp:46-52)
        self._loop_keys.add(key)
        self.loop_edges.append(edge)
        self.last_loop = edge
        if broadcast and self.loopnet is not None and self.sys.broadcast_loops:
            self.loopnet.broadcast_loop_edge(
                edge.frame_id_a, edge.frame_id_b, edge.drone_id_a, edge.drone_id_b,
                edge.rel_pose, edge.pos_cov, edge.yaw_cov, edge.inliers)

    def _on_loop_edge_msg(self, dec: tuple) -> None:
        fa, fb, da, db, rel, pc, yc, inl = dec
        self.add_loop_edge(LoopEdge(frame_id_a=fa, frame_id_b=fb, drone_id_a=da,
                                    drone_id_b=db, rel_pose=rel, pos_cov=pc, yaw_cov=yc,
                                    inliers=inl), broadcast=False)

    def _loop_slot(self, drone_id: int, frame_id: int) -> Optional[int]:
        return self._pgo_slot.get((drone_id, frame_id))

    def nearby_drones(self, now: float) -> set:
        """Drones within near-field range by the pose graph's positions
        (reference getNearbyDronesbyPGOData, d2estimator.cpp:931-976: the
        PGO -> VIO feedback that gates the lazy broadcast's escalation)."""
        if self.odometry is None or self._pgo_poses is None:
            return set()
        with self._pgo_lock:
            positions = {d: (self._pgo_poses[slot][:3].copy(), self._pgo_meta[slot][2])
                         for d, slot in self._last_kf_of.items() if d != self.drone_id}
        return nearby_drones_from_pgo(
            np.asarray(self.odometry.pose[:3]), positions, now,
            distance=self.sys.nearby_distance, max_age=self.sys.nearby_max_age)

    def solve_pgo(self) -> Optional[np.ndarray]:
        """One PGO update over the accumulated graph. Returns optimized
        poses [n, 7]. Serialized against the background worker by
        ``_pgo_solve_lock``; the input snapshot is taken under
        ``_pgo_lock`` and the write-back is dropped if ``_pgo_epoch``
        moved while the solve ran."""
        with self._pgo_solve_lock, self.pgo_perf.stage("solve", self.pgo_solve_count):
            return self._solve_pgo_impl()

    def _solve_pgo_distributed(self) -> np.ndarray:
        """One ARock DPGO round over the transport (reference solve_multi
        -> ARockPGO, d2pgo.cpp:155-328): the new nodes and edges of our
        graph (PCM-kept loops) go into the endpoint, a round runs
        (receive, anchored local solve, dual update, broadcast) and the
        optimized poses come back into the pose table."""
        dp = self.dpgo
        with self._pgo_lock, self.pgo_perf.stage("snapshot"):
            epoch0 = self._pgo_epoch
            n = len(self._pgo_meta)
            for slot, (d, fid, _, _) in enumerate(self._pgo_meta):
                dp.add_frame(global_frame_id(d, fid), owner=d, pose=self._pgo_poses[slot])
            keys = [global_frame_id(d, fid) for (d, fid, _, _) in self._pgo_meta]
            for (a, b, r, dist) in self._ego_edges[self._dpgo_ego_synced:]:
                cov_p = max(self.sys.ego_cov_min, self.sys.ego_pos_cov_per_m * dist)
                cov_y = max(self.sys.ego_cov_min, self.sys.ego_yaw_cov_per_m * dist)
                dp.add_edge(keys[a], keys[b], r,
                            np.diag([1 / np.sqrt(cov_p)] * 3 + [1 / np.sqrt(cov_y)] * 3))
            self._dpgo_ego_synced = len(self._ego_edges)
            loops = self._usable_loops()
            mask = self._pcm_mask(loops) if len(loops) > 1 else np.ones(len(loops), bool)
            self.loops_kept = int(mask.sum())
            for keep, (sa, sb, e) in zip(mask, loops):
                lk = (e.drone_id_a, e.frame_id_a, e.drone_id_b, e.frame_id_b)
                if not keep or lk in self._dpgo_loops_added:
                    continue
                si = np.diag([1 / np.sqrt(e.pos_cov)] * 3 + [1 / np.sqrt(e.yaw_cov)] * 3)
                if dp.add_edge(keys[sa], keys[sb], e.rel_pose, si):
                    self._dpgo_loops_added.add(lk)
            now = self._pgo_meta[-1][2]
        dp.updated = True   # a timer-driven round (the reference's solver cadence)
        stream = self._pgo_stream
        with self.pgo_perf.stage("optimize"), \
                torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            dp.solve(stamp=now)
        with self._pgo_lock, self.pgo_perf.stage("writeback"):
            if self._pgo_epoch == epoch0:
                for slot in range(n):
                    p = dp.optimized_pose(keys[slot])
                    if p is not None:
                        self._pgo_poses[slot] = p
            out = self._pgo_poses[:n].copy()
            self.pgo_solve_count += 1
            if dp.last_report is not None:
                self.last_pgo_report = PGOReport(*dp.last_report)
        return out

    def _solve_pgo_impl(self) -> Optional[np.ndarray]:
        self._kf_since_pgo = 0
        with self._pgo_lock:
            n = len(self._pgo_meta)
            if n < 3:
                return None
        if self.dpgo is not None:
            return self._solve_pgo_distributed()
        with self._pgo_lock, self.pgo_perf.stage("snapshot"):
            n = len(self._pgo_meta)
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
        with self.pgo_perf.stage("optimize"):
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                if use_pcg:
                    out, rep = solve_pgo_pcg(layout, state, edges, fixed,
                                             max_iters=self.sys.pgo_iters,
                                             cg_iters=self.sys.pgo_cg_iters, device=self.device)
                else:
                    out, rep = solve_pgo(layout, state, edges, fixed,
                                         max_iters=self.sys.pgo_iters, device=self.device)
            if stream is not None:
                stream.synchronize()   # the result is complete before it is read back
        with self.pgo_perf.stage("writeback"):
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
            sa = self._loop_slot(e.drone_id_a, e.frame_id_a)
            sb = self._loop_slot(e.drone_id_b, e.frame_id_b)
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
