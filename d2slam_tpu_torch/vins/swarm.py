"""Swarm coordination: remote keyframe ingestion, landmark-id unification,
inter-drone loop edges and map alignment.

Counterpart of ``d2slam_tpu/vins/swarm.py`` (reference:
d2frontend/src/d2featuretracker.cpp:166-387 getMatchedPrevKeyframe ->
NetVLAD gate, trackRemote -> descriptor match and landmark-id
unification with ownership by discovery time;
d2vins/src/estimator/d2estimator.cpp:224-293 addFrameRemote -> yaw-only
map merge). Frames arrive as decoded wire packets (``comm.codec``); the
class is transport-agnostic. Host bookkeeping; the descriptor match of
the unification runs on the loop detector's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from d2slam_tpu_torch.comm.codec import RemoteKeyframePacket
from d2slam_tpu_torch.frontend.loop_detector import KeyframeEntry, LoopDetector, LoopEdge
from d2slam_tpu_torch.frontend.matching import match_descriptors
from d2slam_tpu_torch.utils import np_lie


@dataclasses.dataclass
class SwarmConfig:
    netvlad_thres: float = 0.8      # track_remote_netvlad_thres
    min_unify_matches: int = 12
    yaw_only_alignment: bool = True  # reference map merge is 4-DoF


class MapAlignment(NamedTuple):
    """world_self_T_world_other, yaw-only rotation."""
    drone_id: int
    transform: np.ndarray  # [7]
    n_edges: int


class SwarmManager:
    def __init__(self, self_id: int, loop_detector: LoopDetector,
                 cfg: SwarmConfig = SwarmConfig()):
        self.self_id = self_id
        self.cfg = cfg
        self.detector = loop_detector
        # unified landmark ids: (drone, remote_id) -> (owner_drone, id)
        self.lm_unify: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.lm_discovery: Dict[Tuple[int, int], float] = {}
        self.alignments: Dict[int, MapAlignment] = {}
        self.loop_edges: List[LoopEdge] = []
        self.remote_trajs: Dict[int, List[Tuple[int, float, np.ndarray]]] = {}

    def add_local_keyframe(self, entry: KeyframeEntry, gdesc: np.ndarray,
                           stamp: float) -> None:
        """Register one of our keyframes in the retrieval database."""
        self.detector.add_keyframe(entry, gdesc)

    def on_remote_keyframe(self, pkt: RemoteKeyframePacket) -> Optional[LoopEdge]:
        """One remote keyframe: NetVLAD gate -> match -> PnP -> loop edge,
        map-alignment update and landmark unification; then the frame
        joins the retrieval database."""
        self.remote_trajs.setdefault(pkt.drone_id, []).append(
            (pkt.frame_id, pkt.stamp, pkt.pose.copy()))
        # v4 packets carry landmark positions in the sender's world (the
        # reference's LandmarkPerFrame pt3d): PnP against the remote
        # geometry works in both loop directions
        lm_pos = (pkt.lm_pos3d.astype(np.float64) if len(pkt.lm_pos3d) == len(pkt.lm_ids)
                  else np.full((len(pkt.lm_ids), 3), np.nan))
        entry = KeyframeEntry(
            frame_id=pkt.frame_id, drone_id=pkt.drone_id, stamp=pkt.stamp,
            pose=pkt.pose.astype(np.float64), kpt_rays=pkt.lm_rays.astype(np.float64),
            kpt_cam=pkt.lm_cam.astype(np.int32), kpt_desc=pkt.lm_desc,
            kpt_valid=np.ones(len(pkt.lm_ids), bool), lm_positions=lm_pos,
            lm_ids=np.asarray(pkt.lm_ids, np.int64),
        )
        edge = self.detector.detect(entry, pkt.gdesc)
        if edge is not None:
            self.loop_edges.append(edge)
            self._update_alignment(edge)
            self._unify_landmarks(pkt, edge)
        self.detector.add_keyframe(entry, pkt.gdesc)
        return edge

    def _update_alignment(self, edge: LoopEdge) -> None:
        """An inter-drone loop from one of our frames (a) to a remote one
        (b) sets world_self_T_world_other (reference addFrameRemote map
        merge); the latest loop wins."""
        if edge.drone_id_b == self.self_id or edge.drone_id_a != self.self_id:
            return
        other = edge.drone_id_b
        old = next((e for e in self.detector.entries
                    if e.frame_id == edge.frame_id_a and e.drone_id == self.self_id), None)
        if old is None:
            return
        new_pose_ego = next((p for (fid, _, p) in self.remote_trajs.get(other, [])
                             if fid == edge.frame_id_b), None)
        if new_pose_ego is None:
            return
        T_wself_new = np_lie.pose_compose(old.pose, edge.rel_pose)
        T = np_lie.pose_compose(T_wself_new, np_lie.pose_inverse(new_pose_ego.astype(np.float64)))
        if self.cfg.yaw_only_alignment:
            # both worlds are gravity aligned: keep the yaw of the rotation
            q = T[3:]
            yaw = np.arctan2(2.0 * (q[3] * q[2] + q[0] * q[1]),
                             1.0 - 2.0 * (q[1] * q[1] + q[2] * q[2]))
            T = np.concatenate([T[:3], [0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)]])
        prev = self.alignments.get(other)
        self.alignments[other] = MapAlignment(other, T, (prev.n_edges if prev else 0) + 1)

    def _unify_landmarks(self, pkt: RemoteKeyframePacket, edge: LoopEdge) -> None:
        """Unify matched landmark ids; the earlier discovery owns the id
        (reference trackRemote solver_id by stamp_discover,
        d2featuretracker.cpp:312-387)."""
        old = next((e for e in self.detector.entries if e.frame_id == edge.frame_id_a), None)
        if old is None or len(old.lm_ids) != len(old.kpt_valid):
            return  # the matched entry carries no landmark ids
        dev = self.detector.device
        idx, ok = match_descriptors(
            torch.as_tensor(np.asarray(pkt.lm_desc, np.float32), device=dev),
            torch.as_tensor(np.asarray(old.kpt_desc, np.float32), device=dev),
            torch.ones(len(pkt.lm_ids), dtype=torch.bool, device=dev),
            torch.as_tensor(np.asarray(old.kpt_valid, bool), device=dev))
        idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
        for n_uni, i in enumerate(np.flatnonzero(ok)):
            if n_uni >= self.cfg.min_unify_matches * 4:
                break
            remote_key = (pkt.drone_id, int(pkt.lm_ids[i]))
            local_key = (old.drone_id, int(old.lm_ids[idx[i]]))
            ta = self.lm_discovery.get(remote_key, pkt.stamp)
            tb = self.lm_discovery.get(local_key, old.stamp)
            owner = local_key if tb <= ta else remote_key
            self.lm_unify[remote_key] = owner
            self.lm_unify[local_key] = owner

    def unified_id(self, drone_id: int, lm_id: int) -> Tuple[int, int]:
        return self.lm_unify.get((drone_id, lm_id), (drone_id, lm_id))

    def transform_remote_pose(self, drone_id: int, pose: np.ndarray) -> Optional[np.ndarray]:
        """A remote ego pose in our world frame (None before an alignment)."""
        a = self.alignments.get(drone_id)
        if a is None:
            return None
        return np_lie.pose_compose(a.transform, pose.astype(np.float64))
