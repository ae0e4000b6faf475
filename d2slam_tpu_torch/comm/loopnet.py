"""Keyframe broadcast protocol: greedy vs lazy (compact) modes.

The port's counterpart of ``d2slam_tpu/comm/loopnet.py`` (host code, the
same protocol and bytes). Equivalent of the reference LoopNet
(reference: d2frontend/src/loop_net.cpp:24-87
broadcastVisualImageDescArray; config key ``lazy_broadcast_keyframe``
in README.md). Semantics preserved:

  * **greedy**: every keyframe goes out in full (header + landmark
    records) on the landmarks channel;
  * **lazy/compact**: only the header (ego pose + int8 NetVLAD global
    descriptor) is broadcast. A receiver whose place-recognition gate
    fires requests the full frame (reference: the matched-frame /
    lazy-frame exchange, loop_net.cpp onImgDescHeaderRecevied +
    d2featuretracker getMatchedPrevKeyframe); the owner answers with
    the complete packet addressed to the requester;
  * **nearby override**: drones known (from PGO data) to be within
    communication-relevant range get full frames even in lazy mode
    (reference getNearbyDronesbyPGOData, d2estimator.cpp:931-976 and
    the nearby-drone broadcast logic in d2vins_node.cpp:177-199).

Transport-agnostic: anything with ``send(channel, bytes)`` /
``recv(timeout_ms) -> (channel, sender, bytes) | None`` works (the
native UDP multicast transport, or an in-memory loopback in tests).
"""
from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from d2slam_tpu_torch.comm.codec import (
    RemoteKeyframePacket,
    decode_image_packet,
    decode_keyframe,
    decode_loop_edge,
    encode_image_packet,
    encode_keyframe,
    encode_loop_edge,
)
from d2slam_tpu_torch.comm.transport import (
    CH_SWARM_LOOP,
    CH_VIOKF_HEADER,
    CH_VIOKF_IMG,
    CH_VIOKF_LANDMARKS,
)

CH_KF_REQUEST = 8  # full-frame request (lazy mode pull)

_REQ = struct.Struct("<HHq")  # requester, owner, frame_id


def header_only(pkt: RemoteKeyframePacket) -> RemoteKeyframePacket:
    """Strip landmark records (and the IMU block) for the compact
    header broadcast — pose + global descriptor + window status stay."""
    return pkt._replace(
        lm_ids=np.zeros(0, np.int64),
        lm_cam=np.zeros(0, np.uint8),
        lm_rays=np.zeros((0, 3), np.float32),
        lm_vels=np.zeros((0, 3), np.float32),
        lm_desc=np.zeros((0, pkt.lm_desc.shape[1] if pkt.lm_desc.ndim == 2 else 0),
                         np.float32),
        imu_t=np.zeros(0, np.float64),
        imu_acc=np.zeros((0, 3), np.float32),
        imu_gyr=np.zeros((0, 3), np.float32),
    )


class LoopNet:
    def __init__(
        self,
        transport,
        self_id: int,
        lazy: bool = False,
        keep_frames: int = 256,
        request_timeout: float = 0.5,
        send_img: bool = False,
    ):
        self.transport = transport
        self.self_id = self_id
        self.lazy = lazy
        # reference `send_img` (d2frontend_params.cpp:45): also ship the
        # compressed camera view(s) of every keyframe on the image
        # channel (VIOKF_IMG_ARRAY) for debug/visualization on peers
        self.send_img = send_img
        self.request_timeout = request_timeout
        # full packets kept for serving lazy requests (bounded ring)
        self._sent: Dict[int, RemoteKeyframePacket] = {}
        self._sent_imgs: Dict[int, List[np.ndarray]] = {}
        self._sent_order: List[int] = []
        self._keep = keep_frames
        self._pending: Dict[Tuple[int, int], float] = {}  # (owner, fid) -> t
        self.blacklist: Set[int] = set()
        # stats (reference print_network_status counters)
        self.sent_bytes = 0
        self.recv_bytes = 0
        # callbacks
        self.on_keyframe: Optional[
            Callable[[RemoteKeyframePacket], None]] = None
        # header gate: return True to pull the full frame
        self.want_full: Optional[
            Callable[[RemoteKeyframePacket], bool]] = None
        # loop edges from peers (SWARM_LOOP_CONN): receives the decoded
        # tuple (fid_a, fid_b, drone_a, drone_b, rel[7], pos_cov,
        # yaw_cov, inliers)
        self.on_loop_edge: Optional[Callable[[tuple], None]] = None
        # whole-image attachments (send_img peers): receives
        # (drone_id, frame_id, view, n_views, img[H, W] uint8)
        self.on_image: Optional[Callable[[tuple], None]] = None

    def broadcast_loop_edge(self, frame_id_a: int, frame_id_b: int,
                            drone_id_a: int, drone_id_b: int,
                            rel_pose, pos_cov: float, yaw_cov: float,
                            inliers: int) -> None:
        """Share a detected loop with the swarm (reference
        SWARM_LOOP_CONN channel, loop_net.cpp:10-22 — every robot's PGO
        adds all loops it hears about)."""
        data = encode_loop_edge(frame_id_a, frame_id_b, drone_id_a,
                                drone_id_b, rel_pose, pos_cov, yaw_cov,
                                inliers)
        self.sent_bytes += len(data)
        self.transport.send(CH_SWARM_LOOP, data)

    # ------------------------------------------------------------------

    def broadcast_keyframe(
        self,
        pkt: RemoteKeyframePacket,
        nearby_drones: Optional[Set[int]] = None,
        images: Optional[List[np.ndarray]] = None,
    ) -> None:
        """Send one of our keyframes. Lazy mode sends the header only —
        unless ``nearby_drones`` is non-empty, in which case the full
        frame goes out (the reference sends full features to drones in
        near-field range so their VIO can fuse them immediately).

        With ``send_img`` on and ``images`` given, each view also goes
        out PNG-compressed on the image channel (reference send_img →
        VIOKF_IMG_ARRAY, loop_cam.cpp:72-84 + loop_net.cpp:10-22).
        Images ride only with FULL sends — a lazy header-only broadcast
        attaching whole images would defeat its bandwidth purpose; in
        lazy mode they are served on the pull-request path instead."""
        full = (not self.lazy) or bool(nearby_drones)
        data = encode_keyframe(pkt if full else header_only(pkt))
        self._remember(pkt, images if self.send_img else None)
        self.sent_bytes += len(data)
        self.transport.send(
            CH_VIOKF_LANDMARKS if full else CH_VIOKF_HEADER, data
        )
        if self.send_img and images and full:
            self._send_images(int(pkt.frame_id), images)

    def _send_images(self, frame_id: int, images: List[np.ndarray]) -> None:
        for v, img in enumerate(images):
            buf = encode_image_packet(
                self.self_id, frame_id, v, img, n_views=len(images),
            )
            self.sent_bytes += len(buf)
            self.transport.send(CH_VIOKF_IMG, buf)

    def _remember(self, pkt: RemoteKeyframePacket,
                  images: Optional[List[np.ndarray]] = None) -> None:
        fid = int(pkt.frame_id)
        if fid not in self._sent:
            self._sent_order.append(fid)
            if len(self._sent_order) > self._keep:
                old = self._sent_order.pop(0)
                self._sent.pop(old, None)
                self._sent_imgs.pop(old, None)
        self._sent[fid] = pkt
        if images is not None:
            self._sent_imgs[fid] = images

    def request_frame(self, owner: int, frame_id: int, now: float) -> None:
        key = (owner, int(frame_id))
        t0 = self._pending.get(key)
        if t0 is not None and now - t0 < self.request_timeout:
            return  # outstanding
        self._pending[key] = now
        self.transport.send(
            CH_KF_REQUEST, _REQ.pack(self.self_id, owner, int(frame_id))
        )

    # ------------------------------------------------------------------

    def poll(self, now: float, timeout_ms: int = 0) -> int:
        """Drain the transport once; dispatch callbacks. Returns the
        number of messages handled."""
        n = 0
        while True:
            m = self.transport.recv(timeout_ms if n == 0 else 0)
            if m is None:
                return n
            ch, sender, payload = m
            n += 1
            if sender == self.self_id or sender in self.blacklist:
                continue  # self-message suppression (loop_net.cpp)
            self.recv_bytes += len(payload)
            if ch == CH_VIOKF_HEADER:
                pkt = decode_keyframe(payload)
                if pkt is None:
                    continue
                if self.want_full is not None and self.want_full(pkt):
                    self.request_frame(pkt.drone_id, pkt.frame_id, now)
                elif self.on_keyframe is not None:
                    # header-only frames still carry pose/window status
                    self.on_keyframe(pkt)
            elif ch == CH_VIOKF_LANDMARKS:
                pkt = decode_keyframe(payload)
                if pkt is None:
                    continue
                self._pending.pop((pkt.drone_id, int(pkt.frame_id)), None)
                if self.on_keyframe is not None:
                    self.on_keyframe(pkt)
            elif ch == CH_SWARM_LOOP:
                dec = decode_loop_edge(payload)
                if dec is not None and self.on_loop_edge is not None:
                    self.on_loop_edge(dec)
            elif ch == CH_VIOKF_IMG:
                if self.on_image is not None:
                    dec = decode_image_packet(payload)
                    if dec is not None:
                        self.on_image(dec)
            elif ch == CH_KF_REQUEST and len(payload) >= _REQ.size:
                req, owner, fid = _REQ.unpack_from(payload, 0)
                if owner != self.self_id:
                    continue
                pkt = self._sent.get(int(fid))
                if pkt is not None:
                    data = encode_keyframe(pkt)
                    self.sent_bytes += len(data)
                    self.transport.send(CH_VIOKF_LANDMARKS, data)
                    imgs = self._sent_imgs.get(int(fid))
                    if imgs is not None:
                        self._send_images(int(fid), imgs)


def nearby_drones_from_pgo(
    self_pos: np.ndarray,
    drone_positions: Dict[int, Tuple[np.ndarray, float]],
    now: float,
    distance: float = 5.0,
    max_age: float = 10.0,
) -> Set[int]:
    """Drones currently within near-field range per the latest PGO-fused
    positions (reference getNearbyDronesbyPGOData,
    d2estimator.cpp:931-976: distance gate on pgo_data poses, stale
    entries ignored)."""
    out: Set[int] = set()
    for did, (pos, stamp) in drone_positions.items():
        if now - stamp > max_age:
            continue
        if np.linalg.norm(np.asarray(pos) - np.asarray(self_pos)) <= distance:
            out.add(did)
    return out
