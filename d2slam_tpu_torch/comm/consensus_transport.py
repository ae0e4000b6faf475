"""Distributed consensus over the real network transport, matched by
frame id.

The port's copy of ``d2slam_tpu/comm/consensus_transport.py`` (host
numpy; the same wire bytes). Attaching it to the estimator
(``estimation_mode="distributed"``) waits for the multi-robot slice.

The reference's D2VINSNet path (reference: d2vins/src/network/
d2vins_net.cpp — channels DISTRIB_VINS_DATA + SYNC_SIGNAL with a
token/iteration-matched `waitForSync`, timeout 50-100 ms,
VINSConsenusSolver.cpp:93-120) exchanges ``DistributedVinsData``:
**frame ids + poses** (and camera ids + extrinsics). Each robot matches
incoming poses to its own window BY FRAME ID
(``updateWithDistributedVinsData`` only applies entries where
``state->hasFrame(frame_id)``, VINSConsenusSolver.cpp:60-92), averages
every shared pose across the copies it received
(ConsensusSolver.cpp:166-228 updateGlobal), and runs the dual update
``tilde += (1+alpha)·logm(global⁻¹·local)`` (updateTilde :108-164).
Robots whose windows have drifted apart (different keyframe decisions,
different window membership) therefore average exactly the frames they
genuinely share — never positionally by window slot.

Frame keys on the wire are 64-bit ``(drone_id, frame_id)`` folds
(``vins.types.global_frame_id``), so two robots agree on
a frame's identity regardless of where it sits in their windows.

Use this when robots are separate processes on a real network.
"""
from __future__ import annotations

import struct
import time
from typing import Dict, Tuple

import numpy as np

from d2slam_tpu_torch.comm.transport import CH_DISTRIB_VINS
from d2slam_tpu_torch.utils import np_lie

_HDR = struct.Struct("<BHIiHH")  # ver, robot_id, token, ref_frame, n, c
_WIRE_VERSION = 3


def encode_pose_msg(
    robot_id: int,
    token: int,
    keys: np.ndarray,
    poses: np.ndarray,
    cam_ids: np.ndarray = (),
    cam_poses: np.ndarray = (),
    ref_frame_id: int = 0,
) -> bytes:
    """DistributedVinsData equivalent: frame keys + poses (+ extrinsics
    + reference frame id) (reference VINSConsenusSolver.cpp:27-44
    broadcastData packs frame_ids/frame_poses and cam_ids/extrinsic;
    d2estimator.cpp:453 stamps reference_frame_id)."""
    n, c = len(keys), len(cam_ids)
    return b"".join([
        _HDR.pack(_WIRE_VERSION, robot_id, token, ref_frame_id, n, c),
        np.asarray(keys, np.int64).tobytes(),
        np.asarray(poses, np.float32).tobytes(),
        np.asarray(cam_ids, np.int32).tobytes(),
        np.asarray(cam_poses, np.float32).tobytes(),
    ])


def decode_pose_msg(buf: bytes):
    ver, rid, token, ref, n, c = _HDR.unpack_from(buf, 0)
    if ver != _WIRE_VERSION:
        return None
    off = _HDR.size
    keys = np.frombuffer(buf, np.int64, n, off).copy(); off += 8 * n
    poses = np.frombuffer(buf, np.float32, n * 7, off).reshape(n, 7).copy()
    off += 28 * n
    cam_ids = np.frombuffer(buf, np.int32, c, off).copy(); off += 4 * c
    cam_poses = np.frombuffer(buf, np.float32, c * 7, off).reshape(c, 7).copy()
    return rid, token, keys, poses, cam_ids, cam_poses, ref


def average_keyed_poses(
    keys: np.ndarray,
    poses: np.ndarray,
    peer_copies: Dict[int, Tuple[np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Average each of OUR poses with every peer copy that carries the
    same key (reference updateGlobal, ConsensusSolver.cpp:166-228 —
    SE(3) mean: Euclidean position mean + Markley quaternion average).

    Returns (global_poses [n, 7], n_copies [n] — 1 means nobody else
    estimates that frame, so global == local and the dual stays zero).

    Pure host numpy: the stacks are tiny (window x peers), so the
    Markley average runs as ONE batched 4x4 eigendecomposition instead
    of a jitted device call per frame per ADMM sub-step.
    """
    n = len(keys)
    out = np.array(poses, np.float64, copy=True)
    counts = np.ones(n, np.int64)
    by_key: Dict[int, list] = {}
    for (pkeys, pposes) in peer_copies.values():
        for k, p in zip(pkeys, pposes):
            by_key.setdefault(int(k), []).append(p)
    # accumulate per-frame position sums and Markley matrices M = sum q q^T
    # (sign-invariant, so no hemisphere fixup needed)
    M = np.zeros((n, 4, 4))
    pos_sum = poses[:, :3].astype(np.float64).copy()
    q0 = poses[:, 3:].astype(np.float64)
    q0 = q0 / np.maximum(np.linalg.norm(q0, axis=1, keepdims=True), 1e-12)
    M += np.einsum("ni,nj->nij", q0, q0)
    touched = np.zeros(n, bool)
    for i in range(n):
        others = by_key.get(int(keys[i]))
        if not others:
            continue
        stack = np.asarray(others, np.float64)
        counts[i] = 1 + len(stack)
        pos_sum[i] += stack[:, :3].sum(axis=0)
        qs = stack[:, 3:]
        qs = qs / np.maximum(
            np.linalg.norm(qs, axis=1, keepdims=True), 1e-12
        )
        M[i] += np.einsum("ki,kj->ij", qs, qs)
        touched[i] = True
    if touched.any():
        sel = np.flatnonzero(touched)
        _, vecs = np.linalg.eigh(M[sel])   # batched; top eigvec = last col
        q_avg = vecs[:, :, -1]
        # keep the average on the local hemisphere for stable duals
        sign = np.where(np.sum(q_avg * q0[sel], axis=1) < 0, -1.0, 1.0)
        out[sel, :3] = pos_sum[sel] / counts[sel, None]
        out[sel, 3:] = q_avg * sign[:, None]
    return out, counts


def dual_update_np(local: np.ndarray, global_pose: np.ndarray,
                   tilde: np.ndarray, eta: float = 1.0) -> np.ndarray:
    """tilde += eta·logm(global⁻¹·local) in the repo's tangent
    convention (matches factors.residuals.consensus_pose_residual and
    parallel/consensus.py::dual_update; reference updateTilde
    ConsensusSolver.cpp:108-164 with eta = 1 + relaxation_alpha)."""
    gp, lp = global_pose, local
    q_ref = gp[3:] / np.linalg.norm(gp[3:])
    dt_ref = np_lie.quat_rotate(np_lie.quat_conj(q_ref), lp[:3] - gp[:3])
    q_err = np_lie.quat_mul(np_lie.quat_conj(q_ref),
                            lp[3:] / np.linalg.norm(lp[3:]))
    if q_err[3] < 0:  # hemisphere correction
        q_err = -q_err
    return tilde + eta * np.concatenate([dt_ref, 2.0 * q_err[:3]])


class TransportConsensus:
    """One robot's endpoint for transport-based consensus ADMM.

    Duals (tilde) are keyed by frame id, not window slot, so they
    survive window shifts and divergent keyframe decisions."""

    def __init__(self, transport, self_id: int, ref_frame_id: int = 0):
        self.t = transport
        self.self_id = self_id
        # poses from a different reference frame are ignored until the
        # maps merge (reference d2estimator.cpp:433)
        self.ref_frame_id = ref_frame_id
        self._stash: Dict[Tuple[int, int], tuple] = {}

    def send_poses(self, token: int, keys: np.ndarray, poses: np.ndarray,
                   cam_ids=(), cam_poses=()) -> None:
        """Broadcast this robot's estimates for an iteration token
        (reference broadcastData, VINSConsenusSolver.cpp:11-44)."""
        self.t.send(
            CH_DISTRIB_VINS,
            encode_pose_msg(self.self_id, token, keys, poses,
                            cam_ids, cam_poses, self.ref_frame_id),
        )

    def collect(self, token: int, expected_peers: int,
                timeout_ms: int = 100) -> Dict[int, tuple]:
        """Gather peers' copies for this token (reference waitForSync).

        Returns {robot_id: (keys, poses, cam_ids, cam_poses)}; peers
        that miss the timeout are simply absent (the reference's
        lossy-link tolerance)."""
        got: Dict[int, tuple] = {}
        for (rid, tok) in list(self._stash.keys()):
            if tok == token:
                got[rid] = self._stash.pop((rid, tok))
        deadline = time.monotonic() + timeout_ms / 1000.0
        while len(got) < expected_peers and time.monotonic() < deadline:
            msg = self.t.recv(timeout_ms=20)
            if msg is None:
                continue
            ch, sender, payload = msg
            if ch != CH_DISTRIB_VINS:
                continue
            dec = decode_pose_msg(payload)
            if dec is None:
                continue
            rid, tok, keys, poses, cam_ids, cam_poses, ref = dec
            if ref != self.ref_frame_id:
                continue  # different world frame — not yet merged
            if tok == token:
                got[rid] = (keys, poses, cam_ids, cam_poses)
            elif tok > token:  # arrived early; keep for the next step
                self._stash[(rid, tok)] = (keys, poses, cam_ids, cam_poses)
        return got

    def consensus_step(
        self,
        token: int,
        keys: np.ndarray,
        poses: np.ndarray,
        tilde: Dict[int, np.ndarray],
        expected_peers: int,
        timeout_ms: int = 100,
        eta: float = 1.0,
        send: bool = True,
    ):
        """Full reference-style sub-step: broadcast -> collect ->
        keyed average -> dual update. Set ``send=False`` when
        :meth:`send_poses` was already called (phase-split
        single-process simulation).

        Returns (global_poses [n, 7], tilde [n, 6] aligned to ``keys``,
        n_peers, n_copies [n]). ``tilde`` (the dict) is updated in
        place and pruned to the current keys — pass it back on the next
        call."""
        keys = np.asarray(keys, np.int64)
        poses = np.asarray(poses, np.float64)
        if send:
            self.send_poses(token, keys, poses)
        got = self.collect(token, expected_peers, timeout_ms)
        peer_copies = {rid: (k, p) for rid, (k, p, _, _) in got.items()}
        global_poses, counts = average_keyed_poses(keys, poses, peer_copies)

        live = set(int(k) for k in keys)
        for k in [k for k in tilde if k not in live]:
            del tilde[k]
        tilde_arr = np.zeros((len(keys), 6))
        for i, k in enumerate(keys):
            k = int(k)
            t0 = tilde.get(k, np.zeros(6))
            # frames only we estimate have global == local -> zero step
            # (matches the reference: their average is their own copy)
            t1 = dual_update_np(poses[i], global_poses[i], t0, eta)
            tilde[k] = t1
            tilde_arr[i] = t1
        return global_poses, tilde_arr, len(got), counts
