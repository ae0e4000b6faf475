"""Transport-based distributed pose-graph optimization: the
multi-process DPGO path (the reference's d2comm relay).

Counterpart of ``d2slam_tpu/pgo/dpgo_transport.py``. The reference
exchanges ``DPGOData`` (per-frame poses and dual poses) between robot
processes: ``ARockPGO::broadcastData`` (d2pgo/src/ARockPGO.cpp:72-104)
publishes one message per neighbour on the ``PGO_Sync_Data`` channel
(d2comm/src/d2comm.cpp:3-47), and ``processPGOData`` (:13-60) matches the
incoming duals to frames BY FRAME ID. Here the host runs the ARock
protocol (duals, skip-if-stale, eta_k relaxation, the ROT_INIT_FINISH
barrier) over the port's transports; each local solve is an anchored LM
pose-graph solve on the endpoint's device (float64 by default) whose
consensus rows pull remote-owned poses toward the neighbours' duals
(ARock.cpp:256-314 setDualStateFactors: ConsenusPoseFactor with zero
tilde).

ARock semantics (ARock.cpp:140-190 solve_arock):
  * receive -> if nothing new, skip the step (up to ``max_wait_steps``);
  * local solve with dual-anchor factors;
  * dual update with eta_k relaxation (ARock.cpp:24-84):
      avg        = pose_average(dual_local, dual_remote)
      err        = log(cur_est^-1 o avg)
      dual_local <- dual_local o exp(-eta_k * err)
  * broadcast one DPGOData per neighbour (our duals of its frames).

``pgo.distributed`` is the same algorithm with the robots as one batch on
one device; this module is for robots that are separate processes on a
network. The wire bytes are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import struct
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import torch

from d2slam_tpu_torch.comm.transport import CH_PGO_DATA
from d2slam_tpu_torch.pgo.pcg import anchor_cost, anchor_linearize, solve_pgo_pcg_anchored
from d2slam_tpu_torch.pgo.pose_graph import (
    PGOEdges,
    PGOLayout,
    PGOState,
    _normal_equations,
    boxplus_of,
    edge_cost,
    edge_linearize,
    to_device,
)
from d2slam_tpu_torch.pgo.rot_init import chordal_rotation_init, linear_translation_init
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import load_cuda_linalg, resolve_device, torch_dtype

# DPGODataType (reference d2pgo_types.h:8-13)
DPGO_POSE_DUAL = 0
DPGO_ROT_MAT_DUAL = 1
DPGO_DELTA_POSE_DUAL = 2
# out-of-band signal message (reference sendSignal -> swarm_msgs
# DPGOSignal topic -> inputDPGOsignal, d2pgo.cpp:124-129); the signal
# code rides in the ``iteration`` header field, payload is empty
DPGO_SIGNAL = 3
SIGNAL_ROT_INIT_FINISH = 1

_HDR = struct.Struct("<BHhiBdiH")  # ver, drone, target, ref_frame, type,
#                                    stamp, iteration, n_frames
_WIRE_VERSION = 1


class DPGOData(NamedTuple):
    """Wire payload of one ARock exchange (reference DPGOData,
    d2pgo_types.h:15-31: drone_id, target_id, reference_frame_id, type,
    frame_poses, frame_duals)."""

    drone_id: int
    target_id: int          # the neighbor these duals talk about (-1 = all)
    ref_frame_id: int
    msg_type: int
    stamp: float
    iteration: int
    keys: np.ndarray        # [n] int64 global frame ids
    poses: np.ndarray       # [n, 7] sender's current estimates
    duals: np.ndarray       # [n, 7] sender's local dual poses


def encode_dpgo(d: DPGOData) -> bytes:
    n = len(d.keys)
    return b"".join([
        _HDR.pack(_WIRE_VERSION, d.drone_id, d.target_id, d.ref_frame_id,
                  d.msg_type, d.stamp, d.iteration, n),
        np.asarray(d.keys, np.int64).tobytes(),
        np.asarray(d.poses, np.float32).tobytes(),
        np.asarray(d.duals, np.float32).tobytes(),
    ])


def decode_dpgo(buf: bytes) -> Optional[DPGOData]:
    if len(buf) < _HDR.size:
        return None
    ver, drone, target, ref, typ, stamp, it, n = _HDR.unpack_from(buf, 0)
    if ver != _WIRE_VERSION:
        return None
    off = _HDR.size
    keys = np.frombuffer(buf, np.int64, n, off).copy(); off += 8 * n
    poses = np.frombuffer(buf, np.float32, n * 7, off).reshape(n, 7).copy()
    off += 28 * n
    duals = np.frombuffer(buf, np.float32, n * 7, off).reshape(n, 7).copy()
    return DPGOData(drone, target, ref, typ, stamp, it, keys, poses, duals)


# ---------------------------------------------------------------------------
# the local solve with dual anchors
# ---------------------------------------------------------------------------


def solve_pgo_anchored(
    layout: PGOLayout,
    state: PGOState,
    edges: PGOEdges,
    fixed_mask,
    anchor_idx,      # [K] pose slots
    anchor_pose,     # [K, 7] dual poses to anchor at
    anchor_active,   # [K] bool
    *,
    rho_T: float = 0.1,
    rho_theta: float = 2.0,
    max_iters: int = 6,
    huber_delta: float = 1.0,
    device=None,
):
    """``pose_graph.solve_pgo`` plus consensus anchor rows: every active
    anchor pulls pose[idx] toward its dual pose (reference
    setDualStateFactors, ARock.cpp:256-314: ConsenusPoseFactor with zero
    tilde for 6-DoF layouts, ConsenusPoseFactor4D for the x / y / z / yaw
    mode the reference defaults to, d2pgo_node.cpp:182-187). The anchors
    are unary blocks of the dense normal equations. Returns (new_state,
    (initial_cost, final_cost, accepted))."""
    state, edges, fixed = to_device(state, edges, fixed_mask, device)
    dev, dtype = state.poses.device, state.poses.dtype
    dof, N = layout.pose_dof, layout.N
    if dof not in (4, 6):
        raise ValueError(f"pose_dof must be 4 or 6, got {dof}")
    ai = torch.as_tensor(anchor_idx, dtype=torch.long, device=dev)
    ap = torch.as_tensor(anchor_pose, dtype=dtype, device=dev)
    aa = torch.as_tensor(anchor_active, dtype=torch.bool, device=dev)
    boxplus = boxplus_of(dof)
    free = state.valid & ~fixed
    col_free = free.to(dtype).repeat_interleave(dof)
    fixed_diag = torch.diag(1.0 - col_free) + 1e-9 * torch.eye(N * dof, dtype=dtype, device=dev)

    def anchors(poses):
        return anchor_linearize(poses, state.valid, ai, ap, aa, dof, rho_T, rho_theta)

    def total_cost(poses):
        return (edge_cost(state._replace(poses=poses), edges, dof, huber_delta)
                + anchor_cost(poses, state.valid, ai, ap, aa, dof, rho_T, rho_theta))

    cost = total_cost(state.poses)
    cost0 = cost
    lam = torch.full((), 1e-6, dtype=dtype, device=dev)
    accepted = torch.zeros((), dtype=torch.long, device=dev)
    poses = state.poses
    for _ in range(max_iters):
        s = state._replace(poses=poses)
        r, Ja, Jb, _ = edge_linearize(s, edges, dof, huber_delta, free)
        ra, Jan = anchors(poses)
        H, g = _normal_equations(r, Ja, Jb, edges, N,
                                 unary=(ai, ra, Jan * free[ai].to(dtype)[:, None, None]))
        H = H + lam * torch.diag(torch.diagonal(H)) + fixed_diag
        L, info = torch.linalg.cholesky_ex(H)
        dx = -torch.cholesky_solve(g[:, None], L)[:, 0] * col_free
        cand = boxplus(poses, dx.reshape(N, dof))
        cand_cost = total_cost(cand)
        accept = (cand_cost < cost) & (info == 0)
        poses = torch.where(accept, cand, poses)
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.where(accept, lam * 0.25, lam * 10.0)
        accepted = accepted + accept.long()
    return state._replace(poses=poses), (cost0, cost, accepted)


# ---------------------------------------------------------------------------
# the ARock endpoint
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DPGOTransportConfig:
    max_poses: int = 256
    max_edges: int = 1024
    max_anchors: int = 256
    # 6 = full SE(3); 4 = x/y/z/yaw with roll/pitch pinned to the VIO
    # gravity estimate — the reference's default for real swarms
    # (d2pgo_node.cpp:182-187, is_4dof=true)
    pose_dof: int = 6
    # reference defaults: pgo_rho_frame_T 0.01-0.1, pgo_rho_frame_theta
    # 2.0 (config/tum/tum_multi.yaml:141-142), eta_k 0.9
    rho_T: float = 0.1
    rho_theta: float = 2.0
    eta_k: float = 0.9
    max_steps: int = 1           # ARock sub-steps per solve() call
    max_wait_steps: int = 5      # skip-if-stale budget (ARock.cpp:146-162)
    iters_per_step: int = 6      # inner LM iterations
    huber_delta: float = 1.0
    # local-solve precision: in float32 the per-round cost improvement
    # from slow ARock dual drift falls below the cost scalar's
    # resolution, the LM accept gate rejects every step and the primal
    # freezes while the duals drift, so float64 is the default (the
    # reference's d2pgo_node solves in double with Ceres)
    solve_dtype: str = "float64"
    # chordal rotation initialization before the first ARock round
    # (reference solve_multi: RotInit -> waitForRotInitFinish -> ARock)
    rot_init: bool = True
    # ROT_INIT_FINISH barrier: after local rot-init, skip ARock rounds
    # until every robot in available_robots has signalled (reference
    # waitForRotInitFinish, d2pgo.cpp:130-153) or this many rounds have
    # been skipped (reference rot_init_timeout)
    rot_init_timeout_rounds: int = 20
    # per-frame attitude priors in the rot-init (reference
    # rotation_initialization_base.hpp:131-144; 0 disables)
    gravity_weight: float = 0.0
    # long-mission capacity: the graph GROWS (doubling) instead of
    # silently refusing frames at max_poses —
    # the reference's Ceres graph is unbounded (d2pgo.cpp:15-44
    # addFrame). hard_max_* is the absolute memory ceiling.
    hard_max_poses: int = 32768
    hard_max_edges: int = 131072
    # past this many pose slots the anchored local solve routes to the
    # matrix-free PCG path (pgo/pcg.py::solve_pgo_pcg_anchored) — the
    # dense path's normal matrix is O(N^2) memory
    pcg_threshold: int = 2048
    cg_iters: int = 60


class TransportDPGO:
    """One robot's ARock DPGO endpoint over a real transport.

    Host-side graph bookkeeping (poses, edges, duals keyed by 64-bit
    frame ids); the local solves run on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``). Frames AND edges of ALL drones the robot has heard about
    live in its local problem — the reference builds each robot's PGO
    the same way (setupEgoMotionFactors iterates every drone's
    trajectory and every robot adds all loops it received,
    d2pgo.cpp:413-528); the edge replication is uniform across robots,
    so the implicit consensus objective is a constant multiple of the
    centralized one, and the ARock duals reconcile the copies.
    """

    def __init__(self, transport, self_id: int,
                 cfg: DPGOTransportConfig = DPGOTransportConfig(),
                 ref_frame_id: int = 0, device=None):
        # capacity growth (_grow_poses / add_edge) mutates cfg.max_*;
        # copy per instance so robots sharing one cfg object don't
        # inherit each other's grown capacities without reallocating
        cfg = dataclasses.replace(cfg)
        self.t = transport
        self.device = resolve_device(device)
        load_cuda_linalg(self.device)
        self.dtype = torch_dtype(cfg.solve_dtype)
        self.self_id = self_id
        self.cfg = cfg
        self.ref_frame_id = ref_frame_id
        # graph (host)
        self.keys: List[int] = []
        self.slot_of: Dict[int, int] = {}
        self.owner: Dict[int, int] = {}
        self.poses = np.zeros((cfg.max_poses, 7))
        self.poses[:, 6] = 1.0
        # body-frame gravity direction at insertion (third row of the
        # ego attitude) for the rot-init gravity priors
        self.grav_body = np.tile([0.0, 0.0, 1.0], (cfg.max_poses, 1))
        self._rot_inited = False
        self.edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        # ARock dual state, keyed (peer_drone, frame_key)
        self.dual_local: Dict[Tuple[int, int], np.ndarray] = {}
        self.dual_remote: Dict[Tuple[int, int], np.ndarray] = {}
        self.updated = True           # reference ARockBase::updated
        self.iteration = 0
        self.last_report = None
        # ROT_INIT_FINISH barrier state (reference d2pgo.h:36,58 —
        # available_robots defaults to {self}; a multi-robot launch
        # widens it via setAvailableRobots)
        self.available_robots = {int(self_id)}
        self.rot_init_finished_robots: set = set()
        self._rot_barrier_waited = 0
        self._rot_barrier_passed = False

    # ---------------- graph building ----------------

    def _grow_poses(self) -> bool:
        """Double the pose capacity (up to hard_max_poses), reallocating
        the fixed-shape arrays."""
        cfg = self.cfg
        new_cap = min(cfg.max_poses * 2, cfg.hard_max_poses)
        if new_cap <= cfg.max_poses:
            return False
        poses = np.zeros((new_cap, 7))
        poses[:, 6] = 1.0
        poses[: cfg.max_poses] = self.poses
        grav = np.tile([0.0, 0.0, 1.0], (new_cap, 1))
        grav[: cfg.max_poses] = self.grav_body
        self.poses, self.grav_body = poses, grav
        cfg.max_poses = new_cap
        cfg.max_anchors = max(cfg.max_anchors, new_cap)
        return True

    def add_frame(self, key: int, owner: int, pose: np.ndarray) -> bool:
        if key in self.slot_of:
            return True
        if len(self.keys) >= self.cfg.max_poses and not self._grow_poses():
            warnings.warn(
                f"TransportDPGO at hard_max_poses="
                f"{self.cfg.hard_max_poses}; dropping frame {key}"
            )
            return False
        slot = len(self.keys)
        self.keys.append(int(key))
        self.slot_of[int(key)] = slot
        self.owner[int(key)] = int(owner)
        self.poses[slot] = np.asarray(pose, np.float64)
        self.grav_body[slot] = np_lie.quat_to_rotmat(
            np.asarray(pose[3:], np.float64)
        )[2]
        self.updated = True
        return True

    def set_initial_pose(self, key: int, pose: np.ndarray) -> None:
        slot = self.slot_of.get(int(key))
        if slot is not None:
            self.poses[slot] = np.asarray(pose, np.float64)

    def add_edge(self, key_a: int, key_b: int, rel: np.ndarray,
                 sqrt_info: np.ndarray) -> bool:
        """Relative-pose edge (ego or loop) OWNED by this robot."""
        if len(self.edges) >= self.cfg.max_edges:
            new_cap = min(self.cfg.max_edges * 2, self.cfg.hard_max_edges)
            if new_cap <= self.cfg.max_edges:
                return False
            self.cfg.max_edges = new_cap
        if int(key_a) not in self.slot_of or int(key_b) not in self.slot_of:
            return False
        self.edges.append((int(key_a), int(key_b),
                           np.asarray(rel, np.float64),
                           np.asarray(sqrt_info, np.float64)))
        self.updated = True
        return True

    # ---------------- ARock protocol ----------------

    def _scan_duals(self) -> None:
        """Create dual pairs for remote-owned poses touched by our edges
        (reference scanAndCreateDualStates, ARock.cpp:192-208; init to
        the current estimate, dual_state_init_to_zero=false)."""
        for (ka, kb, _, _) in self.edges:
            for k in (ka, kb):
                own = self.owner.get(k, self.self_id)
                if own == self.self_id:
                    continue
                pair = (own, k)
                if pair not in self.dual_remote:
                    cur = self.poses[self.slot_of[k]].copy()
                    self.dual_remote[pair] = cur.copy()
                    self.dual_local[pair] = cur.copy()

    def receive_all(self, max_msgs: int = 256) -> int:
        """Drain CH_PGO_DATA (reference ARockPGO::receiveAll +
        processPGOData: accept duals about frames we know, if addressed
        to us or previously unseen)."""
        n = 0
        while n < max_msgs:
            m = self.t.recv(timeout_ms=0)
            if m is None:
                break
            ch, sender, payload = m
            if ch != CH_PGO_DATA:
                continue
            d = decode_dpgo(payload)
            if d is None or d.drone_id == self.self_id:
                continue
            if d.ref_frame_id != self.ref_frame_id:
                continue
            self._apply(d)
            n += 1
        return n

    def input_data(self, d: DPGOData) -> None:
        """Direct injection (single-process simulations/tests)."""
        self._apply(d)

    def set_available_robots(self, ids) -> None:
        """Robots whose ROT_INIT_FINISH signal gates the first ARock
        round (reference setAvailableRobots, d2pgo.h:73-75)."""
        self.available_robots = {int(i) for i in ids} | {self.self_id}

    def _apply(self, d: DPGOData) -> None:
        if d.msg_type == DPGO_SIGNAL:
            if d.iteration == SIGNAL_ROT_INIT_FINISH:
                self.rot_init_finished_robots.add(int(d.drone_id))
                # a signal is new information: without this, a robot
                # held at the barrier whose peers are also held (so no
                # dual data flows) would never re-evaluate the barrier
                # and the whole swarm would deadlock pre-ARock
                self.updated = True
            return
        for i, k in enumerate(d.keys):
            k = int(k)
            if k not in self.slot_of:
                continue
            pair = (d.drone_id, k)
            fresh = pair not in self.dual_remote
            if d.target_id != self.self_id and not fresh:
                continue  # reference: target check OR first discovery
            self.dual_remote[pair] = d.duals[i].astype(np.float64)
            if fresh:
                self.dual_local[pair] = d.duals[i].astype(np.float64)
            self.updated = True

    def _broadcast(self, stamp: float) -> None:
        """One DPGOData per neighbor: our local duals of the frames we
        share with them + our current estimates (reference
        ARockPGO::broadcastData)."""
        by_peer: Dict[int, List[int]] = {}
        for (peer, k) in self.dual_local:
            by_peer.setdefault(peer, []).append(k)
        for peer, allk in by_peer.items():
            poses = np.stack([self.poses[self.slot_of[k]] for k in allk])
            duals = np.stack([self.dual_local[(peer, k)] for k in allk])
            msg = DPGOData(
                drone_id=self.self_id, target_id=peer,
                ref_frame_id=self.ref_frame_id,
                msg_type=DPGO_DELTA_POSE_DUAL, stamp=stamp,
                iteration=self.iteration,
                keys=np.asarray(allk, np.int64),
                poses=poses.astype(np.float32),
                duals=duals.astype(np.float32),
            )
            self.t.send(CH_PGO_DATA, encode_dpgo(msg))

    def _update_duals(self) -> None:
        """eta_k-relaxed dual update (reference updateDualStates,
        ARock.cpp:24-84; the 4-DoF branch mirrors the IsPose4D vector
        path: elementwise x/y/z average + circular yaw average, linear
        relaxation, yaw renormalized)."""
        eta = self.cfg.eta_k
        for pair, dl in self.dual_local.items():
            dr = self.dual_remote[pair]
            _, k = pair
            cur = self.poses[self.slot_of[k]]
            if self.cfg.pose_dof == 4:
                yl, yr = np_lie.yaw_of(dl[3:]), np_lie.yaw_of(dr[3:])
                avg_p = 0.5 * (dl[:3] + dr[:3])
                avg_y = np.arctan2(0.5 * (np.sin(yl) + np.sin(yr)),
                                   0.5 * (np.cos(yl) + np.cos(yr)))
                d_p = eta * (avg_p - cur[:3])
                d_y = eta * np_lie.wrap_angle(avg_y - np_lie.yaw_of(cur[3:]))
                new_y = np_lie.wrap_angle(yl - d_y)
                self.dual_local[pair] = np.concatenate(
                    [dl[:3] - d_p, np_lie.quat_from_yaw(new_y)]
                )
                continue
            avg = np_lie.pose_average(np.stack([dl, dr]))
            err = np_lie.pose_log(
                np_lie.pose_compose(np_lie.pose_inverse(cur), avg)
            )
            self.dual_local[pair] = np_lie.pose_compose(
                dl, np_lie.pose_exp(-eta * err)
            )

    # ---------------- the solve ----------------

    def _maybe_rot_init(self) -> None:
        """Chordal attitude + linear position initialization on the
        local graph BEFORE the first ARock round — and before any dual
        states are created, so duals (ours and the first values we
        broadcast to peers) initialize at post-init estimates, matching
        the reference's ordering (solve_multi: RotInit →
        waitForRotInitFinish barrier → ARock, d2pgo.cpp:155-328)."""
        cfg = self.cfg
        if not cfg.rot_init or self._rot_inited or len(self.edges) < 3:
            return
        n = len(self.keys)
        valid = np.zeros(cfg.max_poses, bool)
        valid[:n] = True
        E = cfg.max_edges
        ei = np.zeros(E, np.int64)
        ej = np.zeros(E, np.int64)
        rel = np.tile([0, 0, 0, 0, 0, 0, 1.0], (E, 1))
        ev = np.zeros(E, bool)
        for x, (ka, kb, r, _) in enumerate(self.edges[:E]):
            ei[x], ej[x], rel[x], ev[x] = (
                self.slot_of[ka], self.slot_of[kb], r, True
            )
        # the init runs before any ARock duals exist, so unlike the
        # ARock gauge (main robot only, d2pgo.cpp:602-614) EVERY robot
        # must anchor its local init — an unanchored chordal LS
        # collapses to the trivial zero solution. Anchor at the main
        # (lowest-owner) robot's first frame so the local gauges agree
        # across the swarm; the reference gets the same effect from the
        # rot-init's exchanged ROT_MAT duals
        # (rotation_initialization_arock.hpp).
        init_fixed = np.zeros(cfg.max_poses, bool)
        owners = set(self.owner.values())
        main = min(owners) if owners else self.self_id
        for slot, k in enumerate(self.keys):
            if self.owner[k] == main:
                init_fixed[slot] = True
                break

        rq = rel[:, 3:] / np.linalg.norm(rel[:, 3:], axis=1, keepdims=True)
        p = chordal_rotation_init(
            self._t(self.poses), self._t(valid), self._t(ei), self._t(ej), self._t(rq),
            self._t(ev), self._t(init_fixed), gravity_body=self._t(self.grav_body),
            gravity_weight=cfg.gravity_weight)
        p = linear_translation_init(
            p, self._t(valid), self._t(ei), self._t(ej), self._t(rel[:, :3]), self._t(ev),
            self._t(init_fixed))
        p = p.cpu().numpy()
        self.poses[:n] = p[:n].astype(np.float64)
        self._rot_inited = True

    def _send_signal(self, code: int, stamp: float = 0.0) -> None:
        msg = DPGOData(
            drone_id=self.self_id, target_id=-1,
            ref_frame_id=self.ref_frame_id, msg_type=DPGO_SIGNAL,
            stamp=stamp, iteration=code,
            keys=np.zeros(0, np.int64),
            poses=np.zeros((0, 7), np.float32),
            duals=np.zeros((0, 7), np.float32),
        )
        self.t.send(CH_PGO_DATA, encode_dpgo(msg))

    def _rot_init_barrier_ok(self, stamp: float) -> bool:
        """True when ARock rounds may run. After our local rot-init we
        (re)announce ROT_INIT_FINISH and hold until every robot in
        ``available_robots`` has announced too, or the round budget
        runs out (reference waitForRotInitFinish, d2pgo.cpp:130-153:
        spin + periodic re-send + rot_init_timeout)."""
        if not self.cfg.rot_init or not self._rot_inited:
            return True
        if self._rot_barrier_passed:
            return True
        self.rot_init_finished_robots.add(self.self_id)
        self._send_signal(SIGNAL_ROT_INIT_FINISH, stamp)
        if (self.available_robots <= self.rot_init_finished_robots
                or self._rot_barrier_waited >= self.cfg.rot_init_timeout_rounds):
            self._rot_barrier_passed = True
            return True
        self._rot_barrier_waited += 1
        return False

    def _t(self, x) -> torch.Tensor:
        """Host array -> tensor on the endpoint's device (floats in the
        solve dtype, integers as long)."""
        a = np.asarray(x)
        dtype = (self.dtype if a.dtype.kind == "f" else torch.long if a.dtype.kind in "iu"
                 else None)
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _local_solve(self) -> None:
        cfg = self.cfg
        layout = PGOLayout(cfg.max_poses, cfg.max_edges, cfg.pose_dof)
        n = len(self.keys)
        valid = np.zeros(cfg.max_poses, bool)
        valid[:n] = True
        # gauge: the main robot (lowest known owner id) hard-fixes the
        # first frame it owns (reference setStateProperties,
        # d2pgo.cpp:602-614). Non-main robots must NOT hard-fix their
        # local estimate of that frame — it may be wrong (drifted VIO
        # ingest) and the ARock duals are what correct it — but with
        # nothing fixed their local problem floats in its 6-DoF gauge
        # null space, so they get a SOFT self-anchor on the main frame
        # below (added to the dual-anchor rows).
        fixed = np.zeros(cfg.max_poses, bool)
        owners = set(self.owner.values())
        main = min(owners) if owners else self.self_id
        main_slot = -1
        for slot, k in enumerate(self.keys):
            if self.owner[k] == main:
                main_slot = slot
                break
        if self.self_id == main and main_slot >= 0:
            fixed[main_slot] = True

        E = cfg.max_edges
        dof = cfg.pose_dof
        ei = np.zeros(E, np.int64)
        ej = np.zeros(E, np.int64)
        rel = np.tile([0, 0, 0, 0, 0, 0, 1.0], (E, 1))
        si = np.tile(np.eye(dof), (E, 1, 1))
        sel4 = np.ix_([0, 1, 2, 5], [0, 1, 2, 5])  # x,y,z,yaw of a 6x6
        for x, (ka, kb, r, s) in enumerate(self.edges[:E]):
            if dof == 4 and s.shape == (6, 6):
                s = s[sel4]
            ei[x], ej[x], rel[x], si[x] = (
                self.slot_of[ka], self.slot_of[kb], r, s
            )
        ev = np.zeros(E, bool)
        ev[: min(len(self.edges), E)] = True

        K = cfg.max_anchors
        ai = np.zeros(K, np.int64)
        ap = np.tile([0, 0, 0, 0, 0, 0, 1.0], (K, 1))
        aa = np.zeros(K, bool)
        x = 0
        for pair, dr in self.dual_remote.items():
            if x >= K:
                break
            ai[x], ap[x], aa[x] = self.slot_of[pair[1]], dr, True
            x += 1
        if self.self_id != main and main_slot >= 0 and x < K:
            # soft gauge anchor: the main frame at the robot's CURRENT
            # estimate. Zero force at the current point — it only adds
            # curvature that pins the otherwise-zero-stiffness gauge
            # null space; the regular dual anchors remain free to move
            # the frame across rounds.
            ai[x] = main_slot
            ap[x] = self.poses[main_slot]
            aa[x] = True

        # past pcg_threshold pose slots the matrix-free anchored PCG solve
        # (the dense normal matrix is O(N^2) memory)
        kw = dict(rho_T=cfg.rho_T, rho_theta=cfg.rho_theta, max_iters=cfg.iters_per_step,
                  huber_delta=cfg.huber_delta, device=self.device)
        if cfg.max_poses > cfg.pcg_threshold:
            solver, kw = solve_pgo_pcg_anchored, dict(kw, cg_iters=cfg.cg_iters)
        else:
            solver = solve_pgo_anchored
        out, report = solver(
            layout, PGOState(poses=self._t(self.poses), valid=self._t(valid)),
            PGOEdges(i=self._t(ei), j=self._t(ej), rel=self._t(rel), sqrt_info=self._t(si),
                     valid=self._t(ev)),
            self._t(fixed), self._t(ai), self._t(ap), self._t(aa), **kw)
        opt = out.poses.cpu().numpy().astype(np.float64)
        opt[:n, 3:] /= np.linalg.norm(opt[:n, 3:], axis=1, keepdims=True)
        self.poses[:n] = opt[:n]
        c0, c1, acc = report
        self.last_report = (float(c0), float(c1), int(acc))

    def solve(self, stamp: float = 0.0) -> int:
        """One ARock round (reference solve_arock, ARock.cpp:140-190):
        receive → skip-if-stale → solve → dual update → broadcast.
        Returns the number of sub-steps actually executed."""
        done = 0
        total = 0
        while done < self.cfg.max_steps:
            self.receive_all()
            if not self.updated:
                total += 1
                if total > self.cfg.max_wait_steps + self.cfg.max_steps:
                    break  # exceeded max_wait_steps — give up this round
                continue
            self._maybe_rot_init()
            if not self._rot_init_barrier_ok(stamp):
                break  # hold ARock until peers finish rot-init
            self._scan_duals()
            self._local_solve()
            self.updated = False
            self._update_duals()
            self._broadcast(stamp)
            self.iteration += 1
            done += 1
            total += 1
        return done

    # ---------------- outputs ----------------

    def optimized_pose(self, key: int) -> Optional[np.ndarray]:
        slot = self.slot_of.get(int(key))
        return None if slot is None else self.poses[slot].copy()

    def trajectory(self, owner: int) -> np.ndarray:
        slots = [self.slot_of[k] for k in self.keys if self.owner[k] == owner]
        return self.poses[slots].copy()
