"""SOLVE_ALL / SERVER estimation modes: one estimator, every drone.

Counterpart of ``d2slam_tpu/vins/solve_all.py`` (reference ESTIMATION_MODE
{SOLVE_ALL_MODE, SERVER_MODE}, d2common/include/d2common/d2basetypes.h;
d2vins/src/estimator/d2estimator.cpp:224-293 addFrameRemote, :301-320
inputRemoteImage, :700-736 setupImuFactors over remote windows;
d2vinsstate.cpp:379-394 updateSldwin). Every drone's sliding window
lives in ONE flat slot pool, and the joint problem (an IMU chain per
drone, projection factors across drones through unified landmark ids,
one dense prior) goes through the same LM and marginalization as the
single-robot estimator, on its device:

  * the normal equations cover all drones at once, which is what
    SOLVE_ALL means in the reference;
  * each drone's IMU chain is more (frame_i, frame_j) pairs in the same
    batched preintegration;
  * a remote drone's window membership arrives in its wire packet
    (``sld_win``) and frames it dropped are marginalized into the prior.

SERVER mode is the same class fed only remote packets: ``server_mode=True``,
no ``input_frame``, and ``solve_remote_only`` on a cadence.

As in the JAX package the camera extrinsics are shared across drones
(one rig model per swarm).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from d2slam_tpu_torch.comm.codec import RemoteKeyframePacket
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.imu.buffer import IMUBuffer
from d2slam_tpu_torch.solver.marginalization import add_gauge_rows, make_pose_prior
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.vins.estimator import D2Estimator, WindowFrame
from d2slam_tpu_torch.vins.types import Odometry, global_frame_id as _gfid

_IDENTITY = np.array([0, 0, 0, 0, 0, 0, 1.0])


class SolveAllEstimator(D2Estimator):
    def __init__(
        self,
        config: D2Config,
        extrinsics: np.ndarray,
        max_drones: int = 3,
        server_mode: bool = False,
        lm_id_map: Optional[Callable[[int, int], int]] = None,
        device=None,
    ):
        """``lm_id_map(drone_id, lm_id) -> global id`` unifies landmark ids
        across drones (the system wires its swarm manager's unified ids
        here); the default folds the drone id into the key, so no landmark
        is shared across drones until ids are unified upstream. The pool
        holds ``max_drones`` windows of ``max_sld_win_size`` frames."""
        self.W_per = config.estimator.max_sld_win_size
        self.max_drones = max_drones
        self.server_mode = server_mode
        self._lm_id_map = lm_id_map or _gfid
        cfg = copy.deepcopy(config)
        e = cfg.estimator
        e.max_sld_win_size = self.W_per * max_drones
        e.max_lm_slots *= max_drones
        e.max_solve_cnt *= max_drones
        e.max_solve_measurements *= max_drones
        super().__init__(cfg, extrinsics, device=device)
        self.remote_bufs: Dict[int, IMUBuffer] = {}
        # drone -> (frame_id, ego pose [7], stamp) of its last ingested frame
        self.remote_last_ego: Dict[int, Tuple[int, np.ndarray, float]] = {}
        self._gauge_done: set = set()
        if server_mode:
            # the server sees no IMU or frames of its own; its gauge is the
            # first remote drone's first frame (stiff prior below)
            self.initialized = True

    # ------------------------------------------------------------------
    # remote ingestion
    # ------------------------------------------------------------------

    def input_remote_frame(self, pkt: RemoteKeyframePacket,
                           world_T_other: Optional[np.ndarray] = None) -> Optional[Odometry]:
        """Ingest one remote keyframe packet.

        ``world_T_other``: the map alignment of this drone's ego frame
        (identity when the swarm shares a reference frame), used for the
        drone's FIRST frame only; later frames chain by ego motion
        (reference addFrameRemote, d2estimator.cpp:254-270)."""
        d = pkt.drone_id
        if (d not in self.remote_bufs
                and len(self.remote_bufs) >= self.max_drones - (0 if self.server_mode else 1)):
            return None  # the pool holds max_drones windows; extras are ignored
        buf = self.remote_bufs.setdefault(d, IMUBuffer())
        for k in range(len(pkt.imu_t)):
            buf.add(float(pkt.imu_t[k]), pkt.imu_acc[k], pkt.imu_gyr[k])

        ego = pkt.pose.astype(np.float64)
        if not self.initialized:
            # own window not bootstrapped yet; remember the ego for chaining
            self.remote_last_ego[d] = (pkt.frame_id, ego, pkt.stamp)
            return None

        my_slots = self._drone_slots(d)
        if my_slots:
            _, prev_ego, _ = self.remote_last_ego[d]
            rel = np_lie.pose_compose(np_lie.pose_inverse(prev_ego), ego)
            prev_local = self._np(self.state.poses[my_slots[-1]]).astype(np.float64)
            new_pose = np_lie.pose_compose(prev_local, rel)
            align = np_lie.pose_compose(new_pose, np_lie.pose_inverse(ego))
        else:
            align = _IDENTITY if world_T_other is None else np.asarray(world_T_other, np.float64)
            new_pose = np_lie.pose_compose(align, ego)
        # the velocity arrives in the remote drone's world; rotate it into
        # ours through the alignment's attitude
        vel = np_lie.quat_rotate(align[3:], pkt.vel.astype(np.float64))

        if len(self.frames) >= self.layout.W:
            self._trim_drone(d, self.W_per - 1)   # pool full: make room

        slot = len(self.frames)
        gid = _gfid(d, pkt.frame_id)
        self.frames.append(WindowFrame(gid, pkt.stamp, bool(pkt.is_keyframe), drone_id=d))
        poses = self._np(self.state.poses).copy()
        sb = self._np(self.state.sb).copy()
        fv = self._np(self.state.frame_valid).copy()
        poses[slot] = new_pose
        sb[slot] = np.concatenate([vel, pkt.ba.astype(np.float64), pkt.bg.astype(np.float64)])
        fv[slot] = True
        self.state = self.state._replace(poses=self._t(poses), sb=self._t(sb),
                                         frame_valid=self._t(fv, torch.bool))
        self.fej_poses[slot], self.fej_sb[slot] = poses[slot], sb[slot]
        self.remote_last_ego[d] = (pkt.frame_id, ego, pkt.stamp)
        self._meas_stale = True

        # gauge prior on this drone's first frame: 1/100 of the main
        # drone's stiffness (reference d2vinsstate.cpp:503-555); the
        # server's first drone is its gauge, as stiff as a main drone
        if d not in self._gauge_done:
            if self.prior is None:
                w = 100.0 if self.server_mode and not self._gauge_done else 1.0
                self.prior = make_pose_prior(self.layout, self.state, frame=slot,
                                             pos_sqrt_info=w, rot_sqrt_info=w)
            else:
                self.prior = add_gauge_rows(self.layout, self.prior, self.state, frame=slot,
                                            pos_sqrt_info=1.0, rot_sqrt_info=1.0)
            self._gauge_done.add(d)

        # landmark observations under unified ids
        for i in range(len(pkt.lm_ids)):
            self.lmanager.add_observation(
                self._lm_id_map(d, int(pkt.lm_ids[i])), gid, int(pkt.lm_cam[i]),
                pkt.lm_rays[i].astype(np.float64), pkt.lm_vels[i].astype(np.float64), -1.0)

        self._sync_remote_window(d, pkt.sld_win)
        return Odometry(stamp=pkt.stamp, pose=new_pose, vel=vel)

    def solve_remote_only(self) -> None:
        """SERVER mode's solve (no own frames trigger one)."""
        n = sum(len(self._drone_slots(d)) for d in self.remote_bufs)
        if n >= self.cfg.estimator.min_solve_frames:
            self._solve_window()

    # ------------------------------------------------------------------
    # pooled window management
    # ------------------------------------------------------------------

    def _drone_slots(self, drone_id: int) -> List[int]:
        """Slots of one drone's frames, oldest first (the pool keeps each
        drone's frames in time order and stays compact)."""
        want = -1 if drone_id == self.cfg.self_id else drone_id
        return [w for w, f in enumerate(self.frames) if f.drone_id == want]

    def drone_ids(self) -> List[int]:
        return sorted({self.cfg.self_id if f.drone_id < 0 else f.drone_id for f in self.frames})

    def _imu_chain(self):
        chain = []
        for w, f in enumerate(self.frames):
            # this drone's next frame in the pool
            for w2 in range(w + 1, len(self.frames)):
                if self.frames[w2].drone_id == f.drone_id:
                    buf = self.imubuf if f.drone_id < 0 else self.remote_bufs.get(f.drone_id)
                    if buf is not None:
                        chain.append((w, w2, buf))
                    break
        return chain

    def _sync_remote_window(self, d: int, sld_win: np.ndarray) -> None:
        """Follow the remote drone's own window membership (reference
        updateSldwin, d2vinsstate.cpp:379-394): frames the sender dropped
        are marginalized here; the drone's frames are capped at W_per
        besides. The newest frame (the chaining anchor) always stays."""
        if len(sld_win):
            keep = {_gfid(d, int(f)) for f in sld_win}
            dropped = True
            while dropped:
                dropped = False
                for w in self._drone_slots(d)[:-1]:
                    if self.frames[w].frame_id not in keep:
                        self._drop_frame(w, marginalize_it=True)
                        dropped = True
                        break
        self._trim_drone(d, self.W_per)

    def _trim_drone(self, d: int, cap: int) -> None:
        while len(self._drone_slots(d)) > cap:
            self._drop_frame(self._drone_slots(d)[0], marginalize_it=True)

    def _plan_marg_slot(self) -> int:
        # the pool trims per drone (_sync_remote_window / _trim_drone): no
        # slot is known before the solve to fuse into it
        return -1

    def _manage_window(self) -> None:
        """The own drone's window policy (drop the second-newest
        non-keyframe, else marginalize the oldest: reference
        clearUselessFrames) on the own sub-window of the pool."""
        mine = self._drone_slots(self.cfg.self_id)
        if len(mine) < self.W_per:
            return
        if not self.frames[mine[-2]].is_keyframe:
            self._drop_frame(mine[-2], marginalize_it=False)
        else:
            self._drop_frame(mine[0], marginalize_it=True)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def drone_odometry(self, drone_id: int) -> Optional[Odometry]:
        slots = self._drone_slots(drone_id)
        if not slots:
            return None
        w = slots[-1]
        return Odometry(stamp=self.frames[w].stamp, pose=self._np(self.state.poses[w]),
                        vel=self._np(self.state.sb[w, :3]))

    def drone_trajectory(self, drone_id: int) -> np.ndarray:
        """The drone's in-window poses, oldest first, [n, 7]."""
        return self._np(self.state.poses)[self._drone_slots(drone_id)]
