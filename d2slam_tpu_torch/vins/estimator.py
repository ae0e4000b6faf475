"""Sliding-window visual-inertial estimator (single-robot core).

Counterpart of ``d2slam_tpu/vins/estimator.py`` (reference D2Estimator,
d2vins/src/estimator/d2estimator.cpp), single-robot path. Data-dependent
control flow — keyframe/window management, landmark bookkeeping,
triangulation, outlier decisions — lives on the host in this class; the
numeric path (preintegration, factor linearization, LM solve,
marginalization) runs on torch tensors on ``device``.

Window semantics follow the reference:
  * frames append until ``max_sld_win_size``; then either the
    second-newest non-keyframe is dropped, or the oldest keyframe is
    marginalized into the dense prior (d2vinsstate.cpp:294-320
    clearUselessFrames). The marginalization runs in the same backend
    step as the solve (``solve_and_marginalize_carry``).
  * the first frame carries a stiff pose prior as the gauge anchor
    (d2vinsstate.cpp:503-555).
  * first-pose initialization aligns attitude with the mean IMU
    acceleration and seeds the gyro bias (d2estimator.cpp:74-121); a
    drone already moving at the start goes through the SFM + linear
    alignment initialization instead (d2vinsstate.cpp:763-1040).

The dense prior stays a device tensor across keyframes; window shifts
are recorded as a pending slot permutation and applied on the device at
the next solve.

Multi-robot hooks: ``attach_consensus`` turns every window solve into
ADMM sub-steps with the peers over a transport
(DISTRIBUTED_CAMERA_CONSENUS), and the SOLVE_ALL pool
(``vins.solve_all``) overrides ``_imu_chain`` and the window policy;
frames it drops are marginalized on their own (``_drop_frame``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.factors.residuals import imu_sqrt_info
from d2slam_tpu_torch.geometry import lie
from d2slam_tpu_torch.imu.buffer import IMUBuffer
from d2slam_tpu_torch.imu.preintegration import (
    PreintegrationResult,
    default_noise_matrix,
    imu_propagate_pose,
    preintegrate,
)
from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.lm import lm_solve_vio
from d2slam_tpu_torch.solver.marginalization import (
    make_pose_prior,
    marginalize,
    permute_prior_device,
    solve_and_marginalize_carry,
    zero_prior,
)
from d2slam_tpu_torch.solver.state import ImuMeas, PriorBlock, ProjMeas, VIOState
from d2slam_tpu_torch.utils import np_lie, perf
from d2slam_tpu_torch.utils.device import load_cuda_linalg, resolve_device, torch_dtype
from d2slam_tpu_torch.utils.perf import PerfTracker
from d2slam_tpu_torch.vins.initialization import linear_alignment
from d2slam_tpu_torch.vins.landmark_manager import ESTIMATED, LandmarkManager
from d2slam_tpu_torch.vins.sfm_init import align_to_gravity, sfm_initialize
from d2slam_tpu_torch.vins.types import FrontendFrame, Odometry, global_frame_id


def _sync(device: torch.device) -> None:
    """Wait for the work queued on this thread's current stream (the
    pipelined runtime's backend runs the estimator on a stream of its
    own, beside the frontend's)."""
    perf.count("estimator.host_waits")
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _valid_prefix(mask: np.ndarray) -> int:
    """Length of the sample prefix that holds every valid sample:
    padded samples after it never change an integration, so the loops
    stop there."""
    idx = np.flatnonzero(np.asarray(mask).reshape(-1, mask.shape[-1]).any(0))
    return int(idx[-1]) + 1 if len(idx) else 1


class WindowFrame:
    __slots__ = ("frame_id", "stamp", "is_keyframe", "drone_id")

    def __init__(self, frame_id, stamp, is_keyframe, drone_id=-1):
        self.frame_id = frame_id
        self.stamp = stamp
        self.is_keyframe = is_keyframe
        self.drone_id = drone_id  # -1 = the estimator's own drone


class CamPoseTable:
    """Precomputed world_T_cam for every (window slot, camera), callable
    as ``f(frame_id, cam_id) -> pose[7] | None`` plus a vectorized
    ``lookup(frame_ids, cam_ids) -> (T [N, 7], ok [N])``."""

    def __init__(self, slot_of: Dict[int, int], poses: np.ndarray,
                 ext: np.ndarray):
        self.slot_of = slot_of
        W, C = len(poses), len(ext)
        pq = np.repeat(poses[:, 3:], C, axis=0)              # [W*C, 4]
        R = np_lie.quat_to_rotmat_batch(pq)                  # [W*C, 3, 3]
        et = np.tile(ext[:, :3], (W, 1))
        t = np.repeat(poses[:, :3], C, axis=0) + np.einsum("nij,nj->ni", R, et)
        x1, y1, z1, w1 = pq.T
        x2, y2, z2, w2 = np.tile(ext[:, 3:], (W, 1)).T
        q = np.stack([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ], axis=1)
        self.table = np.concatenate([t, q], axis=1).reshape(W, C, 7)

    def __call__(self, frame_id, cam_id):
        w = self.slot_of.get(frame_id)
        if w is None:
            return None
        return self.table[w, cam_id]

    def lookup(self, frame_ids, cam_ids):
        idx = np.fromiter(
            (self.slot_of.get(int(f), -1) for f in frame_ids),
            np.int64, count=len(frame_ids),
        )
        ok = idx >= 0
        T = self.table[np.maximum(idx, 0), np.asarray(cam_ids)]
        return T, ok


class D2Estimator:
    def __init__(self, config: D2Config, extrinsics: np.ndarray, device=None):
        self.cfg = config
        e = config.estimator
        extrinsics = np.asarray(extrinsics)
        if len(extrinsics) != config.num_cams:
            raise ValueError(
                f"extrinsics has {len(extrinsics)} cameras but "
                f"config.num_cams={config.num_cams}; set num_cams to match"
            )
        self.device = resolve_device(device)
        load_cuda_linalg(self.device)
        self.dtype = torch_dtype(config.dtype)
        self.layout = VIOLayout(
            W=e.max_sld_win_size,
            C=config.num_cams,
            L=e.max_lm_slots,
            M=e.max_solve_measurements,
            N_IMU_SAMPLES=e.max_imu_samples,
        )
        self.gravity = self._t([0.0, 0.0, config.imu.g_norm])
        self.noise = default_noise_matrix(
            config.imu.acc_n, config.imu.gyr_n, config.imu.acc_w,
            config.imu.gyr_w, dtype=self.dtype, device=self.device,
        )
        self.imubuf = IMUBuffer()
        self.lmanager = LandmarkManager(
            min_depth=e.min_depth, max_depth=e.max_depth,
            min_baseline=e.min_triangulate_baseline,
            tri_max_err=e.triangulate_max_err,
        )
        self.frames: List[WindowFrame] = []
        self.state = VIOState.zeros(self.layout, self.dtype, self.device)
        self.state = self.state._replace(ext=self._t(extrinsics))
        self.fej_poses = np.zeros((self.layout.W, 7))
        self.fej_sb = np.zeros((self.layout.W, 9))
        # device-resident prior plus the window shifts not yet applied
        # to it (composed slot map, applied on the device at the next
        # solve)
        self._prior: Optional[PriorBlock] = None
        self._pending_perm: Optional[np.ndarray] = None
        self.initialized = False
        # dynamic start: (frame, {landmark id: cam-0 ray}) of the frames
        # buffered until the SFM initialization succeeds
        self._sfm_buffer: Optional[list] = None
        self.solve_count = 0
        self.margin_count = 0
        self.lm_slot_of: Dict[int, int] = {}
        self.perf = PerfTracker("estimator")
        self.last_report = None
        # the measurements of the last solve, for a marginalization after
        # it; stale once window slots moved
        self._last_meas = None
        self._meas_stale = False
        # the slot the last solve already marginalized (fused into it)
        self._fused_marg_slot: Optional[int] = None
        # consensus over a transport (attach_consensus)
        self._consensus = None
        self._solver_kw = dict(
            gravity=self.gravity,
            proj_sqrt_info=e.focal_length / 1.5,
            dep_sqrt_info=e.depth_sqrt_inf,
            huber_delta=e.huber_delta,
            max_iters=e.max_solver_iters,
            landmark_param=e.landmark_param,
            method=e.solver_method,
            refine_steps=e.cholesky_refine_steps,
            remove_base_mode=e.remove_base_when_margin_remote,
        )

    def _t(self, x, dtype=None) -> torch.Tensor:
        """Host array -> tensor on the estimator's device."""
        return torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype,
                               device=self.device)

    @staticmethod
    def _np(x: torch.Tensor) -> np.ndarray:
        perf.count("estimator.host_waits")
        return x.detach().cpu().numpy()

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def input_imu(self, t: float, acc, gyr) -> None:
        self.imubuf.add(t, acc, gyr)

    def input_frame(self, frame: FrontendFrame) -> Optional[Odometry]:
        """Process one keyframe worth of landmark observations."""
        if not self.imubuf.available(frame.stamp):
            raise ValueError(
                f"IMU not available up to t={frame.stamp:.3f} "
                f"(buffer ends {self.imubuf.t_last:.3f})"
            )
        with self.perf.stage("input_frame", frame.frame_id):
            with self.perf.stage("ingest"):
                if not self.initialized:
                    if not self._try_init_first_pose(frame):
                        return None
                else:
                    self._add_frame(frame)
                self._ingest_observations(frame)

            if len(self.frames) >= self.cfg.estimator.min_solve_frames:
                self._solve_window()

            with self.perf.stage("manage_window"):
                self._manage_window()
            return self.latest_odometry(frame.stamp)

    # ------------------------------------------------------------------
    # initialization & frame addition
    # ------------------------------------------------------------------

    def _try_init_first_pose(self, frame: FrontendFrame) -> bool:
        if len(self.imubuf) < 10:
            return False
        acc = self.imubuf.mean_acc()
        gyr = self.imubuf.mean_gyro()
        g = self.cfg.imu.g_norm
        # a dynamic start (specific force off gravity, or body rate)
        # needs the SFM initialization
        if (abs(np.linalg.norm(acc) - g) > 0.03 * g
                or np.linalg.norm(gyr) > 0.05):
            return self._try_init_sfm(frame)
        # attitude aligning measured specific force with world +z
        a = acc / np.linalg.norm(acc)
        up = np.array([0.0, 0.0, 1.0])
        v = np.cross(a, up)
        s = np.linalg.norm(v)
        c = float(a @ up)
        if s < 1e-9:
            R = np.eye(3) if c > 0 else -np.eye(3)
        else:
            vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
            R = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
        q0 = np_lie.rotmat_to_quat(R)
        pose0 = np.concatenate([[0.0, 0.0, 0.0], q0])
        sb0 = np.concatenate([[0.0, 0.0, 0.0], [0, 0, 0], gyr])

        self.frames.append(WindowFrame(frame.frame_id, frame.stamp, True))
        poses = self._np(self.state.poses).copy()
        sb = self._np(self.state.sb).copy()
        poses[0], sb[0] = pose0, sb0
        fv = np.zeros(self.layout.W, bool)
        fv[0] = True
        self.state = self.state._replace(
            poses=self._t(poses), sb=self._t(sb),
            frame_valid=self._t(fv, torch.bool),
        )
        self.fej_poses[0], self.fej_sb[0] = pose0, sb0
        self._prior = make_pose_prior(self.layout, self.state, frame=0)
        self._pending_perm = None
        self.initialized = True
        return True

    def _try_init_sfm(self, frame: FrontendFrame) -> bool:
        """Dynamic-start initialization: buffer frames (at most W - 2)
        until the SFM + linear-alignment pipeline succeeds, then fill the
        window with the buffered frames' metric states."""
        buf = self._sfm_buffer
        if buf is None:
            buf = self._sfm_buffer = []
        obs0 = {}
        for co in frame.observations:
            if co.cam_id == 0:
                for i, lid in enumerate(co.landmark_ids):
                    obs0[int(lid)] = np.asarray(co.rays[i], np.float64)
        buf.append((frame, obs0))
        if len(buf) > self.layout.W - 2:
            buf.pop(0)
        if len(buf) < 6:
            return False

        ext0 = self._np(self.state.ext[0]).astype(np.float64)
        out = sfm_initialize([b[1] for b in buf], ext0, self._preintegrate_buffer(np.zeros(3)))
        if out is None:
            return False
        la = linear_alignment(out["body_poses_visual"], self._preintegrate_buffer(out["dbg"]))
        if la is None:
            return False
        vels_body, g_vis, scale = la
        poses_init, vels = align_to_gravity(out["body_poses_visual"], vels_body, g_vis, scale,
                                            g_norm=self.cfg.imu.g_norm)

        poses = self._np(self.state.poses).copy()
        sb = self._np(self.state.sb).copy()
        fv = np.zeros(self.layout.W, bool)
        for k, (bframe, _) in enumerate(buf):
            self.frames.append(WindowFrame(bframe.frame_id, bframe.stamp, True))
            poses[k] = poses_init[k]
            sb[k] = np.concatenate([vels[k], np.zeros(3), out["dbg"]])
            fv[k] = True
            self.fej_poses[k], self.fej_sb[k] = poses[k], sb[k]
        self.state = self.state._replace(
            poses=self._t(poses), sb=self._t(sb), frame_valid=self._t(fv, torch.bool),
        )
        self._prior = make_pose_prior(self.layout, self.state, frame=0)
        self._pending_perm = None
        self.initialized = True
        # the buffered frames' observations never reached the landmark
        # manager (ingestion happens after the initialization): replay
        # them, except the current frame, which input_frame ingests next
        for (bframe, _) in buf[:-1]:
            self._ingest_observations(bframe)
        self._sfm_buffer = None
        return True

    def _preintegrate_buffer(self, bg: np.ndarray) -> List[PreintegrationResult]:
        """The SFM buffer's intervals preintegrated in one batch on the
        estimator's device, in float64 whatever the solver's dtype, with
        gyro bias ``bg`` (zero accelerometer bias); host copies, one
        result per interval."""
        buf = self._sfm_buffer
        n = self.layout.N_IMU_SAMPLES
        periods = [self.imubuf.period(buf[k][0].stamp, buf[k + 1][0].stamp, n)
                   for k in range(len(buf) - 1)]
        dts, accs, gyrs, mask = (np.stack(x) for x in zip(*periods))
        cut = _valid_prefix(mask)
        f64 = dict(dtype=torch.float64, device=self.device)
        K = len(periods)
        pre = preintegrate(
            torch.as_tensor(dts[:, :cut], **f64), torch.as_tensor(accs[:, :cut], **f64),
            torch.as_tensor(gyrs[:, :cut], **f64),
            torch.as_tensor(mask[:, :cut], device=self.device),
            torch.zeros((K, 3), **f64), torch.as_tensor(np.tile(bg, (K, 1)), **f64),
            default_noise_matrix(self.cfg.imu.acc_n, self.cfg.imu.gyr_n,
                                 self.cfg.imu.acc_w, self.cfg.imu.gyr_w, **f64),
        )
        host = PreintegrationResult(*(self._np(x) for x in pre))
        return [PreintegrationResult(*(x[k] for x in host)) for k in range(K)]

    def _last_self_slot(self) -> int:
        for w in range(len(self.frames) - 1, -1, -1):
            if self.frames[w].drone_id < 0:
                return w
        return -1

    def _imu_period(self, t0: float, t1: float):
        """IMU samples of (t0, t1] on the device, cut after the last
        valid sample."""
        dts, accs, gyrs, mask = self.imubuf.period(
            t0, t1, self.layout.N_IMU_SAMPLES)
        n = _valid_prefix(mask)
        return (self._t(dts[:n]), self._t(accs[:n]), self._t(gyrs[:n]),
                self._t(mask[:n], torch.bool))

    def _propagate(self, w: int, t_end: float):
        sb = self.state.sb[w]
        dts, accs, gyrs, mask = self._imu_period(self.frames[w].stamp, t_end)
        return imu_propagate_pose(
            self.state.poses[w], sb[:3], sb[3:6], sb[6:9],
            dts, accs, gyrs, mask, -self.gravity,
        )

    def _add_frame(self, frame: FrontendFrame) -> None:
        w_prev = self._last_self_slot()
        if len(self.frames) >= self.layout.W:
            raise RuntimeError("window overflow")
        # motion prediction: propagate pose/vel through the interval
        new_pose, new_vel = self._propagate(w_prev, frame.stamp)
        w = len(self.frames)
        self.frames.append(
            WindowFrame(frame.frame_id, frame.stamp, frame.is_keyframe)
        )
        sb_prev = self._np(self.state.sb[w_prev])
        poses = self._np(self.state.poses).copy()
        sb = self._np(self.state.sb).copy()
        poses[w] = self._np(new_pose)
        sb[w] = np.concatenate([self._np(new_vel), sb_prev[3:9]])
        fv = self._np(self.state.frame_valid).copy()
        fv[w] = True
        self.state = self.state._replace(
            poses=self._t(poses), sb=self._t(sb),
            frame_valid=self._t(fv, torch.bool),
        )
        self.fej_poses[w], self.fej_sb[w] = poses[w], sb[w]

    def _ingest_observations(self, frame: FrontendFrame) -> None:
        for co in frame.observations:
            depths = co.depths if co.depths is not None else -np.ones(len(co.landmark_ids))
            for i, lid in enumerate(co.landmark_ids):
                self.lmanager.add_observation(
                    int(lid), frame.frame_id, co.cam_id,
                    co.rays[i], co.ray_vels[i], float(depths[i]),
                )

    # ------------------------------------------------------------------
    # measurement assembly
    # ------------------------------------------------------------------

    def _slot_of_frame(self) -> Dict[int, int]:
        return {f.frame_id: w for w, f in enumerate(self.frames)}

    def _cam_pose_of(self) -> CamPoseTable:
        return CamPoseTable(
            self._slot_of_frame(),
            self._np(self.state.poses), self._np(self.state.ext),
        )

    def _imu_chain(self):
        """Preintegration intervals as (slot_i, slot_j, imu_buffer): one
        chain of consecutive frames per drone (the SOLVE_ALL pool runs
        one per drone, reference setupImuFactors over remote windows,
        d2estimator.cpp:700-736)."""
        return [(w, w + 1, self.imubuf) for w in range(len(self.frames) - 1)]

    def _build_imu(self) -> ImuMeas:
        layout = self.layout
        K, n = layout.W - 1, layout.N_IMU_SAMPLES
        dts = np.zeros((K, n))
        accs = np.zeros((K, n, 3))
        gyrs = np.zeros((K, n, 3))
        mask = np.zeros((K, n), bool)
        valid = np.zeros(K, bool)
        fi = np.zeros(K, np.int64)
        fj = np.zeros(K, np.int64)
        for k, (si, sj, buf) in enumerate(self._imu_chain()[:K]):
            d, a, g, m = buf.period(self.frames[si].stamp, self.frames[sj].stamp, n)
            dts[k], accs[k], gyrs[k], mask[k] = d, a, g, m
            fi[k], fj[k] = si, sj
            valid[k] = m.any()
        cut = _valid_prefix(mask)
        fi_t = self._t(fi, torch.long)
        sb = self.state.sb[fi_t]
        pre = preintegrate(
            self._t(dts[:, :cut]), self._t(accs[:, :cut]),
            self._t(gyrs[:, :cut]), self._t(mask[:, :cut], torch.bool),
            sb[:, 3:6], sb[:, 6:9], self.noise,
        )
        valid_t = self._t(valid, torch.bool)
        # zero (not just mask) invalid intervals so no non-finite value
        # can enter the assembly
        sqrt_infos = torch.where(
            valid_t[:, None, None], imu_sqrt_info(pre.covariance),
            torch.zeros((), dtype=self.dtype, device=self.device))
        return ImuMeas(frame_i=fi_t, frame_j=self._t(fj, torch.long),
                       valid=valid_t, pre=pre, sqrt_info=sqrt_infos)

    def _build_measurements(self):
        e = self.cfg.estimator
        layout = self.layout
        slots = self._slot_of_frame()
        imu = self._build_imu()

        self.lmanager.initial_landmarks(
            self._cam_pose_of(), e.landmark_estimate_tracks
        )
        usable = self.lmanager.estimated_landmarks(e.landmark_estimate_tracks)
        usable = [lm for lm in usable if lm.anchor.frame_id in slots]
        usable.sort(key=lambda lm: -lm.track_length())
        usable = usable[: min(e.max_solve_cnt, layout.L)]

        M = layout.M
        pm = {
            "frame_i": np.zeros(M, np.int64), "frame_j": np.zeros(M, np.int64),
            "cam_i": np.zeros(M, np.int64), "cam_j": np.zeros(M, np.int64),
            "lm": np.zeros(M, np.int64),
            "ray_i": np.tile([0.0, 0, 1], (M, 1)), "ray_j": np.tile([0.0, 0, 1], (M, 1)),
            "vel_i": np.zeros((M, 3)), "vel_j": np.zeros((M, 3)),
            "td_i": np.zeros(M), "td_j": np.zeros(M), "dep_j": np.zeros(M),
            "has_dep": np.zeros(M, bool), "valid": np.zeros(M, bool),
        }
        pos3d = e.landmark_param == "pos3d"
        inv_dep = self._np(self.state.inv_dep).copy()
        lm_pos = self._np(self.state.lm_pos).copy()
        lm_valid = np.zeros(layout.L, bool)
        self.lm_slot_of = {}
        m = 0
        for slot, lm in enumerate(usable):
            if m >= M:
                break
            a = lm.anchor
            fi = slots[a.frame_id]
            if pos3d and lm.position is None:
                continue
            self.lm_slot_of[lm.lm_id] = slot
            lm_valid[slot] = True
            inv_dep[slot] = lm.inv_dep
            if pos3d:
                lm_pos[slot] = lm.position
            # inv_dep: observations pair with the anchor; pos3d: every
            # observation, the anchor's included, is a single-frame
            # residual of the world point (reference reprojection3d.h)
            for o in (lm.obs if pos3d else lm.obs[1:]):
                if o.frame_id not in slots or m >= M:
                    continue
                pm["frame_i"][m] = fi
                pm["frame_j"][m] = slots[o.frame_id]
                pm["cam_i"][m] = a.cam_id
                pm["cam_j"][m] = o.cam_id
                pm["lm"][m] = slot
                pm["ray_i"][m] = a.ray
                pm["ray_j"][m] = o.ray
                pm["vel_i"][m] = a.ray_vel
                pm["vel_j"][m] = o.ray_vel
                if o.depth > 0:
                    pm["dep_j"][m] = o.depth
                    pm["has_dep"][m] = True
                pm["valid"][m] = True
                m += 1
        kinds = {np.dtype(np.float64): self.dtype,
                 np.dtype(np.int64): torch.long,
                 np.dtype(bool): torch.bool}
        proj = ProjMeas(**{k: self._t(v, kinds[v.dtype]) for k, v in pm.items()})
        self.state = self.state._replace(
            inv_dep=self._t(inv_dep), lm_pos=self._t(lm_pos),
            lm_valid=self._t(lm_valid, torch.bool),
        )
        return imu, proj

    def _col_free(self) -> torch.Tensor:
        e = self.cfg.estimator
        free = np.zeros(self.layout.D_pad, bool)
        free[: 15 * len(self.frames)] = True
        if e.estimate_extrinsic:
            free[15 * self.layout.W: 15 * self.layout.W + 6 * self.layout.C] = True
        if e.estimate_td:
            free[self.layout.td_col] = True
        return self._t(free, torch.bool)

    # ------------------------------------------------------------------
    # solve & window management
    # ------------------------------------------------------------------

    def attach_consensus(self, transport_consensus, expected_peers: int,
                         timeout_ms: int = 100) -> None:
        """DISTRIBUTED_CAMERA_CONSENUS: every window solve becomes
        ``consensus_max_steps`` ADMM sub-steps exchanging shared poses with
        the peers over the transport (reference solveinDistributedMode,
        d2estimator.cpp:502-602; the transport's iteration token is the
        reference's sync token). Shared poses are matched across robots by
        64-bit (drone_id, frame_id) keys, never by window slot, so robots
        whose keyframe decisions diverge still average exactly the frames
        they share (reference VINSConsenusSolver.cpp:60-92); the duals are
        keyed by frame id too and survive window shifts."""
        self._consensus = transport_consensus
        self._consensus_peers = expected_peers
        self._consensus_timeout = timeout_ms
        self._consensus_token = 0
        self._consensus_tilde: Dict[int, np.ndarray] = {}

    def consensus_key(self, frame: WindowFrame) -> int:
        """Swarm-wide identity of a window frame: own frames fold our drone
        id in; remote frames (SOLVE_ALL pool) carry the folded id already."""
        if frame.drone_id < 0:
            return global_frame_id(self.cfg.self_id, frame.frame_id)
        return int(frame.frame_id)

    @property
    def prior(self) -> Optional[PriorBlock]:
        """The current prior, with pending window shifts applied (a
        read; the device-resident carry is left as it is)."""
        if self._prior is None or self._pending_perm is None:
            return self._prior
        return permute_prior_device(self.layout, self._prior, self._pending_perm)

    @prior.setter
    def prior(self, value: Optional[PriorBlock]) -> None:
        """Replace the prior; ``value`` is in the current slot layout."""
        self._prior = value
        self._pending_perm = None

    def _plan_marg_slot(self) -> int:
        """Which slot _manage_window will marginalize after this solve
        (-1 = none): the reference clearUselessFrames policy, decided
        from keyframe flags alone so it runs in the solve's step."""
        if (len(self.frames) >= self.layout.W
                and self.frames[-2].is_keyframe
                and self.solve_count > 0):
            return 0
        return -1

    def _solve_window(self):
        with self.perf.stage("build_measurements"):
            imu, proj = self._build_measurements()
        self._last_meas = (imu, proj)
        self._meas_stale = False
        if self._consensus is not None:
            report = self._solve_consensus(imu, proj)
        else:
            report = self._solve_fused(imu, proj)
        self.solve_count += 1
        self.last_report = report
        with self.perf.stage("sync_back"):
            self._sync_back()

    def _solve_fused(self, imu: ImuMeas, proj: ProjMeas):
        """The solve with the window-management marginalization planned
        now fused into it, the prior carried on the device."""
        marg_slot = self._plan_marg_slot()
        remove = np.zeros(self.layout.W, bool)
        if marg_slot >= 0:
            remove[marg_slot] = True
        perm = (self._pending_perm if self._pending_perm is not None
                else np.arange(self.layout.W))
        self._pending_perm = None
        prior = self._prior
        if prior is None:
            prior = zero_prior(self.layout, self.dtype, self.device)
        with self.perf.stage("lm_solve"):
            self._prior, (new_state, report) = solve_and_marginalize_carry(
                self.layout, prior, self.state, imu, proj, perm,
                self._t(remove, torch.bool), marg_slot >= 0,
                bool(self.cfg.estimator.enable_fej and self._prior is not None),
                col_free=self._col_free(), **self._solver_kw,
            )
            _sync(self.device)
        self.state = new_state
        if marg_slot >= 0:
            self.margin_count += 1
            self._fused_marg_slot = marg_slot
        return report

    def _solve_consensus(self, imu: ImuMeas, proj: ProjMeas):
        """ADMM sub-steps: broadcast our window's poses, average them with
        the peers' copies by frame key, update the duals (on the host,
        ``comm.consensus_transport``), then solve with the consensus rows
        (reference solveinDistributedMode, d2estimator.cpp:502-602). The
        window's marginalization runs afterwards, on its own."""
        e = self.cfg.estimator
        n = len(self.frames)
        keys = np.array([self.consensus_key(f) for f in self.frames], np.int64)
        self.prior = self.prior   # commit pending window shifts
        col_free = self._col_free()
        lm_kw = {k: v for k, v in self._solver_kw.items() if k != "remove_base_mode"}
        report = None
        for _ in range(max(e.consensus_max_steps, 1)):
            poses = self._np(self.state.poses).astype(np.float64)
            with self.perf.stage("consensus_exchange"):
                gp_n, tilde_n, _, _ = self._consensus.consensus_step(
                    self._consensus_token, keys, poses[:n], self._consensus_tilde,
                    self._consensus_peers, self._consensus_timeout)
            self._consensus_token += 1
            gp = poses.copy()
            gp[:n] = gp_n
            tilde = np.zeros((self.layout.W, 6))
            tilde[:n] = tilde_n
            cons = (self._t(gp), self._t(tilde), self.state.frame_valid,
                    e.rho_frame_T, e.rho_frame_theta)
            with self.perf.stage("lm_solve"):
                self.state, report = lm_solve_vio(
                    self.layout, self.state, imu, proj, self._prior,
                    col_free=col_free, consensus=cons, **lm_kw)
                _sync(self.device)
        return report

    def _sync_back(self):
        """Write solved landmark states back to the DB + outlier check
        (reference d2vinsstate.cpp:557-592 syncFromState)."""
        e = self.cfg.estimator
        inv_dep = self._np(self.state.inv_dep)
        lm_pos = self._np(self.state.lm_pos)
        cam_pose = self._cam_pose_of()
        lms, slots, fids, cids, rays = [], [], [], [], []
        for lid, slot in self.lm_slot_of.items():
            lm = self.lmanager.db.get(lid)
            if lm is None:
                continue
            lms.append(lm)
            slots.append(slot)
            fids.append(lm.anchor.frame_id)
            cids.append(lm.anchor.cam_id)
            rays.append(lm.anchor.ray)
        if lms and e.landmark_param == "pos3d":
            T, ok = cam_pose.lookup(fids, np.asarray(cids))
            pos = lm_pos[np.asarray(slots)].astype(np.float64)
            inv_d = 1.0 / np.maximum(np.linalg.norm(pos - T[:, :3], axis=1), 1e-6)
            for k, lm in enumerate(lms):
                lm.position = pos[k]
                lm.flag = ESTIMATED
                if ok[k]:
                    lm.inv_dep = float(inv_d[k])
        elif lms:
            T, ok = cam_pose.lookup(fids, np.asarray(cids))
            invd = inv_dep[np.asarray(slots)]
            R = np_lie.quat_to_rotmat_batch(T[:, 3:])
            pc = np.asarray(rays) / np.maximum(invd[:, None], 1e-12)
            pos = T[:, :3] + np.einsum("nij,nj->ni", R, pc)
            good = ok & (invd > 1e-6)
            for k, lm in enumerate(lms):
                lm.inv_dep = float(invd[k])
                if good[k]:
                    lm.position = pos[k]
                    lm.flag = ESTIMATED
        self.lmanager.outlier_rejection(
            cam_pose, e.focal_length, e.outlier_reproject_px
        )

    def _manage_window(self):
        if len(self.frames) < self.layout.W:
            return
        # reference clearUselessFrames: drop the second-newest non-keyframe,
        # else marginalize the oldest keyframe
        if not self.frames[-2].is_keyframe:
            self._drop_frame(len(self.frames) - 2, marginalize_it=False)
        else:
            self._drop_frame(0, marginalize_it=True)

    def _drop_frame(self, slot: int, marginalize_it: bool = False):
        """Take ``slot`` out of the window; with ``marginalize_it``, its
        information goes into the prior first (unless the last solve's
        fused step did that already)."""
        frame = self.frames[slot]
        if marginalize_it and self._fused_marg_slot == slot:
            marginalize_it = False
        self._fused_marg_slot = None
        if marginalize_it and self.solve_count > 0 and self._last_meas is not None:
            if self._meas_stale:
                # slots moved since the measurements were built (several
                # drops in one cycle of the SOLVE_ALL pool): rebuild so the
                # marginalized rows index live slots
                self._last_meas = self._build_measurements()
                self._meas_stale = False
            imu, proj = self._last_meas
            remove = torch.zeros(self.layout.W, dtype=torch.bool, device=self.device)
            remove[slot] = True
            with self.perf.stage("marginalize"):
                kw = self._solver_kw
                self.prior = marginalize(
                    self.layout, self._fej_marg_state(), imu, proj, self.prior, remove,
                    gravity=kw["gravity"], proj_sqrt_info=kw["proj_sqrt_info"],
                    dep_sqrt_info=kw["dep_sqrt_info"], huber_delta=kw["huber_delta"],
                    landmark_param=kw["landmark_param"],
                    remove_base_mode=kw["remove_base_mode"])
            self.margin_count += 1
        self.lmanager.pop_frame(frame.frame_id, self._cam_pose_of())
        del self.frames[slot]
        slot_map = list(range(self.layout.W))
        del slot_map[slot]
        slot_map.append(-1)
        self._apply_slot_map(slot_map)

    def _fej_marg_state(self) -> VIOState:
        """The state a marginalization linearizes at: the frames the prior
        carries at their first estimates (reference
        replacetoPrevLinearizedPoints, prior_factor.cpp:183+) when FEJ is on."""
        prior = self.prior
        if not self.cfg.estimator.enable_fej or prior is None:
            return self.state
        carried = prior.lin.frame_valid[:, None]
        return self.state._replace(
            poses=torch.where(carried, prior.lin.poses, self.state.poses),
            sb=torch.where(carried, prior.lin.sb, self.state.sb))

    def _apply_slot_map(self, slot_map):
        poses = self._np(self.state.poses)
        sb = self._np(self.state.sb)
        fv = self._np(self.state.frame_valid)
        new_poses, new_sb, new_fv = poses.copy(), sb.copy(), fv.copy()
        new_fej_p, new_fej_sb = self.fej_poses.copy(), self.fej_sb.copy()
        for new, old in enumerate(slot_map):
            if old < 0:
                new_poses[new] = [0, 0, 0, 0, 0, 0, 1]
                new_sb[new] = 0
                new_fv[new] = False
            else:
                new_poses[new] = poses[old]
                new_sb[new] = sb[old]
                new_fv[new] = fv[old]
                new_fej_p[new] = self.fej_poses[old]
                new_fej_sb[new] = self.fej_sb[old]
        self.state = self.state._replace(
            poses=self._t(new_poses), sb=self._t(new_sb),
            frame_valid=self._t(new_fv, torch.bool),
        )
        self.fej_poses, self.fej_sb = new_fej_p, new_fej_sb
        self._meas_stale = True
        # compose the shift into the prior's pending permutation (the
        # consensus duals are keyed by frame id: nothing to move there)
        sm = np.asarray(slot_map, np.int64)
        if self._pending_perm is None:
            self._pending_perm = sm
        else:
            prev = self._pending_perm
            self._pending_perm = np.where(sm >= 0, prev[np.clip(sm, 0, None)], -1)

    def move_all_poses(self, T: np.ndarray, drone_id: Optional[int] = None) -> None:
        """Left-compose the rigid transform ``T`` [7] onto every window pose
        (those of ``drone_id`` only, when given): the reference-frame shift
        of a map merge (reference D2State::moveAllPoses, d2state.hpp:8-125,
        and PriorFactor::moveByPose, prior_factor.cpp:92+).

        Velocities rotate with ``T``, and so do FEJ states, the prior's
        linearization point and the landmark positions anchored in moved
        frames. The prior moves exactly: rotation tangents are local and
        stay, position and velocity differences are world-frame, so those
        prior columns are right-multiplied by R_T^T, on the prior's device.
        ``T`` should be yaw-only (4-DoF), as the reference's map merge: a
        full rotation would break the gravity alignment of the IMU factors.
        """
        T = np.asarray(T, np.float64)
        R = np_lie.quat_to_rotmat(T[3:])
        moved = [w for w, f in enumerate(self.frames)
                 if drone_id is None or f.drone_id == drone_id
                 or (f.drone_id < 0 and drone_id == self.cfg.self_id)]
        if not moved:
            return

        def shift(poses, sb):
            for w in moved:
                poses[w] = np_lie.pose_compose(T, poses[w])
                sb[w, :3] = R @ sb[w, :3]

        poses = self._np(self.state.poses).astype(np.float64)
        sb = self._np(self.state.sb).astype(np.float64)
        shift(poses, sb)
        self.state = self.state._replace(poses=self._t(poses), sb=self._t(sb))
        shift(self.fej_poses, self.fej_sb)

        if self._prior is not None:
            prior = self.prior          # pending window shifts applied
            self._pending_perm = None
            lin = prior.lin
            cols = torch.as_tensor(
                [15 * w + c + k for w in moved for c in (0, 6) for k in range(3)],
                device=prior.J.device)
            Rt = torch.as_tensor(R.T, dtype=prior.J.dtype, device=prior.J.device)
            J = prior.J.clone()
            J[:, cols] = (J[:, cols].reshape(J.shape[0], -1, 3) @ Rt).reshape(J.shape[0], -1)
            rows = torch.as_tensor(moved, device=lin.poses.device)
            Tt = torch.as_tensor(T, dtype=lin.poses.dtype, device=lin.poses.device)
            lp, ls = lin.poses.clone(), lin.sb.clone()
            lp[rows] = lie.pose_compose(Tt.expand(len(moved), 7), lin.poses[rows])
            ls[rows, :3] = ls[rows, :3] @ Rt.to(ls.dtype)
            self._prior = prior._replace(J=J, lin=lin._replace(poses=lp, sb=ls))

        # stored landmark positions anchored in moved frames
        moved_fids = {self.frames[w].frame_id for w in moved}
        for lm in self.lmanager.db.values():
            if lm.obs and lm.anchor.frame_id in moved_fids and lm.position is not None:
                lm.position = np_lie.pose_apply(T, lm.position)
        self._meas_stale = True

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def latest_odometry(self, stamp: Optional[float] = None) -> Optional[Odometry]:
        if not self.frames:
            return None
        w = self._last_self_slot()
        return Odometry(
            stamp=self.frames[w].stamp if stamp is None else stamp,
            pose=self._np(self.state.poses[w]),
            vel=self._np(self.state.sb[w, :3]),
        )

    def imu_propagated_odometry(self, t: float) -> Optional[Odometry]:
        """The JAX package's name for ``predict_odometry(t, from_first_frame=True)``
        (reference inputImu publishing path, d2estimator.cpp:57-72)."""
        return self.predict_odometry(t, from_first_frame=True)

    def predict_odometry(self, t: Optional[float] = None, *,
                         from_first_frame: bool = False) -> Optional[Odometry]:
        """IMU-rate odometry: the newest own frame's state propagated
        through the buffered IMU up to ``t`` (default: the latest IMU
        sample) (reference d2estimator.cpp:57-72). It answers once the
        estimator is initialized, and at or before the frame's stamp
        gives the frame's odometry; ``from_first_frame`` answers from
        the first frame on and stamps the result ``t`` always."""
        if not (self.frames if from_first_frame else self.initialized):
            return None
        w = self._last_self_slot()
        t_end = float(t) if t is not None else self.imubuf.t_last
        if t_end <= self.frames[w].stamp and not from_first_frame:
            return self.latest_odometry()
        pose, vel = self._propagate(w, t_end)
        return Odometry(stamp=t_end, pose=self._np(pose), vel=self._np(vel))
