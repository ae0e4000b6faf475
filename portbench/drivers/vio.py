"""The stereo VIO cells: a seeded flight's camera frames and IMU replayed
into the port's ``D2SLAMSystem`` as fast as it takes them (closed loop).

The frames go to ``PipelinedSystem(D2SLAMSystem).input_stereo`` /
``input_imu``, the path of ``runtime/dataset_vio.py``: extraction
lookahead on the caller's thread, estimator, loop detection and PGO on
the backend thread. Every frame of the pool is rendered from the
seed before the window; set-up also runs the flight's first frames
until the estimator has solved ``warmup_solves`` times (it has
marginalized by then) and PGO has solved ``warmup_pgo_solves`` times, so
that every code path's first call (cuDNN's plans, the kernels' first
loads, the solver's libraries) is behind it, and the window goes on from
there with the same objects.

A frame is complete when its processing has finished: a frame that is
not a keyframe once tracked, a keyframe once the estimator (and the
system's loop detection and PGO behind it) has taken it.

The check: SuperPoint's keypoints, and its descriptors at them, on
frames of the window drawn from the seed against the plain SuperPoint's
on the same images, and the keyframe odometry against the flight.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.frontend import lk, superpoint
from d2slam_tpu_torch.geometry.cameras import PinholeParams
from d2slam_tpu_torch.ops import superpoint_stem as stem
from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
from d2slam_tpu_torch.runtime.threaded import PipelinedSystem
from portbench.reference import compare
from portbench.reference import superpoint as ref_sp
from portbench.yardstick import geometry, work
from portbench.yardstick.flight import Circle, make_scene
from portbench.yardstick.render import render_blobs, to_u8


class State:
    pass


def _render_pool(cell, flight, scene, ext, H, W, fx, hz, n_frames):
    """[F, 2, H, W] uint8 host frames of the flight's first F frames."""
    poses = [geometry.pose_compose(flight.pose(k / hz), e)
             for k in range(n_frames) for e in ext]
    imgs = render_blobs(scene.landmarks, scene.intensity, np.stack(poses), fx, H, W,
                        cell.device)
    return to_u8(imgs).reshape(n_frames, len(ext), H, W).cpu().numpy()


def _frame_work_s(cfg, H, W, netvlad_path) -> float:
    """The least time the card could take for a frame's networks:
    SuperPoint on both views at its compute dtype's peak, NetVLAD (float32)
    on the left view, its widths read from its weights file."""
    sp_peak = (work.PEAK_BF16_FLOPS if cfg["superpoint"]["compute_dtype"] == "bfloat16"
               else work.PEAK_F32_FLOPS)
    nv = np.load(netvlad_path)
    widths = tuple(nv[k].shape[-1] for k in ("stem/w", "ds1/pw/w", "ds2/pw/w", "ds3/pw/w",
                                             "ds4/pw/w"))
    nv_flops = work.netvlad_flops(H, W, widths, nv["vlad_assign/w"].shape[-1],
                                  nv["pca/proj"].shape)
    return work.superpoint_flops(2, H, W) / sp_peak + nv_flops / work.PEAK_F32_FLOPS


def setup(cell) -> State:
    cfg, tr, dev, probes = cell.config, cell.traffic, cell.device, cell.probes
    st = State()
    st.cell = cell
    H, W = cfg["image_hw"]
    fx, hz = cfg["fx"], cfg["camera_hz"]
    ext = geometry.stereo_extrinsics(cfg["baseline_m"])
    st.hz = hz
    if dev.type == "cuda":
        stem.build()
    lk.build()
    cell.parts.mark("kernels")

    d2 = D2Config()
    d2.dtype = cfg["dtype"]
    d2.num_cams = len(ext)
    for k, v in cfg["estimator"].items():
        setattr(d2.estimator, k, v)
    sp = dict(cfg["superpoint"])
    sp_params = superpoint.load_params(cell.path(sp.pop("weights")))
    st.sp_cfg = superpoint.SuperPointConfig(**sp)
    sys_cfg = SystemConfig(netvlad_weights=cell.path(cfg["netvlad_weights"]), **cfg["system"])
    cams = [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in ext]
    system = D2SLAMSystem(d2, sys_cfg, ext, cams, sp_params=sp_params, sp_cfg=st.sp_cfg,
                          frame_rate=hz, device=dev)
    st.system = system
    st.ref_weights = ref_sp.load_weights(cell.path(cfg["superpoint"]["weights"]), dev)
    st.frame_work_s = _frame_work_s(cfg, H, W, cell.path(cfg["netvlad_weights"]))
    cell.parts.mark("weights")

    fl = tr["flight"]
    st.flight = Circle(radius=fl["radius_m"], omega=fl["omega_rad_s"], height=fl["height_m"])
    n_pool = tr["warmup_max_frames"] + int(math.ceil(tr["pool_frames_per_s"] * cell.seconds))
    turn = st.flight.angle((n_pool - 1) / hz)
    if turn > 2 * math.pi - math.pi / 2:
        raise ValueError(f"the pool's flight turns {turn:.2f} rad: it would come back to "
                         "places it saw; slow the flight or shorten the pool")
    scene = make_scene(cell.seed, tr["n_landmarks"])
    st.pool = _render_pool(cell, st.flight, scene, ext, H, W, fx, hz, n_pool)
    st.imu = st.flight.imu(-tr["imu_lead_s"], (n_pool - 1) / hz, cfg["imu_hz"])
    st.stamps = [k / hz for k in range(n_pool)]
    cell.parts.mark("render")

    # what the window produced, for the check: each frame's extraction
    # (device tensors, read after the window), and completion times
    st.extracted = {}
    st.done = {}
    st.k = 0
    st.imu_i = 0
    tracker, est = system.tracker, system.estimator
    node = PipelinedSystem(system, depth=cfg["lookahead_depth"])

    def on_submit(resolver, args):
        st.extracted[st.k] = resolver

    def on_tracked(ff, args):
        if ff is None:                 # not a keyframe: complete once tracked
            st.done[args[1]] = time.perf_counter()
            probes.complete(st.done[args[1]])

    probes.span(tracker, "submit_stereo_extraction", "frontend", after=on_submit)
    probes.span(tracker, "process_stereo", "frontend", after=on_tracked)
    run = node._run

    def run_item(item):                # a keyframe: complete once estimated
        run(item)
        if item.ff is not None:
            st.done[item.ff.frame_id] = time.perf_counter()
            probes.complete(st.done[item.ff.frame_id])

    node._run = run_item
    st.node = node
    probes.span(est, "input_frame", "estimator")
    probes.span(system, "solve_pgo", "pgo")
    probes.kernel_range(superpoint, "superpoint_stem", "stem",
                        lambda args: work.stem_min_s(*args[0].shape))

    # warm-up: the flight's first frames through the same objects
    while st.k < tr["warmup_max_frames"]:
        _feed(st)
        if (est.solve_count >= tr["warmup_solves"]
                and system.pgo_solve_count >= tr["warmup_pgo_solves"]):
            break
    st.node.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    st.warm_frames = st.k
    cell.parts.mark("warmup")
    return st


def _feed(st) -> None:
    """Frame ``st.k``: the IMU up to its stamp, then its images."""
    t = st.stamps[st.k]
    while st.imu_i < len(st.imu) and st.imu[st.imu_i][0] <= t + 1e-9:
        st.node.input_imu(*st.imu[st.imu_i])
        st.imu_i += 1
    imgs = st.pool[st.k]
    st.node.input_stereo(t, imgs[0], imgs[1])
    st.k += 1


def window(st, seconds: float, dtrace) -> dict:
    probes = st.cell.probes
    notes = []
    first = st.k
    sys0 = st.system
    solves0, pgo0 = sys0.estimator.solve_count, sys0.pgo_solve_count
    probes.active = st.cell.trace
    t0 = time.perf_counter()
    if dtrace is not None:
        dtrace.start()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        if st.k >= len(st.pool):
            notes.append(f"the pool's {len(st.pool)} frames ran out "
                         f"{time.perf_counter() - t0:.3f} s into the window")
            break
        _feed(st)
        if dtrace is not None and dtrace.due():
            dtrace.stop()
    fed = st.k - first
    if dtrace is not None:
        dtrace.stop()
    st.node.drain()
    probes.active = False
    st.system.close()
    st.node.close()
    st.window_frames = [k for k in range(first, st.k) if k in st.done and st.done[k] <= t_end]
    failed = sum(1 for k in range(first, st.k) if k not in st.done)
    notes.append(f"set-up ran {st.warm_frames} frames; {fed} frames fed in the window, "
                 f"{len(st.window_frames)} completed in it; estimator solves "
                 f"{sys0.estimator.solve_count - solves0}, PGO solves "
                 f"{sys0.pgo_solve_count - pgo0}, loops {len(sys0.loop_edges)}")
    return dict(t0=t0, attempted=fed, failed=failed, notes=notes,
                stats=dict(frame_work_s=st.frame_work_s))


def _program_extraction(st, k):
    """(kpts [V, K, 2], valid [V, K], desc [V, K, D]) host arrays."""
    out = st.extracted[k]().out
    return (out.kpts.float().cpu().numpy(), out.valid.cpu().numpy(),
            out.desc.float().cpu().numpy())


def check(st, window):
    """The numbers compared against the cell's limits."""
    cell, tr = st.cell, st.cell.traffic
    rng = np.random.default_rng(cell.seed)
    frames = st.window_frames
    sample = sorted(rng.choice(frames, size=min(tr["check_frames"], len(frames)),
                               replace=False).tolist()) if frames else []
    prog = {k: _program_extraction(st, k) for k in sample}
    stamps, poses = st.system.trajectory(optimized=False)
    st.extracted.clear()
    st.system = st.node = None
    sp = st.sp_cfg
    miss, gap = [], [2.0 if not sample else 0.0]
    for k in sample:
        img = torch.as_tensor(st.pool[k], device=cell.device)
        ref = ref_sp.extract(st.ref_weights, img, sp.max_keypoints, sp.nms_radius, sp.threshold)
        if cell.control:
            low = ref_sp.extract(st.ref_weights, img, sp.max_keypoints, sp.nms_radius,
                                 sp.threshold, precision="fp8")
            got = (low.kpts.cpu().numpy(), low.valid.cpu().numpy(), low.desc.cpu().numpy())
        else:
            got = prog[k]
        for v in range(len(img)):
            g = compare.keypoint_gaps(got[0][v], got[1][v], got[2][v], ref.kpts[v],
                                      ref.valid[v], ref.desc_map[v])
            miss.append(g["kp_miss"])
            gap.append(g["desc_gap"])
    # the widest over the sampled images
    gaps = dict(kp_miss=max(miss) if miss else 1.0, desc_gap=max(gap))
    in_window = {round(st.stamps[k], 9) for k in st.window_frames}
    sel = [i for i, t in enumerate(stamps) if round(float(t), 9) in in_window]
    if len(stamps) and sel:
        gaps["ate_m"] = compare.ate(stamps[sel], poses[sel], st.flight.pose, stamps[0], poses[0])
    else:
        gaps["ate_m"] = float("inf")
    return gaps
