"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root

Drives the port (``d2slam_tpu_torch``) only, with SuperPoint in bf16 so
the hand-written stem kernel is on the path:

  (a) builds every kernel from ``d2slam_tpu_torch/csrc`` (one compiler
      per source, all started together) and holds each against its plain
      PyTorch version on the card, at the shapes the main paths give it
      and at ragged ones (sides that are no multiple of a kernel's tile,
      narrower than a tile, a single image; the stem twice back to back
      on different data); times kernel, plain version and, where one
      PyTorch call computes the same function, that call, computes the
      bound from the shapes, and reports each kernel's registers and
      stack from cuobjdump;
  (b) the golden stereo VIO scenario (CircleSim seed 7, 240x320, the
      trained weights in weights/superpoint_synth.npz, 16 frames), with
      the bf16 backbone (stem kernel) and the f32 backbone: asserts the
      keyframe count, ATE < 0.03 m and the median track length;
  (c) the main path at full width: 480x640, the default estimator and
      SuperPoint configurations, 24 frames;
  (d) quadcam depth at full width: 4 Kannala-Brandt fisheyes 480x640
      around a textured cylinder wall -> 4 virtual stereo pairs 240x320
      -> block-matching kernel (max_disp 64, block 9) -> coloured point
      clouds, 6 frames; asserts the wall's depth, the disparity RMS
      against the analytic wall at the JAX package's golden set-up, and
      two kernel launches per frame; one frame through the HitNet option;
  (e) quadcam VIO: 4 outward 240x320 views per frame through the
      multi-view tracker (one stem launch for the 4 views) into the
      estimator, 16 frames: asserts >= 10 keyframes and ATE < 0.25 m;
  (f) the single-robot ``D2SLAMSystem`` at full width: the scene of (c)
      through ``input_stereo`` with NetVLAD (weights/netvlad_synth.npz)
      fused into the extraction, loop detection with PnP verification,
      PCM and the dense pose-graph solve every 5 keyframes, one lap of
      the circle and 17 frames more (the places of the lap's start
      again): asserts one stem launch and one NetVLAD pass per
      frame, >= 2 PGO solves, >= 1 loop kept by PCM, and a PGO
      trajectory no worse than the VIO one by more than 0.02 m;
  (g) the pose-graph solvers alone: dense LM at the system's default
      layout (256 poses, 1024 edges; 6-DoF and 4-DoF) and PCG on the
      10,000-pose spiral of examples/bench_pgo_scale.py, each against
      its own CPU result (relative final cost within 1e-3), with ms and
      kernel launches per solve; and the batched PnP against the host
      path on the correspondences of one of (f)'s loop queries;
  (h) dataset replay at EuRoC's format: the scene of (c) at 480x752
      (camera 20 Hz, IMU 200 Hz, 40 frames from rest) written once as an
      EuRoC-ASL directory and once as a ROS1 bag; (A) its uint8 frames
      fed serially to ``D2SLAMSystem.input_stereo``, (B)
      ``run_dataset_vio`` on the directory (native PNG prefetch, the
      two-thread ``PipelinedSystem`` with the extraction lookahead on a
      CUDA stream), (C) the bag's event stream against the directory's;
      asserts (B)'s keyframes, positions and loop-database descriptors
      against (A)'s, (B)'s ATE against the dataset's ground truth, one
      stem launch per frame in (A) and in (B), and (C) bit for bit;
  (i) the dynamic start: tests/test_estimator.py::
      test_dynamic_start_sfm_init's scenario on the card (mono, moving at
      the start, SFM initialization), with that test's pins; and the
      essential-matrix RANSAC on the card against the host path.

The native pipeline library and LK are built with the kernels in (a).
The launch counts of (c), (d), (e), (f) and (h) go into the ``kernels``
line: each count is set to 0 just before its path runs and read just
after.

Every phase prints one line; any failure exits non-zero. The last three
lines are the ``kernels`` JSON, the card's name and power limit from
nvidia-smi, and the device JSON.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this script "
          "needs an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from d2slam_tpu_torch.config import D2Config  # noqa: E402
from d2slam_tpu_torch.datasets import EuRoCDataset, RosbagReader, RosbagWriter  # noqa: E402
from d2slam_tpu_torch.frontend import lk  # noqa: E402
from d2slam_tpu_torch.frontend import loop_detector  # noqa: E402
from d2slam_tpu_torch.frontend.loop_detector import LoopDetectorConfig  # noqa: E402
from d2slam_tpu_torch.frontend.pnp import ransac_pnp_body  # noqa: E402
from d2slam_tpu_torch.frontend.superpoint import (  # noqa: E402
    SuperPoint,
    SuperPointConfig,
    load_params,
)
from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig  # noqa: E402
from d2slam_tpu_torch.geometry.cameras import KBParams, PinholeParams  # noqa: E402
from d2slam_tpu_torch.depth.fisheye_undist import remap_bilinear  # noqa: E402
from d2slam_tpu_torch.depth.hitnet import HitNetConfig, hitnet_apply, hitnet_init  # noqa: E402
from d2slam_tpu_torch.depth.quadcam import (  # noqa: E402
    QuadcamConfig,
    build_virtual_stereo,
    cloud_in_body,
    quadcam_depth,
)
from d2slam_tpu_torch.depth.stereo import (  # noqa: E402
    block_match_disparity,
    disparity,
    points_from_disparity,
)
from d2slam_tpu_torch.ops import stereo_bm as bm  # noqa: E402
from d2slam_tpu_torch.pgo import PGOEdges, PGOLayout, PGOState, solve_pgo, solve_pgo_pcg  # noqa: E402
from d2slam_tpu_torch.runtime import pipeline  # noqa: E402
from d2slam_tpu_torch.runtime.dataset_vio import run_dataset_vio  # noqa: E402
from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig  # noqa: E402
from d2slam_tpu_torch.ops import superpoint_stem as stem  # noqa: E402
from d2slam_tpu_torch.utils import np_lie  # noqa: E402
from d2slam_tpu_torch.utils.native import nvcc  # noqa: E402
from d2slam_tpu_torch.utils.render import (  # noqa: E402
    cylinder_wall_disparity,
    make_signatures,
    render_blobs,
    render_cylinder_wall,
)
from d2slam_tpu_torch.utils.sim import (  # noqa: E402
    CircleSim,
    fisheye_ring_extrinsics,
    quadcam_extrinsics,
)
from d2slam_tpu_torch.utils.euroc_writer import write_euroc_dataset  # noqa: E402
from d2slam_tpu_torch.utils.evaluation import ate_rmse  # noqa: E402
from d2slam_tpu_torch.utils.synthetic import (  # noqa: E402
    replay_events,
    spiral_pose_graph,
    stereo_replay_sequence,
)
from d2slam_tpu_torch.vins.estimator import D2Estimator  # noqa: E402
from d2slam_tpu_torch.vins.initialization import solve_relative_pose  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights", "superpoint_synth.npz")
NETVLAD_WEIGHTS = os.path.join(REPO, "weights", "netvlad_synth.npz")
PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
# non-fused f32 instructions/s: half the data sheet's 67 TFLOP/s, which
# counts a fused multiply-add as two
PEAK_F32_OPS = 33.5e12
# block matcher, kernel vs plain version (same order of summation, so a
# cost differs by rounding of the compiler's choices at most): integer
# winners equal on 99.9 % of the pixels; where equal, costs and
# sub-pixel disparity within these
BM_AGREE, BM_COST_ATOL, BM_DISP_ATOL = 0.999, 1e-5, 1e-3
# kernel vs plain version: bf16 output, so two bf16 ulps relative plus
# a small absolute floor (the conv1a activation may round across one
# bf16 boundary where the two sum in a different order)
STEM_ATOL, STEM_RTOL = 0.02, 0.016
# golden-scenario ATE pin, both backbones: the JAX package's 0.03 m
# (tests/test_golden_image_vio.py)
GOLDEN_ATE = 0.03
# quadcam pins of the JAX package: image-level quadcam VIO ATE
# (tests/test_golden_quadcam_image.py), disparity RMS against the
# analytic wall (tests/test_golden_ate.py), wall depth (tests/test_quadcam.py)
GOLDEN_QUADCAM_IMAGE_ATE = 0.25
GOLDEN_QUADCAM_DISP_RMS = 0.35
WALL_RADIUS, WALL_DEPTH_RANGE = 5.0, (3.0, 7.5)
# phase f: the PGO trajectory may be worse than the VIO one by this much
# at most (m); phase g: card and CPU solves agree on the final cost
PGO_ATE_SLACK = 0.02
PGO_COST_RTOL = 1e-3
# phase f: one lap of the circle and the first 17 places again. After
# CircleSim's 1 s speed ramp a lap takes 108.6 frames (omega 0.5 rad/s at
# 8 Hz); frames 109-125 revisit the places of frames 3-24 within
# 0.06-1.4 degrees of heading
SYSTEM_FRAMES = 126
# phase f's loop gates, below the defaults' 15 matches and 25 inliers: a
# view of this scene holds ~53 SuperPoint keypoints, and its blobs look
# alike to the matcher, so the ratio test keeps ~12-23 matches between
# two views of one place, about half of them right (a CPU count against
# the rendered ground truth, at 0.1-1.2 degrees apart)
LOOP_CFG = dict(min_match_per_dir=8, min_inliers=8)
# phase h: EuRoC's image size, camera and IMU rates; 40 frames from rest.
# Gates fixed before the first run: (B) against (A) on the keyframes'
# positions (m) and their loop-database descriptors, (B)'s ATE (m)
EUROC_H, EUROC_W, EUROC_FX = 480, 752, 440.0
DATASET_FRAMES, DATASET_CAM_HZ, DATASET_IMU_HZ = 40, 20.0, 200
DATASET_POS_ATOL, DATASET_GDESC_ATOL, DATASET_ATE = 1e-3, 1e-5, 0.05
# phase i: tests/test_estimator.py::test_dynamic_start_sfm_init's pins
DYN_FRAMES, DYN_MIN_OUT, DYN_SPEED, DYN_SPEED_TOL, DYN_ATE = 16, 8, 2.5, 0.3, 0.25
# the essential-matrix RANSAC, card against host: rotation within (rad)
REL_POSE_ROT_TOL = 1e-3


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events).
    The launches queue up behind a spin of ~10 ms on the card, so that a
    kernel shorter than the host's time to launch it is still timed at the
    card's pace, not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stem_library(img, k1, b1, k2, b2):
    """Yardstick only (never called by the port): cuDNN bf16
    conv+ReLU x2 and max-pool, NCHW."""
    x = torch.relu(torch.nn.functional.conv2d(img[:, None].to(torch.bfloat16), k1, b1, padding=1))
    x = torch.relu(torch.nn.functional.conv2d(x, k2, b2, padding=1))
    return torch.nn.functional.max_pool2d(x, 2)


def kernel_resources(lib):
    """Registers, stack (spills) and static shared memory of each kernel
    in a built library, as ``cuobjdump --dump-resource-usage`` gives
    them. A toolkit without cuobjdump, or output without a kernel's
    line, fails the run: the no-spill claim must not vanish unseen."""
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        fail(f"no cuobjdump beside nvcc ({tool}): cannot read the kernels' registers and stack")
    text = subprocess.run([tool, "--dump-resource-usage", lib._name],
                          capture_output=True, text=True, check=True).stdout
    lines = [" ".join(f for f in line.split() if f.split(":")[0] in
                      ("REG", "STACK", "SHARED", "LOCAL"))
             for line in text.splitlines() if line.lstrip().startswith("REG:")]
    if not lines:
        fail(f"cuobjdump gave no resource line for {lib._name}")
    return lines


def phase_kernels(params, dev):
    """(a) build both kernels, then check and time the stem kernel."""
    t0 = time.perf_counter()
    # one compiler per source, all together: the two kernels (nvcc), the
    # native frame pipeline and LK (g++)
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(f) for f in (stem.build, bm.build, pipeline.build, lk.build)]
        libs = [job.result() for job in jobs][:2]
    build_s = time.perf_counter() - t0
    resources = dict(zip(("superpoint_stem", "stereo_bm"), map(kernel_resources, libs)))
    wts = stem.pack_stem_weights(params["conv1a"]["w"], params["conv1a"]["b"],
                                 params["conv1b"]["w"], params["conv1b"]["b"], device=dev)
    k1 = torch.as_tensor(params["conv1a"]["w"]).permute(3, 2, 0, 1).to(dev, torch.bfloat16)
    k2 = torch.as_tensor(params["conv1b"]["w"]).permute(3, 2, 0, 1).to(dev, torch.bfloat16)
    b1 = wts.b1
    b2 = wts.b2
    rng = np.random.default_rng(0)
    rows = {}
    # ragged shapes: sides that are no multiple of the kernel's 16x16
    # tile, one narrower than a tile, a single image, fewer tiles than SMs
    for (B, H, W) in [(2, 34, 50), (1, 38, 10), (3, 50, 70), (1, 240, 320), (2, 240, 320),
                      (4, 240, 320), (2, 480, 640), (2, EUROC_H, EUROC_W)]:
        # two launches back to back on different data: a persistent kernel
        # must leave nothing behind
        imgs = [torch.as_tensor(rng.uniform(0, 1, (B, H, W)).astype(np.float32), device=dev)
                for _ in range(2)]
        outs = [stem.superpoint_stem(im, wts) for im in imgs]
        refs = [stem.stem_plain(im, *wts) for im in imgs]
        torch.cuda.synchronize()
        max_err = 0.0
        for call, (out, ref) in enumerate(zip(outs, refs)):
            o, r = out.float(), ref.float()
            if not torch.isfinite(o).all():
                fail(f"stem kernel output not finite at {B}x{H}x{W}, call {call}")
            err = (o - r).abs()
            bad = int((err > STEM_ATOL + STEM_RTOL * r.abs()).sum())
            max_err = max(max_err, float(err.max()))
            if bad:
                fail(f"stem kernel disagrees with stem_plain at {B}x{H}x{W}, call {call}: "
                     f"{bad} elements out of tolerance, max |err| {max_err}")
        img = imgs[0]
        row = dict(shape=[B, H, W], max_abs_err=max_err)
        if H >= 240:
            flops = stem.stem_flops(B, H, W)
            nbytes = stem.stem_bytes(B, H, W)
            t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
            row.update(
                ms=time_ms(lambda: stem.superpoint_stem(img, wts)),
                plain_ms=time_ms(lambda: stem.stem_plain(img, *wts), iters=20),
                library_ms=time_ms(lambda: stem_library(img, k1, b1, k2, b2)),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6,
            )
        rows[f"{B}x{H}x{W}"] = row
    print("phase a (kernel check): " + json.dumps(
        {"build_s": build_s, "resources": resources,
         "tolerance": f"|k-p| <= {STEM_ATOL} + {STEM_RTOL}*|p|",
         "stem": rows}), flush=True)
    return rows


def textured_pairs(N, H, W, shift, dev, seed):
    """N rectified pairs [N, H, W] on the card: a smoothed random
    texture, the right view shifted by ``shift`` px, plus noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.rand((N, 1, H, W + 64), generator=g, device=dev)
    for _ in range(2):
        base = torch.nn.functional.avg_pool2d(base, 3, stride=1, padding=1)
    base = base[:, 0]
    left = base[..., 16:16 + W].contiguous()
    right = base[..., 16 + shift:16 + shift + W]
    right = right + 0.01 * torch.randn(right.shape, generator=g, device=dev)
    return left, right.contiguous()


def bm_compare(out, ref, region, what):
    """Kernel outputs against the plain version's on one region: the
    fraction of equal winners and the largest error where they agree."""
    (kd, kb, kc, ks), (pd, pb, pc, ps) = ([x[region] for x in o] for o in (out, ref))
    same = kb == pb
    agree = int(same.sum()) / same.numel()   # exact: 1.0 only if all are equal
    errs = {n: float((a - b).abs()[same].max()) if bool(same.any()) else 0.0
            for n, a, b in (("cost", kc, pc), ("second", ks, ps), ("disp", kd, pd))}
    if not all(bool(torch.isfinite(x).all()) for x in (kd, kc, ks)):
        fail(f"stereo_bm output not finite ({what})")
    if (agree < BM_AGREE or errs["cost"] > BM_COST_ATOL
            or errs["second"] > BM_COST_ATOL or errs["disp"] > BM_DISP_ATOL):
        fail(f"stereo_bm disagrees with bm_plain ({what}): winners agree on "
             f"{agree:.6f}, max errors {errs}")
    return agree, max(errs.values())


def phase_bm_kernel(dev):
    """(a, block matcher) check the kernel against ``bm_plain`` at every
    listed shape, forward and reverse, the border columns on their own;
    time it at the frame's shapes."""
    rows = {}
    # 2x102x250: neither side a multiple of the kernel's tile (4 rows x 88
    # columns there); the small ones run the other block sizes' halos
    cases = [(1, 37, 70, 24, 7, 5), (2, 102, 250, 32, 9, 6), (1, 20, 64, 8, 1, 2),
             (1, 26, 90, 16, 5, 3), (1, 30, 130, 17, 15, 4),
             (4, 240, 320, 64, 9, 10), (8, 240, 320, 64, 9, 10),
             (1, 480, 640, 64, 9, 10), (1, 800, 1280, 64, 9, 10)]
    for seed, (N, H, W, D, block, shift) in enumerate(cases):
        left, right = textured_pairs(N, H, W, shift, dev, seed)
        r = block // 2
        row = dict(shape=[N, H, W], max_disp=D, block=block, agree=1.0, max_abs_err=0.0)
        for reverse in (False, True):
            a, b = (right, left) if reverse else (left, right)
            out = bm.stereo_bm(a, b, D, block, reverse)
            ref = bm.bm_plain(a, b, D, block, reverse)
            torch.cuda.synchronize()
            for name, region in (("all", np.s_[...]), ("right r columns", np.s_[..., -r:]),
                                 ("left max_disp columns", np.s_[..., :D])):
                agree, err = bm_compare(out, ref, region,
                                        f"{N}x{H}x{W} reverse={reverse} {name}")
                row["agree"] = min(row["agree"], agree)
                row["max_abs_err"] = max(row["max_abs_err"], err)
        if (H, W) == (240, 320):
            t_ops = bm.bm_ops(N, H, W, D, block) / PEAK_F32_OPS * 1e3
            t_bytes = bm.bm_bytes(N, H, W) / PEAK_BYTES * 1e3
            row.update(
                ms=time_ms(lambda: bm.stereo_bm(left, right, D, block)),
                plain_ms=time_ms(lambda: bm.bm_plain(left, right, D, block), iters=3, warmup=1),
                # no single PyTorch call computes this function; the two
                # whole matchers (both passes and the checks) side by side
                # are the honest comparison
                fused_ms=time_ms(lambda: bm.block_match_disparity_fused(left, right, D, block)),
                cost_volume_ms=time_ms(lambda: block_match_disparity(left, right, D, block),
                                       iters=10, warmup=2),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gop=bm.bm_ops(N, H, W, D, block) / 1e9,
                mbytes=bm.bm_bytes(N, H, W) / 1e6,
            )
        rows[f"{N}x{H}x{W}"] = row
    print("phase a (stereo_bm kernel check): " + json.dumps(
        {"tolerance": f"winners equal on >= {BM_AGREE:.1%} of the pixels; where equal, "
                      f"|cost|, |second| <= {BM_COST_ATOL}, |disp| <= {BM_DISP_ATOL}",
         "stereo_bm": rows}), flush=True)
    return rows


def run_sequence(params, dev, H, W, fx, n_frames, cfg, sp_cfg, tr_cfg, n_landmarks,
                 quadcam=False):
    """VIO over the CircleSim scenario, with the stereo rig or (``quadcam``)
    the ring of 4 outward views; returns the metrics."""
    if quadcam:
        sim = CircleSim(seed=7, n_landmarks=n_landmarks, extrinsics=quadcam_extrinsics(),
                        fov_cos=0.5)
    else:
        sim = CircleSim(seed=7, baseline=0.2, n_landmarks=n_landmarks)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    # distinctive appearance per landmark, for the cross-view association
    sigs = make_signatures(len(sim.lms), seed=9) if quadcam else None
    n_cams = len(sim.ext)
    cams = [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(n_cams)]
    model = SuperPoint(params, sp_cfg, device=dev)
    tracker = FeatureTracker(model, sp_cfg, cams, tr_cfg, frame_rate=sim.frame_hz,
                             extrinsics=sim.ext)
    est = D2Estimator(cfg, sim.ext, device=dev)
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    # warm the extraction once (cuDNN plans, the kernel's first load) and
    # build the native LK, so per-frame times are steady-state; the warm
    # launch is not counted
    tracker.extract(np.zeros((n_cams, H, W), np.float32))
    lk.build()
    torch.cuda.synchronize()
    stem.launches = 0

    errs, align, t_prev, n_kf, est_ms, poses, prof = [], None, 0.0, 0, [], [], None
    t_run = time.perf_counter()
    for k in range(n_frames):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        pose_gt, _ = sim.gt_pose(t)
        imgs = [render_blobs(sim.lms, np_lie.pose_compose(pose_gt, sim.ext[c]),
                             fx, fx, W / 2, H / 2, H, W, intensities=inten, signatures=sigs)
                for c in range(n_cams)]
        ff = (tracker.process_quadcam(t, k, imgs) if quadcam
              else tracker.process_stereo(t, k, imgs[0], imgs[1]))
        if ff is None:
            continue
        if k == n_frames - 1 and est.solve_count:
            # the last keyframe runs under the profiler (kept out of
            # the per-keyframe times): where the estimator's time goes
            od, prof = profile_estimator(est, ff)
        else:
            t0 = time.perf_counter()
            od = est.input_frame(ff)
            torch.cuda.synchronize()
            est_ms.append((time.perf_counter() - t0) * 1e3)
        if od is None:
            continue
        n_kf += 1
        poses.append(od.pose)
        if align is None:
            align = np_lie.pose_compose(od.pose.astype(np.float64),
                                        np_lie.pose_inverse(pose_gt))
        errs.append(np.linalg.norm(od.pose[:3] - np_lie.pose_compose(align, pose_gt)[:3]))
    wall = time.perf_counter() - t_run
    launches = stem.launches
    rep = tracker.perf.report()
    tl = [lm.track_length() for lm in est.lmanager.db.values()]
    return dict(
        frames=n_frames, keyframes=n_kf, solves=est.solve_count,
        ate_m=float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan"),
        median_track=float(np.median(tl)) if tl else 0.0,
        finite=bool(poses) and bool(np.all(np.isfinite(np.asarray(poses)))),
        stem_launches=launches,
        extract_ms_per_frame=rep["extract"]["mean_ms"],
        extract_ms_median=rep["extract"]["p50_ms"],
        tracker_host_ms_per_frame=rep["host"]["mean_ms"],
        tracker_host_ms_median=rep["host"]["p50_ms"],
        estimator_ms_per_keyframe=float(np.mean(est_ms)) if est_ms else 0.0,
        estimator_ms_median=float(np.median(est_ms)) if est_ms else 0.0,
        estimator_ms_per_frame=float(np.sum(est_ms)) / n_frames,
        wall_s=wall,
        estimator_stages={k: v["mean_ms"] for k, v in est.perf.report().items()},
        estimator_profile=prof,
    )


def profile_estimator(est, ff):
    """One ``input_frame`` under torch.profiler: host time, summed
    device kernel time, kernel launches and the busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        od = est.input_frame(ff)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    ka = p.key_averages()
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in ka
                  if e.self_device_time_total > 0), reverse=True)
    return od, dict(
        host_ms_profiled=host_ms,
        device_ms=sum(d for d, _, _ in dev) / 1e3,
        launches=sum(e.count for e in ka if e.key.startswith("cudaLaunch")),
        top_kernels=[[k[:60], c, d / 1e3] for d, c, k in dev[:6]],
    )


def count_launches(fn):
    """Kernel launches of one ``fn()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in p.key_averages()
               if e.key.startswith(("cudaLaunch", "cuLaunch")))


def trajectory_ate(stamps, poses, sim):
    """ATE (RMSE, m) of keyframe positions against ground truth, aligned
    on the first keyframe (the pose graph's gauge)."""
    gts = [sim.gt_pose(t)[0] for t in stamps]
    align = np_lie.pose_compose(np.asarray(poses[0], np.float64), np_lie.pose_inverse(gts[0]))
    errs = [np.linalg.norm(p[:3] - np_lie.pose_compose(align, g)[:3])
            for p, g in zip(poses, gts)]
    return float(np.sqrt(np.mean(np.square(errs))))


def run_system(params, dev, H, W, fx, n_frames, n_landmarks=300):
    """(f) ``D2SLAMSystem.input_stereo`` over the CircleSim stereo scene
    of (c); returns the metrics and the PnP correspondences of the last
    loop query whose PnP found a pose."""
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=n_landmarks)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    cfg = D2Config()
    cfg.estimator.focal_length = fx
    cams = [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(2)]
    system = D2SLAMSystem(cfg, SystemConfig(netvlad_weights=NETVLAD_WEIGHTS), sim.ext, cams,
                          sp_params=params, sp_cfg=SuperPointConfig(compute_dtype="bfloat16"),
                          loop_cfg=LoopDetectorConfig(**LOOP_CFG), frame_rate=sim.frame_hz,
                          device=dev)
    nv = system.netvlad
    # warm the fused extraction once and build LK; not counted
    system.tracker.extract(np.zeros((2, H, W), np.float32))
    lk.build()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    pnp_args = {}

    def recording_pnp(*a, **k):
        T, inl = ransac_pnp_body(*a, **k)
        if T is not None:
            pnp_args["args"], pnp_args["kw"] = a, k
        return T, inl

    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        system.input_imu(t, a, g)
    loop_detector.ransac_pnp_body = recording_pnp
    stem.launches = 0
    nv.calls = 0
    t_prev, n_kf, t_run = 0.0, 0, time.perf_counter()
    try:
        for k in range(n_frames):
            t = k / sim.frame_hz
            if k:
                for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                    system.input_imu(ts, a, g)
            t_prev = t
            pose_gt, _ = sim.gt_pose(t)
            imgs = [render_blobs(sim.lms, np_lie.pose_compose(pose_gt, sim.ext[c]),
                                 fx, fx, W / 2, H / 2, H, W, intensities=inten)
                    for c in range(2)]
            n_kf += system.input_stereo(t, imgs[0], imgs[1]) is not None
        system.solve_pgo()   # the last keyframes join the graph
    finally:
        loop_detector.ransac_pnp_body = ransac_pnp_body
    wall = time.perf_counter() - t_run
    launches, nv_calls = stem.launches, nv.calls
    stamps, opt = system.trajectory()
    _, ego = system.trajectory(optimized=False)
    perf = system.perf.report()
    u8 = torch.zeros((1, H, W), dtype=torch.uint8, device=dev)
    res = dict(
        frames=n_frames, keyframes=n_kf, stem_launches=launches, netvlad_runs=nv_calls,
        gdesc_dim=system.sys.gdesc_dim,
        retrieval_queries=perf.get("loop_detect", {}).get("count", 0),
        loops_verified=len(system.loop_edges), loops_kept_by_pcm=system.loops_kept,
        loop_pairs=[[e.frame_id_a, e.frame_id_b, e.inliers] for e in system.loop_edges],
        pgo_solves=system.pgo_solve_count,
        pgo_ms_per_solve=perf.get("pgo_solve", {}).get("mean_ms", float("nan")),
        pgo_report=system.last_pgo_report._asdict() if system.last_pgo_report else None,
        loop_verification_ms_per_query=perf.get("loop_detect", {}).get("mean_ms", float("nan")),
        netvlad_ms_per_frame=(time_ms(lambda: nv(u8.float() / 255.0), iters=20)
                              if dev.type == "cuda" else float("nan")),
        ate_ego_m=trajectory_ate(stamps, ego, sim), ate_pgo_m=trajectory_ate(stamps, opt, sim),
        finite=bool(np.isfinite(opt).all() and np.isfinite(ego).all()),
        extract_ms_per_frame=system.tracker.perf.report()["extract"]["mean_ms"],
        tracker_host_ms_per_frame=system.tracker.perf.report()["host"]["mean_ms"],
        estimator_stages={k: v["mean_ms"] for k, v in system.estimator.perf.report().items()},
        ms_per_frame=wall * 1e3 / n_frames, wall_s=wall,
    )
    return res, pnp_args


def pgo_graph(n, E, dof, seed):
    """The spiral graph of ``spiral_pose_graph`` with 0.05 m of noise on
    its relative translations (so the optimum keeps a cost) and initial
    positions perturbed by 0.2 m (pose 0 exact and fixed), padded to
    ``E`` edges."""
    gt, edges = spiral_pose_graph(n, seed=seed, pos_noise=0.05)
    m = len(edges.i)
    E = E or m
    pad = E - m
    edges = PGOEdges(
        i=np.concatenate([edges.i, np.zeros(pad, np.int32)]),
        j=np.concatenate([edges.j, np.zeros(pad, np.int32)]),
        rel=np.concatenate([edges.rel, np.tile(np.eye(1, 7, 6, dtype=np.float32), (pad, 1))]),
        sqrt_info=np.concatenate([edges.sqrt_info, np.tile(np.eye(6, dtype=np.float32), (pad, 1, 1))]),
        valid=np.concatenate([edges.valid, np.zeros(pad, bool)]))
    init = gt.copy()
    init[1:, :3] += np.random.default_rng(seed).normal(0, 0.2, (n - 1, 3))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return (PGOLayout(n, E, dof), PGOState(poses=init.astype(np.float32), valid=np.ones(n, bool)),
            edges, fixed)


def phase_pgo(dev, pnp_args):
    """(g) the pose-graph solvers on the card against their CPU result,
    and the batched PnP against the host path."""
    rows = {}
    for name, n, E, dof, solver, kw in (
            ("dense_6dof_N256_E1024", 256, 1024, 6, solve_pgo, dict(max_iters=10)),
            ("dense_4dof_N256_E1024", 256, 1024, 4, solve_pgo, dict(max_iters=10)),
            ("pcg_6dof_N10000", 10000, None, 6, solve_pgo_pcg, dict(max_iters=8, cg_iters=100))):
        layout, state, edges, fixed = pgo_graph(n, E, dof, seed=1)

        def run(d):
            return solver(layout, state, edges, fixed, device=d, **kw)

        out, rep = run(dev)
        t0 = time.perf_counter()
        cpu_out, cpu_rep = run("cpu")
        cpu_s = time.perf_counter() - t0
        card, ref = out.poses.cpu().double().numpy(), cpu_out.poses.double().numpy()
        cost, cpu_cost = float(rep.final_cost), float(cpu_rep.final_cost)
        row = dict(poses=n, edges=layout.E, valid_edges=int(edges.valid.sum()),
                   initial_cost=float(rep.initial_cost), final_cost=cost, cpu_final_cost=cpu_cost,
                   cost_rel_diff=abs(cost - cpu_cost) / max(abs(cpu_cost), 1e-30),
                   accepted=int(rep.accepted), cpu_accepted=int(cpu_rep.accepted),
                   max_pos_diff_m=float(np.abs(card[:, :3] - ref[:, :3]).max()),
                   ms=time_ms(lambda: run(dev), iters=3, warmup=1),
                   launches=count_launches(lambda: run(dev)), cpu_s=cpu_s, **kw)
        rows[name] = row
        if not (np.isfinite(card).all() and row["cost_rel_diff"] <= PGO_COST_RTOL
                and cost < float(rep.initial_cost)):
            fail(f"PGO {name} on the card disagrees with its CPU result: {row}")
    pnp = None
    if "args" in pnp_args:
        a, k = pnp_args["args"], dict(pnp_args["kw"])
        k.pop("device", None)
        ransac_pnp_body(*a, device=dev, **k)   # warm: solver handles, first launches
        times = {}
        for path, dk in (("host", False), ("device", dev), ("device_2", dev), ("host_2", False)):
            t0 = time.perf_counter()
            T, inl = ransac_pnp_body(*a, device=dk, **k)
            times[path + "_ms"] = (time.perf_counter() - t0) * 1e3
            times[path + "_inliers"] = int(inl.sum())
        pnp = dict(correspondences=len(a[0]), iters=k.get("iters"), **times)
    res = dict(solvers=rows, pnp=pnp)
    print("phase g (PGO solvers and batched PnP): " + json.dumps(res), flush=True)
    return res


def dataset_config(fx):
    """Phase h's settings: ``D2Config()`` at focal ``fx``, the bf16
    SuperPoint, NetVLAD fused, loops and PGO on with phase f's gates."""
    cfg = D2Config()
    cfg.estimator.focal_length = fx
    return cfg, SystemConfig(netvlad_weights=NETVLAD_WEIGHTS), dict(
        sp_cfg=SuperPointConfig(compute_dtype="bfloat16"), loop_cfg=LoopDetectorConfig(**LOOP_CFG))


def write_bag(path, imu, frames):
    """The sequence as a ROS1 bag, messages in the order of the EuRoC
    stream (IMU up to a frame's stamp, then its two images)."""
    with RosbagWriter(path) as w:
        for ev in replay_events(imu, frames):
            if ev[0] == "imu":
                w.write_imu("/imu0", *ev[1:])
            else:
                for c, img in enumerate(ev[2]):
                    w.write_image(f"/cam{c}/image_raw", ev[1], img)


def compare_streams(euroc_events, bag_events):
    """(C): the same kinds of events in the same order, IMU values equal,
    stamps within 1 ns (the bag keeps seconds and nanoseconds apart),
    images equal bit for bit. Returns counts."""
    n_imu = n_frames = 0
    for a, b in zip(euroc_events, bag_events, strict=True):
        if a[0] != b[0] or abs(a[1] - b[1]) > 1e-9:
            fail(f"bag event {b[:2]} != EuRoC event {a[:2]}")
        if a[0] == "imu":
            n_imu += 1
            if not (np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])):
                fail(f"IMU sample at {a[1]} differs between the bag and the EuRoC files")
        else:
            n_frames += 1
            if not all(x.dtype == y.dtype == np.uint8 and np.array_equal(x, y)
                       for x, y in zip(a[2], b[2], strict=True)):
                fail(f"frame at {a[1]} differs between the bag and the EuRoC files")
    return dict(imu=n_imu, frames=n_frames)


def keyframe_table(system):
    """Keyframe ids, VIO poses [N, 7] and stamps, and the loop database's
    global descriptor of each keyframe id."""
    stamps, poses = system.trajectory(optimized=False)
    det = system.detector
    n = len(det.entries)
    gdesc = {int(f): det.gdesc[i] for i, f in enumerate(det._db_frame[:n])}
    return [m[1] for m in system._pgo_meta], poses, stamps, gdesc


def frame_times(system, wall, n_frames):
    """Host-clock times of one run: per frame, and the stages apart."""
    tr = system.tracker.perf.report()
    est = system.estimator.perf.report()
    sp = system.perf.report()
    return dict(
        ms_per_frame=wall * 1e3 / n_frames,
        submit_ms_per_frame=tr.get("submit", {}).get("mean_ms"),
        extract_ms_per_frame=tr["extract"]["mean_ms"],
        tracker_host_ms_per_frame=tr["host"]["mean_ms"],
        estimator_ms_per_keyframe=sum(v["mean_ms"] for v in est.values()),
        estimator_stages={k: v["mean_ms"] for k, v in est.items()},
        loop_detect_ms_per_query=sp.get("loop_detect", {}).get("mean_ms"),
        pgo_ms_per_solve=sp.get("pgo_solve", {}).get("mean_ms"),
        pgo_solves=system.pgo_solve_count)


def stem_beside_pgo(dev, system, wts):
    """The stem kernel's time at 2x480x752 on a stream of its own while
    another thread runs the system's pose-graph solve again and again
    (CUDA events, as ``time_ms``)."""
    img = torch.rand((2, EUROC_H, EUROC_W), generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev)
    stop = threading.Event()

    def load():
        while not stop.is_set():
            system.solve_pgo()

    th = threading.Thread(target=load)
    th.start()
    try:
        time.sleep(0.5)   # the solve is issuing kernels
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            ms = time_ms(lambda: stem.superpoint_stem(img, wts))
    finally:
        stop.set()
        th.join()
    return ms


def phase_dataset(params, dev):
    """(h) the dataset replay at EuRoC's format, serial against pipelined,
    and the bag's stream against the directory's."""
    H, W, fx = EUROC_H, EUROC_W, EUROC_FX
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=300, frame_hz=DATASET_CAM_HZ,
                    imu_hz=DATASET_IMU_HZ)
    imu, frames, gt = stereo_replay_sequence(sim, DATASET_FRAMES, H, W, fx)
    cams = [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(2)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        euroc, bag = os.path.join(tmp, "euroc"), os.path.join(tmp, "seq.bag")
        write_euroc_dataset(euroc, imu, frames, gt)
        write_bag(bag, imu, frames)
        streams = compare_streams(
            EuRoCDataset(euroc).play(as_uint8=True),
            RosbagReader(bag).play_vio("/imu0", ["/cam0/image_raw", "/cam1/image_raw"]))

        # (A) the uint8 frames straight into the system, serially
        cfg, sys_cfg, setup = dataset_config(fx)
        system = D2SLAMSystem(cfg, sys_cfg, sim.ext, cams, sp_params=params,
                              frame_rate=sim.frame_hz, device=dev, **setup)
        system.tracker.extract(np.zeros((2, H, W), np.float32))   # warm; not counted
        torch.cuda.synchronize()
        stem.launches = 0
        t0 = time.perf_counter()
        for ev in replay_events(imu, frames):
            if ev[0] == "imu":
                system.input_imu(*ev[1:])
            else:
                system.input_stereo(ev[1], *ev[2])
        system.solve_pgo()   # the last keyframes join the graph, as in (B)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches_a = stem.launches

        # (B) the directory through run_dataset_vio, pipelined
        cfg, sys_cfg, setup = dataset_config(fx)
        stem.launches = 0
        res = run_dataset_vio(euroc, fx=fx, baseline=0.2, sp_weights=WEIGHTS, cfg=cfg,
                              sys_cfg=sys_cfg, device=dev, pipelined=True, **setup)
        torch.cuda.synchronize()
        launches_b = stem.launches

    ids_a, poses_a, stamps_a, gd_a = keyframe_table(system)
    ids_b, poses_b, _, gd_b = keyframe_table(res["system"])
    gt_t = np.array([t for t, _ in gt])
    gt_p = np.stack([p for _, p in gt])
    ate_a, _ = ate_rmse(stamps_a, poses_a, gt_t, gt_p)
    same_ids = ids_a == ids_b
    pos_diff = float(np.abs(poses_a[:, :3] - poses_b[:, :3]).max()) if same_ids else float("inf")
    gdesc_diff = (max(float(np.abs(gd_a[f] - gd_b[f]).max()) for f in ids_a)
                  if same_ids and set(gd_a) == set(gd_b) == set(ids_a) else float("inf"))
    out = dict(
        frames=DATASET_FRAMES, shape=[2, H, W], streams=streams, keyframes=len(ids_a),
        same_keyframe_ids=same_ids, max_pos_diff_m=pos_diff, max_gdesc_diff=gdesc_diff,
        ate_serial_m=float(ate_a), ate_pipelined_m=res["ate_m"],
        loops=[len(system.loop_edges), len(res["system"].loop_edges)],
        stem_launches=[launches_a, launches_b],
        serial=frame_times(system, wall_a, DATASET_FRAMES),
        pipelined=frame_times(res["system"], res["wall_s"], DATASET_FRAMES),
        stem_ms_beside_pgo=stem_beside_pgo(dev, system, system.tracker.model.stem),
    )
    print("phase h (dataset replay 2x480x752, EuRoC dir and bag, serial vs pipelined): "
          + json.dumps(out), flush=True)
    if not same_ids or pos_diff > DATASET_POS_ATOL or gdesc_diff > DATASET_GDESC_ATOL:
        fail(f"pipelined replay differs from the serial run: ids {ids_a} / {ids_b}, "
             f"positions {pos_diff} m, descriptors {gdesc_diff}")
    if not (res["ate_m"] is not None and res["ate_m"] < DATASET_ATE):
        fail(f"pipelined replay ATE {res['ate_m']} m (pin {DATASET_ATE} m)")
    if launches_a != DATASET_FRAMES or launches_b != DATASET_FRAMES:
        fail(f"stem launches {launches_a} (serial) / {launches_b} (pipelined) "
             f"!= {DATASET_FRAMES} frames")
    if streams["frames"] != DATASET_FRAMES:
        fail(f"bag replay gave {streams['frames']} frames")
    return out


def essential_data():
    """tests/test_init_eval.py::test_essential_relative_pose's data: 60
    correspondences of a known relative pose, 6 of them outliers."""
    rng = np.random.default_rng(0)
    w = np.array([0.05, -0.1, 0.2])
    th = np.linalg.norm(w)
    R12 = np_lie.quat_to_rotmat(np.concatenate([np.sin(th / 2) * w / th, [np.cos(th / 2)]]))
    t12 = np.array([0.4, 0.1, -0.2])
    pts1 = np.concatenate([rng.uniform(-2, 2, (60, 2)), rng.uniform(4, 10, (60, 1))], axis=1)
    r1 = pts1 / np.linalg.norm(pts1, axis=1, keepdims=True)
    pts2 = (R12 @ pts1.T).T + t12
    r2 = pts2 / np.linalg.norm(pts2, axis=1, keepdims=True)
    r2[:6] = rng.normal(0, 1, (6, 3))
    r2[:6] /= np.linalg.norm(r2[:6], axis=1, keepdims=True)
    return r1, r2, R12


def phase_dynamic_start(dev):
    """(i) the SFM initialization of a drone moving at the start, and the
    essential-matrix RANSAC on the card against the host."""
    cfg = D2Config()   # the port's default dtype (float64)
    cfg.num_cams = 1
    e = cfg.estimator
    e.max_sld_win_size, e.min_solve_frames, e.max_lm_slots = 8, 4, 128
    e.max_solve_measurements, e.max_imu_samples, e.max_solver_iters = 512, 128, 5
    sim = CircleSim(dynamic_start=True)
    est = D2Estimator(cfg, sim.ext[:1], device=dev)
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    outs, first, t_prev, ms = [], None, 0.0, []
    for k in range(DYN_FRAMES):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        ff = sim.frame(k)
        ff.observations = ff.observations[:1]
        t0 = time.perf_counter()
        od = est.input_frame(ff)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if od is not None:
            first = k if first is None else first
            outs.append((np.asarray(od.pose, np.float64), sim.gt_pose(t)[0], od))
    ate = float("nan")
    if outs:
        align = np_lie.pose_compose(outs[0][1], np_lie.pose_inverse(outs[0][0]))
        ate = float(np.sqrt(np.mean([np.sum((np_lie.pose_compose(align, p)[:3] - g[:3]) ** 2)
                                     for p, g, _ in outs])))
    speed = float(np.linalg.norm(outs[-1][2].vel)) if outs else float("nan")

    r1, r2, R12 = essential_data()
    solve_relative_pose(r1, r2, thresh=1e-4, device=dev)   # warm: solver handles
    rel = {}
    for path, d in (("host", False), ("device", dev), ("device_2", dev), ("host_2", False)):
        t0 = time.perf_counter()
        R, _, inl = solve_relative_pose(r1, r2, thresh=1e-4, device=d)
        rel[path + "_ms"] = (time.perf_counter() - t0) * 1e3
        rel[path + "_inliers"] = int(inl.sum())
        rel.setdefault("R_" + path.split("_")[0], R)
    Rh, Rd = rel.pop("R_host"), rel.pop("R_device")
    rot = (float(np.arccos(np.clip((np.trace(Rh.T @ Rd) - 1) / 2, -1, 1)))
           if Rh is not None and Rd is not None else float("inf"))
    res = dict(initialized=est.initialized, first_initialized_frame=first, outputs=len(outs),
               speed_mps=speed, ate_m=ate, ms_per_frame=float(np.mean(ms)),
               relative_pose=dict(rotation_diff_rad=rot, **rel))
    print("phase i (dynamic start, SFM initialization, essential RANSAC): " + json.dumps(res),
          flush=True)
    if not (est.initialized and len(outs) >= DYN_MIN_OUT
            and abs(speed - DYN_SPEED) < DYN_SPEED_TOL and ate < DYN_ATE):
        fail(f"dynamic start out of its pins: {res}")
    if rel["host_inliers"] != rel["device_inliers"] or not rot < REL_POSE_ROT_TOL:
        fail(f"essential RANSAC on the card differs from the host: {res['relative_pose']}")
    return res


def golden_config(num_cams=2, lm_slots=128, measurements=512):
    """Estimator config of the JAX package's golden image tests
    (tests/test_golden_image_vio.py; with 4 cameras, 160 slots and 640
    measurements, tests/test_golden_quadcam_image.py)."""
    cfg = D2Config()
    cfg.num_cams = num_cams
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = lm_slots
    e.max_solve_measurements = measurements
    e.max_imu_samples = 128
    e.max_solver_iters = 5
    e.focal_length = 220.0
    return cfg


def golden_disparity_rms(dev):
    """Pair 0's disparity RMS against the analytic wall at the set-up
    and on the selection of the JAX package's golden test: fisheyes
    240x320 with f = 95, virtual views 120x160, max_disp 32, block 7."""
    ext = fisheye_ring_extrinsics(0.3)
    fish = [KBParams.make(95.0, 95.0, 160.0, 120.0, k2=0.005) for _ in range(4)]
    cfg = QuadcamConfig(out_hw=(120, 160), min_z=1.0, max_z=20.0, max_disp=32, block=7)
    pairs = build_virtual_stereo(fish, ext, cfg, device=dev)
    imgs = [render_cylinder_wall(fish[i], ext[i], (240, 320), WALL_RADIUS, seed=7)
            for i in range(4)]
    pts, ok = quadcam_depth(imgs, pairs, cfg, device=dev)[0]
    ok = ok.cpu().numpy()
    z = pts[..., 2].cpu().numpy()
    disp = np.where(ok, pairs[0].focal * pairs[0].baseline / np.maximum(z, 1e-6), 0.0)
    disp_gt = cylinder_wall_disparity(pairs[0].focal, pairs[0].baseline, ext[0], (120, 160),
                                      WALL_RADIUS)
    sel = ok & (disp > 0.5) & (disp_gt < cfg.max_disp - 1)
    sel[:, :8] = False  # left occlusion band
    rms = float(np.sqrt(np.mean((disp[sel] - disp_gt[sel]) ** 2))) if sel.any() else float("nan")
    return rms, float(sel.mean())


def phase_quadcam_depth(dev, n_frames=6):
    """(d) the quadcam depth path at full width."""
    rms, sel = golden_disparity_rms(dev)
    if not (sel > 0.3 and rms < GOLDEN_QUADCAM_DISP_RMS):
        fail(f"quadcam disparity RMS {rms} px on {sel:.2f} of the pixels "
             f"(pin {GOLDEN_QUADCAM_DISP_RMS} px on > 0.3)")

    HF, WF = 480, 640
    ext = fisheye_ring_extrinsics(0.3)
    fish = [KBParams.make(190.0, 190.0, WF / 2, HF / 2, k2=0.005) for _ in range(4)]
    cfg = QuadcamConfig(out_hw=(240, 320), min_z=1.0, max_z=20.0)
    pairs = build_virtual_stereo(fish, ext, cfg, device=dev)
    tints = np.array([[1.0, 0.6, 0.6], [0.6, 1.0, 0.6], [0.6, 0.6, 1.0], [1.0, 1.0, 0.6]],
                     np.float32)
    # a new wall texture every frame, rendered before the timed loop
    frames = []
    for k in range(n_frames):
        imgs = np.stack([render_cylinder_wall(fish[i], ext[i], (HF, WF), WALL_RADIUS, seed=k)
                         for i in range(4)])
        frames.append((imgs, imgs[..., None] * tints[:, None, None, :]))
    quadcam_depth(frames[0][0], pairs, cfg, color_images=frames[0][1], device=dev)  # warm
    torch.cuda.synchronize()

    bm.launches = 0
    medians, valid_share, n_points, frame_ms = [], [], 0, []
    for imgs, colors in frames:
        t0 = time.perf_counter()
        out = quadcam_depth(imgs, pairs, cfg, color_images=colors, device=dev)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        qualified = 0
        for k, (pts, ok, tex) in enumerate(out):
            share = float(ok.float().mean())
            valid_share.append(share)
            if (pts.shape != (240, 320, 3) or tex.shape != (240, 320, 3)
                    or not bool(torch.isfinite(pts[ok]).all())
                    or cloud_in_body(pairs[k], pts).shape != pts.shape):
                fail(f"quadcam pair {k}: bad cloud")
            if share < 0.05:
                continue
            med = float(pts[..., 2][ok].median())
            medians.append(med)
            if not WALL_DEPTH_RANGE[0] < med < WALL_DEPTH_RANGE[1]:
                fail(f"quadcam pair {k}: median depth {med} m outside {WALL_DEPTH_RANGE}")
            qualified += 1
            n_points += int(ok.sum())
        if not qualified:
            fail("no quadcam pair produced valid depth")
    launches = bm.launches
    if launches != 2 * n_frames:
        fail(f"stereo_bm launches {launches} != 2 x {n_frames} frames")

    # the frame's stages, timed apart on the last frame's tensors
    t0 = time.perf_counter()
    imgs, colors = (torch.as_tensor(x, device=dev) for x in frames[-1])
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    li, ri = [p.cam_left for p in pairs], [p.cam_right for p in pairs]
    maps_l = torch.stack([p.map_left for p in pairs])
    src = torch.cat([imgs[li], imgs[ri]] + [colors[li][..., c] for c in range(3)])
    maps = torch.cat([maps_l, torch.stack([p.map_right for p in pairs])] + [maps_l] * 3)
    views = remap_bilinear(src, maps)
    left, right = views[:4].contiguous(), views[4:8].contiguous()
    disp, valid = disparity(left, right, cfg.max_disp, cfg.block)
    stage_ms = dict(
        upload_ms=upload_ms, upload_mbytes=(imgs.nbytes + colors.nbytes) / 1e6,
        remap_ms=time_ms(lambda: remap_bilinear(src, maps), iters=20),
        disparity_ms=time_ms(lambda: disparity(left, right, cfg.max_disp, cfg.block), iters=20),
        points_ms=time_ms(lambda: points_from_disparity(
            disp, valid, pairs[0].focal, pairs[0].baseline, 160.0, 120.0, 1.0, 20.0), iters=20),
    )

    # one frame through the HitNet option (configuration network, seeded)
    hcfg = HitNetConfig()
    hparams = hitnet_init(torch.Generator().manual_seed(0), hcfg, device=dev)
    seen = {}

    def apply(p, lft, rgt):
        seen["disp"] = hitnet_apply(p, lft[..., None], rgt[..., None], hcfg)
        return seen["disp"]

    quadcam_depth(frames[0][0], pairs, cfg, hitnet=(apply, hparams), device=dev)
    hd = seen["disp"]
    if (hd.shape != (4, 240, 320) or not bool(torch.isfinite(hd).all())
            or float(hd.min()) < 0.0):
        fail(f"HitNet disparity: shape {tuple(hd.shape)}, min {float(hd.min())}")

    res = dict(frames=n_frames, bm_launches=launches, golden_disp_rms_px=rms,
               golden_selected=sel, median_depth_m=[min(medians), max(medians)],
               valid_share=[min(valid_share), max(valid_share)],
               points_per_frame=n_points / n_frames,
               frame_ms_mean=float(np.mean(frame_ms)), frame_ms_median=float(np.median(frame_ms)),
               hitnet_disp_max=float(hd.max()), **stage_ms)
    print("phase d (quadcam depth, 4 fisheyes 480x640 -> 4 pairs 240x320): "
          + json.dumps(res), flush=True)
    return res


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    params = load_params(WEIGHTS)
    kernel_rows = phase_kernels(params, dev)
    bm_rows = phase_bm_kernel(dev)

    res = {}
    for cdt in ("bfloat16", "float32"):
        sp_cfg = SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4,
                                  compute_dtype=cdt)
        res[cdt] = run_sequence(
            params, dev, 240, 320, 220.0, 16, golden_config(), sp_cfg,
            TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
            n_landmarks=150)
    print("phase b (golden 240x320, bf16 stem and f32 backbone): "
          + json.dumps(res), flush=True)
    for cdt, r in res.items():
        if (r["keyframes"] < 12 or not r["ate_m"] < GOLDEN_ATE or r["median_track"] < 6
                or not r["finite"]):
            fail(f"golden scenario ({cdt}) out of its pins: {r}")
    r = res["bfloat16"]
    if r["stem_launches"] != r["frames"]:
        fail(f"stem launches {r['stem_launches']} != frames {r['frames']}")

    sp_cfg = SuperPointConfig(compute_dtype="bfloat16")
    cfg = D2Config()
    cfg.estimator.focal_length = 440.0
    res = run_sequence(params, dev, 480, 640, 440.0, 24, cfg, sp_cfg,
                       TrackerConfig(), n_landmarks=300)
    print("phase c (full width 480x640, default configs): " + json.dumps(res), flush=True)
    if not res["finite"] or res["solves"] < 1:
        fail(f"full-width run: finite={res['finite']} solves={res['solves']}")
    if res["stem_launches"] != res["frames"]:
        fail(f"stem launches {res['stem_launches']} != frames {res['frames']}")

    depth = phase_quadcam_depth(dev)

    sp_cfg = SuperPointConfig(max_keypoints=150, threshold=0.010, nms_radius=4,
                              compute_dtype="bfloat16")
    quad = run_sequence(
        params, dev, 240, 320, 220.0, 16, golden_config(4, 160, 640), sp_cfg,
        TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
        n_landmarks=220, quadcam=True)
    print("phase e (quadcam VIO, 4 views 240x320, bf16 stem): " + json.dumps(quad), flush=True)
    if (quad["keyframes"] < 10 or not quad["ate_m"] < GOLDEN_QUADCAM_IMAGE_ATE
            or not quad["finite"]):
        fail(f"quadcam VIO out of its pins: {quad}")
    if quad["stem_launches"] != quad["frames"]:
        fail(f"stem launches {quad['stem_launches']} != frames {quad['frames']}")

    sysres, pnp_args = run_system(params, dev, 480, 640, 440.0, SYSTEM_FRAMES)
    print("phase f (D2SLAMSystem 480x640, NetVLAD fused, loops, PCM, PGO): "
          + json.dumps(sysres), flush=True)
    if (not sysres["finite"] or sysres["pgo_solves"] < 2 or sysres["loops_kept_by_pcm"] < 1
            or not sysres["ate_pgo_m"] <= sysres["ate_ego_m"] + PGO_ATE_SLACK):
        fail(f"single-robot system out of its pins: {sysres}")
    if sysres["stem_launches"] != sysres["frames"] or sysres["netvlad_runs"] != sysres["frames"]:
        fail(f"stem launches {sysres['stem_launches']} / NetVLAD runs {sysres['netvlad_runs']} "
             f"!= frames {sysres['frames']}")
    phase_pgo(dev, pnp_args)
    dataset = phase_dataset(params, dev)
    phase_dynamic_start(dev)

    big = kernel_rows["2x480x640"]
    euroc = kernel_rows[f"2x{EUROC_H}x{EUROC_W}"]
    frame = bm_rows["4x240x320"]   # the four pairs of a quadcam frame
    kernels = [{
        "name": "superpoint_stem",
        "route": "cuda",
        "source": "d2slam_tpu_torch/csrc/superpoint_stem.cu",
        "replaces": "d2slam_tpu/ops/superpoint_stem_pallas.py:51",
        "launches": (res["stem_launches"] + quad["stem_launches"] + sysres["stem_launches"]
                     + sum(dataset["stem_launches"])),
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows.values()),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        # the dataset replay's shape (phase h)
        f"at_2x{EUROC_H}x{EUROC_W}": {k: euroc[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")},
    }, {
        "name": "stereo_bm",
        "route": "cuda",
        "source": "d2slam_tpu_torch/csrc/stereo_bm.cu",
        "replaces": "d2slam_tpu/ops/stereo_bm_pallas.py:35",
        "launches": depth["bm_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in bm_rows.values()),
        "ms": frame["ms"],
        "plain_ms": frame["plain_ms"],
        "bound_ms": frame["bound_ms"],
        "bound_by": frame["bound_by"],
        "library_ms": None,   # no single PyTorch call computes it
    }]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
