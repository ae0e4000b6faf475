"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root

Drives the port (``d2slam_tpu_torch``) only, with SuperPoint in bf16 so
the hand-written stem kernel is on the path:

  (a) builds every kernel from ``d2slam_tpu_torch/csrc`` and holds each
      against its plain PyTorch version on the card, at the shapes the
      main path gives it; times kernel, plain version and the one-call
      library yardstick, and computes the bound from the shapes;
  (b) the golden stereo VIO scenario (CircleSim seed 7, 240x320, the
      trained weights in weights/superpoint_synth.npz, 16 frames), with
      the bf16 backbone (stem kernel) and the f32 backbone: asserts the
      keyframe count, ATE < 0.03 m and the median track length;
  (c) the main path at full width: 480x640, the default estimator and
      SuperPoint configurations, 24 frames; the kernel launch counts of
      this run go into the ``kernels`` line.

Every phase prints one line; any failure exits non-zero. The last two
lines are the ``kernels`` JSON and the device JSON; the line before
them is the card's name and power limit from nvidia-smi.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this script "
          "needs an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from d2slam_tpu_torch.config import D2Config  # noqa: E402
from d2slam_tpu_torch.frontend import lk  # noqa: E402
from d2slam_tpu_torch.frontend.superpoint import (  # noqa: E402
    SuperPoint,
    SuperPointConfig,
    load_params,
)
from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig  # noqa: E402
from d2slam_tpu_torch.geometry.cameras import PinholeParams  # noqa: E402
from d2slam_tpu_torch.ops import superpoint_stem as stem  # noqa: E402
from d2slam_tpu_torch.utils import np_lie  # noqa: E402
from d2slam_tpu_torch.utils.render import render_blobs  # noqa: E402
from d2slam_tpu_torch.utils.sim import CircleSim  # noqa: E402
from d2slam_tpu_torch.vins.estimator import D2Estimator  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights", "superpoint_synth.npz")
PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
# kernel vs plain version: bf16 output, so two bf16 ulps relative plus
# a small absolute floor (the conv1a activation may round across one
# bf16 boundary where the two sum in a different order)
STEM_ATOL, STEM_RTOL = 0.02, 0.016
# golden-scenario ATE pin, both backbones: the JAX package's 0.03 m
# (tests/test_golden_image_vio.py)
GOLDEN_ATE = 0.03


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def phase_kernels(params, dev):
    """(a) build, check and time the stem kernel."""
    t0 = time.perf_counter()
    stem.build()
    build_s = time.perf_counter() - t0
    wts = stem.pack_stem_weights(params["conv1a"]["w"], params["conv1a"]["b"],
                                 params["conv1b"]["w"], params["conv1b"]["b"], device=dev)
    k1 = torch.as_tensor(params["conv1a"]["w"]).permute(3, 2, 0, 1).to(dev, torch.bfloat16)
    k2 = torch.as_tensor(params["conv1b"]["w"]).permute(3, 2, 0, 1).to(dev, torch.bfloat16)
    b1 = wts.b1
    b2 = wts.b2
    rng = np.random.default_rng(0)
    rows = {}
    for (B, H, W) in [(2, 34, 50), (2, 240, 320), (2, 480, 640)]:
        img = torch.as_tensor(rng.uniform(0, 1, (B, H, W)).astype(np.float32), device=dev)
        out = stem.superpoint_stem(img, wts)
        ref = stem.stem_plain(img, *wts)
        torch.cuda.synchronize()
        o, r = out.float(), ref.float()
        if not torch.isfinite(o).all():
            fail(f"stem kernel output not finite at {B}x{H}x{W}")
        err = (o - r).abs()
        bad = int((err > STEM_ATOL + STEM_RTOL * r.abs()).sum())
        max_err = float(err.max())
        if bad:
            fail(f"stem kernel disagrees with stem_plain at {B}x{H}x{W}: "
                 f"{bad} elements out of tolerance, max |err| {max_err}")
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
        {"build_s": build_s, "tolerance": f"|k-p| <= {STEM_ATOL} + {STEM_RTOL}*|p|",
         "stem": rows}), flush=True)
    return rows


def run_sequence(params, dev, H, W, fx, n_frames, cfg, sp_cfg, tr_cfg, n_landmarks):
    """Stereo VIO over the CircleSim scenario; returns the metrics."""
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=n_landmarks)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    cams = [PinholeParams.make(fx, fx, W / 2, H / 2) for _ in range(2)]
    model = SuperPoint(params, sp_cfg, device=dev)
    tracker = FeatureTracker(model, sp_cfg, cams, tr_cfg, frame_rate=sim.frame_hz)
    est = D2Estimator(cfg, sim.ext, device=dev)
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    # warm the extraction once (cuDNN plans, the kernel's first load) and
    # build the native LK, so per-frame times are steady-state; the warm
    # launch is not counted
    tracker.extract(np.zeros((2, H, W), np.float32))
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
                             fx, fx, W / 2, H / 2, H, W, intensities=inten)
                for c in range(2)]
        ff = tracker.process_stereo(t, k, imgs[0], imgs[1])
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


def golden_config():
    """Estimator config of tests/test_golden_image_vio.py:46-53."""
    cfg = D2Config()
    e = cfg.estimator
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 128
    e.max_solve_measurements = 512
    e.max_imu_samples = 128
    e.max_solver_iters = 5
    e.focal_length = 220.0
    return cfg


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    params = load_params(WEIGHTS)
    kernel_rows = phase_kernels(params, dev)

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

    big = kernel_rows["2x480x640"]
    kernels = [{
        "name": "superpoint_stem",
        "route": "cuda",
        "source": "d2slam_tpu_torch/csrc/superpoint_stem.cu",
        "replaces": "d2slam_tpu/ops/superpoint_stem_pallas.py:51",
        "launches": res["stem_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows.values()),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
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
