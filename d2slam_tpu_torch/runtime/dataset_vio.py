"""Replay a dataset through the full stack and report the trajectory.

Counterpart of ``examples/run_dataset_vio.py``: an EuRoC-ASL directory
(EuRoC MAV, TUM-VI, the writer of ``utils/euroc_writer.py``) or a ROS1
``.bag`` goes through a ``D2SLAMSystem`` (SuperPoint tracker, VIO
estimator, loop detection, PGO), by default behind the two-thread
``PipelinedSystem`` with the extraction lookahead, and the keyframe
trajectory is compared with the dataset's ground truth when it has one.

    python -m d2slam_tpu_torch.runtime.dataset_vio <dataset_root or .bag>
        [--cpu] [--serial] [--frames N] [--stride K]
        [--fx F --fy F --cx C --cy C] [--baseline B] [--camchain YAML]
        [--sp-weights superpoint.npz | --random-weights]
        [--netvlad-weights netvlad.npz] [--out traj.csv]

A missing SuperPoint weights file raises; random weights only when asked
for (``random_weights=True``, ``--random-weights``): their keypoints are
repeatable but not 3D-consistent, good for a smoke run only.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.datasets import EuRoCDataset, RosbagReader
from d2slam_tpu_torch.frontend import superpoint
from d2slam_tpu_torch.frontend.loop_detector import LoopDetectorConfig
from d2slam_tpu_torch.frontend.tracker import TrackerConfig
from d2slam_tpu_torch.geometry.cameras import PinholeParams
from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
from d2slam_tpu_torch.runtime.threaded import PipelinedSystem
from d2slam_tpu_torch.utils.device import resolve_device
from d2slam_tpu_torch.utils.evaluation import ate_rmse, write_trajectory_csv
from d2slam_tpu_torch.utils.sim import default_extrinsics


def _intrinsics(img0, chain, fx, fy, cx, cy, ds):
    """camchain > arguments > the dataset's sensor.yaml > a guess from
    the image size."""
    H, W = img0.shape[:2]
    if chain is not None:
        p = chain[0].params
        return float(p.fx), float(p.fy), float(p.cx), float(p.cy)
    if fx:
        return fx, fy or fx, cx or W / 2, cy or H / 2
    calib = (ds.calib.get("cam0") or {}) if ds is not None else {}
    intr = calib.get("intrinsics") or []
    if len(intr) >= 4:
        return tuple(float(v) for v in intr[:4])
    print(f"(no intrinsics found; guessing fx={0.9 * W:.0f})")
    return 0.9 * W, 0.9 * W, W / 2, H / 2


def run_dataset_vio(
    root_or_bag: str,
    *,
    frames: int = 0,
    stride: int = 1,
    fx: float = 0.0, fy: float = 0.0, cx: float = 0.0, cy: float = 0.0,
    baseline: float = 0.1,
    camchain: str = "",
    extrinsic_type: int = 0,
    sp_weights: str = "",
    random_weights: bool = False,
    sp_cfg: Optional[superpoint.SuperPointConfig] = None,
    cfg: Optional[D2Config] = None,
    sys_cfg: Optional[SystemConfig] = None,
    tracker_cfg: Optional[TrackerConfig] = None,
    loop_cfg: Optional[LoopDetectorConfig] = None,
    imu_topic: str = "/imu0",
    cam_topics: Sequence[str] = ("/cam0/image_raw", "/cam1/image_raw"),
    out: str = "",
    device=None,
    pipelined: bool = True,
) -> dict:
    """Replay ``root_or_bag`` (an EuRoC-ASL directory, or a path ending in
    ``.bag``). EuRoC images are decoded ahead by the native prefetcher.

    ``cfg`` defaults to ``D2Config()`` with the focal length of the
    chosen intrinsics and 256 IMU samples per interval; ``sp_cfg`` to
    200 keypoints at threshold 1e-4; ``sys_cfg`` to ``SystemConfig()``.
    ``frames`` stops after that many frames (0 = all). ``device``
    defaults to ``cuda``.

    Returns a dict: ``stamps`` and ``poses`` [N, 7] of the VIO keyframes,
    ``frames``, ``keyframes``, ``ate_m`` (4-DoF aligned ATE against
    ground truth, None without it), ``wall_s``, ``system`` (the
    ``D2SLAMSystem``)."""
    dev = resolve_device(device)
    ds = bag = None
    if root_or_bag.endswith(".bag"):
        bag = RosbagReader(root_or_bag)
        first = next((m for _, _, m in bag.read_messages([cam_topics[0]])), None)
        if first is None or first.get("image") is None:
            raise ValueError(f"no decodable images on {cam_topics[0]} in {root_or_bag}")
        img0 = np.asarray(first["image"])
        frame_dt = 0.05
        events = bag.play_vio(imu_topic, list(cam_topics))
    else:
        ds = EuRoCDataset(root_or_bag)
        if not ds.frames:
            raise ValueError(f"no frames found under {root_or_bag}")
        img0 = ds.load_image_u8(ds.frames[0][1][0])
        frame_dt = (ds.frames[-1][0] - ds.frames[0][0]) / max(len(ds.frames) - 1, 1)
        events = ds.play(frame_stride=stride, prefetch=True, as_uint8=True)

    chain = None
    if camchain:
        from d2slam_tpu_torch.geometry.kalibr import load_camchain

        chain = load_camchain(camchain, extrinsic_type)
    fx, fy, cx, cy = _intrinsics(img0, chain, fx, fy, cx, cy, ds)
    if cfg is None:
        cfg = D2Config()
        cfg.estimator.focal_length = fx
        cfg.estimator.max_imu_samples = 256
    sp_cfg = sp_cfg or superpoint.SuperPointConfig(max_keypoints=200, threshold=1e-4)
    if sp_weights:
        if not os.path.exists(sp_weights):
            raise FileNotFoundError(f"SuperPoint weights {sp_weights} not found")
        sp_params = superpoint.load_params(sp_weights)
    elif random_weights:
        sp_params = superpoint.random_params(0, sp_cfg)
    else:
        raise ValueError("no SuperPoint weights given: pass sp_weights, or "
                         "random_weights=True for a smoke run")
    if chain is not None:
        ext = np.stack([c.extrinsic for c in chain[:2]])
        cams = list(chain[:2]) if len(chain) > 1 else [chain[0]] * 2
    else:
        ext = default_extrinsics(baseline)
        cams = [PinholeParams.make(fx, fy, cx, cy) for _ in range(2)]

    sys_cfg = sys_cfg or SystemConfig()
    if sys_cfg.netvlad_weights and not os.path.exists(sys_cfg.netvlad_weights):
        raise FileNotFoundError(f"NetVLAD weights {sys_cfg.netvlad_weights} not found")
    system = D2SLAMSystem(cfg, sys_cfg, ext, cams, sp_params=sp_params, sp_cfg=sp_cfg,
                          tracker_cfg=tracker_cfg, loop_cfg=loop_cfg,
                          frame_rate=1.0 / max(frame_dt * stride, 1e-3), device=dev)
    node = PipelinedSystem(system) if pipelined else system

    n_frames = 0
    t0 = time.perf_counter()
    try:
        for ev in events:
            if ev[0] == "imu":
                node.input_imu(ev[1], ev[2], ev[3])
                continue
            _, t, imgs = ev
            node.input_stereo(t, imgs[0], imgs[1] if len(imgs) > 1 else imgs[0])
            n_frames += 1
            if n_frames == frames:
                break
        if pipelined:
            node.drain()
    finally:
        if pipelined:
            node.close()
        system.close()
    if system.sys.enable_pgo:
        system.solve_pgo()   # the last keyframes join the graph
    wall = time.perf_counter() - t0

    stamps, poses = system.trajectory(optimized=False)
    if out and len(stamps):
        write_trajectory_csv(out, stamps, poses)
    ate = None
    if ds is not None and ds.ground_truth is not None and len(stamps) > 3:
        ate, _ = ate_rmse(stamps, poses, ds.ground_truth[:, 0], ds.ground_truth[:, 1:8])
    return dict(stamps=stamps, poses=poses, frames=n_frames, keyframes=len(stamps),
                ate_m=ate, wall_s=wall, system=system)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--serial", action="store_true", help="no frontend/backend threads")
    ap.add_argument("--frames", type=int, default=0, help="stop after N frames (0 = all)")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--fx", type=float, default=0.0)
    ap.add_argument("--fy", type=float, default=0.0)
    ap.add_argument("--cx", type=float, default=0.0)
    ap.add_argument("--cy", type=float, default=0.0)
    ap.add_argument("--baseline", type=float, default=0.1)
    ap.add_argument("--camchain", default="", help="kalibr camchain YAML (cameras + "
                    "imu-cam extrinsics; overrides --fx/--baseline)")
    ap.add_argument("--extrinsic-type", type=int, default=0,
                    help="camchain T_cam_imu convention (reference extrinsic_parameter_type)")
    ap.add_argument("--sp-weights", default="")
    ap.add_argument("--random-weights", action="store_true",
                    help="random SuperPoint weights (smoke run only)")
    ap.add_argument("--netvlad-weights", default="")
    ap.add_argument("--no-loops", action="store_true", help="no loop detection or PGO")
    ap.add_argument("--out", default="")
    ap.add_argument("--imu-topic", default="/imu0")
    ap.add_argument("--cam-topics", nargs="+", default=["/cam0/image_raw", "/cam1/image_raw"])
    args = ap.parse_args(argv)
    sys_cfg = SystemConfig(netvlad_weights=args.netvlad_weights)
    if args.no_loops:
        sys_cfg = dataclasses.replace(sys_cfg, enable_loop_detection=False, enable_pgo=False)
    res = run_dataset_vio(
        args.root, frames=args.frames, stride=args.stride, fx=args.fx, fy=args.fy,
        cx=args.cx, cy=args.cy, baseline=args.baseline, camchain=args.camchain,
        extrinsic_type=args.extrinsic_type, sp_weights=args.sp_weights,
        random_weights=args.random_weights, sys_cfg=sys_cfg, imu_topic=args.imu_topic,
        cam_topics=args.cam_topics, out=args.out, device="cpu" if args.cpu else None,
        pipelined=not args.serial)
    system = res["system"]
    print(f"processed {res['frames']} frames, {res['keyframes']} keyframes, "
          f"{system.estimator.solve_count} solves, {len(system.loop_edges)} loops, "
          f"{system.pgo_solve_count} PGO solves in {res['wall_s']:.1f} s")
    print(system.estimator.perf.summary())
    if args.out and res["keyframes"]:
        print(f"trajectory -> {args.out}")
    if res["ate_m"] is not None:
        print(f"ATE-RMSE (4-DoF aligned): {res['ate_m']:.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
