"""Quadcam omnidirectional depth demo.

Counterpart of ``examples/run_quadcam_depth.py`` (the reference's
quadcam_depth_est/src/quadcam_depth_est_trt.cpp). Renders a textured
cylinder wall from a 4-fisheye rig (480x640 each), builds the 4 virtual
stereo pairs (240x320), runs disparity with the trained HitNet network
when ``--hitnet`` names its ONNX export, else with the hand-written
block-matching kernel (two launches per frame on the card), and reports
the recovered wall depth per pair. Then it replays frames through the
threaded raw / inference / publish stages of ``runtime/depth_replay.py``.

    python -m d2slam_tpu_torch.examples.run_quadcam_depth [--cpu]
    python -m d2slam_tpu_torch.examples.run_quadcam_depth --hitnet /path/to/hitnet.onnx
    python -m d2slam_tpu_torch.examples.run_quadcam_depth --save-viz /tmp/quadcam
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from d2slam_tpu_torch.depth.hitnet import load_trained_hitnet
from d2slam_tpu_torch.depth.quadcam import (
    QuadcamConfig,
    build_virtual_stereo,
    cloud_in_body,
    quadcam_depth,
)
from d2slam_tpu_torch.geometry.cameras import KBParams
from d2slam_tpu_torch.ops import stereo_bm
from d2slam_tpu_torch.runtime.depth_replay import DepthReplay
from d2slam_tpu_torch.utils.device import resolve_device
from d2slam_tpu_torch.utils.render import render_cylinder_wall
from d2slam_tpu_torch.utils.sim import fisheye_ring_extrinsics

HF, WF, R_WALL = 480, 640, 5.0
# frames of the threaded replay (the JAX script's counts on an
# accelerator and on the CPU)
REPLAY_FRAMES_CARD, REPLAY_FRAMES_CPU = 6, 3
# RGB texture: each camera's gray render tinted, so the coloured-cloud
# path (the reference's publishThread RGB clouds) runs end to end
TINTS = np.array([[1.0, 0.6, 0.6], [0.6, 1.0, 0.6], [0.6, 0.6, 1.0], [1.0, 1.0, 0.6]],
                 np.float32)


def make_rig():
    """4 outward Kannala-Brandt fisheyes at 90 deg steps, 0.3 m apart."""
    fisheyes = [KBParams.make(190.0, 190.0, WF / 2, HF / 2, k2=0.005) for _ in range(4)]
    return fisheyes, fisheye_ring_extrinsics(0.3)


def pairwise_hitnet(net):
    """A trained HitNet (one pair per call) as ``quadcam_depth``'s
    ``hitnet = (apply, params)`` over the frame's [P, H, W] pairs."""
    def apply(model, left, right):
        return torch.stack([model(lft, rgt) for lft, rgt in zip(left, right)])
    return apply, net


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--hitnet", default=None,
                    help="trained HitNet ONNX export (default: block matching)")
    ap.add_argument("--save-viz", default=None, help="directory for disparity colormap PNGs")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    print(f"device: {dev}")
    fisheyes, ext = make_rig()
    cfg = QuadcamConfig(out_hw=(240, 320), min_z=1.0, max_z=20.0)
    pairs = build_virtual_stereo(fisheyes, ext, cfg, device=dev)
    imgs = np.stack([render_cylinder_wall(fisheyes[i], ext[i], (HF, WF), R_WALL)
                     for i in range(4)])
    colors = imgs[..., None] * TINTS[:, None, None, :]

    hitnet = None
    if args.hitnet:
        print(f"disparity backend: trained HitNet ({args.hitnet})")
        hitnet = pairwise_hitnet(load_trained_hitnet(args.hitnet, device=dev))
    else:
        print("disparity backend: block matching kernel")

    launches0 = stereo_bm.launches
    t0 = time.perf_counter()
    out = quadcam_depth(imgs, pairs, cfg, hitnet=hitnet, color_images=colors, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    first_ms = (time.perf_counter() - t0) * 1000
    print(f"4-pair pipeline: {first_ms:.1f} ms (first frame)")

    n_cloud = 0
    per_pair = []
    for k, (pts, ok, tex) in enumerate(out):
        z = pts[..., 2].cpu().numpy()
        m = ok.cpu().numpy()
        med = float(np.median(z[m])) if m.any() else float("nan")
        body = cloud_in_body(pairs[k], pts)
        rgb = tex.cpu().numpy()[m]
        n_cloud += int(m.sum())
        per_pair.append(dict(valid=float(m.mean()), median_depth_m=med))
        print(f"pair {k} (cams {pairs[k].cam_left}-{pairs[k].cam_right}): "
              f"valid {m.mean() * 100:.0f}%  median depth {med:.2f} m "
              f"(wall radius {R_WALL} m)  rgb mean {rgb.mean(0).round(2)}")
        if body.shape != pts.shape:
            raise RuntimeError(f"pair {k}: body cloud {tuple(body.shape)} != {tuple(pts.shape)}")
    print(f"colored omnidirectional cloud: {n_cloud} points (body frame, per-point RGB)")

    # the threaded raw / inference / publish replay (reference
    # quadcam_depth_est_trt.hpp:32-43)
    n_frames = REPLAY_FRAMES_CARD if dev.type == "cuda" else REPLAY_FRAMES_CPU
    replay = DepthReplay(pairs, cfg, hitnet=hitnet, device=dev)
    t0 = time.perf_counter()
    done = replay.run([(imgs, colors)] * n_frames, timeout_s=120.0)
    dt = (time.perf_counter() - t0) / max(len(done), 1)
    print(f"pipelined replay: {len(done)}/{n_frames} frames, {dt * 1000:.1f} ms/frame steady-state")

    if args.save_viz:
        from d2slam_tpu_torch.utils.pngio import png_encode_rgb
        from d2slam_tpu_torch.utils.visualization import disparity_to_rgb

        os.makedirs(args.save_viz, exist_ok=True)
        for k, (pts, ok, _tex) in enumerate(out):
            z = pts[..., 2].cpu().numpy()
            f = pairs[k].focal * pairs[k].baseline
            disp = np.where(ok.cpu().numpy(), f / np.maximum(z, 1e-6), 0.0)
            rgb = disparity_to_rgb(disp, max_disp=float(disp.max() + 1e-6))
            with open(os.path.join(args.save_viz, f"disp_{k}.png"), "wb") as fh:
                fh.write(png_encode_rgb(rgb))
        print(f"saved disparity maps to {args.save_viz}")
    frames = 1 + len(done)
    print(json.dumps(dict(device=str(dev), backend="hitnet" if hitnet else "block_matching",
                          frames=frames, bm_launches=stereo_bm.launches - launches0, points=n_cloud,
                          pairs=per_pair, first_frame_ms=first_ms, replay_ms_per_frame=dt * 1000)))
    return 0 if len(done) == n_frames else 1


if __name__ == "__main__":
    sys.exit(main())
