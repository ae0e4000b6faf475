"""The depth replay cell: a recorded quadcam stream replayed through the
port's ``DepthReplay.run`` (producer, inference worker on its own CUDA
stream, publisher, over queues of two frames) as fast as it takes the
frames.

The stream is a pool of distinct uint8 frames of four fisheyes, each a
textured cylinder wall drawn from the seed, rendered before the window
and cycled through it: the path keeps no state between frames. The
replay is called once a bag of ``bag_frames`` frames, as a user replays
a recording: the call returns the clouds of every frame of the bag, so
their host memory grows through the bag and is freed at its end. A
frame is complete when its four point clouds are published on the
caller's thread.

The check: the clouds of frames of the window drawn from the seed
against the plain reference on the same images (remap tables worked
out again from the fisheye parameters, block matching, points).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from d2slam_tpu_torch.depth import quadcam
from d2slam_tpu_torch.depth.quadcam import QuadcamConfig, build_virtual_stereo
from d2slam_tpu_torch.geometry.cameras import KBParams
from d2slam_tpu_torch.ops import stereo_bm
from d2slam_tpu_torch.runtime.depth_replay import DepthReplay
from portbench.reference import compare
from portbench.reference import depth as ref_depth
from portbench.yardstick import geometry, work
from portbench.yardstick.render import Fisheye, cylinder_wall, to_u8, wall_texture


class State:
    pass


def setup(cell) -> State:
    cfg, tr, dev, probes = cell.config, cell.traffic, cell.device, cell.probes
    st = State()
    st.cell = cell
    if dev.type == "cuda":
        stereo_bm.build()
    cell.parts.mark("kernels")

    d = cfg["depth"]
    Hf, Wf = cfg["fisheye_hw"]
    fe = cfg["fisheye"]
    st.fisheyes = [Fisheye(fe["fx"], fe["fy"], fe["cx"], fe["cy"], k2=fe["k2"])] * 4
    st.ext = geometry.fisheye_ring_extrinsics(cfg["fisheye_baseline_m"])
    st.qcfg = QuadcamConfig(out_hw=tuple(d["out_hw"]), virtual_fov_deg=d["virtual_fov_deg"],
                            max_disp=d["max_disp"], block=d["block"], min_z=d["min_z"],
                            max_z=d["max_z"])
    pairs = build_virtual_stereo([KBParams.make(*f) for f in st.fisheyes], st.ext, st.qcfg,
                                 device=dev)
    st.replay = DepthReplay(pairs, st.qcfg, device=dev)
    cell.parts.mark("tables")

    gen = torch.Generator(device=dev).manual_seed(cell.seed)
    tex = wall_texture(gen, tr["pool_frames"], dev)
    imgs = cylinder_wall(st.fisheyes, st.ext, (Hf, Wf), tex, tr["wall_radius_m"])
    st.pool = to_u8(imgs, rounding="round").cpu().numpy()       # [P, 4, Hf, Wf]
    del tex, imgs
    cell.parts.mark("render")

    probes.span(st.replay, "_infer", "depth_infer")
    N = len(pairs)
    H, W = st.qcfg.out_hw
    probes.kernel_range(quadcam, "disparity", "disparity",
                        lambda args: work.disparity_min_s(N, H, W, st.qcfg.max_disp,
                                                          st.qcfg.block))
    # warm-up: frames through the same replay, every first call behind it
    t = time.perf_counter()
    st.replay.run([(st.pool[k % len(st.pool)], None) for k in range(tr["warmup_frames"])])
    st.warm_s = round(time.perf_counter() - t, 3)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    cell.parts.mark("warmup")
    return st


def window(st, seconds: float, dtrace) -> dict:
    tr, probes = st.cell.traffic, st.cell.probes
    P = len(st.pool)
    rng = np.random.default_rng(st.cell.seed)
    S = tr["check_frames"]
    kept = {}            # a uniform sample of the published frames (reservoir)
    entered, latency = [], []
    n_pub = 0
    probes.active = st.cell.trace
    t0 = time.perf_counter()
    t_end = t0 + seconds
    if dtrace is not None:
        dtrace.start()

    def frames(n):
        for _ in range(n):
            if time.perf_counter() >= t_end:
                return
            k = len(entered)
            entered.append(time.perf_counter())
            yield st.pool[k % P], None

    def publish(i, clouds):
        nonlocal n_pub
        t = time.perf_counter()
        k = base + i
        if t <= t_end:
            probes.complete(t)
            latency.append((t, t - entered[k]))
        n_pub += 1
        if len(kept) < S:
            kept[k] = clouds
        else:
            j = int(rng.integers(0, n_pub))
            if j < S:
                kept.pop(sorted(kept)[j])
                kept[k] = clouds
        if dtrace is not None and dtrace.due():
            dtrace.stop()

    bags = 0
    while time.perf_counter() < t_end:
        base = len(entered)
        st.replay.run(frames(tr["bag_frames"]), publish=publish)
        bags += 1
    if dtrace is not None:
        dtrace.stop()
    probes.active = False
    st.kept = kept
    return dict(t0=t0, attempted=len(entered), failed=len(entered) - n_pub,
                stats=dict(latency_s=latency,
                           frame_work_s=work.disparity_min_s(len(st.pool[0]), *st.qcfg.out_hw,
                                                             st.qcfg.max_disp, st.qcfg.block)),
                notes=[f"warm-up of {tr['warmup_frames']} frames took {st.warm_s} s; "
                       f"{len(entered)} frames entered the replay in {bags} bags of at most "
                       f"{tr['bag_frames']}, {len(latency)} published in the window"])


def check(st, window):
    """The numbers compared against the cell's limits."""
    cell, q = st.cell, st.qcfg
    dtype = torch.bfloat16 if cell.control else torch.float32
    pairs = ref_depth.virtual_pairs(st.fisheyes, st.ext, q.out_hw, q.virtual_fov_deg, cell.device)
    st.replay = None
    gaps = dict(valid_mismatch=0.0 if st.kept else 1.0, depth_off=0.0 if st.kept else 1.0)
    for k, clouds in sorted(st.kept.items()):
        z = np.stack([c[0][..., 2] for c in clouds])
        valid = np.stack([c[1] for c in clouds])
        ref_z, ref_valid = ref_depth.frame_depth(st.pool[k % len(st.pool)], pairs, q.max_disp,
                                                 q.block, q.min_z, q.max_z, cell.device)
        if cell.control:
            z_low, valid_low = ref_depth.frame_depth(st.pool[k % len(st.pool)], pairs,
                                                     q.max_disp, q.block, q.min_z, q.max_z,
                                                     cell.device, dtype)
            z, valid = z_low.float().cpu().numpy(), valid_low.cpu().numpy()
        g = compare.depth_gaps(torch.as_tensor(z), torch.as_tensor(valid), ref_z, ref_valid)
        for key in gaps:
            gaps[key] = max(gaps[key], g[key])
    return gaps
