"""Train the learned frontend on synthetic data and evaluate it:
SuperPoint (MagicPoint-style corners + homography descriptor pairs), the
compact NetVLAD head (contrastive) and, with ``--sg-steps``, the compact
SuperGlue matcher.

Counterpart of ``examples/train_frontend.py``. Saves
``superpoint_synth.npz`` / ``netvlad_synth.npz`` / ``superglue_synth.npz``
in the JAX package's layout (``SystemConfig(superpoint_weights=...)``
and both packages' ``load_weights`` read them) and prints:
  * detector reprojection consistency (px) across rendered 3D views;
  * loop recall@1 on rendered revisits with the trained NetVLAD
    embedding against the weight-free baseline;
  * matcher precision / recall on held-out pairs, SuperGlue against kNN.

    python -m d2slam_tpu_torch.examples.train_frontend --steps 2000 --nv-steps 800 \\
        --out weights/ [--sg-steps 1200] [--cpu]
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from d2slam_tpu_torch.frontend.netvlad import NetVLAD, NetVLADConfig, netvlad_cfg_from_params
from d2slam_tpu_torch.frontend.superpoint import SuperPoint, SuperPointConfig, superpoint_extract
from d2slam_tpu_torch.frontend.train_frontend import (
    calibrate_netvlad_gate,
    fit_netvlad_pca,
    load_weights,
    make_batch,
    random_homography,
    save_weights,
    train_netvlad,
    train_superpoint,
    warp_image,
)
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device
from d2slam_tpu_torch.utils.render import render_blobs


@torch.no_grad()
def eval_detector_consistency(params, cfg, device, n_pairs=12, seed=0):
    """Render textured-blob scenes from two nearby viewpoints, extract
    keypoints in both, associate them through the ground-truth
    projection, and report the median reprojection inconsistency (px)."""
    H, W = 240, 320
    FX = FY = 220.0
    CX, CY = W / 2, H / 2
    rng = np.random.default_rng(seed)
    model = SuperPoint(params, cfg, device=device)
    R_bc = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    q = np_lie.rotmat_to_quat(R_bc)
    errs = []

    def project(T, pts):
        pc = (pts - T[:3]) @ np_lie.quat_to_rotmat(T[3:])
        return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1), pc[:, 2]

    for _ in range(n_pairs):
        n_lm = 80
        ang = rng.uniform(0, 2 * np.pi, n_lm)
        rad = rng.uniform(9.0, 13.0, n_lm)
        lz = rng.uniform(0.5, 3.5, n_lm)
        pts_w = np.stack([rad * np.cos(ang), rad * np.sin(ang), lz], 1)
        inten = rng.uniform(0.5, 1.0, n_lm)
        T0 = np.concatenate([[0.0, 0, 0], q])
        T1 = np.concatenate([rng.normal(0, 0.05, 3), q])
        imgs = np.stack([render_blobs(pts_w, T, FX, FY, CX, CY, H, W, intensities=inten)
                         for T in (T0, T1)]).astype(np.float32)
        out = superpoint_extract(model, torch.as_tensor(imgs, device=model.device))
        k0, k1 = (out.kpts[i][out.valid[i]].cpu().numpy() for i in (0, 1))
        uv0, z0 = project(T0, pts_w)
        uv1, z1 = project(T1, pts_w)
        vis = ((z0 > 0.5) & (z1 > 0.5) & (uv0 > 8).all(1) & (uv0 < [W - 8, H - 8]).all(1)
               & (uv1 > 8).all(1) & (uv1 < [W - 8, H - 8]).all(1))
        for j in np.flatnonzero(vis):
            # a detected keypoint near the true corner in BOTH views?
            d0 = np.linalg.norm(k0 - uv0[j], axis=1) if len(k0) else [99]
            d1 = np.linalg.norm(k1 - uv1[j], axis=1) if len(k1) else [99]
            i0, i1 = np.argmin(d0), np.argmin(d1)
            if d0[i0] < 4.0 and d1[i1] < 4.0:
                # the localization offsets should agree across views
                errs.append(np.linalg.norm((k0[i0] - uv0[j]) - (k1[i1] - uv1[j])))
    if not errs:
        return float("nan"), 0
    return float(np.median(errs)), len(errs)


@torch.no_grad()
def eval_loop_recall(nv_params, device, n_places=24, seed=1):
    """Rendered revisits: each place is a synthetic scene, each query a
    homography + photometric revisit of it. Recall@1 with the trained
    embedding against the weight-free downsample baseline."""
    from d2slam_tpu_torch.runtime.system import image_embedding_gdesc

    H, W = 120, 160
    rng = np.random.default_rng(seed)
    imgs, _ = make_batch(rng, n_places, H, W)
    queries = []
    for b in range(n_places):
        Hm = random_homography(rng, H, W, max_angle=0.3, max_trans=0.12)
        v = warp_image(torch.as_tensor(imgs[b], device=device),
                       np.asarray(Hm, np.float32)).cpu().numpy()
        gain = rng.uniform(0.7, 1.3)
        queries.append(np.clip(v * gain, 0, 1).astype(np.float32))
    queries = np.stack(queries)

    model = NetVLAD(nv_params, device=device)
    db = model(torch.as_tensor(imgs, device=device)).cpu().numpy()
    q = model(torch.as_tensor(queries, device=device)).cpu().numpy()
    hit = (np.argmax(q @ db.T, axis=1) == np.arange(n_places)).mean()
    db0 = np.stack([image_embedding_gdesc(im, 1024) for im in imgs])
    q0 = np.stack([image_embedding_gdesc(im, 1024) for im in queries])
    hit0 = (np.argmax(q0 @ db0.T, axis=1) == np.arange(n_places)).mean()
    return float(hit), float(hit0)


def _train_netvlad(args, dev):
    """The 4096-d VLAD head -> PCA 1024 with renormalization (the
    reference's mobilenetvlad_onnx.h:49-74), a short fine-tune in the
    PCA'd space, then the gate calibrated to the reference's fixed 0.8
    retrieval threshold."""
    nv_cfg = NetVLADConfig(num_clusters=32, feat_dim=128, output_dim=4096, width_mult=4.0)
    t0 = time.time()
    margins = dict(pos_margin=0.92, neg_margin=0.35, margin_weight=4.0)
    nv_params, nv_losses = train_netvlad(
        steps=args.nv_steps, batch=args.batch, hw=(120, 160), netvlad_cfg=nv_cfg,
        log_every=max(args.nv_steps // 8, 1), device=dev, **margins)
    nv_params = fit_netvlad_pca(nv_params, nv_cfg, pca_dim=1024, device=dev)
    nv_cfg_p = netvlad_cfg_from_params(nv_params)
    nv_params, _ = train_netvlad(
        steps=max(args.nv_steps // 6, 1), batch=args.batch, hw=(120, 160),
        netvlad_cfg=nv_cfg_p, params=nv_params, lr=3e-4,
        log_every=max(args.nv_steps // 8, 1), device=dev, **margins)
    nv_params = calibrate_netvlad_gate(nv_params, nv_cfg_p, target=0.8, min_precision=0.97,
                                       device=dev)
    wall = time.time() - t0
    print(f"netvlad: {args.nv_steps} steps in {wall:.0f}s, loss {nv_losses[0]:.3f} -> "
          f"{sum(nv_losses[-20:]) / len(nv_losses[-20:]):.3f}", flush=True)
    save_weights(os.path.join(args.out, "netvlad_synth.npz"), nv_params)
    r1, r0 = eval_loop_recall(nv_params, dev)
    print(f"loop recall@1 (rendered revisits): trained {r1 * 100:.0f}% vs weight-free "
          f"baseline {r0 * 100:.0f}%", flush=True)
    return dict(first_loss=nv_losses[0], last_loss=nv_losses[-1], wall_s=wall,
                recall_trained=r1, recall_baseline=r0)


def _train_superglue(args, dev, sp_params, sp_cfg):
    from d2slam_tpu_torch.frontend.matching import match_descriptors_radius
    from d2slam_tpu_torch.frontend.superglue import SuperGlue, SuperGlueConfig
    from d2slam_tpu_torch.frontend.train_frontend import eval_matcher_pr, train_superglue

    sg_cfg = SuperGlueConfig(num_layers=3, num_heads=4, sinkhorn_iters=20)
    t0 = time.time()
    sg_params, sg_losses = train_superglue(
        steps=args.sg_steps, batch=16, hw=(120, 160), sp_params=sp_params, sp_cfg=sp_cfg,
        sg_cfg=sg_cfg, n_pairs=512, log_every=max(args.sg_steps // 10, 1), device=dev)
    wall = time.time() - t0
    print(f"superglue: {args.sg_steps} steps in {wall:.0f}s, loss {sg_losses[0]:.3f} -> "
          f"{sum(sg_losses[-20:]) / len(sg_losses[-20:]):.3f}", flush=True)
    save_weights(os.path.join(args.out, "superglue_synth.npz"), sg_params)

    # held-out precision / recall against the default kNN matcher
    eval_sp = SuperPoint(sp_params, dataclasses.replace(sp_cfg, max_keypoints=96), device=dev)
    sg = SuperGlue(sg_params, sg_cfg, device=dev)

    def sg_fn(a, b):
        return sg.match(a.kpts, a.desc, a.scores, a.valid, b.kpts, b.desc, b.scores, b.valid,
                        (120, 160))

    def knn_fn(a, b):
        return match_descriptors_radius(a.desc, b.desc, a.kpts.float(), b.kpts.float(),
                                        a.valid, b.valid, radius=1e9, ratio=0.9)

    with torch.no_grad():
        p_sg, r_sg, *_ = eval_matcher_pr(sg_fn, eval_sp, (120, 160))
        p_nn, r_nn, *_ = eval_matcher_pr(knn_fn, eval_sp, (120, 160))
    print(f"matcher P/R on held-out pairs: superglue {p_sg * 100:.0f}%/{r_sg * 100:.0f}% vs "
          f"kNN {p_nn * 100:.0f}%/{r_nn * 100:.0f}%", flush=True)
    return dict(first_loss=sg_losses[0], last_loss=sg_losses[-1], wall_s=wall,
                precision=p_sg, recall=r_sg, knn_precision=p_nn, knn_recall=r_nn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--nv-steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default="weights")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--skip-netvlad", action="store_true")
    ap.add_argument("--sg-steps", type=int, default=0,
                    help="also train the compact SuperGlue matcher on the frozen SuperPoint "
                         "features")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    print(f"device: {dev}")
    os.makedirs(args.out, exist_ok=True)
    sp_cfg = SuperPointConfig(max_keypoints=200, threshold=0.010, nms_radius=4)
    summary = dict(device=str(dev))

    sp_path = os.path.join(args.out, "superpoint_synth.npz")
    if args.steps == 0 and os.path.exists(sp_path):
        sp_params = load_weights(sp_path)
        print(f"superpoint: loaded existing {sp_path}", flush=True)
    else:
        t0 = time.time()
        sp_params, sp_losses = train_superpoint(
            steps=args.steps, batch=args.batch, hw=(120, 160), cfg=sp_cfg,
            log_every=max(args.steps // 10, 1), device=dev)
        wall = time.time() - t0
        print(f"superpoint: {args.steps} steps in {wall:.0f}s, loss {sp_losses[0]:.3f} -> "
              f"{sum(sp_losses[-20:]) / len(sp_losses[-20:]):.3f}", flush=True)
        save_weights(sp_path, sp_params)
        med, n = eval_detector_consistency(sp_params, sp_cfg, dev)
        print(f"detector reprojection consistency: median {med:.2f} px over {n} cross-view "
              "tracks", flush=True)
        summary["superpoint"] = dict(first_loss=sp_losses[0], last_loss=sp_losses[-1],
                                     wall_s=wall, consistency_px=med, tracks=n)
    if not args.skip_netvlad:
        summary["netvlad"] = _train_netvlad(args, dev)
    if args.sg_steps > 0:
        summary["superglue"] = _train_superglue(args, dev, sp_params, sp_cfg)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
