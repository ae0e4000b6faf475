"""Loop-by-loop diagnosis of the port's two-robot swarms on the CPU.

    python -m tests.diag_swarm_image_loops VARIANT [--no-superglue] [--textured]

Runs the image-level blob swarm of
tests/test_torch_distributed_system.py::test_golden_swarm_image_level
(or, with ``--textured``, the golden textured swarm of
tests/test_torch_golden_textured.py::test_golden_textured_swarm) through
the port with one of these changes, and prints every inter-robot loop
edge of each robot (its relative pose's error against ``CircleSim``'s
truth, its PnP inliers), PCM's last mask on robot 1's graph, each
robot's map alignments, and the joint RMSE of the peer's keyframes in
each robot's graph:

- ``port``: the port as it is;
- ``jax_entries``: keyframe entries that list a landmark once per view
  (the JAX package's, tests/test_torch_image_witness.py);
- ``half_desc``: descriptors rounded to float16 (the JAX tracker's);
- ``jax``: both;
- ``per_view_first_record``: entries per view, the database side of the
  loop matcher limited to each landmark's first record (so the ratio
  test never compares a landmark with itself).

``--no-superglue`` puts the kNN matcher on the loop candidates.
"""
import argparse
import os

import numpy as np

from d2slam_tpu_torch.comm.transport import LocalBus
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.frontend.loop_detector import LoopDetectorConfig
from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
from d2slam_tpu_torch.frontend.tracker import TrackerConfig
from d2slam_tpu_torch.geometry.cameras import PinholeParams
from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.render import TexturedRoom, make_signatures, render_blobs
from d2slam_tpu_torch.utils.sim import CircleSim

VARIANTS = ("port", "jax_entries", "half_desc", "jax", "per_view_first_record")
WDIR = os.path.join(os.path.dirname(__file__), "..", "weights")
SP_W = os.path.join(WDIR, "superpoint_synth.npz")
NV_W = os.path.join(WDIR, "netvlad_synth.npz")
SG_W = os.path.join(WDIR, "superglue_synth.npz")


def _first_record_matching(system):
    """The loop matcher sees a database entry's landmark through its
    first record only."""
    refresh = system.detector._refresh_positions

    def first_only(idx, old):
        old = refresh(idx, old)
        ids = np.asarray(old.lm_ids)
        if len(ids) != len(old.kpt_valid):
            return old
        first = np.zeros(len(ids), bool)
        first[np.unique(ids, return_index=True)[1]] = True
        return old._replace(kpt_valid=np.asarray(old.kpt_valid, bool) & first)
    system.detector._refresh_positions = first_only


def _apply(system, variant):
    from tests.test_torch_image_witness import _entries_per_view, _half_descriptors

    if variant in ("jax_entries", "jax", "per_view_first_record"):
        _entries_per_view(system)
    if variant in ("half_desc", "jax"):
        _half_descriptors(system)
    if variant == "per_view_first_record":
        _first_record_matching(system)


def _systems(variant, textured, superglue):
    from tests.test_torch_golden_textured import _cfg
    from tests.test_torch_system import small_config

    H, W, F = 240, 320, 220.0
    sims = [CircleSim(seed=7, baseline=0.2, n_landmarks=10 if textured else 150, phase=ph)
            for ph in (0.0, 0.3)]
    bus, systems, pcm = LocalBus(), [], []
    for i, sim in enumerate(sims):
        cfg = _cfg() if textured else small_config(D2Config)
        cfg.estimator.focal_length = F
        sg = superglue and os.path.exists(SG_W)
        s = D2SLAMSystem(
            cfg, SystemConfig(drone_id=i, pgo_every_n_kf=100, netvlad_weights=NV_W,
                              enable_superglue_remote=sg, superglue_weights=SG_W if sg else ""),
            sim.ext, [PinholeParams.make(F, F, W / 2, H / 2) for _ in range(2)],
            sp_params=load_params(SP_W),
            sp_cfg=(SuperPointConfig(max_keypoints=300, threshold=0.008) if textured else
                    SuperPointConfig(max_keypoints=200, threshold=0.008, nms_radius=4)),
            transport=bus.endpoint(i),
            tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
            loop_cfg=LoopDetectorConfig(gdesc_dim=1024, min_gap_frames=2,
                                        min_inliers=20 if textured else 4,
                                        min_match_per_dir=8 if textured else 4,
                                        pnp_thresh=16.0 / 460.0),
            frame_rate=sim.frame_hz, device="cpu")
        _apply(s, variant)
        pcm_mask = s._pcm_mask

        def logged(loops, _mask=pcm_mask, _s=s):
            m = _mask(loops)
            pcm.append((_s.drone_id, [(e.drone_id_a, e.frame_id_a, e.drone_id_b, e.frame_id_b)
                                      for (_, _, e) in loops], np.asarray(m).tolist()))
            return m
        s._pcm_mask = logged
        systems.append(s)
    return sims, systems, pcm


def run(variant, textured=False, superglue=True):
    H, W, F = 240, 320, 220.0
    sims, systems, pcm = _systems(variant, textured, superglue)
    if textured:
        from tests.test_torch_golden_textured import _render
        room = TexturedRoom(half=14.0, height=7.0, seed=3)

        def frames(sim, t):
            return _render(room, sim.gt_pose(t)[0], sim.ext, t)
    else:
        inten = sims[0].rng.uniform(0.5, 1.0, len(sims[0].lms))
        sims[1].lms = sims[0].lms
        sigs = make_signatures(len(sims[0].lms), seed=7)

        def frames(sim, t):
            pose = sim.gt_pose(t)[0]
            return [render_blobs(sim.lms, np_lie.pose_compose(pose, sim.ext[c]), F, F, W / 2,
                                 H / 2, H, W, intensities=inten, signatures=sigs)
                    for c in range(2)]
    t_prev = 0.0
    for s, sim in zip(systems, sims):
        for (ts, a, g) in sim.imu_samples(-0.3, 0.0):
            s.input_imu(ts, a, g)
    for k in range(26):
        t = k / sims[0].frame_hz
        for s, sim in zip(systems, sims):
            if k:
                for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                    s.input_imu(ts, a, g)
            s.input_stereo(t, *frames(sim, t))
        t_prev = t
        for s in systems:
            s.poll_network(now=t)
    for _ in range(3):
        for s in systems:
            s.poll_network(now=t_prev)
    for s in systems:
        s.solve_pgo()
    stamp = {}
    for s in systems:
        for (d, f, t, _) in s._pgo_meta:
            stamp.setdefault((d, f), t)
    print(f"variant {variant}{'' if superglue else ', kNN loop matcher'} "
          f"({'golden textured' if textured else 'image-level blob'} swarm)")
    for s in systems:
        print(f"robot {s.drone_id}: alignments {sorted(s.swarm.alignments)}")
        for e in s.loop_edges:
            if e.drone_id_a == e.drone_id_b:
                continue
            ta, tb = stamp.get((e.drone_id_a, e.frame_id_a)), stamp.get((e.drone_id_b, e.frame_id_b))
            gt = np_lie.pose_compose(np_lie.pose_inverse(sims[e.drone_id_a].gt_pose(ta)[0]),
                                     sims[e.drone_id_b].gt_pose(tb)[0])
            dq = np_lie.pose_compose(np_lie.pose_inverse(gt), np.asarray(e.rel_pose, np.float64))
            print(f"  loop {e.drone_id_a}:{e.frame_id_a} -> {e.drone_id_b}:{e.frame_id_b} "
                  f"inliers {e.inliers} error {np.linalg.norm(e.rel_pose[:3] - gt[:3]):.4f} m "
                  f"{np.degrees(2 * np.arccos(min(1.0, abs(dq[6])))):.3f} deg")
    last = [r for r in pcm if r[0] == 1][-1:]
    for _, loops, mask in last:
        print("PCM on robot 1's graph: " + ", ".join(
            f"{a}:{fa}->{b}:{fb} {'kept' if m else 'dropped'}"
            for (a, fa, b, fb), m in zip(loops, mask) if a != b))
    for s in systems:
        st_s, ego_s = s.trajectory(drone_id=s.drone_id, optimized=False)
        T = np_lie.pose_compose(sims[s.drone_id].gt_pose(st_s[0])[0], np_lie.pose_inverse(ego_s[0]))
        other = 1 - s.drone_id
        st_o, opt_o = s.trajectory(drone_id=other)
        errs = [np.linalg.norm(np_lie.pose_compose(T, p)[:3] - sims[other].gt_pose(st)[0][:3])
                for st, p in zip(st_o, opt_o)]
        if errs:
            print(f"robot {s.drone_id}'s graph: robot {other} at joint RMSE "
                  f"{float(np.sqrt(np.mean(np.square(errs)))):.4f} m, first keyframes "
                  + ", ".join(f"{x:.3f}" for x in errs[:4]) + " m")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", choices=VARIANTS)
    ap.add_argument("--no-superglue", action="store_true")
    ap.add_argument("--textured", action="store_true")
    args = ap.parse_args()
    run(args.variant, args.textured, not args.no_superglue)
