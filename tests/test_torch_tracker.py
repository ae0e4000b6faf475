"""Parity of the port's tracker layer (matching, LK, stereo tracker)
with the JAX package on the CPU.

* Matching: seeded unit descriptors and points through both packages'
  host matchers; indices and accept masks must be equal (same float32
  GEMM inputs; the ratio/cross checks are exact comparisons).
* LK: the port builds its own copy of the native tracker; same
  inputs, same outputs to 1e-4 px.
* Stereo tracker over a few rendered frames (float32 SuperPoint): the
  keyframe decisions must be equal and the per-camera observation
  counts within 2 (the JAX tracker matches on f16-downloaded
  descriptors, the port on f32 ones, so a borderline ratio test may
  flip).
"""
import os

import numpy as np
import pytest
import torch

from d2slam_tpu.frontend import matching as jm
from d2slam_tpu.frontend.lk import lk_track_images as j_lk
from d2slam_tpu_torch.frontend import matching as tm
from d2slam_tpu_torch.frontend.lk import lk_track_images as t_lk
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.render import render_blobs
from d2slam_tpu_torch.utils.sim import CircleSim

torch.set_num_threads(1)  # tests run one process per core (xdist)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights",
                       "superpoint_synth.npz")


def _desc(rng, n, d=32):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", ["plain", "radius", "epipolar"])
def test_matchers_match_jax(kind):
    rng = np.random.default_rng(0)
    da = _desc(rng, 60)
    db = np.concatenate([da[:40] + 0.2 * _desc(rng, 40), _desc(rng, 30)])
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    pa = rng.uniform(0, 100, (60, 2)).astype(np.float32)
    pb = np.concatenate([pa[:40] + rng.normal(0, 1.0, (40, 2)),
                         rng.uniform(0, 100, (30, 2))]).astype(np.float32)
    pb[:40, 1] = pa[:40, 1] + rng.uniform(-1, 1, 40)   # epipolar band
    pb[:40, 0] = pa[:40, 0] - rng.uniform(0, 10, 40)   # positive disparity
    va = rng.uniform(size=60) > 0.1
    vb = rng.uniform(size=70) > 0.1
    T = torch.as_tensor
    if kind == "plain":
        j = jm.match_descriptors(da, db, va, vb)
        t = tm.match_descriptors(T(da), T(db), va, vb)
    elif kind == "radius":
        j = jm.match_descriptors_radius(da, db, pa, pb, va, vb, radius=5.0)
        t = tm.match_descriptors_radius(T(da), T(db), pa, pb, va, vb, radius=5.0)
    else:
        j = jm.match_stereo_epipolar(da, db, pa, pb, va, vb)
        t = tm.match_stereo_epipolar(T(da), T(db), pa, pb, va, vb)
    ok = np.asarray(j[1])
    assert ok.sum() >= 10
    np.testing.assert_array_equal(t[1].numpy(), ok)
    np.testing.assert_array_equal(t[0].numpy()[ok], np.asarray(j[0])[ok])


def test_lk_matches_jax_native():
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=150)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    imgs = []
    for t in (0.5, 0.625):
        pose, _ = sim.gt_pose(t)
        imgs.append(render_blobs(sim.lms, np_lie.pose_compose(pose, sim.ext[0]),
                                 220.0, 220.0, 160.0, 120.0, 240, 320,
                                 intensities=inten).astype(np.float32))
    rng = np.random.default_rng(1)
    pts = rng.uniform([20, 20], [300, 220], (64, 2)).astype(np.float32)
    valid = rng.uniform(size=64) > 0.2
    jp, jok = j_lk(imgs[0], imgs[1], pts, valid)
    tp, tok = t_lk(imgs[0], imgs[1], pts, valid)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(tp, jp, atol=1e-4)


def test_stereo_tracker_matches_jax():
    from d2slam_tpu.frontend.superpoint import SuperPointConfig as JCfg
    from d2slam_tpu.frontend.tracker import FeatureTracker as JTracker
    from d2slam_tpu.frontend.tracker import TrackerConfig as JTrCfg
    from d2slam_tpu.frontend.train_frontend import load_weights
    from d2slam_tpu.geometry.cameras import PinholeParams as JPin
    from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
    from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig
    from d2slam_tpu_torch.geometry.cameras import PinholeParams

    H, W, F = 120, 160, 110.0
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=150)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    kw = dict(max_keypoints=64, threshold=0.01)
    jt = JTracker(load_weights(WEIGHTS), JCfg(**kw), [JPin.make(F, F, W / 2, H / 2)] * 2,
                  JTrCfg(min_keyframe_parallax=2.0, search_radius=15.0),
                  frame_rate=sim.frame_hz)
    tt = FeatureTracker(load_params(WEIGHTS), SuperPointConfig(**kw),
                        [PinholeParams.make(F, F, W / 2, H / 2)] * 2,
                        TrackerConfig(min_keyframe_parallax=2.0, search_radius=15.0),
                        frame_rate=sim.frame_hz, device="cpu")
    n_obs = 0
    for k in range(4):
        pose, _ = sim.gt_pose(k / sim.frame_hz)
        imgs = [render_blobs(sim.lms, np_lie.pose_compose(pose, sim.ext[c]),
                             F, F, W / 2, H / 2, H, W, intensities=inten)
                for c in range(2)]
        jf = jt.process_stereo(k / sim.frame_hz, k, *imgs)
        tf = tt.process_stereo(k / sim.frame_hz, k, *imgs)
        assert (jf is None) == (tf is None)
        if jf is None:
            continue
        assert len(jf.observations) == len(tf.observations)
        for jo, to in zip(jf.observations, tf.observations):
            assert abs(len(jo.landmark_ids) - len(to.landmark_ids)) <= 2
            n_obs += len(to.landmark_ids)
    assert n_obs >= 40
