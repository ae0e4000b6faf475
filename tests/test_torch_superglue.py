"""The port's SuperGlue against the JAX package's, on the CPU.

The JAX package draws its weights from ``jax.random``, which torch cannot
reproduce, so each comparison carries the JAX parameters across as numpy
(``superglue_params_from_numpy``). Held: the log-assignment matrix
within 1e-4 of its largest magnitude on every entry outside the -1e9
mask, and equal matches,
at the shipped compact configuration (weights/superglue_synth.npz,
256-d, 3 layers) and at tests/test_superglue.py's 64-d 0-layer and
3-layer configurations; masked points never match, a query whose keys
are all masked gets the JAX package's uniform attention; the tracker and
loop-detector hooks give the JAX hooks' matches; and the mirror of
tests/test_superglue.py::test_trained_superglue_beats_knn.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.frontend import superglue as J
from d2slam_tpu.frontend.train_frontend import load_weights as jax_load_weights
from d2slam_tpu_torch.frontend import superglue as P
from d2slam_tpu_torch.frontend.train_frontend import load_weights

torch.set_num_threads(1)  # tests run one process per core (xdist)

REPO = os.path.join(os.path.dirname(__file__), "..")
SG_W = os.path.join(REPO, "weights", "superglue_synth.npz")
SP_W = os.path.join(REPO, "weights", "superpoint_synth.npz")
# float32 network: the two packages sum in another order, so an entry
# errs by a few ulps of the largest scores that enter it. Trained weights
# keep |logP| below ~160 (measured error 1.6e-4); the untrained 3-layer
# net blows the scores up to ~1.7e4, where a float32 ulp is 2e-3
LOGP_TOL = 1e-4

CONFIGS = {
    "compact_256": (dict(num_layers=3, num_heads=4, sinkhorn_iters=20), None),
    "d64_0layer": (dict(desc_dim=64, num_layers=0, num_heads=4, sinkhorn_iters=40,
                        match_threshold=0.05), 0),
    "d64_3layer": (dict(desc_dim=64, num_layers=3, num_heads=4, sinkhorn_iters=20), 0),
}


def _params(name):
    kw, seed = CONFIGS[name]
    if seed is None:
        return jax_load_weights(SG_W), kw
    return J.superglue_init(jax.random.PRNGKey(seed), J.SuperGlueConfig(**kw)), kw


def _sets(D, N=48, M=56, seed=1, overlap=30):
    """Two keypoint sets whose first ``overlap`` points correspond (a
    shifted copy with descriptor noise), a few points masked."""
    rng = np.random.default_rng(seed)
    ka = rng.uniform(10, 300, (N, 2)).astype(np.float32)
    kb = rng.uniform(10, 300, (M, 2)).astype(np.float32)
    da = rng.normal(size=(N, D)).astype(np.float32)
    db = rng.normal(size=(M, D)).astype(np.float32)
    db[:overlap] = da[:overlap] + 0.1 * rng.normal(size=(overlap, D)).astype(np.float32)
    kb[:overlap] = ka[:overlap] + 3.0
    da /= np.linalg.norm(da, axis=1, keepdims=True)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    sa = rng.uniform(0.1, 1, N).astype(np.float32)
    sb = rng.uniform(0.1, 1, M).astype(np.float32)
    va, vb = np.ones(N, bool), np.ones(M, bool)
    va[:4] = False
    vb[-3:] = False
    return ka, da, sa, va, kb, db, sb, vb


def _both(name, sets, hw=(240, 320)):
    pj, kw = _params(name)
    cfg_j = J.SuperGlueConfig(**kw)
    model = P.SuperGlue(P.superglue_params_from_numpy(pj), P.SuperGlueConfig(**kw), device="cpu")
    jargs = [jnp.asarray(x) for x in sets]
    Lj = np.asarray(J.superglue_logP(pj, *jargs, hw, cfg_j))
    ij, oj = J.superglue_match(pj, *jargs, hw, cfg_j)
    Lp = model.logP(*sets, hw).numpy()
    ip, op = model.match(*sets, hw)
    return (Lj, np.asarray(ij), np.asarray(oj)), (Lp, ip, op)


def _unmasked(L, va, vb):
    m = np.ones(L.shape, bool)
    m[:-1, :-1] = va[:, None] & vb[None, :]
    return m


def assert_logP_close(Lp, Lj, m):
    scale = max(1.0, float(np.abs(Lj[m]).max()))
    err = float(np.abs(Lp[m] - Lj[m]).max())
    assert err <= LOGP_TOL * scale, f"logP differs by {err} at scale {scale}"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logP_and_match_match_jax(name):
    D = 256 if name == "compact_256" else 64
    sets = _sets(D)
    (Lj, ij, oj), (Lp, ip, op) = _both(name, sets)
    assert_logP_close(Lp, Lj, _unmasked(Lj, sets[3], sets[7]))
    assert np.array_equal(op, oj) and np.array_equal(ip[oj], ij[oj])
    # untrained attention layers homogenize the features: one match is left
    assert op.sum() >= (1 if name == "d64_3layer" else 5)
    assert not op[~sets[3]].any()                 # masked points never match


def test_all_keys_masked_gives_uniform_attention():
    """With every point of b masked, each cross-attention row of a sees
    only -1e9 logits: JAX's softmax is uniform there, and so is the port's
    (no NaN); nothing matches."""
    ka, da, sa, va, kb, db, sb, vb = _sets(64)
    sets = (ka, da, sa, va, kb, db, sb, np.zeros_like(vb))
    (Lj, _, oj), (Lp, _, op) = _both("d64_3layer", sets)
    assert np.isfinite(Lp).all() and not op.any() and not oj.any()
    m = np.zeros(Lj.shape, bool)
    m[:, -1] = m[-1] = True
    assert_logP_close(Lp, Lj, m)


def test_sinkhorn_matches_jax_and_is_doubly_stochastic():
    rng = np.random.default_rng(0)
    scores = rng.normal(0, 1, (8, 6)).astype(np.float32)
    Pp = P.log_sinkhorn(torch.as_tensor(scores), torch.tensor(1.0), 50).numpy()
    Pj = np.asarray(J._log_sinkhorn(jnp.asarray(scores), jnp.asarray(1.0, jnp.float32), 50))
    assert_logP_close(Pp, Pj, np.ones(Pj.shape, bool))
    Pm = np.exp(Pp)
    np.testing.assert_allclose(Pm[:8].sum(axis=1), 1.0, atol=1e-3)
    np.testing.assert_allclose(Pm[:, :6].sum(axis=0), 1.0, atol=1e-3)


def test_params_layouts_and_init(tmp_path):
    """The nested ``load_weights`` layout, an ``np.load`` of the npz and the
    flat ``name_w`` layout of the JAX ``superglue.load_params`` give one
    tree; ``superglue_init`` draws the JAX tree's shapes from a generator."""
    nested = P.superglue_params_from_numpy(load_weights(SG_W))
    assert sum(1 for _ in _leaves(nested)) == 67
    flat_path = os.path.join(tmp_path, "flat.npz")
    np.savez(flat_path, **{k.replace("/", "_"): v for k, v in np.load(SG_W).items()})
    for other in (np.load(SG_W), J.load_params(flat_path)):
        tree = P.superglue_params_from_numpy(other)
        assert [k for k, _ in _leaves(tree)] == [k for k, _ in _leaves(nested)]
        for (_, a), (_, b) in zip(_leaves(tree), _leaves(nested)):
            np.testing.assert_array_equal(a, b)
    cfg = P.SuperGlueConfig(desc_dim=64, num_layers=2)
    mine = P.superglue_init(torch.Generator().manual_seed(3), cfg)
    ref = J.superglue_init(jax.random.PRNGKey(0), J.SuperGlueConfig(desc_dim=64, num_layers=2))
    assert [(k, v.shape) for k, v in _leaves(mine)] == [
        (k, np.asarray(v).shape) for k, v in _leaves(P.superglue_params_from_numpy(ref))]
    again = P.superglue_init(torch.Generator().manual_seed(3), cfg)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(_leaves(mine), _leaves(again)))
    w = mine["self0"]["q"]["w"]
    assert abs(w.std() - np.sqrt(2.0 / 64)) < 0.01 and not mine["final"]["b"].any()


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_tracker_and_loop_matcher_hooks_match_jax():
    """tests/test_superglue.py::test_superglue_as_tracker_matcher through
    both packages' trackers (oracle features, 0 GNN layers so identical
    sets self-match): the same landmark ids carried across keyframes; and
    the loop matcher of both packages on rays."""
    from d2slam_tpu.frontend.superpoint import SuperPointOutput as JOut
    from d2slam_tpu.frontend.tracker import FeatureTracker as JTracker
    from d2slam_tpu.frontend.tracker import TrackerConfig as JTC
    from d2slam_tpu.geometry.cameras import PinholeParams as JPin
    from d2slam_tpu_torch.frontend.superpoint import SuperPointOutput
    from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig
    from d2slam_tpu_torch.geometry.cameras import PinholeParams

    kw = dict(desc_dim=32, num_layers=0, num_heads=4, sinkhorn_iters=30, match_threshold=0.05)
    pj = J.superglue_init(jax.random.PRNGKey(1), J.SuperGlueConfig(**kw))
    rng = np.random.default_rng(0)
    N = 24
    desc = rng.normal(0, 1, (N, 32)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    kpts = rng.uniform(20, 220, (N, 2)).astype(np.float32)

    def oracle(Out, conv):
        def f(img, cam_id):
            shift = 6.0 * float(np.asarray(img[0, 0]))
            return Out(kpts=conv(kpts + shift), desc=conv(desc), scores=conv(np.ones(N)),
                       valid=conv(np.ones(N, bool)))
        return f

    tr_kw = dict(min_keyframe_parallax=2.0, use_lk=False, search_radius=50.0)
    tj = JTracker(None, None, [JPin.make(200.0, 200.0, 160, 120)] * 2, JTC(**tr_kw),
                  extract_fn=oracle(JOut, jnp.asarray),
                  matcher_fn=J.make_tracker_matcher(pj, (240, 320), J.SuperGlueConfig(**kw)))
    matcher = P.make_tracker_matcher(P.superglue_params_from_numpy(pj), (240, 320),
                                     P.SuperGlueConfig(**kw), device="cpu")
    tp = FeatureTracker(None, None, [PinholeParams.make(200.0, 200.0, 160, 120)] * 2,
                        TrackerConfig(**tr_kw), extract_fn=oracle(SuperPointOutput, np.asarray),
                        matcher_fn=matcher, device="cpu")
    ids = []
    for tr in (tj, tp):
        f0 = tr.process_stereo(0.0, 0, np.zeros((240, 320)), np.zeros((240, 320)))
        f1 = tr.process_stereo(0.2, 1, np.ones((240, 320)), np.ones((240, 320)))
        ids.append((f0.observations[0].landmark_ids.tolist(),
                    f1.observations[0].landmark_ids.tolist()))
    assert ids[1] == ids[0]
    assert len(set(ids[1][0]) & set(ids[1][1])) >= N // 2
    assert matcher.model.calls >= 1

    pj, kw = _params("compact_256")
    rays = rng.normal(size=(40, 3))
    rays[:, 2] = np.abs(rays[:, 2]) + 1.0
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    d = rng.normal(size=(40, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    perm = rng.permutation(40)
    args = (d, rays, np.ones(40, bool), d[perm], rays[perm], np.ones(40, bool))
    ij, oj = J.make_loop_matcher(pj, J.SuperGlueConfig(**kw))(*args)
    ip, op = P.make_loop_matcher(pj, P.COMPACT, device="cpu")(*args)
    assert np.array_equal(op, np.asarray(oj)) and np.array_equal(ip[op], np.asarray(ij)[op])
    assert op.sum() >= 30 and (perm[ip[op]] == np.flatnonzero(op)).all()


def test_trained_superglue_beats_knn():
    """tests/test_superglue.py::test_trained_superglue_beats_knn on the
    port: the shipped compact SuperGlue out-matches the kNN ratio matcher
    (F1) on held-out homography pairs of the port's SuperPoint."""
    from d2slam_tpu_torch.frontend.matching import match_descriptors_radius
    from d2slam_tpu_torch.frontend.superpoint import SuperPoint, SuperPointConfig, load_params
    from d2slam_tpu_torch.frontend.train_frontend import eval_matcher_pr

    sp = SuperPoint(load_params(SP_W), SuperPointConfig(max_keypoints=96, threshold=0.010,
                                                        nms_radius=4), device="cpu")
    sg = P.SuperGlue(load_weights(SG_W), P.COMPACT, device="cpu")

    def sg_fn(a, b):
        return sg.match(a.kpts, a.desc, a.scores, a.valid, b.kpts, b.desc, b.scores, b.valid,
                        (120, 160))

    def knn_fn(a, b):
        return match_descriptors_radius(a.desc, b.desc, a.kpts, b.kpts, a.valid, b.valid,
                                        radius=1e9, ratio=0.9)

    p_sg, r_sg, *_ = eval_matcher_pr(sg_fn, sp, (120, 160), n_pairs=10)
    p_nn, r_nn, *_ = eval_matcher_pr(knn_fn, sp, (120, 160), n_pairs=10)
    f1_sg = 2 * p_sg * r_sg / max(p_sg + r_sg, 1e-9)
    f1_nn = 2 * p_nn * r_nn / max(p_nn + r_nn, 1e-9)
    assert f1_sg > f1_nn, f"trained SG F1 {f1_sg:.3f} <= kNN {f1_nn:.3f}"
