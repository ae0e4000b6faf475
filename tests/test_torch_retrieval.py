"""The port's retrieval pieces against the JAX package on the CPU: the
synthetic scene generators of ``frontend/train_frontend.py`` (corner
images and their labels, batches and homographies bit for bit from the
same seed; the bilinear warp within 1e-5), ``retrieval_pr_aliasing``
over the port's NetVLAD with weights/netvlad_synth.npz at a small
number of places (the same precision / recall curves and operating
points), and ``matching.retrieval_topk``."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.frontend import train_frontend as jtf
from d2slam_tpu.frontend.matching import retrieval_topk as j_topk
from d2slam_tpu_torch.frontend import train_frontend as tf
from d2slam_tpu_torch.frontend.matching import retrieval_topk

torch.set_num_threads(1)  # tests run one process per core (xdist)

NV_W = os.path.join(os.path.dirname(__file__), "..", "weights", "netvlad_synth.npz")


def test_synth_corners_and_batches_match_jax():
    for seed in range(3):
        img, c = tf.synth_corners_image(np.random.default_rng(seed), 96, 128)
        jimg, jc = jtf.synth_corners_image(np.random.default_rng(seed), 96, 128)
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(tf.cell_labels(c, 96, 128), jtf.cell_labels(jc, 96, 128))
    imgs, labs = tf.make_batch(np.random.default_rng(5), 3, 64, 80)
    jimgs, jlabs = jtf.make_batch(np.random.default_rng(5), 3, 64, 80)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labs, jlabs)


def test_homography_and_warp_match_jax():
    rng, jrng = np.random.default_rng(2), np.random.default_rng(2)
    img = tf.synth_corners_image(np.random.default_rng(9), 96, 128)[0]
    for _ in range(3):
        Hm = tf.random_homography(rng, 96, 128)
        np.testing.assert_array_equal(Hm, jtf.random_homography(jrng, 96, 128))
        out = tf.warp_image(torch.as_tensor(img), Hm.astype(np.float32))
        jout = np.asarray(jtf.warp_image(jnp.asarray(img), jnp.asarray(Hm, jnp.float32)))
        assert out.dtype == torch.float32 and (jout > 0).mean() > 0.3
        np.testing.assert_allclose(out.numpy(), jout, atol=1e-5, rtol=0)


@pytest.mark.skipif(not os.path.exists(NV_W), reason="trained NetVLAD weights not present")
def test_retrieval_pr_aliasing_matches_jax():
    from d2slam_tpu.frontend.netvlad import netvlad_cfg_from_params
    from d2slam_tpu.utils.evaluation import retrieval_pr_aliasing as j_pr
    from d2slam_tpu_torch.frontend.netvlad import load_params
    from d2slam_tpu_torch.utils.evaluation import retrieval_pr_aliasing

    kw = dict(n_places=8, n_alias=4, seed=3, hw=(96, 128))
    r = retrieval_pr_aliasing(load_params(NV_W), device="cpu", **kw)
    jnv = jtf.load_weights(NV_W)
    jr = j_pr(jnv, netvlad_cfg_from_params(jnv), **kw)
    assert set(r) == set(jr)
    for k in ("thresholds", "precision", "recall"):
        np.testing.assert_array_equal(r[k], np.asarray(jr[k]), err_msg=k)
    for k in ("precision_at_0p8", "recall_at_0p8", "op_threshold", "op_precision", "op_recall"):
        assert r[k] == pytest.approx(jr[k], abs=1e-12), k
    assert r["op_recall"] > 0


def test_retrieval_topk_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    db = rng.normal(size=(10, 16)).astype(np.float32)
    valid = rng.uniform(size=10) > 0.3
    s, i = retrieval_topk(torch.as_tensor(q), torch.as_tensor(db), torch.as_tensor(valid), 4)
    js, ji = j_topk(jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid), k=4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    assert valid[i.numpy()[:, :int(valid.sum())]].all()
