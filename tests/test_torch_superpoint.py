"""Parity of the port's SuperPoint (stem plain version, trunk, heads,
NMS, top-K, subpixel refinement, descriptor sampling) with the JAX
package on the CPU.

* Stem: ``stem_plain`` (the CUDA kernel's plain version) against the
  TPU kernel itself in Pallas interpret mode and against its XLA
  reference, at [2, 32, 48]. Tolerance |t - j| <= 0.02 + 0.016 |j|:
  two bf16 ulps of the output plus a floor for one conv1a activation
  rounding the other way (the JAX pair differ by up to 0.0156).
* float32 extraction with the trained weights on a rendered image:
  score maps to 1e-5, keypoints compared as sorted sets (top-K may
  order ties differently) to 1e-3 px, descriptors to 1e-4.
* bfloat16 backbone: score maps to 0.02 (bf16 rounding through eight
  convolutions).
* NMS: equal to the JAX package's on a map without ties; of two equal
  maxima within one window the port keeps only the first in raster
  order (the JAX package keeps both).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.frontend import superpoint as jsp
from d2slam_tpu.frontend.train_frontend import load_weights
from d2slam_tpu.ops.superpoint_stem_pallas import stem_reference
from d2slam_tpu.ops.superpoint_stem_pallas import superpoint_stem as pallas_stem
from d2slam_tpu_torch.frontend import superpoint as tsp
from d2slam_tpu_torch.ops import superpoint_stem as tstem
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.render import render_blobs
from d2slam_tpu_torch.utils.sim import CircleSim

torch.set_num_threads(1)  # tests run one process per core (xdist)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights",
                       "superpoint_synth.npz")
STEM_ATOL, STEM_RTOL = 0.02, 0.016


def _stem_inputs():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 32, 48)).astype(np.float32)
    p1 = {"w": rng.normal(0, 0.5, (3, 3, 1, 64)).astype(np.float32),
          "b": rng.normal(0, 0.1, 64).astype(np.float32)}
    p2 = {"w": rng.normal(0, 0.06, (3, 3, 64, 64)).astype(np.float32),
          "b": rng.normal(0, 0.1, 64).astype(np.float32)}
    return img, p1, p2


def _port_stem(img, p1, p2):
    w = tstem.pack_stem_weights(p1["w"], p1["b"], p2["w"], p2["b"], device="cpu")
    return tstem.superpoint_stem(torch.as_tensor(img), w).float().numpy()


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_reference"])
def test_stem_plain_matches_tpu_kernel(ref):
    img, p1, p2 = _stem_inputs()
    jp1 = {k: jnp.asarray(v) for k, v in p1.items()}
    jp2 = {k: jnp.asarray(v) for k, v in p2.items()}
    if ref == "pallas_interpret":
        j = pallas_stem(jnp.asarray(img), jp1, jp2, interpret=True)
    else:
        j = stem_reference(jnp.asarray(img), jp1, jp2)
    j = np.asarray(j.astype(jnp.float32))
    t = _port_stem(img, p1, p2)
    assert t.shape == j.shape == (2, 16, 24, 64)
    assert np.all(np.abs(t - j) <= STEM_ATOL + STEM_RTOL * np.abs(j)), \
        float(np.abs(t - j).max())


def test_stem_wrapper_counts_no_cpu_launch():
    img, p1, p2 = _stem_inputs()
    before = tstem.launches
    _port_stem(img, p1, p2)
    assert tstem.launches == before  # the plain version never counts


def test_load_params_reads_both_key_styles(tmp_path):
    params = tsp.load_params(WEIGHTS)
    ref = load_weights(WEIGHTS)
    assert set(params) == set(ref)
    np.testing.assert_array_equal(params["conv1b"]["w"], np.asarray(ref["conv1b"]["w"]))
    flat = {f"{k}_{leaf}": v for k, d in params.items() for leaf, v in d.items()}
    np.savez(tmp_path / "flat.npz", **flat)
    again = tsp.load_params(str(tmp_path / "flat.npz"))
    np.testing.assert_array_equal(again["convDb"]["b"], params["convDb"]["b"])


@pytest.fixture(scope="module")
def scene_img():
    sim = CircleSim(seed=7, baseline=0.2, n_landmarks=150)
    inten = sim.rng.uniform(0.5, 1.0, len(sim.lms))
    pose, _ = sim.gt_pose(0.5)
    T = np_lie.pose_compose(pose, sim.ext[0])
    img = render_blobs(sim.lms, T, 110.0, 110.0, 80.0, 60.0, 120, 160,
                       intensities=inten)
    return img.astype(np.float32)


def _extract_both(img, compute_dtype):
    cfg_j = jsp.SuperPointConfig(max_keypoints=48, threshold=0.01,
                                 compute_dtype=compute_dtype)
    cfg_t = tsp.SuperPointConfig(max_keypoints=48, threshold=0.01,
                                 compute_dtype=compute_dtype)
    jp = load_weights(WEIGHTS)
    model = tsp.SuperPoint(tsp.load_params(WEIGHTS), cfg_t, device="cpu")
    cdt = jnp.bfloat16 if compute_dtype == "bfloat16" else None
    js, jd = jsp.superpoint_apply(jp, jnp.asarray(img)[None, :, :, None], compute_dtype=cdt)
    ts_, td = tsp.superpoint_apply(model, torch.as_tensor(img)[None, :, :, None])
    jo = jax.jit(lambda p, im: jsp.superpoint_extract(p, im, cfg_j))(jp, jnp.asarray(img))
    to = tsp.superpoint_extract(model, torch.as_tensor(img)[None])
    return (np.asarray(js), np.asarray(jd), jo), (ts_.numpy(), td.numpy(), to)


def test_extract_float32_matches_jax(scene_img):
    (js, jd, jo), (ts_, td, to) = _extract_both(scene_img, "float32")
    np.testing.assert_allclose(ts_, js, atol=1e-5)
    np.testing.assert_allclose(td, jd, atol=1e-4)
    jv = np.asarray(jo.valid)
    tv = to.valid[0].numpy()
    assert tv.sum() == jv.sum() >= 20
    jk = np.asarray(jo.kpts)[jv]
    tk = to.kpts[0].numpy()[tv]
    oj, ot = np.lexsort(jk.T), np.lexsort(tk.T)
    np.testing.assert_allclose(tk[ot], jk[oj], atol=1e-3)
    np.testing.assert_allclose(to.desc[0].numpy()[tv][ot],
                               np.asarray(jo.desc)[jv][oj], atol=1e-4)


def test_extract_bfloat16_close_to_jax(scene_img):
    (js, _, jo), (ts_, _, to) = _extract_both(scene_img, "bfloat16")
    np.testing.assert_allclose(ts_, js, atol=0.02)
    jv, tv = np.asarray(jo.valid), to.valid[0].numpy()
    assert abs(int(tv.sum()) - int(jv.sum())) <= 2


def test_simple_nms_matches_jax_without_ties():
    rng = np.random.default_rng(3)
    scores = rng.uniform(0, 1, (2, 40, 56)).astype(np.float32)
    j = np.asarray(jsp.simple_nms(jnp.asarray(scores), 4))
    t = tsp.simple_nms(torch.as_tensor(scores), 4).numpy()
    np.testing.assert_array_equal(t, j)
    assert 20 < (t > 0).sum() < 200


def test_simple_nms_keeps_one_of_tied_maxima():
    scores = np.zeros((1, 24, 24), np.float32)
    scores[0, 10, 10] = scores[0, 10, 11] = 0.5   # tie, one pixel apart
    scores[0, 18, 12] = scores[0, 18, 20] = 0.3   # tie, 8 px apart: both kept
    scores[0, 20, 3] = 0.2
    t = tsp.simple_nms(torch.as_tensor(scores), 4).numpy()[0]
    assert [tuple(map(int, p)) for p in zip(*np.nonzero(t))] == [
        (10, 10), (18, 12), (18, 20), (20, 3)]
    j = np.asarray(jsp.simple_nms(jnp.asarray(scores), 4))[0]
    assert (j > 0).sum() == 5  # the JAX package keeps both tied pixels
