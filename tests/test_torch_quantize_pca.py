"""The port's int8 quantization and descriptor PCA
(``d2slam_tpu_torch/tools/quantize.py``, ``pca.py``) against the JAX
package's on the CPU.

- ``quantize_array`` and ``fit_pca`` are numpy in both packages: bit-equal.
- ``quantize_module`` on tests/test_quantize.py's small CNN: the same
  int8 values and scales (bit-equal), the same report (sizes equal, the
  error within 1e-6); ``calibrate_activations`` gives the same table
  (same tensors, ranges within 1e-6 relative), its JSON read by both;
  ``fake_quant`` equal; then the JAX test's pins on the port.
- PCA plugged into the port's ``superpoint_extract`` against the JAX
  extractor with the same parameters: descriptors within 1e-4."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.tools import pca as jpca
from d2slam_tpu.tools import quantize as jq
from d2slam_tpu.tools.onnx_jax import load_onnx_module as jload
from d2slam_tpu_torch.tools import pca as ppca
from d2slam_tpu_torch.tools import quantize as pq
from d2slam_tpu.tools import onnx_io as jio
from d2slam_tpu_torch.tools import onnx_io as pio
from d2slam_tpu_torch.tools.onnx_torch import load_onnx_module as pload
from tests.test_quantize import HITNET

torch.set_num_threads(1)  # tests run one process per core (xdist)


def _small_cnn_graph(io):
    """tests/test_quantize.py::_small_cnn's graph, in ``io``'s classes."""
    OnnxAttr, OnnxGraph, OnnxNode = io.OnnxAttr, io.OnnxGraph, io.OnnxNode
    rng = np.random.RandomState(0)
    nodes = [
        OnnxNode("Conv", ["x", "w1", "b1"], ["c1"], attrs={"pads": OnnxAttr("pads", ints=(1, 1, 1, 1))}),
        OnnxNode("Relu", ["c1"], ["r1"]),
        OnnxNode("Conv", ["r1", "w2"], ["c2"], attrs={"pads": OnnxAttr("pads", ints=(1, 1, 1, 1))}),
        OnnxNode("Reshape", ["c2", "shape"], ["flat"]),
        OnnxNode("MatMul", ["flat", "wm"], ["y"]),
    ]
    init = {"w1": rng.randn(8, 1, 3, 3).astype(np.float32), "b1": rng.randn(8).astype(np.float32),
            "w2": rng.randn(4, 8, 3, 3).astype(np.float32) * 0.3,
            "wm": rng.randn(4 * 6 * 6, 10).astype(np.float32) * 0.1,
            "shape": np.asarray([1, -1], np.int64)}
    return OnnxGraph(nodes=nodes, initializers=init, inputs=[("x", (1, 1, 6, 6))], outputs=["y"])


@pytest.fixture(scope="module")
def both():
    jm, pm = jload(_small_cnn_graph(jio)), pload(_small_cnn_graph(pio), device="cpu")
    jqm, pqm = jq.quantize_module(jm, min_size=32), pq.quantize_module(pm, min_size=32)
    rng = np.random.RandomState(3)
    xs = [rng.randn(1, 1, 6, 6).astype(np.float32) for _ in range(3)]
    return dict(
        jm=jm, pm=pm, jqm=jqm, pqm=pqm, xs=xs,
        jrep=jq.quantization_report(jm, jqm, (jnp.asarray(xs[0]),)),
        prep=pq.quantization_report(pm, pqm, (torch.as_tensor(xs[0]),)),
        jtab=jq.calibrate_activations(jm, [(jnp.asarray(x),) for x in xs]),
        ptab=pq.calibrate_activations(pm, [(torch.as_tensor(x),) for x in xs]))


@pytest.mark.parametrize("shape,axis", [((16, 3, 3, 3), 0), ((4, 8, 3, 3), 1), ((144, 10), 1),
                                        ((7,), 0)])
def test_quantize_array_bit_equal(shape, axis):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    w[(0,) * w.ndim] = 0.0
    if w.ndim > 1:
        w[2] = 0.0          # a zero channel: scale 1, q 0
    qp, sp = pq.quantize_array(w, axis)
    qj, sj = jq.quantize_array(w, axis)
    assert qp.dtype == qj.dtype == np.int8 and sp.dtype == sj.dtype == np.float32
    np.testing.assert_array_equal(qp, qj)
    np.testing.assert_array_equal(sp, sj)


def test_quantized_weights_equal_jax(both):
    jqm, pqm = both["jqm"], both["pqm"]
    assert pqm.quantized == jqm.quantized == ["w1", "w2", "wm"]
    assert (pqm.bytes_before, pqm.bytes_after) == (jqm.bytes_before, jqm.bytes_after)
    for name in pqm.quantized:
        assert pqm.qparams[name]["q"].dtype == torch.int8
        np.testing.assert_array_equal(pqm.qparams[name]["q"].numpy(),
                                      np.asarray(jqm.qparams[name]["q"]))
        np.testing.assert_array_equal(pqm.qparams[name]["scale"].numpy(),
                                      np.asarray(jqm.qparams[name]["scale"]))


def test_report_equals_jax_and_pins(both):
    jrep, prep = both["jrep"], both["prep"]
    assert {k: prep[k] for k in prep if k != "max_rel_err"} == \
        {k: jrep[k] for k in jrep if k != "max_rel_err"}
    assert abs(prep["max_rel_err"] - jrep["max_rel_err"]) < 1e-6
    # tests/test_quantize.py's pins
    assert prep["compression"] > 3.0 and prep["max_rel_err"] < 0.05 and prep["n_quantized"] == 3


def test_calibration_table_equals_jax(both, tmp_path):
    jtab, ptab = both["jtab"], both["ptab"]
    assert set(ptab) == set(jtab) and {"x", "c1", "y"} <= set(ptab)
    for k in jtab:
        assert abs(ptab[k] - jtab[k]) <= 1e-6 * max(1.0, jtab[k])
    p = str(tmp_path / "calib.json")
    pq.save_calibration_table(ptab, p)
    assert jq.load_calibration_table(p) == ptab == pq.load_calibration_table(p)
    with open(p) as f:
        assert json.load(f)["method"] == "amax"
    x = both["xs"][0]
    fp = pq.fake_quant(torch.as_tensor(x), ptab["x"]).numpy()
    fj = np.asarray(jq.fake_quant(jnp.asarray(x), ptab["x"]))
    np.testing.assert_allclose(fp, fj, rtol=0, atol=1e-7)
    assert np.abs(fp - x).max() <= ptab["x"] / 127.0 + 1e-6


def test_calibration_percentile_equals_jax(both):
    xs = both["xs"]
    jt = jq.calibrate_activations(both["jm"], [(jnp.asarray(x),) for x in xs], percentile=90.0)
    pt = pq.calibrate_activations(both["pm"], [(torch.as_tensor(x),) for x in xs], percentile=90.0)
    assert set(pt) == set(jt)
    for k in jt:
        assert abs(pt[k] - jt[k]) <= 1e-6 * max(1.0, jt[k])
        assert pt[k] <= both["ptab"][k]


@pytest.mark.slow
def test_quantize_trained_hitnet():
    if not os.path.exists(HITNET):
        pytest.skip("no trained HitNet")
    mod = pload(HITNET, device="cpu")
    qmod = pq.quantize_module(mod, min_size=128)
    assert qmod.bytes_after < 0.4 * qmod.bytes_before
    x = torch.rand(1, 2, 240, 320, generator=torch.Generator().manual_seed(0))
    assert pq.quantization_report(mod, qmod, (x,))["max_rel_err"] < 0.25


@pytest.mark.parametrize("out_dim,whiten", [(8, False), (8, True), (3, False)])
def test_pca_bit_equal(out_dim, whiten, tmp_path):
    rng = np.random.RandomState(0)
    basis = np.linalg.qr(rng.randn(64, 8))[0]
    X = rng.randn(500, 8) @ basis.T * 3.0 + rng.randn(500, 64) * 0.05 + 1.0
    mp, pp = ppca.fit_pca(X, out_dim, whiten)
    mj, pj = jpca.fit_pca(X, out_dim, whiten)
    np.testing.assert_array_equal(mp, mj)
    np.testing.assert_array_equal(pp, pj)
    assert ppca.explained_variance_ratio(X, out_dim) == jpca.explained_variance_ratio(X, out_dim)
    assert ppca.explained_variance_ratio(X, 8) > 0.99
    f = str(tmp_path / "pca.npz")
    ppca.save_pca(f, mp, pp)
    for load in (ppca.load_pca, jpca.load_pca):
        out = load(f)
        np.testing.assert_array_equal(out["mean"], mp)
        np.testing.assert_array_equal(out["proj"], pp)
    assert set(ppca.pca_params(X, out_dim)) == {"mean", "proj"}
    with pytest.raises(ValueError):
        ppca.fit_pca(X[:, :2], 3)


def test_pca_plugs_into_superpoint_extract():
    from d2slam_tpu.frontend import superpoint as jsp
    from d2slam_tpu_torch.frontend import superpoint as psp

    cfg_j = jsp.SuperPointConfig(max_keypoints=16, threshold=-1.0)
    params = jax.tree_util.tree_map(np.asarray, jsp.superpoint_init(jax.random.PRNGKey(0), cfg_j))
    rng = np.random.RandomState(2)
    params["pca"] = ppca.pca_params(rng.randn(300, 256), 64)
    img = rng.rand(64, 96).astype(np.float32)
    ref = jsp.superpoint_extract(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(img), cfg_j)
    model = psp.SuperPoint(params, psp.SuperPointConfig(max_keypoints=16, threshold=-1.0),
                           device="cpu")
    out = psp.superpoint_extract(model, torch.as_tensor(img)[None])
    assert out.desc.shape == (1, 16, 64)
    np.testing.assert_allclose(np.linalg.norm(out.desc[0].numpy(), axis=-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(out.kpts[0].numpy(), np.asarray(ref.kpts), atol=1e-3)
    np.testing.assert_allclose(out.desc[0].numpy(), np.asarray(ref.desc), atol=1e-4)
