"""The port's NetVLAD module against ``netvlad_apply`` of the JAX package
on the CPU: the trained weights of weights/netvlad_synth.npz (PCA to 1024
plus the gate component: 1025-d) at an even and an odd image size, where
XLA's ``SAME`` padding of the stride-2 convolutions is asymmetric;
seeded narrow random parameters in both directions; the int8 wire
quantization. Max abs difference <= 2e-5 on the unit output."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.frontend import netvlad as jnv
from d2slam_tpu.frontend.train_frontend import load_weights
from d2slam_tpu_torch.frontend import netvlad as pnv

torch.set_num_threads(1)  # tests run one process per core (xdist)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "netvlad_synth.npz")
ATOL = 2e-5


def _jax_apply(params, img):
    p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), params)
    return np.asarray(jnv.netvlad_apply(p, jnp.asarray(img)[..., None],
                                        jnv.netvlad_cfg_from_params(p)))


@pytest.mark.parametrize("hw", [(64, 80), (59, 83)])
def test_trained_netvlad_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    img = rng.uniform(0, 1, (2,) + hw).astype(np.float32)
    params = pnv.load_params(WEIGHTS)
    model = pnv.NetVLAD(params, device="cpu")
    out = model(torch.as_tensor(img)).numpy()
    ref = _jax_apply(load_weights(WEIGHTS), img)
    assert out.shape == ref.shape == (2, 1025)
    assert model.output_dim == pnv.netvlad_output_dim(params) == jnv.netvlad_output_dim(params)
    assert model.calls == 1
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    assert np.abs(out - ref).max() <= ATOL


def test_seeded_jax_init_through_port():
    """A narrow network drawn by the JAX package's ``netvlad_init`` (with a
    PCA block) runs the same in the port."""
    cfg = jnv.NetVLADConfig(num_clusters=8, feat_dim=16, output_dim=128, pca_dim=32,
                            width_mult=0.5)
    params = jax.tree_util.tree_map(np.asarray, jnv.netvlad_init(jax.random.PRNGKey(4), cfg))
    img = np.random.default_rng(1).uniform(0, 1, (1, 45, 62)).astype(np.float32)
    out = pnv.NetVLAD(params, device="cpu")(torch.as_tensor(img)).numpy()
    ref = _jax_apply(params, img)
    assert out.shape == ref.shape == (1, 32)
    assert np.abs(out - ref).max() <= ATOL


def test_seeded_port_init_through_jax():
    """The port's ``netvlad_init`` (explicit torch.Generator) emits the
    JAX layout: the JAX package applies it to the same result."""
    cfg = pnv.NetVLADConfig(num_clusters=8, feat_dim=16, output_dim=128, width_mult=0.5)
    g = torch.Generator().manual_seed(3)
    params = pnv.netvlad_init(g, cfg)
    again = pnv.netvlad_init(torch.Generator().manual_seed(3), cfg)
    np.testing.assert_array_equal(params["ds2"]["pw"]["w"], again["ds2"]["pw"]["w"])
    assert params["stem"]["w"].shape == (3, 3, 1, 8)
    assert params["ds1"]["dw"]["w"].shape == (3, 3, 1, 8)
    assert pnv.netvlad_cfg_from_params(params) == pnv.NetVLADConfig(
        num_clusters=8, feat_dim=16, output_dim=128)
    img = np.random.default_rng(2).uniform(0, 1, (1, 40, 48)).astype(np.float32)
    out = pnv.NetVLAD(params, device="cpu")(torch.as_tensor(img)).numpy()
    ref = _jax_apply(params, img)
    assert out.shape == ref.shape == (1, 128)
    assert np.abs(out - ref).max() <= ATOL


def test_int8_quantization_matches_jax():
    v = np.random.default_rng(0).normal(0, 1, (3, 1025)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    qj, sj = jnv.quantize_descriptor_int8(jnp.asarray(v))
    qp, sp = pnv.quantize_descriptor_int8(torch.as_tensor(v))
    assert qp.dtype == torch.int8
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=1e-7)
    dj = np.asarray(jnv.dequantize_descriptor_int8(qj, sj))
    dp = pnv.dequantize_descriptor_int8(qp, sp).numpy()
    np.testing.assert_allclose(dp, dj, atol=1e-7)
    assert np.abs(dp - v).max() < 0.01


def test_netvlad_needs_a_card_or_cpu(monkeypatch, tmp_path):
    """Both routes, the native module and the ONNX export
    (``netvlad_from_onnx``, tests/test_torch_onnx.py holds it against the
    JAX loader), default to the card."""
    from d2slam_tpu_torch.tools.onnx_io import OnnxGraph, OnnxNode, save_onnx

    path = str(tmp_path / "nv.onnx")
    save_onnx(OnnxGraph(nodes=[OnnxNode("Flatten", ["image:0"], ["descriptor:0"])],
                        initializers={"w": np.ones(4, np.float32)},
                        inputs=[("image:0", (1, 4, 4, 1))], outputs=["descriptor:0"]), path)
    v = pnv.netvlad_from_onnx(path, device="cpu")(torch.rand(2, 4, 4))
    assert v.shape == (2, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnv.NetVLAD(pnv.load_params(WEIGHTS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnv.netvlad_from_onnx(path)
