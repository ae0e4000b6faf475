"""Parity of the port's depth modules with the JAX package on the CPU:
the remap, the three map builders, the cost-volume block matcher, the
point assembly and the configuration HitNet. Inputs are made with numpy
from a seed and go through both packages; each test states its
tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.depth import fisheye_undist as jfu
from d2slam_tpu.depth import hitnet as jhit
from d2slam_tpu.depth import stereo as jst
from d2slam_tpu.geometry import cameras as jc
from d2slam_tpu_torch.depth import fisheye_undist as tfu
from d2slam_tpu_torch.depth import hitnet as thit
from d2slam_tpu_torch.depth import stereo as tst
from d2slam_tpu_torch.geometry import cameras as tc

torch.set_num_threads(1)  # tests run one process per core (xdist)

KB = dict(fx=95.0, fy=95.0, cx=80.0, cy=60.0, k2=0.005)
MEI = dict(xi=1.1, fx=150.0, fy=150.0, cx=80.0, cy=60.0, k1=-0.05)


def _cams(kind):
    if kind == "kb":
        return jc.KBParams.make(**KB), tc.KBParams.make(**KB)
    return jc.MEIParams.make(**MEI), tc.MEIParams.make(**MEI)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]], np.float32)


# maps agree to 2e-3 px: the JAX builder evaluates the virtual focal and
# the rays in float32, the port's host scalars are float64


@pytest.mark.parametrize("kind", ["kb", "mei"])
def test_undistort_map_matches_jax(kind):
    jcam, tcam = _cams(kind)
    R = _rot_y(np.deg2rad(45.0))
    jm, jf = jfu.build_undistort_map(jcam, jnp.asarray(R), (48, 64), 90.0)
    tm, tf = tfu.build_undistort_map(tcam, R, (48, 64), 90.0, device="cpu")
    assert tm.shape == (48, 64, 2) and tm.dtype == torch.float32
    assert tf == pytest.approx(float(jf), rel=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-3)


def test_pinhole5_maps_match_jax():
    jcam, tcam = _cams("kb")
    jm, jf = jfu.build_pinhole5_maps(jcam, (32, 32), side_angle_deg=60.0)
    tm, tf = tfu.build_pinhole5_maps(tcam, (32, 32), side_angle_deg=60.0, device="cpu")
    assert tm.shape == (5, 32, 32, 2)
    assert tf == pytest.approx(float(jf), rel=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-3)


def test_cylindrical_map_matches_jax():
    jcam, tcam = _cams("kb")
    R = _rot_y(np.deg2rad(-20.0))
    jm, jp = jfu.build_cylindrical_map(jcam, (40, 96), fov_deg=150.0, v_range=0.8,
                                       R_fisheye_virtual=jnp.asarray(R))
    tm, tp = tfu.build_cylindrical_map(tcam, (40, 96), fov_deg=150.0, v_range=0.8,
                                       R_fisheye_virtual=R, device="cpu")
    assert tp.fx == pytest.approx(float(jp.fx), rel=1e-6)
    assert tp.fy == pytest.approx(float(jp.fy), rel=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-3)


def test_remap_bilinear_matches_jax():
    """Same image, same map (some samples out of range, some on the
    last row/column where the W - 1.001 clamp acts): equal to 1e-6."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (30, 40)).astype(np.float32)
    gain = rng.uniform(0.8, 1.2, (30, 40)).astype(np.float32)
    m = rng.uniform(-3, 43, (16, 20, 2)).astype(np.float32)
    m[0, :4] = [[39.0, 29.0], [38.9995, 28.9995], [0.0, 0.0], [38.5, 28.2]]
    for ph in (None, gain):
        j = jfu.remap_bilinear(jnp.asarray(img), jnp.asarray(m),
                               None if ph is None else jnp.asarray(ph))
        t = tfu.remap_bilinear(torch.as_tensor(img), torch.as_tensor(m),
                               None if ph is None else torch.as_tensor(ph))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    assert (t.numpy() == 0).any() and (t.numpy() > 0).any()
    # a batch of images through a batch of maps, and through one map
    imgs = rng.uniform(0, 1, (3, 30, 40)).astype(np.float32)
    maps = rng.uniform(0, 38, (3, 16, 20, 2)).astype(np.float32)
    tb = tfu.remap_bilinear(torch.as_tensor(imgs), torch.as_tensor(maps))
    t1 = tfu.remap_bilinear(torch.as_tensor(imgs), torch.as_tensor(maps[0]))
    for k in range(3):
        np.testing.assert_allclose(
            tb[k].numpy(),
            np.asarray(jfu.remap_bilinear(jnp.asarray(imgs[k]), jnp.asarray(maps[k]))),
            atol=1e-6)
        np.testing.assert_allclose(
            t1[k].numpy(),
            np.asarray(jfu.remap_bilinear(jnp.asarray(imgs[k]), jnp.asarray(maps[0]))),
            atol=1e-6)


def _pair(H=48, W=96, d_true=7.3, seed=2):
    from numpy.lib.stride_tricks import sliding_window_view

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (H, W + 64))
    for _ in range(2):
        base = (sliding_window_view(np.pad(base, 1, mode="edge"), (3, 3)) / 9).sum(axis=(2, 3))
    x_r = np.arange(W) + 16 + d_true
    x0 = np.floor(x_r).astype(int)
    f = x_r - x0
    left = base[:, 16:16 + W]
    right = base[:, x0] * (1 - f) + base[:, x0 + 1] * f
    return left.astype(np.float32), right.astype(np.float32)


def test_cost_volume_block_matcher_matches_jax():
    """The box filter sums in another order than XLA's reduce_window, so
    a near-tie may pick another winner: valid masks equal on >= 99.5 %,
    disparity within 1e-3 px where both are valid."""
    left, right = _pair()
    jd, jv = jst.block_match_disparity(jnp.asarray(left), jnp.asarray(right),
                                       max_disp=24, block=7)
    td, tv = tst.block_match_disparity(torch.as_tensor(left), torch.as_tensor(right),
                                       max_disp=24, block=7)
    jv, tv = np.asarray(jv), tv.numpy()
    assert (jv == tv).mean() >= 0.995
    both = jv & tv
    assert both.mean() > 0.3
    np.testing.assert_allclose(td.numpy()[both], np.asarray(jd)[both], atol=1e-3)
    assert abs(np.median(td.numpy()[both]) - 7.3) < 0.35
    # a batch gives what its pairs give one by one
    bd, bv = tst.block_match_disparity(torch.as_tensor(np.stack([left, right])),
                                       torch.as_tensor(np.stack([right, left])), 24, 7)
    assert torch.equal(bv[0], torch.as_tensor(tv))
    np.testing.assert_allclose(bd[0].numpy(), td.numpy(), atol=1e-6)
    # the dispatcher: "volume" is this path, "auto" the streaming matcher
    vd, vv = tst.disparity(torch.as_tensor(left), torch.as_tensor(right), 24, 7,
                           backend="volume")
    assert torch.equal(vv, torch.as_tensor(tv))
    ad, av = tst.disparity(torch.as_tensor(left), torch.as_tensor(right), 24, 7)
    assert av.float().mean() > 0.3
    assert abs(float(ad[av].median()) - 7.3) < 0.35
    with pytest.raises(ValueError):
        tst.disparity(torch.as_tensor(left), torch.as_tensor(right), backend="pallas")


def test_points_from_disparity_matches_jax():
    rng = np.random.default_rng(3)
    disp = rng.uniform(-1, 30, (20, 28)).astype(np.float32)
    valid = rng.uniform(size=(20, 28)) > 0.3
    kw = dict(fx=160.0, baseline=0.3, cx=14.0, cy=10.0, min_z=1.0, max_z=20.0)
    jp, jo = jst.points_from_disparity(jnp.asarray(disp), jnp.asarray(valid), **kw)
    tp, to = tst.points_from_disparity(torch.as_tensor(disp), torch.as_tensor(valid), **kw)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    ok = np.asarray(jo)
    assert ok.any()
    # f32; relative 1e-5 on depths up to 20 m
    np.testing.assert_allclose(tp.numpy()[ok], np.asarray(jp)[ok], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(48, 64), (40, 72)])
def test_hitnet_apply_matches_jax(hw):
    """JAX-initialised weights carried across (HWIO -> OIHW); outputs
    within 1e-4 px (f32 convolutions summed in another order)."""
    cfg_kw = dict(max_disp=32, feat_ch=8, levels=3)
    jparams = jhit.hitnet_init(jax.random.PRNGKey(0), jhit.HitNetConfig(**cfg_kw))
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jparams)
    # biases are zero at init; make them count
    rng = np.random.default_rng(1)
    jparams = {n: {"w": p["w"], "b": jnp.asarray(rng.normal(0, 0.05, p["b"].shape), jnp.float32)}
               for n, p in jparams.items()}
    tparams = thit.hitnet_params_from_numpy(
        {n: {k: np.asarray(v) for k, v in p.items()} for n, p in jparams.items()},
        device="cpu")
    left, right = _pair(*hw, d_true=5.0)
    L = np.stack([left, right])[..., None]
    R = np.stack([right, left])[..., None]
    jd = jhit.hitnet_apply(jparams, jnp.asarray(L), jnp.asarray(R), jhit.HitNetConfig(**cfg_kw))
    td = thit.hitnet_apply(tparams, torch.as_tensor(L), torch.as_tensor(R),
                           thit.HitNetConfig(**cfg_kw))
    assert td.shape == (2, *hw)
    assert float(td.min()) >= 0.0 and float(td.max()) > 0.0
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)


def test_hitnet_init_load_and_missing_onnx(tmp_path):
    cfg = thit.HitNetConfig(max_disp=16, feat_ch=4, levels=2)
    a = thit.hitnet_init(torch.Generator().manual_seed(5), cfg, device="cpu")
    b = thit.hitnet_init(torch.Generator().manual_seed(5), cfg, device="cpu")
    assert set(a) == {"stem", "enc0", "enc0b", "enc1", "enc1b", "ref0", "ref1", "ref_out"}
    assert all(torch.equal(a[n]["w"], b[n]["w"]) for n in a)
    assert a["ref0"]["w"].shape == (4, 5, 3, 3)
    # .npz round trip in the JAX package's key layout (HWIO)
    np.savez(tmp_path / "h.npz", **{f"{n}_{k}": (v.permute(2, 3, 1, 0) if k == "w" else v).numpy()
                                    for n, p in a.items() for k, v in p.items()})
    c = thit.load_params(str(tmp_path / "h.npz"), device="cpu")
    assert all(torch.equal(a[n]["w"], c[n]["w"]) for n in a)
    x = torch.rand(1, 16, 24, 1, generator=torch.Generator().manual_seed(0))
    d = thit.hitnet_apply(a, x, x, cfg)
    assert d.shape == (1, 16, 24) and bool(torch.isfinite(d).all())
    # the trained route reads the reference's ONNX export, which is not in
    # the repository (tests/test_torch_onnx.py runs it on a built graph)
    with pytest.raises(FileNotFoundError, match="hitnet_1x240x320_model_float32.onnx"):
        thit.load_trained_hitnet()
    with pytest.raises(FileNotFoundError, match="absent.onnx"):
        thit.load_trained_hitnet(str(tmp_path / "absent.onnx"), device="cpu")
