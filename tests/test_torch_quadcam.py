"""The quadcam depth slice of the port against the JAX package on the
CPU: 4 rendered fisheye views of a textured cylinder wall -> virtual
stereo -> disparity -> point clouds.

The set-up is the JAX package's golden one (tests/test_golden_ate.py):
fisheyes 240x320 with f = 95, virtual views 120x160, max_disp 32,
block 7, ring radius 0.3/sqrt(2), wall radius 5 m.

* ``backend="auto"`` (on the CPU: ``bm_plain``, the plain version of the
  CUDA kernel) against the JAX pipeline composed here from
  ``remap_bilinear`` -> ``block_match_disparity_fused(interpret=True)``
  -> ``points_from_disparity``.
* ``backend="volume"`` against the JAX ``quadcam_depth`` as it runs on
  the CPU (the XLA cost-volume path).

Tolerances: valid masks equal on >= 99.5 % of the pixels, points within
1e-3 m where both are valid, when both packages remap through the same
tables; with each package's own tables (they differ by up to 2e-3 px,
float32 against float64 host scalars) 99 % and 2e-2 m.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.depth import quadcam as jq
from d2slam_tpu.depth.fisheye_undist import remap_bilinear as j_remap
from d2slam_tpu.depth.stereo import points_from_disparity as j_points
from d2slam_tpu.geometry.cameras import KBParams as JKB
from d2slam_tpu.ops.stereo_bm_pallas import block_match_disparity_fused as j_fused
from d2slam_tpu_torch.depth import quadcam as tq
from d2slam_tpu_torch.geometry.cameras import KBParams
from d2slam_tpu_torch.utils.render import cylinder_wall_disparity, render_cylinder_wall
from d2slam_tpu_torch.utils.sim import fisheye_ring_extrinsics

torch.set_num_threads(1)  # tests run one process per core (xdist)

HF, WF, R_WALL = 240, 320, 5.0
KB = dict(fx=95.0, fy=95.0, cx=WF / 2, cy=HF / 2, k2=0.005)
CFG = dict(out_hw=(120, 160), min_z=1.0, max_z=20.0, max_disp=32, block=7)


@pytest.fixture(scope="module")
def scene():
    ext = fisheye_ring_extrinsics(0.3)
    fish_t = [KBParams.make(**KB) for _ in range(4)]
    fish_j = [JKB.make(**KB) for _ in range(4)]
    imgs = [render_cylinder_wall(fish_t[i], ext[i], (HF, WF), R_WALL, seed=7)
            for i in range(4)]
    t_pairs = tq.build_virtual_stereo(fish_t, ext, tq.QuadcamConfig(**CFG), device="cpu")
    j_pairs = jq.build_virtual_stereo(fish_j, ext, jq.QuadcamConfig(**CFG))
    # the JAX tables carried across: plain torch.as_tensor
    shared = [p._replace(map_left=torch.as_tensor(np.array(jp.map_left)),
                         map_right=torch.as_tensor(np.array(jp.map_right)),
                         focal=jp.focal)
              for p, jp in zip(t_pairs, j_pairs)]
    return dict(ext=ext, imgs=imgs, t_pairs=t_pairs, j_pairs=j_pairs, shared=shared)


def _jax_fused_pipeline(imgs, j_pairs):
    H, W = CFG["out_hw"]
    out = []
    for p in j_pairs:
        left = j_remap(jnp.asarray(imgs[p.cam_left]), p.map_left)
        right = j_remap(jnp.asarray(imgs[p.cam_right]), p.map_right)
        disp, valid = j_fused(left, right, max_disp=CFG["max_disp"],
                              block=CFG["block"], interpret=True)
        pts, ok = j_points(disp, valid, fx=p.focal, baseline=p.baseline,
                           cx=W / 2.0, cy=H / 2.0, min_z=CFG["min_z"], max_z=CFG["max_z"])
        out.append((np.asarray(pts), np.asarray(ok)))
    return out


def _hold(t_out, j_out, min_agree, atol):
    n_ok = 0
    for (tp, to, *_), (jp, jo, *_) in zip(t_out, j_out):
        to, jo = to.numpy(), np.asarray(jo)
        assert (to == jo).mean() >= min_agree, (to == jo).mean()
        both = to & jo
        n_ok += int(both.sum())
        np.testing.assert_allclose(tp.numpy()[both], np.asarray(jp)[both], atol=atol)
    assert n_ok > 0.2 * 4 * to.size


def test_pairs_match_jax(scene):
    assert len(scene["t_pairs"]) == 4
    for p, jp in zip(scene["t_pairs"], scene["j_pairs"]):
        assert (p.cam_left, p.cam_right) == (jp.cam_left, jp.cam_right)
        assert p.baseline == pytest.approx(jp.baseline, abs=1e-12)
        assert p.baseline == pytest.approx(0.3, abs=1e-9)
        assert p.focal == pytest.approx(jp.focal, rel=1e-6)
        np.testing.assert_allclose(p.map_left.numpy(), np.asarray(jp.map_left), atol=2e-3)
        np.testing.assert_allclose(p.map_right.numpy(), np.asarray(jp.map_right), atol=2e-3)
        np.testing.assert_array_equal(p.T_body_virtual, jp.T_body_virtual)


def test_quadcam_depth_fused_matches_jax_pipeline(scene):
    cfg = tq.QuadcamConfig(**CFG)
    j_out = _jax_fused_pipeline(scene["imgs"], scene["j_pairs"])
    # same tables: the strict comparison of remap + matcher + points
    _hold(tq.quadcam_depth(scene["imgs"], scene["shared"], cfg, device="cpu"),
          j_out, 0.995, 1e-3)
    # each package's own tables
    t_out = tq.quadcam_depth(scene["imgs"], scene["t_pairs"], cfg, device="cpu")
    _hold(t_out, j_out, 0.99, 2e-2)

    # the pins of the JAX package's own tests, on the port: the wall's
    # depth, and pair 0's disparity against the analytic wall
    for pts, ok in t_out:
        assert ok.float().mean() >= 0.05
        assert 3.0 < float(pts[..., 2][ok].median()) < 7.5
    p = scene["t_pairs"][0]
    H, W = CFG["out_hw"]
    pts, ok = t_out[0]
    disp = np.where(ok.numpy(), p.focal * p.baseline / pts[..., 2].numpy(), 0.0)
    disp_gt = cylinder_wall_disparity(p.focal, p.baseline, scene["ext"][0], (H, W), R_WALL)
    sel = ok.numpy() & (disp > 0.5) & (disp_gt < CFG["max_disp"] - 1)
    sel[:, :8] = False  # left occlusion band
    assert sel.mean() > 0.3
    assert np.sqrt(np.mean((disp[sel] - disp_gt[sel]) ** 2)) < 0.35


def test_quadcam_depth_volume_colour_photometric_match_jax(scene):
    """The cost-volume backend against the JAX ``quadcam_depth`` on the
    CPU, with a vignette gain per camera and RGB textures."""
    rng = np.random.default_rng(0)
    gains = [rng.uniform(0.9, 1.1, (HF, WF)).astype(np.float32) for _ in range(4)]
    tints = np.array([[1.0, 0.6, 0.6], [0.6, 1.0, 0.6], [0.6, 0.6, 1.0], [1.0, 1.0, 0.6]])
    colors = [(scene["imgs"][i][..., None] * tints[i]).astype(np.float32) for i in range(4)]
    j_out = jq.quadcam_depth(
        [jnp.asarray(im) for im in scene["imgs"]], scene["j_pairs"], jq.QuadcamConfig(**CFG),
        photometric=[jnp.asarray(g) for g in gains],
        color_images=[jnp.asarray(c) for c in colors])
    t_out = tq.quadcam_depth(scene["imgs"], scene["shared"], tq.QuadcamConfig(**CFG),
                             photometric=gains, color_images=colors,
                             backend="volume", device="cpu")
    _hold(t_out, j_out, 0.995, 1e-3)
    for (_, _, tt), (_, _, jt) in zip(t_out, j_out):
        assert tt.shape == (*CFG["out_hw"], 3)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    # gray textures keep [H, W]; clouds go to the body frame as in JAX
    g_out = tq.quadcam_depth(scene["imgs"], scene["shared"], tq.QuadcamConfig(**CFG),
                             color_images=scene["imgs"], backend="volume", device="cpu")
    assert g_out[1][2].shape == CFG["out_hw"]
    body = tq.cloud_in_body(scene["t_pairs"][1], t_out[1][0])
    np.testing.assert_allclose(
        body.numpy(), np.asarray(jq.cloud_in_body(scene["j_pairs"][1],
                                                  jnp.asarray(t_out[1][0].numpy()))),
        atol=1e-5)


def test_quadcam_depth_hitnet_option(scene):
    """With ``hitnet=(apply, params)`` the disparity comes from the
    network: finite, non-negative, and valid where it exceeds 0.5 px."""
    from d2slam_tpu_torch.depth.hitnet import HitNetConfig, hitnet_apply, hitnet_init

    hcfg = HitNetConfig(max_disp=32, feat_ch=8, levels=3)
    params = hitnet_init(torch.Generator().manual_seed(0), hcfg, device="cpu")
    seen = {}

    def apply(p, left, right):
        seen["shape"] = tuple(left.shape)
        seen["disp"] = hitnet_apply(p, left[..., None], right[..., None], hcfg)
        return seen["disp"]

    out = tq.quadcam_depth(scene["imgs"], scene["t_pairs"], tq.QuadcamConfig(**CFG),
                           hitnet=(apply, params), device="cpu")
    assert seen["shape"] == (4, *CFG["out_hw"])
    assert bool(torch.isfinite(seen["disp"]).all()) and float(seen["disp"].min()) >= 0.0
    for k, (pts, ok) in enumerate(out):
        assert pts.shape == (*CFG["out_hw"], 3)
        assert not bool((ok & ~(seen["disp"][k] > 0.5)).any())
