"""The port's device pyramidal LK, its Lie identities and ``so3_log``, and
``split_global_id`` against the JAX package on the CPU.

* ``build_pyramid`` / ``lk_track_pyramidal`` (``d2slam_tpu/frontend/
  lk.py``) on the same seeded numpy images: the pyramids within 1e-6,
  the tracked points within 1e-3 px where both packages say ``ok``, the
  ``ok`` masks equal. One case at tests/test_frontend.py::
  test_lk_tracks_known_shift's shapes (2 levels, win 15, iters 15, a
  shifted texture); one at the defaults (3 levels, win 21, iters 10) on
  a 120x160 image with 40 points, some on a flat patch (the structure
  tensor's ``det`` gate) and some that the shift carries out of the
  image (the 1-pixel border test). No point of either case lies within
  1e-3 px of ``fb_thresh``, so no flip of the mask is allowed.
  The native host LK keeps the same points within 0.05 px on 240x320.
* ``quat_identity``, ``pose_identity`` and ``so3_log`` on seeded
  rotations: 1e-6 in float32, 1e-12 in float64.
* ``split_global_id`` inverts ``global_frame_id``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates

import d2slam_tpu.frontend.lk as jlk
import d2slam_tpu.geometry.lie as jlie
import d2slam_tpu.vins.types as jtypes
import d2slam_tpu_torch.frontend as pfrontend
import d2slam_tpu_torch.frontend.lk as plk
import d2slam_tpu_torch.geometry.lie as plie
import d2slam_tpu_torch.vins.types as ptypes
from tests.test_frontend import make_texture

torch.set_num_threads(1)  # tests run one process per core (xdist)

PYR_TOL = 1e-6     # grey levels
PTS_TOL = 1e-3     # px
CPU = torch.device("cpu")


def _shifted(img, shift):
    H, W = img.shape
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return map_coordinates(img, [yy - shift[1], xx - shift[0]], order=1, mode="nearest")


def _known_shift_case():
    """tests/test_frontend.py::test_lk_tracks_known_shift."""
    img0 = make_texture()
    pts = np.stack(np.meshgrid(np.arange(30, 130, 20), np.arange(30, 90, 20)),
                   -1).reshape(-1, 2).astype(np.float32)
    return img0, _shifted(img0, (3.0, -2.0)), pts, dict(levels=2, win=15, iters=15)


def _default_case():
    """Defaults on 120x160 with 40 points: 28 on the texture, 6 at the
    centre of a flat 64x64 patch, 6 on the right edge that a 3 px shift
    carries out of the image."""
    rng = np.random.default_rng(4)
    img0 = make_texture(seed=1)
    img0[4:68, 8:72] = 0.5
    inner = np.stack([rng.uniform(80, 150, 28), rng.uniform(10, 110, 28)], 1)
    flat = np.stack([rng.uniform(36, 44, 6), rng.uniform(32, 40, 6)], 1)
    edge = np.stack([rng.uniform(157.0, 158.5, 6), rng.uniform(20, 100, 6)], 1)
    pts = np.concatenate([inner, flat, edge]).astype(np.float32)
    return img0, _shifted(img0, (3.0, -1.5)), pts, dict(levels=3, win=21, iters=10)


CASES = {"known_shift": _known_shift_case, "defaults": _default_case}


def _both(case):
    img0, img1, pts, kw = CASES[case]()
    levels, lk_kw = kw["levels"], dict(win=kw["win"], iters=kw["iters"])
    valid = np.ones(len(pts), bool)
    valid[1] = False
    jp0 = jlk.build_pyramid(jnp.asarray(img0, jnp.float32), levels)
    jp1 = jlk.build_pyramid(jnp.asarray(img1, jnp.float32), levels)
    jpts, jok = jlk.lk_track_pyramidal(jp0, jp1, jnp.asarray(pts), jnp.asarray(valid), **lk_kw)
    pp0 = plk.build_pyramid(img0.astype(np.float32), levels, device=CPU)
    pp1 = pfrontend.build_pyramid(torch.as_tensor(img1, dtype=torch.float32), levels)
    ppts, pok = pfrontend.lk_track_pyramidal(pp0, pp1, pts, valid, **lk_kw)
    return dict(img0=img0, img1=img1, pts=pts, valid=valid, kw=kw,
                jax=([np.asarray(x) for x in jp0 + jp1], np.asarray(jpts), np.asarray(jok)),
                port=([x.numpy() for x in pp0 + pp1], ppts.numpy(), pok.numpy()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_lk_equals_jax(case):
    r = _both(case)
    (jpyr, jpts, jok), (ppyr, ppts, pok) = r["jax"], r["port"]
    assert [p.shape for p in ppyr] == [p.shape for p in jpyr]
    for a, b in zip(ppyr, jpyr):
        np.testing.assert_allclose(a, b, atol=PYR_TOL, rtol=0)
    np.testing.assert_array_equal(pok, jok)
    both = pok & jok
    np.testing.assert_allclose(ppts[both], jpts[both], atol=PTS_TOL, rtol=0)
    assert not pok[1]
    assert both.sum() >= len(both) // 2
    if case == "known_shift":   # the JAX test's pin on the port
        np.testing.assert_allclose((ppts - r["pts"])[pok].mean(0), (3.0, -2.0), atol=0.15)
    else:                       # both gates fire
        assert not pok[28:].any() and pok[:28].sum() >= 25
        torch_det_gate = plk._lk_level(
            plk.build_pyramid(r["img0"], 0, device=CPU)[0],
            plk.build_pyramid(r["img1"], 0, device=CPU)[0],
            torch.as_tensor(r["pts"][28:34]), torch.zeros(6, 2), 21, 1)[1]
        assert not torch_det_gate.any()


def test_device_lk_agrees_with_native_lk():
    """At the defaults on a 240x320 texture (its coarsest level, 30x40,
    still holds the 21 px window: on 120x160 the native LK's clamped
    gradient images differ from the device LK's clipped samples over
    the whole coarsest level), the batched device LK and the tracker's
    native host LK keep the same points and put them within 0.05 px."""
    rng = np.random.default_rng(2)
    img0 = make_texture(240, 320, seed=2).astype(np.float32)
    img1 = _shifted(img0, (2.3, -1.2)).astype(np.float32)
    pts = np.stack([rng.uniform(15, 305, 60), rng.uniform(15, 225, 60)], 1).astype(np.float32)
    valid = np.ones(len(pts), bool)
    ppts, pok = plk.lk_track_pyramidal(plk.build_pyramid(img0, device=CPU),
                                       plk.build_pyramid(img1, device=CPU), pts, valid)
    npts, nok = plk.lk_track_images(img0, img1, pts, valid)
    pok = pok.numpy()
    np.testing.assert_array_equal(pok, nok)
    assert pok.sum() >= 55
    np.testing.assert_allclose(ppts.numpy()[pok], npts[pok], atol=0.05, rtol=0)


def test_device_lk_wants_a_card_for_arrays(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plk.build_pyramid(np.zeros((8, 8), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lie_identities_and_so3_log_equal_jax(dtype):
    tol = {"float32": 1e-6, "float64": 1e-12}[dtype]
    tdt = getattr(torch, dtype)
    np.testing.assert_array_equal(plie.quat_identity(tdt, CPU).numpy(),
                                  np.asarray(jlie.quat_identity(getattr(jnp, dtype))))
    np.testing.assert_array_equal(plie.pose_identity(tdt, CPU).numpy(),
                                  np.asarray(jlie.pose_identity(getattr(jnp, dtype))))
    assert plie.quat_identity(tdt, CPU).dtype == tdt
    rng = np.random.default_rng(7)
    q = rng.normal(0, 1, (64, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:4] = [[0, 0, 0, 1], [0, 0, 0, -1], [1, 0, 0, 0], [0, 0.6, 0, 0.8]]  # 0, pi, small
    q[4] = [1e-5, 0, 0, 1]
    R = np.asarray(jlie.quat_to_rotmat(jnp.asarray(q))).astype(dtype)
    want = np.asarray(jlie.so3_log(jnp.asarray(R)))
    got = plie.so3_log(torch.as_tensor(R))
    assert got.dtype == tdt and got.shape == (64, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def test_split_global_id_inverts_global_frame_id():
    for d, f in [(0, 0), (0, 17), (3, 12345), (7, (1 << 20) + 5), (15, 2 ** 31)]:
        gid = ptypes.global_frame_id(d, f)
        assert gid == jtypes.global_frame_id(d, f)
        assert ptypes.split_global_id(gid) == jtypes.split_global_id(gid)
        assert ptypes.split_global_id(gid) == (d, f & (ptypes.GID_SHIFT - 1))
