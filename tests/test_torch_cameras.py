"""Parity of the port's camera models and kalibr loader with the JAX
package on the CPU.

Seeded points go through ``*_project`` and ``*_lift`` of both packages.
In float32 pixels must agree to 1e-3 px (f32 at pixel magnitudes of a
few hundred has an ulp of ~3e-5, and the polynomials amplify it) and
rays to 1e-5; in float64 both to 1e-8. The round trips of ``tests/test_cameras.py`` are repeated
on the port in float64 with that file's tolerances.
"""
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.geometry import cameras as jc
from d2slam_tpu_torch.geometry import cameras as tc

torch.set_num_threads(1)  # tests run one process per core (xdist)


def rand_points(n=200, fov=0.7, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 20.0, n)
    xy = rng.uniform(-fov, fov, (n, 2))
    return np.concatenate([xy * d[:, None], d[:, None]], axis=1)


# name -> (params class name, project, lift, kwargs, fov, round-trip tol, use median)
MODELS = {
    "pinhole": ("PinholeParams", "pinhole_project", "pinhole_lift",
                dict(fx=460.0, fy=459.0, cx=320.0, cy=240.0, k1=-0.28, k2=0.07,
                     p1=2e-4, p2=-2e-5), 0.7, 1e-7, False),
    "kb": ("KBParams", "kb_project", "kb_lift",
           dict(fx=380.0, fy=379.0, cx=320.0, cy=240.0, k2=0.01, k3=-0.002,
                k4=0.0005, k5=-1e-4), 1.5, 1e-7, False),
    "mei": ("MEIParams", "mei_project", "mei_lift",
            dict(xi=1.2, fx=600.0, fy=600.0, cx=320.0, cy=240.0, k1=-0.1, k2=0.02),
            1.2, 1e-8, False),
    "pinhole_full": ("PinholeFullParams", "pinhole_full_project", "pinhole_full_lift",
                     dict(fx=460.0, fy=459.0, cx=320.0, cy=240.0, k1=-0.3, k2=0.09,
                          p1=1e-4, p2=-2e-4, k3=-0.01, k4=-0.05, k5=0.01, k6=0.0),
                     0.6, 1e-6, False),
    "cylindrical": ("CylindricalParams", "cylindrical_project", "cylindrical_lift",
                    dict(fx=200.0, fy=200.0, cx=320.0, cy=120.0), 2.5, 1e-9, False),
    "scaramuzza": ("ScaramuzzaParams", "scaramuzza_project", "scaramuzza_lift",
                   dict(a0=-250.0, a2=1.2e-3, a3=-2e-7, a4=6e-10, cx=320.0, cy=240.0),
                   1.0, 1e-6, True),
    "polyfisheye": ("PolyFisheyeParams", "polyfisheye_project", "polyfisheye_lift",
                    dict(A11=320.0, A22=318.0, u0=320.0, v0=240.0, k2=-0.02,
                         k3=0.004, k4=-0.0008, A12=0.5), 0.9, 1e-8, False),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_project_lift_match_jax(model, dtype):
    cls, proj, lift, kw, fov, _, _ = MODELS[model]
    uv_tol, ray_tol = (1e-3, 1e-5) if dtype == "float32" else (1e-8, 1e-8)
    pts = rand_points(fov=fov, seed=1).astype(dtype)
    jp = getattr(jc, cls).make(**kw, dtype=jnp.dtype(dtype))
    tp = getattr(tc, cls).make(**kw)
    j_uv, j_valid = getattr(jc, proj)(jnp.asarray(pts), jp)
    t_uv, t_valid = getattr(tc, proj)(torch.as_tensor(pts), tp)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    assert str(t_uv.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(t_uv.numpy(), np.asarray(j_uv), atol=uv_tol)
    # lift the JAX pixels through both, so the comparison is of lift alone
    uv = np.array(j_uv)
    np.testing.assert_allclose(getattr(tc, lift)(torch.as_tensor(uv), tp).numpy(),
                               np.asarray(getattr(jc, lift)(jnp.asarray(uv), jp)),
                               atol=ray_tol)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_roundtrip_float64(model):
    cls, proj, lift, kw, fov, tol, use_median = MODELS[model]
    pts = torch.as_tensor(rand_points(fov=fov, seed=2))
    params = getattr(tc, cls).make(**kw)
    uv, valid = getattr(tc, proj)(pts, params)
    assert uv.dtype == torch.float64
    rays = getattr(tc, lift)(uv, params)
    gt = pts / torch.linalg.norm(pts, dim=-1, keepdim=True)
    err = torch.linalg.norm(rays - gt, dim=-1)[valid].numpy()
    assert len(err) > 100
    assert (np.median(err) if use_median else err.max()) < tol


def test_behind_camera_is_invalid_and_dispatch():
    params = tc.PinholeParams.make(460.0, 460.0, 320.0, 240.0)
    pts = torch.tensor([[0.0, 0, -1.0], [0.1, 0.1, 2.0]])
    _, v = tc.project(params, pts)
    assert not bool(v[0]) and bool(v[1])
    kb = tc.KBParams.make(190.0, 190.0, 320.0, 240.0, k2=0.005)
    uv, _ = tc.project(kb, pts[1:])
    np.testing.assert_allclose(uv.numpy(), tc.kb_project(pts[1:], kb)[0].numpy())


def _write_chain(tmp_path):
    """cam1 sits 10 cm right of cam0, both tilted; T_cn_cnm1 consistent
    with the two T_cam_imu blocks (as tests/test_kalibr.py)."""
    from d2slam_tpu_torch.utils import np_lie

    def T_of(rvec, t):
        rvec = np.asarray(rvec, np.float64)
        ang = np.linalg.norm(rvec)
        q = np.concatenate([np.sin(ang / 2) * rvec / ang, [np.cos(ang / 2)]])
        T = np.eye(4)
        T[:3, :3] = np_lie.quat_to_rotmat(q)
        T[:3, 3] = t
        return T

    T0 = T_of([0.02, -0.01, 0.03], [0.05, -0.06, 0.07])
    T1 = T_of([-0.01, 0.02, 0.025], [-0.05, -0.055, 0.071])
    T10 = T1 @ np.linalg.inv(T0)

    def rows(T):
        return "\n".join(
            "    - [" + ", ".join(f"{float(v)!r}" for v in r) + "]" for r in T)

    text = textwrap.dedent("""\
    cam0:
      T_cam_imu:
    {t0}
      cam_overlaps: [1]
      camera_model: omni
      distortion_coeffs: [-0.06, 0.17, 0.0007, 0.0005]
      distortion_model: radtan
      intrinsics: [1.79, 533.3, 533.2, 254.6, 256.5]
      resolution: [512, 512]
      rostopic: /cam0/image_raw
    cam1:
      T_cam_imu:
    {t1}
      T_cn_cnm1:
    {t10}
      cam_overlaps: [0]
      camera_model: pinhole
      distortion_coeffs: [-0.01, 0.005, 0.0001, -0.0002]
      distortion_model: equidistant
      intrinsics: [460.0, 461.0, 320.0, 240.0]
      resolution: [640, 480]
      rostopic: /cam1/image_raw
    """).format(t0=rows(T0), t1=rows(T1), t10=rows(T10))
    p = tmp_path / "camchain.yaml"
    p.write_text(text)
    return str(p), T0


def test_kalibr_chain_matches_jax(tmp_path):
    pytest.importorskip("yaml")
    from d2slam_tpu.geometry.kalibr import load_camchain as j_load
    from d2slam_tpu_torch.geometry.kalibr import (
        chain_consistency_errors,
        load_camchain,
    )

    path, T0 = _write_chain(tmp_path)
    for ext_type in (0, 1):
        chain = load_camchain(path, extrinsic_parameter_type=ext_type)
        j_chain = j_load(path, extrinsic_parameter_type=ext_type, dtype=jnp.float64)
        assert [c.name for c in chain] == ["cam0", "cam1"]
        assert [c.model for c in chain] == ["omni", "kb"] == [c.model for c in j_chain]
        assert chain[0].resolution == (512, 512) and chain[0].overlaps == (1,)
        assert chain[1].rostopic == "/cam1/image_raw"
        assert chain[0].params.xi == pytest.approx(1.79)
        assert chain[1].params.k2 == pytest.approx(-0.01)  # kalibr k1
        for c, jcam in zip(chain, j_chain):
            # quaternion sign is free: compare as rotations
            e, je = c.extrinsic, np.asarray(jcam.extrinsic)
            np.testing.assert_allclose(e[:3], je[:3], atol=1e-9)
            assert abs(abs(e[3:] @ je[3:]) - 1.0) < 1e-9
    # project/lift round trip through the dispatched camera, and vs JAX
    pts = np.array([[0.3, -0.2, 2.0], [-0.5, 0.4, 3.0]])
    d = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    for c, jcam in zip(chain, j_chain):
        uv, valid = c.project(torch.as_tensor(pts))
        assert bool(valid.all())
        np.testing.assert_allclose(uv.numpy(), np.asarray(jcam.project(jnp.asarray(pts))[0]),
                                   atol=1e-8)
        np.testing.assert_allclose(c.lift(uv).numpy(), d, atol=1e-6)
    assert max(chain_consistency_errors(chain)) < 1e-9
    # type 1 takes T_cam_imu verbatim
    np.testing.assert_allclose(chain[0].extrinsic[:3], T0[:3, 3], atol=1e-12)
