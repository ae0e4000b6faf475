"""The port's calibration tools (``d2slam_tpu_torch/tools/calibration.py``)
on tests/test_calibration.py's four scenarios, on the CPU.

The pinhole calibration runs through both packages on the same corners
(a module fixture): every intrinsic within 1e-6 of the JAX estimate
(absolute, in pixels or unitless coefficients) and the RMS within 1e-9.
The Kannala-Brandt, stereo-extrinsic and vignette scenarios hold the
port to the JAX tests' pins; the vignette fit (numpy in the JAX
package) also to its coefficients, within 1e-9."""
import numpy as np
import pytest
import torch

from d2slam_tpu.geometry import cameras as jcam
from d2slam_tpu.tools import calibrate_pinhole as j_calibrate_pinhole
from d2slam_tpu.tools import calibrate_vignette as j_calibrate_vignette
from d2slam_tpu_torch.geometry.cameras import KBParams, PinholeParams, pinhole_project
from d2slam_tpu_torch.tools import calibrate_kb, calibrate_pinhole, calibrate_vignette
from d2slam_tpu_torch.tools.calibration import calibrate_stereo_extrinsic
from d2slam_tpu_torch.utils import np_lie
from tests.test_calibration import make_board, render_views

torch.set_num_threads(1)  # tests run one process per core (xdist)

TOL = 1e-6


@pytest.fixture(scope="module")
def pinhole_both():
    gt = jcam.PinholeParams.make(420.0, 418.0, 325.0, 245.0, k1=-0.25, k2=0.06)
    board = make_board()
    img_pts = render_views(jcam.pinhole_project, gt, board)
    return (calibrate_pinhole(board, img_pts, (640, 480), device="cpu"),
            j_calibrate_pinhole(board, img_pts, (640, 480)))


def test_pinhole_matches_jax(pinhole_both):
    (est, rms), (jest, jrms) = pinhole_both
    assert isinstance(est, PinholeParams)
    np.testing.assert_allclose(np.asarray(est, np.float64), np.asarray(jest, np.float64),
                               rtol=0, atol=TOL)
    assert abs(rms - jrms) < 1e-9


def test_pinhole_pins(pinhole_both):
    (est, rms), _ = pinhole_both
    assert rms < 0.3
    assert abs(est.fx - 420.0) < 4.0 and abs(est.fy - 418.0) < 4.0
    assert abs(est.cx - 325.0) < 4.0 and abs(est.k1 + 0.25) < 0.03


def test_calibrate_kb():
    gt = jcam.KBParams.make(200.0, 199.0, 322.0, 242.0, k2=0.02, k3=-0.004)
    board = make_board(square=0.08)
    img_pts = render_views(jcam.kb_project, gt, board, seed=2)
    est, rms = calibrate_kb(board, img_pts, (640, 480), f_guess=210.0, device="cpu")
    assert isinstance(est, KBParams)
    assert rms < 0.3
    assert abs(est.fx - 200.0) < 4.0 and abs(est.cx - 322.0) < 4.0


def test_calibrate_vignette():
    H, W = 240, 320
    ys, xs = np.mgrid[0:H, 0:W]
    r2 = ((xs - 160) ** 2 + (ys - 120) ** 2) / 160.0**2
    img = 0.8 * (1.0 - 0.4 * r2 + 0.05 * r2**2)
    coeffs, corr = calibrate_vignette(img, device="cpu")
    jcoeffs, jcorr = j_calibrate_vignette(img)
    np.testing.assert_allclose(coeffs, jcoeffs, rtol=0, atol=1e-9)
    np.testing.assert_allclose(corr.numpy(), jcorr, rtol=1e-9)
    flat = img * corr.numpy()
    assert flat.std() / flat.mean() < 0.02


def test_calibrate_stereo_extrinsic():
    from d2slam_tpu_torch.geometry.lie import so3_exp_quat

    rng = np.random.default_rng(5)
    board = make_board()
    p0 = PinholeParams(460.0, 458.0, 320.0, 240.0)
    p1 = PinholeParams(455.0, 456.0, 318.0, 242.0)
    q_gt = so3_exp_quat(torch.tensor([0.0, 0.02, 0.005], dtype=torch.float64)).numpy()
    rel_gt = np.concatenate([[-0.12, 0.001, 0.002], q_gt])
    img0, img1 = [], []
    while len(img0) < 8:
        q = so3_exp_quat(torch.as_tensor(rng.normal(0, 0.2, 3))).numpy()
        t = np.array([rng.normal(0, 0.06), rng.normal(0, 0.05), rng.uniform(0.45, 0.7)])
        pose = np.concatenate([t, q])  # cam0_T_board
        pc0 = (np_lie.quat_to_rotmat(pose[3:]) @ board.T).T + pose[:3]
        pc1 = (np_lie.quat_to_rotmat(rel_gt[3:]) @ pc0.T).T + rel_gt[:3]
        uv0, v0 = pinhole_project(torch.as_tensor(pc0), p0)
        uv1, v1 = pinhole_project(torch.as_tensor(pc1), p1)
        uv0, uv1 = uv0.numpy(), uv1.numpy()
        if not (bool(v0.all()) and bool(v1.all())):
            continue
        if min(uv0.min(), uv1.min()) < 10 or max(uv0[:, 0].max(), uv1[:, 0].max()) > 630 \
                or max(uv0[:, 1].max(), uv1[:, 1].max()) > 470:
            continue
        img0.append(uv0 + rng.normal(0, 0.1, uv0.shape))
        img1.append(uv1 + rng.normal(0, 0.1, uv1.shape))
    rel, rms = calibrate_stereo_extrinsic(
        board, img0, img1, lambda pc: pinhole_project(pc, p0), lambda pc: pinhole_project(pc, p1),
        460.0, (320.0, 240.0), 455.0, (318.0, 242.0), device="cpu")
    assert rms < 0.3
    np.testing.assert_allclose(rel[:3], rel_gt[:3], atol=1e-3)
    assert abs(np.dot(rel[3:], rel_gt[3:])) > 1 - 1e-5


def test_calibration_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_vignette(np.ones((32, 32)))
