"""The plain references on hand cases, and beside the port's plain
versions at small sizes."""
import numpy as np
import pytest
import torch

from d2slam_tpu_torch.depth import quadcam as port_quadcam
from d2slam_tpu_torch.frontend import superpoint as port_sp
from d2slam_tpu_torch.geometry.cameras import KBParams
from d2slam_tpu_torch.ops import stereo_bm
from portbench.reference import compare, depth, superpoint
from portbench.yardstick import geometry
from portbench.yardstick.flight import Circle
from portbench.yardstick.render import Fisheye


def test_block_match_finds_a_known_shift():
    """Right = left shifted by 5 px: the interior reads disparity 5."""
    g = torch.Generator().manual_seed(0)
    left = torch.rand((1, 24, 64), generator=g) * 255
    right = torch.roll(left, -5, dims=-1)
    disp, valid = depth.disparity(left, right, max_disp=16, block=5)
    inner = valid[0, 4:-4, 16:-8]
    assert inner.float().mean() > 0.9
    assert ((disp[0, 4:-4, 16:-8][inner] - 5.0).abs() < 0.5).all()   # sub-pixel step within 0.5


def test_block_match_equals_the_ports_plain_version():
    g = torch.Generator().manual_seed(1)
    a, b = torch.rand((2, 2, 16, 40), generator=g)
    for reverse in (False, True):
        ours = depth.block_match(a, b, 12, 9, reverse)
        port = stereo_bm.bm_plain(a, b, 12, 9, reverse)
        for x, y in zip(ours, port):
            assert torch.equal(x, y)


def test_remap_tables_equal_the_ports():
    fe = Fisheye(38.0, 38.0, 64.0, 48.0, k2=0.005)
    ext = geometry.fisheye_ring_extrinsics(0.3)
    ours = depth.virtual_pairs([fe] * 4, ext, (48, 64), 90.0, "cpu")
    port = port_quadcam.build_virtual_stereo(
        [KBParams.make(*fe)] * 4, ext, port_quadcam.QuadcamConfig(out_hw=(48, 64)), device="cpu")
    for p, q in zip(ours, port):
        assert torch.allclose(p.map_left, q.map_left, atol=1e-4)
        assert torch.allclose(p.map_right, q.map_right, atol=1e-4)
        assert p.baseline == pytest.approx(q.baseline) and p.focal == pytest.approx(q.focal)


def test_superpoint_equals_the_ports_float32_extraction():
    weights = superpoint.load_weights("weights/superpoint_synth.npz", "cpu")
    params = port_sp.load_params("weights/superpoint_synth.npz")
    model = port_sp.SuperPoint(params, port_sp.SuperPointConfig(max_keypoints=50, threshold=1e-4), device="cpu")
    g = torch.Generator().manual_seed(2)
    img = (torch.rand((2, 48, 64), generator=g) * 255).to(torch.uint8)
    ref = superpoint.extract(weights, img, 50, 4, 1e-4)
    out = port_sp.superpoint_extract(model, img.float() / 255.0)
    assert torch.allclose(ref.kpts, out.kpts, atol=1e-4)
    assert torch.equal(ref.valid, out.valid)
    assert torch.allclose(ref.desc, out.desc, atol=1e-5)
    gaps = compare.keypoint_gaps(out.kpts[0].numpy(), out.valid[0].numpy(), out.desc[0].numpy(),
                                 ref.kpts[0], ref.valid[0], ref.desc_map[0])
    assert gaps["kp_miss"] == 0.0 and gaps["desc_gap"] < 1e-5
    low = superpoint.extract(weights, img, 50, 4, 1e-4, precision="fp8")
    assert not torch.allclose(low.desc, ref.desc, atol=1e-3)


def test_ate_is_zero_on_the_flight_itself_and_sees_a_drift():
    fl = Circle(omega=0.35)
    ts = np.arange(0, 5, 0.25)
    # the estimate in another frame: the flight composed with a fixed transform
    T = geometry.pose(geometry.rot_z(0.3), [1.0, -2.0, 0.5])
    poses = np.stack([geometry.pose_compose(T, fl.pose(t)) for t in ts])
    assert compare.ate(ts, poses, fl.pose, ts[0], poses[0]) < 1e-9
    poses[:, 0] += 0.1 * ts
    assert compare.ate(ts, poses, fl.pose, ts[0], poses[0]) > 0.1


def test_rotation_round_trip_on_the_rigs():
    for ext in (geometry.stereo_extrinsics(0.11), geometry.fisheye_ring_extrinsics(0.3)):
        for e in ext:
            R = geometry.quat_to_rotmat(e[3:])
            assert np.allclose(geometry.quat_to_rotmat(geometry.rotmat_to_quat(R)), R)
            assert np.allclose(R @ R.T, np.eye(3)) and np.linalg.det(R) > 0


def test_depth_gaps_hand_case():
    z = torch.ones((1, 2, 2)) * 4.0
    valid = torch.tensor([[[True, True], [False, True]]])
    ref_z = z.clone()
    ref_z[0, 0, 0] = 4.5
    g = compare.depth_gaps(z, valid, ref_z, torch.ones_like(valid))
    assert g["valid_mismatch"] == pytest.approx(0.25)
    assert g["depth_off"] == pytest.approx(1 / 3)
