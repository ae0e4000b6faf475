"""The port's dataset readers, writers, config loader and trajectory
evaluation against the JAX package's, on the CPU.

- EuRoC: a scene written by each package's writer (the port's PNGs from
  its own encoder, the JAX package's through Pillow) is read by both
  readers: the event streams are identical (IMU rows, images and ground
  truth exact), with and without the native prefetcher.
- ROS1 bags: written by either package and read by the other, plain and
  with the messages in one bz2 chunk; PNG CompressedImage messages.
- ``D2Config.from_yaml`` over every file in ``config/`` gives the JAX
  package's fields.
- ``utils/evaluation``: equal to the JAX package's functions to 1e-12 on
  random trajectories; each package reads the other's CSV.
"""
import bz2
import dataclasses
import glob
import os
import struct

import numpy as np
import pytest

from d2slam_tpu.config import D2Config as JConfig
from d2slam_tpu.datasets.euroc import EuRoCDataset as JEuRoC
from d2slam_tpu.datasets import rosbag as jbag
from d2slam_tpu.utils import evaluation as jev
from d2slam_tpu.utils.euroc_writer import write_euroc_dataset as jwrite
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.datasets import rosbag as tbag
from d2slam_tpu_torch.datasets.euroc import EuRoCDataset
from d2slam_tpu_torch.utils import evaluation as tev
from d2slam_tpu_torch.utils.euroc_writer import write_euroc_dataset
from d2slam_tpu_torch.utils.pngio import png_encode_gray
from d2slam_tpu_torch.utils.render import render_blobs
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.sim import CircleSim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FX = 48, 64, 44.0


def _scene(n_frames=5):
    """IMU, float frames in [0, 1] and ground truth of a small stereo scene."""
    sim = CircleSim(seed=3, baseline=0.2, n_landmarks=80, frame_hz=4.0, imu_hz=100)
    imu = sim.imu_samples(-0.2, (n_frames - 1) / sim.frame_hz + 1e-6)
    frames, gts = [], []
    for k in range(n_frames):
        t = k / sim.frame_hz
        pose, _ = sim.gt_pose(t)
        imgs = [render_blobs(sim.lms, np_lie.pose_compose(pose, sim.ext[c]), FX, FX, W / 2, H / 2,
                             H, W) for c in range(2)]
        frames.append((t, imgs))
        gts.append((t, pose))
    return imu, frames, gts


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    imu, frames, gts = _scene()
    root = tmp_path_factory.mktemp("euroc")
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    write_euroc_dataset(port_dir, imu, frames, gts)
    jwrite(jax_dir, imu, frames, gts)
    return port_dir, jax_dir


def _events(ds, **kw):
    out = []
    for ev in ds.play(**kw):
        if ev[0] == "imu":
            out.append(("imu", ev[1], *np.concatenate([ev[2], ev[3]])))
        else:
            out.append(("frame", ev[1], np.stack(ev[2])))
    return out


def _assert_same_events(a, b):
    assert len(a) == len(b)
    assert [e[0] for e in a] == [e[0] for e in b]
    for x, y in zip(a, b):
        assert x[1] == y[1]
        if x[0] == "imu":
            assert x[2:] == y[2:]
        else:
            assert x[2].dtype == y[2].dtype
            np.testing.assert_array_equal(x[2], y[2])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_euroc_written_by_either_reads_the_same_in_both(written, writer):
    root = written[0] if writer == "port" else written[1]
    tds, jds = EuRoCDataset(root), JEuRoC(root)
    assert tds.cams == jds.cams == ["cam0", "cam1"]
    np.testing.assert_array_equal(tds.imu, jds.imu)
    np.testing.assert_array_equal(tds.ground_truth, jds.ground_truth)
    assert tds.frames == jds.frames
    ref = _events(jds)
    _assert_same_events(_events(tds), ref)
    _assert_same_events(_events(tds, prefetch=True), ref)
    _assert_same_events(_events(tds, prefetch=True, frame_stride=2), _events(jds, frame_stride=2))
    for t in (0.1, 0.6, 5.0):
        np.testing.assert_array_equal(tds.gt_pose_at(t), jds.gt_pose_at(t))


def test_euroc_writers_give_the_same_pixels(written):
    a, b = (EuRoCDataset(r) for r in written)
    for (_, pa), (_, pb) in zip(a.frames, b.frames):
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(a.load_image_u8(x), b.load_image_u8(y))
    u8 = [ev[2] for ev in a.play(as_uint8=True, prefetch=True) if ev[0] == "frame"]
    fl = [ev[2] for ev in a.play() if ev[0] == "frame"]
    for x, y in zip(u8, fl):
        assert x[0].dtype == np.uint8
        np.testing.assert_array_equal(x[0].astype(np.float32) / 255.0, y[0])


def test_euroc_rgb_image_converts_as_pillow(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(1).integers(0, 256, (20, 30, 3)).astype(np.uint8)
    p = str(tmp_path / "rgb.png")
    Image.fromarray(rgb, "RGB").save(p)
    want = np.asarray(Image.open(p).convert("L"))
    ds = EuRoCDataset(str(tmp_path))
    np.testing.assert_array_equal(ds.load_image_u8(p), want)


def _write_bag(mod, path, imu, frames, compressed=False):
    with mod.RosbagWriter(str(path)) as w:
        for (t, acc, gyr) in imu:
            w.write_imu("/imu0", t + 1.0, acc, gyr)
        for (t, imgs) in frames:
            for c, im in enumerate(imgs):
                u8 = np.clip(im * 255.0, 0, 255).astype(np.uint8)
                if compressed:
                    hdr = mod.RosbagWriter._ser_header(t + 1.0)
                    fmt, data = b"png", png_encode_gray(u8)
                    payload = (hdr + struct.pack("<I", len(fmt)) + fmt
                               + struct.pack("<I", len(data)) + data)
                    w.write_raw(f"/cam{c}/image_raw", "sensor_msgs/CompressedImage",
                                t + 1.0, payload)
                else:
                    w.write_image(f"/cam{c}/image_raw", t + 1.0, u8)


def _bz2_repack(src, dst, mod):
    """The bag's message records moved into one bz2 chunk."""
    raw = open(src, "rb").read()
    magic = b"#ROSBAG V2.0\n"
    keep, msgs = b"", b""
    for header, data in mod._iter_records(raw[len(magic):]):
        enc = mod._encode_header(header)
        rec = struct.pack("<I", len(enc)) + enc + struct.pack("<I", len(data)) + data
        if header[b"op"][0] == mod.OP_MSG:
            msgs += rec
        else:
            keep += rec
    comp = bz2.compress(msgs)
    chdr = mod._encode_header({b"op": bytes([mod.OP_CHUNK]), b"compression": b"bz2",
                               b"size": struct.pack("<I", len(msgs))})
    with open(dst, "wb") as f:
        f.write(magic + keep + struct.pack("<I", len(chdr)) + chdr
                + struct.pack("<I", len(comp)) + comp)


def _bag_events(reader):
    out = []
    for ev in reader.play_vio("/imu0", ["/cam0/image_raw", "/cam1/image_raw"]):
        if ev[0] == "imu":
            out.append(("imu", ev[1], *np.concatenate([ev[2], ev[3]])))
        else:
            out.append(("frame", ev[1], np.stack(ev[2])))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("layout", ["plain", "bz2", "compressed_png"])
def test_bags_cross_both_ways(tmp_path, writer, layout):
    imu, frames, _ = _scene(n_frames=3)
    wmod = tbag if writer == "port" else jbag
    path = tmp_path / "a.bag"
    _write_bag(wmod, path, imu, frames, compressed=layout == "compressed_png")
    if layout == "bz2":
        _bz2_repack(path, tmp_path / "b.bag", wmod)
        path = tmp_path / "b.bag"
    tr, jr = tbag.RosbagReader(str(path)), jbag.RosbagReader(str(path))
    assert tr.topics == jr.topics
    ref = _bag_events(jr)
    assert [e[0] for e in ref].count("frame") == 3
    _assert_same_events(_bag_events(tr), ref)
    for (a, b) in zip(tr.read_messages(["/imu0"]), jr.read_messages(["/imu0"])):
        assert a[:2] == b[:2]
        for k in ("acc", "gyr", "orientation"):
            np.testing.assert_array_equal(a[2][k], b[2][k])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "config", "*.yaml"))),
                         ids=os.path.basename)
def test_config_from_yaml_matches_jax(path):
    port, ref = D2Config.from_yaml(path), JConfig.from_yaml(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_config_load_cameras(tmp_path):
    chain = tmp_path / "chain.yaml"
    chain.write_text(
        "cam0:\n  camera_model: pinhole\n  intrinsics: [400.0, 401.0, 320.0, 240.0]\n"
        "  distortion_model: radtan\n  distortion_coeffs: [0.0, 0.0, 0.0, 0.0]\n"
        "  resolution: [640, 480]\n"
        "  T_cam_imu:\n  - [0.0, -1.0, 0.0, 0.05]\n  - [0.0, 0.0, -1.0, 0.0]\n"
        "  - [1.0, 0.0, 0.0, 0.0]\n  - [0.0, 0.0, 0.0, 1.0]\n")
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text("num_cams: 1\ncalib_file: chain.yaml\nextrinsic_parameter_type: 0\n")
    port, ref = D2Config.from_yaml(str(cfg_file)), JConfig.from_yaml(str(cfg_file))
    assert port.calib_file == ref.calib_file == str(chain)
    (tc,), (jc,) = port.load_cameras(), ref.load_cameras()
    np.testing.assert_allclose(tc.extrinsic, np.asarray(jc.extrinsic), atol=1e-12)
    assert float(tc.params.fx) == float(jc.params.fx) == 400.0
    with pytest.raises(ValueError):
        D2Config().load_cameras()


def _random_trajectory(rng, n):
    t = np.sort(rng.uniform(0, 10, n))
    p = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    q = rng.normal(0, 1, (n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return t, np.concatenate([p, q], axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluation_matches_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    t_gt, gt = _random_trajectory(rng, 80)
    pick = np.sort(rng.choice(80, 50, replace=False))
    t_est = t_gt[pick] + rng.uniform(-0.03, 0.03, 50)   # some beyond the 0.02 s gate
    est = gt[pick] + np.concatenate([rng.normal(0, 0.05, (50, 3)), np.zeros((50, 4))], axis=1)
    for a, b in zip(tev.associate(t_est, t_gt), jev.associate(t_est, t_gt)):
        np.testing.assert_array_equal(a, b)
    ok = tev.associate(t_est, t_gt)[1]
    Rt, tt = tev.align_umeyama_4dof(est[ok, :3], gt[pick][ok, :3], est[ok, 3:], gt[pick][ok, 3:])
    Rj, tj = jev.align_umeyama_4dof(est[ok, :3], gt[pick][ok, :3], est[ok, 3:], gt[pick][ok, 3:])
    np.testing.assert_allclose(Rt, Rj, atol=1e-12)
    np.testing.assert_allclose(tt, tj, atol=1e-12)
    for align in (True, False):
        (rt, et), (rj, ej) = (f.ate_rmse(t_est, est, t_gt, gt, align_4dof=align)
                              for f in (tev, jev))
        assert abs(rt - rj) <= 1e-12
        np.testing.assert_allclose(et, ej, atol=1e-12)
    assert abs(tev.rpe_rmse(t_est, est, t_gt, gt, delta=5)
               - jev.rpe_rmse(t_est, est, t_gt, gt, delta=5)) <= 1e-12
    pt, pj = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    tev.write_trajectory_csv(pt, t_est, est)
    jev.write_trajectory_csv(pj, t_est, est)
    assert open(pt).read() == open(pj).read()
    for path in (pt, pj):
        for a, b in zip(tev.read_trajectory_csv(path), jev.read_trajectory_csv(path)):
            np.testing.assert_array_equal(a, b)
