"""The port's bag toolbox (d2slam_tpu_torch/tools/bag_tools.py) against
the JAX package's: the nine cases of tests/test_bag_tools.py, with the
bags both packages write from the same input compared byte for byte
(split, sync, filter, the inner-stamp shift) and ``bag_info`` equal.
``generate_stereo_bag`` runs the remap through the port's depth modules:
its images are held to the JAX function's within 1 grey level (float32
bilinear sums in another order may round a pixel across a level)."""
import struct

import numpy as np
import pytest

from d2slam_tpu.tools import bag_tools as jbt
from d2slam_tpu_torch.datasets.rosbag import RosbagReader, RosbagWriter
from d2slam_tpu_torch.tools import bag_tools as pbt
from d2slam_tpu_torch.utils import np_lie

# grey levels a virtual-stereo pixel may differ by between the packages
STEREO_GREY_TOL = 1


def _write_quadcam_bag(path, t0=100.0, n_frames=6):
    rng = np.random.RandomState(1)
    composites = []
    with RosbagWriter(str(path)) as w:
        for i in range(n_frames * 5):
            w.write_imu("/imu", t0 + i * 0.01, acc=[0, 0, 9.8], gyr=[0, 0, 0])
        for i in range(n_frames):
            img = rng.randint(0, 256, (20, 4 * 32), np.uint8)
            composites.append(img)
            w.write_image("/arducam/image", t0 + i * 0.05, img)
    return composites


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _images(path, topic):
    return [m["image"] for _, _, m in RosbagReader(str(path)).read_messages([topic])]


def test_split_composite():
    img = np.arange(8 * 16, dtype=np.uint8).reshape(8, 16)
    views = pbt.split_composite(img, 4)
    assert len(views) == 4 and all(v.shape == (8, 4) for v in views)
    np.testing.assert_array_equal(np.concatenate(views, axis=1), img)
    for a, b in zip(views, jbt.split_composite(img, 4)):
        np.testing.assert_array_equal(a, b)


def test_split_quadcam_bag(tmp_path):
    p = tmp_path / "quad.bag"
    composites = _write_quadcam_bag(p)
    out = pbt.split_quadcam_bag(str(p), str(tmp_path / "port.bag"), keep_topics=["/imu"],
                                step=2)
    ref = jbt.split_quadcam_bag(str(p), str(tmp_path / "jax.bag"), keep_topics=["/imu"], step=2)
    assert _bytes(out) == _bytes(ref)
    r = RosbagReader(out)
    assert r.topics["/cam_0/image"] == "sensor_msgs/Image"
    cams = [_images(out, f"/cam_{i}/image") for i in range(4)]
    assert all(len(c) == 3 for c in cams)  # step=2 over 6 frames
    for i in range(4):
        np.testing.assert_array_equal(cams[i][0], composites[0][:, i * 32:(i + 1) * 32])
    assert len(list(r.read_messages(["/imu"]))) == 30
    # the default output name, as the JAX package's
    assert pbt.split_quadcam_bag(str(p)) == str(tmp_path / "quad-split.bag")


def test_sync_bags(tmp_path):
    pa, pb = tmp_path / "droneA.bag", tmp_path / "droneB.bag"
    _write_quadcam_bag(pa, t0=100.0)
    _write_quadcam_bag(pb, t0=250.5)
    assert abs(pbt.find_time0(str(pa)) - 100.0) < 1e-6
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    outs = pbt.sync_bags([str(pa), str(pb)], out_dir=str(tmp_path / "port"), t_start=1.0)
    refs = jbt.sync_bags([str(pa), str(pb)], out_dir=str(tmp_path / "jax"), t_start=1.0)
    for (o, dt), (r, dt_ref) in zip(outs, refs):
        assert dt == dt_ref and _bytes(o) == _bytes(r)
    assert all(abs(pbt.find_time0(out) - 1.0) < 1e-6 for out, _ in outs)
    # embedded header stamps were shifted along with record times
    for _, t, m in RosbagReader(outs[0][0]).read_messages(["/imu"]):
        assert abs(m["stamp"] - t) < 1e-6
        break


def test_filter_and_info(tmp_path):
    p = tmp_path / "quad.bag"
    _write_quadcam_bag(p, t0=10.0)
    out, ref = tmp_path / "cut.bag", tmp_path / "cut_jax.bag"
    n = pbt.filter_bag(str(p), str(out), topics=["/imu"], t_start=10.05, t_end=10.15, step=1)
    assert n == jbt.filter_bag(str(p), str(ref), topics=["/imu"], t_start=10.05, t_end=10.15)
    assert n == 11  # 0.05..0.15 inclusive at 100 Hz
    assert _bytes(out) == _bytes(ref)
    info = pbt.bag_info(str(out))
    assert set(info) == {"/imu"} and info["/imu"]["count"] == 11
    assert abs(info["/imu"]["t1"] - info["/imu"]["t0"] - 0.1) < 1e-6
    assert pbt.bag_info(str(p)) == jbt.bag_info(str(p))
    # every third message per topic
    assert pbt.filter_bag(str(p), str(tmp_path / "s.bag"), step=3) == jbt.filter_bag(
        str(p), str(tmp_path / "s_jax.bag"), step=3)
    assert _bytes(tmp_path / "s.bag") == _bytes(tmp_path / "s_jax.bag")


def _stereo_both(tmp_path, src, calib):
    """(port pairs, JAX pairs, port bag, JAX bag) of one input."""
    out, ref = tmp_path / "stereo.bag", tmp_path / "stereo_jax.bag"
    n = pbt.generate_stereo_bag(str(src), str(out), calib, device="cpu")
    n_ref = jbt.generate_stereo_bag(str(src), str(ref), calib)
    return n, n_ref, out, ref


def _assert_stereo_close(out, ref):
    topics = RosbagReader(str(ref)).topics
    assert RosbagReader(str(out)).topics == topics
    for topic in topics:
        got, want = _images(out, topic), _images(ref, topic)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g.astype(int) - w.astype(int)).max() <= STEREO_GREY_TOL


def test_generate_stereo_bag(tmp_path):
    p = tmp_path / "quad.bag"
    rng = np.random.RandomState(2)
    with RosbagWriter(str(p)) as w:
        for i in range(3):
            # 4 fisheye views of 64x80 assembled horizontally
            w.write_image("/oak_ffc_4p/assemble_image", 1.0 + i * 0.1,
                          rng.randint(0, 256, (64, 4 * 80), np.uint8))
    calib = {"cams": [dict(fx=40.0, fy=40.0, cx=40.0, cy=32.0, k2=0.01)] * 4,
             "baseline": 0.3, "out_hw": [48, 64]}
    n, n_ref, out, ref = _stereo_both(tmp_path, p, calib)
    assert n == n_ref == 3 * 4  # 4 virtual pairs per frame
    _assert_stereo_close(out, ref)
    r = RosbagReader(str(out))
    for k in range(4):
        assert r.topics[f"/virtual_stereo_{k}/left"] == "sensor_msgs/Image"
        assert r.topics[f"/virtual_stereo_{k}/right"] == "sensor_msgs/Image"
    msgs = _images(out, "/virtual_stereo_0/left")
    assert len(msgs) == 3 and msgs[0].shape == (48, 64)
    # photometric alignment: left/right means match closely
    ml = _images(out, "/virtual_stereo_1/left")[0].mean()
    mr = _images(out, "/virtual_stereo_1/right")[0].mean()
    assert abs(ml - mr) < 0.05 * ml


def test_sync_drops_pre_anchor_messages(tmp_path):
    p = tmp_path / "warmup.bag"
    with RosbagWriter(str(p)) as w:
        # IMU starts 3 s before the first camera frame
        for i in range(400):
            w.write_imu("/imu", 100.0 + i * 0.01, [0, 0, 9.8], [0, 0, 0])
        w.write_image("/cam/image", 103.0, np.zeros((8, 8), np.uint8))
    outs = pbt.sync_bags([str(p)], out_dir=str(tmp_path), t_start=1.0)
    ts = [t for _, t, _ in RosbagReader(outs[0][0]).read_messages(["/imu"], raw=True)]
    # pre-anchor prefix dropped, not collapsed onto t=0
    assert min(ts) >= 0.0
    assert np.diff(sorted(ts)).min() > 0.005  # no zero-dt IMU intervals
    _, dropped = pbt.shift_bag(str(p), str(tmp_path / "x.bag"), -102.0)
    assert dropped == 200  # exactly the first 2 s of IMU


def test_split_passthrough_is_lossless(tmp_path):
    p = tmp_path / "quad.bag"
    rng = np.random.RandomState(3)
    with RosbagWriter(str(p)) as w:
        for i in range(4):
            w.write_raw("/gt", "geometry_msgs/PoseStamped", 5.0 + i,
                        b"\x00" * 12 + b"\x00\x00\x00\x00" + b"\x01" * 56)
        w.write_image("/arducam/image", 5.0, rng.randint(0, 256, (8, 4 * 8), np.uint8))
    out = pbt.split_quadcam_bag(str(p), composite_topic="/arducam/image", keep_topics=["/gt"])
    msgs = [(t, d) for _, t, d in RosbagReader(out).read_messages(["/gt"], raw=True)]
    assert len(msgs) == 4  # PoseStamped kept
    assert msgs[0][1].endswith(b"\x01" * 56)  # byte-for-byte copy


def test_shift_path_inner_stamps(tmp_path):
    def header(t, fid=b""):
        secs, nsecs = int(t), int((t - int(t)) * 1e9)
        return struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", len(fid)) + fid

    pose = b"\x00" * 56
    path_msg = (header(100.0, b"map") + struct.pack("<I", 2) + header(100.5) + pose
                + header(101.0) + pose)
    out = pbt._shift_stamp("nav_msgs/Path", path_msg, -99.0)
    assert out == jbt._shift_stamp("nav_msgs/Path", path_msg, -99.0)
    s, ns = struct.unpack_from("<II", out, 4)
    assert s + ns * 1e-9 == 1.0
    # first inner PoseStamped: after the outer header (16 + 3) + count (4)
    pos = 16 + 3 + 4
    s, ns = struct.unpack_from("<II", out, pos + 4)
    assert abs(s + ns * 1e-9 - 1.5) < 1e-6
    s, ns = struct.unpack_from("<II", out, pos + 16 + 56 + 4)
    assert abs(s + ns * 1e-9 - 2.0) < 1e-6
    # a whole bag of Path messages through shift_bag: the same bytes
    src = tmp_path / "path.bag"
    with RosbagWriter(str(src)) as w:
        w.write_raw("/path", "nav_msgs/Path", 100.0, path_msg)
        w.write_raw("/other", "std_msgs/String", 100.2, b"\x03\x00\x00\x00abc")
    assert pbt.shift_bag(str(src), str(tmp_path / "a.bag"), -99.0) == jbt.shift_bag(
        str(src), str(tmp_path / "b.bag"), -99.0)
    assert _bytes(tmp_path / "a.bag") == _bytes(tmp_path / "b.bag")


def test_generate_stereo_with_extrinsics(tmp_path):
    p = tmp_path / "quad.bag"
    rng = np.random.RandomState(4)
    with RosbagWriter(str(p)) as w:
        w.write_image("/cam/image", 1.0, rng.randint(0, 256, (64, 4 * 80), np.uint8))
    # a calibrated rig: slight deviations from the ideal square
    ext = []
    for i in range(4):
        yaw = np.deg2rad(90.0 * i + 1.5)
        q = np_lie.quat_exp(np.array([0.0, yaw, 0.01]))
        R = np_lie.quat_to_rotmat(q)
        ext.append(np.concatenate([R @ [0.151, 0.002, 0.149], q]).tolist())
    calib = {"cams": [dict(fx=40.0, fy=40.0, cx=40.0, cy=32.0)] * 4, "extrinsics": ext,
             "out_hw": [32, 48]}
    n, n_ref, out, ref = _stereo_both(tmp_path, p, calib)
    assert n == n_ref == 4
    _assert_stereo_close(out, ref)
    assert _images(out, "/virtual_stereo_2/right")[0].shape == (32, 48)
    with pytest.raises(ValueError, match="extrinsics"):
        pbt.generate_stereo_bag(str(p), str(tmp_path / "bad.bag"),
                                dict(calib, extrinsics=ext[:3]), device="cpu")
