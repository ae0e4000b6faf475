"""The port's comm package against the JAX package's, on the CPU.

* Wire bytes: for the same keyframe packet, loop edge, image attachment
  and consensus pose message, the port encodes the JAX package's bytes
  exactly, and each package decodes the other's.
* The mirrors of tests/test_comm.py (codec round trip and compression,
  garbage rejected, the native UDP multicast round trip through the
  port's own library, built under ``d2slam_tpu_torch/_build/`` only;
  skipped where the host routes no multicast, as the JAX test),
  tests/test_loopnet.py's host cases (greedy and lazy broadcast, the
  pull request, the nearby override, image attachments) and
  tests/test_consensus_transport.py's host cases, with a two-endpoint
  ``TransportConsensus`` over a ``LocalBus`` on numpy poses.
"""
import os

import numpy as np
import pytest

from d2slam_tpu.comm import codec as jc
from d2slam_tpu.comm import consensus_transport as jct
from d2slam_tpu_torch.comm import codec as pc
from d2slam_tpu_torch.comm import consensus_transport as pct
from d2slam_tpu_torch.comm import transport as pt
from d2slam_tpu_torch.comm.loopnet import (
    CH_KF_REQUEST,
    LoopNet,
    header_only,
    nearby_drones_from_pgo,
)
from tests.test_comm import make_packet
from tests.test_loopnet import Hub, make_pkt

PACKAGES = {"jax": (jc, jct), "port": (pc, pct)}


def full_packet(seed=0):
    """tests/test_comm.py's packet with the v2-v4 blocks filled in."""
    rng = np.random.default_rng(seed)
    p = make_packet(seed=seed)
    n = len(p.lm_ids)
    return p._replace(
        lm_vels=rng.normal(size=(n, 3)).astype(np.float32),
        ba=rng.normal(size=3).astype(np.float32), bg=rng.normal(size=3).astype(np.float32),
        vel=rng.normal(size=3).astype(np.float32),
        imu_t=np.linspace(17.0, 17.25, 5), imu_acc=rng.normal(size=(5, 3)).astype(np.float32),
        imu_gyr=rng.normal(size=(5, 3)).astype(np.float32),
        sld_win=np.arange(100, 108, dtype=np.int64), ref_frame_id=1,
        lm_pos3d=np.where(rng.uniform(size=(n, 1)) < 0.3, np.nan,
                          rng.normal(size=(n, 3))).astype(np.float32))


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_keyframe_bytes_equal_and_cross_decode(src, dst):
    enc, dec = PACKAGES[src][0], PACKAGES[dst][0]
    pkt = full_packet()
    buf = enc.encode_keyframe(enc.RemoteKeyframePacket(**pkt._asdict()))
    assert buf == dec.encode_keyframe(dec.RemoteKeyframePacket(**pkt._asdict()))
    out = dec.decode_keyframe(buf)
    ref = enc.decode_keyframe(buf)
    for f in pkt._fields:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
    assert dec.encode_keyframe(out) == enc.encode_keyframe(ref)
    # header-only packets (lazy broadcast) too
    hdr = header_only(pc.RemoteKeyframePacket(**pkt._asdict()))
    assert enc.encode_keyframe(hdr) == dec.encode_keyframe(hdr)


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_loop_edge_image_and_pose_msg_bytes(src, dst):
    (enc, enc_c), (dec, dec_c) = PACKAGES[src], PACKAGES[dst]
    rel = np.array([0.5, -1, 2, 0, 0, 0.6, 0.8])
    buf = enc.encode_loop_edge(11, 42, 0, 1, rel, 0.1, 0.05, 37)
    assert buf == dec.encode_loop_edge(11, 42, 0, 1, rel, 0.1, 0.05, 37)
    fa, fb, da, db, r, pcov, ycov, inl = dec.decode_loop_edge(buf)
    assert (fa, fb, da, db, inl) == (11, 42, 0, 1, 37)
    np.testing.assert_allclose(r, rel, atol=1e-7)
    img = np.random.default_rng(5).integers(0, 256, (24, 32), dtype=np.uint8)
    buf = enc.encode_image_packet(2, 9, 1, img, n_views=2)
    assert buf == dec.encode_image_packet(2, 9, 1, img, n_views=2)
    did, fid, view, nv, out = dec.decode_image_packet(buf)
    assert (did, fid, view, nv) == (2, 9, 1, 2) and np.array_equal(out, img)
    keys = np.array([7, (3 << 40) + 9], np.int64)
    poses = np.random.default_rng(1).normal(size=(2, 7)).astype(np.float32)
    buf = enc_c.encode_pose_msg(4, 17, keys, poses, np.array([0], np.int32), poses[:1], 2)
    assert buf == dec_c.encode_pose_msg(4, 17, keys, poses, np.array([0], np.int32), poses[:1], 2)
    rid, tok, k2, p2, c2, cp2, ref = dec_c.decode_pose_msg(buf)
    assert (rid, tok, ref) == (4, 17, 2)
    np.testing.assert_array_equal(k2, keys)
    np.testing.assert_array_equal(p2, poses)


def test_codec_roundtrip_and_garbage():
    """tests/test_comm.py::test_codec_roundtrip and ::test_codec_rejects_garbage."""
    pkt = pc.RemoteKeyframePacket(**make_packet()._asdict())
    buf = pc.encode_keyframe(pkt)
    out = pc.decode_keyframe(buf)
    assert out.drone_id == 3 and out.frame_id == 12345678901
    assert out.stamp == 17.25 and out.is_keyframe
    np.testing.assert_array_equal(out.lm_ids, pkt.lm_ids)
    np.testing.assert_array_equal(out.lm_cam, pkt.lm_cam)
    assert float(out.gdesc @ pkt.gdesc) > 0.99
    assert np.sum(out.lm_desc * pkt.lm_desc, axis=1).min() > 0.99
    n = len(pkt.lm_ids)
    assert len(buf) - 12 * n < 0.35 * 4 * (len(pkt.gdesc) + pkt.lm_desc.size + pkt.lm_rays.size)
    assert pc.decode_keyframe(b"") is None
    assert pc.decode_keyframe(b"\x00" * 64) is None
    assert pc.decode_keyframe(buf[:-4]) is None          # truncated v4 block


def test_channel_ids_equal_the_jax_package():
    import d2slam_tpu.comm.loopnet as jl
    import d2slam_tpu.comm.transport as jt

    names = [k for k in dir(jt) if k.startswith("CH_")]
    assert len(names) == 8
    assert {k: getattr(pt, k) for k in names} == {k: getattr(jt, k) for k in names}
    assert CH_KF_REQUEST == jl.CH_KF_REQUEST


def test_udp_library_builds_under_build_dir_only():
    from d2slam_tpu_torch.utils.native import BUILD_DIR

    path = pt._load_lib()._name
    assert os.path.dirname(path) == BUILD_DIR
    assert os.path.basename(path).startswith("libudp_transport-")
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(pt.SOURCE)))


def test_udp_transport_roundtrip():
    """tests/test_comm.py::test_udp_transport_roundtrip through the port's
    library; a JAX-package packet crosses it."""
    try:
        a = pt.UDPMulticastTransport(self_id=1, port=17671)
        b = pt.UDPMulticastTransport(self_id=2, port=17671)
    except OSError:
        pytest.skip("multicast unavailable on this host")
    try:
        payload = jc.encode_keyframe(make_packet(n=50, D=64))
        a.send(pt.CH_VIOKF_HEADER, payload)
        got = b.recv(timeout_ms=2000)
        if got is None:
            pytest.skip("multicast loopback not routed on this host")
        ch, sender, data = got
        assert ch == pt.CH_VIOKF_HEADER and sender == 1 and data == payload
        a.send(pt.CH_VIOKF_HEADER, payload)
        assert a.recv(timeout_ms=300) is None             # self-messages suppressed
        while b.recv(timeout_ms=200) is not None:
            pass
        big = pc.encode_keyframe(pc.RemoteKeyframePacket(
            **make_packet(n=800, D=256, G=4096, seed=1)._asdict()))
        assert len(big) > 200000                           # many datagrams
        a.send(pt.CH_VIOKF_HEADER, big)
        got = b.recv(timeout_ms=3000)
        assert got is not None and got[2] == big
    finally:
        a.close()
        b.close()


def test_router_buffered_and_lossy_bus():
    """ChannelRouter hands each route its channels and keeps the others
    for their owners; BufferedTransport drains a transport on its thread;
    a lossy LocalBus drops deliveries from its seeded generator."""
    bus = pt.LocalBus()
    a, b = bus.endpoint(0), bus.endpoint(1)
    router = pt.ChannelRouter(b)
    kf, loops = router.route({pt.CH_VIOKF_LANDMARKS}), router.route({pt.CH_SWARM_LOOP})
    for ch, d in ((pt.CH_SWARM_LOOP, b"L"), (pt.CH_PGO_DATA, b"x"), (pt.CH_VIOKF_LANDMARKS, b"K")):
        a.send(ch, d)
    assert kf.recv() == (pt.CH_VIOKF_LANDMARKS, 0, b"K")
    assert loops.recv() == (pt.CH_SWARM_LOOP, 0, b"L")
    assert kf.recv() is None and loops.recv() is None
    c = bus.endpoint(2)
    buffered = pt.BufferedTransport(c, poll_ms=5)
    a.send(pt.CH_SYNC_SIGNAL, b"s")
    assert buffered.recv(timeout_ms=2000) == (pt.CH_SYNC_SIGNAL, 0, b"s")
    buffered.close()
    assert not buffered._thread.is_alive()

    def delivered(seed):
        lossy = pt.LocalBus(drop_prob=0.5, seed=seed)
        src, dst = lossy.endpoint(0), lossy.endpoint(1)
        for k in range(200):
            src.send(1, bytes([k % 256]))
        return [m[2] for m in iter(dst.recv, None)]

    got = delivered(3)
    assert 60 < len(got) < 140 and got == delivered(3) and got != delivered(4)


def test_loopnet_greedy_lazy_pull_and_nearby():
    """tests/test_loopnet.py's broadcast cases on the port's LoopNet."""
    pkt = pc.RemoteKeyframePacket(**make_pkt()._asdict())
    # greedy: the full frame
    hub = Hub()
    a, b = LoopNet(hub.endpoint(1), 1), LoopNet(hub.endpoint(2), 2)
    got = []
    b.on_keyframe = got.append
    a.broadcast_keyframe(pkt)
    b.poll(now=0.0)
    assert len(got) == 1 and len(got[0].lm_ids) == 20
    # lazy: header -> request (one while outstanding) -> full frame
    hub = Hub()
    a, b = LoopNet(hub.endpoint(1), 1, lazy=True), LoopNet(hub.endpoint(2), 2, lazy=True)
    got = []
    b.on_keyframe = got.append
    b.want_full = lambda hdr: True
    a.broadcast_keyframe(pkt)
    b.poll(now=0.0)
    assert not got
    b.request_frame(1, 7, now=0.1)
    assert sum(1 for (ch, _, _) in list(a.transport.q) if ch == CH_KF_REQUEST) == 1
    a.poll(now=0.0)
    b.poll(now=0.1)
    assert len(got) == 1 and len(got[0].lm_ids) == 20
    # lazy with the gate off: the header passes through
    hub = Hub()
    a, b = LoopNet(hub.endpoint(1), 1, lazy=True), LoopNet(hub.endpoint(2), 2, lazy=True)
    got = []
    b.on_keyframe = got.append
    b.want_full = lambda hdr: False
    a.broadcast_keyframe(pkt)
    b.poll(now=0.0)
    assert len(got) == 1 and len(got[0].lm_ids) == 0
    # lazy with a nearby drone: the full frame
    hub = Hub()
    a, b = LoopNet(hub.endpoint(1), 1, lazy=True), LoopNet(hub.endpoint(2), 2, lazy=True)
    got = []
    b.on_keyframe = got.append
    a.broadcast_keyframe(pkt, nearby_drones={2})
    b.poll(now=0.0)
    assert len(got) == 1 and len(got[0].lm_ids) == 20
    near = nearby_drones_from_pgo(
        np.zeros(3), {2: (np.array([1.0, 0, 0]), 9.0), 3: (np.array([50.0, 0, 0]), 9.0),
                      4: (np.array([1.0, 1, 0]), 0.0)}, now=10.0, distance=5.0, max_age=5.0)
    assert near == {2}
    h = header_only(pkt)
    assert len(h.lm_ids) == 0 and len(h.imu_t) == 0 and h.gdesc.shape == (64,)


def test_loopnet_images_and_loop_edges():
    """send_img attachments (tests/test_loopnet.py::test_send_img_*) and the
    SWARM_LOOP channel, received by a JAX-package LoopNet."""
    from d2slam_tpu.comm.loopnet import LoopNet as JaxLoopNet

    hub = Hub()
    a = LoopNet(hub.endpoint(1), 1, lazy=False, send_img=True)
    b = JaxLoopNet(hub.endpoint(2), 2, lazy=False)
    imgs, kfs, loops = [], [], []
    b.on_image, b.on_keyframe, b.on_loop_edge = imgs.append, kfs.append, loops.append
    rng = np.random.default_rng(4)
    views = [rng.integers(0, 256, (24, 32), dtype=np.uint8) for _ in range(2)]
    a.broadcast_keyframe(pc.RemoteKeyframePacket(**make_pkt(frame_id=9)._asdict()), images=views)
    a.broadcast_loop_edge(3, 9, 1, 2, np.eye(1, 7, 6)[0], 0.1, 0.1, 30)
    b.poll(now=0.0)
    assert len(kfs) == 1 and len(imgs) == 2 and len(loops) == 1
    for v, (did, fid, view, n_views, im) in enumerate(imgs):
        assert (did, fid, n_views, view) == (1, 9, 2, v) and np.array_equal(im, views[v])
    assert loops[0][:4] == (3, 9, 1, 2) and loops[0][-1] == 30
    hub = Hub()
    a, b = LoopNet(hub.endpoint(1), 1), LoopNet(hub.endpoint(2), 2)
    got = []
    b.on_image = got.append
    a.broadcast_keyframe(pc.RemoteKeyframePacket(**make_pkt()._asdict()),
                         images=[np.zeros((8, 8), np.uint8)])
    b.poll(now=0.0)
    assert got == []


def test_keyed_average_and_dual_update_match_jax():
    """tests/test_consensus_transport.py::test_keyed_average_divergent_windows
    on the port, and both packages' average and dual step on random poses."""
    ident = np.array([0, 0, 0, 0, 0, 0, 1.0])
    shifted = np.array([1, 0, 0, 0, 0, 0, 1.0])
    keys = np.array([10, 11, 12], np.int64)
    peer = (np.array([13, 11, 12], np.int64),
            np.stack([ident + [9, 0, 0, 0, 0, 0, 0], shifted, ident]))
    gp, counts = pct.average_keyed_poses(keys, np.tile(ident, (3, 1)), {2: peer})
    np.testing.assert_array_equal(counts, [1, 2, 2])
    np.testing.assert_allclose(gp[0], ident)
    np.testing.assert_allclose(gp[1, 0], 0.5)
    np.testing.assert_allclose(gp[2], ident, atol=1e-12)

    rng = np.random.default_rng(2)

    def poses(n):
        q = rng.normal(size=(n, 4))
        return np.concatenate([rng.normal(size=(n, 3)), q / np.linalg.norm(q, axis=1,
                                                                            keepdims=True)], 1)

    mine = poses(6)
    peers = {1: (np.arange(3, 9, dtype=np.int64), poses(6)), 2: (np.arange(0, 6, 2), poses(3))}
    keys = np.arange(6, dtype=np.int64)
    gj, cj = jct.average_keyed_poses(keys, mine, peers)
    gp, cp = pct.average_keyed_poses(keys, mine, peers)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_allclose(gp, gj, atol=1e-12)
    for i in range(6):
        np.testing.assert_allclose(pct.dual_update_np(mine[i], gp[i], np.zeros(6), 1.5),
                                   jct.dual_update_np(mine[i], gj[i], np.zeros(6), 1.5),
                                   atol=1e-12)


def test_transport_consensus_two_endpoints_on_a_local_bus():
    """Two robots with diverged estimates of six shared frames run
    consensus steps over a ``LocalBus`` (the ADMM exchange of
    tests/test_consensus_transport.py::test_transport_consensus_two_robots
    with the local solve replaced by a relaxation toward the average):
    each step hears the peer, the duals are keyed by frame, a frame only
    one robot holds keeps a zero step, and the two agree in the end."""
    bus = pt.LocalBus()
    rng = np.random.default_rng(4)
    gt = np.tile(np.eye(1, 7, 6)[0], (6, 1))
    gt[:, 0] = np.arange(6.0)
    keys = np.arange(100, 106, dtype=np.int64)
    robots = []
    for rid in (1, 2):
        p = gt.copy()
        p[:, :3] += rng.normal(0, 0.05, (6, 3))
        robots.append(dict(tc=pct.TransportConsensus(bus.endpoint(rid), rid), poses=p,
                           keys=keys.copy(), tilde={}))
    robots[1]["keys"][-1] = 999            # a frame robot 2 alone estimates
    d0 = np.abs(robots[0]["poses"][:5, :3] - robots[1]["poses"][:5, :3]).max()
    for token in range(4):
        for r in robots:
            r["tc"].send_poses(token, r["keys"], r["poses"])
        steps = [r["tc"].consensus_step(token, r["keys"], r["poses"], r["tilde"],
                                        expected_peers=1, timeout_ms=50, send=False)
                 for r in robots]
        for r, (gpose, tilde_arr, n_peers, counts) in zip(robots, steps):
            assert n_peers == 1 and set(r["tilde"]) == set(int(k) for k in r["keys"])
            np.testing.assert_array_equal(counts, [2] * 5 + [1])
            np.testing.assert_array_equal(tilde_arr[5], 0.0)
            r["poses"] = 0.5 * (r["poses"] + gpose)
    d1 = np.abs(robots[0]["poses"][:5, :3] - robots[1]["poses"][:5, :3]).max()
    assert d1 < 0.1 * d0
    robots[0]["tc"].ref_frame_id = 7       # another world frame: not heard
    robots[1]["tc"].send_poses(9, robots[1]["keys"], robots[1]["poses"])
    assert robots[0]["tc"].collect(9, expected_peers=1, timeout_ms=30) == {}
