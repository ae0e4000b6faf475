"""The port's swarm traffic spy (d2slam_tpu_torch/tools/spy.py): its
report equals the JAX package's for the same ingested packets, and it
counts a LoopNet keyframe broadcast over UDP loopback multicast packet
for packet and byte for byte."""
import errno
import threading
import time

import numpy as np
import pytest

from d2slam_tpu.comm import codec as jc
from d2slam_tpu.tools import spy as jspy
from d2slam_tpu_torch.comm import codec as pc
from d2slam_tpu_torch.comm.loopnet import LoopNet
from d2slam_tpu_torch.comm.transport import (
    CH_SYNC_SIGNAL,
    CH_VIOKF_HEADER,
    CH_VIOKF_IMG,
    CH_VIOKF_LANDMARKS,
    UDPMulticastTransport,
)
from d2slam_tpu_torch.tools import spy as pspy
from tests.test_comm import make_packet

# UDP ports of this file (no other test uses them)
PUMP_PORT, CLI_PORT, BAD_GROUP_PORT = 17701, 17702, 17709


def _traffic():
    """(channel, sender, payload, now) of a mixed stream: keyframes on
    both keyframe channels, a header that does not decode, a sync signal,
    a frame request and an unnamed channel."""
    full = jc.encode_keyframe(make_packet(n=12))
    other = pc.encode_keyframe(pc.RemoteKeyframePacket(**make_packet(n=5, seed=2)._asdict()))
    return [(CH_VIOKF_LANDMARKS, 3, full, 1.0), (CH_VIOKF_LANDMARKS, 3, full, 1.5),
            (CH_VIOKF_HEADER, 4, other, 1.75), (CH_VIOKF_HEADER, 4, b"\x01\x02", 1.8),
            (CH_SYNC_SIGNAL, 1, b"\x00" * 16, 2.0), (8, 1, b"\x07" * 24, 2.25),
            (11, 6, b"\x05" * 3, 2.5)]


def test_spy_report_equals_jax():
    ps, js = pspy.SpyStats(), jspy.SpyStats()
    for ch, sender, payload, now in _traffic():
        ps.ingest(ch, sender, payload, now=now)
        js.ingest(ch, sender, payload, now=now)
    assert ps.report() == js.report()
    assert ps.keyframes == js.keyframes
    assert ps.keyframes[-1] == (4, 12345678901, 5)
    assert {c: (v.packets, v.bytes) for c, v in ps.by_channel.items()} == {
        c: (v.packets, v.bytes) for c, v in js.by_channel.items()}
    assert pspy.CHANNEL_NAMES == jspy.CHANNEL_NAMES
    assert pspy.SpyStats().report() == jspy.SpyStats().report()


def test_spy_counts_loopnet_broadcast_over_udp():
    """One LoopNet keyframe broadcast with its two camera views
    (VIOKF_LANDMARKS + 2 x VIOKF_IMG) over the port's multicast
    transport: the spy's per-channel packets and bytes equal what was
    sent."""
    sender = UDPMulticastTransport(1, port=PUMP_PORT)
    spy = UDPMulticastTransport(9999, port=PUMP_PORT)
    try:
        net = LoopNet(sender, 1, send_img=True)
        pkt = pc.RemoteKeyframePacket(**make_packet(n=40)._asdict())
        views = [np.full((30, 40), 17 * (v + 1), np.uint8) for v in range(2)]
        sent = {}

        def count(ch, data):
            c = sent.setdefault(ch, [0, 0])
            c[0] += 1
            c[1] += len(data)

        send = sender.send

        def send_and_count(ch, data):
            count(ch, data)
            send(ch, data)

        sender.send = send_and_count
        stats = pspy.SpyStats()
        th = threading.Thread(target=lambda: (time.sleep(0.1),
                                              net.broadcast_keyframe(pkt, images=views)))
        th.start()
        n = stats.pump(spy, seconds=0.6)
        th.join(timeout=5)
        assert not th.is_alive()
        assert set(sent) == {CH_VIOKF_LANDMARKS, CH_VIOKF_IMG}
        assert n == 3
        assert {c: [v.packets, v.bytes] for c, v in stats.by_channel.items()} == sent
        assert sum(b for _, b in sent.values()) == net.sent_bytes
        assert stats.keyframes == [(1, pkt.frame_id, 40)]
    finally:
        sender.close()
        spy.close()


def test_spy_cli(capsys):
    assert pspy.main(["--seconds", "0.2", "--port", str(CLI_PORT)]) == 0
    assert capsys.readouterr().out.startswith("channel")


def test_transport_raises_the_os_error():
    """A group the host cannot join raises OSError with its errno and the
    address (the CLIs over multicast then stop with it; nothing falls
    back to an in-process hand-over)."""
    with pytest.raises(OSError, match=f"10.0.0.1:{BAD_GROUP_PORT}") as e:
        UDPMulticastTransport(1, group="10.0.0.1", port=BAD_GROUP_PORT)
    assert e.value.errno == errno.EINVAL
