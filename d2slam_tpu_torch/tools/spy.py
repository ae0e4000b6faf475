"""Swarm traffic spy: subscribe to the multicast channels and report.

Counterpart of ``d2slam_tpu/tools/spy.py``: the reference's
d2frontend_spy (d2frontend/src/d2frontend_spy.cpp, which subscribes the
LCM keyframe traffic and displays it) plus the network byte counters
LoopNet prints under ``print_network_status`` (loop_net.cpp:34-38,
163-175). ``SpyStats`` accumulates per-channel packet / byte counters
and decoded keyframe summaries from any transport with the
``recv(timeout_ms)`` interface; ``main()`` wires it to the port's UDP
multicast transport. Host code only: nothing runs on the card.

    python -m d2slam_tpu_torch.tools.spy --seconds 10
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from d2slam_tpu_torch.comm.codec import decode_keyframe
from d2slam_tpu_torch.comm.transport import (
    CH_DISTRIB_VINS,
    CH_PGO_DATA,
    CH_SWARM_LOOP,
    CH_SYNC_SIGNAL,
    CH_SYNC_SLDWIN,
    CH_VIOKF_HEADER,
    CH_VIOKF_IMG,
    CH_VIOKF_LANDMARKS,
)

CHANNEL_NAMES = {
    CH_VIOKF_HEADER: "VIOKF_HEADER",
    CH_VIOKF_LANDMARKS: "VIOKF_LANDMARKS",
    CH_SWARM_LOOP: "SWARM_LOOP_CONN",
    CH_DISTRIB_VINS: "DISTRIB_VINS_DATA",
    CH_SYNC_SIGNAL: "SYNC_SIGNAL",
    CH_SYNC_SLDWIN: "SYNC_SLDWIN",
    CH_PGO_DATA: "PGO_Sync_Data",
    CH_VIOKF_IMG: "VIOKF_IMG_ARRAY",
    8: "KF_REQUEST",
}


@dataclasses.dataclass
class ChannelCounter:
    packets: int = 0
    bytes: int = 0


class SpyStats:
    """Accumulates traffic statistics from (channel, sender, payload)."""

    def __init__(self) -> None:
        self.by_channel: Dict[int, ChannelCounter] = defaultdict(ChannelCounter)
        self.by_sender: Dict[int, ChannelCounter] = defaultdict(ChannelCounter)
        self.keyframes: List[Tuple[int, int, int]] = []  # sender, frame, n_lm
        self.t0 = None
        self.t_last = None

    def ingest(self, channel: int, sender: int, payload: bytes,
               now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        if self.t0 is None:
            self.t0 = now
        self.t_last = now
        for c in (self.by_channel[channel], self.by_sender[sender]):
            c.packets += 1
            c.bytes += len(payload)
        if channel in (CH_VIOKF_HEADER, CH_VIOKF_LANDMARKS):
            pkt = decode_keyframe(payload)
            if pkt is not None:
                self.keyframes.append((sender, int(pkt.frame_id), len(pkt.lm_ids)))

    def pump(self, transport, seconds: float, tick=None) -> int:
        """Drain a transport for ``seconds``; returns packets seen."""
        n = 0
        deadline = time.time() + seconds
        while time.time() < deadline:
            msg = transport.recv(timeout_ms=50)
            if msg is None:
                continue
            ch, sender, payload = msg
            self.ingest(ch, sender, payload)
            n += 1
            if tick:
                tick(ch, sender, payload)
        return n

    def report(self) -> str:
        dt = ((self.t_last - self.t0) if self.t0 is not None and self.t_last != self.t0
              else 1.0)
        lines = ["channel              pkts      bytes     rate"]
        for ch in sorted(self.by_channel):
            c = self.by_channel[ch]
            name = CHANNEL_NAMES.get(ch, f"ch{ch}")
            lines.append(f"{name:<20} {c.packets:>5} {c.bytes:>10} "
                         f"{c.bytes / dt / 1024:>7.1f} KB/s")
        for sid in sorted(self.by_sender):
            s = self.by_sender[sid]
            lines.append(f"sender {sid:<3} -> {s.packets} pkts, {s.bytes} B")
        if self.keyframes:
            sender, frame, n_lm = self.keyframes[-1]
            lines.append(f"keyframes decoded: {len(self.keyframes)} (last: drone {sender} "
                         f"frame {frame} with {n_lm} landmarks)")
        return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    from d2slam_tpu_torch.comm.transport import UDPMulticastTransport

    ap = argparse.ArgumentParser(description="swarm traffic spy")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--self-id", type=int, default=9999)
    ap.add_argument("--group", default="224.0.0.251")
    ap.add_argument("--port", type=int, default=7667)
    args = ap.parse_args(argv)

    t = UDPMulticastTransport(args.self_id, args.group, args.port)
    stats = SpyStats()
    try:
        stats.pump(t, args.seconds, tick=lambda ch, s, p: print(
            f"[{CHANNEL_NAMES.get(ch, ch)}] from {s}: {len(p)} B"))
    finally:
        t.close()
    print(stats.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
