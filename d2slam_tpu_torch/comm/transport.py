"""Swarm transports: native UDP multicast, channel routing, an in-memory bus.

The port's counterpart of ``d2slam_tpu/comm/transport.py``. Channel ids
mirror the reference's LCM channels (reference: loop_net.cpp:10-22,
d2vins_net.cpp:8-27, d2comm.cpp:14-23) and equal the JAX package's, so
either package's robots can share one bus.

The native transport is the port's own copy of ``udp_transport.cpp``,
compiled with ``g++`` at first use by ``utils/native.build_shared_lib``
into ``d2slam_tpu_torch/_build/`` under a hash of source and command;
nothing is written beside the source.
"""
from __future__ import annotations

import collections
import ctypes
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np

from d2slam_tpu_torch.utils.native import PKG_DIR, build_shared_lib

# channel ids (reference LCM channel names)
CH_VIOKF_HEADER = 1      # "VIOKF_HEADER"
CH_VIOKF_LANDMARKS = 2   # "VIOKF_LANDMARKS"
CH_SWARM_LOOP = 3        # "SWARM_LOOP_CONN"
CH_DISTRIB_VINS = 4      # "DISTRIB_VINS_DATA"
CH_SYNC_SIGNAL = 5       # "SYNC_SIGNAL"
CH_SYNC_SLDWIN = 6       # "SYNC_SLDWIN"
CH_PGO_DATA = 7          # "PGO_Sync_Data"
CH_VIOKF_IMG = 9         # "VIOKF_IMG_ARRAY" (optional send_img attachments)

SOURCE = os.path.join(PKG_DIR, "comm", "native", "udp_transport.cpp")

_LIB = None


def _load_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build_shared_lib("udp_transport", SOURCE, ["g++"], ["-O2", "-fPIC", "-shared"])
        lib.udp_transport_create.restype = ctypes.c_void_p
        lib.udp_transport_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint16, ctypes.c_int]
        lib.udp_transport_destroy.argtypes = [ctypes.c_void_p]
        lib.udp_transport_send.restype = ctypes.c_int
        lib.udp_transport_send.argtypes = [
            ctypes.c_void_p, ctypes.c_uint16, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32]
        lib.udp_transport_errno.restype = ctypes.c_int
        lib.udp_transport_errno.argtypes = []
        lib.udp_transport_recv.restype = ctypes.c_int
        lib.udp_transport_recv.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32, ctypes.c_int]
        _LIB = lib
    return _LIB


class UDPMulticastTransport:
    """Swarm transport on the reference's multicast group
    (udpm://224.0.0.251:7667, reference d2vins/launch/tum.launch:27)."""

    def __init__(self, self_id: int, group: str = "224.0.0.251",
                 port: int = 7667, loopback: bool = True,
                 max_msg: int = 4 * 1024 * 1024):
        self._lib = _load_lib()
        self._where = f"{group}:{port}"
        self._h = self._lib.udp_transport_create(group.encode(), port, self_id, int(loopback))
        if not self._h:
            self._raise("cannot join the multicast group")
        self._buf = (ctypes.c_uint8 * max_msg)()
        self._max = max_msg

    def send(self, channel: int, data: bytes) -> None:
        arr = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        if self._lib.udp_transport_send(self._h, channel, arr, len(data)) != 0:
            self._raise("cannot send to the multicast group")

    def _raise(self, what: str) -> None:
        err = self._lib.udp_transport_errno()
        raise OSError(err, f"UDP multicast {self._where}: {what}: {os.strerror(err)}")

    def recv(self, timeout_ms: int = 0) -> Optional[Tuple[int, int, bytes]]:
        """Returns (channel, sender, payload) or None."""
        ch = ctypes.c_uint16(0)
        snd = ctypes.c_uint16(0)
        n = self._lib.udp_transport_recv(self._h, ctypes.byref(ch), ctypes.byref(snd),
                                         self._buf, self._max, timeout_ms)
        if n <= 0:
            return None
        return int(ch.value), int(snd.value), bytes(self._buf[:n])

    def close(self) -> None:
        if self._h:
            self._lib.udp_transport_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# channel routing (one socket, many consumers)
# ---------------------------------------------------------------------------


class ChannelRouter:
    """Demultiplex one transport across several consumers by channel.

    The reference gives every module its own LCM subscription on one
    multicast socket (loop_net.cpp:10-22, d2vins_net.cpp:8-27,
    d2comm.cpp:14-23); the raw transport has a single ``recv`` queue, so
    ``route(channels)`` returns an endpoint whose ``recv`` yields only
    those channels. Messages for other routes are queued for their
    owners; a channel no route takes is dropped, like LCM. One thread
    per robot.
    """

    def __init__(self, transport):
        self.transport = transport
        self._routes: list = []

    def route(self, channels) -> "RoutedEndpoint":
        ep = RoutedEndpoint(self, frozenset(channels))
        self._routes.append(ep)
        return ep

    def _pump(self, timeout_ms: int) -> bool:
        msg = self.transport.recv(timeout_ms=timeout_ms)
        if msg is None:
            return False
        for ep in self._routes:
            if msg[0] in ep.channels:
                ep._q.append(msg)
                break
        return True

    def close(self) -> None:
        self.transport.close()


class RoutedEndpoint:
    def __init__(self, router: ChannelRouter, channels: frozenset):
        self._router = router
        self.channels = channels
        self._q: list = []

    def send(self, channel: int, data: bytes) -> None:
        self._router.transport.send(channel, data)

    def recv(self, timeout_ms: int = 0):
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            if self._q:
                return self._q.pop(0)
            remain_ms = int((deadline - time.monotonic()) * 1000)
            if not self._router._pump(max(remain_ms, 0)) and remain_ms <= 0:
                return None

    def close(self) -> None:  # routes share the socket; the owner closes it
        pass


# ---------------------------------------------------------------------------
# buffered reader and in-memory bus
# ---------------------------------------------------------------------------


class BufferedTransport:
    """Wrap a transport with a reader thread that drains the socket
    continuously into an unbounded host queue, so a slow consumer does
    not overflow the kernel's socket buffer and lose keyframe packets
    (UDP multicast has no replay)."""

    def __init__(self, inner, poll_ms: int = 50):
        self._inner = inner
        self._q = collections.deque()
        self._cv = threading.Condition()
        self._stop = False

        def _pump():
            while not self._stop:
                m = inner.recv(poll_ms)
                if m is not None:
                    with self._cv:
                        self._q.append(m)
                        self._cv.notify()

        self._thread = threading.Thread(target=_pump, daemon=True)
        self._thread.start()

    def send(self, channel: int, data: bytes) -> None:
        self._inner.send(channel, data)

    def recv(self, timeout_ms: int = 0):
        with self._cv:
            if not self._q and timeout_ms > 0:
                self._cv.wait(timeout_ms / 1000.0)
            return self._q.popleft() if self._q else None

    def close(self) -> None:
        self._stop = True
        self._thread.join(timeout=2.0)
        if hasattr(self._inner, "close"):
            self._inner.close()


class LocalBus:
    """In-memory multicast bus with the ``UDPMulticastTransport``
    interface, for robots in one process: every endpoint gets every
    other endpoint's messages (self-messages are suppressed, as the UDP
    transport does). ``drop_prob`` loses each delivery with that
    probability, drawn from ``np.random.default_rng(seed)`` (the
    reference's d2pgo_test lossy-link simulation, d2pgo_test.cpp:36-75).
    """

    def __init__(self, drop_prob: float = 0.0, seed: int = 0):
        self.endpoints = {}
        self.drop_prob = drop_prob
        self._rng = np.random.default_rng(seed)

    def endpoint(self, self_id: int) -> "LocalEndpoint":
        ep = LocalEndpoint(self, self_id)
        self.endpoints[self_id] = ep
        return ep


class LocalEndpoint:
    def __init__(self, bus: LocalBus, self_id: int):
        self._bus = bus
        self.self_id = self_id
        self._q = []

    def send(self, channel: int, data: bytes) -> None:
        for sid, ep in self._bus.endpoints.items():
            if sid == self.self_id:
                continue  # self-message suppression (loop_net.cpp)
            if self._bus.drop_prob and self._bus._rng.random() < self._bus.drop_prob:
                continue
            ep._q.append((channel, self.self_id, bytes(data)))

    def recv(self, timeout_ms: int = 0):
        return self._q.pop(0) if self._q else None

    def close(self) -> None:
        self._bus.endpoints.pop(self.self_id, None)
