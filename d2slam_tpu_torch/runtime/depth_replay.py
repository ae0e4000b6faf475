"""Threaded quadcam depth replay: raw / inference / publish stages.

Counterpart of the pipelined replay of ``examples/run_quadcam_depth.py``
(after the reference's raw-process, inference and publish threads,
quadcam_depth_est_trt.hpp:32-43): a producer thread puts each frame's
fisheye images into a bounded queue; a worker thread runs
``depth.quadcam.quadcam_depth`` on a CUDA stream of its own and puts
the clouds, copied to the host, into a second queue; the caller's
thread publishes them in order. The stages are threads of one process,
so the queues hand over references (``queue.Queue``), not pickled bytes
as ``runtime.pipeline.FrameQueue`` does; only host objects may cross
them (a CUDA tensor raises). A full queue blocks its producer rather
than drop a frame, and a put that waits past the timeout raises, so the
clouds equal the serial ``quadcam_depth`` ones frame by frame.

    replay = DepthReplay(pairs, cfg, device="cuda")
    clouds = replay.run(frames)   # [(images, color_images or None), ...]
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, List, Optional

import torch

from d2slam_tpu_torch.depth.quadcam import QuadcamConfig, VirtualStereoPair, quadcam_depth
from d2slam_tpu_torch.utils import perf
from d2slam_tpu_torch.utils.device import resolve_device

_END = ("end",)
QUEUE_CAPACITY = 2   # frames in flight per queue (the reference's raw / output buffers)
_POLL_S = 0.05       # how often a blocked stage looks for the run's end


def _host_clouds(out) -> list:
    """Host copies of each pair's (points, valid[, texture])."""
    with perf.span("depth.download"):
        return [tuple(x.cpu().numpy() for x in pair) for pair in out]


def _check_host(obj) -> None:
    """Raise if ``obj`` (nested tuples / lists) holds a CUDA tensor."""
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _check_host(x)
    elif isinstance(obj, torch.Tensor) and obj.is_cuda:
        raise TypeError("a CUDA tensor cannot cross the replay's queues; "
                        "copy what the next stage needs to the host first")


def _put(q: queue.Queue, item, stop: threading.Event, timeout_s: float) -> None:
    """Put ``item`` on ``q``, waiting while it is full; returns early once
    ``stop`` is set (the run is ending), raises TimeoutError after
    ``timeout_s``: a frame is never dropped in silence."""
    _check_host(item)
    deadline = time.perf_counter() + timeout_s
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return
        except queue.Full:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"queue full for {timeout_s} s") from None


def _get(q: queue.Queue, stop: threading.Event, timeout_s: float):
    """The next item of ``q``; ``_END`` once ``stop`` is set; raises
    TimeoutError after ``timeout_s`` without one."""
    deadline = time.perf_counter() + timeout_s
    while not stop.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"nothing queued for {timeout_s} s") from None
    return _END


class DepthReplay:
    """Three-stage replay of quadcam frames over bounded queues.

    pairs / cfg / hitnet: as ``quadcam_depth`` (the pairs' maps on
    ``device``).
    ``stats`` holds the host-clock time of each stage per frame ("raw":
    the producer's put, "inference", "publish") after a run: the totals
    of the stages ``replay.produce``, ``replay.infer`` and
    ``replay.publish``, whose spans are keyed by the frame's index in
    the run. The recorder (``utils.perf``) also gets each frame's wait
    in the queues, from the put's return to the take
    ("replay.queued_raw") and from the worker's put to the take
    ("replay.queued_out", a wait on a full queue included)."""

    def __init__(self, pairs: List[VirtualStereoPair], cfg: QuadcamConfig = QuadcamConfig(),
                 *, hitnet=None, device=None):
        self.pairs, self.cfg, self.hitnet = pairs, cfg, hitnet
        self.device = resolve_device(device)
        self.stats = {}

    def _infer(self, imgs, colors) -> list:
        return _host_clouds(quadcam_depth(imgs, self.pairs, self.cfg, hitnet=self.hitnet,
                                          color_images=colors, device=self.device))

    def run(self, frames: Iterable, publish: Optional[Callable[[int, list], None]] = None,
            timeout_s: float = 60.0) -> list:
        """Replay ``frames`` (each ``(images, color_images or None)``,
        host arrays, ``uint8`` or float). Returns the host clouds of the
        frames in order; ``publish(index, clouds)`` is called on the
        caller's thread as each arrives. A stage's error, or a queue
        that stays full or empty for ``timeout_s``, ends the run with
        that error on the caller's thread."""
        q_raw: queue.Queue = queue.Queue(QUEUE_CAPACITY)
        q_out: queue.Queue = queue.Queue(QUEUE_CAPACITY)
        tracker = perf.PerfTracker("replay")
        self.stats = {old: tracker.totals(new) for old, new in
                      (("raw", "produce"), ("inference", "infer"), ("publish", "publish"))}
        errors: List[BaseException] = []
        stop = threading.Event()

        def stage(body, q_next):
            try:
                body()
            except BaseException as e:  # re-raised on the caller's thread
                errors.append(e)
            finally:
                try:
                    _put(q_next, _END, stop, timeout_s)
                except BaseException as e:
                    errors.append(e)

        def produce():
            for k, (imgs, colors) in enumerate(frames):
                put_at = [None]    # when the put returned, for the queue's wait
                with tracker.stage("produce", k):
                    _put(q_raw, (k, imgs, colors, put_at), stop, timeout_s)
                put_at[0] = time.perf_counter()

        def infer():
            stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
            while True:
                item = _get(q_raw, stop, timeout_s)
                if item == _END:
                    return
                k, imgs, colors, put_at = item
                t = time.perf_counter()
                perf.interval("replay.queued_raw", put_at[0] or t, t, k)
                with tracker.stage("infer", k):
                    if stream is None:
                        clouds = self._infer(imgs, colors)
                    else:
                        with torch.cuda.stream(stream):
                            clouds = self._infer(imgs, colors)
                _put(q_out, (k, clouds, time.perf_counter()), stop, timeout_s)

        threads = [threading.Thread(target=stage, args=a, daemon=True)
                   for a in ((produce, q_raw), (infer, q_out))]
        for t in threads:
            t.start()
        results = []
        try:
            while True:
                item = _get(q_out, stop, timeout_s)
                if item == _END:
                    break
                k, clouds, t_put = item
                with tracker.stage("publish", k) as s:
                    perf.interval("replay.queued_out", t_put, s.t0, k)
                    if publish is not None:
                        publish(k, clouds)
                    results.append(clouds)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=timeout_s)
        if errors:
            raise errors[0]
        return results


def serial_depth(frames: Iterable, pairs: List[VirtualStereoPair],
                 cfg: QuadcamConfig = QuadcamConfig(), *, device=None) -> list:
    """The same frames through ``quadcam_depth`` one after another on
    the caller's thread: the reference the replay is held against."""
    dev = resolve_device(device)
    return [_host_clouds(quadcam_depth(imgs, pairs, cfg, color_images=colors, device=dev))
            for imgs, colors in frames]


def clouds_equal(a: list, b: list) -> bool:
    """Frame by frame, pair by pair, every array equal bit for bit."""
    return len(a) == len(b) and all(
        len(fa) == len(fb) and all(
            len(pa) == len(pb) and all(
                x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
                for x, y in zip(pa, pb))
            for pa, pb in zip(fa, fb))
        for fa, fb in zip(a, b))
