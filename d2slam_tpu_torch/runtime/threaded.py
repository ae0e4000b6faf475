"""Two-thread frontend/backend pipeline around a ``D2SLAMSystem``.

Counterpart of ``d2slam_tpu/runtime/threaded.py``. The reference runs the
camera callback, the CNN + tracking thread (processStereoFrameThread)
and the estimator thread (processVIOKFThread) concurrently
(d2frontend/src/d2frontend.cpp:155-198, d2vins/src/d2vins_node.cpp:
128-303, a bounded queue that drops frames when more than 2 are
pending, d2frontend.cpp:81-84). This wrapper makes the same split:

  caller thread:  input_imu / input_stereo -> tracker (extraction +
                  association) -> keyframe queue
  backend thread: estimator solve + loop detection + PGO

Streams. The caller thread's torch work (association, matching) runs
on its current stream. With a tracker that supports it, frame k+1's
upload and extraction (SuperPoint with the stem kernel, NetVLAD) are
queued on the tracker's side stream while frame k is associated; the
tracker's resolver makes the caller's stream wait on that work's event.
The backend thread runs its torch work (estimator, loop verification,
PGO) on a stream of its own, which at construction waits for the work
already queued on the caller's stream. The two threads meet only in
host objects: each queued item holds the ``FrontendFrame`` (numpy), the
IMU samples fed before the frame, the frame's global descriptor and its
keyframe descriptors by landmark id, all taken on the caller thread
when the frame was tracked. The backend never reads tracker state that
the caller thread has since moved on (the JAX package's backend reads
the tracker's ``last_aux`` when it registers the keyframe, by which time
the tracker has extracted later frames).

Unlike the JAX package, a frame whose extraction cannot be submitted
first flushes the pending lookahead frame, so frames keep their order;
and the IMU reaches the estimator on the backend thread, in order with
the frames, so the estimator sees exactly what a serial run gives it.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import List, Optional

import numpy as np
import torch


class _Item:
    """One unit of backend work: IMU samples, then (optionally) a
    keyframe with what its registration needs."""

    __slots__ = ("imu", "ff", "imgs", "inputs")

    def __init__(self, imu: List, ff=None, imgs=None, inputs=None):
        self.imu = imu
        self.ff = ff
        self.imgs = imgs
        self.inputs = inputs or {}


class PipelinedSystem:
    """Wrap a D2SLAMSystem with the reference's two-thread pipeline.

    ``depth``: bound of the keyframe queue. With ``drop_oldest`` (the
    reference's behaviour under load) the newest keyframe replaces the
    oldest queued one when the backend falls behind (its IMU samples go
    on to the next item); otherwise the caller blocks (deterministic
    replay)."""

    def __init__(self, system, depth: int = 2, drop_oldest: bool = False):
        if getattr(system, "loopnet", None) is not None:
            # polling the transport on the caller thread would race the
            # backend's swarm and pose-graph updates
            raise NotImplementedError("PipelinedSystem over a system with a transport: drive "
                                      "the swarm serially (input_* and poll_network)")
        self.sys = system
        self.depth = depth
        self.drop_oldest = drop_oldest
        self._items: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._err: Optional[BaseException] = None
        self._processed = 0
        self._submitted = 0
        self._stop = False
        # IMU samples fed and not queued yet, and how many were fed in all
        self._imu: List = []
        self._imu_fed = 0
        self._imu_queued = 0
        # 1-frame extraction lookahead: (stamp, left, right, resolver,
        # IMU mark) of the frame whose extraction is in flight
        self._pending_fe = None
        dev = getattr(system, "device", None)
        self._stream = None
        if isinstance(dev, torch.device) and dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
        self._thread = threading.Thread(target=self._backend, name="vio-backend", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def input_imu(self, t: float, acc, gyr) -> None:
        """Buffer one IMU sample; it reaches the estimator on the backend
        thread just before the next keyframe tracked after it."""
        self._imu.append((t, np.array(acc, np.float64), np.array(gyr, np.float64)))
        self._imu_fed += 1

    def input_stereo(self, t: float, img_left, img_right) -> None:
        """Frontend stage on the caller thread: extraction and association;
        keyframes queue for the backend. With a tracker that can submit
        its extraction, this frame's extraction is started and the
        previous frame is associated while it runs (one frame of extra
        latency, the same order and keyframe decisions as a serial run)."""
        self._check()
        submit = getattr(self.sys.tracker, "submit_stereo_extraction", None)
        resolver = submit(img_left, img_right) if submit else None
        if resolver is None:
            self._flush_pending()   # keep frame order
            self._frontend(t, img_left, img_right, None, self._imu_fed)
            return
        prev, self._pending_fe = self._pending_fe, (t, img_left, img_right, resolver,
                                                    self._imu_fed)
        if prev is not None:
            self._frontend(*prev)

    def _flush_pending(self) -> None:
        prev, self._pending_fe = self._pending_fe, None
        if prev is not None:
            self._frontend(*prev)

    def _frontend(self, t, img_left, img_right, resolver, imu_mark: int) -> None:
        if resolver is None:
            ff = self.sys.tracker.process_stereo(t, self.sys._frame_id, img_left, img_right)
        else:
            ff = self.sys.tracker.process_stereo(t, self.sys._frame_id, img_left, img_right,
                                                 extracted=resolver)
        self.sys._frame_id += 1
        if ff is None:
            return
        imgs = [np.asarray(img_left), np.asarray(img_right)]
        # this frame's aux output (the resolver's, or the tracker's
        # last_aux right after its extraction on this thread)
        aux = resolver().aux if resolver is not None else None
        self._put(_Item(self._take_imu(imu_mark), ff, imgs, self.sys.keyframe_inputs(imgs, aux)))

    def _take_imu(self, mark: int) -> List:
        """The buffered IMU samples fed before ``mark``."""
        cut = mark - self._imu_queued
        out, self._imu = self._imu[:cut], self._imu[cut:]
        self._imu_queued = mark
        return out

    def _put(self, item: _Item) -> None:
        with self._cv:
            while len(self._items) >= self.depth:
                if self.drop_oldest:
                    # drop the oldest queued keyframe; its IMU samples
                    # go on to the next item
                    old = self._items.popleft()
                    nxt = self._items[0] if self._items else item
                    nxt.imu[:0] = old.imu
                    self._submitted -= 1
                else:
                    self._cv.wait()
            self._items.append(item)
            self._submitted += 1
            self._cv.notify_all()

    def drain(self, timeout: float = 600.0) -> None:
        """Block until every queued keyframe has been processed (the
        lookahead frame is associated first, and the IMU fed since the
        last keyframe goes to the estimator, so nothing stays behind)."""
        self._flush_pending()
        if self._imu:
            self._put(_Item(self._take_imu(self._imu_fed)))
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._processed < self._submitted:
                if self._err is not None:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("pipeline drain timed out")
                self._cv.wait(min(left, 0.05))
        self._check()

    def close(self) -> None:
        """Process what is queued, stop the backend thread and surface its
        last error."""
        try:
            self._flush_pending()
        finally:
            with self._cv:
                self._stop = True
                self._cv.notify_all()
            self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise TimeoutError("pipeline backend did not stop")
        self._check()

    # ------------------------------------------------------------------

    @property
    def odometry(self):
        return self.sys.odometry

    def _check(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _backend(self) -> None:
        ctx = torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()
        with ctx:
            while True:
                with self._cv:
                    while not self._items and not self._stop:
                        self._cv.wait()
                    if not self._items:
                        return
                    item = self._items.popleft()
                    self._cv.notify_all()
                try:
                    self._run(item)
                except Exception as e:  # surfaced on the caller thread
                    self._err = e
                finally:
                    with self._cv:
                        self._processed += 1
                        self._cv.notify_all()

    def _run(self, item: _Item) -> None:
        est = self.sys.estimator
        for (t, acc, gyr) in item.imu:
            est.input_imu(t, acc, gyr)
        if item.ff is None:
            return
        od = est.input_frame(item.ff)
        if od is not None:
            self.sys.odometry = od
            self.sys._register_keyframe(item.ff, od, item.imgs, **item.inputs)
