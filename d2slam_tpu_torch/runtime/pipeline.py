"""Frame pipeline runtime: native bounded queues, PNG decode, ordered
image prefetch, and a threaded stage executor.

Counterpart of ``d2slam_tpu/runtime/pipeline.py`` (the reference's node
runtime: the bounded image queue that drops frames under load,
d2frontend/src/d2frontend.cpp:70-153, drop when backlogged :81-84, and
the thread pipeline camera-cb -> CNN/tracker thread -> estimator thread,
d2frontend.cpp:155-198, d2vins/src/d2vins_node.cpp:128-303). Queues, PNG
decoding and prefetch ordering live in C++, the port's own copy
``runtime/native/pipeline.cpp``, built with ``g++`` at first use into
the ignored ``_build/`` under a hash of source and flags (the JAX
package rebuilds its library beside the source) and bound with ctypes.
Stage bodies are Python callables; torch releases the GIL inside its
kernels and copies, so stages overlap.

Items that cross a queue are pickled host objects. A CUDA tensor is
refused there: pickling it would hide a copy to the host.
"""
from __future__ import annotations

import ctypes
import io
import os
import pickle
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from d2slam_tpu_torch.utils.native import PKG_DIR, build_shared_lib
from d2slam_tpu_torch.utils.perf import StageStats

SOURCE = os.path.join(PKG_DIR, "runtime", "native", "pipeline.cpp")

_LIB = None


def _load_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = build_shared_lib("pipeline", SOURCE, ["g++"], ["-O2", "-fPIC", "-shared"],
                           ["-lz", "-lpthread"])
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.fq_create.restype = ctypes.c_void_p
    lib.fq_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fq_destroy.argtypes = [ctypes.c_void_p]
    lib.fq_close.argtypes = [ctypes.c_void_p]
    lib.fq_push.restype = ctypes.c_int
    lib.fq_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32, ctypes.c_int]
    lib.fq_pop.restype = ctypes.c_int
    lib.fq_pop.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32, ctypes.c_int, u32p]
    lib.fq_size.restype = ctypes.c_int
    lib.fq_size.argtypes = [ctypes.c_void_p]
    lib.fq_stats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p]
    lib.png_decode.restype = ctypes.c_int
    lib.png_decode.argtypes = [u8p, ctypes.c_uint32, u8p, ctypes.c_uint32,
                               u32p, u32p, u32p, u32p, u32p]
    lib.prefetch_create.restype = ctypes.c_void_p
    lib.prefetch_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.prefetch_next.restype = ctypes.c_int
    lib.prefetch_next.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32,
                                  u32p, u32p, u32p, u32p, ctypes.c_int, u32p]
    lib.prefetch_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def build() -> None:
    """Compile and load the native library now (it is otherwise built
    at its first use)."""
    _load_lib()


class _HostPickler(pickle.Pickler):
    """Pickles host objects only: a CUDA tensor raises."""

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            raise TypeError("a CUDA tensor cannot cross a byte queue; "
                            "copy what the next stage needs to the host first")
        return None


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


class FrameQueue:
    """Bounded byte queue (C++). drop_oldest=True reproduces the
    reference's frame-drop-under-load policy with a dropped counter."""

    def __init__(self, capacity: int = 2, drop_oldest: bool = True):
        self._lib = _load_lib()
        self._h = self._lib.fq_create(capacity, int(drop_oldest))

    def push(self, data: bytes, block_ms: int = 0) -> int:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return self._lib.fq_push(self._h, buf, len(data), block_ms)

    def push_obj(self, obj, block_ms: int = 0) -> int:
        return self.push(_dumps(obj), block_ms)

    def pop(self, timeout_ms: int = 100) -> Optional[bytes]:
        cap = 1 << 16
        while True:
            buf = (ctypes.c_uint8 * cap)()
            need = ctypes.c_uint32(0)
            rc = self._lib.fq_pop(self._h, buf, cap, timeout_ms, ctypes.byref(need))
            if rc == -3:
                cap = max(need.value, cap * 2)
                continue
            if rc < 0:
                return None
            return bytes(bytearray(buf[:rc]))

    def pop_obj(self, timeout_ms: int = 100):
        b = self.pop(timeout_ms)
        return None if b is None else pickle.loads(b)

    def close(self) -> None:
        self._lib.fq_close(self._h)

    def __len__(self) -> int:
        return self._lib.fq_size(self._h)

    @property
    def stats(self) -> Dict[str, int]:
        p, o, d = ctypes.c_uint64(0), ctypes.c_uint64(0), ctypes.c_uint64(0)
        self._lib.fq_stats(self._h, ctypes.byref(p), ctypes.byref(o), ctypes.byref(d))
        return {"pushed": p.value, "popped": o.value, "dropped": d.value}

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.fq_destroy(h)


def _as_image(data: np.ndarray, w, h, ch, depth) -> np.ndarray:
    arr = data.view(np.uint16 if depth.value == 16 else np.uint8)
    arr = arr.reshape(h.value, w.value, ch.value)
    return arr[..., 0] if ch.value == 1 else arr


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes with the native decoder. Returns [H, W] (gray)
    or [H, W, C]; dtype uint8 or uint16. Raises ``ValueError`` on a
    stream it cannot decode (palette, interlaced, corrupt)."""
    lib = _load_lib()
    src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    w, h, ch, depth, need = (ctypes.c_uint32(0) for _ in range(5))
    dims = [ctypes.byref(x) for x in (w, h, ch, depth, need)]
    rc = lib.png_decode(src, len(data), None, 0, *dims)
    if rc != -3:
        raise ValueError(f"png_decode failed ({rc})")
    out = np.empty(need.value, np.uint8)
    rc = lib.png_decode(src, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        need.value, *dims)
    if rc != 0:
        raise ValueError(f"png_decode failed ({rc})")
    return _as_image(out, w, h, ch, depth)


class ImagePrefetcher:
    """Ordered multi-threaded PNG loader (C++ worker threads decode
    ahead; images come out strictly in path order, ``None`` for a file
    that does not decode)."""

    def __init__(self, paths: Sequence[str], n_threads: int = 2, window: int = 4):
        self._lib = _load_lib()
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h = self._lib.prefetch_create(arr, len(self._paths), n_threads, window)
        self._n = len(paths)

    def __iter__(self):
        cap = 1 << 20
        buf = np.empty(cap, np.uint8)
        emitted = 0
        while emitted < self._n:
            w, h, ch, depth, need = (ctypes.c_uint32(0) for _ in range(5))
            rc = self._lib.prefetch_next(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch), ctypes.byref(depth),
                10000, ctypes.byref(need))
            if rc == -3:
                cap = max(need.value, cap * 2)
                buf = np.empty(cap, np.uint8)
                continue
            if rc == -2:
                return
            if rc == -4:
                yield None  # decode error for this index
                emitted += 1
                continue
            if rc < 0:
                raise TimeoutError("prefetch_next timed out")
            yield _as_image(buf[:rc].copy(), w, h, ch, depth)
            emitted += 1

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.prefetch_destroy(h)


class FramePipeline:
    """Threaded stage executor: stage i pops from queue i, runs fn,
    pushes the result to queue i+1. Queue 0 is the ingress (camera
    callback side); the final stage's returns are collected in order.

    stages: [(name, fn, queue_capacity, drop_oldest)]. A stage fn
    returning None drops the item (not forwarded). A stage fn that
    raises drops the item too, as the reference drops a frame under
    load; ``(stage name, repr(error))`` is appended to ``_errors``,
    which a caller must read.
    """

    def __init__(self, stages: List[Tuple[str, Callable, int, bool]]):
        self.names = [s[0] for s in stages]
        self.fns = [s[1] for s in stages]
        self.queues = [FrameQueue(s[2], s[3]) for s in stages]
        self.out: List = []
        self.stats = {s[0]: StageStats() for s in stages}
        self._threads: List[threading.Thread] = []
        self._out_lock = threading.Lock()
        self._closing = False
        self._errors: List[Tuple[str, str]] = []
        # items popped from queue i whose result has been forwarded (or
        # dropped); queue i's "popped" stat minus this is the in-flight
        # count, with no pop-to-flag race (the C++ pop increments
        # "popped" atomically with removing the item)
        self._done = [0] * len(stages)

    def submit(self, item) -> int:
        """Ingress push (returns 1 if an old frame was dropped)."""
        return self.queues[0].push_obj(item)

    def _in_flight(self, i: int) -> int:
        return self.queues[i].stats["popped"] - self._done[i]

    def _upstream_done(self, i: int) -> bool:
        """No work can still reach stage i's queue."""
        return all(len(self.queues[k]) == 0 and self._in_flight(k) == 0 for k in range(i))

    def _worker(self, i: int):
        while True:
            item = self.queues[i].pop_obj(timeout_ms=200)
            if item is None:
                if self._closing and len(self.queues[i]) == 0 and self._upstream_done(i):
                    return
                continue
            t0 = time.perf_counter()
            try:
                res = self.fns[i](item)
            except Exception as e:  # stage failure drops the frame, recorded
                res = None
                self._errors.append((self.names[i], repr(e)))
            self.stats[self.names[i]].add(time.perf_counter() - t0)
            if res is not None:
                if i + 1 < len(self.queues):
                    self.queues[i + 1].push_obj(res, block_ms=1000)
                else:
                    with self._out_lock:
                        self.out.append(res)
            self._done[i] += 1

    def start(self):
        self._closing = False
        self._errors = []
        for i in range(len(self.fns)):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def drain(self, timeout_s: float = 30.0):
        """Wait until all queued and in-flight work is processed, then
        stop the workers. In-flight = a stage fn still executing (its
        result not forwarded yet), tracked per stage so a slow stage
        cannot lose its output."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if (all(len(q) == 0 for q in self.queues)
                    and all(self._in_flight(i) == 0 for i in range(len(self.fns)))):
                break
            time.sleep(0.01)
        self._closing = True
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._threads.clear()
        return self.out

    @property
    def dropped(self) -> Dict[str, int]:
        return {n: q.stats["dropped"] for n, q in zip(self.names, self.queues)}
