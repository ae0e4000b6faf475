"""The port's native frame pipeline (``d2slam_tpu_torch/runtime/pipeline.py``
over its own ``runtime/native/pipeline.cpp``) against the JAX package's.

Mirrors ``tests/test_runtime.py``: the queue policies, ``decode_png``
against the JAX package's decoder and Pillow on the same files (exact),
the ordered prefetcher, and the stage drops and drain of
``FramePipeline``. The port's library is built into ``_build/``.
"""
import io
import os
import time

import numpy as np
import pytest
import torch

from d2slam_tpu.runtime.pipeline import decode_png as jax_decode_png
from d2slam_tpu_torch.runtime import pipeline as tp
from d2slam_tpu_torch.utils import pngio
from d2slam_tpu_torch.utils.native import BUILD_DIR


def test_library_builds_under_build_dir_only():
    tp.build()
    path = tp._load_lib()._name
    assert os.path.dirname(path) == BUILD_DIR
    assert os.path.basename(path).startswith("libpipeline-")
    native = os.path.join(os.path.dirname(tp.SOURCE))
    assert not any(f.endswith(".so") for f in os.listdir(native))


def test_queue_fifo_and_stats():
    q = tp.FrameQueue(capacity=4, drop_oldest=True)
    for i in range(3):
        assert q.push_obj({"i": i}) == 0
    assert len(q) == 3
    assert q.pop_obj()["i"] == 0
    assert q.pop_obj()["i"] == 1
    s = q.stats
    assert s["pushed"] == 3 and s["popped"] == 2 and s["dropped"] == 0


def test_queue_drop_oldest_under_load():
    q = tp.FrameQueue(capacity=2, drop_oldest=True)
    for i in range(5):
        q.push_obj(i)
    assert len(q) == 2
    assert q.stats["dropped"] == 3
    assert q.pop_obj() == 3 and q.pop_obj() == 4


def test_queue_reject_policy_and_timeout():
    q = tp.FrameQueue(capacity=1, drop_oldest=False)
    assert q.push_obj("a") == 0
    assert q.push_obj("b") == -1          # full, rejected
    t0 = time.time()
    assert q.pop(timeout_ms=50) is not None
    assert q.pop(timeout_ms=60) is None   # empty -> timeout
    assert time.time() - t0 < 2.0


def test_queue_refuses_device_tensors_but_carries_host_objects():
    q = tp.FrameQueue(capacity=2)
    q.push_obj({"pts": np.arange(3.0), "t": torch.arange(2)})
    got = q.pop_obj()
    np.testing.assert_array_equal(got["pts"], np.arange(3.0))
    assert got["t"].tolist() == [0, 1]

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    with pytest.raises(TypeError, match="CUDA tensor"):
        q.push_obj([torch.zeros(1).as_subclass(FakeCuda)])


def _png_bytes(arr, mode):
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(b, format="PNG")
    return b.getvalue()


@pytest.mark.parametrize("case", ["gray8", "rgb8", "gray16", "pngio"])
def test_png_decode_matches_jax_and_pil(case):
    from PIL import Image

    rng = np.random.RandomState(0)
    if case == "gray8":
        data = _png_bytes(rng.randint(0, 256, (48, 64), np.uint8), "L")
    elif case == "rgb8":
        data = _png_bytes(rng.randint(0, 256, (32, 40, 3), np.uint8), "RGB")
    elif case == "gray16":
        data = _png_bytes(rng.randint(0, 1 << 16, (24, 36), np.uint16), "I;16B")
    else:   # the port's own encoder, read by all three
        data = pngio.png_encode_gray(rng.randint(0, 256, (37, 51), np.uint8))
    pil = np.asarray(Image.open(io.BytesIO(data)))
    if case == "gray16":
        pil = pil.astype(np.uint16)
    out = tp.decode_png(data)
    assert out.dtype == pil.dtype
    np.testing.assert_array_equal(out, pil)
    np.testing.assert_array_equal(out, jax_decode_png(data))
    if case == "pngio":   # filters 0-2 only; Pillow writes Paeth rows
        np.testing.assert_array_equal(pngio.png_decode_gray(data), pil)


def test_png_decode_rejects_garbage():
    with pytest.raises(ValueError):
        tp.decode_png(b"\x89PNG\r\n\x1a\n" + b"\x00" * 20)


def test_prefetcher_ordered(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(1)
    imgs, paths = [], []
    for i in range(12):
        a = rng.randint(0, 256, (30, 40), np.uint8)
        a[0, 0] = i  # order marker
        p = str(tmp_path / f"img_{i:03d}.png")
        Image.fromarray(a, mode="L").save(p)
        imgs.append(a)
        paths.append(p)
    paths.insert(5, str(tmp_path / "missing.png"))
    got = list(tp.ImagePrefetcher(paths, n_threads=3, window=4))
    assert len(got) == 13 and got[5] is None
    del got[5]
    for a, b in zip(imgs, got):
        np.testing.assert_array_equal(a, b)


def test_pipeline_stages_and_drops():
    def slow_consume(x):
        time.sleep(0.03)
        return x * 10

    pipe = tp.FramePipeline([
        ("ingest", lambda x: x + 1, 2, True),   # fast
        ("solve", slow_consume, 2, True),       # slow -> backpressure
    ]).start()
    for i in range(20):
        pipe.submit(i)
        time.sleep(0.002)
    out = pipe.drain()
    assert sum(pipe.dropped.values()) > 0
    assert len(out) + sum(pipe.dropped.values()) == 20
    assert all(o % 10 == 0 for o in out)
    assert out == sorted(out)
    assert pipe.stats["solve"].mean_ms >= 25.0
    assert pipe._errors == []


def test_pipeline_drain_waits_for_slow_inflight_stage():
    def very_slow(x):
        time.sleep(0.5)
        return x + 100

    pipe = tp.FramePipeline([
        ("fast", lambda x: x, 2, True),
        ("compileish", very_slow, 2, True),
    ]).start()
    pipe.submit(1)
    time.sleep(0.1)  # the item is in flight inside very_slow
    out = pipe.drain(timeout_s=5.0)
    assert out == [101]
    assert sum(pipe.dropped.values()) == 0


def test_pipeline_records_a_failing_stage_and_drops_its_frame():
    def picky(x):
        if x == 2:
            raise RuntimeError("bad frame")
        return x

    pipe = tp.FramePipeline([("only", picky, 8, False)]).start()
    for i in range(4):
        pipe.submit(i)
    out = pipe.drain(timeout_s=5.0)
    assert out == [0, 1, 3]
    assert pipe._errors == [("only", "RuntimeError('bad frame')")]
