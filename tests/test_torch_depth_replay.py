"""The port's threaded quadcam depth replay (``runtime/depth_replay.py``,
after examples/run_quadcam_depth.py's raw / inference / publish
threads) and the uint8 upload of ``depth/quadcam.py`` on the CPU.

Gates, bit for bit: the threaded replay's clouds (points, validity,
texture) equal the serial ``quadcam_depth`` ones frame by frame, in
order; uint8 frames give the same clouds as float32 frames of the same
values (the conversion applies no scaling, as the JAX package's).
"""
import time

import numpy as np
import pytest
import torch

from d2slam_tpu_torch.depth.quadcam import QuadcamConfig, build_virtual_stereo
from d2slam_tpu_torch.geometry.cameras import KBParams
from d2slam_tpu_torch.runtime.depth_replay import DepthReplay, clouds_equal, serial_depth
from d2slam_tpu_torch.utils.render import render_cylinder_wall
from d2slam_tpu_torch.utils.sim import fisheye_ring_extrinsics

torch.set_num_threads(1)  # tests run one process per core (xdist)

HF, WF = 120, 160
TINTS = np.array([[1.0, 0.6, 0.6], [0.6, 1.0, 0.6], [0.6, 0.6, 1.0], [1.0, 1.0, 0.6]])


@pytest.fixture(scope="module")
def rig():
    ext = fisheye_ring_extrinsics(0.3)
    fish = [KBParams.make(47.5, 47.5, WF / 2, HF / 2, k2=0.005) for _ in range(4)]
    cfg = QuadcamConfig(out_hw=(60, 80), min_z=1.0, max_z=20.0, max_disp=16, block=5)
    pairs = build_virtual_stereo(fish, ext, cfg, device="cpu")
    frames = []
    for k in range(5):   # a new wall texture every frame, uint8 as a camera gives it
        imgs = np.stack([render_cylinder_wall(fish[i], ext[i], (HF, WF), 5.0, seed=k)
                         for i in range(4)])
        u8 = np.round(imgs * 255).astype(np.uint8)
        rgb = np.round(imgs[..., None] * TINTS[:, None, None, :] * 255).astype(np.uint8)
        frames.append((u8, rgb))
    return pairs, cfg, frames


def test_threaded_replay_equals_serial(rig):
    pairs, cfg, frames = rig
    serial = serial_depth(frames, pairs, cfg, device="cpu")
    seen = []
    replay = DepthReplay(pairs, cfg, device="cpu")
    out = replay.run(iter(frames), publish=lambda k, clouds: seen.append(k))
    assert seen == list(range(len(frames)))
    assert all(replay.stats[s].count == len(frames) for s in ("raw", "inference", "publish"))
    assert len(out[0]) == 4 and len(out[0][0]) == 3   # 4 pairs of (points, valid, texture)
    assert out[0][0][1].mean() > 0.3                  # the wall is found
    assert clouds_equal(out, serial)
    # frames without texture
    bare = [(imgs, None) for imgs, _ in frames[:2]]
    assert clouds_equal(DepthReplay(pairs, cfg, device="cpu").run(bare),
                        serial_depth(bare, pairs, cfg, device="cpu"))


def test_uint8_upload_equals_float32(rig):
    pairs, cfg, frames = rig
    f32 = [(u8.astype(np.float32), rgb.astype(np.float32)) for u8, rgb in frames[:2]]
    assert clouds_equal(serial_depth(frames[:2], pairs, cfg, device="cpu"),
                        serial_depth(f32, pairs, cfg, device="cpu"))


def test_replay_raises_a_stage_error(rig):
    """A frame the worker cannot process ends the run with its error on
    the caller's thread, not with a hang or a silent drop."""
    pairs, cfg, frames = rig
    bad = [frames[0], (frames[1][0][:2], None)]   # two cameras of four
    with pytest.raises(IndexError):
        DepthReplay(pairs, cfg, device="cpu").run(bad, timeout_s=20.0)


def test_replay_raises_when_a_queue_stays_full(rig):
    """A stage that cannot hand a frame on within the timeout ends the
    run with a TimeoutError: the frame is not dropped."""
    pairs, cfg, frames = rig
    slow = lambda k, clouds: time.sleep(0.4)   # the publisher falls behind
    with pytest.raises(TimeoutError):
        DepthReplay(pairs, cfg, device="cpu").run(frames, publish=slow, timeout_s=0.1)


class _OnCard(torch.Tensor):
    """A tensor that says it lies on the card (there is none here)."""

    @property
    def is_cuda(self):
        return True


def test_replay_refuses_cuda_tensors():
    """Only host objects cross the replay's queues."""
    from d2slam_tpu_torch.runtime.depth_replay import _check_host

    _check_host((0, [np.zeros(2)], None, torch.zeros(2)))   # host objects pass
    on_card = torch.Tensor._make_subclass(_OnCard, torch.zeros(2))
    with pytest.raises(TypeError):
        _check_host((0, [on_card], None))
