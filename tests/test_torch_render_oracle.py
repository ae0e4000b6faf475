"""The port's copies of the host-side scene tools against the JAX
package: ``TexturedRoom`` renders bit for bit, the ``OracleExtractor``
returns the same keypoints, descriptors and validity (noise draws
included), and it drives the port's tracker through ``extract_fn``."""
import numpy as np
import pytest
import torch

from d2slam_tpu.utils.oracle import OracleExtractor as JOracle
from d2slam_tpu.utils.render import TexturedRoom as JRoom
from d2slam_tpu_torch.frontend.superpoint import SuperPointOutput
from d2slam_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig
from d2slam_tpu_torch.geometry.cameras import PinholeParams
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.oracle import OracleExtractor
from d2slam_tpu_torch.utils.render import TexturedRoom
from d2slam_tpu_torch.utils.sim import CircleSim

torch.set_num_threads(1)  # tests run one process per core (xdist)

H, W, FX = 60, 80, 55.0


@pytest.mark.parametrize("kw", [dict(), dict(gain=1.1, vignette=0.25), dict(gamma=0.8)],
                         ids=["plain", "gain_vignette", "gamma"])
def test_textured_room_renders_bit_equal(kw):
    room, jroom = TexturedRoom(half=14.0, height=7.0, seed=3, tex_res=128), \
        JRoom(half=14.0, height=7.0, seed=3, tex_res=128)
    for tex, jtex in zip(room.textures, jroom.textures):
        np.testing.assert_array_equal(tex, jtex)
    sim = CircleSim(seed=11, baseline=0.2)
    for t in (0.0, 0.7, 2.3):
        T = np_lie.pose_compose(sim.gt_pose(t)[0], sim.ext[1])
        img = room.render(T, FX, FX, W / 2, H / 2, H, W, **kw)
        jimg = jroom.render(T, FX, FX, W / 2, H / 2, H, W, **kw)
        assert img.dtype == np.float32 and img.shape == (H, W) and 0.0 <= img.min()
        np.testing.assert_array_equal(img, jimg)


def test_oracle_matches_jax():
    sim = CircleSim(seed=7, n_landmarks=150)
    kw = dict(max_keypoints=64, desc_dim=32, pix_noise=0.5, seed=4)
    ora = OracleExtractor(sim.lms, sim.ext, 220.0, 220.0, 160.0, 120.0, (240, 320), **kw)
    jora = JOracle(sim.lms, sim.ext, 220.0, 220.0, 160.0, 120.0, (240, 320), **kw)
    with pytest.raises(RuntimeError):
        ora(None, 0)
    for t in (0.0, 0.5):
        pose = sim.gt_pose(t)[0]
        ora.set_pose(pose)
        jora.set_pose(pose)
        for cam in (0, 1):
            out, jout = ora(None, cam), jora(None, cam)
            assert isinstance(out, SuperPointOutput) and out.valid.sum() > 20
            for f in SuperPointOutput._fields:
                np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)))


def test_oracle_drives_the_tracker():
    """As ``extract_fn``, the oracle's stereo views associate every
    landmark seen by both cameras under one id."""
    sim = CircleSim(seed=7, n_landmarks=150)
    ora = OracleExtractor(sim.lms, sim.ext, 220.0, 220.0, 160.0, 120.0, (240, 320))
    cams = [PinholeParams.make(220.0, 220.0, 160.0, 120.0)] * 2
    tracker = FeatureTracker(None, None, cams, TrackerConfig(), extract_fn=ora,
                             extrinsics=sim.ext, device="cpu")
    img = np.zeros((240, 320), np.float32)
    ids = []
    for k in range(2):
        ora.set_pose(sim.gt_pose(k / sim.frame_hz)[0])
        ff = tracker.process_stereo(k / sim.frame_hz, k, img, img)
        if ff is not None:
            ids.append(set(ff.observations[0].landmark_ids.tolist()))
    assert ids and len(ids[0]) > 20
