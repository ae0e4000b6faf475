"""The yardstick's copies of the kernels' work counts equal the port's
at every shape the cells run."""
import pytest

from d2slam_tpu_torch.ops import stereo_bm, superpoint_stem
from portbench.yardstick import work


@pytest.mark.parametrize("B,H,W", [(2, 480, 752), (4, 240, 320), (2, 120, 160)])
def test_stem_counts_equal_the_ports(B, H, W):
    assert work.stem_flops(B, H, W) == superpoint_stem.stem_flops(B, H, W)
    assert work.stem_bytes(B, H, W) == superpoint_stem.stem_bytes(B, H, W)


@pytest.mark.parametrize("N,H,W,D,block", [(4, 240, 320, 64, 9), (4, 48, 64, 16, 9)])
def test_bm_counts_equal_the_ports(N, H, W, D, block):
    assert work.bm_ops(N, H, W, D, block) == stereo_bm.bm_ops(N, H, W, D, block)
    assert work.bm_bytes(N, H, W) == stereo_bm.bm_bytes(N, H, W)


def test_least_times():
    # the stem at 2x480x752 is bound by bf16 operations: 54.1 GFLOP
    assert work.stem_min_s(2, 480, 752) == pytest.approx(54.1e9 / 989e12, rel=1e-3)
    # a frame's disparity: two passes over 4 pairs, bound by operations
    assert work.disparity_min_s(4, 240, 320, 64, 9) == pytest.approx(
        2 * work.bm_ops(4, 240, 320, 64, 9) / 33.5e12)


def test_network_counts():
    # the stem is the encoder's first two convolutions
    full = work.superpoint_flops(2, 480, 752)
    assert work.stem_flops(2, 480, 752) < full < 3 * work.stem_flops(2, 480, 752)
    # NetVLAD at the repository's widths: a MobileNet-sized fraction of SuperPoint
    nv = work.netvlad_flops(480, 752, (64, 128, 256, 128, 128), 32, (4096, 1024))
    assert 0 < nv < full / 10


def test_step_share_arithmetic():
    from types import SimpleNamespace

    from portbench import harness

    run = SimpleNamespace(trace=SimpleNamespace(frames=10, window_s=5.0),
                          stats={"frame_work_s": 1e-3})
    assert harness.reader("step_mfu.explore").read(run) == pytest.approx(100 * 10 * 1e-3 / 5.0)
    run.trace = None
    assert harness.reader("step_mfu.explore").read(run) is None
