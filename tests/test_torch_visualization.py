"""The port's headless visualization (d2slam_tpu_torch/utils/
visualization.py): the numpy overlays give the JAX package's arrays
exactly; the figures write files; without matplotlib the module still
imports and its figure functions raise ImportError."""
import importlib.util
import sys

import numpy as np
import pytest

from d2slam_tpu.utils import visualization as jv
from d2slam_tpu_torch.utils import visualization as pv


def _traj(n, phase=0.0):
    t = np.linspace(0, 2 * np.pi, n)
    p = np.stack([np.cos(t + phase), np.sin(t + phase), 0.1 * t], 1)
    q = np.tile([0.0, 0, 0, 1], (n, 1))
    return np.concatenate([p, q], axis=1)


def test_track_and_match_overlays_equal_jax():
    rng = np.random.RandomState(1)
    img = rng.rand(120, 160)
    kp = rng.rand(30, 2) * [150, 110] + 5
    kc = kp + rng.randn(30, 2) * 3
    kc[0] = [-20.0, 300.0]   # off the image: clipped line, no disc
    mask = np.ones(30, bool)
    mask[::3] = False
    rgb = pv.draw_feature_tracks(img, kp, kc, mask)
    np.testing.assert_array_equal(rgb, jv.draw_feature_tracks(img, kp, kc, mask))
    assert rgb.shape == (120, 160, 3) and rgb.dtype == np.uint8
    greens = (rgb[..., 1] > 200) & (rgb[..., 0] < 50)
    assert greens.sum() >= mask.sum()
    # uint8 input, 0-255 float input, no mask
    img8 = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(pv.draw_feature_tracks(img8, kp, kc),
                                  jv.draw_feature_tracks(img8, kp, kc))
    np.testing.assert_array_equal(pv.draw_feature_tracks(img * 200, kp, kc),
                                  jv.draw_feature_tracks(img * 200, kp, kc))

    img2 = rng.rand(100, 140)
    canvas = pv.draw_matches(img, img2, kp, kc, mask)
    np.testing.assert_array_equal(canvas, jv.draw_matches(img, img2, kp, kc, mask))
    assert canvas.shape == (120, 300, 3)
    np.testing.assert_array_equal(pv.draw_matches(img8, img2, kp, kc),
                                  jv.draw_matches(img8, img2, kp, kc))


def test_disparity_colormap_equals_jax():
    d = np.linspace(-4, 40, 48 * 64).reshape(48, 64)
    d[0, :4] = [np.nan, 32.0, 0.0, 31.999]
    for max_disp in (32.0, 7.5):
        rgb = pv.disparity_to_rgb(d, max_disp)
        np.testing.assert_array_equal(rgb, jv.disparity_to_rgb(d, max_disp))
    assert rgb.shape == (48, 64, 3) and rgb.dtype == np.uint8
    assert not np.array_equal(rgb[1, 0], rgb[-1, -1])
    np.testing.assert_array_equal(pv.disparity_to_rgb(np.float32(d)),
                                  jv.disparity_to_rgb(np.float32(d)))


def test_trajectory_graph_and_window_plots(tmp_path):
    trajs = {0: _traj(40), 1: _traj(40, 0.8)}
    loops = [(0, 5, 1, 7), (0, 30, 1, 31)]
    files = [tmp_path / n for n in ("traj.png", "graph.png", "win.png")]
    pv.plot_trajectories(trajs, trajs, str(files[0]), loops=loops)
    pv.plot_pose_graph(trajs, loop_edges=loops, path=str(files[1]))
    lms = np.random.RandomState(0).randn(64, 3) * 3
    pv.plot_sliding_window(_traj(11), lms, np.arange(64) % 2 == 0, str(files[2]))
    for f in files:
        assert f.exists() and f.stat().st_size > 5000
        assert f.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_imports_without_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    spec = importlib.util.spec_from_file_location("_vis_no_mpl", pv.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    np.testing.assert_array_equal(mod.disparity_to_rgb(np.arange(12.0).reshape(3, 4)),
                                  pv.disparity_to_rgb(np.arange(12.0).reshape(3, 4)))
    for call in (lambda: mod.plot_trajectories({0: _traj(5)}),
                 lambda: mod.plot_sliding_window(_traj(5)),
                 lambda: mod.plot_pose_graph({0: _traj(5)})):
        with pytest.raises(ImportError, match="matplotlib"):
            call()
