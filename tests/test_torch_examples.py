"""The port's command-line entry points (d2slam_tpu_torch/examples/) on
the CPU, each through ``main([..., "--cpu"])`` at a small size.

``evaluate_trajectories`` and ``run_swarm_pgo`` run beside the JAX
package's scripts on the same inputs; the other entry points are held
to the pins of their JAX tests, since each library under them was held
to the JAX package in its own parity tests. The two multi-process
entry points run as subprocesses. ``test_every_jax_module_has_a_port``
keeps the list of what is not ported, with the reason for each, whole.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from d2slam_tpu_torch.examples import (
    evaluate_trajectories,
    run_quadcam_depth,
    run_swarm_pgo,
    run_synthetic_vio,
    simulate_dpgo,
    train_frontend,
)
from d2slam_tpu_torch.utils.evaluation import write_trajectory_csv

ROOT = pathlib.Path(__file__).resolve().parents[1]
# UDP ports of this file (no other test uses them)
SWARM_PGO_PORT, PROCESSES_PORT, SERVER_PORT = 17703, 17705, 17707
# seconds a multi-process entry point may take here
SUBPROCESS_TIMEOUT_S = 60

# JAX files whose port lives under another name
RENAMED = {
    "d2slam_tpu/tools/onnx_jax.py": "d2slam_tpu_torch/tools/onnx_torch.py",
    "d2slam_tpu/ops/superpoint_stem_pallas.py": "d2slam_tpu_torch/ops/superpoint_stem.py",
    "d2slam_tpu/ops/stereo_bm_pallas.py": "d2slam_tpu_torch/ops/stereo_bm.py",
    "examples/run_dataset_vio.py": "d2slam_tpu_torch/runtime/dataset_vio.py",
}
# files of the JAX package and around it that have no port, and why
NOT_PORTED = {
    "d2slam_tpu/utils/placement.py": "TPU link packing (PackedAccelFn, f16 download lanes); "
                                     "tensors stay on the card",
    "d2slam_tpu/utils/tpu_profile.py": "TPU profiler; the port uses torch.profiler and CUDA "
                                       "events",
    "d2slam_tpu/utils/compile_cache.py": "XLA compilation cache; the port's native builds are "
                                         "cached in _build/ under a hash",
    "examples/bench_frontend.py": "benchmarks the JAX package; the port's benchmark is its "
                                  "own PR",
    "examples/bench_pgo_scale.py": "benchmarks the JAX package; the port's benchmark is its "
                                   "own PR",
    "bench.py": "benchmarks the JAX package; the port's benchmark is its own PR",
    "tools/profile_host.py": "profiles the JAX runtime's TPU link; torch.profiler and "
                             "chip_smoke.py's CUDA events instead",
    "tools/profile_stages.py": "profiles the JAX runtime's PackedAccelFn stages; "
                               "torch.profiler instead",
    "tools/profile_system.py": "profiles the JAX system's host glue on the TPU; "
                               "torch.profiler instead",
    "__graft_entry__.py": "the TPU multi-chip dry run; chip_smoke.py is the port's",
    "_mosaic_probe.py": "Mosaic lowering probe of the stem; csrc/superpoint_stem.cu",
    "_mosaic_probe2.py": "Mosaic lowering probe of the stem; csrc/superpoint_stem.cu",
    "_probe3.py": "Mosaic lowering probe of the stem; csrc/superpoint_stem.cu",
    "_stem_dbg.py": "debugging script of the Pallas stem; csrc/superpoint_stem.cu",
    "_stem_interp.py": "debugging script of the Pallas stem; csrc/superpoint_stem.cu",
    "_stem_np.py": "debugging script of the Pallas stem; csrc/superpoint_stem.cu",
    "_stem_test.py": "debugging script of the Pallas stem; csrc/superpoint_stem.cu",
}


def _summary(out: str) -> dict:
    """The JSON summary an entry point prints last."""
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def _jax_main(name, argv, monkeypatch):
    """Run examples/<name>.py's ``main()`` in this process with ``argv``."""
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return mod.main()


def _run_module(name, args):
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", f"d2slam_tpu_torch.examples.{name}", *args],
                          capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
                          env=env, cwd=ROOT)


def test_every_jax_module_has_a_port():
    jax_files = sorted(p.relative_to(ROOT).as_posix() for p in [
        *(ROOT / "d2slam_tpu").rglob("*.py"), *(ROOT / "examples").glob("*.py"),
        *(ROOT / "tools").glob("*.py")])
    missing = []
    for f in jax_files:
        if f in NOT_PORTED:
            continue
        port = RENAMED.get(f) or ("d2slam_tpu_torch/" + f.split("/", 1)[1]
                                  if f.startswith("d2slam_tpu/")
                                  else "d2slam_tpu_torch/" + f)
        if not (ROOT / port).exists():
            missing.append(f)
    assert not missing, f"JAX files with neither a port nor a reason in NOT_PORTED: {missing}"
    stale = sorted(f for f in {**NOT_PORTED, **RENAMED} if not (ROOT / f).exists())
    assert not stale, f"entries for files that are gone: {stale}"
    assert all(len(reason) > 20 for reason in NOT_PORTED.values())


@pytest.mark.parametrize("cli, argv", [
    (run_synthetic_vio, []), (run_quadcam_depth, []), (simulate_dpgo, []),
    (run_swarm_pgo, []), (train_frontend, ["--out", "{tmp}"])])
def test_entry_points_default_to_the_card(cli, argv, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([a.format(tmp=tmp_path) for a in argv])


def _write_tracks(tmp_path):
    rng = np.random.default_rng(4)
    est, gt = [], []
    for did in (0, 1):
        t = np.arange(40) * 0.125
        th = 0.5 * t + did
        poses = np.stack([5 * np.cos(th), 5 * np.sin(th), 0.2 * t + did,
                          0 * t, 0 * t, np.sin(th / 2), np.cos(th / 2)], 1)
        noisy = poses.copy()
        noisy[:, :3] += rng.normal(0, 0.05, (40, 3))
        pe, pg = tmp_path / f"est{did}.csv", tmp_path / f"gt{did}.csv"
        write_trajectory_csv(str(pe), t, noisy)
        write_trajectory_csv(str(pg), t, poses)
        est.append(f"{did}={pe}")
        gt.append(f"{did}={pg}")
    return est, gt


def test_evaluate_trajectories_matches_jax(tmp_path, monkeypatch, capsys):
    est, gt = _write_tracks(tmp_path)
    argv = ["--est", *est, "--gt", *gt, "--rpe-delta", "5"]
    assert _jax_main("evaluate_trajectories", argv, monkeypatch) == 0
    ref = capsys.readouterr().out
    assert evaluate_trajectories.main(argv) == 0
    out = capsys.readouterr().out
    table = out[:out.rindex("\n{")]
    assert table.strip() == ref.strip()
    summary = _summary(out)
    assert set(summary["drones"]) == {"0", "1"}
    assert all(0.03 < d["ate_m"] < 0.12 for d in summary["drones"].values())

    plot = tmp_path / "traj.png"
    assert evaluate_trajectories.main(argv + ["--plot", str(plot)]) == 0
    assert plot.stat().st_size > 5000
    # without matplotlib --plot raises, naming it
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        evaluate_trajectories.main(argv + ["--plot", str(tmp_path / "x.png")])


def test_synthetic_vio_then_evaluate(tmp_path, capsys):
    """tests/test_estimator.py's noisy pin (0.15 m) on the CLI's run;
    evaluate_trajectories reads the CSV it wrote."""
    from d2slam_tpu_torch.utils.sim import CircleSim

    csv = tmp_path / "est.csv"
    assert run_synthetic_vio.main(["--cpu", "--frames", "10", "--noisy", "--out", str(csv)]) == 0
    s = _summary(capsys.readouterr().out)
    assert s["device"] == "cpu" and s["frames"] >= 6 and s["solves"] >= 1
    assert s["ate_m"] < 0.15
    # the flight's ground truth at the same stamps
    from d2slam_tpu_torch.utils.evaluation import read_trajectory_csv

    stamps, _ = read_trajectory_csv(str(csv))
    sim = CircleSim()
    write_trajectory_csv(str(tmp_path / "gt.csv"), stamps, [sim.gt_pose(t)[0] for t in stamps])
    assert evaluate_trajectories.main(["--est", f"0={csv}", "--gt",
                                       f"0={tmp_path / 'gt.csv'}"]) == 0
    ev = _summary(capsys.readouterr().out)["drones"]["0"]
    assert ev["poses"] == s["frames"] and abs(ev["ate_m"] - s["ate_m"]) < 1e-4


def test_quadcam_depth_with_trained_hitnet_graph(tmp_path, capsys):
    """The --hitnet route on a 2-channel 240x320 graph the test writes
    with the port's ONNX writer (the reference's trained export is not
    in the repository), the threaded replay, and --save-viz: the PNGs
    decode to disparity_to_rgb of the run's clouds' disparity."""
    from PIL import Image

    from d2slam_tpu_torch.tools.onnx_io import save_onnx
    from tests.test_torch_onnx import _hitnet_graph

    onnx = tmp_path / "hitnet_2ch.onnx"
    save_onnx(_hitnet_graph(240, 320), str(onnx))
    viz = tmp_path / "viz"
    assert run_quadcam_depth.main(["--cpu", "--hitnet", str(onnx), "--save-viz", str(viz)]) == 0
    s = _summary(capsys.readouterr().out)
    assert s["backend"] == "hitnet" and s["frames"] == 1 + run_quadcam_depth.REPLAY_FRAMES_CPU
    assert s["bm_launches"] == 0   # the plain block matcher counts no launch; none ran here
    pngs = sorted(viz.glob("disp_*.png"))
    assert len(pngs) == 4
    for p in pngs:
        rgb = np.asarray(Image.open(p))
        assert rgb.shape == (240, 320, 3) and rgb.dtype == np.uint8


def test_quadcam_depth_block_matching(capsys):
    """tests/test_quadcam.py's wall pin (median depth 3-7.5 m per pair)."""
    assert run_quadcam_depth.main(["--cpu"]) == 0
    s = _summary(capsys.readouterr().out)
    assert s["backend"] == "block_matching" and len(s["pairs"]) == 4
    for p in s["pairs"]:
        assert 3.0 < p["median_depth_m"] < 7.5 and p["valid"] > 0.5


def test_train_frontend_writes_weights_both_packages_read(tmp_path, capsys):
    from d2slam_tpu.frontend.train_frontend import load_weights as jax_load
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.frontend.superpoint import SuperPoint
    from d2slam_tpu_torch.frontend.train_frontend import load_weights
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu_torch.utils.sim import default_extrinsics

    out = tmp_path / "w"
    assert train_frontend.main(["--cpu", "--steps", "2", "--batch", "2", "--skip-netvlad",
                                "--out", str(out)]) == 0
    s = _summary(capsys.readouterr().out)["superpoint"]
    assert np.isfinite(s["first_loss"]) and s["tracks"] > 0
    path = str(out / "superpoint_synth.npz")
    mine, theirs = load_weights(path), jax_load(path)

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            yield from (leaves(v, f"{prefix}{k}/") if isinstance(v, dict)
                        else [(prefix + k, np.asarray(v))])

    assert [k for k, _ in leaves(mine)] == [k for k, _ in leaves(theirs)]
    for (_, a), (_, b) in zip(leaves(mine), leaves(theirs)):
        np.testing.assert_array_equal(a, b)
    # the system built from the file carries those weights
    system = D2SLAMSystem(D2Config(), SystemConfig(superpoint_weights=path),
                          default_extrinsics(), cameras=None, device="cpu")
    ref = SuperPoint(mine, device="cpu")
    for name in ("conv1a_w", "conv2a_w", "convDb_w"):
        assert torch.equal(getattr(system.tracker.model, name), getattr(ref, name))
    # --steps 0 loads the weights it finds
    assert train_frontend.main(["--cpu", "--steps", "0", "--skip-netvlad",
                                "--out", str(out)]) == 0
    assert "loaded existing" in capsys.readouterr().out


def test_simulate_dpgo_converges(capsys):
    assert simulate_dpgo.main(["--cpu", "--robots", "2", "--poses", "16", "--rounds", "12",
                               "--drop-prob", "0.2"]) == 0
    s = _summary(capsys.readouterr().out)
    assert s["ok"] and s["robots"] == 2 and s["cost_final"] < s["cost_init"]


def test_run_swarm_pgo_matches_jax(monkeypatch, capsys):
    assert _jax_main("run_swarm_pgo", ["--cpu"], monkeypatch) == 0
    ref = capsys.readouterr().out
    assert run_swarm_pgo.main(["--cpu", "--port", str(SWARM_PGO_PORT)]) == 0
    out = capsys.readouterr().out
    s = _summary(out)
    for line in ("keyframe received over multicast", "inter-drone loop", "map alignment",
                 "drone B joint-map position error"):
        assert [ln for ln in out.splitlines() if ln.startswith(line)] == [
            ln for ln in ref.splitlines() if ln.startswith(line)]
    assert s["inliers"] == 80 and s["position_err_m"] < run_swarm_pgo.POSITION_GATE
    np.testing.assert_allclose(s["alignment_t"], s["true_t"], atol=1e-3)


def test_run_swarm_processes():
    """tests/test_dpgo_transport.py::test_multi_process_swarm's pins."""
    out = _run_module("run_swarm_processes",
                      ["--rounds", "10", "--port", str(PROCESSES_PORT), "--cpu"])
    assert out.returncode == 0, out.stdout + out.stderr
    s = _summary(out.stdout)
    assert s["devices"] == ["cpu"]
    assert s["max_disagreement_m"] < 0.15
    assert s["ate_optimized_m"] < s["ate_odometry_m"]


def test_run_server_mode():
    out = _run_module("run_server_mode",
                      ["--frames", "8", "--port", str(SERVER_PORT), "--cpu"])
    assert out.returncode == 0, out.stdout + out.stderr
    s = _summary(out.stdout)
    assert s["ok"] and s["server_drones"] == ["0", "1"]
    assert max(s["server_vs_onboard_m"].values()) < 0.5
