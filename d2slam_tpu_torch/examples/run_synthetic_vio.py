"""Run the sliding-window VIO on a synthetic circle flight and report ATE.

Counterpart of ``examples/run_synthetic_vio.py``. Observation-level
pipeline (exact feature measurements from the simulator): IMU at 400 Hz
+ stereo landmark observations at 8 Hz -> ``D2Estimator`` -> trajectory
against ground truth. The solver runs in float64 on the card as on the
CPU (``D2Config.dtype``).

    python -m d2slam_tpu_torch.examples.run_synthetic_vio [--frames 24] [--noisy] [--cpu]
        [--out traj.csv]
"""
import argparse
import json
import sys
import time

import numpy as np

from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.utils.evaluation import ate_rmse, write_trajectory_csv
from d2slam_tpu_torch.utils.sim import CircleSim
from d2slam_tpu_torch.vins.estimator import D2Estimator

# the gate of the JAX script's exit code (m)
ATE_GATE = 0.5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--noisy", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--out", default="", help="write TUM trajectory CSV")
    args = ap.parse_args(argv)

    cfg = D2Config()
    cfg.estimator.max_imu_samples = 128
    sim_kw = {}
    if args.noisy:
        sim_kw = dict(pix_noise_rad=0.5 / 460.0, acc_noise=0.05, gyr_noise=0.004,
                      acc_bias=(0.05, -0.03, 0.02), gyr_bias=(0.002, 0.001, -0.002))
    sim = CircleSim(**sim_kw)
    est = D2Estimator(cfg, sim.ext, device="cpu" if args.cpu else None)
    print(f"device: {est.device}")

    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    stamps, poses, gt_poses = [], [], []
    t_prev = 0.0
    t_start = time.perf_counter()
    for k in range(args.frames):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        od = est.input_frame(sim.frame(k))
        if od is not None:
            stamps.append(t)
            poses.append(od.pose)
            gt_poses.append(sim.gt_pose(t)[0])
    wall = time.perf_counter() - t_start

    rmse, _ = ate_rmse(stamps, np.asarray(poses), stamps, np.asarray(gt_poses))
    ms_per_frame = wall / max(len(stamps), 1) * 1000
    print(f"frames: {len(stamps)}  solves: {est.solve_count}  margins: {est.margin_count}")
    print(f"ATE-RMSE: {rmse * 100:.2f} cm   ({ms_per_frame:.0f} ms/frame incl. host)")
    if args.out:
        write_trajectory_csv(args.out, stamps, poses)
        print(f"trajectory written to {args.out}")
    print(json.dumps(dict(device=str(est.device), frames=len(stamps), solves=est.solve_count,
                          margins=est.margin_count, ate_m=rmse, ms_per_frame=ms_per_frame)))
    return 0 if rmse < ATE_GATE else 1


if __name__ == "__main__":
    sys.exit(main())
