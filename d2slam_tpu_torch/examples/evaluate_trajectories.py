"""Trajectory evaluation report: ATE / RPE tables + plots from CSVs.

Counterpart of ``examples/evaluate_trajectories.py`` (the reference's
data_analysis notebooks, data_analysis/local_plot.py:217-280: relative
and absolute RMSE tables per drone against ground truth). Reads the
TUM-format CSVs the estimator and PGO write
(``utils/evaluation.write_trajectory_csv``) and a ground-truth CSV per
drone; prints a markdown table and, with ``--plot``, draws the
trajectories (that needs matplotlib). Host code only.

    python -m d2slam_tpu_torch.examples.evaluate_trajectories \\
        --est 0=est_d0.csv 1=est_d1.csv --gt 0=gt_d0.csv 1=gt_d1.csv \\
        [--plot out.png] [--rpe-delta 10]
"""
import argparse
import json
import sys

import numpy as np

from d2slam_tpu_torch.utils.evaluation import ate_rmse, read_trajectory_csv, rpe_rmse


def _parse_pairs(items):
    out = {}
    for it in items:
        k, _, v = it.partition("=")
        out[int(k)] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--est", nargs="+", required=True, help="drone_id=trajectory.csv pairs")
    ap.add_argument("--gt", nargs="+", required=True, help="drone_id=groundtruth.csv pairs")
    ap.add_argument("--plot", default="")
    ap.add_argument("--rpe-delta", type=int, default=10)
    args = ap.parse_args(argv)

    est = _parse_pairs(args.est)
    gt = _parse_pairs(args.gt)
    rows = []
    trajs, gts = {}, {}
    for did, path in sorted(est.items()):
        t_e, p_e = read_trajectory_csv(path)
        if did not in gt:
            print(f"drone {did}: no ground truth given, skipping")
            continue
        t_g, p_g = read_trajectory_csv(gt[did])
        ate, per = ate_rmse(t_e, p_e, t_g, p_g)
        rpe = rpe_rmse(t_e, p_e, t_g, p_g, delta=args.rpe_delta)
        length = float(np.sum(np.linalg.norm(np.diff(np.asarray(p_g)[:, :3], axis=0), axis=1)))
        rows.append((did, len(t_e), length, ate, rpe,
                     float(np.max(per)) if len(per) else float("nan")))
        trajs[did] = np.asarray(p_e)
        gts[did] = np.asarray(p_g)

    print("\n| drone | poses | gt length [m] | ATE-RMSE [m] | "
          f"RPE-RMSE(d={args.rpe_delta}) [m] | max err [m] |")
    print("|---|---|---|---|---|---|")
    for did, n, length, ate, rpe, mx in rows:
        print(f"| {did} | {n} | {length:.1f} | {ate:.3f} | {rpe:.3f} | {mx:.3f} |")

    if args.plot and trajs:
        from d2slam_tpu_torch.utils.visualization import plot_trajectories

        plot_trajectories(trajs, gts, path=args.plot, title="estimated vs ground truth")
        print(f"\nplot -> {args.plot}")
    print(json.dumps({"drones": {str(did): dict(poses=n, gt_length_m=length, ate_m=ate,
                                                rpe_m=rpe, max_err_m=mx)
                                 for did, n, length, ate, rpe, mx in rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
