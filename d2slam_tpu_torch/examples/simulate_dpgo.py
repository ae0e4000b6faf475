"""Multi-robot distributed-PGO simulation with graph partitioning.

Counterpart of ``examples/simulate_dpgo.py`` (the reference validates
its distributed PGO offline: partition a pose graph across agents, run
ADMM rounds over a simulated network with losses, and track convergence
against the centralized solution; d2pgo/scripts/simulate_bdslam.py,
dpgo_DGS_eval.py, pose_graph_partitioning/). FENNEL / LDG streaming
partitioning (``pgo/partitioning.py``), chordal rotation initialization
per robot (``pgo/rot_init.py``), bulk-synchronous ARock rounds
(``pgo/distributed.py``) with the robots as a batch dimension on one
device, per-round lossy-link dropout through the estimation masks, and a
convergence table (full-graph cost and inter-robot disagreement per
round).

    python -m d2slam_tpu_torch.examples.simulate_dpgo --robots 4 --rounds 12 [--cpu]
    python -m d2slam_tpu_torch.examples.simulate_dpgo --g2o graph.g2o --method ldg
    python -m d2slam_tpu_torch.examples.simulate_dpgo --drop-prob 0.3   # lossy links
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

from d2slam_tpu_torch.geometry.lie import (
    pose_boxminus,
    pose_boxplus,
    pose_compose,
    pose_inverse,
    quat_normalize,
)
from d2slam_tpu_torch.pgo import PGOEdges, PGOLayout, PGOState, read_g2o, solve_pgo
from d2slam_tpu_torch.pgo.distributed import ARockPGOCarry, arock_pgo_round
from d2slam_tpu_torch.pgo.partitioning import (
    partition_stats,
    partition_to_masks,
    stream_partition,
)
from d2slam_tpu_torch.pgo.pose_graph import edge_cost
from d2slam_tpu_torch.pgo.rot_init import chordal_rotation_init
from d2slam_tpu_torch.utils.device import resolve_device


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def synthetic_graph(n_robots: int, n_poses: int, rng: np.random.Generator):
    """The reference's swarm scenario: one circular trajectory per robot
    (stacked in height), odometry chains along each, a loop closure
    within each and loops between adjacent robots at matching angles.
    Returns (gt [n, 7], edges [(i, j)], noisy relative poses [E, 7])."""
    per = max(n_poses // n_robots, 8)
    n = per * n_robots
    gt = np.zeros((n, 7))
    for r in range(n_robots):
        for k in range(per):
            th = 2 * np.pi * k / per
            gt[r * per + k] = [10 * np.cos(th), 10 * np.sin(th), 1.5 * r,
                               0, 0, np.sin(th / 2), np.cos(th / 2)]
    edge_list = []
    for r in range(n_robots):
        base = r * per
        edge_list += [(base + k, base + k + 1) for k in range(per - 1)]
        edge_list.append((base + per - 1, base))  # own loop closure
        if r > 0:
            edge_list += [((r - 1) * per + k, base + k) for k in range(0, per, 4)]
    rels = []
    for i, j in edge_list:
        rel = pose_compose(pose_inverse(_t(gt[i])), _t(gt[j]))
        noise = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)])
        rels.append(pose_boxplus(rel, _t(noise)).numpy())
    return gt, edge_list, np.stack(rels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--g2o", help="g2o pose graph (default: synthetic loop)")
    ap.add_argument("--robots", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--poses", type=int, default=48, help="synthetic graph size")
    ap.add_argument("--method", choices=["fennel", "ldg"], default="fennel")
    ap.add_argument("--est", choices=["full", "boundary"], default="full",
                    help="full: every robot estimates the whole graph (reference semantics); "
                         "boundary: own+boundary poses only (lean duals, slow diffusion)")
    ap.add_argument("--drop-prob", type=float, default=0.0,
                    help="per-robot per-round probability of a lost link")
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--eta", type=float, default=0.9)
    ap.add_argument("--iters", type=int, default=4, help="local LM iters/round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    print(f"device: {dev}")
    rng = np.random.default_rng(args.seed)

    # ---- graph -----------------------------------------------------------
    if args.g2o:
        vertices, g2o_edges = read_g2o(args.g2o)
        ids = sorted(vertices)
        id2k = {v: k for k, v in enumerate(ids)}
        n = len(ids)
        gt_list = np.stack([vertices[v] for v in ids])
        edge_list = [(id2k[i], id2k[j]) for i, j, _, _ in g2o_edges]
        rels = np.stack([r for _, _, r, _ in g2o_edges])
    else:
        gt_list, edge_list, rels = synthetic_graph(args.robots, args.poses, rng)
        n = len(gt_list)

    def pad(x, m=64):
        return -(-x // m) * m

    layout = PGOLayout(N=pad(n), E=pad(len(edge_list)), pose_dof=6)
    E = layout.E
    ei = np.zeros(E, np.int64)
    ej = np.zeros(E, np.int64)
    rel = np.tile([0, 0, 0, 0, 0, 0, 1.0], (E, 1))
    evalid = np.zeros(E, bool)
    for m, (i, j) in enumerate(edge_list):
        ei[m], ej[m], rel[m], evalid[m] = i, j, rels[m], True
    edges = PGOEdges(
        i=torch.as_tensor(ei, device=dev), j=torch.as_tensor(ej, device=dev),
        rel=torch.as_tensor(rel, device=dev),
        sqrt_info=torch.eye(6, dtype=torch.float64, device=dev).expand(E, 6, 6).contiguous(),
        valid=torch.as_tensor(evalid, device=dev))

    valid = np.zeros(layout.N, bool)
    valid[:n] = True
    # drifted init: the odometry chain only
    init = gt_list.copy()
    odo = {(i, j): rels[m] for m, (i, j) in enumerate(edge_list)}
    for k in range(1, n):
        if (k - 1, k) in odo:
            init[k] = pose_compose(_t(init[k - 1]), _t(odo[(k - 1, k)])).numpy()
    init_pad = np.zeros((layout.N, 7))
    init_pad[:, 6] = 1
    init_pad[:n] = init
    valid_t = torch.as_tensor(valid, device=dev)
    state0 = PGOState(poses=torch.as_tensor(init_pad, device=dev), valid=valid_t)
    fixed = torch.zeros(layout.N, dtype=torch.bool, device=dev)
    fixed[0] = True

    # ---- partition -------------------------------------------------------
    K = args.robots
    parts = stream_partition(n, edge_list, K, method=args.method)
    stats = partition_stats(parts, edge_list, K)
    print(f"partition[{args.method}] k={K}: sizes={stats['sizes']} "
          f"cut={stats['edge_cut']}/{len(edge_list)} "
          f"imbalance={stats['imbalance']:.2f} comm={stats['comm_volume']}")
    eidx = np.stack([ei[:len(edge_list)], ej[:len(edge_list)]], 1)
    est, own, edge_mask = partition_to_masks(parts, eidx, layout.N, K, est_mode=args.est)
    emask_pad = np.zeros((K, E), bool)
    emask_pad[:, :len(edge_list)] = edge_mask

    # ---- centralized reference -------------------------------------------
    t0 = time.perf_counter()
    central, rep = solve_pgo(layout, state0, edges, fixed, max_iters=16, device=dev)
    t_central = time.perf_counter() - t0

    def full_cost(poses):
        st = PGOState(poses=torch.as_tensor(poses, device=dev), valid=valid_t)
        return float(edge_cost(st, edges, 6, 0.5))

    c_init, c_central = full_cost(init_pad), full_cost(central.poses)
    print(f"cost: init {c_init:.4f} -> centralized {c_central:.4f} "
          f"({int(rep.accepted)} accepted steps, {t_central * 1e3:.0f} ms)")

    # ---- distributed rounds ----------------------------------------------
    est_t = torch.as_tensor(est, device=dev)
    own_t = torch.as_tensor(own, device=dev)
    emask_t = torch.as_tensor(emask_pad, device=dev)
    # per-robot chordal rotation init on its known subgraph, one batch
    act = edges.valid[None] & est_t[:, edges.i] & est_t[:, edges.j]
    rot_poses = chordal_rotation_init(
        state0.poses[None].expand(K, -1, -1), valid_t[None].expand(K, -1), edges.i, edges.j,
        quat_normalize(edges.rel[:, 3:]), act, fixed[None].expand(K, -1))
    carry = ARockPGOCarry(state=PGOState(poses=rot_poses, valid=valid_t[None].expand(K, -1)),
                          tilde=torch.zeros((K, layout.N, 6), dtype=torch.float64, device=dev))
    print(f"{'round':>5} {'cost(stitched)':>15} {'vs central':>11} "
          f"{'dev(central)':>13} {'disagreement':>13} {'active':>8}")
    cen = central.poses[valid_t]
    t0 = time.perf_counter()
    c = dev_c = c_init
    for rd in range(args.rounds):
        active = rng.random(K) >= args.drop_prob
        if not active.any():
            active[rng.integers(K)] = True
        # a dropped robot shares nothing this round (timeout semantics:
        # excluded from averaging, keeps stale duals, solves locally)
        est_rd = torch.as_tensor(np.where(active[:, None], est, own), device=dev)
        carry, _ = arock_pgo_round(layout, carry, edges, est_mask=est_rd, own_mask=own_t,
                                   fixed_mask=fixed, edge_mask=emask_t, eta=args.eta,
                                   rho=args.rho, max_iters=args.iters)
        poses = carry.state.poses
        stitched = torch.as_tensor(init_pad, device=dev).clone()
        for r in range(K):
            stitched[own_t[r]] = poses[r][own_t[r]]
        c = full_cost(stitched)
        dev_c = float(torch.abs(pose_boxminus(stitched[valid_t], cen)).max())
        dis = 0.0
        for r in range(1, K):
            sharers = est_t[0] & est_t[r] & valid_t
            if bool(sharers.any()):
                d = pose_boxminus(poses[r][sharers], poses[0][sharers])
                dis = max(dis, float(torch.abs(d).max()))
        print(f"{rd:5d} {c:15.4f} {c / max(c_central, 1e-12):11.3f} "
              f"{dev_c:13.2e} {dis:13.2e} {int(active.sum()):>4d}/{K}")
    t_rounds = time.perf_counter() - t0

    # ADMM's cost tail converges slowly (the reference runs one step per
    # 0.5 s solver tick and never waits for the tail): accept when >= 95 %
    # of the init -> centralized cost gap is closed or the poses track the
    # centralized optimum
    gap_closed = (c_init - c) / max(c_init - c_central, 1e-12)
    ok = gap_closed >= 0.95 or dev_c < 0.25 or c < 2.0 * c_central + 1e-3
    print(f"distributed: {args.rounds} rounds in {t_rounds * 1e3:.0f} ms -> final cost "
          f"{c:.4f} ({100 * gap_closed:.1f}% of cost gap closed), max pose dev vs "
          f"centralized {dev_c:.3f} ({'OK' if ok else 'NOT CONVERGED'})")
    print(json.dumps(dict(device=str(dev), robots=K, poses=n, edges=len(edge_list),
                          rounds=args.rounds, cost_init=c_init, cost_central=c_central,
                          cost_final=c, gap_closed=gap_closed, max_dev_central=dev_c,
                          ms_per_round=t_rounds * 1e3 / max(args.rounds, 1), ok=bool(ok))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
