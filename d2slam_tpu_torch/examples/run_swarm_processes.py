"""Multi-process swarm DPGO: one OS process per robot, joined only by
UDP multicast.

Counterpart of ``examples/run_swarm_processes.py`` (the reference's
docker-emulation deployment, README.md:199-215: one container per drone
on LCM multicast udpm://224.0.0.251:7667). Each process runs a
``TransportDPGO`` endpoint exchanging DPGO packets over the port's
native multicast transport. Each robot owns one ring of a multi-ring
pose graph, knows every edge it heard about (remote ego chains and
inter-robot loops), runs chordal rotation init, the ROT_INIT_FINISH
barrier, then ARock rounds with eta_k-relaxed duals. The parent checks
that the robots' solutions agree and improve on the drifted odometry.

The robot processes are started with ``spawn`` (CUDA cannot be forked);
each takes the card unless ``--cpu`` is given.

    python -m d2slam_tpu_torch.examples.run_swarm_processes [--robots 2] [--rounds 12]
        [--port 7677] [--cpu]
"""
import argparse
import json
import multiprocessing as mp
import queue
import sys
import time

import numpy as np

from d2slam_tpu_torch.utils import np_lie

# the JAX test's pins (tests/test_dpgo_transport.py::test_multi_process_swarm)
MAX_DISAGREEMENT_M = 0.15
# seconds the parent waits for all robots
RESULT_TIMEOUT_S = 600.0


def make_graph(n_robots: int, n_per: int, seed: int = 0):
    """Ground truth + noisy edges + drifted init (keys = robot<<40 | k)."""
    def gid(r, k):
        return (r << 40) | k

    rng = np.random.default_rng(seed)
    gt = {}
    for r in range(n_robots):
        for k in range(n_per):
            th = 2 * np.pi * k / n_per
            p = np.array([3 * np.cos(th), 3 * np.sin(th), 0.3 * r])
            yaw = th + np.pi / 2 + 0.3 * r
            q = np.array([0, 0, np.sin(yaw / 2), np.cos(yaw / 2)])
            gt[gid(r, k)] = np.concatenate([p, q])

    def noisy_rel(ka, kb):
        rel = np_lie.pose_compose(np_lie.pose_inverse(gt[ka]), gt[kb])
        d = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)])
        return np_lie.pose_compose(rel, np_lie.pose_exp(d))

    sqrt_info = np.diag([50.0] * 3 + [100.0] * 3)
    ego, loops = [], []
    for r in range(n_robots):
        for k in range(n_per - 1):
            ego.append((gid(r, k), gid(r, k + 1), noisy_rel(gid(r, k), gid(r, k + 1)), sqrt_info))
    for r in range(n_robots - 1):
        for k in range(0, n_per, 2):
            loops.append((gid(r, k), gid(r + 1, k), noisy_rel(gid(r, k), gid(r + 1, k)),
                          sqrt_info))
    init = {gid(r, 0): gt[gid(r, 0)].copy() for r in range(n_robots)}
    for (ka, kb, rel, _) in ego:
        init[kb] = np_lie.pose_compose(
            init[ka], np_lie.pose_compose(rel, np_lie.pose_exp(rng.normal(0, 0.02, 6))))
    return gt, init, ego, loops


def robot_main(robot_id: int, n_robots: int, rounds: int, port: int, cpu: bool, out_q) -> None:
    """One robot process: TransportDPGO over UDP multicast."""
    from d2slam_tpu_torch.comm.transport import UDPMulticastTransport
    from d2slam_tpu_torch.pgo.dpgo_transport import DPGOTransportConfig, TransportDPGO

    _, init, ego, loops = make_graph(n_robots, n_per=8)
    t = UDPMulticastTransport(self_id=robot_id, port=port)
    try:
        cfg = DPGOTransportConfig(max_poses=64, max_edges=128, max_anchors=64,
                                  rho_T=1.0, rho_theta=1.0, iters_per_step=4)
        ep = TransportDPGO(t, robot_id, cfg, device="cpu" if cpu else None)
        ep.set_available_robots(range(n_robots))
        for k, p in init.items():
            ep.add_frame(k, owner=k >> 40, pose=p)
        for (ka, kb, rel, s) in ego + loops:
            ep.add_edge(ka, kb, rel, s)
        t0 = time.perf_counter()
        for it in range(rounds):
            ep.updated = True
            ep.solve(stamp=float(it))
            time.sleep(0.05)  # processes are not lockstep; let peers talk
        wall = time.perf_counter() - t0
        out_q.put((robot_id, str(ep.device), wall,
                   {int(k): ep.optimized_pose(k).tolist() for k in init}))
    finally:
        t.close()


def collect(procs, out_q, n: int, timeout_s: float) -> list:
    """``n`` results from ``out_q``; raises when a process exits without
    one or the time runs out."""
    results = []
    deadline = time.time() + timeout_s
    while len(results) < n:
        try:
            results.append(out_q.get(timeout=1.0))
            continue
        except queue.Empty:
            pass
        dead = [p for p in procs if p.exitcode not in (None, 0)]
        if dead:
            raise RuntimeError(f"process {dead[0].name} exited with code {dead[0].exitcode}")
        if time.time() > deadline:
            raise TimeoutError(f"{len(results)} of {n} results after {timeout_s:.0f} s")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robots", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--port", type=int, default=7677)
    ap.add_argument("--cpu", action="store_true",
                    help="robots on the CPU (default: each on the CUDA card)")
    args = ap.parse_args(argv)

    ctx = mp.get_context("spawn")  # fresh interpreters: CUDA cannot be forked
    out_q = ctx.Queue()
    procs = [ctx.Process(target=robot_main, name=f"robot{r}",
                         args=(r, args.robots, args.rounds, args.port, args.cpu, out_q))
             for r in range(args.robots)]
    for p in procs:
        p.start()
    try:
        got = collect(procs, out_q, args.robots, RESULT_TIMEOUT_S)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    results = {rid: poses for rid, _, _, poses in got}

    gt, init, _, _ = make_graph(args.robots, n_per=8)
    agree, err_gt, err_init = [], [], []
    for k, g in gt.items():
        own = np.asarray(results[k >> 40][k])
        err_gt.append(np.linalg.norm(own[:3] - g[:3]))
        err_init.append(np.linalg.norm(np.asarray(init[k])[:3] - g[:3]))
        for rid, poses in results.items():
            if rid != (k >> 40):
                agree.append(np.linalg.norm(own[:3] - np.asarray(poses[k])[:3]))
    summary = {
        "robots": args.robots,
        "devices": sorted({d for _, d, _, _ in got}),
        "max_disagreement_m": float(np.max(agree)),
        "ate_optimized_m": float(np.sqrt(np.mean(np.square(err_gt)))),
        "ate_odometry_m": float(np.sqrt(np.mean(np.square(err_init)))),
        "s_per_round": max(w for _, _, w, _ in got) / max(args.rounds, 1),
    }
    ok = (summary["max_disagreement_m"] < MAX_DISAGREEMENT_M
          and summary["ate_optimized_m"] < summary["ate_odometry_m"])
    print("multi-process swarm DPGO:", "OK" if ok else "FAILED")
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
