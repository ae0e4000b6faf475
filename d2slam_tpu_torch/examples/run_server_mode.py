"""SERVER estimation mode across OS processes: N robot processes run VIO
and broadcast keyframe packets (codec v2) over UDP multicast; one
ground-station process (no sensors) ingests every packet and jointly
estimates the whole swarm.

Counterpart of ``examples/run_server_mode.py`` (the reference's
ESTIMATION_MODE SERVER, d2common/include/d2common/d2basetypes.h:38-44;
solve path d2vins/src/estimator/d2estimator.cpp:700-736). The processes
are started with ``spawn`` (CUDA cannot be forked); each takes the card
unless ``--cpu`` is given.

    python -m d2slam_tpu_torch.examples.run_server_mode [--robots 2] [--frames 14]
        [--port 7687] [--cpu]
"""
import argparse
import json
import multiprocessing as mp
import sys
import time

import numpy as np

from d2slam_tpu_torch.examples.run_swarm_processes import collect

SERVER_ID = 99
# the JAX script's gate: server against on-board position (m)
SERVER_VS_ONBOARD_M = 0.5
# the server stops this long after the robots' last packet (s), and
# gives up after SERVER_TIMEOUT_S
QUIET_S, SERVER_TIMEOUT_S = 5.0, 600.0


def _make_system(drone_id, sim, port, cpu, mode="single", max_drones=3, broadcast=True):
    from d2slam_tpu_torch.comm.transport import BufferedTransport, UDPMulticastTransport
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.frontend.loop_detector import LoopDetectorConfig
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig

    cfg = D2Config()
    cfg.estimator.max_sld_win_size = 8
    cfg.estimator.min_solve_frames = 4
    cfg.estimator.max_lm_slots = 128
    cfg.estimator.max_solve_measurements = 512
    cfg.estimator.max_imu_samples = 128
    cfg.estimator.max_solver_iters = 5
    sys_cfg = SystemConfig(drone_id=drone_id, estimation_mode=mode, max_drones=max_drones,
                           assume_common_world=True, broadcast=broadcast,
                           enable_loop_detection=False, enable_pgo=False)
    t = BufferedTransport(UDPMulticastTransport(drone_id, port=port))
    system = D2SLAMSystem(cfg, sys_cfg, sim.ext, cameras=None,
                          extract_fn=lambda img, cam: None, transport=t,
                          loop_cfg=LoopDetectorConfig(desc_dim=8, gdesc_dim=16),
                          device="cpu" if cpu else None)
    return system, t


def robot_main(rid, n_frames, port, cpu, q):
    """One robot: feature-level VIO on its circle, broadcasting keyframes."""
    from d2slam_tpu_torch.utils.sim import CircleSim

    sim = CircleSim(n_landmarks=200, seed=3, phase=0.25 * rid)
    system, transport = _make_system(rid, sim, port, cpu)
    try:
        for (t, a, g) in sim.imu_samples(-0.3, 0.0):
            system.input_imu(t, a, g)
        t_prev = 0.0
        t0 = time.perf_counter()
        for k in range(n_frames):
            t = k / sim.frame_hz
            if k:
                for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                    system.input_imu(ts, a, g)
            t_prev = t
            system.input_frame(sim.frame(k), gdesc=np.zeros(16, np.float32))
        wall = time.perf_counter() - t0
        od = system.odometry
        q.put(("robot", rid, dict(device=str(system.device), ms_per_frame=wall * 1e3 / n_frames,
                                  pose=od.pose.tolist() if od is not None else None)))
    finally:
        transport.close()


def server_main(n_robots, port, cpu, q):
    """The ground station: ingest every packet, solve jointly until the
    robots have gone quiet."""
    from d2slam_tpu_torch.utils.sim import CircleSim

    sim = CircleSim(n_landmarks=200, seed=3)  # geometry only (extrinsics)
    system, transport = _make_system(SERVER_ID, sim, port, cpu, mode="server",
                                     max_drones=n_robots, broadcast=False)
    try:
        deadline = time.time() + SERVER_TIMEOUT_S
        last_pkt = time.time()
        solved_at, solves, solve_s = 0.0, 0, 0.0
        fused = {}
        while time.time() < deadline:
            if system.poll_network(now=time.time(), timeout_ms=200):
                last_pkt = time.time()
                continue  # drain everything queued before solving again
            if solved_at > last_pkt:
                # solved on every packet; stop once the robots have been
                # quiet for QUIET_S of listening (a solve may outlast it)
                if fused and time.time() - max(last_pkt, solved_at) > QUIET_S:
                    break
                continue
            t0 = time.perf_counter()
            fused = system.solve_server()
            solves += 1
            solve_s += time.perf_counter() - t0
            solved_at = time.time()
        window = {}
        for f in system.estimator.frames:
            window.setdefault(f.drone_id, []).append(int(f.frame_id & 0xffffffff))
        print("server window per drone:",
              {d: (len(v), min(v), max(v)) for d, v in window.items()}, flush=True)
        q.put(("server", SERVER_ID, dict(
            device=str(system.device), solves=solves,
            ms_per_solve=solve_s * 1e3 / max(solves, 1),
            poses={str(d): od.pose.tolist() for d, od in fused.items()})))
    finally:
        transport.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robots", type=int, default=2)
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--port", type=int, default=7687)
    ap.add_argument("--cpu", action="store_true",
                    help="all processes on the CPU (default: each on the CUDA card)")
    args = ap.parse_args(argv)

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=server_main, name="server",
                         args=(args.robots, args.port, args.cpu, q))]
    procs[0].start()
    for r in range(args.robots):
        procs.append(ctx.Process(target=robot_main, name=f"robot{r}",
                                 args=(r, args.frames, args.port, args.cpu, q)))
        procs[-1].start()
    try:
        got = collect(procs, q, args.robots + 1, SERVER_TIMEOUT_S)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    results = {(kind, rid): payload for kind, rid, payload in got}

    srv = results[("server", SERVER_ID)]
    print(f"server estimated drones: {sorted(srv['poses'])}")
    ok = True
    diffs = {}
    for r in range(args.robots):
        own = results[("robot", r)]["pose"]
        est = srv["poses"].get(str(r))
        if own is None or est is None:
            print(f"drone {r}: MISSING (own={own is not None}, server={est is not None})")
            ok = False
            continue
        err = float(np.linalg.norm(np.asarray(own[:3]) - np.asarray(est[:3])))
        diffs[str(r)] = err
        print(f"drone {r}: server-vs-onboard position diff {err * 100:.1f} cm")
        ok &= err < SERVER_VS_ONBOARD_M
    print("SERVER-mode swarm:", "OK" if ok else "FAILED")
    print(json.dumps(dict(
        robots=args.robots, devices=sorted({p["device"] for p in results.values()}),
        server_drones=sorted(srv["poses"]), server_vs_onboard_m=diffs,
        server_ms_per_solve=srv["ms_per_solve"],
        robot_ms_per_frame=[results[("robot", r)]["ms_per_frame"] for r in range(args.robots)],
        ok=bool(ok))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
