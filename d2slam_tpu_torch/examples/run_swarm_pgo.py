"""Two-drone swarm demo: keyframe exchange over UDP multicast ->
inter-drone loop edge + map alignment -> joint pose-graph optimization.

Counterpart of ``examples/run_swarm_pgo.py``. Drone B's keyframe goes
over real UDP multicast (the port's native transport); where the host
refuses multicast the run stops with the OS error (no in-process
hand-over). Loop verification and the joint PGO run on the card unless
``--cpu`` is given.

    python -m d2slam_tpu_torch.examples.run_swarm_pgo [--cpu] [--port 17673]
"""
import argparse
import json
import sys

import numpy as np

from d2slam_tpu_torch.comm.codec import RemoteKeyframePacket, decode_keyframe, encode_keyframe
from d2slam_tpu_torch.comm.transport import CH_VIOKF_HEADER, UDPMulticastTransport
from d2slam_tpu_torch.frontend.loop_detector import (
    KeyframeEntry,
    LoopDetector,
    LoopDetectorConfig,
)
from d2slam_tpu_torch.pgo import PGOEdges, PGOLayout, PGOState, solve_pgo
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device
from d2slam_tpu_torch.utils.sim import default_extrinsics
from d2slam_tpu_torch.vins.swarm import SwarmManager

# the JAX script's exit-code gate on drone B's joint-map position (m)
POSITION_GATE = 0.2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--port", type=int, default=17673, help="UDP multicast port")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    print(f"device: {dev}")

    rng = np.random.default_rng(0)
    ext = default_extrinsics()

    # ----- world: landmarks ahead of drone A's first pose -----
    n = 80
    lms = np.concatenate([rng.uniform(6, 14, (n, 1)), rng.uniform(-5, 5, (n, 1)),
                          rng.uniform(0, 4, (n, 1))], axis=1)
    descs = rng.normal(0, 1, (n, 64)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    gdesc = rng.normal(0, 1, 1024).astype(np.float32)
    gdesc /= np.linalg.norm(gdesc)

    # drone B's world frame is offset from A's by yaw + translation
    yaw = 0.5
    A_T_B = np.array([2.0, -1.0, 0.3, 0, 0, np.sin(yaw / 2), np.cos(yaw / 2)])
    det = LoopDetector(LoopDetectorConfig(min_gap_frames=2, min_inliers=20,
                                          min_match_per_dir=10, gdesc_dim=1024),
                       ext, device=dev)
    mgr = SwarmManager(0, det)

    # drone A's keyframe with known landmark positions
    pose_A = np.array([0.0, 0, 0, 0, 0, 0, 1])
    T_cam = np_lie.pose_compose(pose_A, ext[0])
    pc = (lms - T_cam[:3]) @ np_lie.quat_to_rotmat(T_cam[3:])
    rays_A = pc / np.linalg.norm(pc, axis=1, keepdims=True)
    mgr.add_local_keyframe(
        KeyframeEntry(frame_id=0, drone_id=0, stamp=0.0, pose=pose_A, kpt_rays=rays_A,
                      kpt_cam=np.zeros(n, np.int32), kpt_desc=descs,
                      kpt_valid=np.ones(n, bool), lm_positions=lms),
        gdesc, stamp=0.0)

    # ----- drone B broadcasts its keyframe over real UDP multicast -----
    pose_B_inA = np.array([0.6, 0.3, 0.1, 0, 0, np.sin(0.05), np.cos(0.05)])
    pose_B_ego = np_lie.pose_compose(np_lie.pose_inverse(A_T_B), pose_B_inA)
    T_camB = np_lie.pose_compose(pose_B_inA, ext[0])
    pcB = (lms - T_camB[:3]) @ np_lie.quat_to_rotmat(T_camB[3:])
    rays_B = (pcB / np.linalg.norm(pcB, axis=1, keepdims=True)).astype(np.float32)
    descsB = descs + rng.normal(0, 0.03, descs.shape).astype(np.float32)
    descsB /= np.linalg.norm(descsB, axis=1, keepdims=True)
    gB = gdesc + rng.normal(0, 0.005, 1024).astype(np.float32)
    gB /= np.linalg.norm(gB)
    pkt = RemoteKeyframePacket(
        drone_id=1, frame_id=100, stamp=5.0, is_keyframe=True,
        pose=pose_B_ego.astype(np.float32), gdesc=gB,
        lm_ids=np.arange(1000, 1000 + n), lm_cam=np.zeros(n, np.uint8),
        lm_rays=rays_B, lm_vels=np.zeros((n, 3), np.float32), lm_desc=descsB)

    t_b = UDPMulticastTransport(self_id=2, port=args.port)
    t_a = UDPMulticastTransport(self_id=1, port=args.port)
    try:
        t_b.send(CH_VIOKF_HEADER, encode_keyframe(pkt))
        got = t_a.recv(timeout_ms=3000)
    finally:
        t_a.close()
        t_b.close()
    if got is None:
        raise RuntimeError("keyframe lost on the wire")
    payload = got[2]
    print(f"keyframe received over multicast: {len(payload)} bytes (int8 descriptors)")
    edge = mgr.on_remote_keyframe(decode_keyframe(payload))
    if edge is None:
        raise RuntimeError("no inter-drone loop found")
    print(f"inter-drone loop: drones {edge.drone_id_a}->{edge.drone_id_b}, "
          f"{edge.inliers} PnP inliers")
    T = mgr.alignments[1].transform
    yaw_est = float(2 * np.arctan2(T[5], T[6]))
    print(f"map alignment A_T_B: est {np.round(T[:3], 3)} true {A_T_B[:3]}  yaw est "
          f"{yaw_est:.3f} true {yaw:.3f}")

    # ----- joint PGO over both drones' frames + the loop edge -----
    layout = PGOLayout(N=8, E=16, pose_dof=6)
    poses = np.tile([0, 0, 0, 0, 0, 0, 1.0], (layout.N, 1))
    poses[0] = pose_A
    poses[1] = mgr.transform_remote_pose(1, pose_B_ego)  # B in A's frame
    valid = np.zeros(layout.N, bool)
    valid[:2] = True
    ei = np.zeros(layout.E, np.int64)
    ej = np.zeros(layout.E, np.int64)
    ej[0] = 1
    rel = np.tile([0, 0, 0, 0, 0, 0, 1.0], (layout.E, 1))
    rel[0] = edge.rel_pose
    ev = np.zeros(layout.E, bool)
    ev[0] = True
    edges = PGOEdges(i=ei, j=ej, rel=rel, sqrt_info=np.tile(np.eye(6), (layout.E, 1, 1)),
                     valid=ev)
    fixed = np.zeros(layout.N, bool)
    fixed[0] = True
    new_state, rep = solve_pgo(layout, PGOState(poses=poses, valid=valid), edges, fixed,
                               max_iters=5, device=dev)
    print(f"PGO cost {float(rep.initial_cost):.2e} -> {float(rep.final_cost):.2e}")
    err = float(np.linalg.norm(new_state.poses[1].cpu().numpy()[:3] - pose_B_inA[:3]))
    print(f"drone B joint-map position error: {err * 100:.1f} cm")
    print(json.dumps(dict(device=str(dev), payload_bytes=len(payload), inliers=int(edge.inliers),
                          alignment_t=[float(x) for x in T[:3]], alignment_yaw=yaw_est,
                          true_t=A_T_B[:3].tolist(), true_yaw=yaw,
                          pgo_cost=[float(rep.initial_cost), float(rep.final_cost)],
                          position_err_m=err)))
    return 0 if err < POSITION_GATE else 1


if __name__ == "__main__":
    sys.exit(main())
