"""The port's two-robot swarm against the JAX package's, on the CPU.

* The feature-level scenario of tests/test_system.py::
  test_two_robot_swarm_loop_and_alignment (two CircleSims, seed 3, phases
  0 and 0.25, oracle features, bag-of-landmark global descriptors, a
  ``LocalBus``, 18 frames each, greedy broadcast) runs once per package
  (a module fixture, neither package patched). Held: the same keyframe
  packets on the bus (ids, cameras, rays, velocities, int8 descriptors
  and IMU blocks byte for byte; poses and landmark positions within
  ``TRAJ_TOL``), each package decoding the other's bytes; the same loop
  edges (frame pairs, drones, inliers) in both robots; A's alignment of B
  within 5 mm and 1e-3 rad; the same pose-graph inputs (nodes, ego edges)
  and both robots' graphs within ``TRAJ_TOL`` = 5 mm (the tolerance of
  tests/test_torch_system.py), every solve of them; B merged into A's
  reference frame with its window within ``TRAJ_TOL``; and the JAX
  test's pin (B's joint trajectory within 1.0 m RMSE of the truth).
* B merges into A's world between two of its keyframes, and A's graph
  chains B's last node in its old world to its first in the new one with
  an ego edge that holds the merge's jump, in both packages (ROADMAP
  Queue 3).
* Port-only mirrors of tests/test_system.py::
  test_lazy_broadcast_pull_and_nearby_escalation and tests/test_loopnet.py::
  test_move_all_poses_map_merge, with the JAX tests' pins, the
  reference-frame merge under the PGO worker (a solve in flight is
  dropped) and ``send_img``'s image ring.
"""
import numpy as np
import pytest
import torch

import tests.test_system as TS
from tests.test_torch_system import TRAJ_TOL, _modules, small_config

torch.set_num_threads(1)  # tests run one process per core (xdist)

N_FRAMES = 18
ALIGN_POS_TOL, ALIGN_ROT_TOL = 0.005, 1e-3   # m, rad


def _bus(port: bool):
    if port:
        from d2slam_tpu_torch.comm.transport import LocalBus
    else:
        from d2slam_tpu.comm.transport import LocalBus
    return LocalBus()


def make_system(port: bool, drone_id: int, sim, transport, **sys_kw):
    """tests/test_system.py::make_system in either package."""
    D2Config, _, LoopDetectorConfig, D2SLAMSystem, SystemConfig, _ = _modules(port)
    kw = dict(pgo_every_n_kf=6, pgo_max_poses=64, pgo_max_edges=128, pgo_iters=6)
    kw.update(sys_kw)
    loop_cfg = LoopDetectorConfig(desc_dim=TS.DESC_DIM, gdesc_dim=TS.GDESC_DIM, netvlad_thres=0.5,
                                  min_match_per_dir=10, min_inliers=12, min_gap_frames=6)
    return D2SLAMSystem(small_config(D2Config), SystemConfig(drone_id=drone_id, **kw), sim.ext,
                        cameras=None, extract_fn=lambda img, cam: None, transport=transport,
                        loop_cfg=loop_cfg, **(dict(device="cpu") if port else {}))


def feed_frame(s, sim, k, t_prev, KeyframeEntry):
    """IMU since ``t_prev`` and feature frame ``k`` with its cam0 entry."""
    t = k / sim.frame_hz
    if k > 0:
        for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
            s.input_imu(ts, a, g)
    ff = sim.frame(k)
    pose = s.odometry.pose if s.odometry is not None else np.eye(1, 7, 6)[0]
    ids = np.asarray(ff.observations[0].landmark_ids, int)
    entry = KeyframeEntry(
        frame_id=ff.frame_id, drone_id=s.drone_id, stamp=ff.stamp,
        pose=np.asarray(pose, np.float64), kpt_rays=np.asarray(ff.observations[0].rays, np.float64),
        kpt_cam=np.zeros(len(ids), np.int32), kpt_desc=TS.DESC_TABLE[ids],
        kpt_valid=np.ones(len(ids), bool), lm_positions=np.full((len(ids), 3), np.nan))
    s.input_frame(ff, gdesc=TS.bag_gdesc(ids), kf_entry=entry)
    return t


def run_two_robots(port: bool, n_frames: int = N_FRAMES, **sys_kw):
    """Two robots on one bus, frame by frame, each polling after every
    frame. Returns the systems, the sims, what each robot sent (sender,
    channel, bytes) in order, and each system's PGO solves (graph size,
    optimized poses) in order."""
    _, KeyframeEntry, _, _, _, CircleSim = _modules(port)
    bus = _bus(port)
    sims = [CircleSim(n_landmarks=TS.N_LM, seed=3, phase=0.0),
            CircleSim(n_landmarks=TS.N_LM, seed=3, phase=0.25)]
    sent = []
    systems, solves = [], []
    for i, sim in enumerate(sims):
        ep = bus.endpoint(i)
        send = ep.send

        def recording_send(ch, data, i=i, send=send):
            sent.append((i, ch, bytes(data)))
            send(ch, data)

        ep.send = recording_send
        s = make_system(port, i, sim, ep, **sys_kw)
        log = []

        def recording_solve(solve=s.solve_pgo, log=log):
            out = solve()
            if out is not None:
                log.append((len(out), np.array(out, np.float64)))
            return out

        s.solve_pgo = recording_solve
        systems.append(s)
        solves.append(log)
    for s, sim in zip(systems, sims):
        for (t, a, g) in sim.imu_samples(-0.3, 0.0):
            s.input_imu(t, a, g)
    t_prev = 0.0
    for k in range(n_frames):
        for s, sim in zip(systems, sims):
            t = feed_frame(s, sim, k, t_prev, KeyframeEntry)
        t_prev = t
        for s in systems:
            s.poll_network(now=t)
    systems[0].solve_pgo()
    return systems, sims, sent, solves


@pytest.fixture(scope="module")
def swarm_runs():
    return run_two_robots(False), run_two_robots(True)


def _loop_table(system):
    return [(e.drone_id_a, e.frame_id_a, e.drone_id_b, e.frame_id_b, e.inliers)
            for e in system.loop_edges]


def test_swarm_same_packets_and_cross_decode(swarm_runs):
    from d2slam_tpu.comm import codec as jc
    from d2slam_tpu_torch.comm import codec as pc

    (_, _, sent_j, _), (_, _, sent_p, _) = swarm_runs
    assert [(i, ch) for i, ch, _ in sent_p] == [(i, ch) for i, ch, _ in sent_j]
    n_kf = 0
    for (_, ch, bj), (_, _, bp) in zip(sent_j, sent_p):
        if ch != 2:        # CH_VIOKF_LANDMARKS; loop edges are held below
            continue
        n_kf += 1
        kj, kp = jc.decode_keyframe(bj), jc.decode_keyframe(bp)
        assert kp is not None and pc.decode_keyframe(bj) is not None
        # each package re-encodes the other's decoded packet to its bytes
        assert pc.encode_keyframe(pc.decode_keyframe(bj)) == jc.encode_keyframe(kj)
        assert jc.encode_keyframe(kp) == pc.encode_keyframe(pc.decode_keyframe(bp))
        for f in ("drone_id", "frame_id", "stamp", "is_keyframe", "ref_frame_id"):
            assert getattr(kp, f) == getattr(kj, f), f
        for f in ("lm_ids", "lm_cam", "lm_rays", "lm_vels", "lm_desc", "gdesc", "imu_t",
                  "imu_acc", "imu_gyr", "sld_win"):
            np.testing.assert_array_equal(getattr(kp, f), getattr(kj, f), err_msg=f)
        np.testing.assert_allclose(kp.pose[:3], kj.pose[:3], atol=TRAJ_TOL)
        np.testing.assert_allclose(kp.lm_pos3d, kj.lm_pos3d, atol=TRAJ_TOL)
    assert n_kf >= 2 * 12


def test_stereo_keyframe_packet_records_equal_jax(swarm_runs):
    """A keyframe packet that the system builds from a stereo frame's own
    entry (each landmark once per view that sees it): the same records as
    the JAX package's, and the same codec bytes once the fields read from
    the estimator (landmark positions within ``TRAJ_TOL``, biases,
    velocity) are taken from the JAX packet."""
    from d2slam_tpu.comm import codec as jc
    from d2slam_tpu_torch.comm import codec as pc

    (sj, sims_j, _, _), (sp, _, _, _) = swarm_runs
    a, b = sj[0], sp[0]
    ff = sims_j[0].frame(N_FRAMES - 1)
    assert len(ff.observations) == 2
    ids = np.unique(np.concatenate([o.landmark_ids for o in ff.observations]))
    shared = np.intersect1d(ff.observations[0].landmark_ids, ff.observations[1].landmark_ids)
    assert len(shared) >= 10
    desc = TS.DESC_TABLE[ids].astype(np.float32)
    pose = np.asarray(a.odometry.pose, np.float64)
    gdesc = TS.bag_gdesc(ids)
    pkts = []
    for s, d in ((a, desc), (b, torch.as_tensor(desc))):
        saved = s.tracker.last_kf, s._last_bcast_t
        s.tracker.last_kf = dict(ids=ids, desc=d, valid=np.ones(len(ids), bool))
        try:
            pkts.append(s._make_packet(ff, pose, gdesc, None))
        finally:
            s.tracker.last_kf, s._last_bcast_t = saved
    kj, kp = pkts
    n_obs = sum(len(o.landmark_ids) for o in ff.observations)
    assert len(kp.lm_ids) == len(kj.lm_ids) == n_obs
    for f in ("lm_ids", "lm_cam", "lm_rays", "lm_vels", "lm_desc", "gdesc", "sld_win"):
        np.testing.assert_array_equal(getattr(kp, f), getattr(kj, f), err_msg=f)
    np.testing.assert_allclose(kp.lm_pos3d, kj.lm_pos3d, atol=TRAJ_TOL)
    est = dict(lm_pos3d=kj.lm_pos3d, ba=kj.ba, bg=kj.bg, vel=kj.vel)
    assert pc.encode_keyframe(kp._replace(**est)) == jc.encode_keyframe(kj)


def test_swarm_same_loops_and_alignment(swarm_runs):
    (sj, _, _, _), (sp, _, _, _) = swarm_runs
    for a, b in zip(sj, sp):
        assert _loop_table(b) == _loop_table(a)
        for ej, ep in zip(a.loop_edges, b.loop_edges):
            np.testing.assert_allclose(ep.rel_pose[:3], ej.rel_pose[:3], atol=TRAJ_TOL)
    inter = [e for e in sp[0].loop_edges if e.drone_id_a != e.drone_id_b]
    assert inter, "no inter-drone loop edges"
    assert set(sp[0].swarm.alignments) == set(sj[0].swarm.alignments) == {1}
    Tj, Tp = sj[0].swarm.alignments[1].transform, sp[0].swarm.alignments[1].transform
    assert np.abs(Tp[:3] - Tj[:3]).max() < ALIGN_POS_TOL
    yaw = [2 * np.arctan2(T[5], T[6]) for T in (Tj, Tp)]
    assert abs(np.angle(np.exp(1j * (yaw[1] - yaw[0])))) < ALIGN_ROT_TOL


def test_swarm_joint_graph_matches_jax(swarm_runs):
    """Both robots' pose graphs, every solve of them, agree with the JAX
    package's."""
    (sj, _, _, solves_j), (sp, sims, _, solves_p) = swarm_runs
    for a, b, lj, lp in zip(sj, sp, solves_j, solves_p):
        assert b.pgo_solve_count == a.pgo_solve_count >= 1
        assert [m[:2] for m in b._pgo_meta] == [m[:2] for m in a._pgo_meta]
        assert len(lp) == len(lj) >= 2
        for (nj, oj), (np_, op) in zip(lj, lp):
            assert nj == np_ and np.abs(op[:, :3] - oj[:, :3]).max() < TRAJ_TOL
        for did in (0, 1):
            st_j, opt_j = a.trajectory(drone_id=did)
            st_p, opt_p = b.trajectory(drone_id=did)
            np.testing.assert_allclose(st_p, st_j)
            assert np.abs(opt_p[:, :3] - opt_j[:, :3]).max() < TRAJ_TOL
    # the JAX test's pin: B's trajectory in A's joint graph, aligned on
    # A's first keyframe, against B's ground truth
    from d2slam_tpu_torch.utils import np_lie

    sys_a = sp[0]
    stamps_a, ego_a = sys_a.trajectory(drone_id=0, optimized=False)
    T_align = np_lie.pose_compose(sims[0].gt_pose(stamps_a[0])[0], np_lie.pose_inverse(ego_a[0]))
    stamps_b, opt_b = sys_a.trajectory(drone_id=1)
    assert len(stamps_b) >= 8
    errs = [np.linalg.norm(np_lie.pose_compose(T_align, p)[:3] - sims[1].gt_pose(t)[0][:3])
            for t, p in zip(stamps_b, opt_b)]
    assert np.sqrt(np.mean(np.square(errs))) < 1.0


def test_swarm_reference_frame_merge_matches_jax(swarm_runs):
    """B aligns A's map and merges into A's (lower) reference frame: its
    window, prior and pose graph move with it."""
    (sj, _, _, _), (sp, _, _, _) = swarm_runs
    assert sp[1].ref_frame_id == sj[1].ref_frame_id == 0
    assert sp[0].ref_frame_id == sj[0].ref_frame_id == 0
    pj = np.asarray(sj[1].estimator.state.poses)
    pp = sp[1].estimator.state.poses.numpy()
    n = len(sp[1].estimator.frames)
    assert n == len(sj[1].estimator.frames) >= 4
    assert np.abs(pp[:n, :3] - pj[:n, :3]).max() < TRAJ_TOL
    np.testing.assert_allclose(sp[1].odometry.pose[:3], sj[1].odometry.pose[:3], atol=TRAJ_TOL)


def test_swarm_merge_chains_two_worlds_as_jax(swarm_runs):
    """A's graph inputs equal the JAX package's: the stored ego poses and
    the ego edges, among them the one from B's last keyframe before its
    merge to its first after it, which holds the merge's jump (more than a
    metre against B's true motion, ROADMAP Queue 3)."""
    from d2slam_tpu_torch.comm import codec
    from d2slam_tpu_torch.utils import np_lie

    (sj, _, sent_j, _), (sp, sims, _, _) = swarm_runs
    for a, b in zip(sj, sp):
        for mj, mp in zip(a._pgo_meta, b._pgo_meta):
            np.testing.assert_allclose(mp[3][:3], mj[3][:3], atol=TRAJ_TOL)
        assert [e[:2] for e in b._ego_edges] == [e[:2] for e in a._ego_edges]
        for (_, _, rj, _), (_, _, rp, _) in zip(a._ego_edges, b._ego_edges):
            np.testing.assert_allclose(rp[:3], rj[:3], atol=TRAJ_TOL)
    # B's first keyframe sent in A's reference frame, and its edge in A's graph
    fid = next(k.frame_id for i, ch, buf in sent_j if i == 1 and ch == 2
               for k in [codec.decode_keyframe(buf)] if k.ref_frame_id == 0)
    a_p = sp[0]
    j = a_p._pgo_slot[(1, fid)]
    (i, _, rel, _), = [e for e in a_p._ego_edges if e[1] == j]
    gt = np_lie.pose_compose(np_lie.pose_inverse(sims[1].gt_pose(a_p._pgo_meta[i][2])[0]),
                             sims[1].gt_pose(a_p._pgo_meta[j][2])[0])
    assert np.linalg.norm(rel[:3] - gt[:3]) > 1.0


def test_lazy_broadcast_pull_and_nearby_escalation():
    """tests/test_system.py::test_lazy_broadcast_pull_and_nearby_escalation
    on the port, with its pins: far drones exchange headers, a header that
    hits the receiver's retrieval gate pulls the full frame (and that
    gives inter-drone loops), drones the pose graph puts near get full
    frames directly."""
    from d2slam_tpu_torch.comm.transport import CH_VIOKF_HEADER, CH_VIOKF_LANDMARKS, LocalBus
    from d2slam_tpu_torch.frontend.loop_detector import KeyframeEntry
    from d2slam_tpu_torch.utils.sim import CircleSim

    bus = LocalBus()
    sims = [CircleSim(n_landmarks=TS.N_LM, seed=3, phase=0.0),
            CircleSim(n_landmarks=TS.N_LM, seed=3, phase=0.25)]
    ta, tb = bus.endpoint(0), bus.endpoint(1)
    sent_by_channel = {}
    orig_send = ta.send

    def counting_send(ch, data):
        sent_by_channel[ch] = sent_by_channel.get(ch, 0) + 1
        orig_send(ch, data)

    ta.send = counting_send
    systems = [make_system(True, i, sim, t, lazy_broadcast=True, nearby_distance=0.0)
               for i, (sim, t) in enumerate(zip(sims, (ta, tb)))]
    for s, sim in zip(systems, sims):
        for (t, a, g) in sim.imu_samples(-0.3, 0.0):
            s.input_imu(t, a, g)
    t_prev = 0.0
    for k in range(14):
        for s, sim in zip(systems, sims):
            t = feed_frame(s, sim, k, t_prev, KeyframeEntry)
        t_prev = t
        for s in systems:
            s.poll_network(now=t)
    n_headers = sent_by_channel.get(CH_VIOKF_HEADER, 0)
    n_full_phase1 = sent_by_channel.get(CH_VIOKF_LANDMARKS, 0)
    assert n_headers >= 8, f"lazy mode sent {n_headers} headers"
    assert n_full_phase1 >= 1, "place-recognition pull never fired"
    assert n_full_phase1 < n_headers, "lazy mode degenerated to greedy"
    sys_a, sys_b = systems
    assert [e for e in sys_b.loop_edges if e.drone_id_a != e.drone_id_b], \
        "no inter-drone loop through the lazy pull path"

    sys_a.sys.nearby_distance = 1e6
    assert 1 in sys_a.nearby_drones(t_prev), "nearby gate did not fire"
    before = sent_by_channel.get(CH_VIOKF_LANDMARKS, 0)
    for k in range(14, 18):
        t_prev = feed_frame(sys_a, sims[0], k, t_prev, KeyframeEntry)
    gained = sent_by_channel.get(CH_VIOKF_LANDMARKS, 0) - before
    assert gained >= 3, f"nearby escalation sent only {gained} full frames"


def test_move_all_poses_map_merge():
    """tests/test_loopnet.py::test_move_all_poses_map_merge on the port: a
    yaw and translation shift of the whole window, the device-resident
    prior included, leaves the estimator tracking the shifted trajectory
    (the pins: every slot moved within 1e-9 m, drift after the merge
    below 0.05 m)."""
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.utils import np_lie
    from d2slam_tpu_torch.utils.sim import CircleSim
    from d2slam_tpu_torch.vins.estimator import D2Estimator

    # tests/test_estimator.py::run_sequence(n_frames=12) on the port
    sim = CircleSim()
    est = D2Estimator(small_config(D2Config), sim.ext, device="cpu")
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    errs, t_prev = [], 0.0
    for k in range(12):
        t = k / sim.frame_hz
        if k > 0:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        odom = est.input_frame(sim.frame(k))
        if odom is not None:
            errs.append((np.asarray(odom.pose), sim.gt_pose(t)[0]))
    assert est._prior is not None
    yaw = np.deg2rad(30.0)
    T = np.array([1.0, -2.0, 0.5, 0, 0, np.sin(yaw / 2), np.cos(yaw / 2)])
    before = est.state.poses.numpy().copy()
    n = len(est.frames)
    est.move_all_poses(T)
    after = est.state.poses.numpy()
    for w in range(n):
        expect = np_lie.pose_compose(T, before[w])
        assert np.linalg.norm(after[w][:3] - expect[:3]) < 1e-9, f"slot {w} moved wrong"
    t_prev = 11 / sim.frame_hz
    for k in range(12, 18):
        t = k / sim.frame_hz
        for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
            est.input_imu(ts, a, g)
        t_prev = t
        odom = est.input_frame(sim.frame(k))
    est0, gt0 = errs[0]
    G = np_lie.pose_compose(est0.astype(np.float64), np_lie.pose_inverse(gt0.astype(np.float64)))
    expect = np_lie.pose_compose(T, np_lie.pose_compose(G, sim.gt_pose(t)[0]))
    assert np.linalg.norm(odom.pose[:3] - expect[:3]) < 0.05


def test_merge_under_pgo_worker_drops_solve_in_flight(monkeypatch):
    """A reference-frame merge that lands while the PGO worker solves
    bumps the epoch: the solve's result, expressed in the old world, is
    dropped, and the pose table holds the merged poses."""
    import d2slam_tpu_torch.runtime.system as S
    from d2slam_tpu_torch.utils import np_lie
    from tests.test_torch_system import run_feature_level

    system = run_feature_level(True, n_frames=10, pgo_solver="dense", pgo_async=True)
    system.wait_pgo()
    n = len(system._pgo_meta)
    before = system._pgo_poses[:n].copy()
    yaw = np.deg2rad(20.0)
    T = np.array([0.5, 1.0, 0.0, 0, 0, np.sin(yaw / 2), np.cos(yaw / 2)])
    solve = S.solve_pgo

    def solve_then_merge(*a, **k):
        out = solve(*a, **k)
        system._merge_reference_frame(0, T)   # as a peer's packet would, mid-solve
        return out

    monkeypatch.setattr(S, "solve_pgo", solve_then_merge)
    count = system.pgo_solve_count
    system._solve_pgo_background()
    system.close()
    assert system.pgo_solve_count == count + 1
    expect = np.stack([np_lie.pose_compose(T, p) for p in before])
    np.testing.assert_allclose(system._pgo_poses[:n], expect, atol=1e-12)
    _, ego = system.trajectory(optimized=False)
    np.testing.assert_allclose(ego[0][:3], expect[0][:3], atol=1e-9)


def test_send_img_fills_the_peers_image_ring():
    """send_img: each keyframe's two views go out PNG-compressed on the
    image channel and land, bit for bit, in the peer's ``remote_images``
    under (drone, frame, view), a ring of the newest 64 (without send_img
    nothing is sent: tests/test_torch_system.py's transport case)."""
    from d2slam_tpu_torch.comm.transport import LocalBus
    from tests.test_torch_system import oracle_stereo_run

    img = (np.arange(120 * 160) % 251).astype(np.uint8).reshape(120, 160)
    bus = LocalBus()
    systems = oracle_stereo_run(transports=(bus.endpoint(0), bus.endpoint(1)), img=img,
                                send_img=True)
    for s, peer in zip(systems, (1, 0)):
        kfs = [f for (d, f, _, _) in s._pgo_meta if d == peer]
        assert len(kfs) >= 3
        assert set(s.remote_images) == {(peer, f, v) for f in kfs for v in (0, 1)}
        for got in s.remote_images.values():
            np.testing.assert_array_equal(got, img)
    ring = systems[0]
    for fid in range(100, 170):
        ring._on_image((7, fid, 0, 1, img))
    assert len(ring.remote_images) == 64
    assert (7, 169, 0) in ring.remote_images and (7, 105, 0) not in ring.remote_images


def test_pipelined_system_refuses_a_transport():
    """The swarm runs serially: polling the transport from the caller
    thread would race the backend's swarm and pose-graph updates."""
    from d2slam_tpu_torch.comm.transport import LocalBus
    from d2slam_tpu_torch.runtime.threaded import PipelinedSystem
    from d2slam_tpu_torch.utils.sim import CircleSim

    system = make_system(True, 0, CircleSim(n_landmarks=20, seed=3), LocalBus().endpoint(0))
    with pytest.raises(NotImplementedError, match="transport"):
        PipelinedSystem(system)


def _unify_inputs(n_views: int):
    """tests/test_swarm.py::test_swarm_alignment_and_unification's scene
    (the same seed and draws): robot A's keyframe with its landmarks known
    and robot B's keyframe of the same landmarks, B's world offset from
    A's by a yaw and a translation; each landmark in the first
    ``n_views`` cameras of the stereo rig, listed once per view with the
    same descriptor, as both packages' keyframe entries list it."""
    from d2slam_tpu_torch.utils import np_lie
    from d2slam_tpu_torch.utils.sim import default_extrinsics

    rng = np.random.default_rng(0)
    ext, n = default_extrinsics(), 80
    lms = np.concatenate([rng.uniform(6, 14, (n, 1)), rng.uniform(-5, 5, (n, 1)),
                          rng.uniform(0, 4, (n, 1))], axis=1)
    descs = rng.normal(0, 1, (n, 64)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    gdesc = rng.normal(0, 1, 1024).astype(np.float32)
    gdesc /= np.linalg.norm(gdesc)
    yaw = 0.6
    A_T_B = np.array([3.0, -1.0, 0.5, 0, 0, np.sin(yaw / 2), np.cos(yaw / 2)])
    pose_A = np.array([0.0, 0, 0, 0, 0, 0, 1])
    pose_B_inA = np.array([0.8, 0.4, 0.1, 0, 0, np.sin(0.05), np.cos(0.05)])
    pose_B = np_lie.pose_compose(np_lie.pose_inverse(A_T_B), pose_B_inA)
    descs_B = descs + rng.normal(0, 0.03, descs.shape).astype(np.float32)
    descs_B /= np.linalg.norm(descs_B, axis=1, keepdims=True)
    gdesc_B = gdesc + rng.normal(0, 0.005, 1024).astype(np.float32)
    gdesc_B /= np.linalg.norm(gdesc_B)

    def rays(pose):
        out = []
        for c in range(n_views):
            T = np_lie.pose_compose(pose, ext[c])
            pc = (lms - T[:3]) @ np_lie.quat_to_rotmat(T[3:])
            out.append(pc / np.linalg.norm(pc, axis=1, keepdims=True))
        return np.concatenate(out)

    return dict(ext=ext, n=n, lms=np.tile(lms, (n_views, 1)), desc=np.tile(descs, (n_views, 1)),
                desc_B=np.tile(descs_B, (n_views, 1)), gdesc=gdesc, gdesc_B=gdesc_B,
                cam=np.repeat(np.arange(n_views), n), ids=np.tile(np.arange(n), n_views),
                pose_A=pose_A, pose_B=pose_B, pose_B_inA=pose_B_inA, A_T_B=A_T_B,
                rays_A=rays(pose_A), rays_B=rays(pose_B_inA).astype(np.float32))


def _unify_run(port: bool, sc):
    """Robot A's swarm manager takes its own keyframe, then B's through
    the wire codec; returns the manager, the decoded packet and the edge."""
    if port:
        from d2slam_tpu_torch.comm.codec import RemoteKeyframePacket, decode_keyframe, encode_keyframe
        from d2slam_tpu_torch.frontend.loop_detector import (KeyframeEntry, LoopDetector,
                                                             LoopDetectorConfig)
        from d2slam_tpu_torch.vins.swarm import SwarmConfig, SwarmManager
    else:
        from d2slam_tpu.comm.codec import RemoteKeyframePacket, decode_keyframe, encode_keyframe
        from d2slam_tpu.frontend.loop_detector import KeyframeEntry, LoopDetector, LoopDetectorConfig
        from d2slam_tpu.vins.swarm import SwarmConfig, SwarmManager

    det = LoopDetector(LoopDetectorConfig(min_gap_frames=2, min_inliers=20, min_match_per_dir=10,
                                          gdesc_dim=1024),
                       sc["ext"], **(dict(device="cpu") if port else {}))
    mgr = SwarmManager(0, det, SwarmConfig())
    k = len(sc["ids"])
    mgr.add_local_keyframe(
        KeyframeEntry(frame_id=0, drone_id=0, stamp=0.0, pose=sc["pose_A"],
                      kpt_rays=sc["rays_A"], kpt_cam=sc["cam"].astype(np.int32),
                      kpt_desc=sc["desc"], kpt_valid=np.ones(k, bool), lm_positions=sc["lms"],
                      lm_ids=sc["ids"].astype(np.int64)),
        sc["gdesc"], stamp=0.0)
    pkt = decode_keyframe(encode_keyframe(RemoteKeyframePacket(
        drone_id=1, frame_id=100, stamp=5.0, is_keyframe=True,
        pose=sc["pose_B"].astype(np.float32), gdesc=sc["gdesc_B"],
        lm_ids=1000 + sc["ids"], lm_cam=sc["cam"].astype(np.uint8), lm_rays=sc["rays_B"],
        lm_vels=np.zeros((k, 3), np.float32), lm_desc=sc["desc_B"])))
    return mgr, pkt, mgr.on_remote_keyframe(pkt)


@pytest.mark.parametrize("n_views", [1, 2], ids=["mono", "stereo"])
def test_remote_keyframe_unifies_landmarks(n_views):
    """An inter-robot loop from a remote keyframe unifies B's landmark ids
    with A's, the earlier discovery (A's) owning them. Mono: the same
    loop, alignment and unified ids as the JAX package. Stereo (every
    landmark in both views): one pooled ratio test of the packet against
    A's entry, as the unification ran before it matched per
    camera-direction pair, meets each landmark's own copy and finds no
    match; the port still verifies the loop, recovers the alignment
    within the JAX test's 0.1 m, and unifies each of B's landmarks with
    its own counterpart in A."""
    from d2slam_tpu_torch.frontend.matching import match_descriptors
    from d2slam_tpu_torch.utils import np_lie

    sc = _unify_inputs(n_views)
    mgr, pkt, edge = _unify_run(True, sc)
    assert edge is not None and (edge.drone_id_a, edge.drone_id_b) == (0, 1)
    T = mgr.alignments[1].transform
    np.testing.assert_allclose(T[:3], sc["A_T_B"][:3], atol=0.1)
    assert abs(np_lie.quat_mul(np_lie.quat_conj(T[3:]), sc["A_T_B"][3:])[3]) > 0.999
    unified = {k: v for k, v in mgr.lm_unify.items() if k[0] == 1}
    assert len(unified) >= 10
    assert all(v == (0, k[1] - 1000) for k, v in unified.items())
    if n_views == 1:
        mgr_j, _, edge_j = _unify_run(False, sc)
        assert (edge.frame_id_a, edge.frame_id_b, edge.inliers) == (
            edge_j.frame_id_a, edge_j.frame_id_b, edge_j.inliers)
        np.testing.assert_allclose(T, mgr_j.alignments[1].transform, atol=1e-6)
        assert mgr.lm_unify == mgr_j.lm_unify
    else:
        old = mgr.detector.entries[0]
        _, ok = match_descriptors(torch.as_tensor(pkt.lm_desc), torch.as_tensor(old.kpt_desc),
                                  torch.ones(len(pkt.lm_ids), dtype=torch.bool),
                                  torch.as_tensor(old.kpt_valid))
        assert not ok.any()
