"""The port's multi-robot modes of ``D2SLAMSystem`` on the CPU.

Tier 1 (port only, ``device="cpu"``, the oracle stereo path of
tests/test_torch_system.py::oracle_stereo_run, 6 frames per robot on a
``LocalBus`` in a common world):

* ``estimation_mode="distributed"``: two robots, one thread each behind a
  barrier so their consensus tokens match, ingest each other's keyframes
  into their pooled windows and average the frames they share;
* ``estimation_mode="server"``: two single-mode robots and an ingest-only
  server whose ``solve_server`` returns both drones;
* ``enable_dpgo=True``: the pose-graph solve becomes ARock rounds over the
  transport, and duals flow both ways;
* each ``SystemConfig`` field those modes read reaches its consumer.

``slow`` (run with ``-m slow``): the port beside the JAX package on the
JAX package's slow system scenarios, with their pins, in both packages
(tests/test_system.py::test_server_estimation_mode,
test_two_robot_transport_dpgo, test_two_robot_distributed_camera_consensus),
and port mirrors of tests/test_distributed_estimator.py::
test_divergent_windows_consensus and tests/test_golden_swarm_image.py with
their pins. The port as it is misses the image-level swarm's pin (0.744
against 0.65 m); with the JAX package's keyframe entries and float16
descriptors it reads the JAX package's 0.52 m (ROADMAP Queue 3).
"""
import os
import threading

import numpy as np
import pytest
import torch

import tests.test_system as TS
from tests.test_torch_swarm import _bus, make_system
from tests.test_torch_system import _modules, small_config

torch.set_num_threads(1)  # tests run one process per core (xdist)

N_FRAMES = 6


def oracle_systems(n_robots=2, extra=None, **sys_kw):
    """Port systems on CircleSim stereo frames with oracle 256-d features
    (tests/test_torch_system.py::oracle_stereo_run's set-up), one per
    robot on one ``LocalBus``, in a common world; ``extra`` appends an
    ingest-only node of those ``SystemConfig`` fields. Returns (systems,
    sims, oracles, extra node or None)."""
    from d2slam_tpu_torch.comm.transport import LocalBus
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.frontend.tracker import TrackerConfig
    from d2slam_tpu_torch.geometry.cameras import PinholeParams
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu_torch.utils.oracle import OracleExtractor
    from d2slam_tpu_torch.utils.sim import CircleSim

    H, W, F = 120, 160, 110.0
    bus = LocalBus()
    sims = [CircleSim(seed=5, n_landmarks=200, phase=0.1 * i) for i in range(n_robots)]
    cams = [PinholeParams.make(F, F, W / 2, H / 2)] * 2

    def build(i, sim, oracle, kw):
        cfg = small_config(D2Config)
        cfg.estimator.focal_length = F
        return D2SLAMSystem(
            cfg, SystemConfig(drone_id=i, pgo_every_n_kf=3, assume_common_world=True, **kw),
            sim.ext, cams, extract_fn=oracle,
            tracker_cfg=TrackerConfig(min_keyframe_parallax=0.0, search_radius=30.0),
            transport=bus.endpoint(i), frame_rate=sim.frame_hz, device="cpu")

    oracles = [OracleExtractor(sim.lms, sim.ext, F, F, W / 2, H / 2, (H, W), max_keypoints=64,
                               desc_dim=256) for sim in sims]
    systems = [build(i, sim, o, sys_kw) for i, (sim, o) in enumerate(zip(sims, oracles))]
    node = build(9, sims[0], oracles[0], extra) if extra is not None else None
    return systems, sims, oracles, node


def _step(s, sim, oracle, k, t_prev, img):
    """IMU since ``t_prev``, a poll of the bus, then frame ``k``."""
    t = k / sim.frame_hz
    if k == 0:
        for (ts, a, g) in sim.imu_samples(-0.3, 0.0):
            s.input_imu(ts, a, g)
    else:
        for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
            s.input_imu(ts, a, g)
    s.poll_network(now=t)
    return t


def drive(systems, sims, oracles, n_frames=N_FRAMES, lockstep=False, after_frame=None):
    """Feed every robot IMU and frames; each polls the bus before its
    frame. ``lockstep`` runs each robot on a thread of its own behind a
    barrier (the consensus handshake steps the robots together)."""
    img = np.zeros((120, 160), np.float32)

    def frame(s, sim, oracle, t):
        oracle.set_pose(sim.gt_pose(t)[0])
        s.input_stereo(t, img, img)

    if not lockstep:
        t_prev = [0.0] * len(systems)
        for k in range(n_frames):
            for i, (s, sim, o) in enumerate(zip(systems, sims, oracles)):
                t_prev[i] = _step(s, sim, o, k, t_prev[i], img)
                frame(s, sim, o, t_prev[i])
            if after_frame is not None:
                after_frame(k)
        return
    barrier = threading.Barrier(len(systems), timeout=600)
    errors = []

    def run(s, sim, oracle):
        try:
            t = 0.0
            for k in range(n_frames):
                t = _step(s, sim, oracle, k, t, img)
                barrier.wait()
                frame(s, sim, oracle, t)
        except Exception as e:  # surfaced below
            errors.append(e)
            barrier.abort()
            raise

    threads = [threading.Thread(target=run, args=a) for a in zip(systems, sims, oracles)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    assert not any(th.is_alive() for th in threads) and not errors, errors


def test_distributed_mode_runs():
    from d2slam_tpu_torch.vins.solve_all import SolveAllEstimator

    systems, sims, oracles, _ = oracle_systems(
        estimation_mode="distributed", max_drones=2, consensus_timeout_ms=2000)
    drive(systems, sims, oracles, lockstep=True)
    keys = []
    for s, peer in zip(systems, (1, 0)):
        est = s.estimator
        assert isinstance(est, SolveAllEstimator) and est.initialized
        assert est._consensus is not None and est._consensus_token >= 3
        assert peer in {f.drone_id for f in est.frames}, "peer keyframes never ingested"
        assert len(est._drone_slots(s.drone_id)) <= est.W_per
        assert torch.isfinite(est.state.poses).all()
        keys.append({est.consensus_key(f) for f in est.frames})
        assert np.isfinite(s.odometry.pose).all()
    assert keys[0] & keys[1], "no shared frames between the robots"
    # shared frames: the consensus pulled both robots' copies together
    dis = []
    for key in keys[0] & keys[1]:
        p = [est.state.poses[[w for w, f in enumerate(est.frames)
                              if est.consensus_key(f) == key][0]].numpy()
             for est in (systems[0].estimator, systems[1].estimator)]
        dis.append(np.linalg.norm(p[0][:3] - p[1][:3]))
    print("shared-frame disagreement", sorted(dis))
    assert np.median(dis) < 0.1, dis


def test_server_mode_runs():
    systems, sims, oracles, server = oracle_systems(
        extra=dict(estimation_mode="server", max_drones=2, broadcast=False))
    fused = {}

    def after(k):
        server.poll_network(now=k / sims[0].frame_hz)
        if k >= 4:
            fused.update(server.solve_server())

    drive(systems, sims, oracles, after_frame=after)
    assert set(fused) == {0, 1}, set(fused)
    est = server.estimator
    assert est.server_mode and est.solve_count >= 1 and est.drone_ids() == [0, 1]
    for did, s in enumerate(systems):
        assert np.isfinite(fused[did].pose).all()
        assert np.linalg.norm(fused[did].pose[:3] - s.odometry.pose[:3]) < 0.5
    with pytest.raises(RuntimeError, match="server"):
        systems[0].solve_server()


def test_dpgo_mode_runs():
    systems, sims, oracles, _ = oracle_systems(enable_dpgo=True)
    drive(systems, sims, oracles)
    for _ in range(2):
        for s in systems:
            s.poll_network(now=1.0)
            s.solve_pgo()
    for s in systems:
        dp = s.dpgo
        assert dp is not None and dp.iteration >= 2 and s.pgo_solve_count >= 3
        assert dp.dual_remote, "no duals arrived"
        assert {dp.owner[k] for k in dp.keys} == {0, 1}
        stamps, opt = s.trajectory()
        assert len(stamps) >= 5 and np.isfinite(opt).all()
        assert np.isfinite(s.last_pgo_report.final_cost)
    # both robots' estimates of robot 0's keyframes agree
    a, b = (s.dpgo for s in systems)
    d = [np.linalg.norm(a.optimized_pose(k)[:3] - b.optimized_pose(k)[:3])
         for k in a.keys if k in b.slot_of and a.owner[k] == 0]
    assert len(d) >= 3 and np.median(d) < 0.1, d


@pytest.mark.parametrize("field,value", [
    ("max_drones", 3), ("consensus_timeout_ms", 37), ("assume_common_world", False),
    ("dpgo_rho_T", 0.3), ("dpgo_rho_theta", 1.5), ("dpgo_eta_k", 0.7), ("dpgo_iters", 3)])
def test_config_field_reaches_its_consumer(field, value):
    from d2slam_tpu_torch.comm.transport import LocalBus
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu_torch.utils.sim import default_extrinsics

    cfg = small_config(D2Config)
    kw = dict(drone_id=2, estimation_mode="distributed", enable_dpgo=True,
              assume_common_world=True)
    kw[field] = value
    s = D2SLAMSystem(cfg, SystemConfig(**kw),
                     default_extrinsics(), None, extract_fn=lambda img, cam: None,
                     transport=LocalBus().endpoint(2), device="cpu")
    est, dp = s.estimator, s.dpgo
    read = {
        "max_drones": lambda: (est.max_drones, est.layout.W // cfg.estimator.max_sld_win_size,
                               est._consensus_peers + 1),
        "consensus_timeout_ms": lambda: est._consensus_timeout,
        "assume_common_world": lambda: (s.ref_frame_id, dp.ref_frame_id,
                                        est._consensus.ref_frame_id),
        "dpgo_rho_T": lambda: dp.cfg.rho_T,
        "dpgo_rho_theta": lambda: dp.cfg.rho_theta,
        "dpgo_eta_k": lambda: dp.cfg.eta_k,
        "dpgo_iters": lambda: dp.cfg.iters_per_step,
    }[field]()
    want = {"max_drones": (3, 3, 3), "assume_common_world": (2, 2, 2)}.get(field, value)
    assert read == want


# ---------------------------------------------------------------------------
# slow: the JAX package's system scenarios, both packages
# ---------------------------------------------------------------------------


def _feed(s, sim, k, t_prev, KeyframeEntry):
    """IMU since ``t_prev`` and CircleSim feature frame ``k`` with its
    cam0 entry and bag-of-landmark descriptor (tests/test_system.py)."""
    t = k / sim.frame_hz
    if k == 0:
        for (ts, a, g) in sim.imu_samples(-0.3, 0.0):
            s.input_imu(ts, a, g)
    else:
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


def _two_sims(port):
    CircleSim = _modules(port)[5]
    return (CircleSim(n_landmarks=TS.N_LM, seed=3, phase=0.0),
            CircleSim(n_landmarks=TS.N_LM, seed=3, phase=0.25))


def _np_lie(port):
    if port:
        from d2slam_tpu_torch.utils import np_lie
    else:
        from d2slam_tpu.utils import np_lie
    return np_lie


def server_scenario(port):
    """tests/test_system.py::test_server_estimation_mode; returns its
    numbers (server against each drone's own VIO, server ATE)."""
    KeyframeEntry = _modules(port)[1]
    bus = _bus(port)
    sim_a, sim_b = _two_sims(port)
    sys_a = make_system(port, 0, sim_a, bus.endpoint(0), assume_common_world=True)
    sys_b = make_system(port, 1, sim_b, bus.endpoint(1), assume_common_world=True)
    server = make_system(port, 9, sim_a, bus.endpoint(9), estimation_mode="server",
                         max_drones=2, assume_common_world=True, broadcast=False)
    t_prev = 0.0
    for k in range(14):
        for s, sim in ((sys_a, sim_a), (sys_b, sim_b)):
            t = _feed(s, sim, k, t_prev, KeyframeEntry)
        t_prev = t
        server.poll_network(now=t)
        if k >= 4 and k % 2 == 0:
            assert all(np.isfinite(od.pose).all() for od in server.solve_server().values())
    fused = server.solve_server()
    np_lie = _np_lie(port)
    out = dict(drones=sorted(fused), vs_own={}, ate={}, frames={})
    for did, s, sim in ((0, sys_a, sim_a), (1, sys_b, sim_b)):
        out["vs_own"][did] = float(np.linalg.norm(np.asarray(s.odometry.pose[:3])
                                                  - np.asarray(fused[did].pose[:3])))
        traj = server.estimator.drone_trajectory(did)
        stamps = [server.estimator.frames[w].stamp for w in server.estimator._drone_slots(did)]
        T = np_lie.pose_compose(sim.gt_pose(stamps[0])[0], np_lie.pose_inverse(traj[0]))
        errs = [np.linalg.norm(np_lie.pose_compose(T, traj[i])[:3] - sim.gt_pose(st)[0][:3])
                for i, st in enumerate(stamps)]
        out["ate"][did] = float(np.sqrt(np.mean(np.square(errs))))
        out["frames"][did] = len(stamps)
    return out


def assert_server_pins(r):
    assert r["drones"] == [0, 1], r
    assert all(v < 0.5 for v in r["vs_own"].values()), r
    assert all(n >= 5 for n in r["frames"].values()), r
    assert all(v < 0.25 for v in r["ate"].values()), r


def dpgo_scenario(port):
    """tests/test_system.py::test_two_robot_transport_dpgo; returns its
    numbers."""
    KeyframeEntry = _modules(port)[1]
    if port:
        from d2slam_tpu_torch.vins.types import global_frame_id as gid
    else:
        from d2slam_tpu.vins.types import global_frame_id as gid
    bus = _bus(port)
    sim_a, sim_b = _two_sims(port)
    sys_a = make_system(port, 0, sim_a, bus.endpoint(0), enable_dpgo=True, pgo_every_n_kf=4)
    sys_b = make_system(port, 1, sim_b, bus.endpoint(1), enable_dpgo=True, pgo_every_n_kf=4)
    t_prev = 0.0
    for k in range(18):
        for s, sim in ((sys_a, sim_a), (sys_b, sim_b)):
            t = _feed(s, sim, k, t_prev, KeyframeEntry)
        t_prev = t
        sys_a.poll_network(now=t)
        sys_b.poll_network(now=t)
    for _ in range(8):
        for s in (sys_a, sys_b):
            s.poll_network(now=t_prev)
            s.solve_pgo()
    disagree = []
    for (d, fid, _, _) in sys_a._pgo_meta:
        pa, pb = sys_a.dpgo.optimized_pose(gid(d, fid)), sys_b.dpgo.optimized_pose(gid(d, fid))
        if pa is not None and pb is not None:
            disagree.append(float(np.linalg.norm(pa[:3] - pb[:3])))
    return dict(
        inter_loops=[sum(e.drone_id_a != e.drone_id_b for e in s.loop_edges)
                     for s in (sys_a, sys_b)],
        ref_frame_b=sys_b.ref_frame_id,
        duals=[len(s.dpgo.dual_remote) for s in (sys_a, sys_b)],
        shared=len(disagree), median_disagreement=float(np.median(disagree)))


def assert_dpgo_pins(r):
    assert min(r["inter_loops"]) >= 1 and r["ref_frame_b"] == 0, r
    assert min(r["duals"]) >= 1, r
    assert r["shared"] >= 10 and r["median_disagreement"] < 0.25, r


def distributed_scenario(port):
    """tests/test_system.py::test_two_robot_distributed_camera_consensus
    (one thread per robot behind a barrier); returns its numbers."""
    KeyframeEntry = _modules(port)[1]
    bus = _bus(port)
    sim_a, sim_b = _two_sims(port)
    kw = dict(estimation_mode="distributed", max_drones=2, consensus_timeout_ms=2000)
    sys_a = make_system(port, 0, sim_a, bus.endpoint(0), **kw)
    sys_b = make_system(port, 1, sim_b, bus.endpoint(1), **kw)
    barrier = threading.Barrier(2, timeout=900)
    errs = []

    def run(s, sim):
        try:
            t_prev = 0.0
            for k in range(18):
                t = k / sim.frame_hz
                s.poll_network(now=t)
                barrier.wait()   # align the solves so the consensus tokens match
                _feed(s, sim, k, t_prev, KeyframeEntry)
                t_prev = t
        except Exception as e:
            errs.append(e)
            barrier.abort()
            raise

    th = threading.Thread(target=run, args=(sys_b, sim_b))
    th.start()
    run(sys_a, sim_a)
    th.join(timeout=1200)
    assert not th.is_alive() and not errs, errs
    np_lie = _np_lie(port)
    od_a, od_b = sys_a.odometry, sys_b.odometry
    T = np_lie.pose_compose(np.asarray(od_a.pose, np.float64),
                            np_lie.pose_inverse(sim_a.gt_pose(od_a.stamp)[0]))
    gt_b = np_lie.pose_compose(T, sim_b.gt_pose(od_b.stamp)[0])
    ka = {sys_a.estimator.consensus_key(f) for f in sys_a.estimator.frames}
    kb = {sys_b.estimator.consensus_key(f) for f in sys_b.estimator.frames}
    return dict(ref_frame_ids=[sys_a.ref_frame_id, sys_b.ref_frame_id],
                drones_in_a=sorted({f.drone_id for f in sys_a.estimator.frames}),
                drones_in_b=sorted({f.drone_id for f in sys_b.estimator.frames}),
                shared_keys=len(ka & kb),
                err_b=float(np.linalg.norm(np.asarray(od_b.pose[:3]) - gt_b[:3])))


def assert_distributed_pins(r):
    assert r["ref_frame_ids"] == [0, 0], r
    assert 1 in r["drones_in_a"] and 0 in r["drones_in_b"], r
    assert r["shared_keys"] >= 1 and r["err_b"] < 0.6, r


@pytest.mark.slow
@pytest.mark.parametrize("scenario", ["server", "dpgo", "distributed"])
def test_system_scenario_beside_jax(scenario):
    fn, pins = {"server": (server_scenario, assert_server_pins),
                "dpgo": (dpgo_scenario, assert_dpgo_pins),
                "distributed": (distributed_scenario, assert_distributed_pins)}[scenario]
    rj, rp = fn(False), fn(True)
    print(f"{scenario}: JAX {rj}\nport {rp}")
    pins(rj)
    pins(rp)


@pytest.mark.slow
def test_divergent_windows_consensus():
    """tests/test_distributed_estimator.py::test_divergent_windows_consensus
    on the port: two pooled estimators with divergent keyframe decisions
    exchange keyframes and consensus sub-steps by frame id."""
    import tests.test_distributed_estimator as TD
    from d2slam_tpu_torch.comm.codec import decode_keyframe, encode_keyframe
    from d2slam_tpu_torch.comm.consensus_transport import TransportConsensus
    from d2slam_tpu_torch.comm.transport import (
        CH_DISTRIB_VINS,
        CH_VIOKF_LANDMARKS,
        ChannelRouter,
        LocalBus,
    )
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.utils import np_lie
    from d2slam_tpu_torch.utils.sim import CircleSim
    from d2slam_tpu_torch.vins.solve_all import SolveAllEstimator

    class Robot(TD.Robot):
        def __init__(self, rid, bus, phase, kf_fn, seed):
            self.rid = rid
            self.sim = CircleSim(pix_noise_rad=0.5 / 460.0, seed=seed, phase=phase)
            self.cfg = D2Config()
            for k, v in vars(TD.small_cfg(rid).estimator).items():
                setattr(self.cfg.estimator, k, v)
            self.cfg.self_id = rid
            self.est = SolveAllEstimator(self.cfg, self.sim.ext, max_drones=2,
                                         lm_id_map=lambda d, l: l, device="cpu")
            router = ChannelRouter(bus.endpoint(rid))
            self.kf_ep = router.route({CH_VIOKF_LANDMARKS})
            self.est.attach_consensus(TransportConsensus(router.route({CH_DISTRIB_VINS}), rid),
                                      expected_peers=1, timeout_ms=4000)
            self.kf_fn, self.win_ids, self.merged = kf_fn, [], False
            self.t_prev_kf, self.errs = 0.0, []

    # the JAX test's Robot methods, with the port's codec and np_lie
    TD_globals = TD.Robot.step_pre.__globals__
    saved = {k: TD_globals[k] for k in ("decode_keyframe", "encode_keyframe", "np_lie")}
    TD_globals.update(decode_keyframe=decode_keyframe, encode_keyframe=encode_keyframe,
                      np_lie=np_lie)
    try:
        bus = LocalBus()
        r1 = Robot(1, bus, 0.0, lambda k: True, 0)
        r2 = Robot(2, bus, np.pi / 2, lambda k: k % 3 != 2, 99)
        barrier = threading.Barrier(2, timeout=600)
        errs = []

        def run(r):
            try:
                t_prev = 0.0
                for k in range(12):
                    t = k / r.sim.frame_hz
                    r.step_pre(k, t, t_prev)
                    barrier.wait()
                    r.step_frame(k, t)
                    t_prev = t
            except Exception as e:
                errs.append(e)
                barrier.abort()
                raise

        th = threading.Thread(target=run, args=(r2,))
        th.start()
        run(r1)
        th.join(timeout=900)
    finally:
        TD_globals.update(saved)
    assert not th.is_alive() and not errs, errs
    assert r1.est.solve_count >= 6 and r2.est.solve_count >= 6
    keys1 = {r1.est.consensus_key(f) for f in r1.est.frames}
    keys2 = {r2.est.consensus_key(f) for f in r2.est.frames}
    shared = keys1 & keys2
    assert shared and keys1 != keys2
    dis = []
    for key in shared:
        pa = [r1.est.state.poses[w].numpy() for w, f in enumerate(r1.est.frames)
              if r1.est.consensus_key(f) == key][0]
        pb = [r2.est.state.poses[w].numpy() for w, f in enumerate(r2.est.frames)
              if r2.est.consensus_key(f) == key][0]
        dis.append(np.linalg.norm(pa[:3] - pb[:3]))
    assert np.median(dis) < 0.12, sorted(dis)
    assert np.median(r1.errs) < 0.15 and np.median(r2.errs) < 0.15


@pytest.mark.slow
@pytest.mark.parametrize("entries", ["port", "jax"])
def test_golden_swarm_image_level(entries):
    """tests/test_golden_swarm_image.py on the port: two robots at 240x320
    from rendered blobs through the trained SuperPoint and NetVLAD (and
    SuperGlue on the loop candidates), keyframes on a ``LocalBus``, an
    inter-robot loop, the alignment and the joint PGO within its pin.

    ``entries="jax"`` puts the JAX package's two differences into the
    port (keyframe entries listing a landmark once per view, descriptors
    rounded to float16; tests/test_torch_image_witness.py): the JAX
    package reads 0.519 m here, the port so 0.521 m. The port as it is
    reads 0.744 m and misses the pin (ROADMAP Queue 3)."""
    from tests.test_torch_image_witness import _entries_per_view, _half_descriptors
    from tests.test_golden_swarm_image import GOLDEN_SWARM_IMAGE_RMSE, NV_W, SG_W, SP_W
    from d2slam_tpu_torch.comm.transport import LocalBus
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.frontend.loop_detector import LoopDetectorConfig
    from d2slam_tpu_torch.frontend.superpoint import SuperPointConfig, load_params
    from d2slam_tpu_torch.frontend.tracker import TrackerConfig
    from d2slam_tpu_torch.geometry.cameras import PinholeParams
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu_torch.utils import np_lie
    from d2slam_tpu_torch.utils.render import make_signatures, render_blobs
    from d2slam_tpu_torch.utils.sim import CircleSim

    H, W, F = 240, 320, 220.0
    sim_a = CircleSim(seed=7, baseline=0.2, n_landmarks=150, phase=0.0)
    sim_b = CircleSim(seed=7, baseline=0.2, n_landmarks=150, phase=0.3)
    inten = sim_a.rng.uniform(0.5, 1.0, len(sim_a.lms))
    sim_b.lms = sim_a.lms
    sigs = make_signatures(len(sim_a.lms), seed=7)
    bus = LocalBus()
    systems, sims = [], [sim_a, sim_b]
    for i, sim in enumerate(sims):
        cfg = small_config(D2Config)
        cfg.estimator.focal_length = F
        systems.append(D2SLAMSystem(
            cfg, SystemConfig(drone_id=i, pgo_every_n_kf=100, netvlad_weights=NV_W,
                              enable_superglue_remote=os.path.exists(SG_W),
                              superglue_weights=SG_W if os.path.exists(SG_W) else ""),
            sim.ext, [PinholeParams.make(F, F, W / 2, H / 2) for _ in range(2)],
            sp_params=load_params(SP_W),
            sp_cfg=SuperPointConfig(max_keypoints=200, threshold=0.008, nms_radius=4),
            transport=bus.endpoint(i),
            tracker_cfg=TrackerConfig(min_keyframe_parallax=4.0, search_radius=30.0),
            loop_cfg=LoopDetectorConfig(gdesc_dim=1024, min_gap_frames=2, min_inliers=4,
                                        min_match_per_dir=4, pnp_thresh=16.0 / 460.0),
            frame_rate=sim.frame_hz, device="cpu"))
        if entries == "jax":
            _entries_per_view(systems[-1])
            _half_descriptors(systems[-1])
    t_prev = 0.0
    for k in range(26):
        t = k / sim_a.frame_hz
        for s, sim in zip(systems, sims):
            if k == 0:
                for (ts, a, g) in sim.imu_samples(-0.3, 0.0):
                    s.input_imu(ts, a, g)
            else:
                for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                    s.input_imu(ts, a, g)
            pose_gt, _ = sim.gt_pose(t)
            imgs = [render_blobs(sim.lms, np_lie.pose_compose(pose_gt, sim.ext[c]), F, F, W / 2,
                                 H / 2, H, W, intensities=inten, signatures=sigs)
                    for c in range(2)]
            s.input_stereo(t, imgs[0], imgs[1])
        t_prev = t
        for s in systems:
            s.poll_network(now=t)
    for _ in range(3):
        for s in systems:
            s.poll_network(now=t_prev)
    host = next((s for s in systems if s.swarm.alignments), None)
    assert host is not None, "no inter-robot map alignment from images"
    other = 1 - host.drone_id
    assert any(e.drone_id_a != e.drone_id_b for e in host.loop_edges)
    host.solve_pgo()
    st_h, ego_h = host.trajectory(drone_id=host.drone_id, optimized=False)
    T = np_lie.pose_compose(sims[host.drone_id].gt_pose(st_h[0])[0], np_lie.pose_inverse(ego_h[0]))
    st_o, opt_o = host.trajectory(drone_id=other)
    assert len(st_o) >= 8
    errs = [np.linalg.norm(np_lie.pose_compose(T, p)[:3] - sims[other].gt_pose(st)[0][:3])
            for st, p in zip(st_o, opt_o)]
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    print(f"port swarm image-level ({entries} entries): host {host.drone_id}, "
          f"joint RMSE {rmse:.3f} m")
    assert rmse < GOLDEN_SWARM_IMAGE_RMSE
