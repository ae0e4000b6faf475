"""The port's transport-based distributed PGO (``pgo.dpgo_transport``)
against the JAX package's, on the CPU.

* ``DPGOData`` wire bytes: each package's encoding equals the other's, and
  each decodes the other's.
* tests/test_dpgo_transport.py's two robot endpoints on a ``LocalBus``
  (18 ARock rounds on the two-robot graph with drifted initial guesses):
  the port's pair against the JAX pair, every robot's poses within 1e-9
  (float64 local solves taking the same accept / reject decisions; the
  rounds feed each other's float32 duals, so a difference in the last bit
  could grow, and does not), and the JAX test's pins.
* Port-only mirrors of the JAX tests with their pins: lossy links (30 %
  loss; ``slow``, Tier-1's budget), skip-if-stale, the ROT_INIT_FINISH barrier, its timeout,
  barrier signals waking held robots, 4-DoF, and the growth of the
  endpoint's tables (tests/test_pgo_longmission.py:123). Their
  centralized references are the port's own dense solve (held against
  the JAX package's in tests/test_torch_pgo.py).
"""
import numpy as np
import pytest
import torch

import tests.test_dpgo_transport as TJ
from d2slam_tpu.pgo import dpgo_transport as JD
from d2slam_tpu_torch.comm.transport import LocalBus
from d2slam_tpu_torch.pgo import PGOEdges, PGOLayout, PGOState, solve_pgo
from d2slam_tpu_torch.pgo import dpgo_transport as TD
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.vins.types import global_frame_id as gid

torch.set_num_threads(1)  # tests run one process per core (xdist)

POSE_TOL = 1e-9   # m / quaternion units


def test_codec_bytes_equal_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 5):
        args = dict(drone_id=3, target_id=-1 if n == 0 else 1, ref_frame_id=2, msg_type=n % 4,
                    stamp=12.5, iteration=7, keys=np.arange(n, dtype=np.int64) + gid(1, 4),
                    poses=rng.normal(size=(n, 7)).astype(np.float32),
                    duals=rng.normal(size=(n, 7)).astype(np.float32))
        bt = TD.encode_dpgo(TD.DPGOData(**args))
        bj = JD.encode_dpgo(JD.DPGOData(**args))
        assert bt == bj
        for dec in (TD.decode_dpgo(bj), JD.decode_dpgo(bt)):
            assert dec is not None and (dec.drone_id, dec.target_id, dec.iteration) == (
                3, args["target_id"], 7)
            np.testing.assert_array_equal(dec.keys, args["keys"])
            np.testing.assert_array_equal(dec.duals, args["duals"])
    assert TD.decode_dpgo(b"\x02" + bj[1:]) is None      # another wire version
    assert TD.decode_dpgo(bj[:5]) is None


def _robots(bus, cfg, init, edges, n=2, available=None):
    eps = []
    for r in range(n):
        ep = TD.TransportDPGO(bus.endpoint(r), r, cfg, device="cpu")
        if available is not None:
            ep.set_available_robots(available)
        for k, p in init.items():
            ep.add_frame(k, owner=k >> 40, pose=p)
        for (ka, kb, rel, s) in edges:
            ep.add_edge(ka, kb, rel, s)
        eps.append(ep)
    return eps


def _rounds(robots, rounds):
    for it in range(rounds):
        for ep in robots:
            ep.updated = True  # a new round: the reference's timer-driven solve
            ep.solve(stamp=float(it))


def _run_swarm(drop_prob=0.0, rounds=18, seed=0, **cfg_kw):
    gt, init, ego, loops = TJ._make_swarm_graph(seed=seed)
    cfg = TD.DPGOTransportConfig(max_poses=32, max_edges=64, max_anchors=32, rho_T=1.0,
                                 rho_theta=1.0, iters_per_step=4, **cfg_kw)
    robots = _robots(LocalBus(drop_prob=drop_prob, seed=seed), cfg, init, ego + loops)
    _rounds(robots, rounds)
    return gt, init, ego, loops, robots


def _centralized(init, ego, loops, dof=6):
    """The centralized dense solve of the graph (the port's solve_pgo)."""
    keys = sorted(init)
    slot = {k: i for i, k in enumerate(keys)}
    poses = np.tile([0, 0, 0, 0, 0, 0, 1.0], (32, 1))
    for k, i in slot.items():
        poses[i] = init[k]
    valid = np.arange(32) < len(keys)
    ei, ej = np.zeros(64, np.int64), np.zeros(64, np.int64)
    rel = np.tile([0, 0, 0, 0, 0, 0, 1.0], (64, 1))
    si = np.tile(np.eye(6), (64, 1, 1))
    ev = np.zeros(64, bool)
    sel4 = np.ix_([0, 1, 2, 5], [0, 1, 2, 5])
    for x, (ka, kb, r, s) in enumerate(ego + loops):
        ei[x], ej[x], rel[x], ev[x] = slot[ka], slot[kb], r, True
        si[x] = s if dof == 6 else np.pad(s[sel4], ((0, 2), (0, 2)))
    fixed = np.zeros(32, bool)
    fixed[slot[gid(0, 0)]] = True
    out, _ = solve_pgo(PGOLayout(32, 64, dof), PGOState(poses, valid),
                       PGOEdges(ei, ej, rel, si, ev), fixed, max_iters=30, huber_delta=1.0,
                       device="cpu")
    res = out.poses.numpy()
    return {k: res[slot[k]] for k in keys}


def _errors(robots, cen):
    errs, agree = [], []
    for k in cen:
        own = robots[k >> 40].optimized_pose(k)
        other = robots[1 - (k >> 40)].optimized_pose(k)
        errs.append(np.linalg.norm(own[:3] - cen[k][:3]))
        agree.append(np.linalg.norm(own[:3] - other[:3]))
    return max(errs), max(agree)


def _run_jax_swarm(rounds=18):
    """tests/test_dpgo_transport.py::_run_swarm with both JAX endpoints on
    one compiled local solve (the JAX package compiles one per endpoint)."""
    from d2slam_tpu.comm.transport import LocalBus as JBus

    _, init, ego, loops = TJ._make_swarm_graph(seed=0)
    cfg = JD.DPGOTransportConfig(max_poses=32, max_edges=64, max_anchors=32, rho_T=1.0,
                                 rho_theta=1.0, iters_per_step=4)
    bus = JBus(drop_prob=0.0, seed=0)
    robots = []
    for r in range(2):
        ep = JD.TransportDPGO(bus.endpoint(r), r, cfg)
        for k, p in init.items():
            ep.add_frame(k, owner=k >> 40, pose=p)
        for (ka, kb, rel, s) in ego + loops:
            ep.add_edge(ka, kb, rel, s)
        robots.append(ep)
    for it in range(rounds):
        for ep in robots:
            ep.updated = True
            ep.solve(stamp=float(it))
            if robots[1]._solver is None:
                robots[1]._solver = robots[0]._solver
    return robots


def test_transport_dpgo_matches_jax():
    gt, init, ego, loops, robots = _run_swarm()
    jrobots = _run_jax_swarm()
    n = len(init)
    for tr, jr in zip(robots, jrobots):
        assert tr.keys == jr.keys and tr.iteration == jr.iteration == 18
        assert set(tr.dual_local) == set(jr.dual_local)
        np.testing.assert_allclose(tr.poses[:n], jr.poses[:n], atol=POSE_TOL, rtol=0)
    # the JAX test's pins
    err_cen, err_agree = _errors(robots, _centralized(init, ego, loops))
    assert err_cen < 0.08 and err_agree < 0.08, (err_cen, err_agree)

    def ate(poses):
        return np.sqrt(np.mean([np.linalg.norm(poses[k][:3] - gt[k][:3]) ** 2 for k in gt]))

    assert ate({k: robots[k >> 40].optimized_pose(k) for k in gt}) < 0.6 * ate(init)
    assert robots[0].last_report[1] <= robots[0].last_report[0]


@pytest.mark.slow
def test_transport_dpgo_lossy_links():
    """30 % packet loss: ARock skips stale rounds, duals re-sync when
    packets get through (reference UAV-link tolerance)."""
    _, init, ego, loops, robots = _run_swarm(drop_prob=0.3, rounds=30, seed=3)
    cen = _centralized(init, ego, loops)
    errs = [np.linalg.norm(robots[k >> 40].optimized_pose(k)[:3] - cen[k][:3]) for k in cen]
    assert np.max(errs) < 0.12, np.max(errs)


def test_skip_if_stale():
    """A robot with nothing new skips its sub-steps after max_wait_steps
    (reference ARock.cpp:146-162)."""
    _, init, ego, _ = TJ._make_swarm_graph()
    cfg = TD.DPGOTransportConfig(max_poses=32, max_edges=64, max_anchors=32, max_wait_steps=2,
                                 iters_per_step=2)
    (ep,) = _robots(LocalBus(), cfg, init, [e for e in ego if (e[0] >> 40) == 0], n=1)
    assert ep.solve() == 1      # the graph is new: solves
    assert ep.solve() == 0      # nothing new arrived: skipped


def test_rot_init_finish_barrier():
    """ROT_INIT_FINISH (reference waitForRotInitFinish, d2pgo.cpp:130-153):
    a robot holds its ARock rounds after its rotation initialization until
    every available robot has signalled, re-announcing while it waits."""
    _, init, ego, loops = TJ._make_swarm_graph()
    cfg = TD.DPGOTransportConfig(max_poses=32, max_edges=64, max_anchors=32, iters_per_step=2)
    a, b = _robots(LocalBus(), cfg, init, ego + loops, available=[0, 1])
    assert a.solve() == 0
    assert a._rot_inited and not a._rot_barrier_passed
    assert b.solve() == 1 and b._rot_barrier_passed
    a.updated = True
    assert a.solve() == 1 and a._rot_barrier_passed


def test_rot_init_barrier_timeout():
    """A robot whose peers never answer goes on after the timeout budget
    (reference rot_init_timeout)."""
    _, init, ego, loops = TJ._make_swarm_graph()
    cfg = TD.DPGOTransportConfig(max_poses=32, max_edges=64, max_anchors=32, iters_per_step=2,
                                 rot_init_timeout_rounds=2)
    (ep,) = _robots(LocalBus(), cfg, init, ego + loops, n=1, available=[0, 1])
    held = 0
    for _ in range(3):
        if ep.solve() == 0:
            held += 1
            ep.updated = True
        else:
            break
    assert held == 2
    assert ep.solve() >= 0 and ep._rot_barrier_passed


def test_barrier_signals_wake_held_robots():
    """Signals alone wake robots held at the barrier (no dual data flows
    before ARock): three robots, solve() not re-armed by hand."""
    _, init, ego, loops = TJ._make_swarm_graph(n_robots=3, n_per=6)
    cfg = TD.DPGOTransportConfig(max_poses=32, max_edges=64, max_anchors=32, iters_per_step=2)
    eps = _robots(LocalBus(), cfg, init, ego + loops, n=3, available=[0, 1, 2])
    assert [ep.solve() for ep in eps] == [0, 0, 1]
    assert eps[0].solve() == 1 and eps[1].solve() == 1
    assert all(ep._rot_barrier_passed for ep in eps)


def test_transport_dpgo_4dof():
    """4-DoF (x / y / z / yaw), the reference's default for real swarms:
    the robots reach the centralized 4-DoF solution and agree."""
    _, init, ego, loops, robots = _run_swarm(seed=1, pose_dof=4)
    err_cen, err_agree = _errors(robots, _centralized(init, ego, loops, dof=4))
    assert err_cen < 0.1 and err_agree < 0.1, (err_cen, err_agree)


class _NullTransport:
    def send(self, ch, data):
        pass

    def recv(self, timeout_ms=0):
        return None


def test_transport_dpgo_growth():
    """The endpoint's tables double instead of refusing frames at
    max_poses; the caller's config is left alone (tests/
    test_pgo_longmission.py:123); the PCG route past pcg_threshold."""
    from tests.test_pgo_longmission import circle_pose

    cfg = TD.DPGOTransportConfig(max_poses=8, max_edges=8, max_anchors=8, rot_init=False,
                                 pcg_threshold=16)
    dp = TD.TransportDPGO(_NullTransport(), 0, cfg, device="cpu")
    for k in range(40):
        assert dp.add_frame(k, owner=0, pose=circle_pose(k, 40))
        if k:
            rel = np_lie.pose_compose(np_lie.pose_inverse(circle_pose(k - 1, 40)),
                                      circle_pose(k, 40))
            assert dp.add_edge(k - 1, k, rel, np.eye(6))
    assert len(dp.keys) == 40
    assert dp.cfg.max_poses >= 40 and dp.cfg.max_edges >= 39
    assert cfg.max_poses == 8 and cfg.max_edges == 8
    dp.updated = True
    assert dp.solve(stamp=40.0) == 1        # 64 slots > pcg_threshold: the PCG solve
    assert np.isfinite(dp.poses[:40]).all()


def test_endpoint_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TD.TransportDPGO(_NullTransport(), 0)
