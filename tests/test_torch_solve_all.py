"""The port's SOLVE_ALL / SERVER estimator (``vins.solve_all``) against the
JAX package's, on the CPU, on the same wire packets.

* tests/test_solve_all.py's two-drone joint window (the own drone's
  frames from CircleSim seed 0, a second drone's keyframe packets from
  the same landmark ring a quarter turn ahead, 16 frames) and its server
  mode (two drones' packets only, 12 frames): the packets are built once
  and fed to both packages. Held: the pool's drones and slot layout, the
  solve and marginalization counts, every returned odometry, the own and
  the remote drone, within 1e-6 m (float64 windows solved with the same
  LM decisions; many solves and marginalizations in a row, so some room
  over a single solve's 1e-9); and the JAX tests' pins. Server mode is
  ``slow`` (Tier-1's budget; tests/test_torch_distributed_system.py runs
  it in Tier-1, port only).
* ``add_gauge_rows`` against the JAX package's.
"""
import numpy as np
import pytest
import torch

import tests.test_solve_all as TJ
from d2slam_tpu.vins.solve_all import SolveAllEstimator as JEstimator
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.sim import CircleSim
from d2slam_tpu_torch.vins.solve_all import SolveAllEstimator

torch.set_num_threads(1)  # tests run one process per core (xdist)

POSE_TOL = 1e-6   # m


def _cfg(port: bool):
    cfg = TJ.small_cfg()
    if not port:
        return cfg
    out = D2Config()
    for k, v in vars(cfg.estimator).items():
        setattr(out.estimator, k, v)
    return out


# the JAX estimator's compiled programs, shared by every JAX estimator of
# this module (all have one layout: the JAX package compiles per object)
_JAX_PROGRAMS = {}


def _estimator(port: bool, ext, **kw):
    if port:
        return SolveAllEstimator(_cfg(True), ext, lm_id_map=lambda d, l: l, device="cpu", **kw)
    est = JEstimator(_cfg(False), ext, lm_id_map=lambda d, l: l, **kw)
    names = ("_solve", "_marginalize", "_solve_marg", "_preintegrate")
    if _JAX_PROGRAMS:
        for n in names:
            setattr(est, n, _JAX_PROGRAMS[n])
    else:
        _JAX_PROGRAMS.update({n: getattr(est, n) for n in names})
    return est


def run_two_drone(port: bool, packets, n_frames=16):
    """tests/test_solve_all.py::run_two_drone with the remote packets
    given; returns the estimator and, per frame, the own and the remote
    odometry (None where there was none) and the gauge alignment."""
    sim1 = CircleSim(seed=0)
    est = _estimator(port, sim1.ext, max_drones=2)
    for (t, a, g) in sim1.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    t_prev, align, outs = 0.0, None, []
    for k in range(n_frames):
        t = k / sim1.frame_hz
        if k > 0:
            for (ts, a, g) in sim1.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        od = est.input_frame(sim1.frame(k))
        if od is not None and align is None:
            align = np_lie.pose_compose(od.pose.astype(np.float64),
                                        np_lie.pose_inverse(sim1.gt_pose(t)[0]))
        ro = None
        if align is not None:
            ro = est.input_remote_frame(packets(k, t_prev), world_T_other=align)
        outs.append((None if od is None else np.asarray(od.pose, np.float64),
                     None if ro is None else np.asarray(ro.pose, np.float64)))
        t_prev = t
    return est, outs, align


@pytest.fixture(scope="module")
def two_drone():
    sim2 = CircleSim(seed=0, phase=np.pi / 2)
    cache, wins = {}, []

    def packets(k, t_prev):
        if k not in cache:
            wins.append(k)
            cache[k] = TJ.remote_packet(sim2, k, t_prev, drone_id=2, win_ids=wins[-6:])
        return cache[k]

    return run_two_drone(False, packets), run_two_drone(True, packets), sim2


def _same_pool(ej, ep):
    assert [(f.frame_id, f.drone_id, f.is_keyframe) for f in ep.frames] == \
        [(f.frame_id, f.drone_id, f.is_keyframe) for f in ej.frames]
    assert (ep.solve_count, ep.margin_count) == (ej.solve_count, ej.margin_count)
    n = len(ep.frames)
    np.testing.assert_allclose(ep.state.poses.numpy()[:n], np.asarray(ej.state.poses)[:n],
                               atol=POSE_TOL, rtol=0)


def test_two_drone_joint_window_matches_jax(two_drone):
    (ej, oj, aj), (ep, op, ap), sim2 = two_drone
    np.testing.assert_allclose(ap, aj, atol=1e-12)
    _same_pool(ej, ep)
    for (pj, rj), (pp, rp) in zip(oj, op):
        for a, b in ((pp, pj), (rp, rj)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, atol=POSE_TOL, rtol=0)


def test_two_drone_joint_window_pins(two_drone):
    """tests/test_solve_all.py::test_two_drone_joint_window's pins on the
    port's run."""
    _, (est, outs, align), sim2 = two_drone
    sim1 = CircleSim(seed=0)
    mine, theirs = est._drone_slots(est.cfg.self_id), est._drone_slots(2)
    assert 1 <= len(mine) <= est.W_per and 1 <= len(theirs) <= est.W_per
    assert est.solve_count >= 10
    errs1, errs2 = [], []
    for k, (p1, p2) in enumerate(outs):
        t = k / sim1.frame_hz
        if p1 is not None:
            errs1.append(np.linalg.norm(p1[:3] - np_lie.pose_compose(align, sim1.gt_pose(t)[0])[:3]))
        if p2 is not None:
            errs2.append(np.linalg.norm(p2[:3] - np_lie.pose_compose(align, sim2.gt_pose(t)[0])[:3]))
    assert np.median(errs2) < 0.15 and np.median(errs1) < 0.1, (np.median(errs1), np.median(errs2))
    slots = {f.frame_id: f.drone_id for f in est.frames}
    fused = sum(len({slots.get(o.frame_id) for o in lm.obs} - {None}) > 1
                for lm in est.lmanager.db.values())
    assert fused >= 5
    ro = est.drone_odometry(2)
    gt, gv = sim2.gt_pose(ro.stamp)
    assert np.linalg.norm(ro.pose[:3] - np_lie.pose_compose(align, gt)[:3]) < 0.15
    assert np.linalg.norm(ro.vel - np_lie.quat_rotate(align[3:], gv)) < 0.3
    np.testing.assert_allclose(est.drone_trajectory(2), est.state.poses.numpy()[theirs])


def run_server(port: bool, packets, n_frames=12):
    sims = {1: CircleSim(seed=0), 2: CircleSim(seed=0, phase=np.pi)}
    est = _estimator(port, sims[1].ext, max_drones=2, server_mode=True)
    errs, fused = [], []
    for k in range(n_frames):
        t = k / sims[1].frame_hz
        for did in (1, 2):
            est.input_remote_frame(packets(did, k))
        est.solve_remote_only()
        for did in (1, 2):
            od = est.drone_odometry(did)
            if od is not None:
                fused.append(np.asarray(od.pose, np.float64))
                errs.append(np.linalg.norm(od.pose[:3] - sims[did].gt_pose(t)[0][:3]))
    return est, errs, fused


@pytest.mark.slow
def test_server_mode_matches_jax():
    sims = {1: CircleSim(seed=0), 2: CircleSim(seed=0, phase=np.pi)}
    cache, wins = {}, {1: [], 2: []}

    def packets(did, k):
        if (did, k) not in cache:
            wins[did] = (wins[did] + [k])[-6:]
            cache[(did, k)] = TJ.remote_packet(sims[did], k, (k - 1) / sims[1].frame_hz if k
                                               else 0.0, drone_id=did, win_ids=wins[did])
        return cache[(did, k)]

    ej, _, fj = run_server(False, packets)
    ep, errs, fp = run_server(True, packets)
    _same_pool(ej, ep)
    np.testing.assert_allclose(np.stack(fp), np.stack(fj), atol=POSE_TOL, rtol=0)
    assert ep.drone_ids() == [1, 2]
    # the JAX test's pins
    assert ep.solve_count >= 6
    assert np.median(errs) < 0.2, np.median(errs)


def test_gauge_rows_match_jax():
    import jax.numpy as jnp

    from d2slam_tpu.solver import VIOLayout as JL
    from d2slam_tpu.solver.marginalization import (
        add_gauge_rows as j_add,
        make_pose_prior as j_prior,
    )
    from d2slam_tpu.utils.synthetic import make_circle_scene as j_scene
    from d2slam_tpu_torch.solver.layout import VIOLayout
    from d2slam_tpu_torch.solver.marginalization import add_gauge_rows, make_pose_prior
    from d2slam_tpu_torch.utils.synthetic import make_circle_scene

    jl, tl = JL(W=6, C=2, L=16, M=64, N_IMU_SAMPLES=128), VIOLayout(6, 2, 16, 64, 128)
    js = j_scene(jl, 6, 12, dtype=jnp.float64)["gt_state"]
    ts = make_circle_scene(tl, 6, 12)["gt_state"]
    jp = j_add(jl, j_prior(jl, js, frame=0), js, frame=3, pos_sqrt_info=2.0, rot_sqrt_info=3.0)
    tp = add_gauge_rows(tl, make_pose_prior(tl, ts, frame=0), ts, frame=3, pos_sqrt_info=2.0,
                        rot_sqrt_info=3.0)
    for a, b in ((tp.J, jp.J), (tp.r, jp.r), (tp.row_valid, jp.row_valid),
                 (tp.lin.poses, jp.lin.poses), (tp.lin.frame_valid, jp.lin.frame_valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
