"""The port's pose-graph initialization and distributed PGO against the
JAX package's on the CPU, and its partitioning copy.

* ``chordal_rotation_init`` (plain and with gravity priors),
  ``chordal_rotation_init_pcg`` and ``linear_translation_init`` (dense and
  cg) on tests/test_pgo.py's 40-pose circle with perturbed rotations,
  one graph and two batched: within 1e-9 (float64, one solve each;
  rotations compared as quaternions, whose sign both packages fix the
  same way).
* ``solve_pgo_pcg_anchored``, 6- and 4-DoF, anchors on a third of the
  poses: within 1e-6 of the largest pose entry (6 LM iterations of 60 CG
  steps; the accepted counts may part by one, where a step at convergence
  changes the cost by less than its rounding).
* ``arock_pgo_round`` on tests/test_pcm_distributed.py:110's two-drone
  graph (each drone's odometry chained, 16 rounds) and
  ``distributed_pgo_solve`` on its :199 graph (garbage rotations, rotation
  initialization first), the JAX package on a 2-device ``shard_map``, the
  port with the robots batched: within 1e-6 m / rad per round (LM with
  the same decisions; float64 sums in another order). The JAX tests' pins
  hold the port too: after 16 rounds every owned pose within 0.15 of the
  centralized solve and the stitched cost within twice the centralized
  one; after rotation initialization and 8 rounds within 0.3 of the truth.
  (The JAX side of the second runs 2 rounds, enough to hold rotation
  initialization and rounds alike: its program is unrolled per round.
  It is ``slow``: Tier-1's budget.)
* ``partitioning``: the port's copy gives the JAX package's results
  exactly (FENNEL, LDG, re-partition, stats, masks).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from d2slam_tpu.geometry.lie import quat_normalize as j_qnorm, so3_exp_quat
from d2slam_tpu.parallel.mesh import robot_mesh as j_mesh
from d2slam_tpu.pgo import PGOState as JState
from d2slam_tpu.pgo import partitioning as JP
from d2slam_tpu.pgo import rot_init as JR
from d2slam_tpu.pgo.distributed import (
    ARockPGOCarry as JCarry,
    arock_pgo_round as j_round,
    distributed_pgo_solve as j_dist_solve,
)
from d2slam_tpu.pgo.pcg import solve_pgo_pcg_anchored as j_pcg_anchored
from d2slam_tpu.pgo.pose_graph import PGOLayout as JLayout
from d2slam_tpu_torch.geometry.lie import pose_boxminus
from d2slam_tpu_torch.pgo import PGOEdges, PGOLayout, PGOState, solve_pgo
from d2slam_tpu_torch.pgo import partitioning as TP
from d2slam_tpu_torch.pgo import rot_init as TR
from d2slam_tpu_torch.pgo.distributed import (
    ARockPGOCarry,
    arock_pgo_round,
    distributed_pgo_solve,
)
from d2slam_tpu_torch.pgo.pcg import solve_pgo_pcg_anchored
from d2slam_tpu_torch.pgo.pose_graph import edge_cost
from tests.test_partitioning import _chain_with_loops
from tests.test_pcm_distributed import make_two_drone_graph
from tests.test_pgo import LAYOUT, make_loop_graph

torch.set_num_threads(1)  # tests run one process per core (xdist)

FN_TOL = 1e-9      # one float64 solve
LM_TOL = 1e-6      # LM runs taking the same decisions
TL = PGOLayout(LAYOUT.N, LAYOUT.E, 6)


def _t(x, dtype=None):
    a = np.array(x)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.as_tensor(a, dtype=dtype)


def _np(x):
    return x.detach().cpu().numpy()


def _edges(je):
    return PGOEdges(i=_t(je.i), j=_t(je.j), rel=_t(je.rel), sqrt_info=_t(je.sqrt_info),
                    valid=_t(je.valid))


def _quat_signed(a, ref):
    """``a``'s quaternions on ``ref``'s hemisphere."""
    a = a.copy()
    flip = np.sum(a[..., 3:] * ref[..., 3:], axis=-1) < 0
    a[..., 3:][flip] *= -1
    return a


@pytest.fixture(scope="module")
def loop_graph():
    gt, valid, edges, n = make_loop_graph(rot_noise=0.005)
    rng = np.random.default_rng(8)
    bad = np.asarray(gt).copy()
    for k in range(1, n):
        bad[k, 3:] = np.asarray(so3_exp_quat(jnp.asarray(rng.normal(0, 0.4, 3))))
        bad[k, :3] += rng.normal(0, 0.1, 3)
    fixed = np.zeros(LAYOUT.N, bool)
    fixed[0] = True
    grav = np.asarray([np.asarray(gt)[k, 3:] for k in range(LAYOUT.N)])
    # third row of each true attitude: the body-frame direction of world z
    x, y, z, w = grav.T
    grav = np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return gt, valid, edges, n, bad, fixed, grav


@pytest.mark.parametrize("pcg", [False, True])
@pytest.mark.parametrize("gravity_weight", [0.0, 10.0])
def test_chordal_rotation_init_matches_jax(loop_graph, pcg, gravity_weight):
    gt, valid, edges, n, bad, fixed, grav = loop_graph
    jf, tf = ((JR.chordal_rotation_init_pcg, TR.chordal_rotation_init_pcg) if pcg
              else (JR.chordal_rotation_init, TR.chordal_rotation_init))
    rq = j_qnorm(edges.rel[:, 3:])
    j = np.asarray(jf(jnp.asarray(bad), valid, edges.i, edges.j, rq, edges.valid,
                      jnp.asarray(fixed), gravity_body=jnp.asarray(grav),
                      gravity_weight=gravity_weight))
    args = (_t(valid), _t(edges.i), _t(edges.j), _t(rq), _t(edges.valid), _t(fixed))
    t = _np(tf(_t(bad), *args, gravity_body=_t(grav), gravity_weight=gravity_weight))
    np.testing.assert_allclose(_quat_signed(t, j), j, atol=FN_TOL, rtol=0)
    # the rotations came back near the truth (tests/test_pgo.py's pin)
    err = _np(pose_boxminus(torch.as_tensor(t[:n]), _t(np.asarray(gt)[:n])))
    assert np.abs(err[:, 3:]).max() < 0.08
    # two graphs batched: each as alone
    bad2 = bad.copy()
    bad2[1:n, :3] += 0.3
    tb = _np(tf(_t(np.stack([bad, bad2])), *args, gravity_body=_t(grav),
                gravity_weight=gravity_weight))
    np.testing.assert_allclose(tb[0], t, atol=FN_TOL, rtol=0)
    np.testing.assert_allclose(tb[1, :, 3:], t[:, 3:], atol=FN_TOL, rtol=0)


@pytest.mark.parametrize("method", ["dense", "cg"])
def test_linear_translation_init_matches_jax(loop_graph, method):
    gt, valid, edges, n, bad, fixed, _ = loop_graph
    j = np.asarray(JR.linear_translation_init(jnp.asarray(bad), valid, edges.i, edges.j,
                                              edges.rel[:, :3], edges.valid, jnp.asarray(fixed),
                                              method=method))
    t = _np(TR.linear_translation_init(_t(bad), _t(valid), _t(edges.i), _t(edges.j),
                                       _t(edges.rel[:, :3]), _t(edges.valid), _t(fixed),
                                       method=method))
    np.testing.assert_allclose(t, j, atol=FN_TOL * 100, rtol=0)
    with pytest.raises(ValueError):
        TR.linear_translation_init(_t(bad), _t(valid), _t(edges.i), _t(edges.j),
                                   _t(edges.rel[:, :3]), _t(edges.valid), _t(fixed),
                                   method="qr")


@pytest.mark.parametrize("dof", [6, 4])
def test_pcg_anchored_matches_jax(loop_graph, dof):
    gt, valid, edges, n, _, fixed, _ = loop_graph
    rng = np.random.default_rng(dof)
    init = np.asarray(gt).copy()
    init[1:n, :3] += rng.normal(0, 0.2, (n - 1, 3))
    K = 16
    ai = np.arange(0, 3 * K, 3) % n
    ap = np.asarray(gt)[ai].copy()
    ap[:, :3] += rng.normal(0, 0.05, (K, 3))
    aa = np.ones(K, bool)
    aa[::5] = False
    kw = dict(rho_T=1.0, rho_theta=2.0, max_iters=6, cg_iters=60)
    js, (jc0, jc, jacc) = j_pcg_anchored(
        JLayout(LAYOUT.N, LAYOUT.E, dof), JState(jnp.asarray(init), valid), edges,
        jnp.asarray(fixed), jnp.asarray(ai, jnp.int32), jnp.asarray(ap), jnp.asarray(aa), **kw)
    ts, (tc0, tc, tacc) = solve_pgo_pcg_anchored(
        PGOLayout(LAYOUT.N, LAYOUT.E, dof), PGOState(_t(init), _t(valid)), _edges(edges),
        _t(fixed), _t(ai), _t(ap), _t(aa), device="cpu", **kw)
    # a step taken at convergence changes the cost by less than its
    # rounding, and either package may accept it: the counts may part by one
    assert abs(int(tacc) - int(jacc)) <= 1 and int(tacc) >= 1
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-9)
    np.testing.assert_allclose(float(tc), float(jc), rtol=LM_TOL)
    jp = np.asarray(js.poses)
    np.testing.assert_allclose(_quat_signed(_np(ts.poses), jp), jp, atol=LM_TOL * np.abs(jp).max())


def _drifted(gt, edges, n):
    """tests/test_pcm_distributed.py: each drone's odometry chained from
    its first pose."""
    init = np.asarray(gt).copy()
    rel = np.asarray(edges.rel)
    odo = {(int(a), int(b)): rel[m] for m, (a, b) in
           enumerate(zip(np.asarray(edges.i), np.asarray(edges.j))) if np.asarray(edges.valid)[m]}
    from d2slam_tpu_torch.utils import np_lie

    for start in (0, n // 2):
        for k in range(start + 1, start + n // 2):
            init[k] = np_lie.pose_compose(init[k - 1], odo[(k - 1, k)])
    return init


def _shard_call(fn, n_in):
    return jax.jit(functools.partial(jax.shard_map, mesh=j_mesh(2), in_specs=(P("robot"),) * n_in,
                                     out_specs=P("robot"))(fn))


def test_arock_rounds_match_jax():
    gt, valid, edges, edge_mask, own, n = make_two_drone_graph()
    init = _drifted(gt, edges, n)
    fixed = np.zeros(LAYOUT.N, bool)
    fixed[0] = True
    est = np.zeros((2, LAYOUT.N), bool)
    est[:, :n] = True
    kw = dict(eta=0.9, rho=1.0, max_iters=4)

    def one(state_b, tilde_b, est_b, own_b, emask_b):
        carry = JCarry(state=jax.tree_util.tree_map(lambda x: x[0], state_b), tilde=tilde_b[0])
        nc, _ = j_round(LAYOUT, carry, edges, axis_name="robot", fixed_mask=jnp.asarray(fixed),
                        est_mask=est_b[0], own_mask=own_b[0], edge_mask=emask_b[0], **kw)
        return jax.tree_util.tree_map(lambda x: x[None], nc)

    one_round = _shard_call(one, 5)
    jc = JCarry(state=JState(jnp.stack([jnp.asarray(init)] * 2), jnp.stack([valid] * 2)),
                tilde=jnp.zeros((2, LAYOUT.N, 6)))
    tc = ARockPGOCarry(state=PGOState(_t(np.stack([init] * 2)), _t(valid)),
                       tilde=torch.zeros((2, LAYOUT.N, 6), dtype=torch.float64))
    te = _edges(edges)
    for _ in range(16):
        jc = one_round(jc.state, jc.tilde, jnp.asarray(est), jnp.asarray(own),
                       jnp.asarray(edge_mask))
        tc, (c0, c1, acc) = arock_pgo_round(
            TL, tc, te, est_mask=_t(est), own_mask=_t(own), fixed_mask=_t(fixed),
            edge_mask=_t(edge_mask), **kw)
        jp = np.asarray(jc.state.poses)
        np.testing.assert_allclose(_quat_signed(_np(tc.state.poses), jp), jp, atol=LM_TOL)
        np.testing.assert_allclose(_np(tc.tilde), np.asarray(jc.tilde), atol=LM_TOL)
    assert c1.shape == (2,) and bool((c1 <= c0).all())

    # the JAX test's pins against the port's centralized solve
    central, _ = solve_pgo(TL, PGOState(_t(init), _t(valid)), te, _t(fixed), max_iters=12,
                           device="cpu")
    cen = _np(central.poses)
    poses = _np(tc.state.poses)
    stitched = cen.copy()
    errs = []
    for r in range(2):
        for k in np.flatnonzero(own[r]):
            stitched[k] = poses[r, k]
            errs.append(np.abs(poses[r, k, :3] - cen[k, :3]).max())
    assert max(errs) < 0.15, max(errs)

    def cost(p):
        return float(edge_cost(PGOState(_t(p), _t(valid)), te, 6, 0.5))

    assert cost(stitched) < max(cost(cen) * 2.0, cost(cen) + 1e-3)


@pytest.mark.slow
def test_distributed_solve_with_rot_init_matches_jax():
    gt, valid, edges, edge_mask, own, n = make_two_drone_graph(seed=7)
    rng = np.random.default_rng(8)
    bad = np.asarray(gt).copy()
    for k in range(1, n):
        bad[k, 3:] = np.asarray(so3_exp_quat(jnp.asarray(rng.normal(0, 1.0, 3))))
        bad[k, :3] += rng.normal(0, 0.2, 3)
    fixed = np.zeros(LAYOUT.N, bool)
    fixed[0] = True
    est = np.zeros((2, LAYOUT.N), bool)
    est[:, :n] = True
    kw = dict(rho=1.0, max_iters=4, huber_delta=2.0)

    def solve(state_b, est_b, own_b, emask_b):
        s = jax.tree_util.tree_map(lambda x: x[0], state_b)
        out, _ = j_dist_solve(LAYOUT, s, edges, axis_name="robot", est_mask=est_b[0],
                              own_mask=own_b[0], fixed_mask=jnp.asarray(fixed),
                              edge_mask=emask_b[0], rounds=2, **kw)
        return jax.tree_util.tree_map(lambda x: x[None], out)

    batched = JState(jnp.stack([jnp.asarray(bad)] * 2), jnp.stack([valid] * 2))
    jp = np.asarray(_shard_call(solve, 4)(batched, jnp.asarray(est), jnp.asarray(own),
                                          jnp.asarray(edge_mask)).poses)
    state = PGOState(_t(np.stack([bad, bad])), _t(valid))
    args = dict(est_mask=_t(est), own_mask=_t(own), fixed_mask=_t(fixed),
                edge_mask=_t(edge_mask), **kw)
    te = _edges(edges)
    tp = _np(distributed_pgo_solve(TL, state, te, rounds=2, **args)[0].poses)
    np.testing.assert_allclose(_quat_signed(tp, jp), jp, atol=LM_TOL)

    # the JAX test's pin, after its 8 rounds
    out, (c0, c1, acc) = distributed_pgo_solve(TL, state, te, rounds=8, **args)
    poses = _np(out.poses)
    errs = [np.abs(poses[r, k, :3] - np.asarray(gt)[k, :3]).max()
            for r in range(2) for k in np.flatnonzero(own[r])]
    assert max(errs) < 0.3, max(errs)
    assert np.isfinite(poses).all() and bool((c1 <= c0).all())


def test_partitioning_equals_jax():
    n, edges = _chain_with_loops()
    for method in ("fennel", "ldg"):
        for k in (1, 3, 4):
            np.testing.assert_array_equal(TP.stream_partition(n, edges, k, method=method),
                                          JP.stream_partition(n, edges, k, method=method))
    old = JP.stream_partition(n, edges, 4)
    n2 = n + 12
    edges2 = edges + [(k, k + 1) for k in range(n - 1, n2 - 1)]
    np.testing.assert_array_equal(TP.repartition(n2, edges2, 4, old, sticky_bonus=2.0),
                                  JP.repartition(n2, edges2, 4, old, sticky_bonus=2.0))
    parts = TP.stream_partition(n, edges, 4)
    assert TP.partition_stats(parts, edges, 4) == JP.partition_stats(parts, edges, 4)
    for mode in ("full", "boundary"):
        for a, b in zip(TP.partition_to_masks(parts, np.asarray(edges), 64, 4, est_mode=mode),
                        JP.partition_to_masks(parts, np.asarray(edges), 64, 4, est_mode=mode)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TP.stream_partition(n, edges, 2, method="metis")
