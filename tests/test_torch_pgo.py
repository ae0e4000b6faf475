"""The port's pose-graph stack against the JAX package on the CPU:
``linearize_factor`` (forward mode through the retraction, a zero delta
included), dense LM and matrix-free PCG in 6-DoF and 4-DoF on the seeded
noisy loop graph of tests/test_pgo.py, PCM, g2o I/O,
``predicted_odometry`` and the spiral graph of
examples/bench_pgo_scale.py. Float64 on both sides: poses within 1e-4 m
and 1e-4 rad, equal counts of accepted steps, final costs within 1e-4
relative; PCM masks identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.factors import linearize as jlin
from d2slam_tpu.factors.residuals import relpose4d_residual as j_rel4
from d2slam_tpu.factors.residuals import relpose_residual as j_rel
from d2slam_tpu.geometry.lie import pose_compose as j_compose
from d2slam_tpu.geometry.lie import pose_inverse as j_inv
from d2slam_tpu.geometry.lie import so3_exp_quat
from d2slam_tpu.pgo import PGOLayout as JLayout
from d2slam_tpu.pgo import PGOState as JState
from d2slam_tpu.pgo import read_g2o as j_read_g2o
from d2slam_tpu.pgo import solve_pgo as j_solve_pgo
from d2slam_tpu.pgo import solve_pgo_pcg as j_solve_pgo_pcg
from d2slam_tpu.pgo import write_g2o as j_write_g2o
from d2slam_tpu.pgo.pcm import max_clique as j_max_clique
from d2slam_tpu.pgo.pcm import pcm_filter as j_pcm_filter
from d2slam_tpu.pgo.pose_graph import predicted_odometry as j_predicted_odometry
from d2slam_tpu_torch.factors.linearize import linearize_factor
from d2slam_tpu_torch.factors.residuals import relpose4d_residual, relpose_residual
from d2slam_tpu_torch.pgo import (
    PGOEdges,
    PGOLayout,
    PGOState,
    read_g2o,
    solve_pgo,
    solve_pgo_pcg,
    write_g2o,
)
from d2slam_tpu_torch.pgo.pcm import max_clique, pcm_filter
from d2slam_tpu_torch.pgo.pose_graph import predicted_odometry
from d2slam_tpu_torch.utils.synthetic import spiral_pose_graph
from tests.test_pgo import accumulate_odometry, make_loop_graph

torch.set_num_threads(1)  # tests run one process per core (xdist)

POS_TOL, ROT_TOL, COST_RTOL = 1e-4, 1e-4, 1e-4


def _rand_pose(rng, scale=1.0):
    q = np.asarray(so3_exp_quat(jnp.asarray(rng.normal(0, 0.4, 3))))
    return np.concatenate([rng.normal(0, scale, 3), q])


def _rot_err(qa, qb):
    """Angle (rad) between unit quaternions, row-wise."""
    d = np.abs(np.sum(qa / np.linalg.norm(qa, axis=-1, keepdims=True)
                      * qb / np.linalg.norm(qb, axis=-1, keepdims=True), axis=-1))
    return 2 * np.arccos(np.clip(d, -1.0, 1.0))


@pytest.mark.parametrize("kind", ["pose", "pose4d"])
@pytest.mark.parametrize("zero_error", [False, True])
def test_linearize_factor_matches_jax(kind, zero_error):
    """Residual and tangent Jacobians of a relative-pose edge; with
    ``zero_error`` the edge is evaluated exactly at its measurement,
    where the quaternion log meets a zero rotation."""
    rng = np.random.default_rng(3)
    pa, pb = _rand_pose(rng), _rand_pose(rng)
    rel = np.array([0, 0, 0, 0, 0, 0, 1.0]) if zero_error else _rand_pose(rng, 0.5)
    if zero_error:
        pb = pa.copy()
    si = np.diag(rng.uniform(1.0, 3.0, 6))
    if kind == "pose":
        jf, pf, si_used = j_rel, relpose_residual, si
    else:
        jf, pf, si_used = j_rel4, relpose4d_residual, si[:4, :4]
    r_j, J_j = jlin.linearize_factor(jf, (kind, kind), (jnp.asarray(pa), jnp.asarray(pb)),
                                     jnp.asarray(rel), jnp.asarray(si_used))
    t = torch.as_tensor
    r_p, J_p = linearize_factor(pf, (kind, kind), (t(pa), t(pb)), t(rel), t(si_used))
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), atol=1e-9)
    for a, b in zip(J_p, J_j):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)


def _graph(dof):
    gt, valid, edges, n = make_loop_graph()
    init = accumulate_odometry(gt, edges, n)
    fixed = np.zeros(64, bool)
    fixed[0] = True
    return gt, valid, edges, n, init, fixed


def _compare(j_out, j_rep, p_out, p_rep, n):
    jp, pp = np.asarray(j_out.poses)[:n], p_out.poses.numpy()[:n]
    assert np.abs(jp[:, :3] - pp[:, :3]).max() < POS_TOL
    assert _rot_err(jp[:, 3:], pp[:, 3:]).max() < ROT_TOL
    assert int(p_rep.accepted) == int(j_rep.accepted)
    jc, pc = float(j_rep.final_cost), float(p_rep.final_cost)
    assert abs(pc - jc) <= COST_RTOL * abs(jc)
    assert abs(float(p_rep.initial_cost) - float(j_rep.initial_cost)) <= 1e-9 * float(j_rep.initial_cost)
    assert pc < 0.3 * float(p_rep.initial_cost)


@pytest.mark.parametrize("dof", [6, 4])
def test_dense_pgo_matches_jax(dof):
    gt, valid, edges, n, init, fixed = _graph(dof)
    j_out, j_rep = j_solve_pgo(JLayout(64, 256, dof), JState(init, valid), edges,
                               jnp.asarray(fixed), max_iters=4)
    p_out, p_rep = solve_pgo(PGOLayout(64, 256, dof), PGOState(np.asarray(init), np.asarray(valid)),
                             PGOEdges(*[np.asarray(x) for x in edges]), fixed, max_iters=4,
                             device="cpu")
    _compare(j_out, j_rep, p_out, p_rep, n)


@pytest.mark.parametrize("dof", [6, 4])
def test_pcg_pgo_matches_jax(dof):
    gt, valid, edges, n, init, fixed = _graph(dof)
    kw = dict(max_iters=4, cg_iters=60)
    j_out, j_rep = j_solve_pgo_pcg(JLayout(64, 256, dof), JState(init, valid), edges,
                                   jnp.asarray(fixed), **kw)
    p_out, p_rep = solve_pgo_pcg(PGOLayout(64, 256, dof),
                                 PGOState(np.asarray(init), np.asarray(valid)),
                                 PGOEdges(*[np.asarray(x) for x in edges]), fixed,
                                 device="cpu", **kw)
    _compare(j_out, j_rep, p_out, p_rep, n)


def test_dense_pgo_float32_closes_loop():
    """The system's precision: float32 graph, the optimum near ground truth
    (the JAX test's 0.25 m noise bound) and near the JAX float32 solve."""
    gt, valid, edges, n, init, fixed = _graph(6)
    f32 = [np.asarray(x, np.float32) if np.asarray(x).dtype == np.float64 else np.asarray(x)
           for x in edges]
    p_out, p_rep = solve_pgo(PGOLayout(64, 256, 6),
                             PGOState(np.asarray(init, np.float32), np.asarray(valid)),
                             PGOEdges(*f32), fixed, max_iters=12, device="cpu")
    j_out, _ = j_solve_pgo(JLayout(64, 256, 6), JState(jnp.asarray(init, jnp.float32), valid),
                           type(edges)(*[jnp.asarray(x) for x in f32]), jnp.asarray(fixed),
                           max_iters=12)
    pp = p_out.poses.numpy()[:n]
    assert p_out.poses.dtype == torch.float32
    assert np.abs(pp[:, :3] - np.asarray(gt)[:n, :3]).max() < 0.25
    assert np.abs(pp[:, :3] - np.asarray(j_out.poses)[:n, :3]).max() < 1e-3


def test_max_clique_exact():
    adj = np.zeros((5, 5), np.uint8)
    for a, b in [(0, 1), (0, 2), (1, 2), (3, 4)]:
        adj[a, b] = adj[b, a] = 1
    assert max_clique(adj) == j_max_clique(adj) == [0, 1, 2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcm_matches_jax(seed):
    """The scenario of tests/test_pcm_distributed.py::test_pcm_rejects_bad_loops
    (8 consistent inter-robot loops, 3 corrupted), rotated frames added."""
    rng = np.random.default_rng(seed)
    n = 12
    poses_a = np.zeros((n, 7))
    poses_b = np.zeros((n, 7))
    for k in range(n):
        poses_a[k] = np.concatenate([[k * 1.0, 0, 0], _rand_pose(rng)[3:]])
        poses_b[k] = np.concatenate([[k * 1.0, 2.0, 0], _rand_pose(rng)[3:]])
    loops = np.stack([np.asarray(j_compose(j_inv(jnp.asarray(poses_a[k])), jnp.asarray(poses_b[k])))
                      for k in range(n)])
    loops[:, :3] += rng.normal(0, 0.02, (n, 3))
    bad = [2, 5, 9]
    for b in bad:
        loops[b, :3] += rng.normal(0, 3.0, 3)
    keep_j = j_pcm_filter(loops, poses_a, poses_b, thres=1.0)
    keep_p = pcm_filter(loops, poses_a, poses_b, thres=1.0, device="cpu")
    np.testing.assert_array_equal(keep_p, keep_j)
    assert keep_p.sum() == n - len(bad) and not keep_p[bad].any()
    assert pcm_filter(loops[:1], poses_a[:1], poses_b[:1], device="cpu").tolist() == [True]


def test_g2o_roundtrip_across_packages(tmp_path):
    gt, valid, edges, n = make_loop_graph()
    verts = {k: np.asarray(gt[k]) for k in range(n)}
    es = [(int(edges.i[m]), int(edges.j[m]), np.asarray(edges.rel[m]), np.eye(6) * (2.0 + m))
          for m in range(int(np.asarray(edges.valid).sum()))]
    for write, read in ((write_g2o, j_read_g2o), (j_write_g2o, read_g2o)):
        p = str(tmp_path / f"{write.__module__}.g2o")
        write(p, verts, es)
        v2, e2 = read(p)
        assert len(v2) == n and len(e2) == len(es)
        np.testing.assert_allclose(v2[3], verts[3], atol=1e-8)
        for (i, j, rel, info), (i2, j2, rel2, info2) in zip(es, e2):
            assert (i, j) == (i2, j2)
            np.testing.assert_allclose(rel2, rel, atol=1e-8)
            np.testing.assert_allclose(info2, info, atol=1e-8)
    assert open(str(tmp_path / f"{write_g2o.__module__}.g2o")).read() == \
        open(str(tmp_path / f"{j_write_g2o.__module__}.g2o")).read()


def test_predicted_odometry_matches_jax():
    rng = np.random.default_rng(5)
    opt, ego0, delta = _rand_pose(rng), _rand_pose(rng), _rand_pose(rng, 0.2)
    ego_now = np.asarray(j_compose(jnp.asarray(ego0), jnp.asarray(delta)))
    pred_j = np.asarray(j_predicted_odometry(jnp.asarray(opt), jnp.asarray(ego0), jnp.asarray(ego_now)))
    t = torch.as_tensor
    pred_p = predicted_odometry(t(opt), t(ego0), t(ego_now)).numpy()
    np.testing.assert_allclose(pred_p, pred_j, atol=1e-12)
    np.testing.assert_allclose(pred_p, np.asarray(j_compose(jnp.asarray(opt), jnp.asarray(delta))),
                               atol=1e-12)


@pytest.mark.parametrize("pos_noise", [0.0, 0.05])
def test_spiral_graph_matches_bench(pos_noise):
    """The port's copy of examples/bench_pgo_scale.py::big_graph."""
    from examples.bench_pgo_scale import big_graph

    layout, gt_j, edges_j = big_graph(450, seed=1, pos_noise=pos_noise)
    gt, edges = spiral_pose_graph(450, seed=1, pos_noise=pos_noise)
    assert layout.E == len(edges.i)
    np.testing.assert_array_equal(gt, gt_j)
    for a, b in zip(edges, edges_j):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_pgo_solvers_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gt, edges = spiral_pose_graph(20)
    state = PGOState(poses=gt.astype(np.float32), valid=np.ones(20, bool))
    fixed = np.eye(1, 20, 0, dtype=bool)[0]
    layout = PGOLayout(20, len(edges.i))
    for solver in (solve_pgo, solve_pgo_pcg):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solver(layout, state, edges, fixed, max_iters=1)
        out, rep = solver(layout, state, edges, fixed, max_iters=1, device="cpu")
        assert out.poses.device.type == "cpu" and float(rep.final_cost) < 1e-6
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcm_filter(np.tile(gt[:1], (2, 1)), gt[:2], gt[:2])
