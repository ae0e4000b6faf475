"""The port's long-mission pose graph against the JAX package on the CPU:
the table grows past its initial pose budget instead of dropping
keyframes, the auto solver routes to PCG at scale, and the two distance
gates (``pgo_min_kf_dist`` on keyframes, ``loop_distance_threshold`` on
loops) — tests 1-3 of tests/test_pgo_longmission.py on both packages.

The graphs are built from the same host numbers in both packages, so
the bookkeeping (slots, capacities, ego edges, accepted loops) must be
equal exactly; the solve of a grown graph is compared with the JAX
package's, and the slow mirror holds the JAX test's drift pin.
"""
import numpy as np
import pytest
import torch

from d2slam_tpu.config import D2Config as JConfig
from d2slam_tpu.runtime.system import D2SLAMSystem as JSystem
from d2slam_tpu.runtime.system import LoopEdge as JLoopEdge
from d2slam_tpu.runtime.system import SystemConfig as JSystemConfig
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.runtime.system import D2SLAMSystem, LoopEdge, SystemConfig
from d2slam_tpu_torch.utils import np_lie

torch.set_num_threads(1)  # tests run one process per core (xdist)


def make_bare_system(port: bool, **sys_kw):
    Config, System, SysCfg = ((D2Config, D2SLAMSystem, SystemConfig) if port
                              else (JConfig, JSystem, JSystemConfig))
    cfg = Config()
    cfg.num_cams = 1
    return System(cfg, SysCfg(drone_id=0, **sys_kw), np.array([[0, 0, 0, 0, 0, 0, 1.0]]),
                  cameras=None, extract_fn=lambda img, cam: None,
                  **(dict(device="cpu") if port else {}))


def add_loop(system, edge_args, port: bool):
    if port:
        system.add_loop_edge(LoopEdge(*edge_args))
    else:
        system.add_loop_edge(JLoopEdge(*edge_args), broadcast=False)


def circle_pose(k, n, radius=30.0):
    th = 2 * np.pi * k / n
    q = np.array([0, 0, np.sin(th / 2 + np.pi / 4), np.cos(th / 2 + np.pi / 4)])
    return np.concatenate([[radius * np.cos(th), radius * np.sin(th), 0.0], q])


def drifting_circle(N, seed=0):
    rng = np.random.default_rng(seed)
    gt = [circle_pose(k, N) for k in range(N)]
    ego = [gt[0]]
    for k in range(1, N):
        rel = np_lie.pose_compose(np_lie.pose_inverse(gt[k - 1]), gt[k])
        rel[:3] += rng.normal(0, 0.01, 3)
        ego.append(np_lie.pose_compose(ego[-1], rel))
    return gt, ego


def grow(port, N, **kw):
    """N drifting keyframes and a loop every 50 frames of the second
    half-lap into a system of a small initial budget."""
    system = make_bare_system(port, **kw)
    gt, ego = drifting_circle(N)
    for k in range(N):
        system._add_pgo_node(0, k, float(k), ego[k])
    for k in range(N // 2, N, 50):
        j = k - N // 2
        rel = np_lie.pose_compose(np_lie.pose_inverse(gt[j]), gt[k])
        add_loop(system, (j, k, 0, 0, rel, 0.01, 0.01, 50), port)
    return system, gt, ego


def assert_same_graph(sp, sj):
    assert sp._pgo_capacity == sj._pgo_capacity
    assert sp._pgo_edge_capacity == sj._pgo_edge_capacity
    assert sp._pgo_slot == sj._pgo_slot
    assert len(sp._ego_edges) == len(sj._ego_edges)
    for (a, b, r, d), (ja, jb, jr, jd) in zip(sp._ego_edges, sj._ego_edges):
        assert (a, b) == (ja, jb) and d == jd
        np.testing.assert_array_equal(r, jr)
    assert [(e.frame_id_a, e.frame_id_b) for e in sp.loop_edges] == \
        [(e.frame_id_a, e.frame_id_b) for e in sj.loop_edges]


def test_graph_growth_matches_jax():
    """200 keyframes into a 16-pose table: both packages double it four
    times to 256 and keep every node and loop, and their solves of the
    grown graph (dense at this size) agree: positions within 1e-3 m
    (both solve in float32, sums in another order)."""
    kw = dict(pgo_max_poses=16, pgo_max_edges=32, pgo_iters=4, pcm_thres=1e9)
    sp, _, _ = grow(True, 200, **kw)
    sj, _, _ = grow(False, 200, **kw)
    assert len(sp._pgo_meta) == 200 and sp._pgo_capacity == 256
    assert len(sp.loop_edges) == 2
    assert_same_graph(sp, sj)
    out, jout = sp.solve_pgo(), np.asarray(sj.solve_pgo())
    assert out is not None and out.shape == (200, 7) and np.isfinite(out).all()
    np.testing.assert_allclose(out[:, :3], jout[:, :3], atol=1e-3, rtol=0)


@pytest.mark.slow
def test_long_mission_graph_growth_and_pcg_routing():
    """tests/test_pgo_longmission.py::test_long_mission_graph_growth_and_pcg_routing
    on the port (2100 keyframes from a 128-pose budget, PCG past 512
    poses), its graph equal to the JAX package's."""
    kw = dict(pgo_max_poses=128, pgo_max_edges=256, pgo_iters=4, pgo_pcg_threshold=512,
              pgo_cg_iters=50, pcm_thres=1e9)
    N = 2100
    sp, gt, ego = grow(True, N, **kw)
    sj, _, _ = grow(False, N, **kw)
    assert len(sp._pgo_meta) == N and sp._pgo_capacity >= N
    assert len(sp.loop_edges) == len(range(N // 2, N, 50))
    assert_same_graph(sp, sj)
    out = sp.solve_pgo()
    assert out is not None and np.isfinite(out).all() and out.shape[0] == N
    assert sp._pgo_capacity > sp.sys.pgo_pcg_threshold
    assert (np.linalg.norm(out[-1][:3] - gt[-1][:3])
            < np.linalg.norm(ego[-1][:3] - gt[-1][:3]))


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_loop_distance_gate(port):
    system = make_bare_system(port, loop_distance_threshold=5.0)
    system._add_pgo_node(0, 0, 0.0, circle_pose(0, 100))
    system._add_pgo_node(0, 1, 1.0, circle_pose(1, 100))
    add_loop(system, (0, 1, 0, 0, np.array([50.0, 0, 0, 0, 0, 0, 1.0]), 0.01, 0.01, 30), port)
    assert len(system.loop_edges) == 0         # gated out
    add_loop(system, (0, 1, 0, 0, np.array([1.0, 0, 0, 0, 0, 0, 1.0]), 0.01, 0.01, 30), port)
    assert len(system.loop_edges) == 1


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_min_kf_distance_gate(port):
    system = make_bare_system(port, pgo_min_kf_dist=0.5)
    p0 = np.array([0, 0, 0, 0, 0, 0, 1.0])
    system._add_pgo_node(0, 0, 0.0, p0)
    for k in range(1, 11):   # 10 hovering frames 1 cm apart: all gated
        p = p0.copy()
        p[0] = 0.01 * k
        system._add_pgo_node(0, k, float(k), p)
    assert len(system._pgo_meta) == 1
    p1 = p0.copy()
    p1[0] = 1.0
    system._add_pgo_node(0, 99, 99.0, p1)
    assert len(system._pgo_meta) == 2
    # the ego edge chains the last inserted node, composing the skipped motion
    (a, b, rel, dist) = system._ego_edges[-1]
    assert a == 0 and b == 1
    np.testing.assert_allclose(rel[:3], [1.0, 0, 0], atol=1e-9)
