"""The feature-level single-robot scenario of tests/test_torch_system.py
with the matrix-free PCG pose-graph solver (``pgo_solver="pcg"``, 30 CG
steps per LM iteration in both packages), through the port and the JAX
package on the CPU: the same keyframes, PGO solves and loops, PGO
trajectories within 5 mm."""
import torch

from tests.test_torch_system import assert_systems_agree, run_feature_level

torch.set_num_threads(1)  # tests run one process per core (xdist)


def test_feature_level_pcg_matches_jax():
    kw = dict(pgo_solver="pcg", pgo_cg_iters=30)
    sj, sp = run_feature_level(False, **kw), run_feature_level(True, **kw)
    assert_systems_agree(sj, sp)
    assert [(e.frame_id_a, e.frame_id_b) for e in sp.loop_edges] == \
        [(e.frame_id_a, e.frame_id_b) for e in sj.loop_edges]
