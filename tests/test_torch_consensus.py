"""The port's consensus ADMM (``parallel.consensus``, robots on a batch
dimension) against the JAX package's (robots on a ``shard_map`` over the
virtual CPU devices of tests/conftest.py), on tests/test_consensus.py's
scene: the circle window of ``make_circle_scene`` (W=6, 40 landmarks,
seed 4), each robot's poses perturbed by its own seeded draw.

Tolerances: 1e-9 for the averages, duals and consensus rows (single
float64 functions: sums in another order); 1e-6 of the largest entry for
``lm_solve_vio(consensus=)`` against each robot's solve in the JAX
package's first ADMM round; 1e-6 m / rad per ADMM round for R = 2 and 4
(5 rounds of 3 LM iterations each: the LM takes the same accept / reject
decisions, float64 sums in another order). The JAX test's pins hold the
port too: disagreement < 6e-3 after 5 rounds and below a fifth of the
first round's, and, at the test's R = 4, within 5e-2 of the truth.
The R = 2 rounds are ``slow`` (one more JAX compile: Tier-1's budget).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from d2slam_tpu.geometry.lie import pose_boxplus as j_boxplus
from d2slam_tpu.parallel.consensus import (
    ConsensusCarry as JCarry,
    admm_vio_round as j_round,
    build_consensus_rows as j_rows,
    consensus_average as j_average,
    dual_update as j_dual,
)
from d2slam_tpu.parallel.mesh import robot_mesh as j_mesh
from d2slam_tpu.solver import VIOLayout as JLayout
from d2slam_tpu.solver.marginalization import make_pose_prior as j_prior
from d2slam_tpu.utils.synthetic import default_col_free as j_col_free, make_circle_scene as j_scene
from d2slam_tpu_torch.geometry.lie import pose_boxminus
from d2slam_tpu_torch.parallel import (
    ConsensusCarry,
    admm_vio_round,
    build_consensus_rows,
    consensus_average,
    dual_update,
    robot_mesh,
)
from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.lm import lm_solve_vio
from d2slam_tpu_torch.solver.marginalization import make_pose_prior
from d2slam_tpu_torch.solver.state import tree_map
from d2slam_tpu_torch.utils.synthetic import default_col_free, make_circle_scene

torch.set_num_threads(1)  # tests run one process per core (xdist)

JL = JLayout(W=6, C=2, L=64, M=512, N_IMU_SAMPLES=128)
TL = VIOLayout(W=6, C=2, L=64, M=512, N_IMU_SAMPLES=128)
PSI = 460.0 / 1.5
FN_TOL = 1e-9        # single float64 functions
LM_TOL = 1e-6        # of the largest entry, LM with the same decisions
ROUND_TOL = 1e-6     # m / rad per ADMM round
ROUNDS = 5
RHO = 1e4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scenes():
    """The same scene built by both packages (bit-equal by construction,
    asserted) and R=4 perturbed starting states."""
    js = j_scene(JL, n_frames=6, n_landmarks=40, seed=4)
    ts = make_circle_scene(TL, n_frames=6, n_landmarks=40, seed=4)
    np.testing.assert_array_equal(_np(ts["proj"].ray_j), np.asarray(js["proj"].ray_j))
    gt = js["gt_state"]
    rng = np.random.default_rng(3)
    poses, inv_deps = [], []
    for _ in range(4):
        d = np.zeros((JL.W, 6))
        d[1:] = rng.normal(0, 0.03, (JL.W - 1, 6))
        poses.append(np.asarray(jax.vmap(j_boxplus)(gt.poses, jnp.asarray(d))))
        inv_deps.append(np.asarray(gt.inv_dep) * (1 + rng.normal(0, 0.05, JL.L)))
    return js, ts, np.stack(poses), np.stack(inv_deps)


def _batched(state, poses, inv_deps, R, lib):
    """``state`` with R robots' poses / inverse depths on dim 0."""
    if lib == "jax":
        b = jax.tree_util.tree_map(lambda x: jnp.stack([x] * R), state)
        return b._replace(poses=jnp.asarray(poses[:R]), inv_dep=jnp.asarray(inv_deps[:R]))
    b = tree_map(lambda x: torch.stack([x] * R), state)
    return b._replace(poses=torch.as_tensor(poses[:R]), inv_dep=torch.as_tensor(inv_deps[:R]))


@pytest.mark.parametrize("R", [2, 4])
def test_average_and_dual_match_jax(scenes, R):
    _, _, poses, _ = scenes
    rng = np.random.default_rng(R)
    mask = rng.uniform(size=(R, JL.W)) < 0.7
    mask[:, 0] = True
    mask[:, 1] = False          # a frame nobody estimates keeps each robot's own
    mesh = j_mesh(R)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("robot"), P("robot")),
                       out_specs=P("robot"))
    def avg(p, m):
        return j_average(p[0], m[0], "robot")[None]

    ja = np.asarray(avg(jnp.asarray(poses[:R]), jnp.asarray(mask)))
    ta = consensus_average(torch.as_tensor(poses[:R]), torch.as_tensor(mask))
    np.testing.assert_allclose(_np(ta), ja, atol=FN_TOL, rtol=0)
    np.testing.assert_array_equal(_np(ta)[:, 1], poses[:R, 1])
    tilde = rng.normal(0, 0.01, (R, JL.W, 6))
    for r in range(R):
        jd = j_dual(jnp.asarray(poses[r]), jnp.asarray(ja[r]), jnp.asarray(tilde[r]),
                    jnp.asarray(mask[r]), alpha=0.3)
        td = dual_update(torch.as_tensor(poses[r]), ta[r], torch.as_tensor(tilde[r]),
                         torch.as_tensor(mask[r]), alpha=0.3)
        np.testing.assert_allclose(_np(td), np.asarray(jd), atol=FN_TOL, rtol=0)
    # batched over the robots at once: the same duals
    tb = dual_update(torch.as_tensor(poses[:R]), ta, torch.as_tensor(tilde), torch.as_tensor(mask))
    for r in range(R):
        jd = j_dual(jnp.asarray(poses[r]), jnp.asarray(ja[r]), jnp.asarray(tilde[r]),
                    jnp.asarray(mask[r]))
        np.testing.assert_allclose(_np(tb[r]), np.asarray(jd), atol=FN_TOL, rtol=0)
    assert robot_mesh(R, device="cpu").n_robots == R


def test_dual_update_hemisphere_flip():
    """A local quaternion on the other hemisphere of the global one gives
    the same dual as its antipode (the flip of consensus_pose_residual)."""
    g = torch.tensor([[0.1, 0.2, 0.3, 0.0, 0.0, 0.3, 0.95]], dtype=torch.float64)
    g[:, 3:] /= torch.linalg.norm(g[:, 3:])
    loc = g.clone()
    loc[:, 3:] = -g[:, 3:]
    loc[:, 0] += 0.05
    flipped = loc.clone()
    flipped[:, 3:] = g[:, 3:]
    m = torch.ones(1, dtype=torch.bool)
    z = torch.zeros(1, 6, dtype=torch.float64)
    np.testing.assert_allclose(_np(dual_update(loc, g, z, m)), _np(dual_update(flipped, g, z, m)),
                               atol=FN_TOL)


def test_consensus_rows_match_jax(scenes):
    js, ts, poses, inv_deps = scenes
    jstate = js["gt_state"]._replace(poses=jnp.asarray(poses[1]), inv_dep=jnp.asarray(inv_deps[1]))
    tstate = ts["gt_state"]._replace(poses=torch.as_tensor(poses[1]),
                                     inv_dep=torch.as_tensor(inv_deps[1]))
    rng = np.random.default_rng(9)
    ref, tilde = poses[0], rng.normal(0, 0.01, (JL.W, 6))
    active = np.array([True, True, False, True, True, True])
    jb = j_rows(JL, jstate, jnp.asarray(ref), jnp.asarray(tilde), jnp.asarray(active), 50.0, 80.0)
    tb = build_consensus_rows(TL, tstate, torch.as_tensor(ref), torch.as_tensor(tilde),
                              torch.as_tensor(active), 50.0, 80.0)
    for name in ("J", "r", "cost"):
        np.testing.assert_allclose(_np(getattr(tb, name)), np.asarray(getattr(jb, name)),
                                   atol=FN_TOL * 100, rtol=FN_TOL)


_ROUNDS = {}


def jax_rounds(scenes, R):
    """The JAX package's ADMM rounds for R robots (one compile per R per
    module): the carry after each round."""
    if R not in _ROUNDS:
        js, _, poses, inv_deps = scenes
        jgt = js["gt_state"]
        round_fn = functools.partial(
            j_round, JL, axis_name="robot", gravity=js["gravity"],
            col_free=j_col_free(JL, jgt, fix_first_pose=False), proj_sqrt_info=PSI,
            rho_T=RHO, rho_theta=RHO, max_iters=3)
        jprior = j_prior(JL, jgt, frame=0)

        @jax.jit
        @functools.partial(jax.shard_map, mesh=j_mesh(R), in_specs=(P("robot"),) * 3,
                           out_specs=P("robot"))
        def one_round(state_b, tilde_b, mask_b):
            carry = JCarry(state=jax.tree_util.tree_map(lambda x: x[0], state_b),
                           tilde=tilde_b[0])
            new, _ = round_fn(carry, js["imu"], js["proj"], jprior, est_mask=mask_b[0])
            return jax.tree_util.tree_map(lambda x: x[None], JCarry(new.state, new.tilde))

        jc = JCarry(state=_batched(jgt, poses, inv_deps, R, "jax"), tilde=jnp.zeros((R, JL.W, 6)))
        out = []
        for _ in range(ROUNDS):
            jc = one_round(jc.state, jc.tilde, jnp.ones((R, JL.W), bool))
            out.append(jax.tree_util.tree_map(np.asarray, jc))
        _ROUNDS[R] = out
    return _ROUNDS[R]


def test_lm_consensus_matches_jax(scenes):
    """``lm_solve_vio(consensus=)`` of each robot against its solve in the
    JAX package's first ADMM round (R=4): the consensus tuple from the
    port's average and duals of the starting poses."""
    _, ts, poses, inv_deps = scenes
    R = 4
    first = jax_rounds(scenes, R)[0]
    state = _batched(ts["gt_state"], poses, inv_deps, R, "torch")
    est = torch.ones((R, TL.W), dtype=torch.bool)
    gp = consensus_average(state.poses, est)
    tilde = dual_update(state.poses, gp, torch.zeros((R, TL.W, 6), dtype=torch.float64), est)
    for r in range(R):
        sol, rep = lm_solve_vio(
            TL, tree_map(lambda x: x[r], state), ts["imu"], ts["proj"],
            make_pose_prior(TL, ts["gt_state"], frame=0), gravity=ts["gravity"],
            col_free=default_col_free(TL, ts["gt_state"], fix_first_pose=False),
            proj_sqrt_info=PSI, max_iters=3, consensus=(gp[r], tilde[r], est[r], RHO, RHO))
        assert int(rep.accepted) >= 1
        for a, b in ((sol.poses, first.state.poses[r]), (sol.inv_dep, first.state.inv_dep[r])):
            scale = max(np.abs(b).max(), 1e-12)
            np.testing.assert_allclose(_np(a) / scale, b / scale, atol=LM_TOL, rtol=0)


def _spread(poses):
    return max(float(np.abs(_np(pose_boxminus(torch.as_tensor(poses[r]),
                                              torch.as_tensor(poses[0])))).max())
               for r in range(1, len(poses)))


@pytest.mark.parametrize("R", [pytest.param(2, marks=pytest.mark.slow), 4])
def test_admm_rounds_match_jax(scenes, R):
    js, ts, poses, inv_deps = scenes
    jrounds = jax_rounds(scenes, R)
    est = torch.ones((R, TL.W), dtype=torch.bool)
    tc = ConsensusCarry(state=_batched(ts["gt_state"], poses, inv_deps, R, "torch"),
                        tilde=torch.zeros((R, TL.W, 6), dtype=torch.float64))
    tprior = make_pose_prior(TL, ts["gt_state"], frame=0)
    t_col_free = default_col_free(TL, ts["gt_state"], fix_first_pose=False)
    spreads = []
    for jc in jrounds:
        tc, rep = admm_vio_round(
            TL, tc, ts["imu"], ts["proj"], tprior, est_mask=est, gravity=ts["gravity"],
            col_free=t_col_free, proj_sqrt_info=PSI, rho_T=RHO, rho_theta=RHO, max_iters=3)
        assert rep.final_cost.shape == (R,)
        np.testing.assert_allclose(_np(tc.state.poses), jc.state.poses, atol=ROUND_TOL, rtol=0)
        np.testing.assert_allclose(_np(tc.tilde), jc.tilde, atol=ROUND_TOL, rtol=0)
        spreads.append(_spread(_np(tc.state.poses)))
    # the JAX test's pins: agreement for any R, the truth at its R=4
    assert spreads[-1] < 6e-3 and spreads[-1] < 0.2 * spreads[0], spreads
    if R == 4:
        d0 = _np(pose_boxminus(tc.state.poses[0], ts["gt_state"].poses))
        assert np.abs(d0).max() < 5e-2


def test_admm_round_without_comm_is_local():
    """``comm=False`` solves each robot against its own poses: the duals
    stay zero and no robot moves toward another."""
    scene = make_circle_scene(TL, n_frames=6, n_landmarks=40, seed=4)
    gt = scene["gt_state"]
    rng = np.random.default_rng(1)
    poses = np.stack([_np(gt.poses)] * 2)
    poses[1, 1:, :3] += rng.normal(0, 0.02, (TL.W - 1, 3))
    state = tree_map(lambda x: torch.stack([x] * 2), gt)._replace(poses=torch.as_tensor(poses))
    carry = ConsensusCarry(state=state, tilde=torch.zeros((2, TL.W, 6), dtype=torch.float64))
    out, _ = admm_vio_round(
        TL, carry, scene["imu"], scene["proj"], make_pose_prior(TL, gt, frame=0),
        est_mask=torch.ones((2, TL.W), dtype=torch.bool), gravity=scene["gravity"],
        col_free=default_col_free(TL, gt, fix_first_pose=False), proj_sqrt_info=PSI,
        rho_T=RHO, rho_theta=RHO, max_iters=2, comm=False)
    assert float(torch.abs(out.tilde).max()) < 1e-12
    assert torch.isfinite(out.state.poses).all()
