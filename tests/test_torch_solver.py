"""Parity of the port's solver (normal equations, LM step, marginal
prior, prior permutation) with the JAX package on the CPU.

The window comes from the JAX package's synthetic circle scene
(numpy-seeded, float64), its state perturbed with seeded noise, and the
same containers go through both packages. Tolerances, relative to the
largest entry of each quantity: 1e-6 for the normal equations, the LM
result and the marginal prior's normal equations (float64 sums taken
in a different order; LM iterates the same accept/reject decisions).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.solver import VIOLayout as JLayout
from d2slam_tpu.solver.lm import lm_solve_vio as j_lm
from d2slam_tpu.solver.marginalization import (
    make_pose_prior as j_pose_prior,
    marginalize as j_marginalize,
    permute_prior_device as j_permute,
    solve_and_marginalize_carry as j_carry,
)
from d2slam_tpu.solver.normal_assembly import build_window_normal as j_normal
from d2slam_tpu.utils.synthetic import default_col_free, make_circle_scene
from d2slam_tpu_torch.imu.preintegration import PreintegrationResult
from d2slam_tpu_torch.solver import state as ts
from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.lm import lm_solve_vio as t_lm
from d2slam_tpu_torch.solver.marginalization import (
    make_pose_prior as t_pose_prior,
    marginalize as t_marginalize,
    permute_prior_device as t_permute,
    solve_and_marginalize_carry as t_carry,
)
from d2slam_tpu_torch.solver.normal_assembly import build_window_normal as t_normal

torch.set_num_threads(1)  # tests run one process per core (xdist)

JL = JLayout(W=6, C=2, L=32, M=128, N_IMU_SAMPLES=64)
TL = VIOLayout(W=6, C=2, L=32, M=128, N_IMU_SAMPLES=64)
PSI = 460.0 / 1.5
KW = dict(proj_sqrt_info=PSI, dep_sqrt_info=20.0, huber_delta=1.0)
REL = 1e-6


def _t(x):
    a = np.array(x)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def _port(nt, cls):
    """JAX NamedTuple -> the port's NamedTuple of the same fields."""
    fields = {}
    for k, v in nt._asdict().items():
        if k not in cls._fields:
            continue  # pos3d landmark positions: not in the port's slice
        if k == "pre":
            v = _port(v, PreintegrationResult)
        elif k == "lin":
            v = _port(v, ts.VIOState)
        else:
            v = None if v is None else _t(v)
        fields[k] = v
    return cls(**fields)


def _close(t, j, rel=REL):
    j = np.asarray(j)
    scale = max(np.abs(j).max(), 1e-12)
    np.testing.assert_allclose(t.numpy() / scale, j / scale, atol=rel, rtol=0)


@pytest.fixture(scope="module")
def window():
    scene = make_circle_scene(JL, n_frames=6, n_landmarks=24, dt_frame=0.12,
                              pix_noise_rad=0.5 / 460.0, dtype=jnp.float64)
    gt = scene["gt_state"]
    rng = np.random.default_rng(0)
    poses = np.array(gt.poses)
    poses[1:6, :3] += rng.normal(0, 0.02, (5, 3))
    sb = np.array(gt.sb) + rng.normal(0, 0.01, (6, 9))
    inv_dep = np.array(gt.inv_dep) * (1 + rng.normal(0, 0.05, JL.L))
    state = gt._replace(poses=jnp.asarray(poses), sb=jnp.asarray(sb),
                        inv_dep=jnp.asarray(inv_dep))
    prior = j_pose_prior(JL, state, frame=0)
    return dict(
        j=(state, scene["imu"], scene["proj"], prior),
        t=(_port(state, ts.VIOState), _port(scene["imu"], ts.ImuMeas),
           _port(scene["proj"], ts.ProjMeas), _port(prior, ts.PriorBlock)),
        gravity=scene["gravity"],
        col_free=default_col_free(JL, gt),
    )


def test_window_normal_matches_jax(window):
    jn = j_normal(JL, *window["j"], gravity=window["gravity"], **KW)
    tn = t_normal(TL, *window["t"], gravity=_t(window["gravity"]), **KW)
    for name in ("H", "g", "hll", "gl", "Hpl", "cost"):
        _close(getattr(tn, name), getattr(jn, name))


def test_lm_solve_matches_jax(window):
    js, jrep = j_lm(JL, *window["j"], gravity=window["gravity"],
                    col_free=window["col_free"], max_iters=5, **KW)
    tsol, trep = t_lm(TL, *window["t"], gravity=_t(window["gravity"]),
                      col_free=_t(window["col_free"]), max_iters=5, **KW)
    assert int(trep.accepted) == int(jrep.accepted)
    _close(trep.final_cost, jrep.final_cost)
    for name in ("poses", "sb", "inv_dep"):
        _close(getattr(tsol, name), getattr(js, name))


def _prior_normal(p):
    J, r, v = (np.asarray(p.J), np.asarray(p.r), np.asarray(p.row_valid))
    J, r = J * v[:, None], r * v
    return J.T @ J, J.T @ r


@pytest.mark.parametrize("mode", [0, 2])
def test_marginal_prior_matches_jax(window, mode):
    """Compared as the prior's normal equations J^T J, J^T r: the
    eigenvector square root is unique only up to sign and order."""
    remove = np.zeros(JL.W, bool)
    remove[0] = True
    jp = j_marginalize(JL, *window["j"], jnp.asarray(remove),
                       gravity=window["gravity"], remove_base_mode=mode, **KW)
    tp = t_marginalize(TL, *window["t"], torch.as_tensor(remove),
                       gravity=_t(window["gravity"]), remove_base_mode=mode, **KW)
    for a, b in zip(_prior_normal(tp), _prior_normal(jp)):
        _close(torch.as_tensor(a), b)


def test_permuted_carry_matches_jax(window):
    perm = np.array([1, 2, 3, 4, 5, -1], np.int32)
    jperm = j_permute(JL, window["j"][3], jnp.asarray(perm))
    tperm = t_permute(TL, window["t"][3], perm)
    _close(tperm.J, jperm.J)
    _close(tperm.lin.poses, jperm.lin.poses)
    assert np.array_equal(tperm.lin.frame_valid.numpy(), np.asarray(jperm.lin.frame_valid))

    remove = np.zeros(JL.W, bool)
    remove[0] = True
    state, imu, proj, prior = window["j"]
    jprior, (jstate, _) = j_carry(
        JL, prior, state, imu, proj, jnp.arange(JL.W, dtype=jnp.int32),
        jnp.asarray(remove), jnp.asarray(True), jnp.asarray(True),
        gravity=window["gravity"], col_free=window["col_free"], max_iters=3, **KW)
    state, imu, proj, prior = window["t"]
    tprior, (tstate, _) = t_carry(
        TL, prior, state, imu, proj, np.arange(TL.W), torch.as_tensor(remove),
        True, True, gravity=_t(window["gravity"]),
        col_free=_t(window["col_free"]), max_iters=3, **KW)
    _close(tstate.poses, jstate.poses)
    for a, b in zip(_prior_normal(tprior), _prior_normal(jprior)):
        _close(torch.as_tensor(a), b)


def _pose(rng):
    q = rng.normal(size=4)
    return np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])


@pytest.mark.parametrize("name", [
    "projection_two_frame_one_cam", "projection_two_frame_two_cam",
    "projection_one_frame_two_cam", "projection_depth_residual",
    "consensus_pose_residual", "relpose_residual", "relpose4d_residual",
    "gravity_prior_residual", "tangent_base_of",
])
def test_factor_residuals_match_jax(name):
    """Each residual of the factor library, one factor, float64, 1e-9."""
    from d2slam_tpu.factors import residuals as jr
    from d2slam_tpu_torch.factors import residuals as tr

    rng = np.random.default_rng(7)
    ray = lambda: (lambda v: v / np.linalg.norm(v))(rng.normal(size=3) + [0, 0, 3])
    pi, pj, ei, ej = _pose(rng), _pose(rng), _pose(rng), _pose(rng)
    proj = [ray(), ray(), 0.1 * rng.normal(size=3), 0.1 * rng.normal(size=3),
            np.float64(0.01), np.float64(-0.02), np.array(jr.tangent_base_of(jnp.asarray(ray())))]
    args = {
        "projection_two_frame_one_cam": [pi, pj, ei, np.float64(0.3), np.float64(0.005)] + proj,
        "projection_two_frame_two_cam": [pi, pj, ei, ej, np.float64(0.3), np.float64(0.005)] + proj,
        "projection_one_frame_two_cam": [ei, ej, np.float64(0.3), np.float64(0.005)] + proj,
        "projection_depth_residual": [pi, pj, ei, np.float64(0.3), np.float64(0.005)] + proj
        + [np.float64(4.0)],
        "consensus_pose_residual": [pi, pj, rng.normal(size=3), rng.normal(size=3), 2.0, 3.0],
        "relpose_residual": [pi, pj, _pose(rng), np.diag(rng.uniform(1, 2, 6))],
        "relpose4d_residual": [pi, pj, _pose(rng), np.diag(rng.uniform(1, 2, 4))],
        "gravity_prior_residual": [pi, ray(), np.eye(3) * 5.0],
        "tangent_base_of": [ray()],
    }[name]
    arr = (np.ndarray, np.floating)
    t = getattr(tr, name)(*[torch.as_tensor(a) if isinstance(a, arr) else a for a in args])
    j = getattr(jr, name)(*[jnp.asarray(a) if isinstance(a, arr) else a for a in args])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-9, rtol=0)
