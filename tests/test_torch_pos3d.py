"""Parity of the port's solver options with the JAX package on the CPU:
world-position landmarks (``landmark_param="pos3d"``: the 3x3 block
normal equations, their Schur complement in LM and in the marginal
prior, the estimator's packing), the Powell dogleg step
(``method="dogleg"``) and the dense-row assembly that cross-checks both
normal assemblies.

The window is the JAX package's synthetic circle scene (numpy-seeded,
float64), its state perturbed with seeded noise. Tolerances, relative
to the largest entry of each quantity: 1e-6 for normal equations, for
single solves and for the marginal prior's normal equations (float64
sums in another order); 1e-6 m on the poses of a short estimator run on
the same features.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.config import D2Config as JConfig
from d2slam_tpu.solver import VIOLayout as JLayout
from d2slam_tpu.solver import vio_assembly as jva
from d2slam_tpu.solver.lm import lm_solve_vio as j_lm
from d2slam_tpu.solver.marginalization import make_pose_prior as j_pose_prior
from d2slam_tpu.solver.marginalization import marginalize as j_marginalize
from d2slam_tpu.solver.normal_assembly import build_window_normal as j_normal
from d2slam_tpu.utils.sim import CircleSim as JSim
from d2slam_tpu.utils.synthetic import default_col_free, make_circle_scene
from d2slam_tpu.vins.estimator import D2Estimator as JEstimator
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.geometry.lie import pose_boxminus, pose_boxplus
from d2slam_tpu_torch.imu.preintegration import PreintegrationResult
from d2slam_tpu_torch.solver import state as ts
from d2slam_tpu_torch.solver import vio_assembly as tva
from d2slam_tpu_torch.solver.layout import VIOLayout
from d2slam_tpu_torch.solver.lm import lm_solve_vio as t_lm
from d2slam_tpu_torch.solver.marginalization import make_pose_prior as t_pose_prior
from d2slam_tpu_torch.solver.marginalization import marginalize as t_marginalize
from d2slam_tpu_torch.solver.normal_assembly import (
    build_proj_normal,
    build_proj_normal_pos3d,
)
from d2slam_tpu_torch.solver.normal_assembly import build_window_normal as t_normal
from d2slam_tpu_torch.solver.normal_assembly import compact_cols, embed_cols
from d2slam_tpu_torch.utils.sim import CircleSim
from d2slam_tpu_torch.vins.estimator import D2Estimator

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
        if k == "pre":
            v = _port(v, PreintegrationResult)
        elif k == "lin":
            v = _port(v, ts.VIOState)
        else:
            v = None if v is None else _t(v)
        fields[k] = v
    return cls(**fields)


def _close(t, j, rel=REL):
    t, j = np.asarray(t), np.asarray(j)
    scale = max(np.abs(j).max(), 1e-12)
    np.testing.assert_allclose(t / scale, j / scale, atol=rel, rtol=0)


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
    lm_pos = np.array(gt.lm_pos) + rng.normal(0, 0.05, (JL.L, 3))
    state = gt._replace(poses=jnp.asarray(poses), sb=jnp.asarray(sb),
                        inv_dep=jnp.asarray(inv_dep), lm_pos=jnp.asarray(lm_pos))
    prior = j_pose_prior(JL, state, frame=0)
    return dict(
        gt=(gt, _port(gt, ts.VIOState)),
        j=(state, scene["imu"], scene["proj"], prior),
        t=(_port(state, ts.VIOState), _port(scene["imu"], ts.ImuMeas),
           _port(scene["proj"], ts.ProjMeas), _port(prior, ts.PriorBlock)),
        gravity=scene["gravity"],
        col_free=default_col_free(JL, gt),
    )


def _rows_normal(rows, L):
    """(H, g, hll, gl, Hpl in the global layout) of dense rows."""
    J, r, Jl, lm = (np.asarray(x) for x in (rows.J, rows.r, rows.Jl, rows.lm))
    lm3 = Jl.ndim == 2
    hll = np.zeros((L, 3, 3) if lm3 else L)
    gl = np.zeros((L, 3) if lm3 else L)
    Hpl = np.zeros((L, 3, J.shape[1]) if lm3 else (L, J.shape[1]))
    if lm3:
        np.add.at(hll, lm, Jl[:, :, None] * Jl[:, None, :])
        np.add.at(gl, lm, Jl * r[:, None])
        np.add.at(Hpl, lm, Jl[:, :, None] * J[:, None, :])
    else:
        np.add.at(hll, lm, Jl * Jl)
        np.add.at(gl, lm, Jl * r)
        np.add.at(Hpl, lm, J * Jl[:, None])
    return dict(H=J.T @ J, g=J.T @ r, hll=hll, gl=gl, Hpl=Hpl)


@pytest.mark.parametrize("pos3d", [False, True], ids=["inv_dep", "pos3d"])
def test_dense_rows_match_jax(window, pos3d):
    """The dense rows (inverse-depth and pos3d) against the JAX package's."""
    name = "build_proj_rows_pos3d" if pos3d else "build_proj_rows"
    j_rows = getattr(jva, name)(JL, window["j"][0], window["j"][2], PSI, 20.0, 1.0)
    t_rows = getattr(tva, name)(TL, window["t"][0], window["t"][2], PSI, 20.0, 1.0)
    for field in ("J", "r", "Jl", "cost"):
        _close(getattr(t_rows, field), getattr(j_rows, field))
    np.testing.assert_array_equal(t_rows.lm.numpy(), np.asarray(j_rows.lm))
    np.testing.assert_array_equal(t_rows.lm_used.numpy(), np.asarray(j_rows.lm_used))


@pytest.mark.parametrize("pos3d", [False, True], ids=["inv_dep", "pos3d"])
def test_dense_rows_check_normal_assembly(window, pos3d):
    """The port's block normal equations equal rows^T rows of its own
    dense rows, landmark blocks included (the JAX package's
    tests/test_normal_assembly.py check, on the port)."""
    state, _, proj, _ = window["t"]
    rows = (tva.build_proj_rows_pos3d if pos3d else tva.build_proj_rows)(
        TL, state, proj, PSI, 20.0, 1.0)
    ref = _rows_normal(rows, TL.L)
    n = (build_proj_normal_pos3d if pos3d else build_proj_normal)(
        TL, state, proj, PSI, 20.0, 1.0)
    for name in ("H", "g", "hll", "gl"):
        _close(getattr(n, name), ref[name])
    _close(embed_cols(n.Hpl, compact_cols(TL), TL.D_pad), ref["Hpl"])
    _close(n.cost, np.sum(rows.cost.numpy()))


def test_full_rows_check_window_normal(window):
    """IMU + projection + prior rows assembled (landmark-free blocks get
    zero pos3d columns) equal the pos3d window normal equations."""
    state, imu, proj, prior = window["t"]
    g = _t(window["gravity"])
    rows = tva.assemble_full_rows((
        tva.build_imu_rows(TL, state, imu, g),
        tva.build_proj_rows_pos3d(TL, state, proj, PSI, 20.0, 1.0),
        tva.build_prior_rows(TL, state, prior),
    ))
    assert rows.Jl.shape == (rows.r.shape[0], 3)
    ref = _rows_normal(rows, TL.L)
    n = t_normal(TL, state, imu, proj, prior, gravity=g, landmark_param="pos3d", **KW)
    for name in ("H", "g", "hll", "gl"):
        _close(getattr(n, name), ref[name])
    _close(n.cost, np.sum(rows.cost.numpy()))


def test_pos3d_window_normal_matches_jax(window):
    jn = j_normal(JL, *window["j"], gravity=window["gravity"],
                  landmark_param="pos3d", **KW)
    tn = t_normal(TL, *window["t"], gravity=_t(window["gravity"]),
                  landmark_param="pos3d", **KW)
    for name in ("H", "g", "hll", "gl", "Hpl", "cost"):
        assert getattr(tn, name).shape == np.asarray(getattr(jn, name)).shape
        _close(getattr(tn, name), getattr(jn, name))


@pytest.mark.parametrize("param,method", [("pos3d", "lm"), ("inv_dep", "dogleg")])
def test_solve_matches_jax(window, param, method):
    js, jrep = j_lm(JL, *window["j"], gravity=window["gravity"],
                    col_free=window["col_free"], max_iters=5,
                    landmark_param=param, method=method, **KW)
    tsol, trep = t_lm(TL, *window["t"], gravity=_t(window["gravity"]),
                      col_free=_t(window["col_free"]), max_iters=5,
                      landmark_param=param, method=method, **KW)
    assert int(trep.accepted) == int(jrep.accepted) >= 1
    _close(trep.final_cost, jrep.final_cost)
    for name in ("poses", "sb", "lm_pos" if param == "pos3d" else "inv_dep"):
        _close(getattr(tsol, name), getattr(js, name))


def test_dogleg_converges_from_perturbation():
    """tests/test_solver.py::test_dogleg_converges_from_perturbation on
    the port: from perturbed poses, biases and depths the dogleg reaches
    the ground truth within the JAX test's 5e-3 pins."""
    layout = JLayout(W=6, C=2, L=64, M=512, N_IMU_SAMPLES=128)
    scene = make_circle_scene(layout, n_frames=6, n_landmarks=40)
    gt = scene["gt_state"]
    rng = np.random.default_rng(11)
    dpose = np.zeros((layout.W, 6))
    dpose[1:6] = rng.normal(0, 0.05, (5, 6))
    tgt = _port(gt, ts.VIOState)
    pert = tgt._replace(
        poses=pose_boxplus(tgt.poses, torch.as_tensor(dpose)),
        sb=tgt.sb + torch.as_tensor(rng.normal(0, 0.05, (layout.W, 9))),
        inv_dep=tgt.inv_dep * torch.as_tensor(1 + rng.normal(0, 0.1, layout.L)),
    )
    tl = VIOLayout(W=6, C=2, L=64, M=512, N_IMU_SAMPLES=128)
    new_state, report = t_lm(
        tl, pert, _port(scene["imu"], ts.ImuMeas), _port(scene["proj"], ts.ProjMeas),
        None, gravity=_t(scene["gravity"]),
        col_free=_t(default_col_free(layout, gt)), proj_sqrt_info=PSI,
        max_iters=10, method="dogleg")
    assert float(report.final_cost) < 1e-2 * float(report.initial_cost)
    err = pose_boxminus(new_state.poses, tgt.poses).numpy()[np.asarray(gt.frame_valid)]
    assert np.abs(err[:, :3]).max() < 5e-3
    assert np.abs(err[:, 3:]).max() < 5e-3


def _prior_normal(p):
    J, r, v = (np.asarray(p.J), np.asarray(p.r), np.asarray(p.row_valid))
    J, r = J * v[:, None], r * v
    return J.T @ J, J.T @ r


@pytest.mark.parametrize("mode", [0, 2])
def test_pos3d_marginal_prior_matches_jax(window, mode):
    remove = np.zeros(JL.W, bool)
    remove[0] = True
    jp = j_marginalize(JL, *window["j"], jnp.asarray(remove), gravity=window["gravity"],
                       landmark_param="pos3d", remove_base_mode=mode, **KW)
    tp = t_marginalize(TL, *window["t"], torch.as_tensor(remove),
                       gravity=_t(window["gravity"]), landmark_param="pos3d",
                       remove_base_mode=mode, **KW)
    for a, b in zip(_prior_normal(tp), _prior_normal(jp)):
        _close(a, b)


def test_port_pose_prior_matches_jax(window):
    jp = j_pose_prior(JL, window["j"][0], frame=2)
    tp = t_pose_prior(TL, window["t"][0], frame=2)
    np.testing.assert_array_equal(tp.J.numpy(), np.asarray(jp.J))
    np.testing.assert_array_equal(tp.row_valid.numpy(), np.asarray(jp.row_valid))


# ---------------------------------------------------------------------------
# the estimator with pos3d landmarks (tests/test_pos3d.py on both packages)
# ---------------------------------------------------------------------------

N_FRAMES = 16


def _est_config(cls, landmark_param):
    cfg = cls()
    e = cfg.estimator
    e.landmark_param = landmark_param
    e.max_sld_win_size = 8
    e.min_solve_frames = 4
    e.max_lm_slots = 128
    e.max_solve_measurements = 512
    e.max_imu_samples = 128
    e.max_solver_iters = 5
    return cfg


def _run(est, sim):
    for (t, a, g) in sim.imu_samples(-0.3, 0.0):
        est.input_imu(t, a, g)
    poses, gts, t_prev = [], [], 0.0
    for k in range(N_FRAMES):
        t = k / sim.frame_hz
        if k:
            for (ts_, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts_, a, g)
        t_prev = t
        od = est.input_frame(sim.frame(k))
        if od is not None:
            poses.append(np.asarray(od.pose, np.float64))
            gts.append(sim.gt_pose(t)[0])
    return np.stack(poses), np.stack(gts)


def _ate(poses, gts):
    from d2slam_tpu_torch.utils import np_lie
    T = np_lie.pose_compose(gts[0], np_lie.pose_inverse(poses[0]))
    d = [np.linalg.norm(np_lie.pose_compose(T, p)[:3] - g[:3])
         for p, g in zip(poses, gts)]
    return float(np.sqrt(np.mean(np.square(d))))


@pytest.fixture(scope="module")
def pos3d_runs():
    jest = JEstimator(_est_config(JConfig, "pos3d"), JSim().ext)
    test = D2Estimator(_est_config(D2Config, "pos3d"), CircleSim().ext, device="cpu")
    inv = D2Estimator(_est_config(D2Config, "inv_dep"), CircleSim().ext, device="cpu")
    return dict(jax=(jest, _run(jest, JSim())), port=(test, _run(test, CircleSim())),
                inv=(inv, _run(inv, CircleSim())))


def test_pos3d_estimator_matches_jax(pos3d_runs):
    """The same 16 noiseless frames through both estimators: poses
    within 1e-6 m, the same solve / marginalization counts, and the
    port holds tests/test_pos3d.py's pins (ATE < 0.03 m, within 0.03 m
    of the inverse-depth run)."""
    jest, (jp, _) = pos3d_runs["jax"]
    test, (tp, gts) = pos3d_runs["port"]
    assert test.solve_count == jest.solve_count >= 10
    assert test.margin_count == jest.margin_count >= 5
    np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)
    rmse = _ate(tp, gts)
    assert rmse < 0.03, rmse
    assert abs(_ate(*pos3d_runs["inv"][1]) - rmse) < 0.03


def test_pos3d_landmark_geometry_gauge_invariant(pos3d_runs):
    """Solved pos3d landmark geometry matches the simulated world:
    median pairwise-distance error < 0.05 m (tests/test_pos3d.py)."""
    from d2slam_tpu_torch.vins.landmark_manager import ESTIMATED

    test, _ = pos3d_runs["port"]
    sim = CircleSim()
    ids, pos = [], []
    for lm in test.lmanager.db.values():
        if lm.position is not None and lm.flag == ESTIMATED and lm.lm_id < len(sim.lms):
            ids.append(lm.lm_id)
            pos.append(lm.position)
    assert len(ids) > 30
    pos, gt = np.asarray(pos), sim.lms[ids]
    derr = [abs(np.linalg.norm(pos[i] - pos[i + 1]) - np.linalg.norm(gt[i] - gt[i + 1]))
            for i in range(0, len(ids) - 1, 2)]
    assert np.median(derr) < 0.05, np.median(derr)
