"""The port's estimator checkpoint and the small API gaps it closes,
against the JAX package on the CPU.

* ``utils/checkpoint.py``: after the same short run
  (tests/test_init_eval.py::test_checkpoint_roundtrip's), the files the
  two packages write hold the same keys, and equal arrays (1e-6 on
  states and poses, float64; the prior compared as its normal
  equations, 1e-6 relative); the port's save -> load -> next solve
  round trip; a file the JAX package wrote is refused by the port's
  loader (its landmarks are the JAX package's classes).
* ``IMUBuffer.search_closest`` / ``samples_between`` equal the JAX
  package's; ``D2Estimator.imu_propagated_odometry`` within 1e-6.
"""
import json

import numpy as np
import pytest
import torch

from d2slam_tpu.config import D2Config as JConfig
from d2slam_tpu.imu.buffer import IMUBuffer as JBuffer
from d2slam_tpu.utils.checkpoint import save_estimator as j_save
from d2slam_tpu.utils.sim import CircleSim as JSim
from d2slam_tpu.vins.estimator import D2Estimator as JEstimator
from d2slam_tpu_torch.config import D2Config
from d2slam_tpu_torch.imu.buffer import IMUBuffer
from d2slam_tpu_torch.utils.checkpoint import load_estimator, save_estimator
from d2slam_tpu_torch.utils.sim import CircleSim
from d2slam_tpu_torch.vins.estimator import D2Estimator

torch.set_num_threads(1)  # tests run one process per core (xdist)

N_FRAMES = 5


def _cfg(cls):
    cfg = cls()
    e = cfg.estimator
    e.max_sld_win_size = 6
    e.min_solve_frames = 3
    e.max_lm_slots = 64
    e.max_solve_measurements = 256
    e.max_imu_samples = 128
    e.max_solver_iters = 3
    return cfg


def _feed(est, sim, k0, k1):
    t_prev = (k0 - 1) / sim.frame_hz if k0 else 0.0
    if k0 == 0:
        for (t, a, g) in sim.imu_samples(-0.3, 0.0):
            est.input_imu(t, a, g)
    out = None
    for k in range(k0, k1):
        t = k / sim.frame_hz
        if k:
            for (ts, a, g) in sim.imu_samples(t_prev + 1e-6, t + 1e-6):
                est.input_imu(ts, a, g)
        t_prev = t
        out = est.input_frame(sim.frame(k))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    jest = JEstimator(_cfg(JConfig), JSim().ext)
    test = D2Estimator(_cfg(D2Config), CircleSim().ext, device="cpu")
    _feed(jest, JSim(), 0, N_FRAMES)
    _feed(test, CircleSim(), 0, N_FRAMES)
    paths = dict(jax=str(d / "jax.npz"), port=str(d / "port.npz"))
    j_save(paths["jax"], jest)
    save_estimator(paths["port"], test)
    return dict(jax=jest, port=test, paths=paths)


def _prior_normal(raw):
    J = raw["prior_J"] * raw["prior_row_valid"][:, None]
    r = raw["prior_r"] * raw["prior_row_valid"]
    return J.T @ J, J.T @ r


def test_checkpoint_files_match_jax(runs):
    j = np.load(runs["paths"]["jax"], allow_pickle=False)
    t = np.load(runs["paths"]["port"], allow_pickle=False)
    assert set(t.files) == set(j.files)
    assert "prior_J" in t.files and "state_lm_pos" in t.files
    for k in t.files:
        if k in ("landmarks_pickle", "prior_J", "prior_r", "prior_row_valid"):
            continue
        if k == "meta_json":
            assert json.loads(bytes(t[k])) == json.loads(bytes(j[k]))
            continue
        assert t[k].shape == j[k].shape and t[k].dtype.kind == j[k].dtype.kind, k
        if t[k].dtype == bool:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            np.testing.assert_allclose(t[k], j[k], atol=1e-6, rtol=0, err_msg=k)
    # the prior's rows are an eigenvector square root, unique only up
    # to sign and order: compare its normal equations
    for a, b in zip(_prior_normal(t), _prior_normal(j)):
        scale = max(np.abs(b).max(), 1e-12)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-6, rtol=0)


def test_checkpoint_roundtrip(runs, tmp_path):
    """tests/test_init_eval.py::test_checkpoint_roundtrip on the port:
    a fresh estimator loads the file, holds the same state, and its next
    solve goes on from there exactly as the saved estimator's does."""
    est = runs["port"]
    est2 = D2Estimator(_cfg(D2Config), CircleSim().ext, device="cpu")
    load_estimator(runs["paths"]["port"], est2)
    for name in est.state._fields:
        np.testing.assert_array_equal(getattr(est2.state, name).numpy(),
                                      getattr(est.state, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(est2.prior.J.numpy(), est.prior.J.numpy())
    assert est2.solve_count == est.solve_count and est2.margin_count == est.margin_count
    assert [f.frame_id for f in est2.frames] == [f.frame_id for f in est.frames]
    assert len(est2.lmanager.db) == len(est.lmanager.db)
    # a copy of the saved estimator and the loaded one take the next frame
    est_copy = D2Estimator(_cfg(D2Config), CircleSim().ext, device="cpu")
    load_estimator(runs["paths"]["port"], est_copy)
    for e in (est2, est_copy):
        e.imubuf = IMUBuffer()
        for (t, a, g) in CircleSim().imu_samples(-0.3, (N_FRAMES + 1) / 8.0):
            e.input_imu(t, a, g)
    od = est2.input_frame(CircleSim().frame(N_FRAMES))
    od2 = est_copy.input_frame(CircleSim().frame(N_FRAMES))
    assert od is not None and np.isfinite(od.pose).all()
    np.testing.assert_array_equal(od.pose, od2.pose)
    # and one saved after the next solve loads again
    path = str(tmp_path / "again.npz")
    save_estimator(path, est2)
    est3 = D2Estimator(_cfg(D2Config), CircleSim().ext, device="cpu")
    load_estimator(path, est3)
    assert est3.solve_count == est2.solve_count


def test_port_refuses_jax_checkpoint(runs):
    import pickle

    est = D2Estimator(_cfg(D2Config), CircleSim().ext, device="cpu")
    with pytest.raises(pickle.UnpicklingError, match="d2slam_tpu"):
        load_estimator(runs["paths"]["jax"], est)


def test_imu_propagated_odometry_matches_jax(runs):
    jest, test = runs["jax"], runs["port"]
    t = (N_FRAMES - 1) / 8.0 + 0.05
    jo, to = jest.imu_propagated_odometry(t), test.imu_propagated_odometry(t)
    assert to.stamp == jo.stamp == t
    np.testing.assert_allclose(to.pose, np.asarray(jo.pose), atol=1e-6, rtol=0)
    np.testing.assert_allclose(to.vel, np.asarray(jo.vel), atol=1e-6, rtol=0)
    assert D2Estimator(_cfg(D2Config), CircleSim().ext,
                       device="cpu").imu_propagated_odometry(t) is None


def test_imu_buffer_search_and_slices_match_jax():
    rng = np.random.default_rng(0)
    ts = np.cumsum(rng.uniform(0.002, 0.008, 200))
    bufs = (IMUBuffer(), JBuffer())
    for k, t in enumerate(ts):
        for b in bufs:
            b.add(t, np.full(3, float(k)), np.full(3, -float(k)))
    for q in [-1.0, ts[0], ts[7] + 1e-4, (ts[20] + ts[21]) / 2, ts[-1], ts[-1] + 1.0]:
        assert bufs[0].search_closest(q) == bufs[1].search_closest(q)
    for t0, t1 in [(ts[3], ts[40]), (-1.0, ts[5]), (ts[-3], ts[-1] + 1), (ts[9], ts[9])]:
        for a, b in zip(bufs[0].samples_between(t0, t1), bufs[1].samples_between(t0, t1)):
            np.testing.assert_array_equal(a, b)
