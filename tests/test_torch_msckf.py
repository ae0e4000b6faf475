"""The port's MSCKF (``d2slam_tpu_torch/vins/msckf.py``) against the JAX
filter on the CPU, float64: propagation, clone augmentation and the
landmark update on tests/test_msckf.py's circular flight, every state
tensor and P within 1e-9 of the array's own scale (max abs). The
nullspace rows (H0, r0) are not compared: LAPACK and XLA pick different
bases of the same left null space. Then the four JAX pins on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.vins import msckf as jm
from d2slam_tpu_torch.geometry.lie import quat_mul
from d2slam_tpu_torch.vins import msckf as pm
from tests.test_msckf import IMU_HZ, circle_truth, imu_measurements, make_landmarks, project

torch.set_num_threads(1)  # tests run one process per core (xdist)

REL = 1e-9


def _close(port_state, jax_state, rel=REL):
    for name in jm.MSCKFState._fields:
        a = np.asarray(getattr(port_state, name).cpu().numpy(), np.float64)
        b = np.asarray(getattr(jax_state, name), np.float64)
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-300)
        assert np.abs(a - b).max() <= rel * scale, (name, np.abs(a - b).max(), scale)


def _run(mod, cfg, n_kf, noise_px, seed, tensor, record=None):
    """tests/test_msckf.py::run_filter through ``mod`` (either package)."""
    p0, v0, _, q0 = circle_truth(0.0)
    kw = dict(device="cpu") if mod is pm else {}
    st = mod.msckf_init(cfg, q0=q0, p0=p0, v0=v0, **kw)
    lms = make_landmarks(cfg.max_landmarks, seed)
    rng = np.random.RandomState(seed + 1)
    obs_uv = np.zeros((cfg.max_landmarks, cfg.num_clones, 2))
    obs_mask = np.zeros((cfg.max_landmarks, cfg.num_clones), bool)
    for k in range(n_kf):
        t0, t1 = k * 0.25, (k + 1) * 0.25
        dts, gyrs, accs = (np.array(x) for x in imu_measurements(t0, t1, int(IMU_HZ * 0.25)))
        st = mod.msckf_propagate(st, cfg, tensor(dts), tensor(gyrs), tensor(accs))
        if record is not None:
            record.append(("propagate", k, st))
        st, slot = mod.msckf_augment(st, cfg, t1)
        if record is not None:
            record.append(("augment", k, st))
        p_t, _, _, q_t = circle_truth(t1)
        uv, ok = project(p_t, q_t, lms)
        if noise_px > 0:
            uv = uv + rng.randn(*uv.shape) * noise_px
        obs_uv[:, int(slot)] = uv
        obs_mask[:, int(slot)] = ok
        if k >= 3:
            st = mod.msckf_update(st, cfg, tensor(obs_uv), tensor(obs_mask))
            if record is not None:
                record.append(("update", k, st))
    p_t, v_t, _, q_t = circle_truth(n_kf * 0.25)
    return st, p_t, v_t, q_t


def _port(cfg, n_kf, noise_px=0.0, seed=0, record=None):
    return _run(pm, cfg, n_kf, noise_px, seed, torch.as_tensor, record)


@pytest.fixture(scope="module")
def both():
    """Both filters over 6 noisy keyframes (3 updates), every step kept."""
    cfg_j = jm.MSCKFConfig(num_clones=6, max_landmarks=12)
    cfg_p = pm.MSCKFConfig(num_clones=6, max_landmarks=12)
    rec_j, rec_p = [], []
    prop = jax.jit(lambda s, d, g, a: jm.msckf_propagate(s, cfg_j, d, g, a))
    aug = jax.jit(lambda s, t: jm.msckf_augment(s, cfg_j, t))
    upd = jax.jit(lambda s, uv, m: jm.msckf_update(s, cfg_j, uv, m))

    class J:   # the JAX module with jitted steps
        msckf_init = staticmethod(jm.msckf_init)
        msckf_propagate = staticmethod(lambda s, c, d, g, a: prop(s, d, g, a))
        msckf_augment = staticmethod(lambda s, c, t: aug(s, t))
        msckf_update = staticmethod(lambda s, c, uv, m: upd(s, uv, m))

    _run(J, cfg_j, 6, 1.5e-3, 3, jnp.asarray, rec_j)
    _port(cfg_p, 6, 1.5e-3, 3, rec_p)
    return rec_p, rec_j


@pytest.mark.parametrize("stage", ["propagate", "augment", "update"])
def test_steps_match_jax(both, stage):
    rec_p, rec_j = both
    pairs = [(p, j) for p, j in zip(rec_p, rec_j) if p[0] == stage]
    assert pairs and all(p[:2] == j[:2] for p, j in pairs)
    for (_, _, sp), (_, _, sj) in pairs:
        _close(sp, sj)


def test_update_keeps_landmarks_and_contracts(both):
    """The updates moved the state (not all landmarks gated out) and P
    stays symmetric positive semi-definite."""
    rec_p, _ = both
    before = [s for n, k, s in rec_p if n == "augment" and k == 5][0]
    after = [s for n, k, s in rec_p if n == "update" and k == 5][0]
    assert torch.linalg.norm(after.p - before.p) > 1e-6
    P = after.P.numpy()
    np.testing.assert_array_equal(P, P.T)
    assert np.linalg.eigvalsh(P).min() > -1e-12
    assert np.trace(P[3:6, 3:6]) < np.trace(before.P.numpy()[3:6, 3:6])


def test_propagation_tracks_truth():
    cfg = pm.MSCKFConfig(num_clones=4)
    p0, v0, _, q0 = circle_truth(0.0)
    st = pm.msckf_init(cfg, q0=q0, p0=p0, v0=v0, device="cpu")
    dts, gyrs, accs = (torch.tensor(np.asarray(x)) for x in imu_measurements(0.0, 1.0, int(IMU_HZ)))
    st = pm.msckf_propagate(st, cfg, dts, gyrs, accs)
    p_t, v_t, _, _ = circle_truth(1.0)
    assert np.linalg.norm(st.p.numpy() - p_t) < 5e-3
    assert np.linalg.norm(st.v.numpy() - v_t) < 5e-3
    assert float(st.P[3, 3]) > 1e-6


def test_augment_clones_pose_and_covariance():
    cfg = pm.MSCKFConfig(num_clones=4)
    st = pm.msckf_init(cfg, device="cpu")
    dts, gyrs, accs = (torch.tensor(np.asarray(x)) for x in imu_measurements(0.0, 0.5, 100))
    st = pm.msckf_propagate(st, cfg, dts, gyrs, accs)
    st2, slot = pm.msckf_augment(st, cfg, 0.5)
    s = int(slot)
    np.testing.assert_allclose(st2.clone_p[s].numpy(), st.p.numpy())
    base = 15 + 6 * s
    np.testing.assert_allclose(st2.P[base + 3:base + 6, base + 3:base + 6].numpy(),
                               st.P[3:6, 3:6].numpy(), rtol=1e-10)
    assert np.linalg.eigvalsh(st2.P.numpy()).min() > -1e-12


def test_updates_beat_dead_reckoning():
    cfg = pm.MSCKFConfig(num_clones=8, max_landmarks=24)
    st, p_t, v_t, q_t = _port(cfg, 8)
    assert np.linalg.norm(st.p.numpy() - p_t) < 0.03
    assert np.linalg.norm(st.v.numpy() - v_t) < 0.03
    dq = quat_mul(torch.as_tensor(q_t) * torch.tensor([-1.0, -1, -1, 1], dtype=torch.float64), st.q)
    assert 2 * np.arccos(min(1.0, abs(float(dq[3])))) < 0.02


def test_noisy_updates_stay_bounded():
    cfg = pm.MSCKFConfig(num_clones=8, max_landmarks=24)
    st, p_t, _, _ = _port(cfg, 10, noise_px=1.5e-3, seed=3)
    assert np.linalg.norm(st.p.numpy() - p_t) < 0.15
    p0, v0, _, q0 = circle_truth(0.0)
    dr = pm.msckf_init(cfg, q0=q0, p0=p0, v0=v0, device="cpu")
    for k in range(10):
        dts, gyrs, accs = (torch.tensor(np.asarray(x))
                           for x in imu_measurements(k * 0.25, (k + 1) * 0.25, 50))
        dr = pm.msckf_propagate(dr, cfg, dts, gyrs, accs)
    assert float(torch.trace(st.P[3:6, 3:6])) < float(torch.trace(dr.P[3:6, 3:6]))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.msckf_init(pm.MSCKFConfig())
