"""The training half of the port's ``frontend/train_frontend.py`` against
the JAX package's on the CPU, float32, from the same parameters (the JAX
package's inits, carried across as numpy) and the same host batch:

- SuperPoint: the detector cross-entropy and the descriptor hinge, each
  within 1e-5 relative of the JAX losses; one Adam step against the JAX
  trainer's (its loss, gradient and ``optax.adam``): the gradients
  within 1e-4 of each leaf's scale, the stepped parameters within 1e-5
  (``_assert_step_matches``);
- NetVLAD: the NT-Xent loss within 1e-5 relative and one Adam step as
  SuperPoint's;
- SuperGlue: the assignment NLL of a pair within 1e-4 relative;
- ``.npz`` files written by either package's ``save_weights`` are read
  by the other's ``load_weights`` bit for bit; the system loads the
  port's trained weights;
- the loss-reduction runs of tests/test_train_frontend.py, ``slow`` as
  there."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d2slam_tpu.frontend import netvlad as jnv
from d2slam_tpu.frontend import superpoint as jsp
from d2slam_tpu.frontend import train_frontend as jtf
from d2slam_tpu_torch.frontend import netvlad as pnv
from d2slam_tpu_torch.frontend import superpoint as psp
from d2slam_tpu_torch.frontend import train_frontend as ptf

torch.set_num_threads(1)  # tests run one process per core (xdist)

REL = 1e-5
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _jax_adam_step(loss_fn, params, *args):
    """The JAX trainers' step: value_and_grad and one optax.adam update
    (jitted, as the trainers run it)."""
    opt = optax.adam(LR)

    @jax.jit
    def step(p, *a):
        (l, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, *a)
        up, _ = opt.update(g, opt.init(p))
        return l, aux, g, optax.apply_updates(p, up)

    l, aux, g, p = step(params, *args)
    return float(l), aux, _np(g), _np(p)


def _port_adam_step(loss_fn, params, *args):
    p = ptf._trainable(params, torch.device("cpu"))
    opt = torch.optim.Adam(ptf._leaves(p), lr=LR)
    loss, aux = loss_fn(p, *args)
    ptf._adam_step(opt, loss)
    grads = jax.tree_util.tree_map(lambda t: t.grad.numpy().copy(), p)
    return float(loss), aux, grads, ptf._export(p)


def _assert_step_matches(port, jax_, params):
    """Gradients within 1e-4 of each leaf's largest JAX gradient; after
    the Adam step, parameters within 1e-5 wherever the gradient is not
    within 1e-3 of that scale of zero (there Adam's first step, lr *
    g / (|g| + eps), follows the sign of rounding noise)."""
    _, _, gp, pp = port
    _, _, gj, pj = jax_
    for (path, a), b, x, y, p0 in zip(*(jax.tree_util.tree_flatten_with_path(gp)[0],),
                                      jax.tree_util.tree_leaves(gj), jax.tree_util.tree_leaves(pp),
                                      jax.tree_util.tree_leaves(pj), jax.tree_util.tree_leaves(params)):
        scale = np.abs(b).max() + 1e-12
        assert np.abs(a - b).max() <= 1e-4 * scale, (path, np.abs(a - b).max(), scale)
        firm = np.abs(b) > 1e-3 * scale
        np.testing.assert_allclose(x[firm], y[firm], rtol=0, atol=1e-5, err_msg=str(path))
        assert np.abs(x - p0).max() <= 1.01 * LR


def _assert_tree_close(a, b, atol):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def superpoint_step():
    """One SuperPoint step through both packages: batch 2 at 64x80."""
    cfg = jsp.SuperPointConfig()
    params = _np(jsp.superpoint_init(jax.random.PRNGKey(0), cfg))
    H, W = 64, 80
    imgs, labs, Hms, labs_w = ptf.superpoint_batch(np.random.default_rng(5), 2, H, W)

    def jloss(p, imgs, labs, Hmats, labs_w):
        warped = jax.vmap(jtf.warp_image)(imgs, Hmats)
        semiA, descA = jsp.superpoint_raw(p, imgs[..., None])
        semiB, descB = jsp.superpoint_raw(p, warped[..., None])
        det = jtf.detector_loss(semiA, labs) + jtf.detector_loss(semiB, labs_w)
        dsc = jnp.mean(jax.vmap(lambda a, b, h: jtf.descriptor_loss(a, b, h, (H, W)))(
            descA, descB, Hmats))
        return det + dsc, (det, dsc)

    j = _jax_adam_step(jloss, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(imgs),
                       jnp.asarray(labs), jnp.asarray(Hms), jnp.asarray(labs_w))
    t = [torch.as_tensor(x) for x in (imgs, labs, Hms, labs_w)]
    pcfg = psp.SuperPointConfig()
    p = _port_adam_step(lambda p_, *a: ptf.superpoint_loss(p_, *a, pcfg), params, *t)
    return j, p, params


def test_superpoint_losses_match_jax(superpoint_step):
    (jl, (jdet, jdsc), _, _), (pl, (pdet, pdsc), _, _), _ = superpoint_step
    assert abs(float(pdet) - float(jdet)) <= REL * abs(float(jdet))
    assert abs(float(pdsc) - float(jdsc)) <= REL * abs(float(jdsc))
    assert abs(pl - jl) <= REL * abs(jl)


def test_superpoint_adam_step_matches_jax(superpoint_step):
    j, p, params = superpoint_step
    _assert_step_matches(p, j, params)


def test_detector_and_descriptor_loss_functions():
    """The two losses alone on random logits / descriptors, against the
    JAX functions (one pair and a batch of two)."""
    rng = np.random.default_rng(0)
    semi = rng.normal(0, 1, (2, 4, 6, 65)).astype(np.float32)
    labs = rng.integers(0, 65, (2, 4, 6)).astype(np.int32)
    labs[0, :2] = 64
    pd = float(ptf.detector_loss(torch.as_tensor(semi), torch.as_tensor(labs)))
    jd = float(jtf.detector_loss(jnp.asarray(semi), jnp.asarray(labs)))
    assert abs(pd - jd) <= REL * abs(jd)
    d = rng.normal(0, 1, (2, 2, 4, 6, 16)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    Hm = np.stack([jtf.random_homography(rng, 32, 48) for _ in range(2)]).astype(np.float32)
    jb = [float(jtf.descriptor_loss(jnp.asarray(d[0, i]), jnp.asarray(d[1, i]),
                                    jnp.asarray(Hm[i]), (32, 48))) for i in range(2)]
    p1 = float(ptf.descriptor_loss(torch.as_tensor(d[0, 0]), torch.as_tensor(d[1, 0]),
                                   torch.as_tensor(Hm[0])))
    pb = float(ptf.descriptor_loss(torch.as_tensor(d[0]), torch.as_tensor(d[1]),
                                   torch.as_tensor(Hm)))
    assert abs(p1 - jb[0]) <= REL * abs(jb[0])
    assert abs(pb - np.mean(jb)) <= REL * abs(np.mean(jb))


def test_netvlad_step_matches_jax():
    cfg = jnv.NetVLADConfig(num_clusters=8, output_dim=512, width_mult=0.5)
    params = _np(jnv.netvlad_init(jax.random.PRNGKey(1), cfg))
    batch = ptf.netvlad_batch(np.random.default_rng(6), 3, 64, 80)

    def jloss(p, imgs, Ha, Hb, gains, biases):
        a = jnp.clip(jax.vmap(jtf.warp_image)(imgs, Ha) * gains[:, 0] + biases[:, 0], 0, 1)
        b = jnp.clip(jax.vmap(jtf.warp_image)(imgs, Hb) * gains[:, 1] + biases[:, 1], 0, 1)
        sim = (jnv.netvlad_apply(p, a[..., None], cfg)
               @ jnv.netvlad_apply(p, b[..., None], cfg).T) / 0.1
        labels = jnp.arange(sim.shape[0])
        loss = 0.5 * (optax.softmax_cross_entropy_with_integer_labels(sim, labels)
                      + optax.softmax_cross_entropy_with_integer_labels(sim.T, labels)).mean()
        return loss, ()

    j = _jax_adam_step(jloss, jax.tree_util.tree_map(jnp.asarray, params),
                       *(jnp.asarray(x) for x in batch))
    p = _port_adam_step(lambda p_, *a: (ptf.netvlad_loss(p_, *a), ()), params,
                        *(torch.as_tensor(x) for x in batch))
    assert abs(p[0] - j[0]) <= REL * abs(j[0])
    _assert_step_matches(p, j, params)


def test_superglue_pair_loss_matches_jax():
    from d2slam_tpu.frontend import superglue as jsg
    from d2slam_tpu_torch.frontend.superglue import SuperGlueConfig

    cfg_j = jsg.SuperGlueConfig(num_layers=1, num_heads=4, sinkhorn_iters=5)
    params = _np(jsg.superglue_init(jax.random.PRNGKey(2), cfg_j))
    sp = psp.SuperPoint(_np(jsp.superpoint_init(jax.random.PRNGKey(0), jsp.SuperPointConfig())),
                        psp.SuperPointConfig(max_keypoints=16, threshold=-1.0), device="cpu")
    bank = ptf.superglue_bank(sp, np.random.default_rng(3), 32, (64, 80))
    sel = np.array([0, 5])
    cfg_p = SuperGlueConfig(num_layers=1, num_heads=4, sinkhorn_iters=5)
    pl = float(ptf.superglue_loss(params, bank, sel, (64, 80), cfg_p))
    a, b, gt = bank
    jls = []
    for i in sel:
        P = jsg.superglue_logP(jax.tree_util.tree_map(jnp.asarray, params),
                               *(jnp.asarray(x[i].numpy()) for x in (a.kpts, a.desc, a.scores,
                                                                      a.valid, b.kpts, b.desc,
                                                                      b.scores, b.valid)),
                               (64, 80), cfg_j)
        w = a.valid[i].numpy().astype(np.float32)
        row = np.asarray(P)[np.arange(16), gt[i].numpy()]
        jls.append(-np.sum(row * w) / max(w.sum(), 1.0))
    assert abs(pl - np.mean(jls)) <= 1e-4 * abs(np.mean(jls))


def test_weight_files_read_both_ways(tmp_path):
    params = _np(jsp.superpoint_init(jax.random.PRNGKey(0), jsp.SuperPointConfig()))
    ptf.save_weights(str(tmp_path / "p.npz"), params)
    jtf.save_weights(str(tmp_path / "j.npz"), jax.tree_util.tree_map(jnp.asarray, params))
    for writer in ("p", "j"):
        for load in (ptf.load_weights, jtf.load_weights, psp.load_params):
            _assert_tree_close(_np(load(str(tmp_path / f"{writer}.npz"))), params, 0.0)
    nv = _np(jnv.netvlad_init(jax.random.PRNGKey(1), jnv.NetVLADConfig(num_clusters=8)))
    ptf.save_weights(str(tmp_path / "nv.npz"), nv)
    _assert_tree_close(_np(pnv.load_params(str(tmp_path / "nv.npz"))), nv, 0.0)
    _assert_tree_close(_np(jtf.load_weights(str(tmp_path / "nv.npz"))), nv, 0.0)


def test_system_loads_trained_weights(tmp_path):
    """tests/test_train_frontend.py::test_system_loads_trained_weights on
    the port, with weights the port's trainers wrote (two steps each)."""
    from d2slam_tpu_torch.config import D2Config
    from d2slam_tpu_torch.geometry.cameras import PinholeParams
    from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig
    from d2slam_tpu_torch.utils.sim import default_extrinsics

    sp, _ = ptf.train_superpoint(steps=1, batch=2, hw=(64, 80), log_every=0, device="cpu")
    nv_cfg = pnv.NetVLADConfig(num_clusters=16, output_dim=1024)
    nv, _ = ptf.train_netvlad(steps=1, batch=2, hw=(64, 80), log_every=0, netvlad_cfg=nv_cfg,
                              device="cpu")
    sp_path, nv_path = str(tmp_path / "sp.npz"), str(tmp_path / "nv.npz")
    ptf.save_weights(sp_path, sp)
    ptf.save_weights(nv_path, nv)
    sys_cfg = SystemConfig(drone_id=0, superpoint_weights=sp_path, netvlad_weights=nv_path,
                           gdesc_dim=1024)
    cams = [PinholeParams.make(220.0, 220.0, 80, 60) for _ in range(2)]
    system = D2SLAMSystem(D2Config(), sys_cfg, default_extrinsics(0.1), cams, device="cpu")
    g = system._frame_gdesc([np.random.default_rng(2).uniform(0, 1, (120, 160))])
    assert g.shape == (1024,)
    np.testing.assert_allclose(np.linalg.norm(g), 1.0, atol=1e-3)
    w = system.tracker.model.conv1a_w.permute(2, 3, 1, 0).numpy()
    np.testing.assert_array_equal(w, sp["conv1a"]["w"])


def test_bf16_stem_refuses_a_gradient():
    params = psp.random_params(0)
    p = ptf._trainable(params, torch.device("cpu"))
    model = psp.SuperPoint(p, psp.SuperPointConfig(compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        model(torch.rand(1, 16, 16))
    with torch.no_grad():
        assert model(torch.rand(1, 16, 16))[0].shape == (1, 65, 2, 2)


@pytest.mark.slow
def test_superpoint_training_reduces_loss():
    _, losses = ptf.train_superpoint(steps=30, batch=8, hw=(80, 96), log_every=0, seed=3,
                                     device="cpu")
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])


@pytest.mark.slow
def test_netvlad_training_reduces_loss():
    cfg = pnv.NetVLADConfig(num_clusters=8, output_dim=512)
    _, losses = ptf.train_netvlad(steps=40, batch=8, hw=(80, 96), log_every=0, netvlad_cfg=cfg,
                                  seed=4, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
