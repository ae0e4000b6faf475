"""The port's PnP RANSAC and loop detector against the JAX package on the
CPU, mirroring tests/test_pnp_loop.py:

* host ``ransac_pnp``, ``ransac_pnp_body`` and ``ransac_homography``: the
  same numpy code, so the same inlier masks and poses to 1e-9;
* the batched path (one torch program of batched SVDs, here on the CPU)
  against the JAX package's batched kernel: the same best inlier count,
  the pose within 1e-3 m and 1e-3 rad (singular vectors' signs differ
  between LAPACK, cuSOLVER and XLA; the fix-ups make the pose agree);
* ``LoopDetector.detect``: the same ``LoopEdge`` (frame ids, inliers,
  ``rel_pose`` to 1e-6) end to end, with the homography gate, through
  the gravity gate and with the automatic retrieval threshold;
* the port's matching of multi-view entries per camera-direction pair:
  matches where the pooled ratio test of all views finds none, the
  winning view offset, the cross-view check, one match per landmark
  (the loop's inliers count landmarks), one learned-matcher call per
  view pair, and a single-view pair matched as one call, as before.
"""
import numpy as np
import pytest
import torch

import d2slam_tpu.frontend.loop_detector as jld
import d2slam_tpu.frontend.pnp as jpnp
import d2slam_tpu_torch.frontend.loop_detector as pld
import d2slam_tpu_torch.frontend.pnp as ppnp
from d2slam_tpu_torch.frontend.matching import match_descriptors
from d2slam_tpu.utils import np_lie
from d2slam_tpu.utils.sim import default_extrinsics
from tests.test_pnp_loop import make_pnp_scene

torch.set_num_threads(1)  # tests run one process per core (xdist)


def _planar_scene():
    rng = np.random.default_rng(9)
    n = 60
    pts = np.concatenate([rng.uniform(-4, 4, (n, 1)), rng.uniform(-2, 2, (n, 1)),
                          np.full((n, 1), 8.0)], axis=1)
    T_true = np.array([0.4, -0.2, 0.5, 0, np.sin(0.1), 0, np.cos(0.1)])
    R = np_lie.quat_to_rotmat(T_true[3:])
    pc = (pts - T_true[:3]) @ R
    return T_true, pc / np.linalg.norm(pc, axis=1, keepdims=True), pts


def _scene(name):
    if name == "planar":
        T, rays, pts = _planar_scene()
        return T, rays, pts, dict(thresh=2.0 / 460.0, min_inliers=30)
    T, rays, pts, _ = make_pnp_scene(seed=int(name))
    return T, rays, pts, dict(thresh=2e-3, min_inliers=20)


SCENES = ["0", "4", "9", "planar"]


@pytest.mark.parametrize("scene", SCENES)
def test_host_ransac_pnp_equals_jax(scene):
    _, rays, pts, kw = _scene(scene)
    Tj, inl_j = jpnp.ransac_pnp(rays, pts, **kw)
    Tp, inl_p = ppnp.ransac_pnp(rays, pts, **kw)
    assert Tj is not None and Tp is not None
    np.testing.assert_array_equal(inl_p, inl_j)
    np.testing.assert_allclose(Tp, Tj, atol=1e-9)


def test_host_ransac_pnp_body_equals_jax():
    T, rays, pts, _ = make_pnp_scene(n=80, outliers=8, seed=9)
    ext = default_extrinsics(baseline=0.2)
    cam = np.zeros(len(rays), np.int32)
    cam[::5] = 1   # a second camera's share: the body pose joins both
    Tj, inl_j = jpnp.ransac_pnp_body(rays, cam, ext, pts, thresh=2e-3, min_inliers=20)
    Tp, inl_p = ppnp.ransac_pnp_body(rays, cam, ext, pts, thresh=2e-3, min_inliers=20)
    assert Tj is not None
    np.testing.assert_array_equal(inl_p, inl_j)
    np.testing.assert_allclose(Tp, Tj, atol=1e-9)


def test_host_ransac_homography_equals_jax():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.5, 0.5, (60, 2))
    H = np.array([[1.02, 0.01, 0.03], [-0.01, 0.98, -0.02], [0.05, -0.03, 1.0]])
    hb = np.concatenate([pts, np.ones((60, 1))], 1) @ H.T
    pa = hb[:, :2] / hb[:, 2:]
    pa[:10] += rng.uniform(0.2, 0.4, (10, 2))
    for n in (60, 3):
        np.testing.assert_array_equal(ppnp.ransac_homography(pa[:n], pts[:n], thresh=0.02),
                                      jpnp.ransac_homography(pa[:n], pts[:n], thresh=0.02))


def _pose_close(Ta, Tb, pos_tol=1e-3, rot_tol=1e-3):
    dq = np_lie.quat_mul(np_lie.quat_conj(Ta[3:]), Tb[3:])
    ang = 2 * np.arccos(min(1.0, abs(dq[3])))
    return np.linalg.norm(Ta[:3] - Tb[:3]) < pos_tol and ang < rot_tol


@pytest.mark.parametrize("scene", SCENES)
def test_batched_pnp_matches_jax(scene):
    import jax.numpy as jnp

    T_true, rays, pts, kw = _scene(scene)
    # the raw batched kernels on the same padded inputs and samples
    n, iters = len(rays), 100
    N_pad = max(128, int(2 ** np.ceil(np.log2(n))))
    idx = np.stack([np.random.default_rng(0).choice(n, 6, replace=False) for _ in range(iters)])
    rp = np.zeros((N_pad, 3), np.float32)
    pp = np.zeros((N_pad, 3), np.float32)
    rp[:n], pp[:n] = rays, pts
    va = np.arange(N_pad) < n
    _, _, n_j = jpnp._ransac_pnp_device_kernel(jnp.asarray(rp), jnp.asarray(pp), jnp.asarray(va),
                                                jnp.asarray(idx), kw["thresh"])
    _, _, n_p = ppnp._ransac_pnp_device_kernel(torch.as_tensor(rp), torch.as_tensor(pp),
                                                torch.as_tensor(va), torch.as_tensor(idx),
                                                kw["thresh"])
    assert int(n_p.max()) == int(np.asarray(n_j).max())
    # the search's best pose, then the whole ransac_pnp (host refinement)
    Tj = jpnp._ransac_pnp_device(rays, pts, kw["thresh"], iters, 0)
    Tp = ppnp._ransac_pnp_device(rays, pts, kw["thresh"], iters, 0, torch.device("cpu"))
    assert _pose_close(Tp, Tj)
    Tj, inl_j = jpnp.ransac_pnp(rays, pts, device=True, **kw)
    Tp, inl_p = ppnp.ransac_pnp(rays, pts, device="cpu", **kw)
    assert inl_p.sum() == inl_j.sum()
    assert _pose_close(Tp, Tj)
    assert _pose_close(Tp, T_true, 0.02, 0.02)


def test_batched_pnp_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, rays, pts, kw = _scene("0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppnp.ransac_pnp(rays, pts, device=True, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pld.LoopDetector(pld.LoopDetectorConfig(), default_extrinsics())


# ---------------------------------------------------------------------------
# loop detector scenarios (tests/test_pnp_loop.py), run through both packages
# ---------------------------------------------------------------------------


def _entry(mod, frame_id, pose, rays, desc, lms, drone_id=0):
    n = len(rays)
    return mod.KeyframeEntry(
        frame_id=frame_id, drone_id=drone_id, stamp=0.0, pose=pose, kpt_rays=rays,
        kpt_cam=np.zeros(n, np.int32), kpt_desc=desc, kpt_valid=np.ones(n, bool),
        lm_positions=lms)


def _rays(lms, pose, ext, cam=0):
    T = np_lie.pose_compose(pose, ext[cam])
    pc = (lms - T[:3]) @ np_lie.quat_to_rotmat(T[3:])
    return pc / np.linalg.norm(pc, axis=1, keepdims=True)


def _loop_scene(planar: bool):
    """The old keyframe with its landmarks, and a query keyframe seeing
    them again from a moved (and VIO-drifted) pose; with ``planar`` the
    landmarks lie on a wall and 15 query descriptors mimic wrong ones."""
    rng = np.random.default_rng(5 if planar else 3)
    ext = default_extrinsics()
    n = 80
    x = np.full((n, 1), 10.0) if planar else rng.uniform(6, 14, (n, 1))
    y = rng.uniform(-5, 5, (n, 1))
    z = rng.uniform(-1, 3, (n, 1)) if planar else rng.uniform(0, 4, (n, 1))
    lms = np.concatenate([x, y, z], axis=1)
    pose_old = np.array([0.0, 0, 0, 0, 0, 0, 1])
    desc = rng.normal(0, 1, (n, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    gdesc = rng.normal(0, 1, 4096).astype(np.float32)
    gdesc /= np.linalg.norm(gdesc)
    yaw = 0.05 if planar else 0.1
    pose_new = np.array([1.0, 0.5, 0.1 if planar else 0.2, 0, 0, np.sin(yaw), np.cos(yaw)])
    desc_new = desc + rng.normal(0, 0.03, desc.shape).astype(np.float32)
    if planar:
        desc_new[:15] = desc[rng.permutation(15)] + rng.normal(0, 0.03, (15, 256))
    desc_new /= np.linalg.norm(desc_new, axis=1, keepdims=True)
    gdesc_new = gdesc + rng.normal(0, 0.005, 4096).astype(np.float32)
    gdesc_new /= np.linalg.norm(gdesc_new)
    pose_vio = pose_new.copy()
    pose_vio[:3] += [0.3, -0.2, 0.1]
    return dict(ext=ext, lms=lms, pose_old=pose_old, rays_old=_rays(lms, pose_old, ext),
                desc=desc, gdesc=gdesc, pose_vio=pose_vio, rays_new=_rays(lms, pose_new, ext),
                desc_new=desc_new, gdesc_new=gdesc_new)


def _detect_both(sc, cfg_kw, query_pose=None, query_gdesc=None):
    edges = []
    for mod, kw in ((jld, {}), (pld, dict(device="cpu"))):
        det = mod.LoopDetector(mod.LoopDetectorConfig(min_gap_frames=2, min_inliers=20,
                                                      min_match_per_dir=10, **cfg_kw),
                               sc["ext"], **kw)
        det.add_keyframe(_entry(mod, 0, sc["pose_old"], sc["rays_old"], sc["desc"], sc["lms"]),
                         sc["gdesc"])
        n = len(sc["lms"])
        entry = _entry(mod, 10, sc["pose_vio"] if query_pose is None else query_pose,
                       sc["rays_new"], sc["desc_new"], np.full((n, 3), np.nan))
        edges.append(det.detect(entry, sc["gdesc_new"] if query_gdesc is None else query_gdesc))
    return edges


def _assert_same_edge(ej, ep):
    assert ej is not None and ep is not None
    assert (ep.frame_id_a, ep.frame_id_b, ep.drone_id_a, ep.drone_id_b, ep.inliers) == \
        (ej.frame_id_a, ej.frame_id_b, ej.drone_id_a, ej.drone_id_b, ej.inliers)
    np.testing.assert_allclose(ep.rel_pose, ej.rel_pose, atol=1e-6)
    assert (ep.pos_cov, ep.yaw_cov) == (ej.pos_cov, ej.yaw_cov)


def test_loop_detector_end_to_end_equals_jax():
    sc = _loop_scene(planar=False)
    ej, ep = _detect_both(sc, {})
    _assert_same_edge(ej, ep)
    assert ep.inliers >= 50
    g = np.random.default_rng(0).normal(0, 1, 4096).astype(np.float32)
    assert _detect_both(sc, {}, query_gdesc=g / np.linalg.norm(g)) == [None, None]


def test_loop_detector_homography_gate_equals_jax():
    sc = _loop_scene(planar=True)
    ej, ep = _detect_both(sc, dict(enable_homography_test=True))
    _assert_same_edge(ej, ep)


def test_loop_detector_gravity_gate_equals_jax(monkeypatch):
    """A PnP result tilted by 10 degrees of pitch fails the gravity gate in
    both packages; untilted, both accept the same edge."""
    sc = _loop_scene(planar=False)
    sc["rays_new"], sc["desc_new"], sc["gdesc_new"] = sc["rays_old"], sc["desc"], sc["gdesc"]
    _assert_same_edge(*_detect_both(sc, {}, query_pose=sc["pose_old"]))
    tilt = np.array([0, 0, 0, 0, np.sin(0.09), 0, np.cos(0.09)])
    for mod in (jld, pld):
        real = mod.ransac_pnp_body

        def tilted(*a, real=real, **k):
            T, inl = real(*a, **k)
            return (None, inl) if T is None else (np_lie.pose_compose(T, tilt), inl)

        monkeypatch.setattr(mod, "ransac_pnp_body", tilted)
    assert _detect_both(sc, {}, query_pose=sc["pose_old"]) == [None, None]


def test_loop_detector_auto_threshold_equals_jax():
    """auto_thres: the impostor statistics and the gate they calibrate
    evolve alike over the same query stream."""
    rng = np.random.default_rng(0)
    ext = default_extrinsics()

    def unit(v):
        return (v / np.linalg.norm(v)).astype(np.float32)

    base = [unit(rng.normal(0, 1, 4096)) for _ in range(8)]
    queries = [unit(rng.normal(0, 1, 4096)) for _ in range(30)]
    revisit = unit(base[3] + 0.05 * rng.normal(0, 1, 4096))
    rays = np.tile([[1.0, 0, 0]], (4, 1))
    desc = np.eye(4, 8, dtype=np.float32)
    out = []
    for mod, kw in ((jld, {}), (pld, dict(device="cpu"))):
        cfg = mod.LoopDetectorConfig(netvlad_thres=0.8, auto_thres=True, auto_thres_sigma=3.0,
                                     auto_thres_min_samples=10, min_gap_frames=2)
        det = mod.LoopDetector(cfg, ext, **kw)
        for i, g in enumerate(base):
            det.add_keyframe(_entry(mod, 100 + i, np.eye(1, 7, 6)[0], rays, desc,
                                    np.full((4, 3), np.nan)), g)
        thres = []
        for i, q in enumerate(queries):
            assert det.detect(_entry(mod, 500 + i, np.eye(1, 7, 6)[0], rays, desc,
                                     np.full((4, 3), np.nan), drone_id=1), q) is None
            thres.append(det.effective_netvlad_thres())
        out.append((thres, det._imp_n, det.query_score(revisit)))
    (tj, nj, sj), (tp, np_, sp) = out
    assert nj == np_ == 30
    np.testing.assert_allclose(tp, tj, atol=1e-9)
    assert tp[-1] < 0.5 and sp == pytest.approx(sj, abs=1e-6) and sp > tp[-1]


# ---------------------------------------------------------------------------
# multi-view entries: matching per camera-direction pair
# ---------------------------------------------------------------------------


def _two_view_entry(desc, frame_id, views=None):
    """Landmark ``i`` with descriptor ``desc[i]`` in the views ``views[i]``
    (default: both), each landmark's records with the same descriptor, as
    ``D2SLAMSystem._make_entry`` lists a stereo landmark."""
    n = len(desc)
    views = [(0, 1)] * n if views is None else views
    rec = [(c, i) for c in (0, 1) for i in range(n) if c in views[i]]
    cams, ids = (np.asarray(x) for x in zip(*rec))
    return pld.KeyframeEntry(
        frame_id=frame_id, drone_id=0, stamp=0.0, pose=np.eye(1, 7, 6)[0],
        kpt_rays=np.tile([[0.0, 0.0, 1.0]], (len(rec), 1)), kpt_cam=cams.astype(np.int32),
        kpt_desc=desc[ids], kpt_valid=np.ones(len(rec), bool),
        lm_positions=np.full((len(rec), 3), np.nan), lm_ids=ids.astype(np.int64))


def _descriptors(n, seed=11):
    """Unit descriptors and a noisy copy of them."""
    rng = np.random.default_rng(seed)
    desc = rng.normal(0, 1, (n, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    noisy = desc + rng.normal(0, 0.03, desc.shape).astype(np.float32)
    return desc, noisy / np.linalg.norm(noisy, axis=1, keepdims=True)


def _ratio_match(desc_a, desc_b, valid_a, valid_b):
    idx, ok = match_descriptors(torch.as_tensor(desc_a), torch.as_tensor(desc_b),
                                torch.as_tensor(valid_a), torch.as_tensor(valid_b))
    return idx.numpy(), ok.numpy()


def _pooled(entry, old):
    """The matching before per-pair: every record of both entries in one
    ratio-test call."""
    return _ratio_match(entry.kpt_desc, old.kpt_desc, entry.kpt_valid, old.kpt_valid)


def test_two_view_entries_match_per_direction_pair():
    """Two-view entries in which both views see every landmark: the pooled
    ratio test meets each landmark's own copy and keeps no match; per
    camera-direction pair every landmark matches, one match per landmark
    (its first view's) is kept, and a landmark whose views match
    different candidate landmarks loses its matches."""
    n = 40
    desc, noisy = _descriptors(n)
    query, old = _two_view_entry(noisy, 10), _two_view_entry(desc, 0)
    det = pld.LoopDetector(pld.LoopDetectorConfig(), default_extrinsics(), device="cpu")
    assert not _pooled(query, old)[1].any()
    midx, mok = det._match_views(query, old)
    np.testing.assert_array_equal(mok, query.kpt_cam == 0)
    np.testing.assert_array_equal(old.lm_ids[midx[mok]], query.lm_ids[mok])
    np.testing.assert_array_equal(old.kpt_cam[midx[mok]], 0)
    # the candidate's camera-1 records of landmarks 0 and 1 carry each
    # other's ids: both views of each still match, but to different
    # candidate landmarks, so those two lose their matches
    ids = old.lm_ids.copy()
    cam1 = np.flatnonzero(old.kpt_cam == 1)
    ids[cam1[[0, 1]]] = ids[cam1[[1, 0]]]
    _, mok_x = det._match_views(query, old._replace(lm_ids=ids))
    np.testing.assert_array_equal(mok_x, (query.kpt_cam == 0) & ~np.isin(query.lm_ids, [0, 1]))
    # a learned matcher sees one view of each entry per call
    seen = []

    def matcher(da, ra, va, db, rb, vb):
        seen.append((len(da), len(db)))
        return _ratio_match(da, db, va, vb)

    det.matcher_fn = matcher
    midx_sg, mok_sg = det._match_views(query, old)
    assert seen == [(n, n)] * 4
    np.testing.assert_array_equal(midx_sg, midx)
    np.testing.assert_array_equal(mok_sg, mok)


def test_multi_view_entries_need_landmark_ids():
    """A multi-view pair is matched landmark by landmark, so an entry of
    it without one landmark id per record is refused."""
    desc, noisy = _descriptors(8)
    query, old = _two_view_entry(noisy, 10), _two_view_entry(desc, 0)
    det = pld.LoopDetector(pld.LoopDetectorConfig(), default_extrinsics(), device="cpu")
    for a, b in ((query._replace(lm_ids=np.zeros(0, np.int64)), old),
                 (query, old._replace(lm_ids=old.lm_ids[:-1]))):
        with pytest.raises(ValueError, match="one landmark id per record"):
            det._match_views(a, b)


@pytest.mark.parametrize("swap", [False, True], ids=["same_order", "views_swapped"])
def test_view_offset_follows_the_candidates_views(swap):
    """Views that see different landmarks: query view c matches the
    candidate's view (c + k) mod 2 at the offset k with the most matches,
    0, or 1 where the candidate's views are swapped."""
    n = 40
    desc, noisy = _descriptors(n, seed=12)
    views = [(i % 2,) for i in range(n)]
    query = _two_view_entry(noisy, 10, views)
    old = _two_view_entry(desc, 0, [((v + swap) % 2,) for (v,) in views])
    det = pld.LoopDetector(pld.LoopDetectorConfig(), default_extrinsics(), device="cpu")
    midx, mok = det._match_views(query, old)
    assert mok.all()
    np.testing.assert_array_equal(old.lm_ids[midx], query.lm_ids)
    np.testing.assert_array_equal(old.kpt_cam[midx], (query.kpt_cam + swap) % 2)


def test_single_view_entries_match_as_one_call():
    """A single-view pair is today's one call: the same matches as the
    ratio test over all records, and one learned-matcher call with every
    record."""
    sc = _loop_scene(planar=True)
    n = len(sc["lms"])
    query = _entry(pld, 10, sc["pose_vio"], sc["rays_new"], sc["desc_new"], np.full((n, 3), np.nan))
    old = _entry(pld, 0, sc["pose_old"], sc["rays_old"], sc["desc"], sc["lms"])
    det = pld.LoopDetector(pld.LoopDetectorConfig(), sc["ext"], device="cpu")
    midx, mok = det._match_views(query, old)
    pidx, pok = _pooled(query, old)
    np.testing.assert_array_equal(mok, pok)
    np.testing.assert_array_equal(midx[mok], pidx[pok])
    assert mok.sum() >= 50
    calls = []
    det.matcher_fn = lambda *a: calls.append([len(x) for x in a]) or (np.zeros(n, int),
                                                                       np.zeros(n, bool))
    det._match_views(query, old)
    assert calls == [[n] * 6]


def test_two_view_loop_counts_landmarks_not_records():
    """_loop_scene seen by both cameras of the stereo rig in both
    keyframes: the loop verifies, and its inliers (and so its covariance)
    count each landmark once, not once per view."""
    sc = _loop_scene(planar=False)
    n, ext = len(sc["lms"]), sc["ext"]

    def both_views(pose, desc, lms, frame_id):
        rays = [_rays(sc["lms"], pose, ext, c) for c in range(2)]
        return pld.KeyframeEntry(
            frame_id=frame_id, drone_id=0, stamp=0.0, pose=pose,
            kpt_rays=np.concatenate(rays), kpt_cam=np.repeat(np.arange(2, dtype=np.int32), n),
            kpt_desc=np.concatenate([desc, desc]), kpt_valid=np.ones(2 * n, bool),
            lm_positions=np.concatenate([lms, lms]), lm_ids=np.tile(np.arange(n), 2))

    det = pld.LoopDetector(pld.LoopDetectorConfig(min_gap_frames=2, min_inliers=20,
                                                  min_match_per_dir=10), ext, device="cpu")
    det.add_keyframe(both_views(sc["pose_old"], sc["desc"], sc["lms"], 0), sc["gdesc"])
    pose_new = sc["pose_vio"].copy()
    pose_new[:3] -= [0.3, -0.2, 0.1]
    query = both_views(pose_new, sc["desc_new"], np.full((n, 3), np.nan), 10)
    query = query._replace(pose=sc["pose_vio"])
    edge = det.detect(query, sc["gdesc_new"])
    assert edge is not None and 50 <= edge.inliers <= n
    np.testing.assert_allclose(edge.rel_pose[:3], pose_new[:3] - sc["pose_old"][:3], atol=0.05)
