"""Feature tracker: the host state machine turning images into
landmark-observation frames for the estimator.

Counterpart of ``d2slam_tpu/frontend/tracker.py`` (reference
D2FeatureTracker, d2frontend/src/d2featuretracker.cpp). Stereo path:

* all views of a frame go through ONE batched SuperPoint extraction
  (B=2 for stereo, B=V for a multi-view rig); the images upload as
  uint8 and are normalized on the device;
* keypoints and validity come back to the host for the bookkeeping;
  descriptors stay on the device, where the matching runs;
* LK carries existing landmarks from the previous frame (trackLK
  :472-621), radius-gated descriptor matching against the last keyframe
  fills the gaps (matchLocalFeatures :1077-1294), epipolar matching
  associates the right view (:658-753), and the keyframe decision
  looks at parallax and tracked count (isKeyframe :754-775).

Multi-view path (FOURCORNER_FISHEYE quadcam, :121-133): per-view
temporal tracking as above, then descriptor matching between adjacent
views gated by positions predicted through the camera extrinsics; the
matched features of several views are unified into one landmark id.

Extraction lookahead (``submit_stereo_extraction``): on a CUDA device a
frame's upload and batched extraction (SuperPoint, the stem kernel, and
the fused auxiliary network) are queued on a side stream of the
tracker's own while the caller associates the previous frame; the
resolver hands the outputs over to the caller's current stream.

Images come in as float [0, 1] or ``uint8``; they upload as ``uint8``.

RGB-D (``process_rgbd``, reference PINHOLE_DEPTH): one view and an
aligned depth image; each keypoint carries the depth sampled there, as
a distance along its ray.

The learned matcher (``matcher_fn``, reference enable_superglue_local;
``frontend/superglue.make_tracker_matcher``) replaces the radius-gated
descriptor matching at every call site: the keyframe gap fill of the
stereo path, the cross-view association and the per-view keyframe match
of the multi-view path.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from d2slam_tpu_torch.frontend.lk import lk_track_images
from d2slam_tpu_torch.frontend.matching import (
    match_descriptors_radius,
    match_stereo_epipolar,
)
from d2slam_tpu_torch.frontend.superpoint import (
    SuperPoint,
    SuperPointConfig,
    SuperPointOutput,
    superpoint_extract,
)
from d2slam_tpu_torch.geometry.cameras import PinholeParams
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device
from d2slam_tpu_torch.utils.perf import PerfTracker
from d2slam_tpu_torch.vins.types import CameraObservations, FrontendFrame


@dataclasses.dataclass
class TrackerConfig:
    min_keyframe_parallax: float = 10.0       # px (reference kf gating)
    min_tracked_for_nonkf: int = 40           # below -> force keyframe
    match_ratio: float = 0.8
    search_radius: float = 40.0               # px, radius-gated matching
    stereo_ratio: float = 0.8
    use_lk: bool = True
    lk_levels: int = 3
    # RGB-D (reference PINHOLE_DEPTH): accepted measured-depth range
    # when sampling the aligned depth image at keypoints
    depth_min: float = 0.3
    depth_max: float = 10.0


def _img_f32(img: np.ndarray) -> np.ndarray:
    """A view as float32 in [0, 1] (``uint8`` divided by 255) for the
    host work (LK runs on float images)."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        return a.astype(np.float32) / 255.0
    return np.asarray(a, np.float32)


def _img_u8(img: np.ndarray) -> np.ndarray:
    """Quantize an image (or stack) to uint8 for the upload. Float
    inputs are [0, 1]; uint8 passes through."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        return a
    return np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# vectorized host association helpers
# ---------------------------------------------------------------------------


def _assoc_lk_vec(new_pts: np.ndarray, ok: np.ndarray,
                  prev_ids: np.ndarray, kpts: np.ndarray,
                  valid: np.ndarray, ids: np.ndarray,
                  max_dist: float = 2.0) -> None:
    """Assign LK-tracked landmark ids to the nearest extracted keypoint
    (< max_dist px), one keypoint per landmark and one landmark per
    keypoint, conflicts resolved min-distance-first. Mutates ``ids``."""
    prev_ids = np.asarray(prev_ids)
    cand = np.flatnonzero(ok & (prev_ids >= 0))
    if not len(cand) or not len(kpts):
        return
    _, first = np.unique(prev_ids[cand], return_index=True)
    cand = cand[np.sort(first)]
    d = np.linalg.norm(kpts[None, :, :] - new_pts[cand, None, :], axis=2)
    d = np.where((valid & (ids < 0))[None, :], d, np.inf)  # [nc, K]
    j_near = np.argmin(d, axis=1)
    d_near = d[np.arange(len(cand)), j_near]
    good = np.flatnonzero(d_near < max_dist)
    if not len(good):
        return
    good = good[np.argsort(d_near[good], kind="stable")]
    _, keep = np.unique(j_near[good], return_index=True)
    winners = good[keep]
    ids[j_near[winners]] = prev_ids[cand[winners]]


def _assign_matches_vec(idx: np.ndarray, ok: np.ndarray,
                        src_ids: np.ndarray, ids: np.ndarray) -> None:
    """Write matched source landmark ids onto still-unassigned target
    keypoints; the lowest source index wins a contested target."""
    sel = np.flatnonzero(ok)
    if not len(sel):
        return
    tgt = idx[sel]
    free = ids[tgt] < 0
    sel, tgt = sel[free], tgt[free]
    if not len(sel):
        return
    uniq_t, first = np.unique(tgt, return_index=True)
    ids[uniq_t] = np.asarray(src_ids)[sel[first]]


def _lookup_pts_vec(query_ids: np.ndarray, ref_ids: np.ndarray,
                    ref_pts: np.ndarray):
    """Vectorized id->point lookup: (found [Nq], pts [Nq, 2])."""
    query_ids = np.asarray(query_ids)
    ref_ids = np.asarray(ref_ids)
    out = np.zeros((len(query_ids), ref_pts.shape[1] if len(ref_pts) else 2))
    if not len(ref_ids) or not len(query_ids):
        return np.zeros(len(query_ids), bool), out
    order = np.argsort(ref_ids, kind="stable")
    sids = ref_ids[order]
    loc = np.searchsorted(sids, query_ids)
    locc = np.minimum(loc, len(sids) - 1)
    found = (query_ids >= 0) & (sids[locc] == query_ids)
    out[found] = np.asarray(ref_pts)[order[locc[found]]]
    return found, out


class Extraction(NamedTuple):
    """One frame's batched extraction: the device outputs, host copies
    of keypoints and validity, and the auxiliary network's output for
    this frame (None without ``aux_fn``)."""

    out: SuperPointOutput
    kpts: np.ndarray
    valid: np.ndarray
    aux: Optional[torch.Tensor]


class FeatureTracker:
    def __init__(
        self,
        sp_params: Union[Dict, SuperPoint],
        sp_cfg: SuperPointConfig,
        cam_params: List[PinholeParams],
        cfg: TrackerConfig = TrackerConfig(),
        frame_rate: float = 8.0,
        device=None,
        extrinsics=None,
        extract_fn=None,
        aux_fn=None,
        matcher_fn=None,
    ):
        """sp_params: the SuperPoint parameter pytree (numpy, JAX
        layout) or a ready ``SuperPoint``. ``device`` defaults to
        ``cuda`` and raises without a card unless ``device="cpu"``.

        extract_fn: optional ``f(img, cam_id) -> SuperPointOutput`` of one
        view, replacing SuperPoint (tests inject oracle extractors);
        ``sp_params`` may then be None.

        aux_fn: optional ``f(imgs_u8 [V, H, W] on the device) -> tensor``
        run inside the extraction of a frame's views, on the images
        already uploaded for SuperPoint (the system fuses NetVLAD here);
        its result is ``self.last_aux`` until the next extraction.

        cam_params: per camera a ``PinholeParams`` or any object with
        ``lift`` / ``project`` methods (``geometry.kalibr.KalibrCamera``).

        extrinsics: [C, 7] body_T_cam, required for multi-view (quadcam)
        cross-view association, which predicts feature positions through
        the relative camera rotations (reference matchLocalFeatures
        prediction_using_extrinsic).

        matcher_fn: optional learned matcher ``f(desc_a, kpts_a, valid_a,
        desc_b, kpts_b, valid_b) -> (idx, ok)`` replacing the radius-gated
        nearest-neighbour matching (reference enable_superglue_local)."""
        self.matcher_fn = matcher_fn
        self._extract_fn = extract_fn
        self._aux_fn = aux_fn
        self.last_aux = None
        if extract_fn is not None:
            self.model = None
            self.device = resolve_device(device)
        else:
            self.model = (sp_params if isinstance(sp_params, SuperPoint)
                          else SuperPoint(sp_params, sp_cfg, device=device))
            self.device = self.model.device
        self.cams = cam_params
        self.cfg = cfg
        self.dt = 1.0 / frame_rate
        self.ext = None if extrinsics is None else np.asarray(extrinsics, np.float64)
        self.perf = PerfTracker()
        self._lm_ids = itertools.count(0)
        self.prev: Dict = {}          # last processed frame data
        self.last_kf: Dict = {}       # last keyframe data
        self.prev_mv: Dict[int, Dict] = {}     # per-view (multi-view rig)
        self.last_kf_mv: Dict[int, Dict] = {}  # per-view (multi-view rig)
        self.frame_count = 0
        self.landmark_count = 0
        self._side_stream = None      # the lookahead's CUDA stream

    def extract(self, imgs: np.ndarray, aux: bool = True):
        """Batched extraction of [B, H, W] images (float [0, 1] or u8):
        u8 upload, normalization on the device. Returns the device
        ``SuperPointOutput`` and host copies of (kpts, valid). With
        ``aux`` the auxiliary function runs on the same upload; otherwise
        ``last_aux`` is cleared, so a frame never carries a stale one."""
        self.last_aux = None
        if self._extract_fn is not None:
            per_view = [self._extract_fn(im, v) for v, im in enumerate(imgs)]
            out = SuperPointOutput(*(
                torch.stack([torch.as_tensor(np.asarray(getattr(o, f)), device=self.device)
                             for o in per_view])
                for f in SuperPointOutput._fields))
            return out, out.kpts.cpu().numpy(), out.valid.cpu().numpy()
        res = self._extract_u8(torch.from_numpy(_img_u8(imgs)), aux)
        self.last_aux = res.aux
        return res.out, res.kpts, res.valid

    def _lift(self, cam_idx: int, uv):
        """Pixels -> unit rays for camera ``cam_idx`` (numpy). Dispatches
        on the camera object, so fisheye chains (KalibrCamera) work
        beside bare PinholeParams (reference liftProjective); the bare
        pinhole has no distortion here and runs in float64 numpy."""
        cam = self.cams[cam_idx]
        if hasattr(cam, "lift"):
            return cam.lift(torch.as_tensor(np.asarray(uv, np.float32))).numpy()
        uv = np.asarray(uv, np.float64)
        r = np.stack([
            (uv[..., 0] - float(cam.cx)) / float(cam.fx),
            (uv[..., 1] - float(cam.cy)) / float(cam.fy),
            np.ones(uv.shape[:-1]),
        ], axis=-1)
        return r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-12)

    def _project(self, cam_idx: int, rays):
        """Camera-frame rays -> [N, 2] pixels for camera ``cam_idx``
        (the validity mask of a project function is dropped: callers
        gate on the ray's z)."""
        cam = self.cams[cam_idx]
        if hasattr(cam, "project"):
            return cam.project(torch.as_tensor(np.asarray(rays, np.float32)))[0].numpy()
        rays = np.asarray(rays, np.float64)
        z = np.maximum(np.abs(rays[..., 2]), 1e-9) * np.sign(
            np.where(rays[..., 2] == 0, 1.0, rays[..., 2]))
        return np.stack([
            float(cam.fx) * rays[..., 0] / z + float(cam.cx),
            float(cam.fy) * rays[..., 1] / z + float(cam.cy),
        ], axis=-1)

    def _match(self, desc_a, pts_a, valid_a, desc_b, pts_b, valid_b,
               radius: float):
        """Descriptor association: the learned matcher when one is set,
        else the radius-gated nearest-neighbour ratio match. Host numpy
        (idx, ok)."""
        if self.matcher_fn is not None:
            idx, ok = self.matcher_fn(desc_a, pts_a, valid_a, desc_b, pts_b, valid_b)
            return np.asarray(idx), np.asarray(ok)
        idx, ok = match_descriptors_radius(
            desc_a, desc_b, pts_a, pts_b, valid_a, valid_b,
            radius=radius, ratio=self.cfg.match_ratio,
        )
        return idx.cpu().numpy(), ok.cpu().numpy()

    def _extract_u8(self, u8: torch.Tensor, aux: bool = True) -> Extraction:
        """Batched extraction of host ``uint8`` views [B, H, W]: upload,
        SuperPoint, ``aux_fn`` on the same upload (with ``aux``),
        keypoints and validity to the host."""
        u8 = u8.to(self.device)
        out = superpoint_extract(self.model, u8.float() / 255.0)
        aux = self._aux_fn(u8) if aux and self._aux_fn is not None else None
        return Extraction(out, out.kpts.cpu().numpy(), out.valid.cpu().numpy(), aux)

    def submit_stereo_extraction(self, img_left, img_right
                                 ) -> Optional[Callable[[], Extraction]]:
        """Start the batched extraction of a stereo pair without waiting
        for it. Returns a zero-argument resolver to pass as
        ``process_stereo(..., extracted=...)`` with these images, or None
        where the batched path does not apply (an ``extract_fn``, views
        of different shapes).

        On a CUDA device the pair is staged in pinned memory; on the
        tracker's side stream it is uploaded (``non_blocking``),
        extracted (SuperPoint with the stem kernel, then ``aux_fn``) and
        its keypoints and validity copied back into pinned host memory,
        and an event closes the work. The resolver makes the caller's
        current stream wait on that event, records the outputs' use on
        that stream, waits for the host copies and returns the
        :class:`Extraction` with this frame's aux output (never a shared
        ``last_aux``); a second call returns the same result. On the CPU
        the extraction runs at once and the resolver returns it."""
        if self._extract_fn is not None or np.shape(img_left) != np.shape(img_right):
            return None
        u8 = torch.from_numpy(np.stack([_img_u8(img_left), _img_u8(img_right)]))
        if self.device.type != "cuda":
            res = self._extract_u8(u8)
            return lambda: res
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream
        # the side stream starts after the work already queued on the
        # caller's stream (weights, earlier frames)
        side.wait_stream(torch.cuda.current_stream(self.device))
        staged = u8.pin_memory()
        with self.perf.stage("submit"), torch.cuda.stream(side):
            dev_u8 = staged.to(self.device, non_blocking=True)
            out = superpoint_extract(self.model, dev_u8.float() / 255.0)
            aux = self._aux_fn(dev_u8) if self._aux_fn is not None else None
            kpts = torch.empty(out.kpts.shape, dtype=out.kpts.dtype, pin_memory=True)
            valid = torch.empty(out.valid.shape, dtype=out.valid.dtype, pin_memory=True)
            kpts.copy_(out.kpts, non_blocking=True)
            valid.copy_(out.valid, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        result: List[Extraction] = []

        def resolve() -> Extraction:
            if not result:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(done)
                for t in (*out, aux):
                    if t is not None:
                        t.record_stream(cur)
                done.synchronize()
                result.append(Extraction(out, kpts.numpy(), valid.numpy(), aux))
            return result[0]

        return resolve

    def process_stereo(self, stamp: float, frame_id: int,
                       img_left: np.ndarray, img_right: np.ndarray,
                       extracted: Optional[Callable[[], Extraction]] = None,
                       ) -> Optional[FrontendFrame]:
        """Returns a FrontendFrame when this frame is a keyframe.
        ``extracted``: the resolver of ``submit_stereo_extraction`` for
        these images; its aux output becomes ``last_aux``."""
        imgL = _img_f32(img_left)
        imgR = _img_f32(img_right)
        with self.perf.stage("extract"):
            if extracted is not None:
                res = extracted()
                self.last_aux = res.aux
                outs, kpts, valid = res.out, res.kpts, res.valid
            else:
                outs, kpts, valid = self.extract(np.stack([imgL, imgR]))
        with self.perf.stage("host"):
            return self._associate(stamp, frame_id, imgL, outs, kpts, valid)

    def _associate(self, stamp, frame_id, imgL, outs, kpts, valid):
        kptsL, kptsR = kpts[0], kpts[1]
        validL, validR = valid[0], valid[1]
        descL, descR = outs.desc[0], outs.desc[1]

        # ---- LK carry-over first: geometric short-baseline tracking is
        # the trustworthy association layer; descriptor matching then
        # only fills the gaps
        matched_ids = -np.ones(len(kptsL), np.int64)
        if self.cfg.use_lk and self.prev:
            live = np.asarray(self.prev["valid"])
            if live.any():
                new_pts, ok = lk_track_images(
                    self.prev["img"], imgL, self.prev["pts"], live,
                    levels=self.cfg.lk_levels,
                )
                _assoc_lk_vec(new_pts, ok, self.prev["ids"], kptsL, validL,
                              matched_ids)

        # ---- descriptor match vs last keyframe for remaining gaps ----
        if self.last_kf:
            kf = self.last_kf
            kf_ids_arr = np.asarray(kf["ids"])
            taken = matched_ids[matched_ids >= 0]
            kf_free = ~np.isin(kf_ids_arr, taken)
            target_free = (matched_ids < 0) & validL
            idx, ok = self._match(
                kf["desc"], kf["pts"], kf["valid"] & kf_free,
                descL, kptsL, target_free,
                radius=self.cfg.search_radius,
            )
            _assign_matches_vec(idx, ok, kf_ids_arr, matched_ids)

        # ---- new landmark ids ----
        fresh = np.flatnonzero(validL & (matched_ids < 0))
        if len(fresh):
            base = next(self._lm_ids)
            for _ in range(len(fresh) - 1):  # keep the counter in sync
                next(self._lm_ids)
            matched_ids[fresh] = base + np.arange(len(fresh))
            self.landmark_count += len(fresh)

        # ---- keyframe decision (reference isKeyframe) ----
        tracked = 0
        parallax = 0.0
        if self.last_kf:
            sel_v = np.flatnonzero(validL)
            found, pts_kf = _lookup_pts_vec(
                matched_ids[sel_v], self.last_kf["ids"],
                np.asarray(self.last_kf["pts"]),
            )
            tracked = int(found.sum())
            moves = np.linalg.norm(kptsL[sel_v[found]] - pts_kf[found], axis=1)
            parallax = float(np.mean(moves)) if len(moves) else 1e9
        is_keyframe = (
            not self.last_kf
            or parallax > self.cfg.min_keyframe_parallax
            or tracked < self.cfg.min_tracked_for_nonkf
        )

        # ---- stereo association (epipolar band gated) ----
        idxR, okR = match_stereo_epipolar(
            descL, descR, kptsL, kptsR, validL, validR,
            ratio=self.cfg.stereo_ratio,
        )
        idxR, okR = idxR.cpu().numpy(), okR.cpu().numpy()

        # ---- ray velocities from previous positions ----
        prev_ids_v = np.zeros(0, np.int64)
        prev_pts_v = np.zeros((0, 2))
        if self.prev:
            pkeep = np.asarray(self.prev["ids"]) >= 0
            prev_ids_v = np.asarray(self.prev["ids"])[pkeep]
            prev_pts_v = np.asarray(self.prev["pts"])[pkeep]

        self.prev = dict(img=imgL, pts=kptsL, ids=matched_ids, valid=validL,
                         desc=descL)
        self.frame_count += 1

        if not is_keyframe:
            return None

        self.last_kf = dict(pts=kptsL, ids=matched_ids, valid=validL, desc=descL)

        # ---- build FrontendFrame (unit rays via camera lift) ----
        obs = []
        selL = np.flatnonzero(validL)
        raysL = self._lift(0, kptsL[selL])
        velL = np.zeros_like(raysL)
        found, prev_pt = _lookup_pts_vec(matched_ids[selL], prev_ids_v, prev_pts_v)
        if found.any():
            velL[found] = (raysL[found] - self._lift(0, prev_pt[found])) / self.dt
        obs.append(CameraObservations(
            cam_id=0, landmark_ids=matched_ids[selL], rays=raysL, ray_vels=velL,
        ))
        selR = np.flatnonzero(okR & validL)
        if len(selR):
            raysR = self._lift(1, kptsR[idxR[selR]])
            obs.append(CameraObservations(
                cam_id=1, landmark_ids=matched_ids[selR], rays=raysR,
                ray_vels=np.zeros_like(raysR),
            ))
        return FrontendFrame(stamp=stamp, frame_id=frame_id, is_keyframe=True,
                             observations=obs)

    # ------------------------------------------------------------------
    # multi-view (FOURCORNER_FISHEYE quadcam) tracking
    # ------------------------------------------------------------------

    def process_quadcam(self, stamp: float, frame_id: int,
                        imgs: List[np.ndarray]) -> Optional[FrontendFrame]:
        """4-view omnidirectional tracking (reference FOURCORNER_FISHEYE
        path, d2featuretracker.cpp:121-133: per-view temporal track, then
        adjacent-pair cross-view association 0-1, 1-2, 2-3, 0-3).
        ``imgs`` are the undistorted virtual-pinhole views; adjacency is
        the camera ring."""
        V = len(imgs)
        ring = [(v, (v + 1) % V) for v in range(V)]
        return self.process_multiview(stamp, frame_id, imgs, ring)

    def process_rgbd(self, stamp: float, frame_id: int, img: np.ndarray,
                     depth: np.ndarray) -> Optional[FrontendFrame]:
        """Mono + aligned depth image (reference PINHOLE_DEPTH camera
        config: each keypoint carries its measured depth and the
        estimator adds depth residuals). ``depth`` is metric z along the
        optical axis (as a depth camera gives it), at the resolution of
        ``img``; each keypoint's sample becomes its distance along the
        keypoint's ray. Samples outside [depth_min, depth_max] leave the
        landmark vision-only."""
        return self.process_multiview(stamp, frame_id, [img], [], depth_imgs=[depth])

    def process_multiview(self, stamp: float, frame_id: int,
                          imgs: List[np.ndarray], adjacency,
                          depth_imgs: Optional[List[np.ndarray]] = None
                          ) -> Optional[FrontendFrame]:
        """General N-view tracking with cross-view landmark unification.

        Per view: SuperPoint (one batched extraction across the views
        when they share a shape), LK carry-over from the previous frame,
        descriptor match against the last keyframe. Cross-view:
        descriptor match gated by extrinsic-predicted positions
        (reference matchLocalFeatures prediction_using_extrinsic,
        d2featuretracker.cpp:658-753); matched features across views are
        union-found into ONE landmark id."""
        imgs = [_img_f32(im) for im in imgs]
        with self.perf.stage("extract"):
            if len({im.shape for im in imgs}) == 1:
                outs, kpts, valid = self.extract(np.stack(imgs))
                per_view = [(kpts[v], outs.desc[v], valid[v]) for v in range(len(imgs))]
            else:
                per_view = []
                for im in imgs:
                    outs, kpts, valid = self.extract(im[None], aux=False)
                    per_view.append((kpts[0], outs.desc[0], valid[0]))
        with self.perf.stage("host"):
            return self._associate_multiview(stamp, frame_id, imgs, per_view, adjacency,
                                             depth_imgs)

    def _associate_multiview(self, stamp, frame_id, imgs, per_view, adjacency,
                             depth_imgs=None):
        V = len(imgs)
        views = []
        moves_all: List[float] = []
        tracked_tot = 0
        for v in range(V):
            res = self._track_view_temporal(v, imgs[v], *per_view[v])
            views.append(res)
            tracked_tot += res["tracked"]
            moves_all.extend(res["moves"])

        # ---- cross-view association (union-find over (view, idx)) ----
        parent: Dict = {}

        def find(x):
            while parent.setdefault(x, x) != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for (a, b) in adjacency:
            va, vb = views[a], views[b]
            if not va["valid"].any() or not vb["valid"].any():
                continue
            pred = self._predict_cross_view(a, b, va["kpts"])
            infront = pred[:, 2] > 0
            idx, ok = self._match(
                va["desc"], pred[:, :2], va["valid"] & infront,
                vb["desc"], vb["kpts"], vb["valid"],
                radius=self.cfg.search_radius,
            )
            for i in np.flatnonzero(ok):
                parent[find((a, int(i)))] = find((b, int(idx[i])))

        # one landmark id per union group: an existing temporal id if
        # any member carries one, else a fresh id
        groups: Dict = {}
        for v in range(V):
            for j in np.flatnonzero(views[v]["valid"]):
                groups.setdefault(find((v, int(j))), []).append((v, int(j)))
        for members in groups.values():
            ids = [views[v]["ids"][j] for (v, j) in members
                   if views[v]["ids"][j] >= 0]
            lid = min(ids) if ids else next(self._lm_ids)
            if not ids:
                self.landmark_count += 1
            for (v, j) in members:
                views[v]["ids"][j] = lid

        # ---- keyframe decision (reference isKeyframe) ----
        parallax = float(np.mean(moves_all)) if moves_all else 1e9
        is_keyframe = (
            not self.last_kf_mv
            or parallax > self.cfg.min_keyframe_parallax
            or tracked_tot < self.cfg.min_tracked_for_nonkf
        )

        for v in range(V):
            self.prev_mv[v] = dict(
                img=views[v]["img"], pts=views[v]["kpts"], ids=views[v]["ids"],
                valid=views[v]["valid"], desc=views[v]["desc"],
            )
        self.frame_count += 1
        if not is_keyframe:
            return None
        for v in range(V):
            self.last_kf_mv[v] = dict(
                pts=views[v]["kpts"], ids=views[v]["ids"],
                valid=views[v]["valid"], desc=views[v]["desc"],
            )

        obs = []
        for v in range(V):
            sel = np.flatnonzero(views[v]["valid"])
            if not len(sel):
                continue
            rays = np.asarray(self._lift(v, views[v]["kpts"][sel]))
            vel = np.zeros_like(rays)
            found, prev_pt = _lookup_pts_vec(
                views[v]["ids"][sel], views[v]["prev_ids"], views[v]["prev_pts"])
            if found.any():  # ONE batched lift for all carried features
                vel[found] = (rays[found] - self._lift(v, prev_pt[found])) / self.dt
            dep = None
            if depth_imgs is not None and depth_imgs[v] is not None:
                dimg = np.asarray(depth_imgs[v])
                H, W = dimg.shape[:2]
                px = np.clip(np.round(views[v]["kpts"][sel]).astype(int), 0, [W - 1, H - 1])
                d = dimg[px[:, 1], px[:, 0]].astype(np.float64)
                ok_d = (d > self.cfg.depth_min) & (d < self.cfg.depth_max)
                # the image holds z along the optical axis; the estimator
                # wants the distance along the unit ray (its inverse
                # depth and depth residual are distances): z / ray_z.
                # The JAX package attaches z itself (ROADMAP.md)
                ray_z = np.maximum(rays[:, 2], 1e-6)
                dep = np.where(ok_d, d / ray_z, 0.0)  # <= 0: no measurement
            obs.append(CameraObservations(
                cam_id=v, landmark_ids=views[v]["ids"][sel], rays=rays, ray_vels=vel,
                depths=dep,
            ))
        return FrontendFrame(stamp=stamp, frame_id=frame_id, is_keyframe=True,
                             observations=obs)

    def _track_view_temporal(self, v: int, img_now, kpts, desc, valid) -> Dict:
        """One view's temporal association: LK carry-over first, then
        descriptor match vs the view's last keyframe (the layering of
        ``process_stereo``; reference track(frame) per view)."""
        ids = -np.ones(len(kpts), np.int64)
        prev = self.prev_mv.get(v)
        if self.cfg.use_lk and prev and prev["valid"].any():
            new_pts, ok = lk_track_images(
                prev["img"], img_now, prev["pts"], prev["valid"],
                levels=self.cfg.lk_levels,
            )
            _assoc_lk_vec(new_pts, ok, prev["ids"], kpts, valid, ids)

        kf = self.last_kf_mv.get(v)
        tracked, moves = 0, []
        if kf:
            kf_ids = kf["ids"]
            kf_free = ~np.isin(kf_ids, ids[ids >= 0])
            idx, ok = self._match(
                kf["desc"], kf["pts"], kf["valid"] & kf_free,
                desc, kpts, (ids < 0) & valid,
                radius=self.cfg.search_radius,
            )
            _assign_matches_vec(idx, ok, kf_ids, ids)

            keep = kf_ids >= 0
            sel_v = np.flatnonzero(valid)
            found, pts_kf = _lookup_pts_vec(ids[sel_v], kf_ids[keep], kf["pts"][keep])
            tracked = int(found.sum())
            moves = np.linalg.norm(
                kpts[sel_v[found]] - pts_kf[found], axis=1).tolist()
        prev_ids = np.zeros(0, np.int64)
        prev_pts = np.zeros((0, 2))
        if prev:
            pkeep = prev["ids"] >= 0
            prev_ids = prev["ids"][pkeep]
            prev_pts = prev["pts"][pkeep]
        return dict(kpts=kpts, desc=desc, valid=valid, ids=ids, img=img_now,
                    tracked=tracked, moves=moves, prev_ids=prev_ids, prev_pts=prev_pts)

    def _predict_cross_view(self, a: int, b: int, kpts_a: np.ndarray) -> np.ndarray:
        """Predict view-a features' pixel positions in view b through
        the relative camera rotation (far-field approximation, the
        reference's prediction_using_extrinsic). Returns [N, 3]:
        (u, v, z_in_b); z <= 0 means behind camera b."""
        if self.ext is None:
            raise ValueError("multi-view tracking needs extrinsics")
        rays_a = np.asarray(self._lift(a, kpts_a), np.float64)
        R_a = np_lie.quat_to_rotmat(self.ext[a, 3:])
        R_b = np_lie.quat_to_rotmat(self.ext[b, 3:])
        rays_b = rays_a @ (R_b.T @ R_a).T
        uv = np.asarray(self._project(b, rays_b))
        return np.concatenate([uv, rays_b[:, 2:3]], axis=1)
