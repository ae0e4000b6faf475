"""Quadcam omnidirectional depth pipeline.

Counterpart of ``d2slam_tpu/depth/quadcam.py`` (reference
quadcam_depth_est node, quadcam_depth_est/src/quadcam_depth_est_trt.cpp
and virtual_stereo.cpp): split the 4 fisheye views, undistort each
adjacent pair into co-facing virtual pinhole halves, run disparity (the
streaming block matcher, or a HitNet network when one is given), and
assemble camera-frame point clouds.

The four pairs of a frame run as one batch: one bilinear remap for all
left, right and texture views, the block-matching kernel launched twice
(the forward and the reverse pass, each on all four pairs), and one
point assembly.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from d2slam_tpu_torch.depth.fisheye_undist import build_undistort_map, remap_bilinear
from d2slam_tpu_torch.depth.stereo import disparity, points_from_disparity
from d2slam_tpu_torch.utils import np_lie
from d2slam_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class QuadcamConfig:
    out_hw: tuple = (240, 320)
    virtual_fov_deg: float = 90.0
    max_disp: int = 64
    block: int = 9
    min_z: float = 0.3
    max_z: float = 30.0


class VirtualStereoPair(NamedTuple):
    """Precomputed remap tables for one adjacent-camera pair."""
    map_left: torch.Tensor     # [H, W, 2] into the left fisheye image
    map_right: torch.Tensor    # [H, W, 2] into the right fisheye image
    cam_left: int
    cam_right: int
    baseline: float
    focal: float
    T_body_virtual: np.ndarray  # [7] pose of the virtual left camera


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def build_virtual_stereo(fisheyes, extrinsics: np.ndarray,
                         cfg: QuadcamConfig = QuadcamConfig(),
                         device=None) -> List[VirtualStereoPair]:
    """For each adjacent camera pair (i, i+1 mod 4), build virtual
    pinhole half-views facing the direction BETWEEN the two cameras
    (reference VirtualStereo: the left camera yaws +45 deg, the right
    one -45 deg, so both virtual views are parallel and rectified by
    construction).

    fisheyes: 4 camera parameter structs (or KalibrCamera objects);
    extrinsics: [4, 7] body_T_cam, cameras at 90 deg yaw steps.
    ``device=None`` means the card."""
    extrinsics = np.asarray(extrinsics, np.float64)
    # rotation from the virtual (forward) frame into each fisheye camera
    # frame: yaw of +-45 deg about the vertical (camera y)
    R_left = _rot_y(np.deg2rad(45.0))
    R_right = _rot_y(np.deg2rad(-45.0))
    pairs = []
    for i in range(4):
        j = (i + 1) % 4
        map_l, f = build_undistort_map(fisheyes[i], R_left, cfg.out_hw,
                                       cfg.virtual_fov_deg, device)
        map_r, _ = build_undistort_map(fisheyes[j], R_right, cfg.out_hw,
                                       cfg.virtual_fov_deg, device)
        pairs.append(VirtualStereoPair(
            map_left=map_l, map_right=map_r, cam_left=i, cam_right=j,
            # baseline = distance between the two camera centers
            baseline=float(np.linalg.norm(extrinsics[i][:3] - extrinsics[j][:3])),
            focal=float(f), T_body_virtual=extrinsics[i],
        ))
    return pairs


def _stack(images, dev) -> torch.Tensor:
    """A list of arrays or tensors of one shape -> one f32 tensor on
    ``dev`` (one upload for numpy inputs). ``uint8`` arrays go up as they
    are, from pinned staging on a CUDA device, and become float32 on the
    device with no scaling: the same values as a float32 upload, at a
    quarter of the bytes."""
    if isinstance(images, torch.Tensor):
        return images.to(dev, torch.float32)
    if all(isinstance(im, torch.Tensor) for im in images):
        return torch.stack([im.to(dev, torch.float32) for im in images])
    a = np.asarray(images)
    if a.dtype != np.uint8:
        return torch.as_tensor(a.astype(np.float32, copy=False), device=dev)
    u8 = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        u8 = u8.pin_memory().to(dev, non_blocking=True)
    return u8.to(dev).float()


def quadcam_depth(images, pairs: List[VirtualStereoPair],
                  cfg: QuadcamConfig = QuadcamConfig(), hitnet=None,
                  photometric=None, color_images=None,
                  backend: str = "auto", device=None):
    """Run all virtual stereo pairs of one frame. Returns a list of
    (points [H, W, 3] in the virtual-left camera frame, valid [H, W])
    or, with ``color_images``, triples (points, valid, texture): each
    point carries its remapped left-view texture sample, the reference's
    RGB point-cloud path (quadcam_depth_est_trt.hpp:22-114).

    images: the fisheye images [Hf, Wf] of all cameras (a list of arrays
    or tensors, or one stacked tensor; ``uint8`` arrays are uploaded as
    bytes and converted on the device, values unscaled, as float32
    arrays of the same values would be). ``color_images``: per camera
    [Hf, Wf] gray or [Hf, Wf, 3] RGB, the same forms. ``photometric``: optional
    per-camera [Hf, Wf] vignette-correction gain maps, applied before
    remapping as the reference's photometric_calib images are.

    With ``hitnet = (apply, params)``, disparity is
    ``apply(params, left [N, H, W], right [N, H, W])`` and is valid
    where it exceeds 0.5 px; otherwise it comes from the block matcher
    (``backend`` as in ``depth.stereo.disparity``). ``device=None``
    means the card; the maps of ``pairs`` must live on that device."""
    dev = resolve_device(device)
    H, W = cfg.out_hw
    P = len(pairs)
    imgs = _stack(images, dev)
    if photometric is not None:
        imgs = imgs * _stack(photometric, dev)
    li = [p.cam_left for p in pairs]
    ri = [p.cam_right for p in pairs]
    src = [imgs[li], imgs[ri]]
    maps_l = torch.stack([p.map_left for p in pairs])
    maps = [maps_l, torch.stack([p.map_right for p in pairs])]
    if color_images is not None:
        col = _stack(color_images, dev)
        gray = col.dim() == 3
        col = (col[..., None] if gray else col)[li]          # [P, Hf, Wf, C]
        n_ch = col.shape[-1]
        src += [col[..., c] for c in range(n_ch)]
        maps += [maps_l] * n_ch
    # one remap for every left, right and texture view of the frame
    views = remap_bilinear(torch.cat(src), torch.cat(maps))
    left, right = views[:P].contiguous(), views[P:2 * P].contiguous()

    if hitnet is not None:
        apply, params = hitnet
        disp = apply(params, left, right)
        valid = disp > 0.5
    else:
        disp, valid = disparity(left, right, max_disp=cfg.max_disp,
                                block=cfg.block, backend=backend)

    def per_pair(vals):
        return torch.tensor(vals, dtype=disp.dtype, device=dev)[:, None, None]

    pts, ok = points_from_disparity(
        disp, valid, fx=per_pair([p.focal for p in pairs]),
        baseline=per_pair([p.baseline for p in pairs]),
        cx=W / 2.0, cy=H / 2.0, min_z=cfg.min_z, max_z=cfg.max_z)
    if color_images is None:
        return [(pts[k], ok[k]) for k in range(P)]
    tex = views[2 * P:].reshape(n_ch, P, H, W).permute(1, 2, 3, 0)
    if gray:
        tex = tex[..., 0]
    return [(pts[k], ok[k], tex[k]) for k in range(P)]


def cloud_in_body(pair: VirtualStereoPair, pts: torch.Tensor) -> torch.Tensor:
    """Transform a [H, W, 3] virtual-left-camera cloud into the body
    frame through the pair's extrinsic (the reference publishes clouds
    composed into a common frame, quadcam_depth_est_trt publishThread)."""
    T = np.asarray(pair.T_body_virtual, np.float64)
    R = torch.as_tensor(np_lie.quat_to_rotmat(T[3:]).T, dtype=pts.dtype, device=pts.device)
    t = torch.as_tensor(T[:3], dtype=pts.dtype, device=pts.device)
    return pts @ R + t
