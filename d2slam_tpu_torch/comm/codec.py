"""Swarm wire format: compact keyframe packets with int8 descriptors.

The port's copy of ``d2slam_tpu/comm/codec.py``: for the same packet the
bytes are equal, and each package decodes the other's. Equivalent of
the reference's LCM message encoding
(reference: d2common/include/d2common/d2frontend_types.h:228-341 toLCM /
fromLCM — int8 descriptor quantization scaled by max/127, per-feature
renormalization on decode; d2frontend/src/loop_net.cpp:110-160 bounded
landmark packets). One packet carries the header (ids, stamp, ego pose,
int8 NetVLAD) plus all landmark records (id, camera, unit ray, int8
SuperPoint descriptor).

Layout (little-endian):
  magic u32 | version u16 | drone_id u16 | frame_id i64 | stamp f64 |
  is_keyframe u8 | n_lm u16 | gdesc_dim u16 | desc_dim u16 |
  pose f32[7] | gdesc_scale f32 | gdesc i8[gdesc_dim] |
  per-landmark: id i64 | cam u8 | ray f32[3] | vel f32[3] |
                scale f32 | desc i8[desc_dim]

Version 2 appends the state block the reference carries for its
SOLVE_ALL/SERVER estimation modes (VisualImageDescArray's imu_buf,
Ba/Bg and sld_win_status, reference d2frontend_types.h:85-527):
  ba f32[3] | bg f32[3] | vel f32[3] |
  n_imu u16 | per-sample: t f64 | acc f32[3] | gyr f32[3] |
  n_sld u16 | sld_win i64[n_sld]
Version-1 packets decode with an empty state block.

Version 3 appends the sender's reference frame id (i32) — the world
frame this packet's poses are expressed in (reference
D2BaseFrame::reference_frame_id; receivers merge maps toward the lower
id, d2estimator.cpp:274-281). Older packets decode with
ref_frame_id == drone_id (every drone starts as its own reference).
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from d2slam_tpu_torch.utils.pngio import png_decode_gray, png_encode_gray

MAGIC = 0xD25A11A7
VERSION = 4
_HDR = struct.Struct("<IHHqdBHHH")
_Z3 = np.zeros(3, np.float32)


class RemoteKeyframePacket(NamedTuple):
    drone_id: int
    frame_id: int
    stamp: float
    is_keyframe: bool
    pose: np.ndarray        # [7] ego pose
    gdesc: np.ndarray       # [G] float32 (renormalized on decode)
    lm_ids: np.ndarray      # [N] int64
    lm_cam: np.ndarray      # [N] uint8
    lm_rays: np.ndarray     # [N, 3] float32
    lm_vels: np.ndarray     # [N, 3] float32
    lm_desc: np.ndarray     # [N, D] float32 (renormalized on decode)
    # --- v2 state block (SOLVE_ALL/SERVER modes) ---
    ba: np.ndarray = _Z3    # [3] accel bias estimate
    bg: np.ndarray = _Z3    # [3] gyro bias estimate
    vel: np.ndarray = _Z3   # [3] world-frame velocity estimate
    imu_t: np.ndarray = np.zeros(0, np.float64)      # [S] sample stamps
    imu_acc: np.ndarray = np.zeros((0, 3), np.float32)  # [S, 3]
    imu_gyr: np.ndarray = np.zeros((0, 3), np.float32)  # [S, 3]
    sld_win: np.ndarray = np.zeros(0, np.int64)  # sender's window frame ids
    # --- v3: world frame these poses live in (merge toward lower id) ---
    ref_frame_id: int = -1
    # --- v4: landmark world positions in the SENDER's frame (nan =
    # not yet estimated) — the reference ships pt3d with every landmark
    # (d2common/include/d2common/d2landmarks.h:28-169 LandmarkPerFrame),
    # which is what lets a receiver verify loops by PnP against REMOTE
    # geometry, not only against its own map ---
    lm_pos3d: np.ndarray = np.zeros((0, 3), np.float32)


def _quant(v: np.ndarray):
    scale = float(np.max(np.abs(v))) / 127.0 if v.size else 1.0
    scale = max(scale, 1e-12)
    q = np.clip(np.round(v / scale), -127, 127).astype(np.int8)
    return q, scale


def _dequant(q: np.ndarray, scale: float, renorm: bool):
    v = q.astype(np.float32) * scale
    if renorm:
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        v = v / np.maximum(n, 1e-12)
    return v


def encode_keyframe(pkt: RemoteKeyframePacket) -> bytes:
    n = len(pkt.lm_ids)
    G = len(pkt.gdesc)
    D = pkt.lm_desc.shape[1] if n else 0
    gq, gscale = _quant(np.asarray(pkt.gdesc, np.float32))
    out = [
        _HDR.pack(MAGIC, VERSION, pkt.drone_id, pkt.frame_id, pkt.stamp,
                  int(pkt.is_keyframe), n, G, D),
        np.asarray(pkt.pose, np.float32).tobytes(),
        struct.pack("<f", gscale),
        gq.tobytes(),
    ]
    for i in range(n):
        dq, dscale = _quant(np.asarray(pkt.lm_desc[i], np.float32))
        out.append(struct.pack("<qB", int(pkt.lm_ids[i]), int(pkt.lm_cam[i])))
        out.append(np.asarray(pkt.lm_rays[i], np.float32).tobytes())
        out.append(np.asarray(pkt.lm_vels[i], np.float32).tobytes())
        out.append(struct.pack("<f", dscale))
        out.append(dq.tobytes())
    # v2 state block
    out.append(np.asarray(pkt.ba, np.float32).tobytes())
    out.append(np.asarray(pkt.bg, np.float32).tobytes())
    out.append(np.asarray(pkt.vel, np.float32).tobytes())
    s = len(pkt.imu_t)
    out.append(struct.pack("<H", s))
    for k in range(s):
        out.append(struct.pack("<d", float(pkt.imu_t[k])))
        out.append(np.asarray(pkt.imu_acc[k], np.float32).tobytes())
        out.append(np.asarray(pkt.imu_gyr[k], np.float32).tobytes())
    out.append(struct.pack("<H", len(pkt.sld_win)))
    out.append(np.asarray(pkt.sld_win, np.int64).tobytes())
    # v3 reference frame id
    ref = pkt.ref_frame_id if pkt.ref_frame_id >= 0 else pkt.drone_id
    out.append(struct.pack("<i", int(ref)))
    # v4 landmark world positions (nan where unknown)
    p3 = np.asarray(pkt.lm_pos3d, np.float32)
    if p3.shape != (n, 3):
        p3 = np.full((n, 3), np.nan, np.float32)
    out.append(p3.tobytes())
    return b"".join(out)


def decode_keyframe(buf: bytes) -> Optional[RemoteKeyframePacket]:
    if len(buf) < _HDR.size:
        return None
    magic, ver, drone_id, frame_id, stamp, is_kf, n, G, D = _HDR.unpack_from(
        buf, 0
    )
    if magic != MAGIC or ver not in (1, 2, 3, 4):
        return None
    off = _HDR.size
    pose = np.frombuffer(buf, np.float32, 7, off).copy()
    off += 28
    (gscale,) = struct.unpack_from("<f", buf, off)
    off += 4
    gq = np.frombuffer(buf, np.int8, G, off).copy()
    off += G
    gdesc = _dequant(gq, gscale, renorm=True)

    lm_ids = np.zeros(n, np.int64)
    lm_cam = np.zeros(n, np.uint8)
    lm_rays = np.zeros((n, 3), np.float32)
    lm_vels = np.zeros((n, 3), np.float32)
    lm_desc = np.zeros((n, D), np.float32)
    for i in range(n):
        lm_ids[i], lm_cam[i] = struct.unpack_from("<qB", buf, off)
        off += 9
        lm_rays[i] = np.frombuffer(buf, np.float32, 3, off)
        off += 12
        lm_vels[i] = np.frombuffer(buf, np.float32, 3, off)
        off += 12
        (dscale,) = struct.unpack_from("<f", buf, off)
        off += 4
        dq = np.frombuffer(buf, np.int8, D, off)
        off += D
        lm_desc[i] = _dequant(dq, dscale, renorm=True)

    ba, bg, vel = _Z3, _Z3, _Z3
    imu_t = np.zeros(0, np.float64)
    imu_acc = np.zeros((0, 3), np.float32)
    imu_gyr = np.zeros((0, 3), np.float32)
    sld_win = np.zeros(0, np.int64)
    if ver >= 2:
        ba = np.frombuffer(buf, np.float32, 3, off).copy(); off += 12
        bg = np.frombuffer(buf, np.float32, 3, off).copy(); off += 12
        vel = np.frombuffer(buf, np.float32, 3, off).copy(); off += 12
        (s,) = struct.unpack_from("<H", buf, off); off += 2
        imu_t = np.zeros(s, np.float64)
        imu_acc = np.zeros((s, 3), np.float32)
        imu_gyr = np.zeros((s, 3), np.float32)
        for k in range(s):
            (imu_t[k],) = struct.unpack_from("<d", buf, off); off += 8
            imu_acc[k] = np.frombuffer(buf, np.float32, 3, off); off += 12
            imu_gyr[k] = np.frombuffer(buf, np.float32, 3, off); off += 12
        (n_sld,) = struct.unpack_from("<H", buf, off); off += 2
        sld_win = np.frombuffer(buf, np.int64, n_sld, off).copy()
        off += 8 * n_sld
    ref_frame_id = drone_id
    if ver >= 3:
        (ref_frame_id,) = struct.unpack_from("<i", buf, off); off += 4
    lm_pos3d = np.full((n, 3), np.nan, np.float32)
    if ver >= 4:
        if len(buf) - off < 12 * n:
            # truncated / hostile packet: keep the documented contract
            # (decode returns None on malformed input, never raises)
            return None
        lm_pos3d = np.frombuffer(
            buf, np.float32, 3 * n, off).reshape(n, 3).copy()
        off += 12 * n
    return RemoteKeyframePacket(
        drone_id=drone_id, frame_id=frame_id, stamp=stamp,
        is_keyframe=bool(is_kf), pose=pose, gdesc=gdesc,
        lm_ids=lm_ids, lm_cam=lm_cam, lm_rays=lm_rays, lm_vels=lm_vels,
        lm_desc=lm_desc, ba=ba, bg=bg, vel=vel,
        imu_t=imu_t, imu_acc=imu_acc, imu_gyr=imu_gyr, sld_win=sld_win,
        ref_frame_id=ref_frame_id, lm_pos3d=lm_pos3d,
    )


# ---------------------------------------------------------------------------
# loop edges (SWARM_LOOP_CONN channel)
# ---------------------------------------------------------------------------

_LOOP = struct.Struct("<IHqqHHffi")
_LOOP_MAGIC = 0xD25A100F


def encode_loop_edge(frame_id_a: int, frame_id_b: int, drone_id_a: int,
                     drone_id_b: int, rel_pose: np.ndarray, pos_cov: float,
                     yaw_cov: float, inliers: int) -> bytes:
    """Wire format of one loop edge (reference LoopEdge_t on
    SWARM_LOOP_CONN, loop_net.cpp:10-22: relative pose + covariance so
    every robot's PGO can add the edge)."""
    return _LOOP.pack(
        _LOOP_MAGIC, 1, frame_id_a, frame_id_b, drone_id_a, drone_id_b,
        pos_cov, yaw_cov, inliers,
    ) + np.asarray(rel_pose, np.float32).tobytes()


def decode_loop_edge(buf: bytes):
    """Returns (frame_id_a, frame_id_b, drone_id_a, drone_id_b,
    rel_pose[7], pos_cov, yaw_cov, inliers) or None."""
    if len(buf) < _LOOP.size + 28:
        return None
    magic, ver, fa, fb, da, db, pc, yc, inl = _LOOP.unpack_from(buf, 0)
    if magic != _LOOP_MAGIC or ver != 1:
        return None
    rel = np.frombuffer(buf, np.float32, 7, _LOOP.size).astype(np.float64)
    return fa, fb, da, db, rel, pc, yc, inl


# ---------------------------------------------------------------------------
# whole-image attachments (VIOKF_IMG_ARRAY channel, optional)
# ---------------------------------------------------------------------------

_IMG = struct.Struct("<IHHBBq")
_IMG_MAGIC = 0xD25A1336


def encode_image_packet(drone_id: int, frame_id: int, view: int,
                        img: "np.ndarray", n_views: int = 1) -> bytes:
    """One compressed camera view of a keyframe (reference ``send_img``:
    LoopCam JPEG-encodes each view into VisualImageDesc.image,
    loop_cam.cpp:72-84, broadcast on VIOKF_IMG_ARRAY, loop_net.cpp:10-22.
    Here: lossless PNG via stdlib zlib — see utils/pngio.py)."""
    return _IMG.pack(_IMG_MAGIC, 1, drone_id, view, n_views,
                     frame_id) + png_encode_gray(img)


def decode_image_packet(buf: bytes):
    """Returns (drone_id, frame_id, view, n_views, img[H,W] uint8)
    or None."""
    if len(buf) < _IMG.size + 8:
        return None
    magic, ver, did, view, n_views, fid = _IMG.unpack_from(buf, 0)
    if magic != _IMG_MAGIC or ver != 1:
        return None
    try:
        img = png_decode_gray(buf[_IMG.size:])
    except (ValueError, zlib.error, struct.error):
        return None
    return did, fid, view, n_views, img
