"""Rosbag preparation toolbox: quadcam split, multi-bag sync, filtering.

Counterpart of ``d2slam_tpu/tools/bag_tools.py`` (the reference's
dataset-preparation scripts: quadcam_tools/quad_cam_split.py splits the
composite quadcam image into per-camera views; quadcam_tools/
sync_multi_bags.py shifts every drone's bag so all start at a common
zero, anchored at the first camera frame; plus a topic / time filter).
Everything but ``generate_stereo_bag`` is host code on the port's
``datasets/rosbag.py``; the bags it writes are byte-equal to the JAX
package's on the same input. ``generate_stereo_bag`` remaps the fisheye
views through the port's ``depth/`` modules on ``device``.

    python -m d2slam_tpu_torch.tools.bag_tools split  -i in.bag [-o out.bag] [-n 4] [--step 2]
    python -m d2slam_tpu_torch.tools.bag_tools sync   a.bag b.bag ... [--out-dir DIR]
    python -m d2slam_tpu_torch.tools.bag_tools filter -i in.bag -o out.bag [--topics ...]
    python -m d2slam_tpu_torch.tools.bag_tools stereo-gen -i in.bag -o out.bag -c calib.yaml [--cpu]
    python -m d2slam_tpu_torch.tools.bag_tools info   -i in.bag
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from d2slam_tpu_torch.datasets.rosbag import _DECODERS, RosbagReader, RosbagWriter
from d2slam_tpu_torch.utils import np_lie

# message types whose serialized form begins with std_msgs/Header
# (seq uint32, stamp 2x uint32, frame_id string) — the embedded stamp
# can be patched in place at bytes [4, 12).
_HEADER_FIRST = {
    "sensor_msgs/Imu",
    "sensor_msgs/Image",
    "sensor_msgs/CompressedImage",
    "sensor_msgs/CameraInfo",
    "sensor_msgs/PointCloud2",
    "sensor_msgs/Range",
    "sensor_msgs/MagneticField",
    "sensor_msgs/FluidPressure",
    "geometry_msgs/PoseStamped",
    "geometry_msgs/TwistStamped",
    "geometry_msgs/PointStamped",
    "nav_msgs/Odometry",
    "nav_msgs/Path",
}

_IMAGE_TYPES = ("sensor_msgs/Image", "sensor_msgs/CompressedImage")


def split_composite(img: np.ndarray, n_views: int = 4) -> List[np.ndarray]:
    """Split a horizontally-assembled multi-camera image into views
    (reference quad_cam_split.py split_image: vertical cuts at w/n)."""
    w = img.shape[1] // n_views
    return [img[:, i * w:(i + 1) * w] for i in range(n_views)]


def _pack_time(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs += 1
        nsecs -= 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _shift_header_at(data: bytearray, pos: int, dt: float) -> int:
    """Shift the std_msgs/Header starting at ``pos`` (seq, stamp,
    frame_id) in place; returns the offset just past the header."""
    secs, nsecs = struct.unpack_from("<II", data, pos + 4)
    data[pos + 4: pos + 12] = _pack_time(max(secs + nsecs * 1e-9 + dt, 0.0))
    (fid_len,) = struct.unpack_from("<I", data, pos + 12)
    return pos + 16 + fid_len


def _shift_stamp(msgtype: str, data: bytes, dt: float) -> bytes:
    """Return ``data`` with the embedded header stamp(s) shifted by dt
    seconds (for Header-first message types; others pass through — the
    record time still moves, which is what replay tools key on).
    nav_msgs/Path also shifts the stamp inside every contained
    PoseStamped, keeping the whole message on one timeline."""
    if msgtype not in _HEADER_FIRST or len(data) < 12:
        return data
    buf = bytearray(data)
    pos = _shift_header_at(buf, 0, dt)
    if msgtype == "nav_msgs/Path" and pos + 4 <= len(buf):
        (n_poses,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        for _ in range(n_poses):
            if pos + 16 > len(buf):
                break
            pos = _shift_header_at(buf, pos, dt)  # PoseStamped.header
            pos += 56  # Pose: point(3x f64) + quaternion(4x f64)
    return bytes(buf)


def _composite_topic(path: str, types: Dict[str, str], topic: Optional[str]) -> str:
    """The given topic, else the bag's only image topic."""
    if topic is not None:
        return topic
    cands = [t for t, ty in types.items() if ty in _IMAGE_TYPES]
    if len(cands) != 1:
        raise ValueError(f"{path}: specify composite_topic; image topics found: {cands}")
    return cands[0]


def find_time0(path: str, image_topics: Optional[Sequence[str]] = None) -> float:
    """First camera-frame record time in the bag (the reference anchors
    multi-bag sync at the first image, sync_multi_bags.py get_time0)."""
    reader = RosbagReader(path)
    img_topics = {t for t, ty in reader.topics.items() if ty in _IMAGE_TYPES}
    if image_topics:
        img_topics &= set(image_topics)
    if not img_topics:
        raise ValueError(f"{path}: no image topics to anchor sync on")
    for _, t, _ in reader.read_messages(sorted(img_topics), raw=True):
        return t
    raise ValueError(f"{path}: image topics exist but carry no messages")


def shift_bag(input_path: str, output_path: str, dt: float,
              topics: Optional[Sequence[str]] = None) -> Tuple[int, int]:
    """Rewrite a bag with all record times (and embedded header stamps
    of standard types) shifted by ``dt`` seconds. Messages that would
    land before time 0 are DROPPED — clamping them would collapse a
    whole prefix of the stream onto identical timestamps (zero-dt IMU
    intervals break preintegration on replay). Returns
    (messages_written, messages_dropped)."""
    reader = RosbagReader(input_path)
    types = reader.topics
    n = dropped = 0
    with RosbagWriter(output_path) as w:
        for topic, t, data in reader.read_messages(topics, raw=True):
            if t + dt < 0:
                dropped += 1
                continue
            ty = types.get(topic, "")
            w.write_raw(topic, ty, t + dt, _shift_stamp(ty, data, dt))
            n += 1
    return n, dropped


def sync_bags(paths: Sequence[str], out_dir: Optional[str] = None,
              t_start: float = 1.0) -> List[Tuple[str, float]]:
    """Time-align one bag per robot for synchronized swarm replay.

    Every bag is shifted so its first camera frame lands at ``t_start``
    (ROS time must stay positive). Sensor data recorded more than
    ``t_start`` seconds before the first camera frame is dropped —
    raise ``t_start`` to keep a longer IMU warm-up prefix. Output names
    follow the reference's convention: ``<stem>-sync.bag``. Returns
    [(output_path, shift_s)].
    """
    outs = []
    for p in paths:
        dt = t_start - find_time0(p)
        stem = Path(p)
        out = (Path(out_dir) if out_dir else stem.parent) / (stem.stem + "-sync.bag")
        _, dropped = shift_bag(p, str(out), dt)
        if dropped:
            print(f"{p}: dropped {dropped} pre-anchor messages "
                  f"(older than {t_start:.2f} s before the first frame; "
                  f"raise --t-start to keep them)")
        outs.append((str(out), dt))
    return outs


def filter_bag(input_path: str, output_path: str,
               topics: Optional[Sequence[str]] = None,
               t_start: Optional[float] = None,
               t_end: Optional[float] = None,
               step: int = 1) -> int:
    """Copy a bag keeping only selected topics / a record-time window /
    every ``step``-th message per topic. Returns messages written."""
    reader = RosbagReader(input_path)
    types = reader.topics
    counts: Dict[str, int] = {}
    n = 0
    with RosbagWriter(output_path) as w:
        for topic, t, data in reader.read_messages(topics, raw=True):
            if t_start is not None and t < t_start:
                continue
            if t_end is not None and t > t_end:
                continue
            c = counts.get(topic, 0)
            counts[topic] = c + 1
            if c % step:
                continue
            w.write_raw(topic, types.get(topic, ""), t, data)
            n += 1
    return n


def split_quadcam_bag(input_path: str, output_path: Optional[str] = None,
                      composite_topic: Optional[str] = None,
                      n_views: int = 4, step: int = 1,
                      t_start: float = 0.0,
                      view_topic_fmt: str = "/cam_{i}/image",
                      keep_topics: Optional[Sequence[str]] = None) -> str:
    """Split composite quadcam images into per-view Image topics.

    The reference records all four fisheye views side-by-side in one
    image (topics like /oak_ffc_4p/assemble_image) and splits before
    processing (quad_cam_split.py). Non-image topics listed in
    ``keep_topics`` (e.g. /imu) are copied through byte for byte.
    Returns the output path (default ``<stem>-split.bag``).
    """
    reader = RosbagReader(input_path)
    types = reader.topics
    composite_topic = _composite_topic(input_path, types, composite_topic)
    if output_path is None:
        p = Path(input_path)
        output_path = str(p.parent / (p.stem + "-split.bag"))

    want = [composite_topic, *(keep_topics or [])]
    decode_img = _DECODERS.get(types.get(composite_topic, ""))
    seen = 0
    with RosbagWriter(output_path) as w:
        # raw=True: pass-through topics keep their bytes and record
        # times; only the composite topic is decoded
        for topic, t, data in reader.read_messages(want, raw=True):
            if topic != composite_topic:
                w.write_raw(topic, types.get(topic, ""), t, data)
                continue
            if t < t_start:
                continue
            if seen % step:
                seen += 1
                continue
            seen += 1
            msg = decode_img(data) if decode_img else None
            img = msg.get("image") if msg else None
            if img is None:
                continue
            if img.ndim == 3:  # collapse color: the frontend consumes gray
                img = img.mean(axis=-1).astype(np.uint8)
            stamp = msg.get("stamp", t)
            for i, view in enumerate(split_composite(img, n_views)):
                w.write_image(view_topic_fmt.format(i=i), stamp, np.ascontiguousarray(view))
    return output_path


def photometric_align(img_l: np.ndarray, img_r: np.ndarray):
    """Match the right image's mean brightness to the left's (reference
    stereo_gen.py stereoPhotometicAlign — virtual pairs come from two
    physical cameras with different exposure)."""
    ml, mr = float(img_l.mean()), float(img_r.mean())
    img_r = np.clip(img_r * (ml / max(mr, 1e-6)), 0, 255)
    return img_l, img_r.astype(img_l.dtype)


def _square_rig(baseline: float) -> np.ndarray:
    """[4, 7] body_T_cam of the idealized square rig: cameras at exact
    90-degree yaw steps about y, symmetric ``baseline`` translations."""
    ext = np.zeros((4, 7))
    for i in range(4):
        yaw = np.deg2rad(90.0 * i)
        R = np_lie.quat_to_rotmat(np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)]))
        ext[i] = np.concatenate([R @ [baseline / 2, 0, baseline / 2], np_lie.rotmat_to_quat(R)])
    return ext


def generate_stereo_bag(
    input_path: str,
    output_path: str,
    calib: Dict,
    composite_topic: Optional[str] = None,
    step: int = 1,
    align: bool = True,
    device=None,
) -> int:
    """Rewrite a quadcam bag as rectified virtual-stereo pairs.

    The reference generates training/eval stereo from fisheye bags by
    undistorting adjacent cameras into co-facing pinhole halves
    (quadcam_tools/generate_stereo_from_bag.py + stereo_gen.py); this
    uses the virtual-stereo construction of the depth pipeline
    (depth/quadcam.py) and writes ``/virtual_stereo_{k}/left|right``
    Image topics. The four views of a frame are remapped in one call on
    ``device`` (``None``: the card).

    calib: {"cams": [{fx, fy, cx, cy, k2, k3, k4, k5} x4],
            "baseline": m, "out_hw": [H, W] (opt),
            "fov_deg": virtual FOV (opt),
            "extrinsics": [[x y z qx qy qz qw] x4] (opt)}
    ``extrinsics`` are the calibrated body_T_cam poses (e.g. from
    tools.calibration.calibrate_stereo_extrinsic chained around the
    rig); without them an idealized square rig is assumed — fine for
    synthetic data, mis-rectified on a real rig.
    Returns the number of stereo pairs written.
    """
    from d2slam_tpu_torch.depth.fisheye_undist import remap_bilinear
    from d2slam_tpu_torch.depth.quadcam import QuadcamConfig, build_virtual_stereo
    from d2slam_tpu_torch.geometry.cameras import KBParams
    from d2slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cams = calib["cams"]
    if len(cams) != 4:
        raise ValueError("quadcam calib needs 4 cameras")
    fisheyes = [KBParams.make(c["fx"], c["fy"], c["cx"], c["cy"], k2=c.get("k2", 0.0),
                              k3=c.get("k3", 0.0), k4=c.get("k4", 0.0), k5=c.get("k5", 0.0))
                for c in cams]
    if "extrinsics" in calib:
        ext = np.asarray(calib["extrinsics"], np.float64)
        if ext.shape != (4, 7):
            raise ValueError("extrinsics must be 4 x [x y z qx qy qz qw]")
    else:
        ext = _square_rig(float(calib.get("baseline", 0.3)))
    cfg = QuadcamConfig(out_hw=tuple(calib.get("out_hw", (240, 320))),
                        virtual_fov_deg=float(calib.get("fov_deg", 90.0)))
    pairs = build_virtual_stereo(fisheyes, ext, cfg, device=dev)
    maps = torch.cat([torch.stack([p.map_left for p in pairs]),
                      torch.stack([p.map_right for p in pairs])])
    sel = [p.cam_left for p in pairs] + [p.cam_right for p in pairs]

    reader = RosbagReader(input_path)
    composite_topic = _composite_topic(input_path, reader.topics, composite_topic)
    n_written = 0
    seen = 0
    with RosbagWriter(output_path) as w:
        for _, t, msg in reader.read_messages([composite_topic]):
            img = msg.get("image") if isinstance(msg, dict) else None
            if img is None:
                continue
            if seen % step:
                seen += 1
                continue
            seen += 1
            if img.ndim == 3:
                img = img.mean(axis=-1)
            views = np.stack(split_composite(np.asarray(img), 4)).astype(np.float32)
            src = torch.as_tensor(views, device=dev)[sel]
            out = torch.clamp(remap_bilinear(src, maps), 0, 255).to(torch.uint8).cpu().numpy()
            stamp = msg.get("stamp", t)
            for k in range(len(pairs)):
                left, right = out[k], out[len(pairs) + k]
                if align:
                    left, right = photometric_align(left, right)
                w.write_image(f"/virtual_stereo_{k}/left", stamp, left)
                w.write_image(f"/virtual_stereo_{k}/right", stamp, right)
                n_written += 1
    return n_written


def bag_info(path: str) -> Dict[str, Dict]:
    """Per-topic message counts and time span (rosbag-info equivalent)."""
    reader = RosbagReader(path)
    types = reader.topics
    stats: Dict[str, Dict] = {}
    for topic, t, _ in reader.read_messages(raw=True):
        s = stats.setdefault(topic, {"type": types.get(topic, "?"), "count": 0, "t0": t, "t1": t})
        s["count"] += 1
        s["t1"] = t
    return stats


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="d2slam_tpu_torch.tools.bag_tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("split", help="split composite quadcam images")
    sp.add_argument("-i", "--input", required=True)
    sp.add_argument("-o", "--output")
    sp.add_argument("-t", "--topic", help="composite image topic")
    sp.add_argument("-n", "--views", type=int, default=4)
    sp.add_argument("--step", type=int, default=1)
    sp.add_argument("--start", type=float, default=0.0)
    sp.add_argument("--keep", nargs="*", help="topics to copy through")

    sy = sub.add_parser("sync", help="align bags to a common start time")
    sy.add_argument("bags", nargs="+")
    sy.add_argument("--out-dir")
    sy.add_argument("--t-start", type=float, default=1.0)

    fl = sub.add_parser("filter", help="topic/time/step filter")
    fl.add_argument("-i", "--input", required=True)
    fl.add_argument("-o", "--output", required=True)
    fl.add_argument("--topics", nargs="*")
    fl.add_argument("--start", type=float)
    fl.add_argument("--end", type=float)
    fl.add_argument("--step", type=int, default=1)

    sg = sub.add_parser("stereo-gen", help="fisheye quadcam -> rectified virtual stereo")
    sg.add_argument("-i", "--input", required=True)
    sg.add_argument("-o", "--output", required=True)
    sg.add_argument("-c", "--calib", required=True,
                    help="YAML: cams (4x fx/fy/cx/cy/k2..k5), baseline, out_hw, fov_deg")
    sg.add_argument("-t", "--topic", help="composite image topic")
    sg.add_argument("--step", type=int, default=1)
    sg.add_argument("--no-align", action="store_true", help="skip photometric mean alignment")
    sg.add_argument("--cpu", action="store_true", help="remap on the CPU (default: the CUDA card)")

    inf = sub.add_parser("info", help="per-topic counts and spans")
    inf.add_argument("-i", "--input", required=True)

    a = ap.parse_args(argv)
    if a.cmd == "split":
        out = split_quadcam_bag(a.input, a.output, a.topic, a.views, a.step, a.start,
                                keep_topics=a.keep)
        print(f"wrote {out}")
    elif a.cmd == "sync":
        for out, dt in sync_bags(a.bags, a.out_dir, a.t_start):
            print(f"wrote {out} (shift {dt:+.3f} s)")
    elif a.cmd == "filter":
        n = filter_bag(a.input, a.output, a.topics, a.start, a.end, a.step)
        print(f"wrote {a.output} ({n} messages)")
    elif a.cmd == "stereo-gen":
        import yaml

        with open(a.calib) as f:
            calib = yaml.safe_load(f)
        n = generate_stereo_bag(a.input, a.output, calib, a.topic, a.step,
                                align=not a.no_align, device="cpu" if a.cpu else None)
        print(f"wrote {a.output} ({n} stereo pairs)")
    elif a.cmd == "info":
        for topic, s in sorted(bag_info(a.input).items()):
            span = s["t1"] - s["t0"]
            print(f"{topic:40s} {s['type']:32s} {s['count']:7d} msgs  {span:8.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
