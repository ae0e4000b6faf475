"""ROS1 bag (v2.0) reader/writer, dependency-free.

Counterpart of ``d2slam_tpu/datasets/rosbag.py``. The reference consumes
datasets as rosbags replayed through ROS (its README's dataset
instructions, the d2frontend image callbacks); this module reads the
same .bag files with no ROS install: the bag container (records,
chunks, connections) and the ROS1 message wire format are parsed in
Python, payloads with numpy. Bags written by either package read the
same in the other.

Supported:
  * bag format 2.0, uncompressed and bz2 chunks (lz4 if `lz4` exists);
  * sensor_msgs/Imu, sensor_msgs/Image (mono8/8UC1/mono16/rgb8/bgr8),
    sensor_msgs/CompressedImage (PNG via the port's native decoder,
    other formats via Pillow where it is installed),
    geometry_msgs/PoseStamped, nav_msgs/Odometry;
  * unknown types come out as raw bytes for user-side decoding.

Also includes a minimal writer (uncompressed, index-free) for the bag
split/sync tooling and round-trip tests.
"""
from __future__ import annotations

import bz2
import io
import struct
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from d2slam_tpu_torch.runtime.pipeline import decode_png

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    pos = 0
    while pos < len(buf):
        (flen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        field = buf[pos : pos + flen]
        pos += flen
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1 :]
    return fields


def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        f = k + b"=" + v
        out += struct.pack("<I", len(f)) + f
    return out


def _iter_records(buf: bytes, pos: int = 0) -> Iterator[Tuple[Dict, bytes]]:
    n = len(buf)
    while pos + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        header = _parse_header(buf[pos : pos + hlen])
        pos += hlen
        (dlen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        data = buf[pos : pos + dlen]
        pos += dlen
        yield header, data


# ---------------------------------------------------------------------------
# ROS1 message deserialization
# ---------------------------------------------------------------------------


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def f64(self, n=1):
        v = np.frombuffer(self.buf, np.float64, n, self.pos)
        self.pos += 8 * n
        return v

    def string(self):
        n = self.u32()
        s = self.buf[self.pos : self.pos + n]
        self.pos += n
        return s.decode(errors="replace")

    def bytes_(self, n):
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def header(self):
        seq = self.u32()
        secs, nsecs = self.u32(), self.u32()
        frame = self.string()
        return {"seq": seq, "stamp": secs + nsecs * 1e-9, "frame_id": frame}


def _decode_imu(buf: bytes) -> Dict:
    c = _Cursor(buf)
    h = c.header()
    quat = c.f64(4).copy()          # x, y, z, w
    c.f64(9)                        # orientation covariance
    gyr = c.f64(3).copy()
    c.f64(9)
    acc = c.f64(3).copy()
    c.f64(9)
    return {"stamp": h["stamp"], "frame_id": h["frame_id"],
            "orientation": quat, "gyr": gyr, "acc": acc}


def _decode_image(buf: bytes) -> Dict:
    c = _Cursor(buf)
    h = c.header()
    height, width = c.u32(), c.u32()
    encoding = c.string()
    c.u8()                          # is_bigendian
    step = c.u32()
    n = c.u32()
    data = c.bytes_(n)
    if encoding in ("mono8", "8UC1"):
        img = np.frombuffer(data, np.uint8).reshape(height, step)[:, :width]
    elif encoding in ("mono16", "16UC1"):
        img = np.frombuffer(data, np.uint16).reshape(
            height, step // 2)[:, :width]
    elif encoding in ("rgb8", "bgr8"):
        img = np.frombuffer(data, np.uint8).reshape(
            height, step // 3 if step >= 3 * width else width, 3
        )[:, :width]
        if encoding == "bgr8":
            img = img[..., ::-1]
    else:
        img = data  # unknown encoding: raw bytes
    return {"stamp": h["stamp"], "frame_id": h["frame_id"],
            "encoding": encoding, "image": img}


def _decode_with_pil(data: bytes) -> Optional[np.ndarray]:
    """JPEG (and PNGs the native decoder refuses) through Pillow, a
    lazy import as in the JAX package; None without Pillow or when the
    bytes do not decode (the message then keeps its raw ``data``)."""
    try:
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        return None
    try:
        return np.asarray(Image.open(io.BytesIO(data)))
    except (UnidentifiedImageError, OSError):
        return None


def _decode_compressed_image(buf: bytes) -> Dict:
    c = _Cursor(buf)
    h = c.header()
    fmt = c.string()
    n = c.u32()
    data = c.bytes_(n)
    img = None
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        try:
            img = decode_png(data)
        except ValueError:
            img = None  # palette/interlaced: Pillow below, where installed
    if img is None:
        img = _decode_with_pil(data)
    return {"stamp": h["stamp"], "frame_id": h["frame_id"],
            "format": fmt, "image": img, "data": data if img is None else None}


def _decode_pose_stamped(buf: bytes) -> Dict:
    c = _Cursor(buf)
    h = c.header()
    pos = c.f64(3).copy()
    quat = c.f64(4).copy()
    return {"stamp": h["stamp"], "frame_id": h["frame_id"],
            "pose": np.concatenate([pos, quat])}


def _decode_odometry(buf: bytes) -> Dict:
    c = _Cursor(buf)
    h = c.header()
    child = c.string()
    pos = c.f64(3).copy()
    quat = c.f64(4).copy()
    c.f64(36)  # pose covariance
    lin = c.f64(3).copy()
    ang = c.f64(3).copy()
    return {"stamp": h["stamp"], "frame_id": h["frame_id"],
            "child_frame_id": child,
            "pose": np.concatenate([pos, quat]),
            "vel": lin, "ang_vel": ang}


_DECODERS = {
    "sensor_msgs/Imu": _decode_imu,
    "sensor_msgs/Image": _decode_image,
    "sensor_msgs/CompressedImage": _decode_compressed_image,
    "geometry_msgs/PoseStamped": _decode_pose_stamped,
    "nav_msgs/Odometry": _decode_odometry,
}


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class RosbagReader:
    """Sequential rosbag reader. Messages come out in file order (which
    rosbag records in time order per chunk)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._buf = f.read()
        if not self._buf.startswith(_MAGIC):
            raise ValueError(f"{path}: not a ROS bag v2.0")
        self.connections: Dict[int, Dict] = {}
        self._scan_connections()

    def _scan_connections(self):
        # rosbag repeats connection records at the top level (after the
        # chunks, before the index), so a cheap top-level pass usually
        # suffices; decompressing every chunk just to harvest
        # connections would decompress multi-GB bags during __init__.
        chunks = []
        for header, data in _iter_records(self._buf, len(_MAGIC)):
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                self._add_connection(header, data)
            elif op == OP_CHUNK:
                chunks.append((header, data))
        if not self.connections:  # writer without top-level records
            for header, data in chunks:
                blob = self._decompress(header, data)
                for h2, d2 in _iter_records(blob):
                    if h2.get(b"op", b"\x00")[0] == OP_CONNECTION:
                        self._add_connection(h2, d2)

    def _add_connection(self, header, data):
        conn = struct.unpack("<I", header[b"conn"])[0]
        info = _parse_header(data)
        self.connections[conn] = {
            "topic": header.get(b"topic", info.get(b"topic", b"")).decode(),
            "type": info.get(b"type", b"").decode(),
        }

    @staticmethod
    def _decompress(header, data) -> bytes:
        comp = header.get(b"compression", b"none").decode()
        if comp == "none":
            return data
        if comp == "bz2":
            return bz2.decompress(data)
        if comp == "lz4":
            try:
                import lz4.frame

                return lz4.frame.decompress(data)
            except ImportError as e:
                raise NotImplementedError(
                    "lz4-compressed bag and no lz4 module") from e
        raise NotImplementedError(f"bag compression {comp}")

    @property
    def topics(self) -> Dict[str, str]:
        return {c["topic"]: c["type"] for c in self.connections.values()}

    def read_messages(
        self, topics: Optional[Sequence[str]] = None, raw: bool = False,
    ) -> Iterator[Tuple[str, float, object]]:
        """Yield (topic, record_time_sec, message). Known types decode
        to dicts (see _DECODERS); unknown or raw=True yield bytes."""
        want = set(topics) if topics else None

        def emit(header, data):
            conn = struct.unpack("<I", header[b"conn"])[0]
            info = self.connections.get(conn)
            if info is None:
                return None
            topic = info["topic"]
            if want is not None and topic not in want:
                return None
            secs, nsecs = struct.unpack("<II", header[b"time"])
            t = secs + nsecs * 1e-9
            if raw:
                return topic, t, data
            dec = _DECODERS.get(info["type"])
            return topic, t, (dec(data) if dec else data)

        for header, data in _iter_records(self._buf, len(_MAGIC)):
            op = header.get(b"op", b"\x00")[0]
            if op == OP_MSG:
                out = emit(header, data)
                if out:
                    yield out
            elif op == OP_CHUNK:
                blob = self._decompress(header, data)
                for h2, d2 in _iter_records(blob):
                    if h2.get(b"op", b"\x00")[0] == OP_MSG:
                        out = emit(h2, d2)
                        if out:
                            yield out

    def play_vio(self, imu_topic: str, image_topics: Sequence[str],
                 frame_slop: float = 0.005) -> Iterator[tuple]:
        """EuRoCDataset.play-compatible event stream from a bag:
        ('imu', t, acc, gyr) and ('frame', t, [images]) with approximate
        stereo time sync (the reference's message_filters
        ApproximateTime sync, d2frontend.cpp:354-389)."""
        pending: Dict[str, Tuple[float, np.ndarray]] = {}
        n_cams = len(image_topics)
        for topic, t, msg in self.read_messages(
                [imu_topic, *image_topics]):
            if topic == imu_topic:
                yield ("imu", msg["stamp"], msg["acc"], msg["gyr"])
                continue
            img = msg.get("image")
            if img is None:
                continue
            pending[topic] = (msg["stamp"], img)
            if len(pending) == n_cams:
                stamps = [pending[tp][0] for tp in image_topics]
                if max(stamps) - min(stamps) <= frame_slop:
                    yield ("frame", stamps[0],
                           [pending[tp][1] for tp in image_topics])
                    pending.clear()
                else:  # drop the oldest view, keep waiting
                    oldest = min(pending, key=lambda k: pending[k][0])
                    del pending[oldest]


# ---------------------------------------------------------------------------
# minimal writer (uncompressed, single implicit chunk layout)
# ---------------------------------------------------------------------------


class RosbagWriter:
    """Writes a valid (index-free) v2.0 bag: bag header, connections,
    plain message records. rosbag-compatible readers that tolerate a
    missing index (like RosbagReader above, and `rosbag reindex`)
    consume it directly."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._conns: Dict[str, int] = {}
        # bag header record (rosbag pads its data to 4096 bytes)
        self._write_record({b"op": bytes([OP_BAGHDR]),
                            b"index_pos": struct.pack("<Q", 0),
                            b"conn_count": struct.pack("<I", 0),
                            b"chunk_count": struct.pack("<I", 0)},
                           b" " * 4096)

    def _write_record(self, header: Dict[bytes, bytes], data: bytes):
        h = _encode_header(header)
        self._f.write(struct.pack("<I", len(h)) + h)
        self._f.write(struct.pack("<I", len(data)) + data)

    def _connection(self, topic: str, msgtype: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        cid = len(self._conns)
        self._conns[topic] = cid
        info = _encode_header({
            b"topic": topic.encode(),
            b"type": msgtype.encode(),
            b"md5sum": b"*",
            b"message_definition": b"",
        })
        self._write_record(
            {b"op": bytes([OP_CONNECTION]),
             b"conn": struct.pack("<I", cid),
             b"topic": topic.encode()},
            info,
        )
        return cid

    @staticmethod
    def _split_time(stamp: float) -> Tuple[int, int]:
        if stamp < 0:
            raise ValueError(
                f"ROS time is unsigned; got stamp {stamp} (offset your "
                "timeline to start >= 0)")
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        if nsecs >= 1_000_000_000:
            secs += 1
            nsecs -= 1_000_000_000
        return secs, nsecs

    def write_raw(self, topic: str, msgtype: str, stamp: float,
                  payload: bytes):
        cid = self._connection(topic, msgtype)
        secs, nsecs = self._split_time(stamp)
        self._write_record(
            {b"op": bytes([OP_MSG]),
             b"conn": struct.pack("<I", cid),
             b"time": struct.pack("<II", secs, nsecs)},
            payload,
        )

    @staticmethod
    def _ser_header(stamp: float, frame_id: str = "") -> bytes:
        secs, nsecs = RosbagWriter._split_time(stamp)
        fid = frame_id.encode()
        return struct.pack("<III", 0, secs, nsecs) + struct.pack(
            "<I", len(fid)) + fid

    def write_imu(self, topic: str, stamp: float, acc, gyr):
        buf = self._ser_header(stamp)
        buf += np.zeros(4, np.float64).tobytes()       # orientation
        buf += np.full(9, -1.0, np.float64).tobytes()  # its covariance
        buf += np.asarray(gyr, np.float64).tobytes()
        buf += np.zeros(9, np.float64).tobytes()
        buf += np.asarray(acc, np.float64).tobytes()
        buf += np.zeros(9, np.float64).tobytes()
        self.write_raw(topic, "sensor_msgs/Imu", stamp, buf)

    def write_image(self, topic: str, stamp: float, img: np.ndarray):
        img = np.asarray(img)
        if img.dtype != np.uint8 or img.ndim != 2:
            raise ValueError("writer supports mono8 [H, W] uint8")
        H, W = img.shape
        buf = self._ser_header(stamp)
        buf += struct.pack("<II", H, W)
        enc = b"mono8"
        buf += struct.pack("<I", len(enc)) + enc
        buf += struct.pack("<BI", 0, W)
        raw = np.ascontiguousarray(img).tobytes()
        buf += struct.pack("<I", len(raw)) + raw
        self.write_raw(topic, "sensor_msgs/Image", stamp, buf)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
