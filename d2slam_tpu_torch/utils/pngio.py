"""Stdlib-only PNG encode/decode for 8-bit grayscale images (and an
8-bit RGB encoder for overlays).

Counterpart of ``d2slam_tpu/utils/pngio.py`` (a copy: the port imports
nothing of the JAX package). The port writes its datasets' PNGs with
:func:`png_encode_gray` and needs no Pillow; the native loader
(``runtime/native/pipeline.cpp`` ``png_decode``) reads them back.

The encoder emits filter type 0 (None) scanlines; the decoder handles
filters 0-2 (None/Sub/Up), which covers everything this encoder and
common grayscale writers produce. Average/Paeth-filtered inputs raise.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _encode(a: np.ndarray, color_type: int, level: int) -> bytes:
    h, w = a.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)  # 8-bit
    rows = a.reshape(h, -1)
    raw = np.empty((h, rows.shape[1] + 1), np.uint8)
    raw[:, 0] = 0  # filter: None
    raw[:, 1:] = rows
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def png_encode_gray(img: np.ndarray, level: int = 6) -> bytes:
    """Encode an 8-bit grayscale image ([H, W] uint8, or float in
    [0, 1]) as a PNG byte stream."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(np.asarray(a, np.float64) * 255.0 + 0.5, 0, 255
                    ).astype(np.uint8)
    if a.ndim != 2:
        raise ValueError(f"expected [H, W] grayscale, got {a.shape}")
    return _encode(a, 0, level)


def png_encode_rgb(img: np.ndarray, level: int = 6) -> bytes:
    """Encode an [H, W, 3] uint8 RGB image as a PNG byte stream."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {a.dtype} {a.shape}")
    return _encode(np.ascontiguousarray(a), 2, level)


def png_decode_gray(buf: bytes) -> np.ndarray:
    """Decode a grayscale PNG produced by :func:`png_encode_gray` (or
    any 8-bit gray, non-interlaced PNG using filters 0-2). Returns
    [H, W] uint8."""
    if buf[:8] != _SIG:
        raise ValueError("not a PNG stream")
    pos, w = 8, 0
    h = bitdepth = color = interlace = 0
    idat = bytearray()
    while pos + 8 <= len(buf):
        (ln,) = struct.unpack_from(">I", buf, pos)
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bitdepth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", data)
        elif tag == b"IDAT":
            idat += data
        elif tag == b"IEND":
            break
    if color != 0 or bitdepth != 8 or interlace != 0:
        raise ValueError(
            f"unsupported PNG (color={color} depth={bitdepth} "
            f"interlace={interlace}); wire images are 8-bit gray")
    # untrusted wire data (UDP image channel): cap the declared size and
    # bound the inflate output by it, so a crafted IHDR + high-ratio
    # deflate stream can't force a multi-GB allocation
    if not (0 < w <= 8192 and 0 < h <= 8192):
        raise ValueError(f"implausible PNG dims {w}x{h}")
    want = h * (w + 1)
    dec = zlib.decompressobj()
    raw = np.frombuffer(dec.decompress(bytes(idat), want), np.uint8)
    if raw.size != want:
        raise ValueError("PNG IDAT size mismatch")
    raw = raw.reshape(h, w + 1)
    filt, rows = raw[:, 0], raw[:, 1:].astype(np.int32)
    out = np.empty((h, w), np.int32)
    for y in range(h):
        r = rows[y]
        f = int(filt[y])
        if f == 0:
            out[y] = r
        elif f == 1:  # Sub: add left neighbor (prefix scan mod 256)
            out[y] = np.cumsum(r % 256, dtype=np.int64) % 256
        elif f == 2:  # Up
            out[y] = (r + (out[y - 1] if y else 0)) % 256
        else:
            raise ValueError(f"unsupported PNG filter {f}")
    return out.astype(np.uint8)
