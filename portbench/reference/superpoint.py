"""Plain SuperPoint: the VIO cells' reference for the extraction.

The published network (DeTone et al., CVPR-W 2018, as the reference
D2SLAM runs it): a VGG encoder conv(64)x2-pool-conv(64)x2-pool-
conv(128)x2-pool-conv(128)x2, a detector head 3x3x256 -> 1x1x65 (8x8
cells and a dustbin) and a descriptor head 3x3x256 -> 1x1x256; then
softmax, depth-to-space, non-maximum suppression (the first maximum in
raster order keeps a tie), the top K scores, a parabolic sub-pixel step
on the score map and bilinear sampling of the L2-normalised descriptors
at cell centres 8k + 3.5. Plain ``torch.nn.functional`` in float32 with
TF32 off; weights from the repository's ``.npz`` (HWIO convolutions).

``precision="fp8"`` is the control: every convolution's weights and
input rounded to float8 e4m3 (one scale a tensor, amax / 448), the
sums kept in float32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

ENCODER = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b"]
HEADS = ["convPa", "convPb", "convDa", "convDb"]
FP8_MAX = 448.0


def load_weights(path: str, device) -> Dict[str, tuple]:
    """{layer: (OIHW weight, bias)} float32 on ``device`` from an ``.npz``
    with ``<layer>/w`` or ``<layer>_w`` keys (HWIO)."""
    raw = np.load(path)
    out = {}
    for name in ENCODER + HEADS:
        def get(leaf):
            key = f"{name}/{leaf}" if f"{name}/{leaf}" in raw.files else f"{name}_{leaf}"
            return np.asarray(raw[key], np.float32)
        w = torch.as_tensor(get("w"), device=device).permute(3, 2, 0, 1).contiguous()
        out[name] = (w, torch.as_tensor(get("b"), device=device))
    return out


@contextlib.contextmanager
def full_f32():
    """float32 convolutions and products without TF32."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor."""
    scale = torch.clamp_min(x.abs().amax(), 1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def network(weights, img: torch.Tensor, precision: str = "f32"):
    """img [B, H, W] in [0, 1] -> (semi [B, 65, H/8, W/8], desc [B, 256,
    H/8, W/8] L2-normalised)."""
    q = fp8_round if precision == "fp8" else (lambda t: t)

    def conv(x, name):
        w, b = weights[name]
        return F.conv2d(q(x), q(w), padding=w.shape[-1] // 2) + b[:, None, None]

    with full_f32():
        x = img[:, None].float()
        for i, (a, b) in enumerate(zip(ENCODER[::2], ENCODER[1::2])):
            x = F.relu(conv(F.relu(conv(x, a)), b))
            if i < 3:
                x = F.max_pool2d(x, 2)
        semi = conv(F.relu(conv(x, "convPa")), "convPb")
        desc = conv(F.relu(conv(x, "convDa")), "convDb")
    return semi, desc / torch.clamp_min(torch.linalg.norm(desc, dim=1, keepdim=True), 1e-12)


def _window_max(x, r: int):
    k = 2 * r + 1
    x = F.max_pool2d(x[:, None], (k, 1), stride=1, padding=(r, 0))
    return F.max_pool2d(x, (1, k), stride=1, padding=(0, r))[:, 0]


def nms(scores, r: int):
    """Local maxima of (2r+1)^2 windows; of equal maxima in a window the
    first in raster order stays."""
    is_max = scores == _window_max(scores, r)
    H, W = scores.shape[-2:]
    rank = -torch.arange(H * W, device=scores.device, dtype=torch.float32).reshape(1, H, W)
    rank = torch.where(is_max, rank, torch.full_like(scores, -float("inf")))
    keep = is_max & (rank == _window_max(rank, r))
    return torch.where(keep, scores, torch.zeros_like(scores))


def sample_descriptors(desc, kpts):
    """desc [B, D, Hc, Wc], kpts [B, K, 2] (x, y) -> [B, K, D] normalised."""
    B, D, Hc, Wc = desc.shape
    d = desc.permute(0, 2, 3, 1)
    gx = (kpts[..., 0] - 3.5) / 8.0
    gy = (kpts[..., 1] - 3.5) / 8.0
    x0 = torch.clamp(torch.floor(gx).long(), 0, Wc - 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, Hc - 1)
    x1 = torch.clamp(x0 + 1, 0, Wc - 1)
    y1 = torch.clamp(y0 + 1, 0, Hc - 1)
    wx = torch.clamp(gx - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(gy - y0, 0.0, 1.0)[..., None]
    bi = torch.arange(B, device=kpts.device)[:, None]
    s = (d[bi, y0, x0] * (1 - wx) * (1 - wy) + d[bi, y0, x1] * wx * (1 - wy)
         + d[bi, y1, x0] * (1 - wx) * wy + d[bi, y1, x1] * wx * wy)
    return s / torch.clamp_min(torch.linalg.norm(s, dim=-1, keepdim=True), 1e-12)


class Keypoints(NamedTuple):
    kpts: torch.Tensor     # [B, K, 2]
    valid: torch.Tensor    # [B, K]
    desc: torch.Tensor     # [B, K, D]
    desc_map: torch.Tensor  # [B, D, Hc, Wc]


def extract(weights, img_u8: torch.Tensor, max_keypoints: int, nms_radius: int,
            threshold: float, precision: str = "f32") -> Keypoints:
    """Keypoints of uint8 images [B, H, W] (scaled to [0, 1])."""
    img = img_u8.float() / 255.0
    B, H, W = img.shape
    semi, desc_map = network(weights, img, precision)
    scores = F.pixel_shuffle(torch.softmax(semi, dim=1)[:, :64], 8)[:, 0]
    top, idx = torch.topk(nms(scores, nms_radius).reshape(B, -1), max_keypoints, dim=1)
    yi, xi = idx // W, idx % W
    xc, yc = torch.clamp(xi, 1, W - 2), torch.clamp(yi, 1, H - 2)
    flat = scores.reshape(B, -1)

    def at(y, x):
        return torch.gather(flat, 1, y * W + x)

    s0 = at(yc, xc)

    def para(sm, sp):
        den = sm - 2 * s0 + sp
        den = torch.where(den.abs() < 1e-9, torch.full_like(den, -1e-9), den)
        return torch.clamp(0.5 * (sm - sp) / den, -0.5, 0.5)

    kpts = torch.stack([xi.float() + para(at(yc, xc - 1), at(yc, xc + 1)),
                        yi.float() + para(at(yc - 1, xc), at(yc + 1, xc))], dim=-1)
    return Keypoints(kpts, top > threshold, sample_descriptors(desc_map, kpts), desc_map)
