"""MobileNetVLAD global descriptor as a torch module.

Counterpart of ``d2slam_tpu/frontend/netvlad.py`` (reference
MobileNetVLAD ONNX/TensorRT inference,
d2frontend/include/d2frontend/CNN/mobilenetvlad_onnx.h: 4096-d global
descriptor, optional PCA to 1024 with renormalization). Backbone: a
MobileNetV2-style depthwise-separable stack truncated at stride 16
(relu6); head: a NetVLAD layer (soft assignment to K clusters, residual
aggregation, intra + global L2 normalization), then the optional PCA and
gate-calibration component.

Parameters use the JAX package's layout (nested dict of numpy arrays,
HWIO convolutions), as ``weights/netvlad_synth.npz`` stores them; the
module's structure is read from them. Convolutions pad as XLA's
``SAME`` does: a 3x3 stride-2 convolution on an even side pads one
pixel at the bottom/right and none at the top/left.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d2slam_tpu_torch.utils.device import cudnn_fp32, resolve_device, to_f32


@dataclasses.dataclass(frozen=True)
class NetVLADConfig:
    num_clusters: int = 64
    feat_dim: int = 64        # backbone output channels
    output_dim: int = 4096    # num_clusters * feat_dim
    pca_dim: int = 0          # reference: netvlad_pca_dims 1024
    width_mult: float = 1.0   # backbone channel multiplier (init only)


# (name, stride); a "conv" stage has {"w", "b"}, a "dsconv" stage {"dw", "pw"}
_STAGES = (("stem", 2), ("ds1", 2), ("ds2", 2), ("ds3", 2), ("ds4", 1))


def _backbone_spec(cfg: NetVLADConfig):
    """Channel plan scaled by ``width_mult``; the final stage always
    lands on ``feat_dim`` (the VLAD descriptor dimension)."""
    def c(n):
        return max(8, int(round(n * cfg.width_mult)))

    return [
        ("stem", "conv", 1, c(16)),
        ("ds1", "dsconv", c(16), c(32)),
        ("ds2", "dsconv", c(32), c(64)),
        ("ds3", "dsconv", c(64), cfg.feat_dim),
        ("ds4", "dsconv", cfg.feat_dim, cfg.feat_dim),
    ]


def load_params(path: str) -> Dict:
    """Read a NetVLAD ``.npz`` (keys ``ds1/dw/w`` ...) into the nested
    dict of numpy arrays the JAX package uses."""
    raw = np.load(path)
    out: Dict = {}
    for name in raw.files:
        parts = name.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = np.asarray(raw[name])
    return out


def netvlad_cfg_from_params(params: Dict) -> NetVLADConfig:
    """The config implied by a weight tree (cluster count and feature dim
    from ``vlad_centers``, pca_dim from the stored projection)."""
    K, D = params["vlad_centers"].shape
    pca = params.get("pca")
    pca_dim = int(pca["proj"].shape[-1]) if pca is not None else 0
    return NetVLADConfig(num_clusters=int(K), feat_dim=int(D), output_dim=int(K * D),
                         pca_dim=pca_dim)


def netvlad_output_dim(params: Dict) -> int:
    """Dimensionality of the descriptor the module emits (PCA dims, plus
    one for the gate-calibration constant component)."""
    cfg = netvlad_cfg_from_params(params)
    d = cfg.pca_dim or cfg.output_dim
    pca = params.get("pca")
    if pca is not None and "alpha" in pca:
        d += 1
    return d


def netvlad_init(generator: torch.Generator, cfg: NetVLADConfig = NetVLADConfig()) -> Dict:
    """Random parameters (He-normal convolutions) in the JAX layout, as
    numpy float32, drawn from ``generator``."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).numpy()

    def conv(k, cin, cout, depthwise=False):
        fan = k * k * (1 if depthwise else cin)
        w = normal((k, k, 1 if depthwise else cin, cout), math.sqrt(2.0 / fan))
        return {"w": w, "b": np.zeros(cout, np.float32)}

    params: Dict = {}
    for name, kind, cin, cout in _backbone_spec(cfg):
        if kind == "conv":
            params[name] = conv(3, cin, cout)
        else:
            params[name] = {"dw": conv(3, 1, cin, depthwise=True), "pw": conv(1, cin, cout)}
    K, D = cfg.num_clusters, cfg.feat_dim
    params["vlad_assign"] = conv(1, D, K)
    params["vlad_centers"] = normal((K, D), 0.1)
    if cfg.pca_dim:
        proj = np.zeros((cfg.output_dim, cfg.pca_dim), np.float32)
        proj[:cfg.pca_dim] = np.eye(cfg.pca_dim, dtype=np.float32)
        params["pca"] = {"proj": proj, "mean": np.zeros(cfg.output_dim, np.float32)}
    return params


def _same_pad(x, k: int, stride: int):
    """XLA ``SAME`` padding: total = max((ceil(n/s) - 1)·s + k - n, 0),
    the smaller half before."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):   # F.pad order: last dim first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class NetVLAD(nn.Module):
    """NetVLAD on one device. ``params``: the JAX parameter tree (numpy),
    e.g. from :func:`load_params`. ``device`` defaults to ``cuda`` and
    raises without a card unless ``device="cpu"``. ``calls`` counts the
    forward passes."""

    def __init__(self, params: Dict, device=None):
        super().__init__()
        dev = resolve_device(device)

        def t(x):
            return to_f32(x, dev)

        def conv_w(p):   # HWIO -> [Cout, Cin/groups, kh, kw]
            return t(p["w"]).permute(3, 2, 0, 1).contiguous()

        self.stages = []
        for name, stride in _STAGES:
            p = params[name]
            if "dw" in p:
                convs = [(conv_w(p["dw"]), t(p["dw"]["b"]), stride, p["dw"]["w"].shape[-1]),
                         (conv_w(p["pw"]), t(p["pw"]["b"]), 1, 1)]
            else:
                convs = [(conv_w(p), t(p["b"]), stride, 1)]
            self.stages.append(convs)
        self.assign_w = conv_w(params["vlad_assign"])
        self.assign_b = t(params["vlad_assign"]["b"])
        self.centers = t(params["vlad_centers"])
        pca = params.get("pca")
        self.pca = None if pca is None else (t(pca["mean"]), t(pca["proj"]))
        self.gate = (None if pca is None or "alpha" not in pca
                     else (float(pca["alpha"]), float(pca["beta"])))
        self.output_dim = netvlad_output_dim(params)
        self.calls = 0

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def forward(self, img):
        """img: [B, H, W] float in [0, 1] -> [B, output_dim] unit vectors."""
        self.calls += 1
        x = img[:, None]
        with cudnn_fp32():
            for convs in self.stages:
                for w, b, stride, groups in convs:
                    k = w.shape[-1]
                    x = F.conv2d(_same_pad(x, k, stride), w, b, stride=stride, groups=groups)
                    x = F.relu6(x)   # gradient 0 at 0 and 6, as jax.nn.relu6
            logits = F.conv2d(x, self.assign_w, self.assign_b)
        B, D = x.shape[:2]
        feats = x.flatten(2).transpose(1, 2)                            # [B, N, D]
        assign = torch.softmax(logits.flatten(2).transpose(1, 2), dim=-1)  # [B, N, K]
        agg = torch.einsum("bnk,bnd->bkd", assign, feats)
        V = agg - assign.sum(dim=1)[..., None] * self.centers[None]
        V = V / torch.clamp_min(torch.linalg.norm(V, dim=-1, keepdim=True), 1e-12)
        v = V.reshape(B, -1)
        v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)
        if self.pca is not None:
            mean, proj = self.pca
            v = (v - mean) @ proj
            v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)
            if self.gate is not None:
                # gate calibration: a constant unit-sphere component maps
                # cosine similarity affinely, s' = alpha^2 s + beta^2
                alpha, beta = self.gate
                v = torch.cat([v * alpha, torch.full_like(v[:, :1], beta)], dim=-1)
        return v


class OnnxNetVLAD(nn.Module):
    """A MobileNetVLAD ONNX export lowered to torch ops, with
    :class:`NetVLAD`'s contract: img [B, H, W] in [0, 1] -> [B, D] unit
    vectors, optionally PCA-projected and renormalized."""

    def __init__(self, module, pca=None):
        super().__init__()
        self.module = module
        self.rank = len(module.input_shapes[0])
        dev = module.device
        self.pca = None if pca is None else tuple(to_f32(a, dev) for a in pca)
        self.calls = 0

    @property
    def device(self) -> torch.device:
        return self.module.device

    def forward(self, img):
        self.calls += 1
        vs = []
        for x in img:   # the export takes one image
            v = self.module(x[None, ..., None] if self.rank == 4 else x[None])
            vs.append((v[0] if isinstance(v, tuple) else v).reshape(-1))
        v = torch.stack(vs)
        v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)
        if self.pca is not None:
            mean, proj = self.pca
            v = (v - mean) @ proj
            v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)
        return v


def netvlad_from_onnx(path: str, pca=None, device=None) -> OnnxNetVLAD:
    """Load a MobileNetVLAD ONNX export (JAX ``netvlad_from_onnx``).

    The reference feeds NHWC [1, H, W, 1] into tensor "image:0" and
    reads "descriptor:0" [1, 4096]
    (d2frontend/include/d2frontend/CNN/mobilenetvlad_onnx.h:20-32),
    optionally projecting to 1024-d with PCA + renormalization
    (mobilenetvlad_onnx.h:49-74): pass pca=(mean [D], proj [D, d])."""
    from d2slam_tpu_torch.tools.onnx_torch import load_onnx_module

    return OnnxNetVLAD(load_onnx_module(path, device=device), pca)


def quantize_descriptor_int8(v):
    """int8 wire quantization: scale by max/127 (reference
    d2frontend_types.h:228-238 toLCM descriptor packing)."""
    scale = torch.amax(torch.abs(v), dim=-1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(v / torch.clamp_min(scale, 1e-12)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_descriptor_int8(q, scale):
    v = q.to(scale.dtype) * scale
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)
