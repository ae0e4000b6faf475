"""HitNet-style learned stereo disparity network in PyTorch.

Counterpart of ``d2slam_tpu/depth/hitnet.py`` (reference HitNet
TensorRT engines, quadcam_depth_est/include/hitnet.hpp, models at
320x240). The architecture follows HitNet's shape: a shared multi-scale
feature extractor, a coarse disparity from a matching cost over the
disparity range at the coarsest scale, and per-scale refinement blocks
predicting disparity updates. Weights load from ``.npz`` (the JAX
package's layout, HWIO convs); a seeded random init keeps the pipeline
testable.

Convolutions are ``F.conv2d`` (they are stock convolutions in the JAX
package too, outside any kernel). Public functions keep the JAX
package's NHWC layout; parameters are held as OIHW tensors.

The trained HitNet (the reference's ONNX export) runs through the
port's ONNX lowering, ``tools/onnx_torch.py`` (``load_trained_hitnet``).
The export is not in this repository: the caller names its path.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from d2slam_tpu_torch.tools.onnx_torch import load_onnx_module
from d2slam_tpu_torch.utils.device import cudnn_fp32, resolve_device


@dataclasses.dataclass(frozen=True)
class HitNetConfig:
    max_disp: int = 64
    feat_ch: int = 16
    levels: int = 3


def _layer_shapes(cfg: HitNetConfig):
    """(name, k, cin, cout) of every conv, in the JAX package's order."""
    c = cfg.feat_ch
    shapes = [("stem", 3, 1, c)]
    for l in range(cfg.levels):
        shapes += [(f"enc{l}", 3, c, c), (f"enc{l}b", 3, c, c)]
    shapes += [(f"ref{l}", 3, c + 1, c) for l in range(cfg.levels)]
    shapes.append(("ref_out", 3, c, 1))
    return shapes


def hitnet_params_from_numpy(params: Dict, device=None) -> Dict:
    """``{layer: {"w": HWIO, "b": [cout]}}`` (numpy, the JAX layout) ->
    the port's ``{layer: {"w": OIHW f32 tensor, "b": tensor}}``."""
    dev = resolve_device(device)
    return {
        n: {"w": torch.as_tensor(np.array(p["w"], np.float32))
            .permute(3, 2, 0, 1).contiguous().to(dev),
            "b": torch.as_tensor(np.array(p["b"], np.float32)).to(dev)}
        for n, p in params.items()
    }


def hitnet_init(generator: torch.Generator,
                cfg: HitNetConfig = HitNetConfig(), device=None) -> Dict:
    """He-normal weights drawn from ``generator`` (a CPU generator; the
    draw does not depend on the device), zero biases."""
    dev = resolve_device(device)
    params = {}
    for name, k, cin, cout in _layer_shapes(cfg):
        w = torch.randn((cout, cin, k, k), generator=generator) * math.sqrt(
            2.0 / (k * k * cin))
        params[name] = {"w": w.to(dev), "b": torch.zeros(cout, device=dev)}
    return params


def load_params(path: str, device=None) -> Dict:
    """Read a ``.npz`` with ``{layer}_w`` (HWIO) / ``{layer}_b`` keys."""
    raw = np.load(path)
    names = {k.rsplit("_", 1)[0] for k in raw.files}
    return hitnet_params_from_numpy(
        {n: {"w": raw[f"{n}_w"], "b": raw[f"{n}_b"]} for n in names}, device)


def _same_pad(n: int, k: int, stride: int):
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, p, stride: int = 1):
    """NCHW conv with XLA's SAME padding (the extra pixel of an odd
    total goes to the bottom/right, which matters at stride 2)."""
    k = p["w"].shape[-1]
    top, bottom = _same_pad(x.shape[-2], k, stride)
    lft, rgt = _same_pad(x.shape[-1], k, stride)
    x = F.pad(x, (lft, rgt, top, bottom))
    return F.conv2d(x, p["w"], p["b"], stride=stride)


def _features(params, img, cfg):
    """Multi-scale features, finest first. img: [B, 1, H, W]."""
    x = F.relu(_conv(img, params["stem"]))
    feats = []
    for l in range(cfg.levels):
        x = F.relu(_conv(x, params[f"enc{l}"], stride=2))
        x = F.relu(_conv(x, params[f"enc{l}b"]))
        feats.append(x)
    return feats


def _cost_volume_init(fl, fr, max_disp: int):
    """Coarse disparity [B, 1, H, W] by feature matching at the coarsest
    scale: soft-argmin over the mean absolute feature difference."""
    W = fl.shape[-1]
    col = torch.arange(W, device=fl.device)
    costs = []
    for d in range(max_disp):
        c = (fl - torch.roll(fr, d, dims=-1)).abs().mean(dim=1)
        costs.append(torch.where(col >= d, c, torch.full_like(c, 1e3)))
    costs = torch.stack(costs, dim=1)                        # [B, D, H, W]
    soft = torch.softmax(-costs * 8.0, dim=1)
    ds = torch.arange(max_disp, dtype=fl.dtype, device=fl.device)
    return (soft * ds[None, :, None, None]).sum(dim=1, keepdim=True)


def _upsample2(x):
    """2x bilinear with half-pixel centres (``jax.image.resize``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def hitnet_apply(params: Dict, left, right, cfg: HitNetConfig = HitNetConfig()):
    """left/right: [B, H, W, 1] rectified pair, H and W multiples of
    2**levels. Returns disparity [B, H, W] at full resolution."""
    with cudnn_fp32():
        fl = _features(params, left.permute(0, 3, 1, 2), cfg)
        fr = _features(params, right.permute(0, 3, 1, 2), cfg)
        scale = 2 ** cfg.levels
        d = _cost_volume_init(fl[-1], fr[-1], max(cfg.max_disp // scale, 4))
        # coarse-to-fine refinement
        for l in range(cfg.levels - 1, -1, -1):
            h = F.relu(_conv(torch.cat([fl[l], d], dim=1), params[f"ref{l}"]))
            d = F.relu(d + _conv(h, params["ref_out"]))
            if l > 0:
                d = _upsample2(d) * 2.0
        d = _upsample2(d) * 2.0  # back to full resolution
    return d[:, 0]


TRAINED_HITNET_EXPORT = "hitnet_1x240x320_model_float32.onnx"


class TrainedHitNet:
    """A trained HitNet ONNX export lowered to torch ops on one device:
    ``net(left, right)`` maps a rectified [H, W] pair in [0, 1] (the
    reference feeds gray/255: quadcam_depth_est_trt.cpp:319-329) to
    disparity [H, W]. The input resolution is the export's
    (``input_hw``; 240x320 for the reference models)."""

    def __init__(self, module):
        _, c, h, w = module.input_shapes[0]
        if c != 2:
            raise ValueError(f"expected 2-channel (left,right) input, got {c}")
        self.module = module
        self.input_hw = (h, w)

    @property
    def params(self):
        return self.module.params

    @property
    def device(self) -> torch.device:
        return self.module.device

    def __call__(self, left, right):
        x = torch.stack([left, right])[None].to(self.device, self.module.runner.dtype)
        y = self.module(x)
        return y.reshape(y.shape[-3:-1] if y.shape[-1] == 1 else y.shape[-2:])


def load_trained_hitnet(path: str = "", dtype=torch.float32, device=None) -> TrainedHitNet:
    """Load a trained HitNet ONNX export (the reference's
    models/hitnet_series/hitnet_1x240x320_model_float32.onnx, or its
    float16_quant variant) through the ONNX lowering. The repository
    does not carry the export: without a path that exists this raises
    ``FileNotFoundError``."""
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            f"trained HitNet export not found: {path or TRAINED_HITNET_EXPORT!r} "
            f"(pass the path of the reference's {TRAINED_HITNET_EXPORT})")
    return TrainedHitNet(load_onnx_module(path, dtype=dtype, device=device))
