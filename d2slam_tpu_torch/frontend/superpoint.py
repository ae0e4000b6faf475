"""SuperPoint keypoint detector + descriptor in PyTorch.

Counterpart of ``d2slam_tpu/frontend/superpoint.py`` (reference
TensorRT SuperPoint, d2frontend/src/CNN/superpoint_tensorrt.cpp, and
its post-processing, superpoint_common.cpp:12-99): shared VGG encoder
conv(64)x2-pool-conv(64)x2-pool-conv(128)x2-pool-conv(128)x2, detector
head 3x3x256 -> 1x1x65 (8x8 cells + dustbin), descriptor head
3x3x256 -> 1x1x256, then NMS, top-K, parabolic subpixel refinement and
bilinear descriptor sampling.

Compute dtypes:
* ``"bfloat16"``: conv1a+conv1b+pool always run as the fused stem
  (``ops/superpoint_stem.py``: the Hopper kernel on a CUDA tensor, its
  plain version on a CPU tensor); the rest of the trunk and the heads
  are ``F.conv2d`` in bf16.
* ``"float32"``: every layer is ``F.conv2d`` in f32, as the JAX package
  leaves the stem to XLA. cuDNN's TF32 is switched off for these convs
  so they stay f32 on the card.

Weights: ``load_params`` reads the JAX package's ``.npz`` (HWIO convs);
``SuperPoint`` turns them into OIHW tensors plus the stem kernel's
packed bf16 layout, so both packages compute the same network from
the same file. Built from trainable float32 tensors, the float32 model
passes gradients back to them (the trainer's route); the stem kernel
has no backward. Public functions keep the JAX package's NHWC layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d2slam_tpu_torch.ops.superpoint_stem import (
    pack_stem_weights,
    superpoint_stem,
)
from d2slam_tpu_torch.utils.device import cudnn_fp32, resolve_device, to_f32


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    max_keypoints: int = 200
    nms_radius: int = 4
    threshold: float = 0.015
    pca_dim: int = 0  # 0 = no PCA; reference uses 64 (superpoint_pca_dims)
    desc_dim: int = 256
    # conv compute dtype: "bfloat16" (the reference's fp16 TensorRT
    # engines; puts the stem kernel on the path) or "float32"
    compute_dtype: str = "float32"


_ENCODER = ["conv1a", "conv1b", "conv2a", "conv2b",
            "conv3a", "conv3b", "conv4a", "conv4b"]
_HEADS = ["convPa", "convPb", "convDa", "convDb"]


def load_params(path: str) -> Dict:
    """Read a SuperPoint ``.npz`` into the JAX parameter layout as numpy:
    ``{layer: {"w": HWIO, "b": [cout]}}`` plus ``"pca"`` when present.
    Accepts both key styles the JAX package writes (``conv1a/w`` from
    train_frontend.save_weights, ``conv1a_w`` from superpoint.load_params)."""
    raw = np.load(path)
    params: Dict = {}
    for name in raw.files:
        sep = "/" if "/" in name else "_"
        layer, leaf = name.rsplit(sep, 1)
        if layer == "pca":
            params.setdefault("pca", {})[leaf] = np.asarray(raw[name])
        else:
            params.setdefault(layer, {})[leaf] = np.asarray(raw[name])
    return params


def random_params(seed: int = 0, cfg: SuperPointConfig = SuperPointConfig()) -> Dict:
    """He-initialized parameters in the JAX layout (numpy), drawn from
    ``numpy.random.default_rng(seed)``: repeatable keypoints that are not
    3D-consistent, for smoke runs without trained weights (the JAX
    package's ``superpoint_init`` draws from ``jax.random`` instead)."""
    rng = np.random.default_rng(seed)
    shapes = [(3, 1, 64), (3, 64, 64), (3, 64, 64), (3, 64, 64), (3, 64, 128),
              (3, 128, 128), (3, 128, 128), (3, 128, 128),
              (3, 128, 256), (1, 256, 65), (3, 128, 256), (1, 256, cfg.desc_dim)]
    params: Dict = {}
    for name, (k, cin, cout) in zip(_ENCODER + _HEADS, shapes):
        w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (k * k * cin))
        params[name] = {"w": w.astype(np.float32), "b": np.zeros(cout, np.float32)}
    if cfg.pca_dim:
        proj = np.zeros((cfg.desc_dim, cfg.pca_dim), np.float32)
        proj[: cfg.pca_dim] = np.eye(cfg.pca_dim, dtype=np.float32)
        params["pca"] = {"proj": proj, "mean": np.zeros(cfg.desc_dim, np.float32)}
    return params


class SuperPoint(nn.Module):
    """SuperPoint weights on one device in the port's layouts.

    ``params``: the JAX parameter pytree as numpy arrays (HWIO convs),
    e.g. from :func:`load_params`. ``device`` defaults to ``cuda`` and
    raises when there is no card unless ``device="cpu"``.
    """

    def __init__(self, params: Dict, cfg: SuperPointConfig = SuperPointConfig(),
                 device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.bf16 = cfg.compute_dtype == "bfloat16"
        wdtype = torch.bfloat16 if self.bf16 else torch.float32
        for name in _ENCODER + _HEADS:
            w = to_f32(params[name]["w"], dev)
            b = to_f32(params[name]["b"], dev)
            self.register_buffer(f"{name}_w", w.permute(3, 2, 0, 1).to(wdtype).contiguous())
            self.register_buffer(f"{name}_b", b.to(wdtype))
        self.stem = None
        if self.bf16:
            # the stem's packed weights are constants: the kernel has no backward
            self.stem = pack_stem_weights(
                *(params[n][k].detach().cpu() if torch.is_tensor(params[n][k]) else params[n][k]
                  for n in ("conv1a", "conv1b") for k in ("w", "b")), device=dev)
        self.pca = None
        if "pca" in params:
            self.pca = (to_f32(params["pca"]["proj"], dev), to_f32(params["pca"]["mean"], dev))

    @property
    def device(self) -> torch.device:
        return self.conv2a_w.device

    def _conv(self, x, name):
        # bias added after the conv, in the compute dtype, as the JAX
        # package's ``_conv`` does: in bf16 the conv output is rounded
        # before the bias add. cuDNN adds the bias that way on the card;
        # a fused bias (one rounding, CPU oneDNN) would differ by a logit
        # ulp, so CPU and card would round differently
        w = getattr(self, f"{name}_w")
        b = getattr(self, f"{name}_b")
        return F.conv2d(x, w, padding=w.shape[-1] // 2) + b[:, None, None]

    def forward(self, img):
        """img: [B, H, W] f32 in [0, 1] -> (semi [B, 65, Hc, Wc] f32
        logits, desc [B, D, Hc, Wc] f32 L2-normalized), NCHW."""
        with cudnn_fp32():
            if self.bf16:
                if torch.is_grad_enabled() and (self.conv1a_w.requires_grad
                                                or self.conv1b_w.requires_grad):
                    raise RuntimeError("the bf16 stem has no backward: train the float32 "
                                       "trunk (compute_dtype='float32')")
                x = superpoint_stem(img, self.stem).permute(0, 3, 1, 2)
            else:
                x = F.relu(self._conv(img[:, None], "conv1a"))
                x = F.max_pool2d(F.relu(self._conv(x, "conv1b")), 2)
            x = F.relu(self._conv(x, "conv2a"))
            x = F.max_pool2d(F.relu(self._conv(x, "conv2b")), 2)
            x = F.relu(self._conv(x, "conv3a"))
            x = F.max_pool2d(F.relu(self._conv(x, "conv3b")), 2)
            x = F.relu(self._conv(x, "conv4a"))
            x = F.relu(self._conv(x, "conv4b"))
            semi = self._conv(F.relu(self._conv(x, "convPa")), "convPb").float()
            desc = self._conv(F.relu(self._conv(x, "convDa")), "convDb").float()
        desc = desc / torch.clamp_min(torch.linalg.norm(desc, dim=1, keepdim=True), 1e-12)
        return semi, desc


def convert_torch_state_dict(state: Dict) -> Dict:
    """Map the public magicleap SuperPoint checkpoint (OIHW torch convs,
    ``<layer>.weight`` / ``<layer>.bias``) to the JAX parameter layout
    (HWIO, numpy) that :class:`SuperPoint` and ``load_params`` use."""
    out = {}
    for name in _ENCODER + _HEADS:
        w = np.asarray(state[f"{name}.weight"])  # [O, I, H, W]
        out[name] = {"w": w.transpose(2, 3, 1, 0), "b": np.asarray(state[f"{name}.bias"])}
    return out


class OnnxSuperPoint(nn.Module):
    """A SuperPoint ONNX export lowered to torch ops, with
    :class:`SuperPoint`'s contract for ``superpoint_extract``:
    ``forward(img [B, H, W])`` returns (semi, desc [B, D, Hc, Wc]
    L2-normalized). ``semi`` is the export's own: [B, 65, Hc, Wc] cell
    logits, or a [B, H, W] heatmap decoded in-graph (both styles the
    reference consumes, d2frontend/src/CNN/superpoint_onnx.cpp:59 —
    outputs "semi", "desc")."""

    def __init__(self, module, cfg: SuperPointConfig = SuperPointConfig()):
        super().__init__()
        self.module = module
        self.cfg = cfg
        self.pca = None

    @property
    def device(self) -> torch.device:
        return self.module.device

    def forward(self, img):
        semis, descs = [], []
        for x in img:   # the export takes one [1, 1, H, W] image
            semi, desc = self.module(x[None, None])
            semis.append(semi.reshape(semi.shape[-2:])[None] if semi.dim() != 4 else semi)
            descs.append(desc)
        desc = torch.cat(descs)
        desc = desc / torch.clamp_min(torch.linalg.norm(desc, dim=1, keepdim=True), 1e-12)
        return torch.cat(semis), desc


def superpoint_from_onnx(path: str, cfg: SuperPointConfig = SuperPointConfig(),
                         dtype=torch.float32, device=None) -> OnnxSuperPoint:
    """Load a SuperPoint ONNX export (JAX ``superpoint_from_onnx``); the
    model plugs into ``superpoint_extract`` like :class:`SuperPoint`."""
    from d2slam_tpu_torch.tools.onnx_torch import load_onnx_module

    return OnnxSuperPoint(load_onnx_module(path, dtype=dtype, device=device), cfg)


def superpoint_raw(model: SuperPoint, img):
    """img: [B, H, W, 1] in [0, 1]. Returns the pre-softmax head outputs
    (semi [B, Hc, Wc, 65], desc [B, Hc, Wc, D]) in NHWC."""
    semi, desc = model(img[..., 0])
    return semi.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def superpoint_apply(model: SuperPoint, img):
    """img: [B, H, W, 1] in [0, 1]. Returns (scores [B, H, W],
    desc_coarse [B, Hc, Wc, D]), f32. A model whose ``semi`` is already a
    [B, H, W] heatmap (an ONNX export that decodes in-graph) passes it
    through."""
    semi, desc = model(img[..., 0])
    if semi.dim() == 3:
        return semi, desc.permute(0, 2, 3, 1)
    dense = torch.softmax(semi, dim=1)[:, :64]  # drop dustbin
    # depth-to-space: channel 8*i+j of cell (h, w) -> pixel (8h+i, 8w+j)
    scores = F.pixel_shuffle(dense, 8)[:, 0]
    return scores, desc.permute(0, 2, 3, 1)


def _window_max(x, radius: int):
    """Max over (2r+1)^2 windows of [B, H, W]; the 2-D max is separable."""
    k = 2 * radius + 1
    x = F.max_pool2d(x[:, None], (k, 1), stride=1, padding=(radius, 0))
    return F.max_pool2d(x, (1, k), stride=1, padding=(0, radius))[:, 0]


def simple_nms(scores, radius: int):
    """Keep local maxima within (2r+1)^2 windows (reference NMS,
    superpoint_common.cpp:107-177) as a max-pool equality test.
    scores: [B, H, W].

    Equal maxima inside one window keep only the first in raster order,
    as the reference's suppression pass does. The JAX package keeps them
    all; with a bf16 backbone such ties are common (the logits are
    bf16, so two pixels of one cell can share a score), and both
    refine to one sub-pixel point: a duplicate keypoint, which the
    tracker then hands to two landmarks."""
    is_max = scores == _window_max(scores, radius)
    H, W = scores.shape[-2:]
    # -raster index, exact in f32 up to 2^24 pixels
    rank = -torch.arange(H * W, device=scores.device, dtype=torch.float32).reshape(1, H, W)
    rank = torch.where(is_max, rank, torch.full_like(scores, -float("inf")))
    keep = is_max & (rank == _window_max(rank, radius))
    return torch.where(keep, scores, torch.zeros_like(scores))


def sample_descriptors(desc_coarse, kpts):
    """Bilinear descriptor interpolation at keypoint pixel locations
    (reference computeDescriptors, superpoint_common.cpp:42-99).

    desc_coarse: [B, Hc, Wc, D]; kpts: [B, K, 2] (x, y) pixels.
    """
    B, Hc, Wc, D = desc_coarse.shape
    gx = (kpts[..., 0] - 3.5) / 8.0   # cell centers at 8k+3.5
    gy = (kpts[..., 1] - 3.5) / 8.0
    x0 = torch.clamp(torch.floor(gx).long(), 0, Wc - 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, Hc - 1)
    x1 = torch.clamp(x0 + 1, 0, Wc - 1)
    y1 = torch.clamp(y0 + 1, 0, Hc - 1)
    wx = torch.clamp(gx - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(gy - y0, 0.0, 1.0)[..., None]
    bi = torch.arange(B, device=kpts.device)[:, None]
    d = (desc_coarse[bi, y0, x0] * (1 - wx) * (1 - wy)
         + desc_coarse[bi, y0, x1] * wx * (1 - wy)
         + desc_coarse[bi, y1, x0] * (1 - wx) * wy
         + desc_coarse[bi, y1, x1] * wx * wy)
    return d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)


class SuperPointOutput(NamedTuple):
    kpts: torch.Tensor    # [B, K, 2] (x, y) pixel coords
    scores: torch.Tensor  # [B, K]
    desc: torch.Tensor    # [B, K, D] L2-normalized (PCA'd if configured)
    valid: torch.Tensor   # [B, K] bool


def superpoint_extract(model: SuperPoint, img) -> SuperPointOutput:
    """Full extraction for a batch of images [B, H, W] f32 in [0, 1].
    Fixed output size ``max_keypoints`` with a validity mask; keypoints
    come in descending score order."""
    cfg = model.cfg
    B, H, W = img.shape
    raw, desc_coarse = superpoint_apply(model, img[..., None])
    scores_map = simple_nms(raw, cfg.nms_radius)
    top_scores, top_idx = torch.topk(scores_map.reshape(B, -1), cfg.max_keypoints, dim=1)
    yi = top_idx // W
    xi = top_idx % W
    # parabolic subpixel refinement on the raw score map
    xi_c = torch.clamp(xi, 1, W - 2)
    yi_c = torch.clamp(yi, 1, H - 2)
    flat = raw.reshape(B, -1)

    def at(y, x):
        return torch.gather(flat, 1, y * W + x)

    sc = at(yi_c, xi_c)

    def para(sm, s0, sp):
        denom = sm - 2 * s0 + sp  # negative at a maximum
        safe = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, -1e-9), denom)
        return torch.clamp(0.5 * (sm - sp) / safe, -0.5, 0.5)

    dx = para(at(yi_c, xi_c - 1), sc, at(yi_c, xi_c + 1))
    dy = para(at(yi_c - 1, xi_c), sc, at(yi_c + 1, xi_c))
    kpts = torch.stack([xi.float() + dx, yi.float() + dy], dim=-1)
    valid = top_scores > cfg.threshold
    desc = sample_descriptors(desc_coarse, kpts)
    if model.pca is not None:
        proj, mean = model.pca
        desc = (desc - mean) @ proj
        desc = desc / torch.clamp_min(torch.linalg.norm(desc, dim=-1, keepdim=True), 1e-12)
    return SuperPointOutput(kpts=kpts, scores=top_scores, desc=desc, valid=valid)
