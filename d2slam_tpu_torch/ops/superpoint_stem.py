"""Fused SuperPoint stem: conv1a+ReLU, conv1b+ReLU, 2x2 max-pool.

Replaces the TPU kernel ``d2slam_tpu/ops/superpoint_stem_pallas.py``
(``_stem_kernel``, launched by ``superpoint_stem``) with the
hand-written Hopper kernel ``csrc/superpoint_stem.cu`` (CUDA C++ for
sm_90a, plain C interface bound with ctypes, built at first use).

Bound on the card: 2*B*H*W*64*(9+576) FLOPs, nearly all of them in the
64->64 conv1b, against 4*B*H*W bytes in and B*H*W*32 bytes out, so the
stem is tensor-core bound (B=2, 480x640: 46.0 GFLOP ~ 46.5 us at
989 TF/s bf16; its 22 MB of traffic ~ 6.6 us at 3.35 TB/s). The
kernel's design (see the source): persistent blocks, at most one per
SM (``stem_grid``), walk over 16x16 output tiles; the conv1b
weights are staged once per block in the layout ``wgmma`` reads
(``pack_stem_weights`` emits it); two producer warpgroups make conv1a
of the next tile (an im2col of the 9 taps and ``wgmma`` m64n64k16, as
the TPU kernel uses its matrix unit) into a double-buffered shared
activation while two consumer warpgroups, on alternate tiles, run
conv1b as ``wgmma`` m64n128k16 products (weights x an 8 wide, 16 high
patch of pixels; bf16 operands, f32 sums) and pool, add the bias and
store straight from their accumulator registers. Only the pooled tile
reaches device memory.

Rounding, as the TPU kernel: bf16 image, weights and biases; f32 sums;
bias added in f32; conv1a activation rounded once to bf16; bf16 out.
``stem_plain`` is the same function in plain PyTorch with the same
rounding. The wrapper runs it for CPU tensors only; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from d2slam_tpu_torch.utils.device import cudnn_fp32
from d2slam_tpu_torch.utils.native import PKG_DIR, build_shared_lib, nvcc

SOURCE = os.path.join(PKG_DIR, "csrc", "superpoint_stem.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

TILE = 16                  # the kernel's output tile side (pre-pool pixels)
W2_SHAPE = (9, 8, 64, 8)   # packed conv1b weights

# kernel launches since the counter was last reset (one per wrapper
# call on a CUDA tensor; the plain version never counts)
launches = 0

_LIB = None


class StemWeights(NamedTuple):
    """The kernel's packed bf16 weights (all contiguous, one device)."""

    w1: torch.Tensor  # [9, 64]      conv1a taps, row dy*3+dx
    b1: torch.Tensor  # [64]
    w2: torch.Tensor  # [9, 8, 64, 8]  conv1b [dy*3+dx][cin/8][cout][cin%8]
    b2: torch.Tensor  # [64]


def pack_stem_weights(conv1a_w, conv1a_b, conv1b_w, conv1b_b,
                      device=None) -> StemWeights:
    """HWIO conv1a [3,3,1,64] / conv1b [3,3,64,64] weights and [64]
    biases (numpy or tensors) -> the kernel's bf16 layout.

    conv1b goes out as [tap][cin/8][cout][cin%8]: per tap, 8x8 "core
    matrices" of 8 couts x 8 cins (16 bytes a cout), the no-swizzle
    K-major form ``wgmma`` reads a shared-memory operand in, so the
    kernel stages it with a flat copy. ``unpack_stem_w2`` inverts it."""
    def bf16(t, shape):
        return t.reshape(shape).to(device=device, dtype=torch.bfloat16).contiguous()

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    w2 = f32(conv1b_w).reshape(9, 8, 8, 64).permute(0, 1, 3, 2)
    return StemWeights(
        w1=bf16(f32(conv1a_w), (9, 64)), b1=bf16(f32(conv1a_b), (64,)),
        w2=bf16(w2, W2_SHAPE), b2=bf16(f32(conv1b_b), (64,)),
    )


def unpack_stem_w2(w2: torch.Tensor) -> torch.Tensor:
    """The packed conv1b weights back in HWIO order, [3, 3, 64, 64]."""
    return w2.permute(0, 1, 3, 2).reshape(3, 3, 64, 64)


def stem_grid(B: int, H: int, W: int, n_sm: int) -> int:
    """Persistent blocks of one launch: at most one per SM and one per
    TILE x TILE output tile (the last tiles of a row or column ragged)."""
    return max(1, min(n_sm, B * -(-H // TILE) * -(-W // TILE)))


def stem_flops(B: int, H: int, W: int) -> int:
    return 2 * B * H * W * 64 * (9 + 576)


def stem_bytes(B: int, H: int, W: int) -> int:
    """Each input read once (f32 image, bf16 weights), output written once."""
    weights = 2 * (9 * 64 + 64 + 9 * 64 * 64 + 64)
    return 4 * B * H * W + weights + 2 * B * (H // 2) * (W // 2) * 64


def stem_plain(img, w1, b1, w2, b2):
    """Plain PyTorch stem with the kernel's rounding.

    img: [B, H, W] f32; weights in the ``StemWeights`` layout.
    Returns [B, H/2, W/2, 64] bf16. f32 convolutions run without TF32.
    """
    x = img.to(torch.bfloat16).float()[:, None]
    k1 = w1.float().reshape(3, 3, 64).permute(2, 0, 1)[:, None]        # OIHW
    k2 = unpack_stem_w2(w2.float()).permute(3, 2, 0, 1)                # OIHW
    with cudnn_fp32():
        a1 = F.relu(F.conv2d(x, k1, padding=1) + b1.float()[:, None, None])
        a1 = a1.to(torch.bfloat16).float()
        a2 = F.relu(F.conv2d(a1, k2, padding=1) + b2.float()[:, None, None])
    return F.max_pool2d(a2, 2).to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _lib():
    global _LIB
    if _LIB is None:
        lib = build_shared_lib("superpoint_stem", SOURCE, [nvcc()], NVCC_FLAGS)
        lib.superpoint_stem_launch.restype = ctypes.c_int
        lib.superpoint_stem_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        _LIB = lib
    return _LIB


def build() -> ctypes.CDLL:
    """Compile and load the kernel now (it is otherwise built at its
    first launch); returns the loaded library."""
    return _lib()


def superpoint_stem(img: torch.Tensor, wts: StemWeights) -> torch.Tensor:
    """Fused stem of a batch: img [B, H, W] f32 in [0, 1], H and W even.
    Returns [B, H/2, W/2, 64] bf16 (NHWC, as the TPU kernel).

    CPU tensors take ``stem_plain``; CUDA tensors launch the kernel."""
    global launches
    if img.dim() != 3 or img.dtype != torch.float32:
        raise ValueError(f"stem wants img [B, H, W] float32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    B, H, W = img.shape
    if H % 2 or W % 2 or H == 0 or W == 0:
        raise ValueError(f"stem wants even H and W, got {H}x{W}")
    shapes = {"w1": (9, 64), "b1": (64,), "w2": W2_SHAPE, "b2": (64,)}
    for name, shape in shapes.items():
        t = getattr(wts, name)
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device != img.device or not t.is_contiguous()):
            raise ValueError(f"stem weight {name} must be a contiguous bf16 "
                             f"{shape} tensor on {img.device}")
    if img.device.type == "cpu":
        return stem_plain(img, *wts)
    if img.device.type != "cuda":
        raise ValueError(f"stem runs on CPU or CUDA tensors, not {img.device}")
    if not img.is_contiguous():
        raise ValueError("stem wants a contiguous image")
    lib = _lib()
    n_sm = torch.cuda.get_device_properties(img.device).multi_processor_count
    out = torch.empty((B, H // 2, W // 2, 64), dtype=torch.bfloat16,
                      device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = lib.superpoint_stem_launch(
        img.data_ptr(), wts.w1.data_ptr(), wts.b1.data_ptr(),
        wts.w2.data_ptr(), wts.b2.data_ptr(), out.data_ptr(),
        B, H, W, stem_grid(B, H, W, n_sm), stream)
    if err != 0:
        raise RuntimeError(f"superpoint_stem launch failed: CUDA error {err}")
    launches += 1
    return out
