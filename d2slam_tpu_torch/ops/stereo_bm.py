"""Streaming SAD block matching of rectified stereo pairs.

Replaces the TPU kernel ``d2slam_tpu/ops/stereo_bm_pallas.py``
(``_bm_kernel``, launched by ``block_match_disparity_pallas``) with the
hand-written Hopper kernel ``csrc/stereo_bm.cu`` (CUDA C++ for sm_90a,
plain C interface bound with ctypes, built at first use).

Per pixel, over d in [0, max_disp): ``|L - R shifted by d|`` (circular
in x), a block x block box mean (rows replicated at the top and bottom
edge, columns circular), cost 1e3 where the shift has no match
(``x < d``; ``x >= W - d`` with ``reverse``), then a running best cost
and disparity (the lowest d wins a tie), the second-best cost outside
the winner's +-1 neighbourhood, and the costs at the winner's two
neighbours, from which the sub-pixel parabola is evaluated after the
loop. The cost volume is never stored.

Bound on the card: 8 bytes in and 16 out per pixel (``bm_bytes``)
against ``max_disp * (2*block + 10) + 15`` non-fused instructions per
pixel, and two more per disparity on the ``max_disp - 1`` columns that
can lack a match (``bm_ops``), so the function is bound by operations:
at [8, 240, 320], max_disp 64, block 9 it is 1.13 G operations against
14.7 MB. What keeps a kernel from that bound is the SM's
shared-memory pipe (one warp-wide instruction per clock against four
arithmetic ones) and, at a frame's four pairs, too few warps on an SM,
so the kernel's design (see the source) spends few shared-memory
instructions and few registers: one thread block per (image, 4 rows,
``bm_tile_cols`` <= 128 - (block - 1) columns plus a halo of block // 2
on each side); a vertical stage with one thread per column (left
column in registers, right tile in shared memory) stores the column
sums, a horizontal stage with one thread per (row, 4 adjacent columns)
reads them back 16 bytes at a time and keeps the 4 pixels' running
values in registers; one barrier per disparity.

``bm_plain`` is the same function in plain PyTorch with the same order
of summation. The wrapper runs it for CPU tensors only; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from d2slam_tpu_torch.utils.native import PKG_DIR, build_shared_lib, nvcc

SOURCE = os.path.join(PKG_DIR, "csrc", "stereo_bm.cu")
# -fmad=false: a cost must equal the plain version's bit for bit, or
# near-ties pick another winner
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
BLOCKS = (1, 3, 5, 7, 9, 11, 13, 15)   # the kernel's instantiations
COL_ROUND = 8       # tile widths are whole 16-byte load phases: 2 groups
MAX_THREADS = 128   # columns of a tile, halo included

# kernel launches since the counter was last reset (one per wrapper
# call on a CUDA tensor; the plain version never counts)
launches = 0

_LIB = None


def bm_ops(N: int, H: int, W: int, D: int, block: int) -> int:
    """Non-fused f32/integer operations the function needs. Per pixel
    and disparity: difference and abs (2), vertical and horizontal box
    sums (2*(block-1)), scale (1) and the running update (9: take 1,
    "the winner is the step before" 1, cp1 1, second 3, and cm1, best
    cost, best disparity 1 each; the winner is never nearer than one
    step, so no distance is computed). The no-match mask (compare and
    select, 2) only on the min(D - 1, W) columns of a row that can lack
    a match. Per pixel after the loop: 15 (neighbour test 3, parabola 9,
    output 3)."""
    return N * H * (W * (D * (2 * block + 10) + 15) + min(D - 1, W) * D * 2)


def bm_bytes(N: int, H: int, W: int) -> int:
    """Two f32 inputs read once, four 4-byte outputs written once."""
    return N * H * W * (8 + 16)


def bm_tile_cols(W: int, block: int) -> int:
    """Columns of a thread block's tile: column tiles of equal width,
    each a multiple of ``COL_ROUND`` and, with the halo of block // 2 on
    each side, at most ``MAX_THREADS`` wide."""
    max_tc = (MAX_THREADS - (block - 1)) // COL_ROUND * COL_ROUND
    n_tiles = -(-W // max_tc)
    return -(-(-(-W // n_tiles)) // COL_ROUND) * COL_ROUND


def bm_plain(left, right, max_disp: int = 64, block: int = 9,
             reverse: bool = False):
    """Plain PyTorch block matching, the kernel's semantics and order of
    summation. left, right: [N, H, W] f32. Returns (disp f32, best i32,
    cost f32, second f32), each [N, H, W]."""
    N, H, W = left.shape
    r = block // 2
    Lp = F.pad(left[:, None], (0, 0, r, r), mode="replicate")[:, 0]
    Rp = F.pad(right[:, None], (0, 0, r, r), mode="replicate")[:, 0]
    col = torch.arange(W, device=left.device).expand(N, H, W)
    big = torch.full((N, H, W), 1e9, dtype=torch.float32, device=left.device)
    best_c, second_c, cm1, cp1, c_prev = big, big, big, big, big
    best_d = torch.full((N, H, W), -2, dtype=torch.int32, device=left.device)
    no_match = torch.full_like(big, 1e3)
    inv = 1.0 / (block * block)
    for d in range(max_disp):
        sad = (Lp - torch.roll(Rp, -d if reverse else d, dims=-1)).abs()
        vs = sad[:, 0:H]
        for dy in range(1, block):
            vs = vs + sad[:, dy:dy + H]
        hs = vs
        for dx in range(1, r + 1):
            hs = hs + torch.roll(vs, dx, dims=-1) + torch.roll(vs, -dx, dims=-1)
        invalid = (col >= W - d) if reverse else (col < d)
        c = torch.where(invalid, no_match, hs * inv)

        take = c < best_c
        far_old = (best_d - d).abs() > 1
        cm1 = torch.where(take, c_prev, cm1)
        cp1 = torch.where(take, big, torch.where(best_d + 1 == d, c, cp1))
        second_c = torch.where(
            far_old, torch.minimum(second_c, torch.where(take, best_c, c)),
            second_c)
        best_c = torch.where(take, c, best_c)
        best_d = torch.where(take, torch.full_like(best_d, d), best_d)
        c_prev = c
    have_nb = (cm1 < 0.5e9) & (cp1 < 0.5e9)
    denom = torch.clamp_min(cm1 - 2.0 * best_c + cp1, 1e-6)
    delta = torch.clamp(0.5 * (cm1 - cp1) / denom, -1.0, 1.0)
    disp = best_d.float() + torch.where(have_nb, delta, torch.zeros_like(delta))
    return disp, best_d, best_c, second_c


def _lib():
    global _LIB
    if _LIB is None:
        lib = build_shared_lib("stereo_bm", SOURCE, [nvcc()], NVCC_FLAGS)
        lib.stereo_bm_launch.restype = ctypes.c_int
        lib.stereo_bm_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        _LIB = lib
    return _LIB


def build() -> ctypes.CDLL:
    """Compile and load the kernel now (it is otherwise built at its
    first launch); returns the loaded library."""
    return _lib()


def stereo_bm(left: torch.Tensor, right: torch.Tensor, max_disp: int = 64,
              block: int = 9, reverse: bool = False):
    """Block matching of N rectified pairs in one launch.

    left, right: [N, H, W] f32 contiguous, H and W >= block; ``block``
    odd, at most 15. Forward matches left pixel x to right pixel x - d;
    ``reverse`` matches x to x + d (the right-to-left pass). Returns
    (disp f32 with sub-pixel, best i32, cost f32, second f32), each
    [N, H, W].

    CPU tensors take ``bm_plain``; CUDA tensors launch the kernel."""
    global launches
    for name, t in (("left", left), ("right", right)):
        if t.dim() != 3 or t.dtype != torch.float32:
            raise ValueError(f"stereo_bm wants {name} [N, H, W] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if left.shape != right.shape or left.device != right.device:
        raise ValueError("stereo_bm wants left and right of one shape on one device")
    N, H, W = left.shape
    if block not in BLOCKS:
        raise ValueError(f"stereo_bm wants block in {BLOCKS}, got {block}")
    if max_disp < 1 or N < 1 or H < block or W < block:
        raise ValueError(f"stereo_bm wants max_disp >= 1 and H, W >= block, "
                         f"got max_disp={max_disp} block={block} {N}x{H}x{W}")
    if left.device.type == "cpu":
        return bm_plain(left, right, max_disp, block, reverse)
    if left.device.type != "cuda":
        raise ValueError(f"stereo_bm runs on CPU or CUDA tensors, not {left.device}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("stereo_bm wants contiguous images")
    lib = _lib()
    disp, cost, second = (torch.empty_like(left) for _ in range(3))
    best = torch.empty((N, H, W), dtype=torch.int32, device=left.device)
    stream = torch.cuda.current_stream(left.device).cuda_stream
    err = lib.stereo_bm_launch(
        left.data_ptr(), right.data_ptr(), disp.data_ptr(), best.data_ptr(),
        cost.data_ptr(), second.data_ptr(), N, H, W, max_disp, block,
        bm_tile_cols(W, block), int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"stereo_bm launch failed: CUDA error {err}")
    launches += 1
    return disp, best, cost, second


def block_match_disparity_fused(left, right, max_disp: int = 64, block: int = 9,
                                lr_thresh: float = 1.5, uniqueness: float = 0.95):
    """(disparity f32, valid bool) of rectified pairs [H, W] or
    [N, H, W]: the forward and the reverse pass of ``stereo_bm`` (two
    launches for all N pairs), then the uniqueness test
    (``cost < uniqueness * second``), the left-right check
    (``<= lr_thresh`` px), ``0 < best < max_disp - 1`` and the border
    mask ``x >= max_disp`` as plain tensor code on the outputs."""
    batched = left.dim() == 3
    if not batched:
        left, right = left[None], right[None]
    left = left.float().contiguous()
    right = right.float().contiguous()
    W = left.shape[-1]
    disp, best, cost, second = stereo_bm(left, right, max_disp, block, False)
    _, best_r, _, _ = stereo_bm(right, left, max_disp, block, True)
    unique_ok = cost < uniqueness * second
    xs = torch.arange(W, device=left.device).expand_as(best)
    xr = torch.clamp(xs - best, 0, W - 1)
    d_r_at = torch.gather(best_r, -1, xr)
    lr_ok = (best - d_r_at).abs() <= lr_thresh
    valid = (unique_ok & lr_ok & (best > 0) & (best < max_disp - 1)
             & (xs >= max_disp))
    if not batched:
        return disp[0], valid[0]
    return disp, valid
