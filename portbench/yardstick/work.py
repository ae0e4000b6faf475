"""The work of the two hand-written kernels' stages, from their shapes,
and the card's peaks: the yardstick of the roofline metrics.

The counts are those of the port's ``ops/superpoint_stem.py``
(``stem_flops`` / ``stem_bytes``) and ``ops/stereo_bm.py`` (``bm_ops`` /
``bm_bytes``), kept here so that a change to the program cannot change
what its kernels are measured against. A roofline share is the least
time the card could take for the work (the larger of operations over
the peak rate and bytes over the peak bandwidth) over the device time
the stage took.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12      # tensor-core bf16 FLOP/s
PEAK_F32_FLOPS = 67e12        # float32 FLOP/s outside the tensor cores
PEAK_F32_OPS = 33.5e12        # non-fused f32 / integer instructions per second
#                               (132 SMs x 128 lanes x 1.98 GHz)
PEAK_BYTES = 3.35e12          # HBM3 bytes/s


def stem_flops(B: int, H: int, W: int) -> int:
    """conv1a (1 -> 64 channels, 3x3) and conv1b (64 -> 64, 3x3) over B
    images of H x W: 2 FLOPs a multiply-add."""
    return 2 * B * H * W * 64 * (9 + 576)


def stem_bytes(B: int, H: int, W: int) -> int:
    """Each input read once (f32 image, bf16 weights and biases), the
    pooled bf16 output written once."""
    weights = 2 * (9 * 64 + 64 + 9 * 64 * 64 + 64)
    return 4 * B * H * W + weights + 2 * B * (H // 2) * (W // 2) * 64


def stem_min_s(B: int, H: int, W: int) -> float:
    return max(stem_flops(B, H, W) / PEAK_BF16_FLOPS, stem_bytes(B, H, W) / PEAK_BYTES)


def bm_ops(N: int, H: int, W: int, D: int, block: int) -> int:
    """One pass of SAD block matching over N pairs: per pixel and
    disparity the difference and its absolute value (2), the vertical and
    horizontal box sums (2 * (block - 1)), the scale (1) and the running
    best / second-best update (9); the no-match mask (2) on the
    min(D - 1, W) columns of a row that can lack a match; 15 per pixel
    after the loop (neighbour test, parabola, output)."""
    return N * H * (W * (D * (2 * block + 10) + 15) + min(D - 1, W) * D * 2)


def bm_bytes(N: int, H: int, W: int) -> int:
    """Two f32 images read once, four 4-byte outputs written once."""
    return N * H * W * (8 + 16)


def disparity_min_s(N: int, H: int, W: int, D: int, block: int) -> float:
    """The forward and the reverse pass of a frame's N pairs."""
    return 2 * max(bm_ops(N, H, W, D, block) / PEAK_F32_OPS, bm_bytes(N, H, W) / PEAK_BYTES)


def superpoint_flops(B: int, H: int, W: int) -> int:
    """The whole SuperPoint network over B images of H x W: the VGG
    encoder (the stem's two convolutions at full size, then 64, 128 and
    128 channels at 1/2, 1/4 and 1/8), the detector head (3x3 to 256,
    1x1 to 65) and the descriptor head (3x3 to 256, 1x1 to 256)."""
    P = H * W
    per_image = (P * 64 * (9 + 576) + P // 4 * 64 * 576 * 2
                 + P // 16 * (128 * 576 + 128 * 1152)
                 + P // 64 * (128 * 1152 * 2 + 256 * 1152 * 2 + 65 * 256 + 256 * 256))
    return 2 * B * per_image


def netvlad_flops(H: int, W: int, channels: tuple, clusters: int, pca: tuple) -> int:
    """NetVLAD over one H x W image: a 3x3 stride-2 stem to ``channels[0]``,
    depthwise-separable stages (3x3 depthwise, 1x1 pointwise) to
    ``channels[1:]`` at strides 2, 2, 2, 1 (``SAME`` padding), the 1x1
    soft assignment to ``clusters``, the aggregation and the
    ``pca`` = (in, out) projection."""
    def down(n, s):
        return -(-n // s)

    h, w = down(H, 2), down(W, 2)
    f = h * w * channels[0] * 9
    for cin, cout, stride in zip(channels[:-1], channels[1:], (2, 2, 2, 1)):
        h, w = down(h, stride), down(w, stride)
        f += h * w * cin * 9 + h * w * cin * cout
    f += h * w * channels[-1] * clusters * 2        # assignment and aggregation
    return 2 * f + 2 * pca[0] * pca[1]
