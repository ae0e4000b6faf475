"""What the two Hopper kernels leave to the host, tested without a card.

* ``pack_stem_weights`` emits the conv1b weights in the layout ``wgmma``
  reads ([tap][cin/8][cout][cin%8]); ``unpack_stem_w2`` inverts it exactly
  to the HWIO weights (rounded once to bf16), and ``stem_plain`` on the
  packed weights still matches the JAX package's ``stem_reference`` to the
  stated bf16 tolerance |t - j| <= 0.02 + 0.016 |j|.
* What the launches take from Python, the stem's number of persistent
  blocks (``stem_grid``) and the block matcher's tile width
  (``bm_tile_cols``), gives a cut that covers every output pixel exactly
  once at ragged shapes. The walks over the tiles below are models of
  what the kernels do with those two numbers (a block takes tiles block,
  block + grid, ...; a launch's grid is ceil(W / tile_cols) x ceil(H / 4)
  x N), written here only to state that property; no kernel reads them.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.ops.superpoint_stem_pallas import stem_reference
from d2slam_tpu_torch.frontend.superpoint import load_params
from d2slam_tpu_torch.ops import stereo_bm as sbm
from d2slam_tpu_torch.ops import superpoint_stem as tstem

torch.set_num_threads(1)  # tests run one process per core (xdist)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights",
                       "superpoint_synth.npz")
STEM_ATOL, STEM_RTOL = 0.02, 0.016
SHAPES = [(34, 50), (240, 320), (480, 640), (480, 752), (37, 70), (800, 1280)]


def _packed():
    params = load_params(WEIGHTS)
    wts = tstem.pack_stem_weights(params["conv1a"]["w"], params["conv1a"]["b"],
                                  params["conv1b"]["w"], params["conv1b"]["b"],
                                  device="cpu")
    return params, wts


def test_packed_conv1b_inverts_to_hwio():
    params, wts = _packed()
    assert tuple(wts.w2.shape) == tstem.W2_SHAPE and wts.w2.is_contiguous()
    hwio = torch.as_tensor(np.asarray(params["conv1b"]["w"], np.float32))
    back = tstem.unpack_stem_w2(wts.w2)
    assert back.shape == (3, 3, 64, 64)
    assert torch.equal(back, hwio.to(torch.bfloat16))


def test_packed_conv1b_is_the_wgmma_core_matrix_layout():
    """Byte offset of weight (tap, cin, cout): 8192 tap + 1024 (cin // 8)
    + 16 cout + 2 (cin % 8) -- 8 couts x 8 cins are 128 contiguous bytes."""
    _, wts = _packed()
    flat = wts.w2.reshape(-1)
    hwio = tstem.unpack_stem_w2(wts.w2).reshape(9, 64, 64)
    rng = np.random.default_rng(0)
    for tap, cin, cout in rng.integers(0, [9, 64, 64], (200, 3)):
        off = (8192 * tap + 1024 * (cin // 8) + 16 * cout + 2 * (cin % 8)) // 2
        assert flat[off] == hwio[tap, cin, cout]


def test_stem_plain_on_packed_weights_matches_jax_reference():
    params, wts = _packed()
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 34, 50)).astype(np.float32)
    jp1 = {k: jnp.asarray(v) for k, v in params["conv1a"].items()}
    jp2 = {k: jnp.asarray(v) for k, v in params["conv1b"].items()}
    j = np.asarray(stem_reference(jnp.asarray(img), jp1, jp2).astype(jnp.float32))
    t = tstem.superpoint_stem(torch.as_tensor(img), wts).float().numpy()
    assert t.shape == j.shape == (2, 17, 25, 64)
    assert np.all(np.abs(t - j) <= STEM_ATOL + STEM_RTOL * np.abs(j)), \
        float(np.abs(t - j).max())


# models of the kernels' constants (csrc/superpoint_stem.cu: TILE;
# csrc/stereo_bm.cu: PY, CX)
BM_TILE_ROWS, BM_COL_GROUP = 4, 4


def stem_block_tiles(B, H, W, grid, block):
    """Model of the stem kernel's walk: the tiles block ``block`` of
    ``grid`` takes, in its order, as (image, y0, x0)."""
    tiles_y, tiles_x = -(-H // tstem.TILE), -(-W // tstem.TILE)
    out = []
    for tile in range(block, B * tiles_y * tiles_x, grid):
        b, rem = divmod(tile, tiles_y * tiles_x)
        ty, tx = divmod(rem, tiles_x)
        out.append((b, ty * tstem.TILE, tx * tstem.TILE))
    return out


def bm_tiles(H, W, tc):
    """Model of the block matcher's grid over one image: tiles as
    (y0, y1, x0, x1), clipped to the image."""
    return [(y0, min(y0 + BM_TILE_ROWS, H), x0, min(x0 + tc, W))
            for y0 in range(0, H, BM_TILE_ROWS) for x0 in range(0, W, tc)]


@pytest.mark.parametrize("n_sm", [132, 7])
@pytest.mark.parametrize("hw", SHAPES)
def test_stem_tile_plan_covers_every_pixel_once(hw, n_sm):
    B, (H, W) = 2, hw
    grid = tstem.stem_grid(B, H, W, n_sm)
    n_tiles = B * -(-H // tstem.TILE) * -(-W // tstem.TILE)
    assert 1 <= grid <= min(n_sm, n_tiles)
    hit = np.zeros((B, H, W), np.int32)
    per_block = []
    for g in range(grid):
        tiles = stem_block_tiles(B, H, W, grid, g)
        per_block.append(len(tiles))
        for b, y0, x0 in tiles:
            assert y0 % 2 == 0 and x0 % 2 == 0   # pooling windows stay whole
            hit[b, y0:y0 + tstem.TILE, x0:x0 + tstem.TILE] += 1
    assert (hit == 1).all()
    assert sum(per_block) == n_tiles
    assert max(per_block) - min(per_block) <= 1   # the walk is balanced


def test_stem_tile_plan_small_inputs():
    assert tstem.stem_grid(1, 2, 2, 132) == 1
    assert tstem.stem_grid(1, 38, 10, 132) == 3     # narrower than a tile
    assert tstem.stem_grid(2, 480, 640, 132) == 132


@pytest.mark.parametrize("block", [1, 7, 9, 15])
@pytest.mark.parametrize("hw", SHAPES)
def test_bm_tiles_cover_every_pixel_once(hw, block):
    H, W = hw
    tc = sbm.bm_tile_cols(W, block)
    assert tc % sbm.COL_ROUND == 0 and tc % BM_COL_GROUP == 0
    assert tc + block - 1 <= sbm.MAX_THREADS       # a thread per column and halo
    hit = np.zeros((H, W), np.int32)
    for y0, y1, x0, x1 in bm_tiles(H, W, tc):
        assert y1 - y0 <= BM_TILE_ROWS and x1 - x0 <= tc
        hit[y0:y1, x0:x1] += 1
    assert (hit == 1).all()
    # equal-width tiles: the last one is not a sliver
    n = -(-W // tc)
    assert n * tc - W < n * sbm.COL_ROUND
