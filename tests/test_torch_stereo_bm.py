"""Parity of the port's block matcher (``ops/stereo_bm.py``) with the
JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs ``bm_plain``, the plain PyTorch
version of its CUDA kernel with the same order of summation; the JAX
kernel sums in the same order, so costs agree to a few f32 ulps.
Tolerances: integer winners equal on >= 99.9 % of the pixels (a cost
tie within an ulp may flip a winner); where they agree, costs to 1e-5
and sub-pixel disparity to 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.ops.stereo_bm_pallas import (
    block_match_disparity_fused as j_fused,
)
from d2slam_tpu.ops.stereo_bm_pallas import block_match_disparity_pallas
from d2slam_tpu_torch.depth.stereo import block_match_disparity
from d2slam_tpu_torch.ops import stereo_bm as sbm

torch.set_num_threads(1)  # tests run one process per core (xdist)

D, BLOCK = 24, 7


def _smooth(base):
    from numpy.lib.stride_tricks import sliding_window_view

    pad = np.pad(base, 1, mode="edge")
    return (sliding_window_view(pad, (3, 3)) / 9).sum(axis=(2, 3))


def make_pair(H=64, W=128, d_true=10.0, seed=1, noise=0.0):
    """Textured pair with a known (possibly fractional) shift."""
    rng = np.random.default_rng(seed)
    base = _smooth(_smooth(rng.uniform(0, 1, (H, W + 64))))
    xs = np.arange(W)
    left = base[:, 16:16 + W]
    x_r = xs + 16 + d_true
    x0 = np.floor(x_r).astype(int)
    f = x_r - x0
    right = base[:, x0] * (1 - f) + base[:, x0 + 1] * f
    if noise:
        right = right + rng.normal(0, noise, right.shape)
    return left.astype(np.float32), right.astype(np.float32)


def _compare(t_out, j_out, region=np.s_[:, :]):
    td, tb, tc, ts = (x[0].numpy()[region] for x in t_out)
    jd, jb, jc, js = (np.asarray(x)[region] for x in j_out)
    same = tb == jb
    assert same.mean() >= 0.999, f"winners agree on {same.mean():.5f}"
    np.testing.assert_allclose(tc[same], jc[same], atol=1e-5)
    np.testing.assert_allclose(ts[same], js[same], atol=1e-5)
    np.testing.assert_allclose(td[same], jd[same], atol=1e-3)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,row_tile", [((64, 128), None), ((64, 128), 32),
                                            ((50, 77), None)])
def test_bm_plain_matches_pallas_interpret(shape, row_tile, reverse):
    left, right = make_pair(*shape, noise=0.01)
    if reverse:
        left, right = right, left
    j = block_match_disparity_pallas(
        jnp.asarray(left), jnp.asarray(right), max_disp=D, block=BLOCK,
        reverse=reverse, row_tile=row_tile, interpret=True)
    t = sbm.stereo_bm(torch.as_tensor(left)[None], torch.as_tensor(right)[None],
                      D, BLOCK, reverse)
    assert t[1].dtype == torch.int32 and t[0].shape == (1, *shape)
    _compare(t, j)


@pytest.mark.parametrize("reverse", [False, True])
def test_bm_border_columns_match(reverse):
    """The box filter wraps around in x: the right ``r`` columns are
    not hidden by the fused mask, and the left ``max_disp`` columns hold
    the no-match cost. Both bands are held on their own."""
    left, right = make_pair(50, 77, noise=0.01)
    if reverse:
        left, right = right, left
    j = block_match_disparity_pallas(
        jnp.asarray(left), jnp.asarray(right), max_disp=D, block=BLOCK,
        reverse=reverse, interpret=True)
    t = sbm.stereo_bm(torch.as_tensor(left)[None], torch.as_tensor(right)[None],
                      D, BLOCK, reverse)
    r = BLOCK // 2
    for region in (np.s_[:, -r:], np.s_[:, :D], np.s_[:, -D:], np.s_[:, :r]):
        td, tb, tc, ts = (x[0].numpy()[region] for x in t)
        jd, jb, jc, js = (np.asarray(x)[region] for x in j)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_allclose(tc, jc, atol=1e-5)
        np.testing.assert_allclose(ts, js, atol=1e-5)
        np.testing.assert_allclose(td, jd, atol=1e-3)


def test_bm_batch_equals_single_pairs():
    """One call on N pairs equals N calls on one pair (bit for bit)."""
    pairs = [make_pair(40, 64, d_true=4.0 + k, seed=k) for k in range(3)]
    L = torch.as_tensor(np.stack([p[0] for p in pairs]))
    R = torch.as_tensor(np.stack([p[1] for p in pairs]))
    full = sbm.stereo_bm(L, R, 16, 5)
    for k in range(3):
        one = sbm.stereo_bm(L[k:k + 1], R[k:k + 1], 16, 5)
        for a, b in zip(full, one):
            assert torch.equal(a[k], b[0])


def test_fused_matches_jax_fused():
    left, right = make_pair(noise=0.01)
    jd, jv = j_fused(jnp.asarray(left), jnp.asarray(right), max_disp=D,
                     block=BLOCK, interpret=True)
    td, tv = sbm.block_match_disparity_fused(
        torch.as_tensor(left), torch.as_tensor(right), D, BLOCK)
    jv, tv = np.asarray(jv), tv.numpy()
    assert tv.shape == left.shape
    assert (jv == tv).mean() >= 0.999
    both = jv & tv
    assert both.mean() > 0.3
    np.testing.assert_allclose(td.numpy()[both], np.asarray(jd)[both], atol=1e-3)


# ---- the four behaviours of the JAX kernel's own tests, on the port ----


def test_winner_agrees_with_cost_volume_path():
    left, right = make_pair()
    _, best, _, _ = sbm.stereo_bm(torch.as_tensor(left)[None],
                                  torch.as_tensor(right)[None], D, BLOCK)
    disp_x, valid_x = block_match_disparity(
        torch.as_tensor(left), torch.as_tensor(right), D, BLOCK)
    vx = valid_x.numpy()
    dp = best[0].numpy()[vx]
    dx = np.round(disp_x.numpy())[vx]
    assert (np.abs(dp - dx) <= 1).mean() > 0.95
    assert np.median(np.abs(dp - 10)) <= 1


def test_fused_validity():
    left, right = make_pair()
    disp, valid = sbm.block_match_disparity_fused(
        torch.as_tensor(left), torch.as_tensor(right), D, BLOCK)
    valid = valid.numpy()
    assert valid.mean() > 0.3
    assert np.median(np.abs(disp.numpy()[valid] - 10.0)) <= 1.0


def test_subpixel_refinement():
    left, right = make_pair(d_true=10.4, seed=3)
    disp, valid = sbm.block_match_disparity_fused(
        torch.as_tensor(left), torch.as_tensor(right), D, BLOCK)
    valid = valid.numpy()
    assert valid.mean() > 0.3
    # the in-loop parabola must beat integer resolution
    assert np.median(np.abs(disp.numpy()[valid] - 10.4)) < 0.35


def test_result_independent_of_row_tiling():
    """The JAX wrapper's row bands have no counterpart in the port; the
    port's result equals the JAX result whatever the band height."""
    left, right = make_pair(96, 128)
    t = sbm.stereo_bm(torch.as_tensor(left)[None], torch.as_tensor(right)[None],
                      D, BLOCK)
    for row_tile in (None, 32):
        j = block_match_disparity_pallas(
            jnp.asarray(left), jnp.asarray(right), max_disp=D, block=BLOCK,
            row_tile=row_tile, interpret=True)
        _compare(t, j)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 16, 16)
    with pytest.raises(ValueError):
        sbm.stereo_bm(x, x, 8, 4)              # even block
    with pytest.raises(ValueError):
        sbm.stereo_bm(x[0], x[0], 8, 5)        # not [N, H, W]
    with pytest.raises(ValueError):
        sbm.stereo_bm(x.double(), x.double(), 8, 5)
    with pytest.raises(ValueError):
        sbm.stereo_bm(x[:, :4], x[:, :4], 8, 5)  # H < block
    assert sbm.bm_bytes(8, 240, 320) == 8 * 240 * 320 * 24
    # a lone column can lack a match: the mask's two operations count
    assert sbm.bm_ops(1, 1, 1, 64, 9) == 64 * (28 + 2) + 15
    assert sbm.bm_ops(1, 1, 320, 64, 9) == 320 * (64 * 28 + 15) + 63 * 64 * 2
