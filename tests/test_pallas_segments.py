"""Kernel-level checks of the Triton-route raster kernels (interpret mode on
the CPU) on a hand-built pair list: unaligned segments that straddle block
boundaries and share blocks with their neighbours, an empty tile, a
one-pair tile and trailing padding — forward against the jnp tile
compositor, per-pair gradients against its autodiff, and the per-rank
segment-sum against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.ops import pallas_raster as pr
from gaussian_splat_tpu.ops.tile_raster import composite_pairs

CFG = RenderConfig()
TX, TY = 2, 3  # 64x48 px frame of 32x16 tiles
# per-tile segment lengths: none is a multiple of the backward's pair block,
# so every boundary falls inside a block that the neighbouring tile also
# reads; the 71-pair tile outlasts the forward's saturation-check interval
COUNTS = [7, 23, 0, 1, 71, 18]
B = 128  # padded pair array (padding rows carry the sentinel tile)


def _pairs(seed):
    rs = np.random.RandomState(seed)
    tiles = np.concatenate([np.full(c, t) for t, c in enumerate(COUNTS)])
    n = tiles.size
    tx, ty = tiles % TX, tiles // TX
    mx = tx * 32 + rs.uniform(-6, 38, n)  # some centres outside their tile
    my = ty * 16 + rs.uniform(-6, 22, n)
    a = rs.uniform(0.02, 0.3, n)
    c = rs.uniform(0.02, 0.3, n)
    b = rs.uniform(-0.5, 0.5, n) * np.sqrt(a * c)  # positive definite
    feats = np.zeros((pr.NF, B), np.float32)
    feats[:, :n] = np.stack([
        mx, my, a, b, c,
        rs.uniform(0, 1, n), rs.uniform(0, 1, n), rs.uniform(0, 1, n),
        rs.uniform(2, 6, n),  # depth channel
        rs.uniform(0.2, 0.95, n),
    ])
    pair_tile = np.full(B, TX * TY, np.int32)
    pair_tile[:n] = tiles
    offsets = np.concatenate([[0], np.cumsum(COUNTS)[:-1]]).astype(np.int32)
    return (jnp.asarray(feats), jnp.asarray(offsets),
            jnp.asarray(np.asarray(COUNTS, np.int32)), jnp.asarray(pair_tile), n)


def _static(sat_check=False):
    return pr.RasterStatics(
        tile_w=CFG.tile_width, tile_h=CFG.tile_height, tiles_x=TX, tiles_y=TY,
        alpha_clamp=CFG.alpha_clamp, alpha_skip=CFG.alpha_skip,
        sigma_cutoff=CFG.sigma_cutoff, trans_eps=CFG.transmittance_eps,
        sat_check=sat_check,
    )


def _reference(feats, offsets, pair_tile):
    """(T·NROW, P) tile outputs from the jnp tile compositor."""
    f = feats.T
    rgbd, t_final = composite_pairs(
        pair_tile, f[:, 0:2], f[:, 2:5], f[:, 5:9], f[:, 9],
        pair_tile < TX * TY, offsets, TX, TX * TY, CFG,
    )  # (T, P, 4), (T, P)
    rows = jnp.concatenate(
        [jnp.swapaxes(rgbd, 1, 2), t_final[:, None, :],
         jnp.zeros((TX * TY, pr.NROW - 5, CFG.tile_pixels))], axis=1,
    )
    return rows.reshape(TX * TY * pr.NROW, CFG.tile_pixels)


@pytest.mark.parametrize("seed", [0, 1])
def test_unaligned_segments_forward(seed):
    feats, offsets, counts, pair_tile, _ = _pairs(seed)
    out = pr._raster_forward(feats, offsets, counts, _static())
    want = _reference(feats, offsets, pair_tile)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               atol=2e-6, rtol=1e-5)
    # the empty tile composites nothing: colour 0, transmittance 1
    empty = np.asarray(out).reshape(TX * TY, pr.NROW, -1)[2]
    assert (empty[:4] == 0).all() and (empty[4] == 1).all()


def test_unaligned_segments_gradients():
    """Each program writes only its own rows [off, end): the gradients of
    pairs on both sides of every shared block boundary match autodiff of
    the jnp compositor, and padding rows stay exactly zero."""
    feats, offsets, counts, pair_tile, n = _pairs(2)
    cot = jax.random.normal(jax.random.PRNGKey(3), (TX * TY * pr.NROW, 512))
    cot = cot.reshape(TX * TY, pr.NROW, 512).at[:, 5:].set(0.0).reshape(cot.shape)
    static = _static()

    g_k = jax.grad(lambda f: jnp.sum(pr._raster(f, offsets, counts, static) * cot))(feats)
    g_r = jax.grad(lambda f: jnp.sum(_reference(f, offsets, pair_tile) * cot))(feats)
    g_k, g_r = np.asarray(g_k), np.asarray(g_r)
    assert (g_k[:, n:] == 0).all()
    scale = np.abs(g_r).max(axis=1, keepdims=True) + 1e-12
    np.testing.assert_allclose(g_k / scale, g_r / scale, atol=2e-5)


def test_saturation_exit_bounded_by_trans_eps():
    """With sat_check a tile stops once all its pixels are below trans_eps:
    outputs and gradients move by at most that order, on segments that
    saturate early (wide, nearly opaque splats)."""
    feats, offsets, counts, pair_tile, n = _pairs(4)
    feats = feats.at[9, :n].set(0.99).at[2, :n].set(0.01).at[4, :n].set(0.01)
    cot = jax.random.normal(jax.random.PRNGKey(5), (TX * TY * pr.NROW, 512))

    def run(sat):
        static = _static(sat)
        out, vjp = jax.vjp(lambda f: pr._raster(f, offsets, counts, static), feats)
        return np.asarray(out), np.asarray(vjp(cot)[0])

    (o_exact, g_exact), (o_early, g_early) = run(False), run(True)
    np.testing.assert_allclose(o_early, o_exact, atol=10 * CFG.transmittance_eps)
    scale = np.abs(g_exact).max(axis=1, keepdims=True) + 1e-12
    np.testing.assert_allclose(g_early / scale, g_exact / scale, atol=1e-4)


def test_sum_by_rank_matches_numpy():
    rs = np.random.RandomState(0)
    n, b = 37, 300
    ranks = rs.randint(0, n + 1, b).astype(np.int32)  # n = padding sentinel
    d = rs.randn(pr.NF, b).astype(np.float32)
    got = np.asarray(pr._sum_by_rank(jnp.asarray(d), jnp.asarray(ranks), n))
    want = np.zeros((n, pr.NF), np.float64)
    keep = ranks < n
    np.add.at(want, ranks[keep], d[:, keep].T)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
