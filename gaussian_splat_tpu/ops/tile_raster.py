"""Tile rasterizer in pure jnp: segmented log-space compositing over the pair list.

The mid-level backend: uses the exact same binning output as the Pallas kernels
but composites with vectorized jnp (segmented cumulative sums + scatter-add), so
it runs anywhere (CPU tests, interpret mode) and is differentiable end-to-end by
plain autodiff. It validates the binning machinery against the oracle and serves
as the semantic bridge: oracle ⟺ jnp_tile (same math, different data layout)
⟺ pallas (same layout, fused kernels).

Per-tile transmittance is a segmented exclusive prefix product over the pair
list, computed as exp(segmented-cumsum(log1p(−α))) — the same log-space trick
the Pallas kernels evaluate blockwise with an in-register cumsum.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.ops.binning import BinningResult, bin_gaussians
from gaussian_splat_tpu.ops.falloff import alpha_from_sigma, sigma_bound, sigma_quadform
from gaussian_splat_tpu.ops.projection import ProjectedGaussians


def tiles_to_image(
    tiles: jax.Array, tx_n: int, ty_n: int, width: int, height: int,
    tw: int, th: int,
) -> jax.Array:
    """(T, tw·th, C) tile-major pixels → (H, W, C) image (cropped)."""
    c = tiles.shape[-1]
    img = tiles.reshape(ty_n, tx_n, th, tw, c)
    img = img.transpose(0, 2, 1, 3, 4).reshape(ty_n * th, tx_n * tw, c)
    return img[:height, :width]


def composite_pairs(
    pair_tile: jax.Array,  # (B,) tile id (num_tiles = padding sentinel)
    means2d_p: jax.Array,  # (B, 2) per-pair gathered features
    conics_p: jax.Array,  # (B, 3)
    colors_p: jax.Array,  # (B, C) — RGB(+depth) channels, composited alike
    opac_p: jax.Array,  # (B,)
    valid_p: jax.Array,  # (B,) bool
    tile_offsets: jax.Array,  # (T,)
    num_tiles_x: int,
    num_tiles: int,
    config: RenderConfig,
    tile_row0: jax.Array = None,  # () i32: band's first global tile row
) -> Tuple[jax.Array, jax.Array]:
    """Composite the pair list into (T, tw·th, 3) tile colors and (T, tw·th) T_final."""
    tw, th = config.tile_width, config.tile_height
    npix = tw * th
    b = pair_tile.shape[0]

    # pixel centers of each pair's tile: (B, npix) — global coordinates when
    # banding (tile_row0), matching the Pallas kernels bit-for-bit in dx/dy
    lane = jnp.arange(npix, dtype=jnp.float32)
    col = jnp.mod(lane, tw)
    row = jnp.floor_divide(lane, tw)
    trow0 = jnp.int32(0) if tile_row0 is None else tile_row0
    tile_x = (pair_tile % num_tiles_x).astype(jnp.float32)
    tile_y = (pair_tile // num_tiles_x + trow0).astype(jnp.float32)
    px = tile_x[:, None] * tw + col[None, :] + 0.5  # (B, npix)
    py = tile_y[:, None] * th + row[None, :] + 0.5

    dx = px - means2d_p[:, 0:1]
    dy = py - means2d_p[:, 1:2]
    A2, Bc, C2 = (0.5 * conics_p[:, 0:1], conics_p[:, 1:2],
                  0.5 * conics_p[:, 2:3])
    # σ / keep / α semantics live in ops/falloff.py (shared with the oracle
    # and the Pallas kernels, down to the evaluation order)
    sigma = sigma_quadform(dx, dy, A2, Bc, C2)
    bound = sigma_bound(opac_p[:, None], valid_p[:, None],
                        config.sigma_cutoff, config.alpha_skip)
    alpha, _, _ = alpha_from_sigma(sigma, opac_p[:, None], bound,
                                   config.alpha_clamp)

    # segmented exclusive prefix product along the pair axis, in log space.
    la = jnp.log1p(-alpha)  # (B, npix); padding rows contribute exactly 0
    cum = jnp.cumsum(la, axis=0)
    excl = cum - la
    seg_start = excl[tile_offsets.clip(0, b - 1)]  # (T, npix) cumsum before segment
    t_excl = jnp.exp(excl - seg_start[pair_tile.clip(0, num_tiles - 1)])
    weights = alpha * t_excl  # (B, npix)

    # scatter-add into tiles; sentinel rows land in a trash bucket T.
    nchan = colors_p.shape[1]
    tiles_rgb = (
        jnp.zeros((num_tiles + 1, npix, nchan))
        .at[pair_tile]
        .add(weights[..., None] * colors_p[:, None, :])
    )[:num_tiles]
    la_tot = (
        jnp.zeros((num_tiles + 1, npix)).at[pair_tile].add(la)
    )[:num_tiles]
    t_final = jnp.exp(la_tot)
    return tiles_rgb, t_final


def render_tiled(
    proj: ProjectedGaussians,
    colors: jax.Array,
    opacities: jax.Array,
    width: int,
    height: int,
    config: RenderConfig,
    max_active: int = None,
    return_stats: bool = False,
    tile_row0: jax.Array = None,
    total_tiles_y: int = None,
) -> Tuple[jax.Array, ...]:
    """Full tiled render: bin → gather pair features → composite → assemble.
    Returns (image (H,W,3), T_final (H,W), depth (H,W)[, BinningStats]).

    `tile_row0`/`total_tiles_y`: global-grid banding (see
    pallas_raster.render_tiled_pallas) — means2d stay in global pixel
    coordinates and this call renders tile rows [tile_row0, tile_row0+ty_n)."""
    tw, th = config.tile_width, config.tile_height
    tx_n = config.tiles_x(width)
    ty_n = config.tiles_y(height)
    num_tiles = tx_n * ty_n

    binning = bin_gaussians(
        proj, width, height, config, max_active=max_active,
        tile_row0=tile_row0, total_tiles_y=total_tiles_y,
        opacities=opacities,
    )

    order = binning.order
    g = binning.pair_gauss  # index into depth-sorted arrays
    valid_p = binning.pair_tile < num_tiles

    means2d_p = proj.means2d[order][g]
    conics_p = proj.conics[order][g]
    chans = jnp.concatenate([colors, proj.depths[:, None]], axis=1)
    chans_p = chans[order][g]
    opac_p = opacities[order][g]

    tiles_rgb, t_final_tiles = composite_pairs(
        binning.pair_tile,
        means2d_p,
        conics_p,
        chans_p,
        opac_p,
        valid_p,
        binning.tile_offsets,
        tx_n,
        num_tiles,
        config,
        tile_row0=tile_row0,
    )

    image = tiles_to_image(tiles_rgb, tx_n, ty_n, width, height, tw, th)
    t_final = tiles_to_image(
        t_final_tiles[..., None], tx_n, ty_n, width, height, tw, th
    )[..., 0]
    bg = jnp.asarray(config.background, jnp.float32)
    depth = image[..., 3]
    image = image[..., :3] + t_final[..., None] * bg
    if return_stats:
        from gaussian_splat_tpu.ops.binning import BinningStats

        return image, t_final, depth, BinningStats.of(binning)
    return image, t_final, depth
