"""Sharded render pipeline: splat-parallel projection → feature exchange →
tile-parallel rasterization.

Scheme (north-star configs 4-5, replacing the nothing-at-all of the reference,
SURVEY §2.3):

  * The GaussianModel is sharded over the primitive axis: each chip projects
    and shades N/D gaussians (embarrassingly parallel, the FLOP-heavy
    quat→Σ→EWA chain).
  * Screen-space features (13 floats/gaussian) reach the tile-owning chips by
    one of two exchanges (config.shard_exchange):
      - "all_gather" (default, best ≤8 devices): dense gather over NVLink —
        ~48 MB/chip at 1M splats — then each chip COMPACTS to the splats whose
        rect intersects its band before binning, so the expensive pair sort
        runs over ≤ N/D + margin·N rows per chip, not N.
      - "all_to_all" (the north-star sparse exchange, for larger meshes):
        each chip routes every local splat only to the chips whose tile band
        its rect touches, via static-capacity per-destination buffers + one
        lax.all_to_all. Traffic and per-chip working set stay O(N/D) as D
        grows, unlike the all_gather's O(N).
  * Each chip then bins and rasterizes only its horizontal band of tile rows
    (tile sharding): expansion, pair sort, and raster are all ~1/D per chip,
    and the output image is row-sharded with no further communication.
  * Autodiff through `shard_map` transposes the all_gather into a
    reduce-scatter of feature gradients (and the all_to_all into an
    all_to_all), landing per-shard parameter grads on the owning chip — the
    "gradient all-reduce overlapped with backward" of the north star falls
    out of XLA's collective scheduling.

Load imbalance is explicit, not silent: every band reports its pair count,
pair-budget overflow, and how many in-band splats its capacity cap dropped
(`ShardedRender.stats`, one row per chip). Capacities are static shapes —
`shard_capacity_margin` / `a2a_capacity_factor` trade headroom for memory.

The image height is padded so every chip owns an equal integer number of tile
rows; callers crop. Each band renders in GLOBAL pixel coordinates: means2d
are never re-based — binning computes rects/shrinks/tier flags on the global
tile grid and band-clips (bin_gaussians tile_row0/total_tiles_y), and the
raster kernels evaluate px/py with the band's global tile-row offset — so
every α equals the single-chip value BITWISE, and the raster kernels walk
each tile's segment in blocks starting at the segment's own offset, so the
per-tile compositing order is the single-chip one too.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gaussian_splat_tpu.camera import Camera
from gaussian_splat_tpu.config import PAIR_ALIGN, RenderConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel
from gaussian_splat_tpu.ops.binning import BinningStats, quantize_extent_up
from gaussian_splat_tpu.ops.projection import ProjectedGaussians
from gaussian_splat_tpu.ops.render import (
    _effective_opacities, _project_and_shade, auto_backend,
)

NFEAT_X = 13  # exchanged floats per splat:
#   mx,my,A,B,C,depth,rx,valid,r,g,b,op,ry — rx/ry are the exact per-axis
#   ellipse-AABB extents from projection (carried bit-identically so sharded
#   tile rects — and therefore per-band pair counts — match the single-chip
#   binning exactly; ry alone drives the band-intersection test)


class ShardedRender(NamedTuple):
    """Row-sharded render outputs plus per-band load telemetry."""

    image: jax.Array  # (H, W, 3), rows sharded over the mesh
    t_final: jax.Array  # (H, W)
    depth: jax.Array  # (H, W)
    stats: BinningStats  # each leaf (D,): per-band num_pairs / overflow /
    #   clamped_rects / dropped_gaussians (capacity-cap or send-buffer drops)


def _band_geometry(config: RenderConfig, height: int, ndev: int) -> Tuple[int, int]:
    """(tile_rows_per_device, padded_height)."""
    ty_n = config.tiles_y(height)
    rows_per_dev = -(-ty_n // ndev)
    return rows_per_dev, rows_per_dev * ndev * config.tile_height


def _pack_features(model_shard: GaussianModel, cam: Camera, config: RenderConfig):
    """Project + shade a model shard into the NFEAT_X-float exchange record."""
    proj, colors = _project_and_shade(model_shard, cam, config)
    opac = _effective_opacities(model_shard, proj, config)
    return jnp.concatenate(
        [
            proj.means2d,  # 0:2
            proj.conics,  # 2:5
            proj.depths[:, None],  # 5
            proj.extents[:, 0:1],  # 6: rx
            proj.valid.astype(jnp.float32)[:, None],  # 7
            colors,  # 8:11
            opac[:, None],  # 11
            proj.extents[:, 1:2],  # 12: ry
        ],
        axis=1,
    )


def _unpack_to_band(feats: jax.Array, row0_px, band_valid=None) -> ProjectedGaussians:
    """Exchange records → ProjectedGaussians in band-local pixel coordinates."""
    means2d = feats[:, 0:2] - jnp.stack([jnp.float32(0.0), row0_px])
    valid = feats[:, 7] > 0.5
    if band_valid is not None:
        valid = valid & band_valid
    rx, ry = feats[:, 6], feats[:, 12]
    return ProjectedGaussians(
        means2d=means2d,
        conics=feats[:, 2:5],
        depths=feats[:, 5],
        radii=jnp.ceil(jnp.maximum(rx, ry)).astype(jnp.int32),
        valid=valid,
        cov2d=feats[:, 2:5],  # placeholder (debug only)
        extents=jnp.stack([rx, ry], axis=-1),
    )


def _band_raster(config: RenderConfig):
    backend = auto_backend() if config.backend == "auto" else config.backend
    if backend == "pallas":
        from gaussian_splat_tpu.ops.pallas_raster import render_tiled_pallas

        return render_tiled_pallas
    from gaussian_splat_tpu.ops.tile_raster import render_tiled

    return render_tiled


def render_sharded(
    model: GaussianModel,
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    axis_name: str = "dev",
) -> ShardedRender:
    """Render with splat+tile sharding over `mesh`. Returns a `ShardedRender`
    of row-sharded global arrays (cropped to the true height) plus per-band
    stats.

    Requires model.num_gaussians % ndev == 0 (pad the model if needed).
    """
    ndev = mesh.shape[axis_name]
    width, height = camera.width, camera.height
    rows_per_dev, padded_h = _band_geometry(config, height, ndev)
    band_h = rows_per_dev * config.tile_height
    n = model.num_gaussians
    raster = _band_raster(config)

    # all_gather path: per-band compaction cap (static). The depth sort keys
    # out-of-band splats to +inf, so only splats whose rect intersects the
    # band occupy the first `max_active` ranks — the pair expansion and sort
    # then run over max_active rows instead of N.
    # The capacity floor keeps small scenes (where band-splat incidence is far
    # above N/D — e.g. single-tile-row bands in tests) exact at negligible
    # cost; at production N the factor term dominates.
    floor = config.shard_capacity_floor
    # additive-margin cap: N/D residents + margin*N boundary-crossing tail
    # (see RenderConfig.shard_capacity_margin)
    cap = max(
        -(-n // ndev) + int(n * config.shard_capacity_margin), min(n, floor)
    )
    max_active = min(n, -(-cap // PAIR_ALIGN) * PAIR_ALIGN)

    # all_to_all path: per-(source, dest) send capacity (static).
    n_local = n // ndev
    a2a_cap = max(
        int(n_local * config.a2a_capacity_factor / ndev), min(n_local, floor)
    )
    a2a_cap = min(n_local, -(-a2a_cap // 8) * 8)

    total_ty = rows_per_dev * ndev  # global tile rows of the padded frame

    def body_all_gather(model_shard: GaussianModel, cam: Camera):
        idx = jax.lax.axis_index(axis_name)
        feats = _pack_features(model_shard, cam, config)  # (N/D, NFEAT_X)
        feats_all = jax.lax.all_gather(feats, axis_name, tiled=True)  # (N, NFEAT_X)

        row0_px = (idx * band_h).astype(jnp.float32)
        my = feats_all[:, 1] - row0_px
        # 1/256-px round-up keeps the band test exact and consistent with
        # binning's rects (see binning.quantize_extent_up)
        r = quantize_extent_up(feats_all[:, 12])  # ry drives band intersection
        in_band = (my + r > 0.0) & (my - r < band_h)
        # GLOBAL pixel coordinates throughout (row0_px=0): binning band-clips
        # on the global grid and the kernels offset their pixel coords
        proj_all = _unpack_to_band(
            feats_all, jnp.float32(0.0), band_valid=in_band
        )
        image, t_final, depth, stats = raster(
            proj_all,
            feats_all[:, 8:11],
            feats_all[:, 11],
            width,
            band_h,
            config,
            max_active=max_active,
            return_stats=True,
            tile_row0=(idx * rows_per_dev).astype(jnp.int32),
            total_tiles_y=total_ty,
        )
        stats = jax.tree_util.tree_map(lambda x: x[None], stats)
        return image, t_final, depth, stats

    def body_all_to_all(model_shard: GaussianModel, cam: Camera):
        idx = jax.lax.axis_index(axis_name)
        feats = _pack_features(model_shard, cam, config)  # (Nl, NFEAT_X)
        my = feats[:, 1]
        r = quantize_extent_up(feats[:, 12])  # ry, quantized to match binning
        valid_l = feats[:, 7] > 0.5

        # route each local splat to every band its rect touches; capacity is
        # static per destination, overflow (hits beyond capacity) is counted
        table = jnp.concatenate(
            [feats, jnp.zeros((1, NFEAT_X), feats.dtype)], axis=0
        )  # sentinel row: valid=0
        sends = []
        send_drop = jnp.int32(0)
        for d in range(ndev):
            lo = jnp.float32(d * band_h)
            hi = jnp.float32((d + 1) * band_h)
            hit = valid_l & (my + r > lo) & (my - r < hi)
            (sel,) = jnp.nonzero(hit, size=a2a_cap, fill_value=n_local)
            sends.append(jnp.take(table, sel, axis=0))
            send_drop = send_drop + jnp.maximum(
                jnp.sum(hit.astype(jnp.int32)) - a2a_cap, 0
            )
        send = jnp.stack(sends)  # (D, cap, NFEAT_X)
        recv = jax.lax.all_to_all(
            send, axis_name, split_axis=0, concat_axis=0, tiled=False
        )  # (D, cap, NFEAT_X): slot j holds source j's splats for MY band
        feats_band = recv.reshape(ndev * a2a_cap, NFEAT_X)

        # GLOBAL pixel coordinates (see body_all_gather)
        proj_band = _unpack_to_band(feats_band, jnp.float32(0.0))
        image, t_final, depth, stats = raster(
            proj_band,
            feats_band[:, 8:11],
            feats_band[:, 11],
            width,
            band_h,
            config,
            return_stats=True,
            tile_row0=(idx * rows_per_dev).astype(jnp.int32),
            total_tiles_y=total_ty,
        )
        stats = stats._replace(
            dropped_gaussians=stats.dropped_gaussians + send_drop
        )
        stats = jax.tree_util.tree_map(lambda x: x[None], stats)
        return image, t_final, depth, stats

    if config.shard_exchange == "all_to_all":
        body = body_all_to_all
    elif config.shard_exchange == "all_gather":
        body = body_all_gather
    else:
        raise ValueError(f"unknown shard_exchange {config.shard_exchange!r}")

    image, t_final, depth, stats = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name), None),
        out_specs=(
            P(axis_name),
            P(axis_name),
            P(axis_name),
            BinningStats(
                num_pairs=P(axis_name),
                overflow=P(axis_name),
                clamped_rects=P(axis_name),
                dropped_gaussians=P(axis_name),
                tier_overflow=P(axis_name),
            ),
        ),
        check_vma=False,
    )(model, camera)

    # padded_h ≥ height; crop (keeps row sharding of the leading rows)
    return ShardedRender(image[:height], t_final[:height], depth[:height], stats)


def sharded_binning_stats(
    model: GaussianModel,
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    axis_name: str = "dev",
    sigma_test: bool = True,
) -> BinningStats:
    """Project → exchange → bin (NO raster): per-band BinningStats (D,).

    The dress-rehearsal entry point for very large configs (north-star
    config 5: 3M splats @ 4K): it exercises the full sharded data path —
    feature exchange, band compaction, pair expansion, sort, segment
    boundaries — at target shapes without materializing band images (the pure
    jnp rasterizer's (pairs × pixels) working set only fits the kernels).
    """
    from gaussian_splat_tpu.ops.binning import bin_gaussians

    ndev = mesh.shape[axis_name]
    width, height = camera.width, camera.height
    rows_per_dev, _ = _band_geometry(config, height, ndev)
    band_h = rows_per_dev * config.tile_height
    n = model.num_gaussians
    floor = config.shard_capacity_floor
    # additive-margin cap: N/D residents + margin*N boundary-crossing tail
    # (see RenderConfig.shard_capacity_margin)
    cap = max(
        -(-n // ndev) + int(n * config.shard_capacity_margin), min(n, floor)
    )
    max_active = min(n, -(-cap // PAIR_ALIGN) * PAIR_ALIGN)
    n_local = n // ndev
    a2a_cap = max(
        int(n_local * config.a2a_capacity_factor / ndev), min(n_local, floor)
    )
    a2a_cap = min(n_local, -(-a2a_cap // 8) * 8)

    total_ty = rows_per_dev * ndev

    def body(model_shard: GaussianModel, cam: Camera):
        idx = jax.lax.axis_index(axis_name)
        feats = _pack_features(model_shard, cam, config)
        row0_px = (idx * band_h).astype(jnp.float32)
        send_drop = jnp.int32(0)
        if config.shard_exchange == "all_to_all":
            my = feats[:, 1]
            r = quantize_extent_up(feats[:, 12])  # ry, quantized to match binning
            valid_l = feats[:, 7] > 0.5
            table = jnp.concatenate(
                [feats, jnp.zeros((1, NFEAT_X), feats.dtype)], axis=0
            )
            sends = []
            for d in range(ndev):
                lo = jnp.float32(d * band_h)
                hi = jnp.float32((d + 1) * band_h)
                hit = valid_l & (my + r > lo) & (my - r < hi)
                (sel,) = jnp.nonzero(hit, size=a2a_cap, fill_value=n_local)
                sends.append(jnp.take(table, sel, axis=0))
                send_drop = send_drop + jnp.maximum(
                    jnp.sum(hit.astype(jnp.int32)) - a2a_cap, 0
                )
            recv = jax.lax.all_to_all(
                jnp.stack(sends), axis_name, split_axis=0, concat_axis=0
            )
            feats_band = recv.reshape(ndev * a2a_cap, NFEAT_X)
            proj_band = _unpack_to_band(feats_band, jnp.float32(0.0))
            opac_band = feats_band[:, 11]
            cap_arg = None
        else:
            feats_all = jax.lax.all_gather(feats, axis_name, tiled=True)
            my = feats_all[:, 1] - row0_px
            # quantized so the band test is exact and consistent with
            # binning's rects (see binning.quantize_extent_up)
            r = quantize_extent_up(feats_all[:, 12])
            in_band = (my + r > 0.0) & (my - r < band_h)
            proj_band = _unpack_to_band(
                feats_all, jnp.float32(0.0), band_valid=in_band
            )
            opac_band = feats_all[:, 11]
            cap_arg = max_active
        # opacities → the σ-bound cell test runs, exactly as in the render
        # path (round-5 fix: the stats path used to skip it, so its per-band
        # pair counts could not be compared 1:1 against a σ-tested single-
        # chip binning)
        b = bin_gaussians(
            proj_band, width, band_h, config, max_active=cap_arg,
            tile_row0=(idx * rows_per_dev).astype(jnp.int32),
            total_tiles_y=total_ty,
            opacities=opac_band if sigma_test else None,
        )
        stats = BinningStats.of(b)
        stats = stats._replace(
            dropped_gaussians=stats.dropped_gaussians + send_drop
        )
        return jax.tree_util.tree_map(lambda x: x[None], stats)

    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name), None),
        out_specs=BinningStats(
            num_pairs=P(axis_name),
            overflow=P(axis_name),
            clamped_rects=P(axis_name),
            dropped_gaussians=P(axis_name),
            tier_overflow=P(axis_name),
        ),
        check_vma=False,
    )(model, camera)
