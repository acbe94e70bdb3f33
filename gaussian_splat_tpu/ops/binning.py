"""Tile binning: depth sort, gaussian→tile pair expansion, segmented offsets.

This is the replacement for the reference's hardware rasterizer +
per-pixel OIT lists (/root/reference/shaders/gaussian_splat_50layer.metal:149-223):
instead of atomically appending fragments per pixel, we bin splats to 32×16 px
tiles ahead of time and depth-sort once per frame, producing dense per-tile
segments that the rasterization kernels stream sequentially. Everything is
static-shape (XLA requirement): capacities come from RenderConfig, and overflow
is accounted explicitly (`BinningResult.overflow`) rather than silently dropped
the way the reference drops fragments past its 50-slot cap
(gaussian_splat_50layer.metal:172).

Design notes (SURVEY §7 hard part (b)):
  * Gaussians are depth-sorted FIRST (argsort over N); pair generation then
    runs in two size tiers, and a single stable 2-key sort (tile id, depth
    rank) yields per-tile front-to-back segments.
  * Per-tile segments stay unaligned: the Pallas kernels read each segment
    in masked blocks starting at its own offset, so no aligning pass is
    needed.
  * Oversized gaussians have their tile rect shrunk isotropically to fit
    `max_tiles_per_gaussian` (area-preserving center crop) — a bounded
    approximation for extreme near-camera splats, reported via `clamped_rects`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussian_splat_tpu.config import PAIR_ALIGN, RenderConfig
from gaussian_splat_tpu.ops.projection import ProjectedGaussians


class BinningResult(NamedTuple):
    order: jax.Array  # (N,) depth argsort: sorted_i -> original gaussian index
    pair_gauss: jax.Array  # (B_pad,) index into the *depth-sorted* gaussian arrays
    #   (clamped to 0 on padding rows — mask with pair_tile)
    pair_tile: jax.Array  # (B_pad,) tile id, == num_tiles on padding rows
    tile_offsets: jax.Array  # (T,) int32 segment start per tile (unaligned)
    tile_counts: jax.Array  # (T,) int32 actual (unpadded) pairs per tile
    num_pairs: jax.Array  # () int32 valid pairs before budget truncation
    overflow: jax.Array  # () int32 pairs dropped by the budget
    clamped_rects: jax.Array  # () int32 gaussians whose tile rect was shrunk
    #   by the per-gaussian K cap or the tier-capacity overflow below
    rank_starts: jax.Array = None  # (N+1,) int32 exclusive cumsum of per-rank
    #   pair counts: pairs of depth-rank r number rank_starts[r+1]−rank_starts[r].
    #   Exact by construction (overflow drops whole farthest gaussians), which
    #   gives the gather-VJP its segment boundaries for free.
    dropped_gaussians: jax.Array = None  # () int32 valid gaussians beyond the
    #   `max_active` compaction cap (sharded path: in-band splats a chip had to
    #   drop because its band capacity overflowed; 0 when max_active is None)
    tier_overflow: jax.Array = None  # () int32 big-tier-ELIGIBLE gaussians
    #   (threshold: K-capped rect area > small cap) denied a big slot because
    #   the static big-tier capacity overflowed — the ONLY population-relative
    #   decision left in binning: when this is 0 on every shard, tier
    #   membership (and so every rect) is a pure per-gaussian function and the
    #   sharded pair partition is exact (round-2 verdict item 5b)


class BinningStats(NamedTuple):
    """Scalar telemetry extracted from a BinningResult — shaped for shard_map
    outputs (each chip contributes one row of per-band load/overflow stats)."""

    num_pairs: jax.Array  # () int32 valid pairs before budget truncation
    overflow: jax.Array  # () int32 pairs dropped by the pair budget
    clamped_rects: jax.Array  # () int32 shrunk tile rects
    dropped_gaussians: jax.Array  # () int32 splats dropped by max_active
    tier_overflow: jax.Array = None  # () int32 big-tier capacity misses (the
    #   partition-exactness sentinel — see BinningResult.tier_overflow)

    @classmethod
    def of(cls, b: "BinningResult") -> "BinningStats":
        zero = jnp.int32(0)
        return cls(
            num_pairs=b.num_pairs,
            overflow=b.overflow,
            clamped_rects=b.clamped_rects,
            dropped_gaussians=zero if b.dropped_gaussians is None else b.dropped_gaussians,
            tier_overflow=zero if b.tier_overflow is None else b.tier_overflow,
        )


def quantize_extent_up(x: jax.Array) -> jax.Array:
    """Round a billboard extent UP to the 1/256-px grid.

    The sharded path computes rects in band-local pixel coordinates
    ((my − row0) − ry, vs the single-chip my − ry), and float subtraction
    only reassociates exactly when both operands share a coarse-enough grid:
    with raw float extents the two paths disagree on a rect edge by one tile
    row ~1e-6 of the time (caught by the config-5 rehearsal's pair
    accounting at 3M splats — per-band sums drifted +5 of 12.6M). On the
    2⁻⁸-px grid, mean − extent is exact for coordinates < 4096 (grids align
    within the f32 mantissa), so every path floors the same rect. Rounding
    UP only enlarges the exact ellipse AABB (~0.1% extra pairs vs ~5.6% for
    whole-pixel ceil), so the zero-output-change guarantee holds."""
    return jnp.ceil(x * 256.0) * (1.0 / 256.0)


def tile_rects(
    means2d: jax.Array,
    radii: jax.Array,
    valid: jax.Array,
    width: int,
    height: int,
    config: RenderConfig,
    extents: jax.Array = None,
    total_tiles_y: int = None,
):
    """Per-gaussian tile rectangle [tx0,tx1)×[ty0,ty1), capped to the per-gaussian
    tile budget. Returns (tx0, ty0, rect_w, rect_h, clamped_count).

    `extents` (N, 2), when given, is the exact per-axis ellipse AABB from
    projection — strictly tighter than the circular `radii` for
    anisotropic/tilted splats with identical rendered output (every dropped
    tile is provably outside the {σ ≤ σ_max} support).

    `total_tiles_y` (static): the GLOBAL tile-row count when this call covers
    only a horizontal band of a taller frame (sharded path). Rects — and the
    K-cap shrink — are computed against the global grid so every shard makes
    the same per-gaussian decision; the caller band-clips afterwards
    (see effective_rects)."""
    tw, th = config.tile_width, config.tile_height
    tx_n = config.tiles_x(width)
    ty_n = config.tiles_y(height) if total_tiles_y is None else total_tiles_y

    if extents is not None:
        rx = quantize_extent_up(extents[:, 0])
        ry = quantize_extent_up(extents[:, 1])
    else:
        rx = ry = radii.astype(jnp.float32)
    mx, my = means2d[:, 0], means2d[:, 1]

    tx0 = jnp.clip(jnp.floor((mx - rx) / tw), 0, tx_n).astype(jnp.int32)
    tx1 = jnp.clip(jnp.ceil((mx + rx) / tw), 0, tx_n).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor((my - ry) / th), 0, ty_n).astype(jnp.int32)
    ty1 = jnp.clip(jnp.ceil((my + ry) / th), 0, ty_n).astype(jnp.int32)

    w = jnp.where(valid, tx1 - tx0, 0)
    h = jnp.where(valid, ty1 - ty0, 0)

    tx0, ty0, w, h, clamped = _shrink_to_cap(
        tx0, ty0, w, h, config.max_tiles_per_gaussian, mx, my, tw, th, tx_n, ty_n
    )
    w = jnp.where(valid, w, 0)
    h = jnp.where(valid, h, 0)
    clamped = jnp.sum((clamped & valid).astype(jnp.int32))
    return tx0, ty0, w, h, clamped


def _shrink_to_cap(tx0, ty0, w, h, cap, mx, my, tw, th, tx_n, ty_n, apply=None):
    """Shrink rects with area > cap isotropically around the mean's tile:
    floor(w·s)·floor(h·s) ≤ w·h·(cap/area) = cap for s = sqrt(cap/area).
    `apply` optionally restricts which gaussians are eligible for shrinking.
    Returns (tx0, ty0, w, h, shrunk_mask)."""
    area = w * h
    needs = area > cap
    if apply is not None:
        needs = needs & apply
    s = jnp.sqrt(cap / jnp.maximum(area, 1).astype(jnp.float32))
    w_c = jnp.maximum((w.astype(jnp.float32) * s).astype(jnp.int32), 1)
    h_c = jnp.maximum((h.astype(jnp.float32) * s).astype(jnp.int32), 1)
    # Thin rects can violate the cap after the floor-and-bump above (e.g. a
    # 64×1 rect with cap 16: h_c floors to 0 → bumped to 1 while w_c=32).
    # Re-clamp so w_c·h_c ≤ cap ALWAYS holds — rank_starts counts the full
    # rect area, so an area > the expansion block size would shift every
    # downstream VJP segment boundary (advisor finding, round 1).
    w_c = jnp.minimum(w_c, cap // jnp.maximum(h_c, 1))
    h_c = jnp.minimum(h_c, cap // jnp.maximum(w_c, 1))
    w_c = jnp.maximum(w_c, 1)
    h_c = jnp.maximum(h_c, 1)
    cx = jnp.clip(jnp.floor(mx / tw).astype(jnp.int32), 0, tx_n - 1)
    cy = jnp.clip(jnp.floor(my / th).astype(jnp.int32), 0, ty_n - 1)
    tx0_c = jnp.clip(cx - (w_c - 1) // 2, 0, tx_n - w_c)
    ty0_c = jnp.clip(cy - (h_c - 1) // 2, 0, ty_n - h_c)
    return (
        jnp.where(needs, tx0_c, tx0),
        jnp.where(needs, ty0_c, ty0),
        jnp.where(needs, w_c, w),
        jnp.where(needs, h_c, h),
        needs,
    )


def effective_rects(
    means2d: jax.Array,
    radii: jax.Array,
    valid: jax.Array,
    width: int,
    height: int,
    config: RenderConfig,
    n_active: int = None,
    extents: jax.Array = None,
    total_tiles_y: int = None,
):
    """Two-tier per-gaussian rects as used by `bin_gaussians`.

    Tier membership is a per-gaussian THRESHOLD: any splat whose K-capped rect
    area exceeds `small_tiles_per_gaussian` is big-tier eligible. This makes
    the tier decision — and therefore every emitted rect — a pure function of
    the splat itself, identical no matter how the population is sharded
    (round 2 used top-(N/fraction)-by-area membership, which was population-
    relative, so per-band rects diverged from single-chip whenever shrinks
    fired — the config-5 rehearsal's accounting caveat).

    The big tier keeps a STATIC capacity `n_eff // big_gaussian_fraction + 1`
    (it sizes the K-block expansion and the pair budget); eligible splats
    beyond capacity lose deterministically by area and are shrunk to the
    small cap, counted in `tier_overflow` — zero in any sane configuration,
    and the partition-exactness sentinel for the sharded path.

    `n_active` sizes the capacity when only a prefix of the depth-sorted rows
    can emit pairs (sharded compaction).

    `total_tiles_y` (static): global tile-row count when this call serves a
    horizontal band of a taller frame (sharded path) — rects, the K-cap
    shrink, AND tier membership are all computed against the global grid so
    every shard makes byte-identical per-gaussian decisions; the caller
    band-clips afterwards (bin_gaussians with tile_row0).
    Returns (tx0, ty0, w, h, is_big, big_idx, clamped, tier_overflow)."""
    tw, th = config.tile_width, config.tile_height
    tx_n = config.tiles_x(width)
    ty_n = config.tiles_y(height) if total_tiles_y is None else total_tiles_y
    n = means2d.shape[0]
    n_eff = n if n_active is None else min(n_active, n)
    mx, my = means2d[:, 0], means2d[:, 1]

    tx0, ty0, w, h, clamped_big = tile_rects(
        means2d, radii, valid, width, height, config, extents=extents,
        total_tiles_y=total_tiles_y,
    )
    area = w * h  # 0 on invalid rows

    # static capacity: fraction heuristic or the absolute override
    # (config.big_capacity docstring; floor of 64 keeps small scenes exact)
    m_big = config.big_capacity(n_eff)
    eligible = area > config.small_tiles_per_gaussian
    score = jnp.where(eligible, area, 0)
    _, big_idx = jax.lax.top_k(score, m_big)
    sel = eligible[big_idx]  # capacity slots actually holding eligible splats
    is_big = jnp.zeros((n,), bool).at[big_idx].set(sel)
    tier_overflow = jnp.sum(eligible.astype(jnp.int32)) - jnp.sum(
        sel.astype(jnp.int32)
    )

    tx0, ty0, w, h, shrunk = _shrink_to_cap(
        tx0,
        ty0,
        w,
        h,
        config.small_tiles_per_gaussian,
        mx,
        my,
        tw,
        th,
        tx_n,
        ty_n,
        apply=~is_big,
    )
    clamped = clamped_big + jnp.sum((shrunk & valid).astype(jnp.int32))
    return tx0, ty0, w, h, is_big, big_idx, clamped, tier_overflow


def code_packing_ok(
    width: int, height: int, config: RenderConfig, total_tiles_y: int = None
) -> bool:
    """Whether the rect+flags pack into one u32 (see bin_gaussians):
    requires tx0 ≤ 127, ty0 ≤ 511, w/area ≤ 63 — true up to 4K at 32×16."""
    ty_n = config.tiles_y(height) if total_tiles_y is None else total_tiles_y
    return (
        config.tiles_x(width) <= 127
        and ty_n <= 511
        and config.max_tiles_per_gaussian <= 63
    )


def rect_codes(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    config: RenderConfig,
    n_active: int = None,
    total_tiles_y: int = None,
):
    """Original-index-order packed rect codes for the one-gather pipeline.

    Returns (code (N,) u32, clamped () i32, tier_overflow () i32). The caller rides `code`
    (bitcast to f32) as an extra column of the depth-ordered feature-table
    gather, then hands the gathered column to `bin_gaussians(...,
    order=..., code_sorted=...)` — eliminating binning's own 1-column
    gather (a row gather's cost is mostly per row, so the extra column is
    nearly free). Only valid when `code_packing_ok`.
    """
    assert code_packing_ok(width, height, config, total_tiles_y)
    tx0_o, ty0_o, w_o, h_o, is_big_o, _big, clamped, tier_ovf = effective_rects(
        proj.means2d, proj.radii, proj.valid, width, height, config,
        n_active=n_active, extents=proj.extents, total_tiles_y=total_tiles_y,
    )
    code = (
        tx0_o.astype(jnp.uint32)
        | (ty0_o.astype(jnp.uint32) << 7)
        | (w_o.astype(jnp.uint32) << 16)
        | ((w_o * h_o).astype(jnp.uint32) << 22)
        | (is_big_o.astype(jnp.uint32) << 28)
        | (proj.valid.astype(jnp.uint32) << 29)
    )
    return code, clamped, tier_ovf


def _cell_sigma_min(tx, ty_global, mx, my, A2, B, C2, tw, th):
    """Exact min of σ = A2·dx² + B·dx·dy + C2·dy² over a tile's pixel-center
    box [tx·tw+0.5, tx·tw+tw−0.5] × [ty·th+0.5, ty·th+th−0.5].

    The box-constrained minimum of a positive-definite quadratic is 0 if the
    mean is inside, else it lies on the boundary: evaluate the 1-D clamped
    minimizer on each of the four edges and take the min. ~25 ops/cell."""
    x0 = tx.astype(jnp.float32) * tw + 0.5
    y0 = ty_global.astype(jnp.float32) * th + 0.5
    dx0 = x0 - mx
    dx1 = dx0 + (tw - 1.0)
    dy0 = y0 - my
    dy1 = dy0 + (th - 1.0)
    inside = (dx0 <= 0.0) & (0.0 <= dx1) & (dy0 <= 0.0) & (0.0 <= dy1)
    inv2c = 1.0 / jnp.maximum(2.0 * C2, 1e-12)
    inv2a = 1.0 / jnp.maximum(2.0 * A2, 1e-12)

    def sig(dx, dy):
        return (A2 * dx) * dx + (C2 * dy + B * dx) * dy

    def edge_x(dx):  # fixed dx, minimize over dy
        dy = jnp.clip(-B * dx * inv2c, dy0, dy1)
        return sig(dx, dy)

    def edge_y(dy):  # fixed dy, minimize over dx
        dx = jnp.clip(-B * dy * inv2a, dx0, dx1)
        return sig(dx, dy)

    smin = jnp.minimum(
        jnp.minimum(edge_x(dx0), edge_x(dx1)),
        jnp.minimum(edge_y(dy0), edge_y(dy1)),
    )
    return jnp.where(inside, 0.0, smin)


def bin_gaussians(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    config: RenderConfig,
    max_active: int = None,
    order: jax.Array = None,
    code_sorted: jax.Array = None,
    clamped_precomputed: jax.Array = None,
    tier_overflow_precomputed: jax.Array = None,
    tile_row0: jax.Array = None,
    total_tiles_y: int = None,
    table_sorted: jax.Array = None,
    opacities: jax.Array = None,
) -> BinningResult:
    """Full binning pass. All shapes static; jit-safe.

    `max_active` (static) caps how many depth-sorted gaussians may emit pairs:
    the sharded path marks out-of-band splats invalid and passes its band
    capacity here, so the padded expansion — and the dominant pair sort — runs
    over M rows instead of N (per-chip sort ≈ 1/D of the single-chip one).
    Valid gaussians beyond the cap are counted in `dropped_gaussians`.

    `order` + `code_sorted` (+ `clamped_precomputed`, all from `rect_codes`):
    the one-gather pipeline hands in the depth order and the already-gathered
    rect codes (they rode the pair-feature-table gather as an extra column),
    so this function performs NO argsort and NO gather at all.

    `tile_row0` (traced () int32) + `total_tiles_y` (static): GLOBAL-grid
    banding for the sharded path. Rects, K-cap shrinks, and tier membership
    are computed against the global `total_tiles_y`-row grid (bit-identical
    to the single-chip decisions, since means2d stays in global pixel
    coordinates); this function then clips each rect to the band of
    `tiles_y(height)` rows starting at `tile_row0` and emits band-local tile
    ids. With `tile_row0=None` the band IS the frame (single-chip path,
    unchanged).

    `table_sorted` ((N, ≥10) [mx,my,A,B,C,…,op] in depth-rank order) or
    `opacities` ((N,) original order, gathered here): enables the EXACT
    per-cell σ-bound tile test — a (gaussian, tile) pair whose support
    ellipse {σ ≤ bound} does not reach the tile's pixel-center box is
    dropped at expansion time. Output-identical (such pairs contribute α≡0
    in every backend); cuts real pairs ~9% on the shallow random bench scene
    and more on scenes with larger splats (rect corners the ellipse misses).
    The per-cell decision depends only on the splat and the GLOBAL tile, so
    it is sharding-partition-invariant. With neither argument the test is
    skipped (keep-all — previous behavior)."""
    tx_n = config.tiles_x(width)
    ty_n = config.tiles_y(height)
    num_tiles = tx_n * ty_n
    if total_tiles_y is not None and tile_row0 is None:
        tile_row0 = jnp.int32(0)
    n = proj.means2d.shape[0]
    m = n if max_active is None else min(max_active, n)
    K = config.max_tiles_per_gaussian
    budget = config.pair_budget(m)

    # --- 1. depth sort (near → far); culled splats sort last ----------------
    if order is None:
        depth_key = jnp.where(proj.valid, proj.depths, jnp.inf)
        order = jnp.argsort(depth_key)

    # --- 2. two-tier tile rects ---------------------------------------------
    # Sorting dominates binning, and its size is the PADDED expansion. A flat
    # cap of K=64 wastes ~90% of the sort on padding (typical mean overlap is
    # 3-6 tiles), but a flat cap of 16 visibly shrinks big near-camera splats.
    # Two tiers fix both: the top ~(N/fraction) largest-area gaussians get the
    # full K_big block, everyone else a K_small block — at 1M splats the sort
    # drops from 64M to ~18M entries.
    #
    # GATHER ELISION: rects and the
    # two-tier shrink are order-independent, so they run in ORIGINAL index
    # order on the un-gathered projection outputs; the post-shrink rect plus
    # the is_big/valid flags pack into ONE u32 per gaussian, and a single
    # 1-column gather by `order` replaces the three row gathers
    # (means2d/radii/valid ≈ 4 columns) the depth sort used to need.
    # Requires tx0 ≤ 127, ty0 ≤ 511, w/area ≤ 63 (true up to 4K at 32×16
    # tiles); larger frames fall back to gathering the rect columns directly.
    k_small = config.small_tiles_per_gaussian
    n_eff = min(m, n)
    m_big = config.big_capacity(n_eff)

    # tx0/ty0 can equal tx_n/ty_n (empty rect clipped at the far edge)
    grid_ty_n = ty_n if total_tiles_y is None else total_tiles_y
    pack_ok = tx_n <= 127 and grid_ty_n <= 511 and K <= 63
    if code_sorted is not None:
        assert pack_ok and order is not None and clamped_precomputed is not None
        code = code_sorted  # gathered by the caller (rode the table gather)
        clamped = clamped_precomputed
        tier_ovf = tier_overflow_precomputed
        if tier_ovf is None:
            tier_ovf = jnp.int32(0)
    elif pack_ok:
        code, clamped, tier_ovf = rect_codes(
            proj, width, height, config, n_active=m,
            total_tiles_y=total_tiles_y,
        )
        code = code[order]  # the ONE gather
    else:
        code = None
        tx0_o, ty0_o, w_o, h_o, is_big_o, _bi, clamped, tier_ovf = effective_rects(
            proj.means2d, proj.radii, proj.valid, width, height, config,
            n_active=m, extents=proj.extents, total_tiles_y=total_tiles_y,
        )
        tx0 = tx0_o[order]
        ty0 = ty0_o[order]
        w = w_o[order]
        h = h_o[order]
        is_big = is_big_o[order]
        valid = proj.valid[order]
    if code is not None:
        tx0 = (code & 0x7F).astype(jnp.int32)
        ty0 = ((code >> 7) & 0x1FF).astype(jnp.int32)
        w = ((code >> 16) & 0x3F).astype(jnp.int32)
        area = ((code >> 22) & 0x3F).astype(jnp.int32)
        is_big = ((code >> 28) & 1).astype(bool)
        valid = ((code >> 29) & 1).astype(bool)
        h = area // jnp.maximum(w, 1)  # exact: area was packed as w·h
    if tile_row0 is not None:
        # band clip in the GLOBAL grid: [ty0, ty0+h) ∩ [row0, row0+ty_n),
        # re-based to band-local rows. Everything upstream (shrinks, tier
        # flags, w) came from the global rect, so the per-gaussian geometry
        # is byte-identical to the single-chip decisions.
        ty1_b = jnp.clip(ty0 + h - tile_row0, 0, ty_n)
        ty0 = jnp.clip(ty0 - tile_row0, 0, ty_n)
        h = ty1_b - ty0
    area = w * h

    if m < n:
        in_cap = jnp.arange(n, dtype=jnp.int32) < m
        dropped = jnp.sum((valid & ~in_cap).astype(jnp.int32))
        area = jnp.where(in_cap, area, 0)
    else:
        dropped = jnp.int32(0)

    # rank-space index list of the big tier (≤ m_big set bits — threshold
    # membership leaves capacity slots unused on scenes with few big splats;
    # cheap in context — XLA fuses the 0/1 top_k)
    _, big_idx = jax.lax.top_k(is_big.astype(jnp.int32), m_big)
    big_used = is_big[big_idx]  # mask of capacity slots actually occupied

    # --- 2a. exact per-cell σ-bound tile test (optional) --------------------
    # A rect cell whose pixel-center box the {σ ≤ bound} support ellipse
    # provably misses yields α ≡ 0 for every pixel — emit nothing for it.
    # The σ/bound definitions are ops/falloff.py's (shared with every
    # backend); a +1e-4 absolute margin on the bound makes an FP-rounding
    # kill of a genuinely contributing pair impossible (the kernels' σ(p)
    # evaluation noise is ~1e-6 at these magnitudes).
    cellmask = None
    if table_sorted is not None or opacities is not None:
        from gaussian_splat_tpu.ops.falloff import sigma_bound

        if table_sorted is not None:
            mx_s = table_sorted[:, 0]
            my_s = table_sorted[:, 1]
            A2_s = 0.5 * table_sorted[:, 2]
            B_s = table_sorted[:, 3]
            C2_s = 0.5 * table_sorted[:, 4]
            op_s = table_sorted[:, 9]
        else:
            mx_s = proj.means2d[order, 0]
            my_s = proj.means2d[order, 1]
            A2_s = 0.5 * proj.conics[order, 0]
            B_s = proj.conics[order, 1]
            C2_s = 0.5 * proj.conics[order, 2]
            op_s = opacities[order]
        bound_s = sigma_bound(
            op_s, valid, config.sigma_cutoff, config.alpha_skip
        ) + jnp.float32(1e-4)
        row0_g = jnp.int32(0) if tile_row0 is None else tile_row0
        tw, th = config.tile_width, config.tile_height

        def cellmask(tx0e, ty0e, we, areae, rows, kk):
            """(len(rows), kk) bool: cell inside rect AND ellipse reaches it."""
            kidx = jnp.arange(kk, dtype=jnp.int32)[None, :]
            w_safe = jnp.maximum(we, 1)[:, None]
            tx = tx0e[:, None] + kidx % w_safe
            tyg = ty0e[:, None] + kidx // w_safe + row0_g
            smin = _cell_sigma_min(
                tx, tyg,
                mx_s[rows][:, None], my_s[rows][:, None],
                A2_s[rows][:, None], B_s[rows][:, None], C2_s[rows][:, None],
                tw, th,
            )
            return (kidx < areae[:, None]) & (smin <= bound_s[rows][:, None])

    if cellmask is not None:
        sl = slice(0, m)
        area_small_raw = jnp.where(is_big, 0, area)[:m]
        mask_s = cellmask(tx0[:m], ty0[:m], w[:m], area_small_raw, sl, k_small)
        area_big_raw = jnp.where(big_used, area[big_idx], 0)
        mask_b = cellmask(
            tx0[big_idx], ty0[big_idx], w[big_idx], area_big_raw, big_idx, K
        )
        # per-rank survivor counts replace the raw rect areas everywhere
        # downstream (budget, rank_starts, telemetry). Built with concat +
        # one scatter-add (a slice-assign .at[:m].set breaks under
        # checkify.all_checks' index instrumentation — empty-argmin bug)
        surv_s = jnp.sum(mask_s.astype(jnp.int32), axis=1)  # (m,)
        if m < n:
            surv_s = jnp.concatenate(
                [surv_s, jnp.zeros((n - m,), jnp.int32)]
            )
        area = surv_s.at[big_idx].add(jnp.sum(mask_b.astype(jnp.int32), axis=1))

    # --- 2b. rank-deterministic budget truncation ---------------------------
    # Drop WHOLE gaussians from the far end of the depth order until the pair
    # budget fits. This (a) makes overflow semantically clean (the farthest
    # splats vanish, instead of arbitrary per-tile-tail fragments), and
    # (b) makes per-rank pair counts exact, so `rank_starts` hands the
    # gather-VJP its segment boundaries without a searchsorted.
    budget = min(budget, m * k_small + m_big * K)
    starts_all = jnp.cumsum(area) - area  # exclusive prefix
    fits = starts_all + area <= budget
    eff_area = jnp.where(fits, area, 0)
    num_pairs = jnp.sum(area)
    overflow = num_pairs - jnp.sum(eff_area)
    rank_starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(eff_area).astype(jnp.int32)]
    )

    # post-truncation areas of the big set; UNUSED capacity slots must emit
    # nothing (their rows already emit through the small tier)
    big_vals = jnp.where(big_used, eff_area[big_idx], 0)

    # --- 3. padded pair expansion, then ONE sort -----------------------------
    # The padded expansion keeps every stage a regular, static-shape array op
    # (one sort); compaction schemes (searchsorted, scatter markers, scatter
    # compaction) trade it for irregular gathers and scatters.
    #
    # KEY PACKING: when tile_bits + rank_bits ≤ 32, (tile id, depth rank)
    # packs into ONE u32 key — sorted payload-free and unstable (keys are
    # unique: ≤1 pair per gaussian per tile), then decoded, instead of a
    # 2-key stable sort with payload. The default 32×16 tiles keep 1080p at 12 tile bits
    # so N ≤ 2²⁰ fits; larger products fall back to the 2-key stable sort
    # (the two expansion blocks concatenate out of depth order, so the sort
    # needs the rank — `gauss` indices ARE depth ranks here).
    rank_bits = max((m - 1).bit_length(), 1)
    tile_bits = max(num_tiles.bit_length(), 1)
    use_packed = rank_bits + tile_bits <= 32

    def expand(tx0e, ty0e, we, ok, gausse, kk):
        """Emit keys for the cells where `ok` ((rows, kk) bool) holds."""
        kidx = jnp.arange(kk, dtype=jnp.int32)[None, :]
        w_safe = jnp.maximum(we, 1)[:, None]
        tile = (ty0e[:, None] + kidx // w_safe) * tx_n + (
            tx0e[:, None] + kidx % w_safe
        )
        if use_packed:
            packed = (tile.astype(jnp.uint32) << rank_bits) | gausse[
                :, None
            ].astype(jnp.uint32)
            keys = jnp.where(ok, packed, jnp.uint32(0xFFFFFFFF))
            return keys.reshape(-1), None
        keys = jnp.where(ok, tile, num_tiles).astype(jnp.int32)
        gauss = jnp.broadcast_to(gausse[:, None], keys.shape)
        return keys.reshape(-1), gauss.reshape(-1)

    kidx_s = jnp.arange(k_small, dtype=jnp.int32)[None, :]
    kidx_b = jnp.arange(K, dtype=jnp.int32)[None, :]
    if cellmask is not None:
        # σ-test masks, gated by the budget fit of the whole gaussian
        ok_s = mask_s & fits[:m, None]
        ok_b = mask_b & fits[big_idx][:, None]
    else:
        # rows ≥ m are invalid (zero area) by construction, so the small-tier
        # expansion — the sort's bulk — covers only the first m depth ranks
        area_small = jnp.where(is_big, 0, eff_area)
        ok_s = kidx_s < area_small[:m, None]
        ok_b = kidx_b < big_vals[:, None]
    keys_s, gauss_s = expand(
        tx0[:m], ty0[:m], w[:m], ok_s,
        jnp.arange(m, dtype=jnp.int32), k_small,
    )
    keys_b, gauss_b = expand(
        tx0[big_idx], ty0[big_idx], w[big_idx], ok_b, big_idx, K
    )
    flat_keys = jnp.concatenate([keys_s, keys_b])

    if use_packed:
        (sorted_packed,) = jax.lax.sort(
            (flat_keys,), dimension=0, is_stable=False, num_keys=1
        )
        sorted_packed = sorted_packed[:budget]
        sorted_keys = (sorted_packed >> rank_bits).astype(jnp.int32)
        sorted_keys = jnp.minimum(sorted_keys, num_tiles)  # sentinel decode
        sorted_gauss = (
            sorted_packed & jnp.uint32((1 << rank_bits) - 1)
        ).astype(jnp.int32)
        sorted_gauss = jnp.where(sorted_keys < num_tiles, sorted_gauss, 0)
    else:
        flat_gauss = jnp.concatenate([gauss_s, gauss_b])
        sorted_keys, sorted_gauss = jax.lax.sort(
            (flat_keys, flat_gauss), dimension=0, is_stable=True, num_keys=2
        )
        sorted_keys = sorted_keys[:budget]
        sorted_gauss = sorted_gauss[:budget]

    # pad the pair array to a PAIR_ALIGN multiple plus one granule: a raster
    # kernel block that starts inside the list never reads past its end
    pad = (-budget) % PAIR_ALIGN + PAIR_ALIGN
    sorted_keys = jnp.concatenate(
        [sorted_keys, jnp.full((pad,), num_tiles, jnp.int32)]
    )
    sorted_gauss = jnp.concatenate([sorted_gauss, jnp.zeros((pad,), jnp.int32)])

    # --- 4. per-tile segment boundaries -------------------------------------
    # Segments are left UNALIGNED: the Pallas kernels read each segment in
    # masked blocks from its own offset, and the backward kernel writes only
    # its own segment's rows.
    boundaries = jnp.searchsorted(
        sorted_keys, jnp.arange(num_tiles + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    counts = boundaries[1:] - boundaries[:-1]  # (T,)

    return BinningResult(
        order=order,
        pair_gauss=sorted_gauss,
        pair_tile=sorted_keys,
        tile_offsets=boundaries[:-1],
        tile_counts=counts,
        num_pairs=num_pairs,
        overflow=overflow,
        clamped_rects=clamped,
        rank_starts=rank_starts,
        dropped_gaussians=dropped,
        tier_overflow=tier_ovf,
    )
