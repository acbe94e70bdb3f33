"""Fused Pallas tile-rasterization kernels (Triton route): forward + analytic
backward.

The GPU replacement for the reference's fragment pipeline
(/root/reference/shaders/gaussian_splat_50layer.metal:149-223 — atomic per-pixel
fragment lists + per-pixel insertion sort):

  * Grid = one program per 32×16 tile; its 512 pixels are one vector. Each
    program loads its own `tile_offsets[t]` / `tile_counts[t]` and walks its
    depth-ordered segment of the pair list — no atomics and no sorting in the
    kernel, binning already ordered everything.
  * Forward: the front-to-back recurrence T ← T·(1−α) runs one pair at a
    time over the 512-pixel vector, the pair's features as scalar loads;
    every SAT_CHUNK pairs the tile stops if all its pixels are saturated.
  * Backward: pairs are read in blocks of BWD_BLOCK with masked loads
    (segments are unaligned; rows outside [off, end) load as zeros and are
    inert), and the recurrence is vectorized over the block as a (512, G)
    array with a log-space prefix along G:
        T_i = T_in · exp( Σ_{j<i, block} log1p(−α_j) )
    computed with an f32 cumsum (CUDA cores, no tensor-core TF32 rounding).
  * The backward needs suffix sums Σ_{j>i} — rewritten as
    Σ_{j>i} x_j = X_total − Σ_{j≤i} x_j so it walks front-to-back in ONE pass
    (the gsplat CUDA kernel walks back-to-front instead), reusing the saved
    per-tile outputs (C, T_final) as residuals. Per-pair gradients are
    reductions over the 512 pixels, written with masked stores to the
    program's OWN rows [off, end) only: no program touches another tile's
    rows, so the result is race-free and independent of block order.
  * Depth rides as a fourth "color" channel: the expected-depth map uses the
    exact same compositing and backward math as RGB.

Layouts: pair features are feature-major (NF, B) f32 — rows
[mx, my, A, B, C, r, g, b, depth, opacity] — so a backward block load of one
feature is G contiguous floats. Tile outputs are (NROW=8, P) per tile: rows
0-2 RGB, row 3 depth, row 4 T_final, rows 5-7 zero.

Per-gaussian gradients are the per-pair rows summed per depth rank by a plain
`jax.ops.segment_sum`, left to XLA.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.ops.binning import bin_gaussians
from gaussian_splat_tpu.ops.falloff import alpha_from_sigma, sigma_bound, sigma_quadform
from gaussian_splat_tpu.ops.projection import ProjectedGaussians
from gaussian_splat_tpu.ops.tile_raster import tiles_to_image

NF = 10  # pair feature rows: mx,my,A,B,C, r,g,b,depth, op
NROW = 8  # output rows per tile: r,g,b,depth,T_final + 3 zero rows

# Launch shapes, chosen by measurement on an H100 (PERF.md, "Kernel
# decisions"). The backward's pair block must be a power of two ≤ PAIR_ALIGN
# (config.py):
# binning pads the pair array so a block that starts inside the list never
# reads past its end (interpret mode clamps out-of-range slices).
FWD_WARPS = 4
SAT_CHUNK = 32  # forward pairs between two saturation checks
BWD_BLOCK = 4
BWD_WARPS = 4
NUM_STAGES = 2


class RasterStatics(NamedTuple):
    """Hashable static parameters for the kernels (jit/custom_vjp friendly)."""

    tile_w: int
    tile_h: int
    tiles_x: int
    tiles_y: int
    alpha_clamp: float
    alpha_skip: float
    sigma_cutoff: float
    trans_eps: float
    sat_check: bool = True  # stop a tile's walk once every pixel's
    #   transmittance is below trans_eps (deviation ≤ trans_eps from τ=0);
    #   False = exact τ=0 semantics, every pair of the segment is visited


def _use_interpret() -> bool:
    """Interpret mode on the CPU only; on the GPU the kernels compile or the
    call fails — there is no silent fallback."""
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise ValueError(
        f"the pallas backend runs on the GPU (or interpreted on the CPU), "
        f"not on {platform!r}"
    )


def _params(warps: int):
    return dict(
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=warps, num_stages=NUM_STAGES
        ),
    )


def _pixel_coords(static: RasterStatics, t, trow0):
    """Pixel-center coordinates of tile t as (P,) vectors (P = tw·th).

    `trow0` is the band's first GLOBAL tile row (0 single-chip): sharded
    bands evaluate px/py in global pixel coordinates so dx = px − mx is
    bit-identical to the single-chip kernel (sharded_render exactness)."""
    tw, th = static.tile_w, static.tile_h
    p = jnp.arange(tw * th, dtype=jnp.int32)
    tx = t % static.tiles_x
    ty = t // static.tiles_x + trow0
    px = (tx * tw + p % tw).astype(jnp.float32) + 0.5
    py = (ty * th + p // tw).astype(jnp.float32) + 0.5
    return px, py


def _load_block(feats_ref, start, end, g):
    """Masked load of pair rows [start, start+g) ∩ [.., end): NF (G,) rows
    (zeros outside the segment) and the (G,) row mask."""
    m = start + jnp.arange(g, dtype=jnp.int32) < end
    rows = [
        plgpu.load(feats_ref.at[k, pl.ds(start, g)], mask=m, other=0.0)
        for k in range(NF)
    ]
    return rows, m


def _block_alpha(static: RasterStatics, f, m, px, py):
    """Shared forward math for one block of pairs: (P, G) arrays from the
    (G,) feature rows `f` and mask `m`.

    The σ / keep / α math is ops/falloff.py, textually shared with the oracle
    and the jnp tile backend. Rows outside the segment get bound = −1 and so
    α ≡ 0 (an exact no-op in both recurrences)."""
    f = [x[None, :] for x in f]
    bound = sigma_bound(f[9], m[None, :], static.sigma_cutoff, static.alpha_skip)
    dx = px[:, None] - f[0]
    dy = py[:, None] - f[1]
    sigma = sigma_quadform(dx, dy, 0.5 * f[2], f[3], 0.5 * f[4])
    alpha, alpha_raw, keep = alpha_from_sigma(
        sigma, f[9], bound, static.alpha_clamp
    )
    return alpha, alpha_raw, keep, dx, dy


def _walk(static: RasterStatics, nblk, body, log_t0, carry0):
    """Loop `body(i, log_t, carry)` over a segment's blocks; with sat_check,
    stop once every pixel's log-transmittance is below log(trans_eps)."""
    if not static.sat_check:
        return jax.lax.fori_loop(
            0, nblk, lambda i, c: body(i, *c), (log_t0, carry0)
        )
    log_eps = np.float32(np.log(max(static.trans_eps, 1e-30)))

    def cond(c):
        i, log_t, _ = c
        return (i < nblk) & (jnp.max(log_t) > log_eps)

    def step(c):
        i, log_t, carry = c
        return (i + 1, *body(i, log_t, carry))

    _, log_t, carry = jax.lax.while_loop(
        cond, step, (jnp.int32(0), log_t0, carry0)
    )
    return log_t, carry


# ---------------------------------------------------------------------------
# Forward kernel
# ---------------------------------------------------------------------------


def _fwd_kernel(static: RasterStatics, offs_ref, cnts_ref, trow0_ref, feats_ref, out_ref):
    """Forward: one pair at a time over the tile's 512-pixel vector (scalar
    feature loads, multiplicative transmittance); the saturation test runs
    once every SAT_CHUNK pairs."""
    npix = static.tile_w * static.tile_h
    t = pl.program_id(0)
    off = offs_ref[t]
    end = off + cnts_ref[t]
    px, py = _pixel_coords(static, t, trow0_ref[0])

    def pair(j, carry):
        trans, acc = carry
        f = [feats_ref[k, j] for k in range(NF)]
        bound = sigma_bound(f[9], True, static.sigma_cutoff, static.alpha_skip)
        dx = px - f[0]
        dy = py - f[1]
        sigma = sigma_quadform(dx, dy, 0.5 * f[2], f[3], 0.5 * f[4])
        alpha, _, _ = alpha_from_sigma(sigma, f[9], bound, static.alpha_clamp)
        w = alpha * trans
        acc = tuple(a + w * f[5 + c] for c, a in enumerate(acc))
        return trans * (1.0 - alpha), acc

    zero = jnp.zeros((npix,), jnp.float32)
    carry = (zero + 1.0, (zero,) * 4)
    if static.sat_check:
        eps = np.float32(static.trans_eps)

        def cond(c):
            s, trans, _ = c
            return (s < end) & (jnp.max(trans) > eps)

        def step(c):
            s, trans, acc = c
            trans, acc = jax.lax.fori_loop(
                s, jnp.minimum(s + SAT_CHUNK, end), pair, (trans, acc)
            )
            return s + SAT_CHUNK, trans, acc

        _, trans, acc = jax.lax.while_loop(cond, step, (off, *carry))
    else:
        trans, acc = jax.lax.fori_loop(off, end, pair, carry)
    for c in range(4):
        out_ref[c, :] = acc[c]
    out_ref[4, :] = trans
    for c in range(5, NROW):
        out_ref[c, :] = zero


def _trow0_arr(trow0):
    """Normalize the band tile-row offset to a (1,) i32 array."""
    if trow0 is None:
        return jnp.zeros((1,), jnp.int32)
    return jnp.asarray(trow0, jnp.int32).reshape((1,))


_ANY = pl.BlockSpec(memory_space=pl.ANY)


def _raster_forward(pair_feats, offsets, counts, static: RasterStatics,
                    trow0=None):
    num_tiles = static.tiles_x * static.tiles_y
    npix = static.tile_w * static.tile_h
    return pl.pallas_call(
        functools.partial(_fwd_kernel, static),
        grid=(num_tiles,),
        in_specs=[_ANY, _ANY, _ANY, _ANY],
        out_specs=pl.BlockSpec((NROW, npix), lambda t: (t, 0)),
        out_shape=jax.ShapeDtypeStruct((num_tiles * NROW, npix), jnp.float32),
        interpret=_use_interpret(),
        name="gs_raster_fwd",
        **_params(FWD_WARPS),
    )(offsets, counts, _trow0_arr(trow0), pair_feats)


# ---------------------------------------------------------------------------
# Backward kernel
# ---------------------------------------------------------------------------


def _bwd_kernel(
    static: RasterStatics,
    offs_ref,
    cnts_ref,
    trow0_ref,
    feats_ref,
    fwd_ref,  # (NROW, P) block: forward result for this tile
    cot_ref,  # (NROW, P) block: cotangent (rows 0-3 dC, row 4 dT_final)
    zeros_ref,  # aliased to d_ref: pairs no program writes stay zero
    d_ref,  # (NF, B) per-pair gradients
):
    del zeros_ref
    g = BWD_BLOCK
    npix = static.tile_w * static.tile_h
    t = pl.program_id(0)
    off = offs_ref[t]
    end = off + cnts_ref[t]
    px, py = _pixel_coords(static, t, trow0_ref[0])

    g_c = [cot_ref[c, :][:, None] for c in range(4)]  # (P, 1) rgb+depth
    # Q = gC·C_total + g_Tf·T_final  (P,)
    q = cot_ref[4, :] * fwd_ref[4, :]
    for c in range(4):
        q = q + cot_ref[c, :] * fwd_ref[c, :]

    def body(i, log_t, incl_acc):
        start = off + i * g
        f, m = _load_block(feats_ref, start, end, g)
        alpha, alpha_raw, keep, dx, dy = _block_alpha(static, f, m, px, py)
        la = jnp.log1p(-alpha)
        t_i = jnp.exp(log_t[:, None] + (jnp.cumsum(la, axis=1) - la))
        w = alpha * t_i  # (P, G)
        v = g_c[0] * f[5][None, :]
        for c in range(1, 4):
            v = v + g_c[c] * f[5 + c][None, :]
        contrib = v * w
        # inclusive prefix Σ_{j≤i} v_j α_j T_j, carried across blocks
        incl = incl_acc[:, None] + jnp.cumsum(contrib, axis=1)
        da = v * t_i - (q[:, None] - incl) / (1.0 - alpha)  # 1−α ≥ 1−clamp
        # chain through α = min(α_raw, clamp) with masks
        da = jnp.where(keep & (alpha_raw < static.alpha_clamp), da, 0.0)
        dsig = -da * alpha_raw  # d(op·e^{-σ})/dσ = −α_raw

        # reductions over the tile's pixels → (G,) per-pair gradients
        s1 = jnp.sum(dsig, axis=0)
        m_x = jnp.sum(dsig * dx, axis=0)  # Σ_p dσ·dx
        m_y = jnp.sum(dsig * dy, axis=0)
        m_xx = jnp.sum(dsig * dx * dx, axis=0)
        m_xy = jnp.sum(dsig * dx * dy, axis=0)
        m_yy = jnp.sum(dsig * dy * dy, axis=0)
        A, B, C, op = f[2], f[3], f[4], f[9]
        # Σ_p da·e^{-σ} = −S1/op (op is uniform per pair)
        dop = jnp.where(op > 0.0, -s1 / jnp.where(op > 0.0, op, 1.0), 0.0)
        grads = [
            -(A * m_x + B * m_y),  # d mx
            -(C * m_y + B * m_x),  # d my
            0.5 * m_xx,  # d A
            m_xy,  # d B
            0.5 * m_yy,  # d C
            *(jnp.sum(g_c[c] * w, axis=0) for c in range(4)),  # d chans
            dop,
        ]
        rows = pl.ds(start, g)
        for k in range(NF):
            plgpu.store(d_ref.at[k, rows], grads[k], mask=m)
        return log_t + jnp.sum(la, axis=1), incl_acc + jnp.sum(contrib, axis=1)

    zero = jnp.zeros((npix,), jnp.float32)
    _walk(static, pl.cdiv(end - off, g), body, zero, zero)


def _raster_backward(pair_feats, offsets, counts, fwd_out, cot,
                     static: RasterStatics, trow0=None):
    """Per-pair gradient kernel: (NF, B) f32, zero outside every segment."""
    num_tiles = static.tiles_x * static.tiles_y
    npix = static.tile_w * static.tile_h
    tile_block = pl.BlockSpec((NROW, npix), lambda t: (t, 0))
    return pl.pallas_call(
        functools.partial(_bwd_kernel, static),
        grid=(num_tiles,),
        in_specs=[_ANY, _ANY, _ANY, _ANY, tile_block, tile_block, _ANY],
        out_specs=_ANY,
        out_shape=jax.ShapeDtypeStruct(pair_feats.shape, jnp.float32),
        input_output_aliases={6: 0},
        interpret=_use_interpret(),
        name="gs_raster_bwd",
        **_params(BWD_WARPS),
    )(offsets, counts, _trow0_arr(trow0), pair_feats, fwd_out, cot,
      jnp.zeros(pair_feats.shape, jnp.float32))


# ---------------------------------------------------------------------------
# custom_vjp wrappers
# ---------------------------------------------------------------------------


def _f0(x):
    """float0 cotangent for a non-differentiable primal (None passes through)."""
    if x is None:
        return None
    return np.zeros(jnp.shape(x), dtype=jax.dtypes.float0)


def _sum_by_rank(d_pairs, ranks_keyed, n):
    """(NF, B) per-pair gradients → (N, NF) per-depth-rank sums: XLA's
    scatter-add (atomics on the GPU, so summation order may vary run to run).
    Padding rows carry the sentinel rank N and are dropped."""
    return jax.ops.segment_sum(d_pairs.T, ranks_keyed, num_segments=n)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _raster(pair_feats, offsets, counts, static: RasterStatics, trow0=None):
    return _raster_forward(pair_feats, offsets, counts, static, trow0=trow0)


def _raster_fwd(pair_feats, offsets, counts, static, trow0=None):
    out = _raster_forward(pair_feats, offsets, counts, static, trow0=trow0)
    return out, (pair_feats, offsets, counts, out, trow0)


def _raster_bwd(static, residuals, cot):
    pair_feats, offsets, counts, fwd_out, trow0 = residuals
    d_feats = _raster_backward(
        pair_feats, offsets, counts, fwd_out, cot, static, trow0=trow0
    )
    return d_feats, _f0(offsets), _f0(counts), _f0(trow0)


_raster.defvjp(_raster_fwd, _raster_bwd)


def _gather_sorted_t(table10, ranks_keyed):
    """(N, NF) rank-ordered table → (NF, B) feature-major pair array; padding
    rows (rank N) gather a sentinel row of zeros."""
    n = table10.shape[0]
    table = jnp.concatenate([table10, jnp.zeros((1, NF), table10.dtype)], axis=0)
    return jnp.take(table, jnp.minimum(ranks_keyed, n), axis=0).T


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def raster_pairs(feats10, order, ranks_keyed, offsets, counts,
                 static: RasterStatics, trow0=None):
    """Gather per-pair features and rasterize: (N, 10) per-gaussian features
    in ORIGINAL order → (T·NROW, P) tile outputs, differentiable w.r.t.
    feats10 only. `order` is the depth argsort (rank → original index)."""
    pair_feats = _gather_sorted_t(jnp.take(feats10, order, axis=0), ranks_keyed)
    return _raster_forward(pair_feats, offsets, counts, static, trow0=trow0)


def _raster_pairs_fwd(feats10, order, ranks_keyed, offsets, counts, static,
                      trow0=None):
    pair_feats = _gather_sorted_t(jnp.take(feats10, order, axis=0), ranks_keyed)
    out = _raster_forward(pair_feats, offsets, counts, static, trow0=trow0)
    return out, (pair_feats, offsets, counts, out, order, ranks_keyed, trow0)


def _raster_pairs_bwd(static, res, cot):
    pair_feats, offsets, counts, fwd_out, order, ranks_keyed, trow0 = res
    n = order.shape[0]
    d_pairs = _raster_backward(
        pair_feats, offsets, counts, fwd_out, cot, static, trow0=trow0
    )
    d_rank = _sum_by_rank(d_pairs, ranks_keyed, n)  # (N, NF), rank order
    # rank order → original order: `order` is a permutation, so this
    # scatter touches every row exactly once
    d_feats10 = jnp.zeros_like(d_rank).at[order].set(d_rank, unique_indices=True)
    return (
        d_feats10, _f0(order), _f0(ranks_keyed), _f0(offsets), _f0(counts),
        _f0(trow0),
    )


raster_pairs.defvjp(_raster_pairs_fwd, _raster_pairs_bwd)


# ---------------------------------------------------------------------------
# One-gather pipeline: raster from a DEPTH-ORDERED feature table
# ---------------------------------------------------------------------------
# `raster_pairs` gathers its (N, 10) feature table by `order` inside the
# custom_vjp and un-permutes the per-gaussian gradients itself.
# `raster_pairs_sorted` moves the permutation OUT of the custom_vjp: the
# caller gathers the table once (riding binning's rect codes on the same row
# gather — see binning.rect_codes) and receives rank-ordered gradients, whose
# re-ordering is `take_rows`' transpose.


@jax.custom_vjp
def take_rows(x, order):
    """Row gather whose transpose is a gather by the inverse permutation
    instead of a scatter-add. `order` must be a permutation (unique indices),
    which binning's argsort guarantees."""
    return jnp.take(x, order, axis=0)


def _take_rows_fwd(x, order):
    return jnp.take(x, order, axis=0), (order, x.shape[0])


def _take_rows_bwd(res, d_out):
    order, n = res
    _, inv = jax.lax.sort((order, jnp.arange(n, dtype=jnp.int32)), num_keys=1)
    return jnp.take(d_out, inv, axis=0), np.zeros(order.shape, jax.dtypes.float0)


take_rows.defvjp(_take_rows_fwd, _take_rows_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def raster_pairs_sorted(table10, ranks_keyed, offsets, counts,
                        static: RasterStatics, trow0=None):
    """Rasterize from a depth-ordered per-gaussian feature table.

    table10: (N, 10) [mx,my,A,B,C,r,g,b,depth,op] in DEPTH-RANK order
    ranks_keyed: (B,) depth rank per pair, == N on padding rows
    Returns (T·NROW, P) tile outputs; the VJP yields d_table10 in the same
    rank order (the caller's gather transpose restores original order)."""
    pair_feats = _gather_sorted_t(table10, ranks_keyed)
    return _raster_forward(pair_feats, offsets, counts, static, trow0=trow0)


def _raster_pairs_sorted_fwd(table10, ranks_keyed, offsets, counts, static,
                             trow0=None):
    pair_feats = _gather_sorted_t(table10, ranks_keyed)
    out = _raster_forward(pair_feats, offsets, counts, static, trow0=trow0)
    res = (pair_feats, offsets, counts, out, ranks_keyed, table10.shape[0],
           trow0)
    return out, res


def _raster_pairs_sorted_bwd(static, res, cot):
    pair_feats, offsets, counts, fwd_out, ranks_keyed, n, trow0 = res
    d_pairs = _raster_backward(
        pair_feats, offsets, counts, fwd_out, cot, static, trow0=trow0
    )
    return (
        _sum_by_rank(d_pairs, ranks_keyed, n), _f0(ranks_keyed), _f0(offsets),
        _f0(counts), _f0(trow0),
    )


raster_pairs_sorted.defvjp(_raster_pairs_sorted_fwd, _raster_pairs_sorted_bwd)


# ---------------------------------------------------------------------------
# Public entry: full tiled pipeline with the Pallas kernels
# ---------------------------------------------------------------------------


def render_tiled_pallas(
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
    """`tile_row0` (traced () i32) + `total_tiles_y` (static): render this
    call's `height`-pixel frame as a horizontal BAND of a `total_tiles_y`-row
    global frame, starting at global tile row `tile_row0`, with means2d in
    GLOBAL pixel coordinates — every per-gaussian decision and every α is
    then bit-identical to the single-chip render (sharded exactness)."""
    tw, th = config.tile_width, config.tile_height
    tx_n = config.tiles_x(width)
    ty_n = config.tiles_y(height)
    num_tiles = tx_n * ty_n
    npix = tw * th
    if npix & (npix - 1):
        raise ValueError(
            f"pallas backend needs a power-of-two tile pixel count, got {tw}x{th}"
        )

    static = RasterStatics(
        tile_w=tw,
        tile_h=th,
        tiles_x=tx_n,
        tiles_y=ty_n,
        alpha_clamp=config.alpha_clamp,
        alpha_skip=config.alpha_skip,
        sigma_cutoff=config.sigma_cutoff,
        trans_eps=config.transmittance_eps,
        sat_check=config.sat_check,
    )

    n = proj.means2d.shape[0]
    feats10 = jnp.concatenate(
        [
            proj.means2d,  # (N, 2)
            proj.conics,  # (N, 3)
            colors,  # (N, 3)
            proj.depths[:, None],  # (N, 1) — composited as a 4th channel
            opacities[:, None],  # (N, 1)
        ],
        axis=1,
    )  # (N, 10)

    from gaussian_splat_tpu.ops.binning import code_packing_ok, rect_codes

    if code_packing_ok(width, height, config, total_tiles_y):
        # ONE-GATHER PIPELINE: binning's packed rect codes ride the feature-
        # table row gather as an 11th column — binning then needs no gather
        # of its own, and the rank-ordered raster VJP needs no inverse
        # permutation (take_rows' transpose restores original order).
        m = n if max_active is None else min(max_active, n)
        code, clamped, tier_ovf = rect_codes(
            proj, width, height, config, n_active=m,
            total_tiles_y=total_tiles_y,
        )
        depth_key = jnp.where(proj.valid, proj.depths, jnp.inf)
        order = jnp.argsort(depth_key)
        codef = jax.lax.stop_gradient(
            jax.lax.bitcast_convert_type(code, jnp.float32)
        )
        combined = jnp.concatenate([feats10, codef[:, None]], axis=1)
        table_all = take_rows(combined, order)  # THE one gather
        code_sorted = jax.lax.bitcast_convert_type(
            jax.lax.stop_gradient(table_all[:, 10]), jnp.uint32
        )
        binning = bin_gaussians(
            proj, width, height, config, max_active=max_active,
            order=order, code_sorted=code_sorted, clamped_precomputed=clamped,
            tier_overflow_precomputed=tier_ovf,
            tile_row0=tile_row0, total_tiles_y=total_tiles_y,
            table_sorted=table_all[:, :10],  # enables the σ-bound tile test
        )
        valid_p = binning.pair_tile < num_tiles
        ranks_keyed = jnp.where(valid_p, binning.pair_gauss, n)
        tiles_flat = raster_pairs_sorted(
            table_all[:, :10], ranks_keyed, binning.tile_offsets,
            binning.tile_counts, static, _trow0_arr(tile_row0),
        )  # (T·NROW, P)
    else:
        binning = bin_gaussians(
            proj, width, height, config, max_active=max_active,
            tile_row0=tile_row0, total_tiles_y=total_tiles_y,
            opacities=opacities,
        )
        valid_p = binning.pair_tile < num_tiles
        # pair ranks with a sentinel on padding rows → exact VJP segments
        ranks_keyed = jnp.where(valid_p, binning.pair_gauss, n)
        tiles_flat = raster_pairs(
            feats10, binning.order, ranks_keyed, binning.tile_offsets,
            binning.tile_counts, static, _trow0_arr(tile_row0),
        )  # (T·NROW, P) — fused gather+raster custom VJP

    tiles = tiles_flat.reshape(num_tiles, NROW, npix)
    tiles_rgbd = jnp.swapaxes(tiles[:, 0:4, :], 1, 2)  # (T, P, 4)
    t_final_tiles = tiles[:, 4, :]  # (T, P)

    rgbd = tiles_to_image(tiles_rgbd, tx_n, ty_n, width, height, tw, th)
    t_final = tiles_to_image(
        t_final_tiles[..., None], tx_n, ty_n, width, height, tw, th
    )[..., 0]
    bg = jnp.asarray(config.background, jnp.float32)
    depth = rgbd[..., 3]
    image = rgbd[..., :3] + t_final[..., None] * bg
    if return_stats:
        from gaussian_splat_tpu.ops.binning import BinningStats

        return image, t_final, depth, BinningStats.of(binning)
    return image, t_final, depth
