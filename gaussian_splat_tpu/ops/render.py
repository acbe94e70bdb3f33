"""Top-level render pipeline: activations → SH → projection → rasterization.

Replacement for the reference's frame encoding
(/root/reference/src/instanced_splat_renderer.mm:424-528): instead of a draw call
plus OIT passes, one jitted function composes cull → project → bin → sort →
raster over device arrays. Backend selection:

  * "reference": the O(N·H·W) oracle (tests/small scenes; exact semantics)
  * "jnp_tile":  tile binning + segmented-cumsum compositing in pure jnp
                 (CPU-friendly, differentiable via autodiff)
  * "pallas":    fused Pallas tile kernels with custom VJP (the fast path)
  * "auto":      pallas on the GPU, jnp_tile otherwise
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from gaussian_splat_tpu.camera import Camera
from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel
from gaussian_splat_tpu.ops import reference as reference_ops
from gaussian_splat_tpu.ops import sh as sh_ops
from gaussian_splat_tpu.ops.projection import ProjectedGaussians, project_gaussians, view_directions


class RenderOutput(NamedTuple):
    image: jax.Array  # (H, W, 3) composited color (background applied)
    alpha: jax.Array  # (H, W) 1 − T_final
    depth: jax.Array = None  # (H, W) α-weighted expected camera-space depth
    projected: Optional[ProjectedGaussians] = None  # per-gaussian debug info


def _project_and_shade(model: GaussianModel, camera: Camera, config: RenderConfig):
    proj = project_gaussians(
        model.means,
        model.quats,
        model.scales,
        camera,
        near_plane=config.near_plane,
        cov2d_dilation=config.cov2d_dilation,
        sigma_extent=config.sigma_extent,
        # opacity-aware extents are an upper bound for the antialiased mode
        # too: compensation ≤ 1 only lowers effective opacity further
        opacities=model.opacities if config.opacity_aware_extent else None,
        alpha_skip=config.alpha_skip if config.opacity_aware_extent else None,
    )
    degree = min(config.sh_degree, model.sh_degree)
    dirs = view_directions(model.means, camera)
    colors = sh_ops.eval_sh(degree, model.sh, dirs)
    return proj, colors


def _effective_opacities(model: GaussianModel, proj, config: RenderConfig):
    op = model.opacities
    if config.antialiased:
        op = op * proj.compensation
    return op


def auto_backend() -> str:
    """What `backend="auto"` resolves to: the Pallas kernels on the GPU, the
    plain jnp tile pipeline anywhere else."""
    return "pallas" if jax.default_backend() == "gpu" else "jnp_tile"


def render(
    model: GaussianModel,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
    screen_offset: Optional[jax.Array] = None,
) -> RenderOutput:
    """Render a scene. Differentiable w.r.t. every GaussianModel leaf.

    `screen_offset` is an optional (N, 2) array added to the projected 2D
    means. Training passes zeros and differentiates w.r.t. it to obtain the
    SCREEN-SPACE positional gradient — the 3DGS densification criterion —
    without a second rendering pass."""
    backend = config.backend
    if backend == "auto":
        backend = auto_backend()

    proj, colors = _project_and_shade(model, camera, config)
    if screen_offset is not None:
        proj = proj._replace(means2d=proj.means2d + screen_offset)
    opacities = _effective_opacities(model, proj, config)

    if backend == "reference":
        image, t_final, depth = reference_ops.render_reference(
            proj.means2d,
            proj.conics,
            colors,
            opacities,
            proj.depths,
            proj.valid,
            camera.width,
            camera.height,
            config,
        )
    elif backend == "jnp_tile":
        from gaussian_splat_tpu.ops import tile_raster

        image, t_final, depth = tile_raster.render_tiled(
            proj, colors, opacities, camera.width, camera.height, config
        )
    elif backend == "pallas":
        from gaussian_splat_tpu.ops import pallas_raster

        image, t_final, depth = pallas_raster.render_tiled_pallas(
            proj, colors, opacities, camera.width, camera.height, config
        )
    else:
        raise ValueError(f"unknown backend {backend!r}")

    return RenderOutput(
        image=image, alpha=1.0 - t_final, depth=depth, projected=proj
    )


def binning_stats(
    model: GaussianModel,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
):
    """The render path's binning telemetry at `camera` (no rasterization):
    a `BinningStats` of scalar num_pairs / overflow / clamped_rects /
    dropped_gaussians / tier_overflow. `overflow` and `tier_overflow` are the
    sentinels a calibrated config must hold at 0."""
    from gaussian_splat_tpu.ops.binning import BinningStats, bin_gaussians

    @jax.jit
    def stats(m, cam):
        proj, _ = _project_and_shade(m, cam, config)
        opac = _effective_opacities(m, proj, config)
        return BinningStats.of(bin_gaussians(
            proj, cam.width, cam.height, config, opacities=opac
        ))

    return jax.device_get(stats(model, camera))


def calibrate_render_config(
    model: GaussianModel,
    cameras,
    config: RenderConfig = RenderConfig(),
    pair_headroom: float = 1.15,
    big_headroom: float = 1.2,
    mesh_ndev: Optional[int] = None,
    margin_headroom: float = 2.0,
) -> RenderConfig:
    """Measure scene-dependent static capacities and return a tightened config.

    Every B-proportional stage (pair row gather, the raster
    kernels, the segment sum) scales with `pair_budget`, and the big-tier
    expansion block scales with the tier capacity — but both defaults are
    sized for a worst case the scene may be nowhere near (or, at 4K scales,
    UNDER it: the fraction heuristic under-sizes the tier — see
    RenderConfig.big_tier_capacity). This helper renders nothing: one cheap
    projection + rect pass per calibration camera measures

      * the total K-capped rect-cell count (an upper bound on num_pairs —
        the σ-bound cell test only removes pairs), setting
        `pairs_per_gaussian` with `pair_headroom`, and
      * the big-tier-eligible count (K-capped area > small cap), setting
        `big_tier_capacity` with `big_headroom` (so tier_overflow == 0 and
        the sharded pair partition stays exact by construction).

    With both sentinels at 0 the calibrated config renders BIT-IDENTICAL
    output to the default config — the budget and capacity only affect
    truncation and padding. `BinningStats.overflow`/`tier_overflow` remain
    the runtime guards if the scene or cameras change later (e.g. under
    training: pass several representative cameras and keep the headroom).

    With `mesh_ndev`, a third measurement sizes `shard_capacity_margin`: the
    max per-band splat incidence (band test identical to the sharded path's)
    minus the N/D resident share, scaled by `margin_headroom` — so the
    sharded compaction cap stays as tight as the scene allows without drops.

    `cameras` is one Camera or an iterable; the max over cameras is used.
    """
    import dataclasses

    from gaussian_splat_tpu.ops.binning import quantize_extent_up, tile_rects

    if isinstance(cameras, Camera):
        cameras = [cameras]
    n = model.num_gaussians
    max_sum_area = 0
    max_eligible = 0
    max_incidence = 0

    @jax.jit
    def measure(m, cam):
        proj, _ = _project_and_shade(m, cam, config)
        _tx0, _ty0, w, h, _cl = tile_rects(
            proj.means2d, proj.radii, proj.valid, cam.width, cam.height,
            config, extents=proj.extents,
        )
        area = w * h
        inc = jnp.int32(0)
        if mesh_ndev is not None and mesh_ndev > 1:
            rows_per_dev = -(-config.tiles_y(cam.height) // mesh_ndev)
            band_h = rows_per_dev * config.tile_height
            my = proj.means2d[:, 1]
            ry = quantize_extent_up(proj.extents[:, 1])
            per_band = []
            for d in range(mesh_ndev):
                lo, hi = jnp.float32(d * band_h), jnp.float32((d + 1) * band_h)
                per_band.append(jnp.sum(
                    (proj.valid & (my + ry > lo) & (my - ry < hi)).astype(
                        jnp.int32
                    )
                ))
            inc = jnp.max(jnp.stack(per_band))
        return (
            jnp.sum(area),
            jnp.sum((area > config.small_tiles_per_gaussian).astype(jnp.int32)),
            inc,
        )

    for cam in cameras:
        sum_area, eligible, inc = jax.device_get(measure(model, cam))
        max_sum_area = max(max_sum_area, int(sum_area))
        max_eligible = max(max_eligible, int(eligible))
        max_incidence = max(max_incidence, int(inc))

    ppg = max(max_sum_area * pair_headroom / max(n, 1), 0.5)
    big_cap = max(-(-int(max_eligible * big_headroom) // 1024) * 1024, 64)
    updates = dict(
        pairs_per_gaussian=round(ppg, 3),
        big_tier_capacity=big_cap,
    )
    if mesh_ndev is not None and mesh_ndev > 1:
        tail = max(max_incidence - -(-n // mesh_ndev), 0)
        # margin 1.0 already yields cap = N (no compaction possible beyond
        # that), so clamp: tiny scenes with band-spanning splats can measure
        # a tail above (1 - 1/D)·N
        updates["shard_capacity_margin"] = round(
            min(tail * margin_headroom / max(n, 1), 1.0), 4
        )
    return dataclasses.replace(config, **updates)


def measure_pair_costs(
    model: GaussianModel,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
):
    """Per-splat K-capped tile-rect areas at `camera` — the (N,) pair-cost
    vector behind `GaussianModel.lod_pair_budget`.

    Same cheap projection + rect pass as `calibrate_render_config` (no
    rasterization), but returning the PER-SPLAT costs instead of their sum:
    cost[i] is the number of tile cells splat i's K-capped rect covers, an
    upper bound on the pairs it contributes (the σ-bound cell test only
    removes pairs), and 0 for splats culled at this camera."""

    @jax.jit
    def measure(m, cam):
        from gaussian_splat_tpu.ops.binning import tile_rects

        proj, _ = _project_and_shade(m, cam, config)
        _tx0, _ty0, w, h, _cl = tile_rects(
            proj.means2d, proj.radii, proj.valid, cam.width, cam.height,
            config, extents=proj.extents,
        )
        return w * h

    return jax.device_get(measure(model, camera))


def measure_splat_contributions(
    model: GaussianModel,
    camera: Camera,
    config: RenderConfig = RenderConfig(),
):
    """Per-splat MEASURED visual contribution at `camera`: |∂Σimage/∂logit_i|,
    one differentiable render at the pose (N,) — the value vector for
    `GaussianModel.lod_pair_budget`.

    The opacity-logit gradient of the composited image is each splat's
    MARGINAL effect on the final pixels — occlusion, transmittance, and
    overlap included — and the backward kernel makes it one fwd+bwd pass
    (~2× frame time, once per scene load). Measured caveat
    (docs/REALISTIC_SCENE.md selector table): marginal gradients cannot
    predict the JOINT removal of a collectively-occluding stack — on the
    fog-tailed 2.5M scene this value lost to the plain impact ranking
    (13.0 vs 28.2 dB at the same pair spend), which is why
    `lod_pair_budget`'s default value stays impact and this measurement is
    opt-in."""

    @jax.jit
    def contrib(m, cam):
        g = jax.grad(
            lambda mm: jnp.sum(render(mm, cam, config).image)
        )(m)
        return jnp.abs(g.opacity_logits)

    return jax.device_get(contrib(model, camera))
