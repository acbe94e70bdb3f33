"""Pure-jnp oracle rasterizer: every splat against every pixel, exact semantics.

This is the framework's ground truth (SURVEY §4: the reference repo has zero
tests; the oracle + autodiff stands in for them). It implements gsplat-style
front-to-back alpha compositing with NO capacity limits, NO tiling, and NO early
termination, so its output and its autodiff gradients define the semantics every
faster backend (jnp tile rasterizer, Pallas kernels, sharded pipeline) is
allclose-validated against.

Semantics (shared constants live in RenderConfig):
  α_i   = min(opacity_i · exp(−σ_i), alpha_clamp),  σ = 0.5(A dx² + C dy²) + B dx dy
  α_i ← 0 where α_i < alpha_skip, σ < 0, or the splat was culled
  T_i   = Π_{j<i} (1 − α_j)   (depth order, near to far)
  C     = Σ_i c_i α_i T_i + T_final · background

This deliberately does NOT replicate the reference's active 50-layer OIT mode,
whose composite order is far-first with unpremultiplied colors
(/root/reference/shaders/gaussian_splat_50layer.metal:198-222 — the "front-to-back"
comment at :197 contradicts the code); per SURVEY §7 that is a reference quirk,
and the north star mandates gsplat-style (near-first, α-weighted) semantics.

Memory is O(N·H·W): use only for small scenes/tests.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.ops.falloff import alpha_from_sigma, sigma_bound, sigma_quadform


def composite_sorted(
    means2d: jax.Array,  # (N,2) already depth-sorted near→far
    conics: jax.Array,  # (N,3)
    colors: jax.Array,  # (N,C) — any channel count; the standard pipeline
    #   passes RGB+depth so the expected-depth map falls out of the same math
    opacities: jax.Array,  # (N,)
    valid: jax.Array,  # (N,) bool
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
) -> Tuple[jax.Array, jax.Array]:
    """Composite depth-sorted splats over all pixels. Returns (image (H,W,C), T_final (H,W))."""
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    ys = jnp.arange(height, dtype=jnp.float32) + 0.5

    dx = xs[None, None, :] - means2d[:, 0, None, None]  # (N,H,W) via broadcast
    dy = ys[None, :, None] - means2d[:, 1, None, None]
    A2 = 0.5 * conics[:, 0, None, None]
    B = conics[:, 1, None, None]
    C2 = 0.5 * conics[:, 2, None, None]
    # σ / keep / α semantics live in ops/falloff.py — textually shared with
    # the jnp tile backend and the Pallas kernels so boundary pixels agree
    sigma = sigma_quadform(dx, dy, A2, B, C2)  # (N,H,W)
    bound = sigma_bound(
        opacities[:, None, None], valid[:, None, None],
        config.sigma_cutoff, config.alpha_skip,
    )
    alpha, _, _ = alpha_from_sigma(sigma, opacities[:, None, None], bound,
                                   config.alpha_clamp)

    trans = jnp.cumprod(1.0 - alpha, axis=0)  # inclusive
    t_excl = jnp.concatenate(
        [jnp.ones_like(trans[:1]), trans[:-1]], axis=0
    )  # T_i, exclusive
    weights = alpha * t_excl  # (N,H,W)

    image = jnp.einsum("nhw,nc->hwc", weights, colors, precision=jax.lax.Precision.HIGHEST)
    t_final = trans[-1] if trans.shape[0] > 0 else jnp.ones((height, width))
    return image, t_final


def render_reference(
    means2d: jax.Array,
    conics: jax.Array,
    colors: jax.Array,
    opacities: jax.Array,
    depths: jax.Array,
    valid: jax.Array,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Depth-sort then composite. Returns (image (H,W,3), T_final (H,W),
    depth (H,W) — the α-weighted expected camera-space depth, composited as a
    fourth color channel).

    Background is applied here: C += T_final · bg. The sort indices are
    stop-gradiented implicitly (argsort is integer-valued); everything else is
    plain differentiable jnp.
    """
    key = jnp.where(valid, depths, jnp.inf)
    order = jnp.argsort(key)
    image, t_final = composite_sorted(
        means2d[order],
        conics[order],
        jnp.concatenate([colors, depths[:, None]], axis=1)[order],
        opacities[order],
        valid[order],
        width,
        height,
        config,
    )
    bg = jnp.asarray(config.background, jnp.float32)
    depth = image[..., 3]
    image = image[..., :3] + t_final[..., None] * bg
    return image, t_final, depth
