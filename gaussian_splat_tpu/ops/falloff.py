"""Shared per-splat falloff semantics: ONE definition for all three backends.

The oracle (ops/reference.py), the jnp tile rasterizer (ops/tile_raster.py) and
the Pallas kernels (ops/pallas_raster.py) must agree on α to the last ulp —
their parity tests compare at tolerances far below the α_skip step (1/255), so
a pair that flips across the skip/cutoff boundary in ONE backend shows up as a
4e-3 pixel error. That forces the α math to be TEXTUALLY shared, not merely
equivalent: these helpers are the single source of truth.

Semantics:

    σ      = 0.5·A·dx² + B·dx·dy + 0.5·C·dy²          (EWA falloff argument,
             reference math: /root/reference/shaders/gaussian_splat.metal:157-163
             evaluated in the fragment shader as exp(−0.5 d²) per pixel)
    bound  = min(σ_cutoff, ln(op) − ln(α_skip))        (per GAUSSIAN, not per pixel)
    keep   = (σ ≥ 0) ∧ (σ ≤ bound)
    α      = keep ? min(op·e^(−σ), α_clamp) : 0

The `bound` folding: the per-PIXEL tests
(σ ≤ cutoff, op·e^(−σ) ≥ α_skip, valid) collapse into one per-gaussian scalar
(α ≥ skip ⟺ σ ≤ ln(op/α_skip)) so the (pixels × gaussians) inner loop runs
2 compares + 1 and instead of 4 compares + 3 ands — and it is the exact same
bound the opacity-aware billboard extents already use for tile culling
(ops/projection.py), so binning and compositing now share one support
definition. The quadratic form is factored for FMA chains: with A2 = 0.5A,
C2 = 0.5C,  σ = (A2·dx)·dx + (C2·dy + B·dx)·dy — 6 ops instead of 9.

Validity folds into the bound as well (invalid/out-of-segment rows get
bound = −1, unreachable since σ ≥ 0), so masked rows cost nothing extra.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_TINY_OP = 1e-30  # log argument floor; real opacities are sigmoid outputs > 0


def sigma_bound(
    opacities: jax.Array,
    valid: jax.Array,
    sigma_cutoff: float,
    alpha_skip: float,
) -> jax.Array:
    """Per-gaussian σ acceptance bound: min(cutoff, ln(op/α_skip)); −1 if invalid.

    Shapes broadcast: `opacities` and `valid` must already be mutually
    broadcastable; the result broadcasts against σ."""
    log_skip = np.float32(np.log(alpha_skip))
    lop = jnp.log(jnp.maximum(opacities, _TINY_OP))
    bound = jnp.minimum(jnp.float32(sigma_cutoff), lop - log_skip)
    return jnp.where(valid, bound, jnp.float32(-1.0))


def sigma_quadform(dx, dy, A2, B, C2):
    """σ = (A2·dx)·dx + (C2·dy + B·dx)·dy with A2 = 0.5·A, C2 = 0.5·C.

    All backends MUST evaluate σ with this exact factorization — a different
    association rounds differently and flips keep-boundary pixels between
    backends."""
    return (A2 * dx) * dx + (C2 * dy + B * dx) * dy


def alpha_from_sigma(sigma, opacities, bound, alpha_clamp):
    """(α, α_raw, keep) from the falloff argument. α is 0 outside keep."""
    keep = (sigma >= 0.0) & (sigma <= bound)
    alpha_raw = opacities * jnp.exp(-sigma)
    alpha = jnp.where(keep, jnp.minimum(alpha_raw, alpha_clamp), 0.0)
    return alpha, alpha_raw, keep
