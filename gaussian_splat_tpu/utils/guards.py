"""Numerics guards: checkify'd rendering + NaN sweeps (SURVEY §5, race
detection/sanitizers).

The raster kernels use no atomics (binning is a sort, compositing a prefix
product, each backward program writes only its own pairs' rows), so the
sanitizer story is (a) determinism tests (tests/test_gpu_hardware.py) and (b)
this module: run the differentiable
jnp pipeline under `jax.experimental.checkify` to trap NaN/Inf and
out-of-bounds indexing that silently clamp in normal XLA execution, and sweep
pytrees for non-finite leaves. Use it when a training run misbehaves — it is
the debugging analogue of the reference compiling shaders with fast-math off
(/root/reference/src/instanced_splat_renderer.mm:85-93)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


def checked_render(model, camera, config=None) -> jax.Array:
    """Render on the jnp_tile path under checkify's full check set
    (NaN/Inf + out-of-bounds + div-by-zero). Raises on the first violation,
    with a traceback into the failing op. Returns the (H, W, 3) image.

    The Pallas backend cannot run under checkify; jnp_tile shares its exact
    semantics (same binning, same α math), so numeric pathologies reproduce.
    """
    from jax.experimental import checkify

    from gaussian_splat_tpu.config import RenderConfig
    from gaussian_splat_tpu.ops.render import render

    config = config or RenderConfig()
    cfg = dataclasses.replace(config, backend="jnp_tile")
    f = checkify.checkify(
        lambda m: render(m, camera, cfg).image, errors=checkify.all_checks
    )
    err, img = jax.jit(f)(model)
    err.throw()
    return img


def checked_grads(model, camera, config=None):
    """checkify'd gradient pass (mean-image loss). Raises on NaN/Inf anywhere
    in the backward chain; returns the gradient pytree."""
    from jax.experimental import checkify

    from gaussian_splat_tpu.config import RenderConfig
    from gaussian_splat_tpu.ops.render import render

    config = config or RenderConfig()
    cfg = dataclasses.replace(config, backend="jnp_tile")

    def loss(m):
        return jnp.mean(render(m, camera, cfg).image ** 2)

    f = checkify.checkify(jax.grad(loss), errors=checkify.float_checks)
    err, grads = jax.jit(f)(model)
    err.throw()
    return grads


def find_nonfinite(tree, prefix: str = "") -> Tuple[str, ...]:
    """Names of pytree leaves containing NaN/Inf (empty tuple = all finite)."""
    bad = []
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            if not bool(jnp.all(jnp.isfinite(leaf))):
                bad.append(prefix + jax.tree_util.keystr(path))
    return tuple(bad)
