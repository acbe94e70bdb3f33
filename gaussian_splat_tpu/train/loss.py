"""Photometric losses: L1 + SSIM (the 3DGS training objective).

The reference has no training at all (forward-only viewer); this implements the
standard 3DGS loss  L = (1−λ)·L1 + λ·(1−SSIM)  with λ=0.2, against which the
framework's analytic gradients are exercised end-to-end.

SSIM is the 11×11 Gaussian-windowed variant. The window is separable, so the
filter is two 1D passes of shifted fused-multiply-adds on the (H, W, C)
image — plain elementwise XLA that fuses cleanly and, under SPMD sharding of
the image, gets its halo exchanges inserted automatically.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=8)
def _gaussian_window_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


def _filter2d(img: jax.Array, window1d: np.ndarray) -> jax.Array:
    """Separable Gaussian filter on (H, W, C), SAME zero padding: two 1D
    passes of `size` shifted multiply-adds each (slice-of-pad, no conv)."""
    size = int(window1d.shape[0])
    pad = size // 2
    h, w_, _ = img.shape

    def pass_along(x, axis, n):
        widths = [(0, 0)] * 3
        widths[axis] = (pad, pad)
        xp = jnp.pad(x, widths)
        acc = None
        for k in range(size):
            term = float(window1d[k]) * jax.lax.dynamic_slice_in_dim(
                xp, k, n, axis
            )
            acc = term if acc is None else acc + term
        return acc

    return pass_along(pass_along(img, 0, h), 1, w_)


def ssim(a: jax.Array, b: jax.Array, window_size: int = 11) -> jax.Array:
    """Mean SSIM over an (H, W, C) image pair, data range 1.0."""
    w = _gaussian_window_1d(window_size)
    c1 = 0.01**2
    c2 = 0.03**2

    mu_a = _filter2d(a, w)
    mu_b = _filter2d(b, w)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_aa = _filter2d(a * a, w) - mu_aa
    sigma_bb = _filter2d(b * b, w) - mu_bb
    sigma_ab = _filter2d(a * b, w) - mu_ab

    s = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2)
    )
    return jnp.mean(s)


def l1(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.mean(jnp.abs(a - b))


def photometric_loss(
    pred: jax.Array, target: jax.Array, ssim_weight: float = 0.2
) -> jax.Array:
    """(1−λ)·L1 + λ·(1−SSIM), the 3DGS objective."""
    if ssim_weight == 0.0:
        return l1(pred, target)
    return (1.0 - ssim_weight) * l1(pred, target) + ssim_weight * (
        1.0 - ssim(pred, target)
    )
