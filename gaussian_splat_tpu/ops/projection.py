"""EWA 3D→2D Gaussian projection: quat→R, Σ=MMᵀ, perspective Jacobian, culling.

Re-derivation of the reference's vertex-shader math
(/root/reference/shaders/gaussian_splat.metal:55-196): fully vectorized jnp over
all N splats at once (no per-vertex shader), differentiable end-to-end so the
rasterizer's custom VJP composes with plain autodiff through this stage.

Math contract (with reference citations):
  * quaternion (wxyz, normalized) → rotation matrix: gaussian_splat.metal:55-65
  * Σ3D = (R·S)(R·S)ᵀ:                               gaussian_splat.metal:67-79
  * Σview = W·Σ3D·Wᵀ, W = viewmat[:3,:3]:            gaussian_splat.metal:137-144
  * perspective Jacobian J rows (fx/z, 0, −fx·x/z²), (0, fy/z, −fy·y/z²):
                                                      gaussian_splat.metal:151-154
  * 2×2 pixel covariance = J·Σview·Jᵀ + dilation·I:  gaussian_splat.metal:157-163
  * closed-form symmetric 2×2 eigenvalues, radius = 3√λmax:
                                                      gaussian_splat.metal:82-107,173-174
  * near cull:                                        gaussian_splat.metal:125-131

Deviations from the reference (documented per SURVEY §7): OpenCV +z-forward
camera (no zFront = −z flip), a 0.3 px covariance dilation instead of 1e-4 (the
gsplat anti-alias convention), and Jacobian-input clamping to 1.3× the frustum
(3DGS convention; the reference has no equivalent and lets off-screen splats
produce unstable Jacobians).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussian_splat_tpu.camera import Camera


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities. All shapes lead with N."""

    means2d: jax.Array  # (N, 2) pixel coordinates of the projected center
    conics: jax.Array  # (N, 3) upper-triangular inverse 2D covariance (A, B, C);
    #   the falloff is σ(d) = 0.5·(A·dx² + C·dy²) + B·dx·dy
    depths: jax.Array  # (N,) camera-space z (positive in front)
    radii: jax.Array  # (N,) int32 extent in pixels (0 ⇒ culled)
    valid: jax.Array  # (N,) bool — survives near/frustum/degeneracy culling
    cov2d: jax.Array  # (N, 3) the (a, b, c) 2D covariance (pre-inverse), for debug
    compensation: jax.Array = None  # (N,) √(det Σ / det(Σ+dilation·I)) — the
    #   gsplat "antialiased" opacity factor (1.0 when antialiasing is off)
    extents: jax.Array = None  # (N, 2) f32 per-axis billboard half-widths —
    #   the EXACT axis-aligned bounding box of the {σ ≤ σ_max} ellipse:
    #   rx = √(2·σ_max·cov_a), ry = √(2·σ_max·cov_c). For anisotropic or
    #   tilted splats this is strictly tighter than the circular radius
    #   √(2·σ_max·λmax) the reference billboards use
    #   (/root/reference/shaders/gaussian_splat.metal:173-189), with NO
    #   rendered-output change: pixels outside it provably fail every
    #   backend's σ/α-skip test. Falls back to `radii` when None.


def quat_to_rotmat(quats: jax.Array) -> jax.Array:
    """(…,4) wxyz quaternions (not necessarily unit) → (…,3,3) rotations.

    Same algebra as `quaternionToMatrix` (gaussian_splat.metal:55-65) but
    normalizing here (the reference normalizes too) and batched.
    """
    q = quats / jnp.linalg.norm(quats, axis=-1, keepdims=True).clip(1e-8)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                axis=-1,
            ),
        ],
        axis=-2,
    )


def compute_cov3d(quats: jax.Array, scales: jax.Array) -> jax.Array:
    """Σ3D = (R·S)(R·S)ᵀ, returned as full (…,3,3) (gaussian_splat.metal:67-79)."""
    R = quat_to_rotmat(quats)
    M = R * scales[..., None, :]  # R @ diag(scales)
    return jnp.matmul(M, jnp.swapaxes(M, -1, -2), precision=jax.lax.Precision.HIGHEST)


def _rotmat_rows(quats: jax.Array):
    """Unit-quaternion rotation as nine (N,) component arrays (row-major).

    Same algebra as quat_to_rotmat but without materializing (N,3,3): the
    elementwise components fuse into the surrounding projection arithmetic
    instead of running as batched 3×3 matmuls (which would also need f32
    precision pinned against TF32 on the GPU).
    """
    q = quats / jnp.linalg.norm(quats, axis=-1, keepdims=True).clip(1e-8)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def _cov_view_components(quats, scales, W):
    """Upper-triangular components of Σview = (W·R)·S²·(W·R)ᵀ, elementwise.

    Returns (s00, s01, s02, s11, s12, s22) as (N,) arrays. W is the (3,3)
    camera rotation; its entries are scalars, so every operation here is an
    (N,)-elementwise FMA that XLA fuses into one pass — replacing the
    batched-matmul chain (compute_cov3d + einsum).
    """
    r = _rotmat_rows(quats)  # row-major 3×3 components
    # U = W @ R, unrolled: U[i][j] = Σ_k W[i,k]·R[k,j]
    U = [
        [
            W[i, 0] * r[0 + j] + W[i, 1] * r[3 + j] + W[i, 2] * r[6 + j]
            for j in range(3)
        ]
        for i in range(3)
    ]
    s2 = scales * scales
    s0, s1, s2_ = s2[:, 0], s2[:, 1], s2[:, 2]

    def sv(i, j):
        return U[i][0] * U[j][0] * s0 + U[i][1] * U[j][1] * s1 + U[i][2] * U[j][2] * s2_

    return sv(0, 0), sv(0, 1), sv(0, 2), sv(1, 1), sv(1, 2), sv(2, 2)


def project_gaussians(
    means: jax.Array,  # (N, 3) world positions
    quats: jax.Array,  # (N, 4) wxyz
    scales: jax.Array,  # (N, 3) activated (positive) scales
    camera: Camera,
    *,
    near_plane: float = 0.01,
    cov2d_dilation: float = 0.3,
    sigma_extent: float = 3.0,
    opacities: jax.Array = None,  # (N,) activated opacities (optional)
    alpha_skip: float = None,
) -> ProjectedGaussians:
    """Project all gaussians to screen space and cull.

    Vectorized counterpart of the per-instance vertex shader
    (gaussian_splat.metal:109-196). Differentiable w.r.t. means/quats/scales.

    When `opacities` and `alpha_skip` are given, the billboard extent is
    opacity-aware: a splat's contribution α = op·exp(−σ) falls below
    `alpha_skip` — and is therefore zeroed by EVERY backend's α-skip test —
    once σ > ln(op/alpha_skip), so the radius shrinks to
    √(2·min(σ_cutoff, ln(op/alpha_skip))·λmax) with NO change in rendered
    output. This bounds the tile-rect crop error (a splat that fits its full
    opacity-aware rect loses nothing) and cuts pair counts for dim splats;
    splats with op ≤ alpha_skip cull outright. The reference instead evaluates
    a fixed 3σ billboard and discards low contributions per fragment
    (gaussian_splat_50layer.metal:131-132,156-157).
    """
    W = camera.rotation  # (3,3)
    t = camera.translation  # (3,)
    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    width, height = camera.width, camera.height

    # --- view transform + near cull (gaussian_splat.metal:119-131) ---------
    # f32 products: on the GPU a DEFAULT-precision dot runs in TF32 (~1e-3)
    p_view = jnp.matmul(means, W.T, precision=jax.lax.Precision.HIGHEST) + t  # (N,3)
    x, y, z = p_view[:, 0], p_view[:, 1], p_view[:, 2]
    in_front = z > near_plane
    zs = jnp.where(in_front, z, 1.0)  # safe denominator for culled splats

    # --- 3D covariance in view space (gaussian_splat.metal:137-144) --------
    # Elementwise (W·R)·S²·(W·R)ᵀ — see _cov_view_components for why not
    # compute_cov3d + einsum
    s00, s01, s02, s11, s12, s22 = _cov_view_components(quats, scales, W)

    # --- perspective Jacobian with frustum-clamped inputs ------------------
    # (gaussian_splat.metal:147-154; the 1.3× clamp is the 3DGS stabilization)
    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    tx = jnp.clip(x / zs, -lim_x, lim_x) * zs
    ty = jnp.clip(y / zs, -lim_y, lim_y) * zs

    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    # J = [[fx/z, 0, -fx·tx/z²], [0, fy/z, -fy·ty/z²]]  (2,3) per gaussian
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    # cov2d = J · Σview · Jᵀ, expanded (avoids materializing (N,2,3) J):
    # row0 of J·Σ = j00·Σ[0,:] + j02·Σ[2,:]; row1 = j11·Σ[1,:] + j12·Σ[2,:]
    a = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    b = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)

    # diagonal low-pass lift (gaussian_splat.metal:161-163 uses 1e-4; we use the
    # gsplat 0.3 px convention via cov2d_dilation)
    det_raw = a * c - b * b
    a = a + cov2d_dilation
    c = c + cov2d_dilation

    # --- conic (inverse 2D covariance) -------------------------------------
    det = a * c - b * b
    # gsplat "antialiased" opacity compensation: scales α by the mass ratio of
    # the pre/post-dilation gaussians so tiny splats fade instead of aliasing
    compensation = jnp.sqrt(jnp.maximum(det_raw, 0.0) / jnp.maximum(det, 1e-12))
    det_ok = det > 1e-10
    det_safe = jnp.where(det_ok, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = jnp.stack([c * inv_det, -b * inv_det, a * inv_det], axis=-1)

    # --- extent: closed-form symmetric 2×2 eigenvalues ---------------------
    # (eigenSym2x2, gaussian_splat.metal:82-107; λ clamp mirrors :169-170)
    mid = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(mid * mid - det_safe, 0.1))
    lambda_max = mid + disc
    # σ ≤ σ_max on the contributing set; radius = √(2·σ_max·λmax) bounds its
    # ellipse. With σ_max = σ_cutoff (= extent²/2) this is the classic 3σ
    # radius; the opacity-aware min() below only removes provably-zero pixels.
    sigma_max = 0.5 * sigma_extent * sigma_extent
    if opacities is not None and alpha_skip is not None and alpha_skip > 0.0:
        sigma_max = jnp.minimum(
            sigma_max,
            jnp.log(jnp.maximum(opacities, 1e-30)) - jnp.log(alpha_skip),
        )
    sigma_pos = jnp.maximum(sigma_max, 0.0)
    radius_f = jnp.sqrt(2.0 * sigma_pos * jnp.maximum(lambda_max, 0.0))
    radii = jnp.ceil(radius_f).astype(jnp.int32)
    # exact ellipse AABB: the level set {σ ≤ σ_max} of conic = cov⁻¹ spans
    # ±√(2·σ_max·cov_xx) in x and ±√(2·σ_max·cov_yy) in y — tighter than the
    # λmax circle for anisotropic/tilted splats, identical output (pixels
    # beyond it have σ > σ_max ⇒ α < alpha_skip in every backend)
    rx = jnp.sqrt(2.0 * sigma_pos * jnp.maximum(a, 0.0))
    ry = jnp.sqrt(2.0 * sigma_pos * jnp.maximum(c, 0.0))

    # --- projected center (pixels) -----------------------------------------
    mean_x = fx * x * inv_z + cx
    mean_y = fy * y * inv_z + cy
    means2d = jnp.stack([mean_x, mean_y], axis=-1)

    # --- frustum cull: tile rect must intersect the screen -----------------
    on_screen = (
        (mean_x + rx > 0)
        & (mean_x - rx < width)
        & (mean_y + ry > 0)
        & (mean_y - ry < height)
    )
    valid = in_front & det_ok & on_screen & (radii > 0)
    radii = jnp.where(valid, radii, 0)
    extents = jnp.stack(
        [jnp.where(valid, rx, 0.0), jnp.where(valid, ry, 0.0)], axis=-1
    )

    return ProjectedGaussians(
        means2d=means2d,
        conics=conic,
        depths=z,
        radii=radii,
        valid=valid,
        cov2d=jnp.stack([a, b, c], axis=-1),
        compensation=compensation,
        extents=extents,
    )


def view_directions(means: jax.Array, camera: Camera) -> jax.Array:
    """Unit directions camera-center → gaussian, for SH evaluation."""
    d = means - camera.position
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True).clip(1e-8)
