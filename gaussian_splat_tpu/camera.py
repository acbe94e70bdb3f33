"""Camera model: intrinsics + world→camera extrinsics, plus lookat/perspective helpers.

Replaces the reference's uniform upload {viewProj, view, proj, viewportSize}
(/root/reference/src/instanced_splat_renderer.mm:456-469) and the matrix helpers in
/root/reference/src/trackball_camera.mm:136-163 (`makeLookAt`, `makePerspective`).

Convention: **OpenCV-style** camera space — +x right, +y down, +z forward, so a
point in front of the camera has z > 0. This differs from the reference's
OpenGL-style "looking down −z" convention (`trackball_camera.mm:136-148`, where the
shaders then use zFront = −z_view, `shaders/gaussian_splat.metal:125-131`); using
+z-forward directly avoids the sign flip the reference carries through its entire
shader chain, and matches gsplat-style rasterizer semantics which this framework's
gradients are validated against.

Pixel convention: a pixel (i, j) has its center at (j + 0.5, i + 0.5) in image
coordinates; `mean2d = (fx·x/z + cx, fy·y/z + cy)`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera. `viewmat` is the (4,4) world→camera transform (OpenCV axes).

    `width`/`height` are static Python ints (they determine array shapes under jit
    and are therefore aux data, not traced leaves).
    """

    viewmat: jax.Array  # (4, 4) float32, world -> camera
    fx: jax.Array  # focal length in pixels
    fy: jax.Array
    cx: jax.Array  # principal point in pixels
    cy: jax.Array
    width: int
    height: int

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        children = (self.viewmat, self.fx, self.fy, self.cx, self.cy)
        aux = (self.width, self.height)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        viewmat, fx, fy, cx, cy = children
        width, height = aux
        return cls(viewmat, fx, fy, cx, cy, width, height)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_fov(
        cls,
        viewmat,
        fov_y_deg: float,
        width: int,
        height: int,
    ) -> "Camera":
        """Vertical-FOV constructor, matching the reference's perspective setup
        (fov=45°, /root/reference/src/trackball_camera.h:33-37). The reference
        derives pixel focals from the projection matrix as
        `proj[1][1] * height/2` (/root/reference/shaders/gaussian_splat.metal:147-148);
        here fy = (H/2) / tan(fov_y/2) directly, which is the same quantity.
        """
        fov_y = math.radians(fov_y_deg)
        fy = 0.5 * height / math.tan(0.5 * fov_y)
        fx = fy  # square pixels
        return cls(
            viewmat=jnp.asarray(viewmat, jnp.float32),
            fx=jnp.float32(fx),
            fy=jnp.float32(fy),
            cx=jnp.float32(width / 2.0),
            cy=jnp.float32(height / 2.0),
            width=int(width),
            height=int(height),
        )

    @classmethod
    def from_lookat(
        cls,
        eye,
        target,
        up,
        fov_y_deg: float,
        width: int,
        height: int,
    ) -> "Camera":
        viewmat = look_at(eye, target, up)
        return cls.from_fov(viewmat, fov_y_deg, width, height)

    # -- derived quantities ------------------------------------------------
    @property
    def rotation(self) -> jax.Array:
        return self.viewmat[:3, :3]

    @property
    def translation(self) -> jax.Array:
        return self.viewmat[:3, 3]

    @property
    def position(self) -> jax.Array:
        """Camera center in world coordinates (−Rᵀ t)."""
        R = self.rotation
        t = self.translation
        return -jnp.matmul(R.T, t, precision=jax.lax.Precision.HIGHEST)

    def resized(self, width: int, height: int) -> "Camera":
        """Scale intrinsics to a new viewport, analogous to the reference's
        resize path (/root/reference/src/metal_renderer.mm:158-160)."""
        sx = width / self.width
        sy = height / self.height
        return Camera(
            viewmat=self.viewmat,
            fx=self.fx * sx,
            fy=self.fy * sy,
            cx=self.cx * sx,
            cy=self.cy * sy,
            width=int(width),
            height=int(height),
        )


def look_at(eye, target, up) -> jax.Array:
    """Build a world→camera matrix in the OpenCV convention (+z toward target).

    Counterpart of the reference's right-handed `makeLookAt`
    (/root/reference/src/trackball_camera.mm:136-148), with the forward axis
    negated so z is positive in front of the camera.
    """
    eye = jnp.asarray(eye, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)

    fwd = target - eye
    fwd = fwd / jnp.linalg.norm(fwd)
    right = jnp.cross(fwd, up)
    right = right / jnp.linalg.norm(right)
    down = jnp.cross(fwd, right)  # +y is down in OpenCV camera space

    R = jnp.stack([right, down, fwd], axis=0)  # (3,3) world->cam rotation
    t = -jnp.matmul(R, eye, precision=jax.lax.Precision.HIGHEST)
    viewmat = jnp.eye(4, dtype=jnp.float32)
    viewmat = viewmat.at[:3, :3].set(R)
    viewmat = viewmat.at[:3, 3].set(t)
    return viewmat


def orbit_camera(
    radius: float,
    azimuth_deg: float,
    elevation_deg: float,
    target=(0.0, 0.0, 0.0),
    fov_y_deg: float = 45.0,
    width: int = 1280,
    height: int = 720,
) -> Camera:
    """Convenience orbit constructor (the reference's startup pose is an orbit at
    (0,2,5) toward the origin, /root/reference/src/main.mm:55-58)."""
    az = math.radians(azimuth_deg)
    el = math.radians(elevation_deg)
    tx, ty, tz = target
    eye = (
        tx + radius * math.cos(el) * math.sin(az),
        ty + radius * math.sin(el),
        tz + radius * math.cos(el) * math.cos(az),
    )
    return Camera.from_lookat(eye, target, (0.0, 1.0, 0.0), fov_y_deg, width, height)
