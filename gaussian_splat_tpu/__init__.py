"""gaussian_splat_tpu — a differentiable 3D Gaussian splatting framework in JAX.

A from-scratch JAX / Pallas / shard_map implementation of the capabilities of the
reference viewer (nshelton/gaussian_splat): PLY scene ingestion, spherical-harmonic
color evaluation, EWA 3D→2D covariance projection, frustum culling, tile binning
with per-tile depth sort, and alpha-compositing rasterization — extended (per the
project north star) with analytic gradients, fused Pallas forward+backward tile
kernels, and multi-chip sharding over a `jax.sharding.Mesh`.

The reference (Metal/Obj-C++, forward-only) defines the *data contract*
(/root/reference/src/ply_loader.cpp), the *math contract*
(/root/reference/shaders/gaussian_splat.metal:109-196) and the *product contract*
(interactive viewer, /root/reference/src/main.mm). The architecture here is
tile binning + segmented sort + fused per-tile compositing kernels (Pallas,
Triton route on the GPU) instead of hardware rasterization + per-pixel OIT
lists.
"""

from gaussian_splat_tpu.camera import Camera
from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel
from gaussian_splat_tpu.ops.render import binning_stats, calibrate_render_config, render

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "RenderConfig",
    "GaussianModel",
    "render",
    "calibrate_render_config",
    "binning_stats",
    "__version__",
]
