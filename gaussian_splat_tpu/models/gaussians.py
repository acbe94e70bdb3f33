"""GaussianModel — the trainable splat parameter pytree.

Analogue of the reference's `SplatInstance` array
(/root/reference/src/instanced_splat_renderer.h:6-11: rotation[4] wxyz, scale[3],
position[3], color[4]) re-designed for training: parameters are stored RAW
(log-scales, opacity logits, SH coefficients) and activated inside the forward
pass, unlike the reference which irreversibly bakes `opacity = sigmoid(raw)`,
`scale = exp(raw)` and SH-DC→RGB at load time
(/root/reference/src/ply_loader.cpp:116-119,133-139 — SURVEY §7 flags this as a
quirk not to replicate).

As a registered dataclass the model is a JAX pytree: it jits, vmaps, shards
with `NamedSharding` over the leading N axis, and optimizes with optax
directly; `.replace(**leaves)` returns an updated copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from gaussian_splat_tpu.ops import sh as sh_ops


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GaussianModel:
    means: jax.Array  # (N, 3) world positions
    quats: jax.Array  # (N, 4) wxyz rotations (normalized in forward)
    log_scales: jax.Array  # (N, 3) raw; scale = exp(log_scale)  [ply_loader.cpp:119]
    opacity_logits: jax.Array  # (N,) raw; opacity = sigmoid(logit) [ply_loader.cpp:116-117]
    sh: jax.Array  # (N, K, 3) SH coefficients, K = (degree+1)², band-ordered

    def replace(self, **leaves) -> "GaussianModel":
        return dataclasses.replace(self, **leaves)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1

    # -- activations --------------------------------------------------------
    @property
    def scales(self) -> jax.Array:
        return jnp.exp(self.log_scales)

    @property
    def opacities(self) -> jax.Array:
        return jax.nn.sigmoid(self.opacity_logits)

    # -- constructors -------------------------------------------------------
    @classmethod
    def create(
        cls,
        means,
        quats,
        log_scales,
        opacity_logits,
        sh,
    ) -> "GaussianModel":
        return cls(
            means=jnp.asarray(means, jnp.float32),
            quats=jnp.asarray(quats, jnp.float32),
            log_scales=jnp.asarray(log_scales, jnp.float32),
            opacity_logits=jnp.asarray(opacity_logits, jnp.float32),
            sh=jnp.asarray(sh, jnp.float32),
        )

    @classmethod
    def random(
        cls,
        key: jax.Array,
        n: int,
        sh_degree: int = 0,
        extent: float = 1.0,
        scale_range=(0.01, 0.1),
        isotropic: bool = False,
    ) -> "GaussianModel":
        """Random scene generator for tests/benchmarks (the framework's synthetic
        stand-in for the reference's hardcoded truck PLY, main.mm:69-70)."""
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        means = jax.random.uniform(k1, (n, 3), minval=-extent, maxval=extent)
        if isotropic:
            quats = jnp.tile(jnp.array([1.0, 0.0, 0.0, 0.0]), (n, 1))
            ls = jax.random.uniform(
                k2,
                (n, 1),
                minval=jnp.log(scale_range[0]),
                maxval=jnp.log(scale_range[1]),
            )
            log_scales = jnp.tile(ls, (1, 3))
        else:
            quats = jax.random.normal(k2, (n, 4))
            quats = quats / jnp.linalg.norm(quats, axis=-1, keepdims=True)
            log_scales = jax.random.uniform(
                k3,
                (n, 3),
                minval=jnp.log(scale_range[0]),
                maxval=jnp.log(scale_range[1]),
            )
        opacity_logits = jax.random.uniform(k4, (n,), minval=-1.0, maxval=3.0)
        K = sh_ops.num_sh_bases(sh_degree)
        sh = jnp.zeros((n, K, 3))
        dc = sh_ops.rgb_to_sh_dc(jax.random.uniform(k5, (n, 3), minval=0.1, maxval=0.9))
        sh = sh.at[:, 0, :].set(dc)
        if K > 1:
            rest_key = jax.random.fold_in(k5, 1)
            sh = sh.at[:, 1:, :].set(
                0.1 * jax.random.normal(rest_key, (n, K - 1, 3))
            )
        return cls.create(means, quats, log_scales, opacity_logits, sh)

    # -- filters ------------------------------------------------------------
    def lod(self, fraction: float) -> "GaussianModel":
        """Keep the `fraction` highest-impact splats (impact ≈ opacity ×
        max-scale², the view-independent part of expected screen coverage).

        Level-of-detail subset for interactive viewing: the viewer renders
        this while the camera is being dragged and the full model when idle
        (the reference has no equivalent — it leans on the GPU rasterizer's
        speed; here the binning/gather stages scale with N, so a smaller
        interaction model renders proportionally faster). Host-side compaction,
        load/init time only."""
        import numpy as np

        n = self.num_gaussians
        k = max(1, min(n, int(n * fraction)))
        op = 1.0 / (1.0 + np.exp(-np.asarray(self.opacity_logits)))
        smax = np.exp(np.asarray(self.log_scales)).max(axis=-1)
        impact = op * smax * smax
        keep = np.argsort(impact)[::-1][:k]
        keep.sort()  # preserve original relative order
        return self._take_host(keep)

    def lod_pair_budget(
        self, cost_fraction: float, costs=None, values=None,
        order: str = "value",
    ) -> "GaussianModel":
        """Pair-budget LoD: keep the subset whose predicted tile-PAIR cost is
        ≤ `cost_fraction` of the full model's.

        `lod(fraction)` bounds N, but frame time scales with tile pairs (the
        pair gather, pair sort, and raster kernel are all per-pair —
        docs/ARCHITECTURE.md "Known costs"), and the impact ranking keeps
        exactly the splats that touch the most tiles, so `lod(0.25)` can
        retain ~40% of the pairs. This selection spends a *pair* budget
        instead: splats are admitted in decreasing contribution-per-pair
        order (greedy knapsack by value density) until `cost_fraction` of
        the total predicted cost is spent — bounding the degraded frame's
        time directly.

        `costs`: optional (N,) per-splat pair costs — the K-capped tile-rect
        areas from `ops.render.measure_pair_costs(model, camera, config)` at
        a representative pose (the viewer calibrates this at its start
        pose); splats culled there (cost 0) are admitted last. Without it, a
        view-independent proxy `1 + β·smax²` is used (tile count scales with
        screen area ∝ world area at fixed view; β normalized so the average
        splat's area term costs one pair). Host-side, load/init time only.

        `values`: optional (N,) per-splat visual worth, e.g. the MEASURED
        occlusion-aware contribution from
        `ops.render.measure_splat_contributions` (one differentiable render).
        Default: impact = `opacity × world area` — `lod()`'s ranking, the
        measured winner (see `order` below).

        `order`: `"value"` (default) admits splats in decreasing value order
        and stops when the budget is spent; `"density"` is the classic
        knapsack value/cost ordering. Density ordering divides by tile cost,
        which INVERTS the ranking on collectively-occluding stacks of
        low-opacity big splats (fog) — each is individually poor
        value-per-pair but jointly they are the image. Measured at the same
        ~48% pair spend on the procedural 2.5M fog-tailed scene
        (docs/REALISTIC_SCENE.md selector table): impact-valued
        value-ordered 28.2 dB PSNR vs the full frame (lod(0.25) itself:
        29.7); density-ordered 4.1 dB with heuristic values and 13.0 dB
        even with measured contributions (marginal gradients cannot predict
        the JOINT removal of an occluding stack); at a 10% budget the
        shipped default drags at 20.7 FPS / 15.5 dB where lod(0.25) ran
        4.2 FPS."""
        import numpy as np

        n = self.num_gaussians
        op = 1.0 / (1.0 + np.exp(-np.asarray(self.opacity_logits)))
        smax = np.exp(np.asarray(self.log_scales)).max(axis=-1)
        area = smax * smax
        # Default value = the SAME impact ranking as lod(): opacity × WORLD
        # area, uncapped. Not opacity × measured screen cost: the K-cap
        # clamps huge splats' tile rects, undervaluing exactly the fog-tail
        # splats whose joint occlusion carries the image (measured: 3.9 dB
        # vs 29.7 dB at the same 48% pair spend — see the docstring table).
        value = op * area if values is None else np.asarray(values, np.float64)
        if costs is None:
            beta = n / max(float(area.sum()), 1e-12)
            cost = 1.0 + beta * area
        else:
            cost = np.asarray(costs, np.float64)
            value = value * (cost > 0)  # splats culled at the pose sort last
            cost = np.maximum(cost, 1.0)
        key = value / cost if order == "density" else value
        idx = np.argsort(-key, kind="stable")
        csum = np.cumsum(cost[idx])
        k = int(np.searchsorted(csum, cost_fraction * csum[-1], side="right"))
        keep = idx[: max(1, min(n, k))]
        keep.sort()  # preserve original relative order
        return self._take_host(keep)

    def _take_host(self, keep) -> "GaussianModel":
        import numpy as np

        return GaussianModel(
            means=jnp.asarray(np.asarray(self.means)[keep]),
            quats=jnp.asarray(np.asarray(self.quats)[keep]),
            log_scales=jnp.asarray(np.asarray(self.log_scales)[keep]),
            opacity_logits=jnp.asarray(np.asarray(self.opacity_logits)[keep]),
            sh=jnp.asarray(np.asarray(self.sh)[keep]),
        )

    def aabb_filter(self, radius: float) -> "GaussianModel":
        """Keep splats with |x|,|y|,|z| < radius — optional scene-load clip
        mirroring /root/reference/src/instanced_splat_renderer.mm:383-387.
        Host-side (numpy) boolean compaction: not jittable, for load time only."""
        import numpy as np

        m = np.asarray(self.means)
        keep = np.all(np.abs(m) < radius, axis=-1)
        return GaussianModel(
            means=jnp.asarray(m[keep]),
            quats=jnp.asarray(np.asarray(self.quats)[keep]),
            log_scales=jnp.asarray(np.asarray(self.log_scales)[keep]),
            opacity_logits=jnp.asarray(np.asarray(self.opacity_logits)[keep]),
            sh=jnp.asarray(np.asarray(self.sh)[keep]),
        )
