"""Adaptive density control (3DGS densify/clone/split/prune) — fixed-N, static shapes.

The original 3DGS training loop grows and shrinks the gaussian set dynamically;
on a shape-static compiler that would retrigger compilation every densify step.
This implements ADC as a **slot redistribution** at constant N, fully jittable:

  * every gaussian carries a densify score — an EMA of its screen-space
    positional gradient magnitude (the 3DGS criterion);
  * a fixed fraction of slots (the lowest keep-priority: low opacity OR culled)
    are VICTIMS; the same number of top-scoring gaussians are DONORS;
  * each victim slot is respawned as a *split* of its donor: positioned at the
    donor's mean plus a scale-sized jitter, with donor and child scales divided
    by 1.6 and opacities shared (3DGS split rule); low-gradient donors instead
    behave like *clones* (jitter ≈ 0 relative to tiny scales).
  * periodic opacity reset clamps all opacities below a ceiling, as in 3DGS.

Optimizer moments for respawned slots are zeroed via `reset_opt_rows`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gaussian_splat_tpu.models.gaussians import GaussianModel


class DensifyState(NamedTuple):
    grad_score: jax.Array  # (N,) EMA of the screen-space positional gradient
    #   ‖∂L/∂means2d‖ (pixels) — the 3DGS criterion; the trainer obtains it by
    #   differentiating w.r.t. a zero screen offset (render(screen_offset=...))
    ema_beta: float = 0.9


def init_densify_state(n: int) -> DensifyState:
    return DensifyState(grad_score=jnp.zeros((n,)))


def update_scores(state: DensifyState, grads_means2d: jax.Array) -> DensifyState:
    """Accumulate the screen-space positional-gradient EMA (every train step)."""
    g = jnp.linalg.norm(grads_means2d, axis=-1)
    score = state.ema_beta * state.grad_score + (1.0 - state.ema_beta) * g
    return state._replace(grad_score=score)


def densify_step(
    model: GaussianModel,
    state: DensifyState,
    key: jax.Array,
    *,
    victim_fraction: float = 0.05,
    opacity_floor: float = 0.005,
    split_scale: float = 1.6,
) -> Tuple[GaussianModel, DensifyState, jax.Array]:
    """One redistribution. Returns (model, state, respawned_mask (N,) bool)."""
    n = model.num_gaussians
    v = max(1, int(n * victim_fraction))

    opacity = model.opacities
    # keep-priority: low opacity first to die (3DGS prune criterion)
    _, victim_idx = jax.lax.top_k(-opacity, v)
    # donors: highest gradient score, excluding victims
    score = state.grad_score.at[victim_idx].set(-jnp.inf)
    _, donor_idx = jax.lax.top_k(score, v)

    donor_scales = jnp.exp(model.log_scales[donor_idx])  # (v, 3)
    jitter = donor_scales * jax.random.normal(key, (v, 3))
    # rotate jitter into the donor's frame (scales are axis-aligned pre-rotation)
    from gaussian_splat_tpu.ops.projection import quat_to_rotmat

    R = quat_to_rotmat(model.quats[donor_idx])
    offset = jnp.einsum("vij,vj->vi", R, jitter, precision=jax.lax.Precision.HIGHEST)

    new_means = model.means[donor_idx] + offset
    new_log_scales = model.log_scales[donor_idx] - jnp.log(split_scale)

    means = model.means.at[victim_idx].set(new_means)
    log_scales = model.log_scales.at[victim_idx].set(new_log_scales)
    # the donor also shrinks (split semantics)
    log_scales = log_scales.at[donor_idx].set(new_log_scales)
    quats = model.quats.at[victim_idx].set(model.quats[donor_idx])
    opacity_logits = model.opacity_logits.at[victim_idx].set(
        model.opacity_logits[donor_idx]
    )
    sh = model.sh.at[victim_idx].set(model.sh[donor_idx])

    respawned = jnp.zeros((n,), bool).at[victim_idx].set(True)
    respawned = respawned.at[donor_idx].set(True)

    new_model = GaussianModel(
        means=means,
        quats=quats,
        log_scales=log_scales,
        opacity_logits=opacity_logits,
        sh=sh,
    )
    new_state = state._replace(
        grad_score=state.grad_score.at[victim_idx].set(0.0).at[donor_idx].set(0.0)
    )
    return new_model, new_state, respawned


def reset_opacity(model: GaussianModel, ceiling: float = 0.01) -> GaussianModel:
    """Clamp opacities to ≤ ceiling (3DGS periodic opacity reset)."""
    cap = jnp.log(ceiling) - jnp.log1p(-ceiling)  # logit(ceiling)
    return model.replace(
        opacity_logits=jnp.minimum(model.opacity_logits, cap)
    )


def reset_opt_rows(opt_state, mask: jax.Array):
    """Zero optimizer moments for respawned slots: any state leaf whose leading
    dimension matches the mask gets its masked rows zeroed."""
    n = mask.shape[0]

    def fix(leaf):
        if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] == n:
            shaped = mask.reshape((n,) + (1,) * (leaf.ndim - 1))
            return jnp.where(shaped, jnp.zeros_like(leaf), leaf)
        return leaf

    return jax.tree_util.tree_map(fix, opt_state)
