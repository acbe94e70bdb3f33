"""Pallas tile kernels (Triton route, interpret mode on the CPU) vs the oracle:
forward images and custom-VJP gradients allclose. On the GPU the same kernels
compile through Triton; `tests/test_gpu_hardware.py` and `chip_smoke.py`
exercise that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splat_tpu.camera import Camera
from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel
from gaussian_splat_tpu.ops.render import render


def _setup(n=120, width=96, height=64, seed=0, sh_degree=1):
    cam = Camera.from_lookat(
        (0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height
    )
    model = GaussianModel.random(
        jax.random.PRNGKey(seed), n, sh_degree=sh_degree, extent=1.2,
        scale_range=(0.02, 0.1),
    )
    return cam, model


REF = RenderConfig(backend="reference")
PAL = RenderConfig(backend="pallas")


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_oracle(seed):
    cam, model = _setup(seed=seed)
    img_ref = render(model, cam, REF).image
    img_pal = render(model, cam, PAL).image
    np.testing.assert_allclose(
        np.asarray(img_pal), np.asarray(img_ref), atol=3e-5, rtol=1e-4
    )


def test_alpha_matches_oracle():
    cam, model = _setup(seed=2)
    np.testing.assert_allclose(
        np.asarray(render(model, cam, PAL).alpha),
        np.asarray(render(model, cam, REF).alpha),
        atol=3e-5,
    )


def test_gradients_match_oracle():
    cam, model = _setup(n=60, width=64, height=48, seed=3)
    target = jax.random.uniform(jax.random.PRNGKey(99), (48, 64, 3))

    def loss(m, cfg):
        return jnp.mean((render(m, cam, cfg).image - target) ** 2)

    g_ref = jax.grad(lambda m: loss(m, REF))(model)
    g_pal = jax.grad(lambda m: loss(m, PAL))(model)

    for name in ["means", "quats", "log_scales", "opacity_logits", "sh"]:
        a = np.asarray(getattr(g_ref, name))
        b = np.asarray(getattr(g_pal, name))
        assert np.all(np.isfinite(b)), name
        np.testing.assert_allclose(b, a, atol=5e-6, rtol=3e-3, err_msg=name)


def test_empty_tiles_and_background():
    """Scene confined to one corner: most tiles have zero pairs."""
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 128, 96)
    model = GaussianModel.create(
        means=[[1.2, 0.9, 0.0]],
        quats=[[1.0, 0.0, 0.0, 0.0]],
        log_scales=[[np.log(0.08)] * 3],
        opacity_logits=[2.0],
        sh=[[[1.0, 0.5, 0.2]]],
    )
    cfg_r = RenderConfig(backend="reference", background=(0.3, 0.1, 0.6))
    cfg_p = RenderConfig(backend="pallas", background=(0.3, 0.1, 0.6))
    np.testing.assert_allclose(
        np.asarray(render(model, cam, cfg_p).image),
        np.asarray(render(model, cam, cfg_r).image),
        atol=3e-5,
    )


def test_multi_chunk_segments():
    """Deep stacks: many gaussians in the same tiles force long segments
    (many saturation-check intervals and backward blocks)."""
    n = 200  # all land in roughly the same tiles
    key = jax.random.PRNGKey(5)
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 64, 64)
    means = 0.05 * jax.random.normal(key, (n, 3))
    model = GaussianModel.create(
        means=means,
        quats=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        log_scales=np.full((n, 3), np.log(0.02)),
        opacity_logits=np.full((n,), -2.0),  # low opacity → deep stacks, no saturation
        sh=np.random.RandomState(0).uniform(-0.5, 1.5, (n, 1, 3)),
    )
    img_ref = render(model, cam, REF).image
    img_pal = render(model, cam, PAL).image
    np.testing.assert_allclose(
        np.asarray(img_pal), np.asarray(img_ref), atol=5e-5, rtol=1e-4
    )

    # gradient path through multi-chunk backward
    def loss(m):
        return jnp.mean(render(m, cam, PAL).image)

    g = jax.grad(loss)(model)
    g_ref = jax.grad(lambda m: jnp.mean(render(m, cam, REF).image))(model)
    np.testing.assert_allclose(
        np.asarray(g.means), np.asarray(g_ref.means), atol=1e-5, rtol=3e-3
    )


def test_saturated_early_exit_stays_close():
    """Opaque near splat saturates T; far splats must not contribute; the
    early-exit path deviates at most trans_eps from exact."""
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 64, 64)
    n = 150
    rs = np.random.RandomState(1)
    means = np.concatenate(
        [[[0.0, 0.0, -1.0]], 0.1 * rs.randn(n - 1, 3) + [[0, 0, 1.0]]]
    )
    model = GaussianModel.create(
        means=means,
        quats=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        log_scales=np.full((n, 3), np.log(0.3)),
        opacity_logits=np.concatenate([[12.0], np.full(n - 1, 2.0)]),
        sh=rs.uniform(-0.5, 1.5, (n, 1, 3)),
    )
    img_ref = render(model, cam, REF).image
    img_pal = render(model, cam, PAL).image
    np.testing.assert_allclose(
        np.asarray(img_pal), np.asarray(img_ref), atol=1e-4, rtol=1e-3
    )


def test_jit_wraps_cleanly():
    cam, model = _setup(n=40, width=48, height=48, seed=6)
    fn = jax.jit(lambda m: render(m, cam, PAL).image)
    a = np.asarray(fn(model))
    b = np.asarray(fn(model))
    assert np.array_equal(a, b)
    assert np.all(np.isfinite(a))


def test_depth_map_matches_oracle():
    """Expected-depth channel agrees across backends; nearer scenes read lower."""
    cam, model = _setup(n=80, width=64, height=48, seed=9)
    out_ref = render(model, cam, REF)
    out_pal = render(model, cam, PAL)
    np.testing.assert_allclose(
        np.asarray(out_pal.depth), np.asarray(out_ref.depth), atol=2e-4, rtol=1e-4
    )
    # depth is positive where alpha is significant, near the scene distance (~4)
    a = np.asarray(out_ref.alpha)
    d = np.asarray(out_ref.depth)
    hit = a > 0.5
    if hit.any():
        mean_depth = (d[hit] / a[hit]).mean()
        assert 2.0 < mean_depth < 6.0

    # depth gradients flow (depth supervision works)
    g = jax.grad(lambda m: jnp.mean(render(m, cam, PAL).depth))(model)
    assert np.all(np.isfinite(np.asarray(g.means)))
    assert float(jnp.abs(g.means).max()) > 0


def test_thin_rect_gradients_match_oracle():
    """Regression (round-1 advisor): an edge-clipped thin-wide splat used to
    violate the shrink cap, shifting VJP segment boundaries so later gaussians
    received each other's gradients."""
    width, height = 256, 64
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    n = 12
    rs = np.random.RandomState(3)
    means = rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    log_scales = np.full((n, 3), np.log(0.05), np.float32)
    means[0] = [0.0, -1.36, 0.0]
    log_scales[0] = [np.log(2.0), np.log(0.004), np.log(0.004)]
    model = GaussianModel.create(
        means=means,
        quats=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        log_scales=log_scales,
        opacity_logits=np.full((n,), 2.0),
        sh=rs.uniform(0.0, 1.0, (n, 1, 3)),
    )
    # jnp_tile (not the oracle): the thin splat's rect IS legitimately cropped
    # to the cap, so only backends sharing the crop semantics can agree exactly
    ref = RenderConfig(backend="jnp_tile", small_tiles_per_gaussian=8,
                       max_tiles_per_gaussian=16)
    pal = RenderConfig(backend="pallas", small_tiles_per_gaussian=8,
                       max_tiles_per_gaussian=16)
    target = jax.random.uniform(jax.random.PRNGKey(7), (height, width, 3))

    def loss(m, cfg):
        return jnp.mean((render(m, cam, cfg).image - target) ** 2)

    g_ref = jax.grad(lambda m: loss(m, ref))(model)
    g_pal = jax.grad(lambda m: loss(m, pal))(model)
    for name in ["means", "opacity_logits", "sh"]:
        np.testing.assert_allclose(
            np.asarray(getattr(g_pal, name)),
            np.asarray(getattr(g_ref, name)),
            atol=1e-5, rtol=3e-3, err_msg=name,
        )


def test_opacity_aware_extent_is_output_neutral():
    """Opacity-aware extents shrink rects only past the alpha_skip contour, so
    the rendered image and gradients are unchanged — including dim splats."""
    cam, model = _setup(n=100, width=96, height=64, seed=11)
    # spread opacities across dim..opaque (logits -6..3 → op 0.002..0.95)
    model = model.replace(
        opacity_logits=jnp.linspace(-6.0, 3.0, model.num_gaussians)
    )
    on = RenderConfig(backend="pallas", opacity_aware_extent=True)
    off = RenderConfig(backend="pallas", opacity_aware_extent=False)
    img_on = render(model, cam, on).image
    img_off = render(model, cam, off).image
    np.testing.assert_allclose(
        np.asarray(img_on), np.asarray(img_off), atol=1e-6
    )

    def loss(m, cfg):
        return jnp.mean(render(m, cam, cfg).image ** 2)

    g_on = jax.grad(lambda m: loss(m, on))(model)
    g_off = jax.grad(lambda m: loss(m, off))(model)
    np.testing.assert_allclose(
        np.asarray(g_on.opacity_logits), np.asarray(g_off.opacity_logits),
        atol=1e-6, rtol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(g_on.means), np.asarray(g_off.means), atol=1e-6, rtol=1e-4
    )


def test_sat_check_off_matches_oracle():
    """sat_check=False (no early-saturation skip) is exact tau=0 semantics:
    image AND gradients match the oracle on a deeply-saturating scene."""
    cam, model = _setup(n=150, width=64, height=48, seed=7)
    # crank opacities so transmittance saturates within a few chunks
    model = model.replace(opacity_logits=model.opacity_logits + 4.0)
    target = jax.random.uniform(jax.random.PRNGKey(5), (48, 64, 3))
    off = RenderConfig(backend="pallas", sat_check=False)

    np.testing.assert_allclose(
        np.asarray(render(model, cam, off).image),
        np.asarray(render(model, cam, REF).image),
        atol=3e-5, rtol=1e-4,
    )

    def loss(m, cfg):
        return jnp.mean((render(m, cam, cfg).image - target) ** 2)

    g_ref = jax.grad(lambda m: loss(m, REF))(model)
    g_off = jax.grad(lambda m: loss(m, off))(model)
    for name in ["means", "quats", "log_scales", "opacity_logits", "sh"]:
        a = np.asarray(getattr(g_ref, name))
        b = np.asarray(getattr(g_off, name))
        assert np.all(np.isfinite(b)), name
        np.testing.assert_allclose(b, a, atol=5e-6, rtol=3e-3, err_msg=name)


def test_gradients_on_fallback_pipeline():
    """The raster_pairs pipeline (packed rect codes disabled via
    max_tiles_per_gaussian > 63) matches the oracle's gradients too."""
    from gaussian_splat_tpu.ops.binning import code_packing_ok

    cam, model = _setup(n=60, width=64, height=48, seed=3)
    target = jax.random.uniform(jax.random.PRNGKey(99), (48, 64, 3))
    exact = RenderConfig(backend="pallas", max_tiles_per_gaussian=64)
    assert not code_packing_ok(64, 48, exact)

    def loss(m, cfg):
        return jnp.mean((render(m, cam, cfg).image - target) ** 2)

    ref64 = RenderConfig(backend="reference", max_tiles_per_gaussian=64)
    g_ref = jax.grad(lambda m: loss(m, ref64))(model)
    g_pal = jax.grad(lambda m: loss(m, exact))(model)
    for name in ["means", "quats", "log_scales", "opacity_logits", "sh"]:
        a = np.asarray(getattr(g_ref, name))
        b = np.asarray(getattr(g_pal, name))
        assert np.all(np.isfinite(b)), name
        np.testing.assert_allclose(b, a, atol=5e-6, rtol=3e-3, err_msg=name)
