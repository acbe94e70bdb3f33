"""GPU parity tests: the Triton-COMPILED Pallas kernels vs the pure jnp tile
rasterizer, at a scale where every code path (two-tier expansion, packed
sort, budget truncation, saturation exit, segments that share blocks with
their neighbours) is hot. The CPU suite runs the kernels in interpret mode
only; these pin the compiled semantics on the card:

    python -m pytest -m gpu tests/test_gpu_hardware.py -q

Every test skips without a GPU. One module-scoped scene amortizes the compile
cost across tests; the jnp_tile references run at "highest" matmul precision.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splat_tpu.camera import Camera
from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel
from gaussian_splat_tpu.ops.render import render

pytestmark = pytest.mark.gpu

N = 100_000
W, H = 640, 360


@pytest.fixture(scope="module")
def scene():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: python -m pytest -m gpu tests/test_gpu_hardware.py")
    model = GaussianModel.random(
        jax.random.PRNGKey(7), N, sh_degree=1, extent=2.0, scale_range=(0.005, 0.03)
    )
    camera = Camera.from_lookat(
        (0.0, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, W, H
    )
    return model, camera


def _run(model, camera, backend):
    cfg = RenderConfig(backend=backend)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda m: render(m, camera, cfg))(model)
    return jax.device_get(out.image), jax.device_get(out.alpha), jax.device_get(out.depth)


def test_pallas_image_matches_jnp_tile_at_scale(scene):
    model, camera = scene
    img_p, a_p, d_p = _run(model, camera, "pallas")
    img_j, a_j, d_j = _run(model, camera, "jnp_tile")
    # f32 on both sides, different summation order (jnp_tile differences a
    # global cumsum over all pairs): see chip_smoke.py for the bounds
    np.testing.assert_allclose(img_p, img_j, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(a_p, a_j, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(d_p, d_j, atol=5e-3, rtol=1e-3)


def _grads(model, camera, target, backend):
    def loss(m):
        img = render(m, camera, RenderConfig(backend=backend)).image
        return jnp.mean(jnp.abs(img - target))

    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.grad(loss))(model)


def test_pallas_gradients_match_jnp_tile_at_scale(scene):
    """f32 per-pair gradients end to end, so the bulk matches tightly. A
    handful of elements may deviate by a few % of the global max: the α-clamp
    gradient mask (alpha_raw < alpha_clamp) flips between backends when a
    near-opaque splat's α sits within an ulp of the clamp — a knife-edge of
    the model (the clamp is a step in dα), not a precision defect."""
    model, camera = scene
    target = jax.random.uniform(jax.random.PRNGKey(1), (H, W, 3))
    g_p = _grads(model, camera, target, "pallas")
    g_j = _grads(model, camera, target, "jnp_tile")
    for name in ["means", "quats", "log_scales", "opacity_logits", "sh"]:
        a = np.asarray(getattr(g_j, name))
        b = np.asarray(getattr(g_p, name))
        err = np.abs(b - a) / (np.abs(a).max() + 1e-12)
        assert float((err > 5e-3).mean()) < 1e-4, name
        assert float(err.max()) < 6e-2, name


def test_pallas_determinism_across_runs(scene):
    """No atomics in the kernels: renders are bit-identical run to run."""
    model, camera = scene
    cfg = RenderConfig(backend="pallas")
    fn = jax.jit(lambda m: render(m, camera, cfg).image)
    np.testing.assert_array_equal(np.asarray(fn(model)), np.asarray(fn(model)))


def test_pallas_gradient_determinism(scene):
    """The per-pair gradients are atomic-free and bitwise repeatable; the
    per-splat sum is XLA's segment-sum, a scatter-add the GPU runs with
    atomics in any order, so gradients are NOT bitwise repeatable. Asserted:
    repeat runs agree to 1e-6 of each leaf's max (f32 reassociation)."""
    model, camera = scene
    cfg = RenderConfig(backend="pallas")
    fn = jax.jit(jax.grad(lambda m: jnp.mean(render(m, camera, cfg).image ** 2)))
    a, b = fn(model), fn(model)
    for name in ["means", "opacity_logits", "sh"]:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6 * np.abs(x).max())


def test_sharded_render_on_hardware(scene):
    if len(jax.devices()) < 2:
        pytest.skip("needs more than one GPU")
    from gaussian_splat_tpu.parallel.mesh import make_mesh, shard_model
    from gaussian_splat_tpu.parallel.sharded_render import render_sharded

    model, camera = scene
    ndev = len(jax.devices())
    n = model.num_gaussians
    pad = (-n) % ndev
    if pad:
        model = jax.tree_util.tree_map(
            lambda x: jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]),
            model,
        )
        model = model.replace(
            opacity_logits=model.opacity_logits.at[n:].set(-20.0),
            log_scales=model.log_scales.at[n:].set(-20.0),
        )
    mesh = make_mesh()
    cfg = RenderConfig(backend="pallas")
    out = render_sharded(shard_model(model, mesh), camera, cfg, mesh)
    img_single = jax.device_get(render(model, camera, cfg).image)
    np.testing.assert_allclose(
        jax.device_get(out.image), img_single, atol=3e-6, rtol=1e-5
    )
