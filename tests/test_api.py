"""API-surface coverage: package exports, backend dispatch, camera utilities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_package_exports():
    import gaussian_splat_tpu as gs

    assert hasattr(gs, "render")
    assert hasattr(gs, "GaussianModel")
    assert hasattr(gs, "Camera")
    assert hasattr(gs, "RenderConfig")
    assert isinstance(gs.__version__, str)


def test_auto_backend_on_cpu_is_jnp_tile():
    import gaussian_splat_tpu as gs

    model = gs.GaussianModel.random(jax.random.PRNGKey(0), 20, sh_degree=0)
    cam = gs.Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60, 48, 48)
    auto = gs.render(model, cam, gs.RenderConfig(backend="auto")).image
    tile = gs.render(model, cam, gs.RenderConfig(backend="jnp_tile")).image
    assert np.array_equal(np.asarray(auto), np.asarray(tile))


def test_unknown_backend_raises():
    import gaussian_splat_tpu as gs

    model = gs.GaussianModel.random(jax.random.PRNGKey(0), 4, sh_degree=0)
    cam = gs.Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60, 32, 32)
    with pytest.raises(ValueError, match="unknown backend"):
        gs.render(model, cam, gs.RenderConfig(backend="metal"))


def test_camera_resized_scales_intrinsics():
    from gaussian_splat_tpu.camera import Camera

    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60, 640, 480)
    cam2 = cam.resized(1280, 960)
    assert cam2.width == 1280 and cam2.height == 960
    np.testing.assert_allclose(float(cam2.fx), 2 * float(cam.fx))
    np.testing.assert_allclose(float(cam2.cx), 2 * float(cam.cx))


def test_camera_position_roundtrip():
    from gaussian_splat_tpu.camera import Camera

    eye = (1.5, -0.5, -3.0)
    cam = Camera.from_lookat(eye, (0, 0, 0), (0, 1, 0), 50, 64, 64)
    np.testing.assert_allclose(np.asarray(cam.position), eye, atol=1e-5)


def test_camera_is_pytree():
    from gaussian_splat_tpu.camera import Camera

    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60, 64, 48)
    leaves, treedef = jax.tree_util.tree_flatten(cam)
    cam2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert cam2.width == 64 and cam2.height == 48

    @jax.jit
    def f(c):
        return c.viewmat.sum()

    assert np.isfinite(float(f(cam)))


def test_orbit_camera_points_at_target():
    from gaussian_splat_tpu.camera import orbit_camera

    for az in [0.0, 90.0, 210.0]:
        cam = orbit_camera(5.0, az, 30.0, target=(1.0, 0.5, -0.5), width=64, height=64)
        p = cam.viewmat @ jnp.array([1.0, 0.5, -0.5, 1.0])
        assert float(p[2]) > 0
        assert abs(float(p[0])) < 1e-4 and abs(float(p[1])) < 1e-4


def test_model_sh_degree_property():
    from gaussian_splat_tpu.models.gaussians import GaussianModel

    for deg in [0, 1, 2, 3]:
        m = GaussianModel.random(jax.random.PRNGKey(0), 4, sh_degree=deg)
        assert m.sh_degree == deg


def test_binning_stats_reports_sentinels():
    """binning_stats is the render path's binning telemetry: a starved big
    tier reports tier_overflow, the calibrated config reports none."""
    import dataclasses

    import gaussian_splat_tpu as gs
    from gaussian_splat_tpu.config import RenderConfig

    cam = gs.Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 128, 96)
    model = gs.GaussianModel.random(
        jax.random.PRNGKey(5), 300, sh_degree=1, extent=1.2,
        scale_range=(0.02, 0.1),
    )
    cal = gs.calibrate_render_config(model, cam, RenderConfig(backend="jnp_tile"))
    ok = gs.binning_stats(model, cam, cal)
    assert int(ok.overflow) == 0 and int(ok.tier_overflow) == 0
    assert int(ok.num_pairs) > 0
    starved = dataclasses.replace(cal, small_tiles_per_gaussian=1, big_tier_capacity=1)
    bad = gs.binning_stats(model, cam, starved)
    assert int(bad.tier_overflow) > 0 and int(bad.clamped_rects) > 0


def test_calibrate_render_config_is_output_identical():
    """Scene calibration tightens pairs_per_gaussian / big_tier_capacity /
    (with mesh_ndev) shard_capacity_margin; with the overflow sentinels at 0
    the calibrated config must render BIT-IDENTICAL output to the default."""
    import gaussian_splat_tpu as gs
    from gaussian_splat_tpu.config import RenderConfig

    cam = gs.Camera.from_lookat(
        (0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 128, 96
    )
    model = gs.GaussianModel.random(
        jax.random.PRNGKey(5), 300, sh_degree=1, extent=1.2,
        scale_range=(0.02, 0.1),
    )
    base = RenderConfig(backend="jnp_tile")
    cal = gs.calibrate_render_config(model, cam, base, mesh_ndev=4)
    assert cal.big_tier_capacity is not None
    assert cal.pairs_per_gaussian <= base.pairs_per_gaussian  # tiny scene
    assert 0.0 <= cal.shard_capacity_margin <= 1.0

    out_base = gs.render(model, cam, base)
    out_cal = gs.render(model, cam, cal)
    assert np.array_equal(np.asarray(out_base.image), np.asarray(out_cal.image))
    assert np.array_equal(np.asarray(out_base.alpha), np.asarray(out_cal.alpha))

    # sentinel check: the calibrated capacities must not truncate this scene
    from gaussian_splat_tpu.ops.binning import bin_gaussians
    from gaussian_splat_tpu.ops.render import (
        _effective_opacities, _project_and_shade,
    )

    proj, _ = _project_and_shade(model, cam, cal)
    opac = _effective_opacities(model, proj, cal)
    b = bin_gaussians(proj, 128, 96, cal, opacities=opac)
    assert int(b.overflow) == 0
    assert int(b.tier_overflow) == 0
