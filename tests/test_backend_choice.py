"""Backend choice per platform, no hidden interpret fallback, the compile-cache
location, and the GPU smoke script's refusal to run without a GPU."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from gaussian_splat_tpu.camera import Camera
from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel
from gaussian_splat_tpu.ops import pallas_raster, render as render_mod
from gaussian_splat_tpu.ops.tile_raster import render_tiled
from gaussian_splat_tpu.parallel import sharded_render
from gaussian_splat_tpu.utils.compile_cache import REPO_CACHE, enable_compile_cache

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRITON_CALL = "__gpu$xla.gpu.triton"


@pytest.mark.parametrize(
    "platform,expected", [("gpu", "pallas"), ("cpu", "jnp_tile")]
)
def test_auto_backend_per_platform(monkeypatch, platform, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert render_mod.auto_backend() == expected
    raster = sharded_render._band_raster(RenderConfig(backend="auto"))
    want = pallas_raster.render_tiled_pallas if expected == "pallas" else render_tiled
    assert raster is want


def test_pallas_compiles_for_gpu_never_interprets(monkeypatch):
    """On the GPU the kernels are lowered as Triton custom calls (forward and
    backward); interpret mode exists only on the CPU; elsewhere it fails."""
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert pallas_raster._use_interpret() is True
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError):
        pallas_raster._use_interpret()

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pallas_raster._use_interpret() is False
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 64, 48)
    model = GaussianModel.random(jax.random.PRNGKey(0), 40, sh_degree=1)
    cfg = RenderConfig(backend="auto")
    loss = lambda m: jnp.mean(render_mod.render(m, cam, cfg).image)
    text = jax.jit(jax.grad(loss)).trace(model).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert TRITON_CALL in text
    assert "gs_raster_fwd" in text and "gs_raster_bwd" in text


def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == str(REPO_CACHE)
        assert jax.config.jax_compilation_cache_dir == str(REPO_CACHE)
        assert REPO_CACHE == ROOT / ".jax_cache"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old  # set nothing in code


def test_chip_smoke_refuses_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr
