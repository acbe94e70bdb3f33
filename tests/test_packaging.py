"""Packaging sanity: every third-party package the library imports must be
declared in pyproject.toml (a required or an optional dependency), and the
render and train path must run with only the required ones installed."""

import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "gaussian_splat_tpu"

# import name -> PyPI distribution name as it appears in pyproject deps
DIST_OF = {
    "jax": "jax",
    "jaxlib": "jax",
    "numpy": "numpy",
    "optax": "optax",
    "PIL": "pillow",
}


def _declared_deps():
    if sys.version_info >= (3, 11):
        import tomllib

        with open(ROOT / "pyproject.toml", "rb") as f:
            data = tomllib.load(f)
        deps = list(data["project"]["dependencies"])
        for extra in data["project"].get("optional-dependencies", {}).values():
            deps += extra
    else:  # pragma: no cover
        text = (ROOT / "pyproject.toml").read_text()
        deps = []
        for block in re.findall(r"=\s*\[(.*?)\]", text, re.S):
            deps += re.findall(r'"([^"]+)"', block)
    return {re.split(r"[<>=!\[; ]", d)[0].lower() for d in deps}


def _imported_top_level():
    """Top-level names imported anywhere in the package (incl. lazy imports)."""
    names = set()
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    names.add(a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if node.module:
                    names.add(node.module.split(".")[0])
    return names


def test_all_imports_are_declared_dependencies():
    declared = _declared_deps()
    stdlib = set(sys.stdlib_module_names)
    missing = []
    for name in sorted(_imported_top_level()):
        if name in stdlib or name == "gaussian_splat_tpu":
            continue
        dist = DIST_OF.get(name)
        assert dist is not None, (
            f"unknown third-party import {name!r}: map it in DIST_OF and "
            f"declare it in pyproject.toml"
        )
        if dist.lower() not in declared:
            missing.append((name, dist))
    assert not missing, f"imports missing from pyproject dependencies: {missing}"


def test_main_path_runs_without_optional_packages(tmp_path):
    """Import the package and take a train step (render, backward, optimizer,
    checkpoint) with flax, orbax and PIL made unimportable."""
    script = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("flax", "orbax", "PIL"):
                    raise ImportError(f"{name} is blocked")
        sys.meta_path.insert(0, Block())
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        import gaussian_splat_tpu as gs
        from gaussian_splat_tpu.config import TrainConfig
        from gaussian_splat_tpu.train.checkpoint import restore_checkpoint, save_checkpoint
        from gaussian_splat_tpu.train.trainer import create_train_state, make_train_step
        model = gs.GaussianModel.random(jax.random.PRNGKey(0), 32, sh_degree=1)
        cam = gs.Camera.from_lookat((0, 0, -3), (0, 0, 0), (0, 1, 0), 60.0, 32, 32)
        tc = TrainConfig()
        state = create_train_state(model, tc)
        step = make_train_step(cam, gs.RenderConfig(backend="pallas"), tc)
        state, loss = step(state, jnp.full((32, 32, 3), 0.5))
        assert bool(jnp.isfinite(loss))
        save_checkpoint(sys.argv[1], state)
        assert int(restore_checkpoint(sys.argv[1], state).step) == 1
        assert not any(m.split(".")[0] in ("flax", "orbax", "PIL") for m in sys.modules)
        print("ok")
    """)
    r = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "ckpt")],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]
