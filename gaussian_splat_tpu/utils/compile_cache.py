"""Where compiled programs persist between processes of one checkout."""

from __future__ import annotations

import os
import pathlib

import jax

REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    With `JAX_COMPILATION_CACHE_DIR` set, JAX reads that variable itself and
    nothing is set here; otherwise the cache lives at `<repo>/.jax_cache` (a
    fixed path, so later runs of the same checkout hit it)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
