"""Checkpoint / resume for the training state.

The reference's only persistence is the PLY itself (its test scene is a
training-iteration-30000 artifact, /root/reference/src/main.mm:69-70, reloaded
from disk every launch, instanced_splat_renderer.mm:339-393). This module adds:

  * `.npz` checkpoints of the full TrainState pytree (model + optimizer
    moments + step): one file per step, `step_<N>.npz`, written atomically
    (temporary file + rename), the newest `MAX_TO_KEEP` kept. Restoring
    places every leaf like the template's (sharding included), so a resumed
    run continues exactly where the saved one stopped (SURVEY §5
    failure-detection: checkpoint + restart-from-checkpoint is the v1
    recovery story).
  * PLY export via `gaussian_splat_tpu.io.ply` remains the interchange format
    (the ecosystem's de-facto checkpoint), usable at any step.

With several processes every process gathers the global arrays and process
0 alone writes; all of them read.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import jax
import numpy as np

MAX_TO_KEEP = 3
_NAME = re.compile(r"^step_(\d+)\.npz$")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m
    )


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.npz")


def _to_host(leaf):
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(leaf, tiled=True))
    return np.asarray(leaf)


def save_checkpoint(directory: str, state) -> None:
    """Write `state` as the checkpoint of its `step`; keep the newest
    MAX_TO_KEEP."""
    leaves = [_to_host(x) for x in jax.tree_util.tree_leaves(state)]
    if jax.process_index() != 0:
        return
    os.makedirs(directory, exist_ok=True)
    step = int(state.step)
    tmp = os.path.join(directory, f".step_{step}.tmp.npz")
    np.savez(tmp, *leaves)
    os.replace(tmp, _path(directory, step))
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_path(directory, old))


def restore_checkpoint(directory: str, template):
    """Restore the latest checkpoint into the structure of `template`
    (each leaf takes the template leaf's dtype and sharding); None if the
    directory holds no checkpoint."""
    step = latest_step(directory)
    if step is None:
        return None
    t_leaves, treedef = jax.tree_util.tree_flatten(template)
    with np.load(_path(directory, step)) as data:
        saved = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(saved) != len(t_leaves):
        raise ValueError(
            f"checkpoint step {step} holds {len(saved)} arrays, the template "
            f"{len(t_leaves)}"
        )
    leaves = []
    for value, t in zip(saved, t_leaves):
        if isinstance(t, jax.Array):
            leaves.append(jax.device_put(value.astype(t.dtype), t.sharding))
        else:
            leaves.append(type(t)(value) if np.ndim(value) == 0 else value)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None
