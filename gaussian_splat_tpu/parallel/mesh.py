"""Mesh construction + sharding placement helpers."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dev") -> Mesh:
    """1D device mesh over the first `n_devices` local devices.

    Within a host the axis rides NVLink; under `jax.distributed` with
    multiple processes the same construction spans hosts (network edges),
    where the splat/tile sharding scheme keeps the heavy all-gather traffic
    within each host (see distributed.make_pod_mesh).
    """
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh({n_devices}) but only {len(devices)} devices are "
                "visible — on CPU set XLA_FLAGS=--xla_force_host_platform_"
                "device_count=N before JAX starts"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_model(model, mesh: Mesh, axis_name: str = "dev"):
    """Place a GaussianModel with every leaf sharded over the primitive axis
    (the sharded version of the reference's single shared-memory instance
    buffer, /root/reference/src/instanced_splat_renderer.mm:410-419)."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, sharding), model
    )


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
