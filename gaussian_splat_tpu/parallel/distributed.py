"""Multi-host bootstrap: jax.distributed + host-ordered meshes (north-star
config 5).

The reference has no distributed backend (SURVEY §2.3); here
`jax.distributed.initialize` forms the multi-process runtime (XLA's
collectives then run over NCCL), and the mesh helpers order devices host by
host so the heavy all_gather of projected features stays on each host's
NVLink while only the (small) scalar reductions cross the network.

Single-process usage is unaffected — `init_distributed()` is a no-op when the
environment carries no coordinator address.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from args or the environment
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID). Returns True
    if multi-process.

    Safe to call unconditionally: returns False when no coordinator address
    is given. Nothing else announces a GPU cluster, so the process count and
    this process's id must be given too.
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None:
        return False
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=addr, num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def make_pod_mesh(axis_name: str = "dev") -> Mesh:
    """1D mesh over ALL devices of all processes, ordered so consecutive mesh
    positions are intra-host first: the render pipeline's all_gather then
    keeps most hops on each host's NVLink rather than the network."""
    devices = sorted(
        jax.devices(), key=lambda d: (d.process_index, d.id)
    )
    return Mesh(np.asarray(devices), (axis_name,))


def local_batch_slice(total: int) -> slice:
    """This process's contiguous shard of a length-`total` leading axis
    (equal split across processes; total must divide evenly)."""
    p = jax.process_count()
    i = jax.process_index()
    assert total % p == 0, f"{total} not divisible by {p} processes"
    per = total // p
    return slice(i * per, (i + 1) * per)
