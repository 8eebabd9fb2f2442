"""Device-mesh helpers for the 1-D block-row partition axis."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

AXIS = "x"  # the block-row partition axis


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devs = devices if devices is not None else jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)} "
                "(set XLA_FLAGS=--xla_force_host_platform_device_count=N "
                "with JAX_PLATFORMS=cpu to simulate)"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def place_on_mesh(tree, mesh: Mesh):
    """Put every leaf of a stacked per-shard pytree (leading axis = shard:
    ShardedBmSparse, ShardedPrepared, ShardedProduct) on the mesh, shard
    s on device s, so the sharded ops run without moving their plans."""
    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec(AXIS)))
