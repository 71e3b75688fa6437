"""Device-mesh helpers: the data-parallel replacement for the reference's manual
multi-seed scale-out (SURVEY §2.5).

All distribution in this workload is data-parallelism over i.i.d. Monte-Carlo
frames: the batch axis is sharded over every available device (within a host
and across hosts alike, by jax.sharding), and the only
communication is the scalar error/frame-counter reduction XLA inserts for the
final sums — communication-trivial by design (SURVEY §5).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"


def data_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, batch axis = 'data'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def round_up_batch(batch: int, mesh: Mesh) -> int:
    """Round the per-step batch up to a multiple of the mesh size."""
    n = mesh.devices.size
    return ((batch + n - 1) // n) * n
