"""Device mesh helpers.

Collections larger than one device shard across devices
(SURVEY §2 parallelism checklist: document-sharding is the only axis a
vector store has; queries are replicated, per-shard top-k results are
all-gathered and merged; the mesh is a flat 1-D axis, as the cards of
one host are joined all to all).  Multi-host setups extend the same mesh
via jax.distributed — the axis name stays "shard" either way.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shard"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]), (SHARD_AXIS,))


def shard_spec() -> P:
    return P(SHARD_AXIS)


def replicated_spec() -> P:
    return P()


def sharded(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for stacked per-shard state arrays."""
    return NamedSharding(mesh, P(SHARD_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
