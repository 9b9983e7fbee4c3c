"""Device mesh helpers — the "distributed backend" of vers_tpu.

The reference is single-process shared-memory (rayon work stealing +
DashSet, see SURVEY §2); its scale-out axis is absent. Here the corpus
axis ``n`` shards across a 1-D `jax.sharding.Mesh` (every card reaches
every other at the same rate over NVLink, so a 1-D mesh fits): each chip
scans its rows with the same fused kernels, and cross-chip merges ride
XLA collectives (`psum` for k-means reductions, `all_gather` for
top-k candidate merges).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shards"


def make_mesh(n_devices: Optional[int] = None, axis: str = SHARD_AXIS) -> Mesh:
    """1-D mesh over the first n_devices devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def shard_rows(
    x: np.ndarray,
    mesh: Mesh,
    axis: str = SHARD_AXIS,
    capacity_per_shard: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Pad axis 0 to a multiple of the mesh size and place the array
    row-sharded. Returns (sharded (n_pad, ...), per-shard valid counts
    (n_shards,) int32 row-sharded as (1,) each).

    ``capacity_per_shard`` reserves headroom rows per shard (zero
    padding past each shard's count) so callers can append in place
    without re-sharding."""
    n_shards = mesh.shape[axis]
    n = x.shape[0]
    base = -(-max(n, 1) // n_shards)  # balanced rows per shard
    per = base
    if capacity_per_shard is not None:
        per = max(per, capacity_per_shard)
    # round per-shard rows up to the f32 sublane so local scans tile
    per = ((per + 7) // 8) * 8
    x = np.asarray(x)
    counts = np.asarray(
        [max(0, min(base, n - s * base)) for s in range(n_shards)],
        dtype=np.int32,
    )
    xp = np.zeros((per * n_shards,) + x.shape[1:], dtype=x.dtype)
    for s in range(n_shards):
        c = counts[s]
        xp[s * per : s * per + c] = x[s * base : s * base + c]
    xs = jax.device_put(xp, NamedSharding(mesh, P(axis)))
    cs = jax.device_put(counts, NamedSharding(mesh, P(axis)))
    return xs, cs
