"""Sharded exact search: each chip runs the fused distance+top-k scan
over its corpus shard, then a cross-chip top-k merge (`all_gather` of
k·n_shards candidates + re-top-k) rides the links between cards
(NVLink on a four-H100 host).

This is the GloVe-1.2M sharded config of BASELINE.json (config 5):
scaling the corpus axis the reference can only hold in one host's RAM.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from vers_tpu.ops.topk import fused_scan_topk, topk_smallest
from vers_tpu.parallel.mesh import SHARD_AXIS


def sharded_topk(
    queries: jax.Array,
    corpus_sharded: jax.Array,   # (n_pad, d) row-sharded over mesh
    counts_sharded: jax.Array,   # (n_shards,) valid rows per shard
    k: int,
    mesh: Mesh,
    metric: str = "sq_euclidean",
    chunk_size: int = 16384,
    axis: str = SHARD_AXIS,
):
    """Replicated queries, sharded corpus -> exact global top-k.
    Returns (dists (Q, k), global_row_ids (Q, k))."""

    def local(q, x, nv):
        per_shard = x.shape[0]
        d, i = fused_scan_topk(
            q, x, nv[0], k, metric=metric, chunk_size=chunk_size
        )
        shard = jax.lax.axis_index(axis)
        gi = jnp.where(i >= 0, i + shard * per_shard, -1)
        dg = jax.lax.all_gather(d, axis, axis=1, tiled=True)   # (Q, S*k)
        ig = jax.lax.all_gather(gi, axis, axis=1, tiled=True)
        dd, sel = topk_smallest(dg, k)
        ii = jnp.take_along_axis(ig, sel, axis=1)
        ii = jnp.where(jnp.isfinite(dd), ii, -1)
        return dd, ii

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)(queries, corpus_sharded, counts_sharded)
