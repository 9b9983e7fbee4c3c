"""ShardedANNIndex: replicated shared-corpus forest, query-sharded search.

Scale-out story for the RP-tree forest (the reference searches trees
with a rayon thread pool inside one host's RAM, `vers/src/indexes/
lsh.rs:264-281`): every chip of a 1-D mesh holds the full forest in the
SHARED-corpus layout (`ops/forest_shared`: ONE corpus copy + per-tree
int32 index tables — the reference's own memory shape, `lsh.rs:44,53`)
and the QUERY batch shards across chips. Each chip runs the same
single-dispatch program as the single-chip path — multiprobe descent +
lax.scan over trees with the packed-scan engine + dedup merge
(`index/lsh._search_batch_internal`) — inside one shard_map, so serving
throughput scales with the mesh and the query path needs no cross-chip
collectives at all (the same profile as `parallel/hnsw.py`).

The replicated state is the shared layout: one ~1.2GB corpus at
1M x 300, ~4·T·n bytes of int32 tables and one live gathered tree view,
not a corpus copy per tree — see docs/MULTICHIP.md.

Tree-parallelism (the reference's axis) deliberately does NOT map to
chips: trees share the corpus, and candidates from different trees must
be deduplicated before ranking — an all_gather + dedup barrier per
batch. Query-sharding keeps the dedup on-chip (the lax.scan's id-dedup
merge) and rides the embarrassingly parallel axis instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from jax import shard_map

from vers_tpu.engine import resolve_engine
from vers_tpu.index.lsh import ANNIndex
from vers_tpu.models.candidates import SearchResult
from vers_tpu.parallel.mesh import SHARD_AXIS, make_mesh


class ShardedANNIndex:
    """Query-sharded serving wrapper around a built ANNIndex.
    Construction, adds, and persistence delegate to the wrapped index;
    only the batched search fans out over the mesh."""

    def __init__(self, base: ANNIndex, mesh=None):
        self.base = base
        self.mesh = mesh or make_mesh()
        self.dim = base.dim

    @classmethod
    def build_index(
        cls,
        num_trees: int,
        max_node_size: int,
        vectors: np.ndarray,
        vector_ids=None,
        config=None,
        mesh=None,
    ) -> "ShardedANNIndex":
        if vector_ids is None:
            vector_ids = np.arange(len(vectors))
        base = ANNIndex.build_index(
            num_trees, max_node_size, vectors, vector_ids, config=config
        )
        return cls(base, mesh=mesh)

    def save_index(self, file_path: str) -> None:
        self.base.save_index(file_path)

    @classmethod
    def load_index(cls, file_path: str, dim: Optional[int] = None,
                   mesh=None) -> "ShardedANNIndex":
        return cls(ANNIndex.load_index(file_path, dim=dim), mesh=mesh)

    def add(self, embedding, vec_id: int) -> None:
        self.base.add(embedding, vec_id)

    def search_approximate(self, query, top_k: int):
        return self.base.search_approximate(query, top_k)

    def _search_batch_rows(
        self, queries, top_k: int, probes_per_tree: Optional[int] = None
    ):
        from vers_tpu.ops.forest_shared import forest_search_shared

        base = self.base
        base._rebuild_dirty()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        q_n = q.shape[0]
        n_shards = self.mesh.shape[SHARD_AXIS]
        n_probes, deficit_k = base._probe_plan(top_k, probes_per_tree)
        # the tile plan below is built for the PER-CHIP query count
        q_pad = -(-q_n // (64 * n_shards)) * (64 * n_shards)
        qp = np.pad(q, ((0, q_pad - q_n), (0, 0)))
        sh, plan = base._shared_plan(
            q_pad // n_shards, top_k,
            resolve_engine(base.config.engine, top_k),
        )

        def local(qs, *reps):
            return forest_search_shared(
                qs, *reps, n_probes=n_probes, num_bins=sh["num_bins"],
                top_k=top_k, deficit_k=deficit_k, **plan,
            )

        reps = base.shared_operands(sh)
        fn = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(SHARD_AXIS),) + (P(),) * len(reps),
            out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
            check_vma=False,
        )
        dists, internal = fn(
            jax.device_put(qp, NamedSharding(self.mesh, P(SHARD_AXIS))),
            *reps,
        )
        return np.asarray(dists)[:q_n], np.asarray(internal)[:q_n]

    def search_batch(
        self, queries, top_k: int, probes_per_tree: Optional[int] = None
    ) -> SearchResult:
        dists, internal = self._search_batch_rows(
            queries, top_k, probes_per_tree
        )
        ids = self.base._ids
        ext = np.where(
            internal >= 0, ids[np.clip(internal, 0, len(ids) - 1)], -1
        )
        return SearchResult(ids=ext.astype(np.int64), distances=dists)
