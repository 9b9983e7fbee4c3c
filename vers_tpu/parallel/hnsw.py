"""ShardedHNSWIndex: replicated graph, query-sharded beam search.

Scale-out story for the graph index (the reference holds the whole
HNSW in one host's RAM and serves queries single-process,
`vers/src/indexes/hnsw.rs:26`): the navigation table + adjacency are
replicated on every chip of a 1-D mesh and the QUERY batch shards
across chips, so serving throughput scales with the mesh while every
chip runs the same single-chip beam kernel (`vers_tpu.ops.beam`). The
whole descent (all layers + exact f32 rescore) is ONE jitted shard_map
program — no cross-chip collectives at all on the query path, which is
the ideal communication profile for a replicated-model / sharded-data serving
fleet.

(The alternative axis — sharding the f32 rescore corpus — only splits
the small rescore gather; the bf16 nav table dominates memory and the
beam's row gathers are random-access, so replication is the right
layout until a chip cannot hold the table.)
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from jax import shard_map
from jax.sharding import NamedSharding

from vers_tpu.index.hnsw import HNSWIndex, resolve_beam_expand
from vers_tpu.models.candidates import SearchResult
from vers_tpu.ops.beam import full_descent
from vers_tpu.parallel.mesh import SHARD_AXIS, make_mesh


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "top_k", "ef", "ef_r", "entry_row", "rescore", "n_layers",
        "has_scales", "expand", "steps_cap",
    ),
)
def _sharded_descent(
    queries,        # (Q_pad, d) query-sharded
    vecs,           # (n_pad, d) f32, replicated
    vecs_nav,       # (n_pad, d) nav dtype, replicated
    scales,         # (n_pad,) or (1,) dummy, replicated
    adjs,           # tuple of (n_pad, deg_l) int32, replicated
    mesh,
    top_k: int,
    ef: int,
    ef_r: int,
    entry_row: int,
    rescore: bool,
    n_layers: int,
    has_scales: bool,
    expand: int = 4,
    steps_cap=None,
):
    def local(q, vecs, vecs_nav, scales, *adjs):
        return full_descent(
            q, vecs, vecs_nav, scales, tuple(adjs[: n_layers - 1]),
            jnp.full((q.shape[0],), entry_row, jnp.int32),
            top_k=top_k, ef=ef, ef_r=ef_r, rescore=rescore,
            has_scales=has_scales, expand=expand, steps_cap=steps_cap,
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(), P(), P()) + (P(),) * len(adjs),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        check_vma=False,
    )
    return fn(queries, vecs, vecs_nav, scales, *adjs)


class ShardedHNSWIndex:
    """Query-sharded serving wrapper around a (host- or device-built)
    HNSWIndex. Construction and persistence delegate to the wrapped
    index; only `search_batch` fans out over the mesh."""

    def __init__(self, base: HNSWIndex, mesh=None):
        self.base = base
        self.mesh = mesh or make_mesh()
        self.dim = base.dim

    @classmethod
    def build_index(
        cls,
        num_layers: int,
        ef_construction: int,
        ef_search: int,
        num_neighbours: int,
        vectors: np.ndarray,
        mesh=None,
        seed: int = 0,
        batched: bool = False,
    ) -> "ShardedHNSWIndex":
        if batched:
            base = HNSWIndex.build_index_batched(
                num_layers, ef_construction, ef_search, num_neighbours,
                vectors, seed=seed,
            )
        else:
            base = HNSWIndex.build_index(
                num_layers, ef_construction, ef_search, num_neighbours,
                vectors, seed=seed,
            )
        return cls(base, mesh=mesh)

    def save_index(self, file_path: str) -> None:
        self.base.save_index(file_path)

    @classmethod
    def load_index(cls, file_path: str, dim: Optional[int] = None,
                   mesh=None) -> "ShardedHNSWIndex":
        return cls(HNSWIndex.load_index(file_path, dim=dim), mesh=mesh)

    def add(self, embedding, vec_id: int) -> None:
        self.base.add(embedding, vec_id)

    def search_approximate(self, query, top_k: int):
        return self.base.search_approximate(query, top_k)

    def _search_batch_rows(self, queries, top_k: int):
        base = self.base
        cache = base._ensure_device_cache()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        q_n = q.shape[0]
        if cache["entry"] is None or len(base.layers) < 2:
            return (
                np.full((q_n, top_k), np.inf, np.float32),
                np.full((q_n, top_k), -1, np.int32),
            )
        n_shards = self.mesh.shape[SHARD_AXIS]
        q_pad = -(-q_n // n_shards) * n_shards
        qp = np.pad(q, ((0, q_pad - q_n), (0, 0)))
        ef = max(base.ef_search, top_k)
        ef_route = getattr(base.config, "ef_route", None)
        ef_r = max(1, min(ef_route, ef)) if ef_route else ef
        scales = cache["nav_scales"]
        bd, bi = _sharded_descent(
            jax.device_put(qp, NamedSharding(self.mesh, P(SHARD_AXIS))),
            cache["vecs"],
            cache["vecs_nav"],
            scales if scales is not None else jnp.zeros((1,), jnp.float32),
            tuple(cache["adjs"]),
            self.mesh,
            top_k=top_k,
            ef=ef,
            ef_r=ef_r,
            entry_row=int(cache["entry"]),
            rescore=cache["vecs_nav"].dtype != cache["vecs"].dtype,
            n_layers=len(base.layers),
            has_scales=scales is not None,
            expand=resolve_beam_expand(base.config),
            steps_cap=getattr(base.config, "beam_steps", None),
        )
        return np.asarray(bd)[:q_n], np.asarray(bi)[:q_n]

    def search_batch(self, queries, top_k: int) -> SearchResult:
        bd, bi = self._search_batch_rows(queries, top_k)
        node_ids = self.base._ensure_device_cache()["node_ids"]  # int64
        ids = np.where(
            bi >= 0,
            node_ids[np.clip(bi, 0, max(len(node_ids) - 1, 0))],
            -1,
        )
        return SearchResult(ids=ids.astype(np.int64), distances=bd)
