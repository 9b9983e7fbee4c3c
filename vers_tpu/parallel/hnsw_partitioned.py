"""PartitionedHNSWIndex: corpus-partitioned HNSW — capacity scale-out.

The reference holds the whole graph in one host's RAM
(`vers/src/indexes/hnsw.rs:26`); `parallel/hnsw.ShardedHNSWIndex`
scales *throughput* by replicating that state per chip. This class
scales *capacity*: corpus rows split into contiguous blocks, ONE
independent HNSW subgraph per shard over its local rows, so per-chip
state is ~1/n_shards of a single-graph index and an index larger than
one card's memory becomes possible.

Query = every shard runs its full local descent (the same brute-force
layer-1 routing scan + layer-0 beam + f32 rescore as the single-chip
scan route, `ops/beam.full_descent_scan`) on the REPLICATED query
batch, emitting its local top-k as global padded-row candidates; the
k·n_shards candidates all_gather (XLA inserts it at the shard_map
boundary) and one final top-k per query picks the answer. Per-shard
candidates are disjoint by construction (each covers distinct rows),
so the merge needs no dedup.

Recall: each sub-search is an ANN search over an n/S-row graph with the
full ef — the union dominates a single-graph search of the same ef in
practice (smaller graphs route better), at the cost of S× total scan
work. That trade (work for capacity+recall) is the standard partitioned
ANN serving design.

Construction cost note: S subgraphs of n/S rows each build *faster*
than one n-row graph (beam steps scale with log n), and shard builds
are independent — they could run concurrently, one per card (today
they run one after another on the first device).
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from vers_tpu.core import device_id_map, round_up
from vers_tpu.index.hnsw import HNSWIndex, resolve_beam_expand
from vers_tpu.ops.beam import full_descent_scan
from vers_tpu.ops.topk import topk_smallest
from vers_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from vers_tpu.parallel.partitioned import PartitionedIndexBase


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "top_k", "ef", "seeds", "expand", "steps_cap", "per",
    ),
)
def _partitioned_search(
    queries,      # (Q, d) f32, replicated
    vecs,         # (S*per, d) f32, row-sharded
    vecs_nav,     # (S*per, d) bf16, row-sharded
    adj0,         # (S*per, deg) int32 LOCAL rows, row-sharded
    l1_tab,       # (S*n1_pad, d) bf16, row-sharded
    l1_members,   # (S*n1_pad,) int32 local rows, row-sharded
    n1s,          # (S,) int32 live layer-1 rows per shard, row-sharded
    mesh,
    top_k: int,
    ef: int,
    seeds: int,
    expand: int,
    steps_cap,
    per: int,     # padded rows per shard (static)
):
    """One program: per-shard full descent -> global padded-row ids ->
    all_gather (implicit at the shard_map boundary) -> final top-k."""

    def local(q, vecs, vecs_nav, adj0, l1_tab, l1_members, n1):
        d, rows = full_descent_scan(
            q, vecs, vecs_nav,
            jnp.zeros((1,), jnp.float32),  # no int8 scales in this layout
            adj0, l1_tab, l1_members, n1[0],
            top_k=top_k, ef=ef, seeds=seeds,
            rescore=True, has_scales=False,
            expand=expand, steps_cap=steps_cap,
        )
        # local row -> global padded row (shard offset)
        offset = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32) * per
        return d, jnp.where(rows >= 0, rows + offset, -1)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(),) + (P(SHARD_AXIS),) * 6,
        out_specs=(P(None, SHARD_AXIS), P(None, SHARD_AXIS)),
        check_vma=False,
    )
    all_d, all_i = fn(
        queries, vecs, vecs_nav, adj0, l1_tab, l1_members, n1s
    )
    # candidates from different shards cover disjoint rows: plain top-k
    fin_d, sel = topk_smallest(all_d, top_k)
    fin_i = jnp.take_along_axis(all_i, sel, axis=1)
    return fin_d, jnp.where(jnp.isfinite(fin_d), fin_i, -1)


class PartitionedHNSWIndex(PartitionedIndexBase):
    """One HNSW subgraph per mesh shard over that shard's corpus rows.

    ``shards`` are plain single-chip `HNSWIndex` objects with LOCAL
    identity node ids (0..n_s-1); ``gids[s]`` maps shard s's local rows
    to external ids. Construction, single-query parity search, adds and
    persistence all work per shard on the host; only `search_batch`
    compiles against the mesh. Incremental adds patch the assembled
    device cache in place (`_patch_device_cache`) — the shard's own
    fast add already computed the touched adjacency rows.
    """

    _manifest_format = "vers_tpu.partitioned_hnsw.v1"
    _shard_cls = HNSWIndex

    @staticmethod
    def _shard_rows(shard) -> int:
        return shard._rows_used

    # -- construction ----------------------------------------------------

    @classmethod
    def build_index(
        cls,
        num_layers: int,
        ef_construction: int,
        ef_search: int,
        num_neighbours: int,
        vectors: np.ndarray,
        vector_ids=None,
        mesh=None,
        seed: int = 0,
        batched: bool = True,
        **build_kwargs,
    ) -> "PartitionedHNSWIndex":
        """Split ``vectors`` into contiguous row blocks and build one
        independent subgraph per shard (wave-parallel by default; the
        host port with ``batched=False``). Per-shard seeds differ so
        layer assignment stays independent across shards."""
        mesh = mesh or make_mesh()
        n_shards = mesh.shape[SHARD_AXIS]
        vectors = np.asarray(vectors, dtype=np.float32)
        n = vectors.shape[0]
        if vector_ids is None:
            vector_ids = np.arange(n, dtype=np.int64)
        vector_ids = np.asarray(vector_ids, np.int64)
        base = -(-max(n, 1) // n_shards)
        shards, gids = [], []
        for s in range(n_shards):
            lo, hi = s * base, min((s + 1) * base, n)
            block = vectors[lo:hi]
            if batched and block.shape[0]:
                # small shards need proportionally smaller waves: the
                # default 1024-cap schedule would insert most of a
                # 300-row shard against a ~70-node frozen graph and
                # the subgraph quality (hence recall) suffers
                kwargs = dict(build_kwargs)
                kwargs.setdefault(
                    "wave_cap", min(1024, max(8, block.shape[0] // 8))
                )
                shard = HNSWIndex.build_index_batched(
                    num_layers, ef_construction, ef_search,
                    num_neighbours, block, seed=seed + s, **kwargs,
                )
            else:
                shard = HNSWIndex.build_index(
                    num_layers, ef_construction, ef_search,
                    num_neighbours, block, seed=seed + s,
                )
            shards.append(shard)
            gids.append(vector_ids[lo:hi].copy())
        return cls(shards, gids=gids, mesh=mesh)

    # -- device cache -----------------------------------------------------

    def _ensure_device_cache(self):
        """Assemble the row-sharded serving arrays: every per-shard
        piece pads to common shapes on the HOST (numpy), then ONE
        device_put per array places each shard's block directly on its
        chip — per-chip state is that shard's subgraph only."""
        if self._device_cache is not None:
            return self._device_cache
        n_shards = self.mesh.shape[SHARD_AXIS]
        graphs = [s._host_graph_arrays() for s in self.shards]
        # row slack (~12.5%, min 64) so incremental adds patch in place
        # for a long stream before a block fills and forces re-assembly
        # (+ a `per` recompile); padding rows are inert — adj -1, never
        # seeded.
        max_n = max(max(g["n"], 1) for g in graphs)
        per = round_up(max_n + max(64, max_n // 8), 8)
        deg = max(
            (g["adjs"][0].shape[1] if g["adjs"] else 1) for g in graphs
        )
        max_l1 = max(max(int(g["l1_rows"].size), 1) for g in graphs)
        n1_pad = round_up(max_l1 + 16, 8)

        vecs = np.zeros((n_shards * per, self.dim), np.float32)
        adj0 = np.full((n_shards * per, deg), -1, np.int32)
        l1_tab = np.zeros((n_shards * n1_pad, self.dim), np.float32)
        l1_members = np.zeros((n_shards * n1_pad,), np.int32)
        n1s = np.zeros((n_shards,), np.int32)
        row_to_gid = np.full((n_shards * per,), -1, np.int64)
        for s, g in enumerate(graphs):
            n_s = g["n"]
            if n_s == 0:
                continue  # neutral fills already in place
            if g["vecs"] is not None:
                vecs[s * per : s * per + n_s] = g["vecs"][:n_s]
            else:  # device-resident shard corpus: download once
                vecs[s * per : s * per + n_s] = np.asarray(
                    self.shards[s]._corpus_dev[:n_s]
                )
            if g["adjs"]:
                a0 = g["adjs"][0]
                rows = min(a0.shape[0], per)
                adj0[s * per : s * per + rows, : a0.shape[1]] = a0[:rows]
            l1 = g["l1_rows"]
            if l1.size == 0:
                # tiny shard with an empty layer 1: seed the beam from
                # the first local rows instead of returning nothing
                l1 = np.arange(min(n_s, n1_pad), dtype=np.int64)
            n1 = int(l1.size)
            n1s[s] = n1
            if n1:
                l1_members[s * n1_pad : s * n1_pad + n1] = l1.astype(np.int32)
                l1_tab[s * n1_pad : s * n1_pad + n1] = vecs[
                    s * per + l1.astype(np.int64)
                ]
            # external ids follow the shard's compact row order
            row_to_gid[s * per : s * per + n_s] = self.gids[s][
                g["node_ids"][:n_s]
            ]

        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        vecs_dev = jax.device_put(vecs, sh)
        self._device_cache = dict(
            vecs=vecs_dev,
            vecs_nav=vecs_dev.astype(jnp.bfloat16),
            adj0=jax.device_put(adj0, sh),
            l1_tab=jax.device_put(l1_tab, sh).astype(jnp.bfloat16),
            l1_members=jax.device_put(l1_members, sh),
            n1s=jax.device_put(n1s, sh),
            n1s_host=n1s.copy(),
            n1_pad=n1_pad,
            per=per,
            row_to_gid=row_to_gid,
            row_to_gid_dev=device_id_map(row_to_gid),
        )
        return self._device_cache

    # -- Index API ---------------------------------------------------------

    def _patch_device_cache(
        self, s: int, local_id: int, emb: np.ndarray, vec_id: int
    ) -> bool:
        """Apply one insert to the assembled sharded cache in place: a
        handful of row scatters instead of a full re-assembly (which
        for device-built shards even re-DOWNLOADS their corpora).
        Returns False — cache dropped, lazily re-assembled — when the
        shard took its host add path, its block or layer-1 slots are
        full, or a touched row outgrew the cache's padded degree."""
        cache = self._device_cache
        shard = self.shards[s]
        patch = getattr(shard, "_last_add_patch", None)
        if patch is None or patch.get("row") != local_id:
            return False  # host-path insert: graph dicts changed shape
        per = cache["per"]
        if local_id >= per:
            return False  # shard block full: re-assemble with new slack
        deg = int(cache["adj0"].shape[1])
        rows, mats = [], []
        for r, a in patch["adj0"].items():
            v = a[a >= 0]
            if len(v) > deg:
                return False  # would truncate edges
            packed = np.full((deg,), -1, np.int32)
            packed[: len(v)] = v
            rows.append(s * per + int(r))
            mats.append(packed)
        if patch["l1_added"]:
            n1 = int(cache["n1s_host"][s])
            if n1 >= cache["n1_pad"]:
                return False  # layer-1 slots full
        q = jnp.asarray(emb)
        grow = s * per + local_id
        cache["vecs"] = cache["vecs"].at[grow].set(q)
        cache["vecs_nav"] = cache["vecs_nav"].at[grow].set(
            q.astype(cache["vecs_nav"].dtype)
        )
        if rows:
            ridx = jnp.asarray(np.asarray(rows, np.int32))
            cache["adj0"] = cache["adj0"].at[ridx].set(
                jnp.asarray(np.stack(mats))
            )
        if patch["l1_added"]:
            pos = s * cache["n1_pad"] + n1
            cache["l1_members"] = cache["l1_members"].at[pos].set(
                np.int32(local_id)
            )
            cache["l1_tab"] = cache["l1_tab"].at[pos].set(
                q.astype(cache["l1_tab"].dtype)
            )
            cache["n1s_host"][s] = n1 + 1
            cache["n1s"] = cache["n1s"].at[s].set(np.int32(n1 + 1))
        cache["row_to_gid"][grow] = vec_id
        idmap = cache["row_to_gid_dev"]
        if idmap is not None:
            if -(2**31) <= vec_id < 2**31:
                cache["row_to_gid_dev"] = idmap.at[grow].set(
                    np.int32(vec_id)
                )
            else:
                cache["row_to_gid_dev"] = None  # host mapping only
        return True

    def _search_batch_rows(self, queries, top_k: int):
        cache = self._ensure_device_cache()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        ef = max(
            max(s.ef_search for s in self.shards), top_k
        )
        cfg = self.shards[0].config
        seeds = getattr(cfg, "route_seeds", 0) or min(ef, 8)
        return _partitioned_search(
            jnp.asarray(q),
            cache["vecs"], cache["vecs_nav"], cache["adj0"],
            cache["l1_tab"], cache["l1_members"], cache["n1s"],
            self.mesh,
            top_k=top_k, ef=ef, seeds=seeds,
            expand=resolve_beam_expand(cfg),
            steps_cap=getattr(cfg, "beam_steps", None),
            per=cache["per"],
        )

    def get_num_nodes_in_layers(self) -> List[int]:
        """Global per-layer node counts (sum over shards)."""
        per_shard = [s.get_num_nodes_in_layers() for s in self.shards]
        depth = max(len(p) for p in per_shard)
        return [
            sum(p[l] for p in per_shard if l < len(p))
            for l in range(depth)
        ]
