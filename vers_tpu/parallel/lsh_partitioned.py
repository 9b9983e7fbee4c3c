"""PartitionedANNIndex: corpus-partitioned RP-forest — capacity axis.

The reference holds the whole forest in one host's RAM (`vers/src/
indexes/lsh.rs:53`); `parallel/lsh.ShardedANNIndex` replicates that
state per chip and shards queries (throughput axis). This class closes
the CAPACITY axis the same way `parallel/hnsw_partitioned` does for the
graph: corpus rows split into contiguous blocks, one independent forest
per shard over its local rows, so per-chip state is ~1/n_shards.

Each shard's local search runs on the SHARED-corpus layout
(`ops/forest_shared`, the reference's own memory shape `lsh.rs:44,53`):
the shard's corpus block lives on its chip exactly ONCE, trees hold
int32 index tables, and the per-tree bin-major view is gathered inside
a lax.scan (one tree live at a time). Per-chip device memory is
therefore ~n/S corpus rows + one gathered tree view, not a corpus copy
per tree (see docs/MULTICHIP.md for the 1M x 300 math).

Query = ONE program: the query batch replicates, every shard runs the
same single-dispatch shared-corpus forest search as the single-chip
path (multiprobe descent + lax.scan over trees + dedup merge,
`ops/forest_shared.forest_search_shared_*`) over its LOCAL tables,
local result rows offset into global padded rows, and the k·n_shards
candidates all_gather (implicit at the shard_map boundary) into one
final top-k. Shards cover disjoint rows, so the merge needs no dedup.

The per-shard tables unify to common statics (r_blk / G_max / num_bins
maxima across shards; group tables pad by repeating their last bin
boundary — zero bins, zero tiles) so one compiled program serves every
shard.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from vers_tpu.core import device_id_map, round_up
from vers_tpu.engine import resolve_engine
from vers_tpu.index.lsh import ANNIndex
from vers_tpu.ops.binned import kernel_q_blk
from vers_tpu.ops.topk import topk_smallest
from vers_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from vers_tpu.parallel.partitioned import PartitionedIndexBase


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_probes", "num_bins", "top_k", "pern", "deficit_k",
        "plan",
    ),
)
def _partitioned_forest_search_shared(
    queries,    # (Q, d) replicated
    coeffs,     # (S, maxlen, d) PACKED hyperplanes, row-sharded axis 0
    consts,     # (S, maxlen)
    cbase,      # (S, T, L) first packed row per (tree, level)
    splits,     # (S, T, L, SC)
    buckets,    # (S, T, L, SC)
    offsets,    # (S, T)
    sizes,      # (S, kb) int32 leaf sizes (deficit gate)
    corpus,     # (S*pern, d) ONE corpus copy per shard
    order,      # (S, T, pern) tree-sorted pos -> local row
    rbin_sorted,  # (S, T, pern)
    g_first,    # (S, T, G+1)
    g_rstart,   # (S, T, G)
    mesh,
    n_probes: int,
    num_bins: int,
    top_k: int,
    pern: int,
    deficit_k: int,
    plan: tuple,   # sorted (key, value) statics for the local program
):
    plan_kw = dict(plan)

    from vers_tpu.ops.forest_shared import forest_search_shared

    def local(q, cf, cn, cb, sp, bk, of, sz, co, od, rs, gf, gr):
        d, internal = forest_search_shared(
            q, cf[0], cn[0], cb[0], sp[0], bk[0], of[0], sz[0],
            co, od[0], rs[0], gf[0], gr[0],
            n_probes=n_probes, num_bins=num_bins, top_k=top_k,
            deficit_k=deficit_k, **plan_kw,
        )
        off = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32) * pern
        return d, jnp.where(internal >= 0, internal + off, -1)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(),) + (P(SHARD_AXIS),) * 12,
        out_specs=(P(None, SHARD_AXIS), P(None, SHARD_AXIS)),
        check_vma=False,
    )
    all_d, all_i = fn(
        queries, coeffs, consts, cbase, splits, buckets, offsets, sizes,
        corpus, order, rbin_sorted, g_first, g_rstart,
    )
    fin_d, sel = topk_smallest(all_d, top_k)
    fin_i = jnp.take_along_axis(all_i, sel, axis=1)
    return fin_d, jnp.where(jnp.isfinite(fin_d), fin_i, -1)


class PartitionedANNIndex(PartitionedIndexBase):
    """One RP-forest per mesh shard over that shard's corpus rows.

    ``shards`` are single-chip `ANNIndex` objects whose ids are LOCAL
    input ordinals (0..block_rows-1); ``gids[s]`` maps shard s's input
    ordinals to external ids.

    Adds always invalidate the assembled cache (base default): a
    leaf-split rewrites the shard's tree tables, so there is no cheap
    row-scatter patch — and re-assembly is host-side only (forest
    shards keep host `_values`; nothing is downloaded).
    """

    _manifest_format = "vers_tpu.partitioned_lsh.v1"
    _shard_cls = ANNIndex

    def __init__(self, shards, gids=None, mesh=None):
        super().__init__(shards, gids=gids, mesh=mesh)

    @staticmethod
    def _shard_rows(shard) -> int:
        return len(shard._ids)

    @classmethod
    def build_index(
        cls,
        num_trees: int,
        max_node_size: int,
        vectors: np.ndarray,
        vector_ids=None,
        config=None,
        mesh=None,
    ) -> "PartitionedANNIndex":
        mesh = mesh or make_mesh()
        n_shards = mesh.shape[SHARD_AXIS]
        vectors = np.asarray(vectors, dtype=np.float32)
        n = vectors.shape[0]
        if n < n_shards:
            raise ValueError(
                f"corpus of {n} rows cannot partition over {n_shards} shards"
            )
        if vector_ids is None:
            vector_ids = np.arange(n, dtype=np.int64)
        vector_ids = np.asarray(vector_ids, np.int64)
        base = -(-n // n_shards)
        shards, gids = [], []
        for s in range(n_shards):
            lo, hi = s * base, min((s + 1) * base, n)
            block = vectors[lo:hi]
            shard = ANNIndex.build_index(
                num_trees, max_node_size, block,
                np.arange(hi - lo), config=config,
            )
            shards.append(shard)
            gids.append(vector_ids[lo:hi].copy())
        return cls(shards, gids=gids, mesh=mesh)

    # -- device cache ------------------------------------------------------

    def _ensure_device_cache(self):
        """Engine-independent state: descent tables, ONE corpus copy per
        shard (row-sharded), id maps. The per-tree index tables are
        r_blk-dependent and built by `_tables`."""
        if self._device_cache is not None:
            return self._device_cache
        for s in self.shards:
            s._rebuild_dirty()
        n_shards = self.mesh.shape[SHARD_AXIS]
        trees = [s._trees for s in self.shards]
        T = len(trees[0])
        if any(len(t) != T for t in trees):
            raise ValueError("all shards must share num_trees")
        flats = [s._flat_descent_tables() for s in self.shards]
        L = max(f[2].shape[1] for f in flats)
        SC = max(f[3].shape[2] for f in flats)
        maxlen = max(f[0].shape[0] for f in flats)
        kb = max(
            sum(t.num_buckets for t in ts) for ts in trees
        )
        d = self.dim
        pern = round_up(
            max(s._values.shape[0] for s in self.shards), 128
        )

        coeffs = np.zeros((n_shards, maxlen, d), np.float32)
        consts = np.zeros((n_shards, maxlen), np.float32)
        cbase = np.zeros((n_shards, T, L), np.int32)
        splits = np.full((n_shards, T, L, SC), -1, np.int32)
        buckets = np.full((n_shards, T, L, SC), -1, np.int32)
        offsets = np.zeros((n_shards, T), np.int32)
        sizes = np.zeros((n_shards, kb), np.int32)
        corpus = np.zeros((n_shards * pern, d), np.float32)
        row_to_gid = np.full((n_shards * pern,), -1, np.int64)
        for s, shard in enumerate(self.shards):
            cf, cn, cb, sp, bk = flats[s]
            ln = cf.shape[0]
            l, sc = sp.shape[1], sp.shape[2]
            coeffs[s, :ln] = cf
            consts[s, :ln] = cn
            cbase[s, :, :l] = cb
            cbase[s, :, l:] = cb[:, -1:] if l else 0
            splits[s, :, :l, :sc] = sp
            buckets[s, :, :l, :sc] = bk
            off = 0
            for t, tr in enumerate(shard._trees):
                offsets[s, t] = off
                for b, m in enumerate(tr.members):
                    sizes[s, off + b] = len(m)
                off += tr.num_buckets
            rows = shard._values.shape[0]
            corpus[s * pern : s * pern + rows] = shard._values
            ids = shard._ids  # internal row -> local input ordinal
            row_to_gid[s * pern : s * pern + rows] = self.gids[s][ids]
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        self._device_cache = dict(
            coeffs=jax.device_put(coeffs, sh),
            consts=jax.device_put(consts, sh),
            cbase=jax.device_put(cbase, sh),
            splits=jax.device_put(splits, sh),
            buckets=jax.device_put(buckets, sh),
            offsets=jax.device_put(offsets, sh),
            sizes=jax.device_put(sizes, sh),
            corpus=jax.device_put(corpus, sh),
            pern=pern,
            kb=kb,
            T=T,
            tables={},   # r_blk -> stacked shared tree tables
            row_to_gid=row_to_gid,
            row_to_gid_dev=device_id_map(row_to_gid),
        )
        return self._device_cache

    def _unified_r_blk(self, engine: str, top_k: int) -> int:
        """One r_blk across shards (statics must agree): each shard's
        natural single-chip target (`ANNIndex._shared_plan`), unified by
        max."""
        r_blk = 1
        for s in self.shards:
            max_bin = s._max_bin()
            n = s._values.shape[0]
            n_pad = round_up(max(n, 1), 128)
            if engine == "pallas":
                r_blk = max(r_blk, max_bin)
            else:
                r_target = max(
                    max_bin, top_k, min(8192, max(1024, n // 16))
                )
                r_blk = max(r_blk, min(round_up(r_target, 128), n_pad))
        return r_blk

    def _tables(self, r_blk: int):
        """Per-shard shared-corpus tree tables (`ops/forest_shared.
        shared_tree_tables`), stacked over shards and padded to common
        statics, device-put row-sharded. Cached per r_blk."""
        from vers_tpu.ops.forest_shared import shared_tree_tables

        cache = self._ensure_device_cache()
        if r_blk in cache["tables"]:
            return cache["tables"][r_blk]
        n_shards = len(self.shards)
        T = cache["T"]
        pern = cache["pern"]
        ts = [
            shared_tree_tables(
                [tr.leaf_of_vec for tr in s._trees],
                [tr.num_buckets for tr in s._trees],
                r_blk,
            )
            for s in self.shards
        ]
        g_max = max(t["g_max"] for t in ts)
        g_total_min = min(t["g_total"] for t in ts)
        order = np.full((n_shards, T, pern), -1, np.int32)
        rbin_sorted = np.full((n_shards, T, pern), -1, np.int32)
        g_first = np.zeros((n_shards, T, g_max + 1), np.int32)
        g_rstart = np.zeros((n_shards, T, g_max), np.int32)
        for s, t in enumerate(ts):
            np_s = t["order"].shape[1]
            order[s, :, :np_s] = t["order"]
            rbin_sorted[s, :, :np_s] = t["rbin_sorted"]
            gw = t["g_first"].shape[1]
            g_first[s, :, :gw] = t["g_first"]
            g_first[s, :, gw:] = t["g_first"][:, -1:]
            g_rstart[s, :, : t["g_rstart"].shape[1]] = t["g_rstart"]
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        out = dict(
            g_max=g_max, g_total_min=g_total_min,
            order=jax.device_put(order, sh),
            rbin_sorted=jax.device_put(rbin_sorted, sh),
            g_first=jax.device_put(g_first, sh),
            g_rstart=jax.device_put(g_rstart, sh),
        )
        cache["tables"][r_blk] = out
        return out

    # -- Index API -----------------------------------------------------------

    def _search_batch_rows(
        self, queries, top_k: int, probes_per_tree: Optional[int] = None
    ):
        cache = self._ensure_device_cache()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        q_n = q.shape[0]
        if probes_per_tree is None:
            n_probes = max(s._auto_probes(top_k) for s in self.shards)
            deficit_k = top_k if n_probes > 1 else 0
        else:
            n_probes = max(1, probes_per_tree)
            deficit_k = 0
        engine = resolve_engine(self.shards[0].config.engine, top_k)
        r_blk = self._unified_r_blk(engine, top_k)
        tbl = self._tables(r_blk)
        if engine == "pallas":
            q_blk = kernel_q_blk(q_n, tbl["g_max"])
        else:
            q_blk = min(
                round_up(
                    max(64, q_n // max(tbl["g_total_min"], 1) * 2), 64
                ),
                round_up(q_n, 8),
            )
        plan = dict(
            q_blk=q_blk, r_blk=r_blk, engine=engine,
            w_rank=(q_n + q_blk - 1) // q_blk + tbl["g_max"],
        )
        qdev = jnp.asarray(q)
        bd, bi = _partitioned_forest_search_shared(
            qdev,
            cache["coeffs"], cache["consts"], cache["cbase"],
            cache["splits"], cache["buckets"], cache["offsets"],
            cache["sizes"],
            cache["corpus"],
            tbl["order"], tbl["rbin_sorted"], tbl["g_first"],
            tbl["g_rstart"],
            self.mesh,
            n_probes=n_probes, num_bins=cache["kb"],
            top_k=top_k, pern=cache["pern"], deficit_k=deficit_k,
            plan=tuple(sorted(plan.items())),
        )
        return bd, bi
