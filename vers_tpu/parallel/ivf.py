"""ShardedIVFFlatIndex — multi-chip IVFFlat.

Build: global k-means via the psum-reduced distributed Lloyd loop
(`vers_tpu.parallel.kmeans`), centroids replicated on every chip.

Search: every shard stores its rows cluster-major; queries probe the
(replicated) centroids once, then each chip runs the same packed
binned scan (`vers_tpu.ops.binned.scan_packed` logic) over its local
members of the probed clusters inside one `shard_map` program; local
top-k candidates are `all_gather`ed across cards and re-top-k'd. External
ids are global, so the merge needs no offset bookkeeping.

Persistence: per-shard files + manifest (same scheme as
ShardedFlatIndex) with centroids in the manifest sidecar; also exports
to the reference single-file IVFFlat bincode layout.
"""

from __future__ import annotations

import functools
import json
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from vers_tpu.core import round_up
from vers_tpu.index.base import Index
from vers_tpu.io.bincode import Reader, Writer
from vers_tpu.models.candidates import SearchResult
from vers_tpu.ops.distance import pairwise_distance, pairwise_sq_euclidean
from vers_tpu.ops.kmeans import assign_clusters
from vers_tpu.ops.topk import topk_smallest
from vers_tpu.parallel.kmeans import sharded_build_kmeans
from vers_tpu.parallel.mesh import SHARD_AXIS, make_mesh, shard_rows


def _local_packed_scan(
    q_sorted, qbin_sorted, gq, gr, corpus_sorted, rbin, orig_ids,
    top_k: int, q_blk: int, r_blk: int, metric: str, axis: str,
):
    """Body run per shard under shard_map. Leading shard dim already
    stripped. Returns replicated (dists, global_ids) (Q, top_k)."""
    q_pad, d = q_sorted.shape
    n_pad = corpus_sorted.shape[0]
    kk = min(top_k, r_blk)

    q_ext = jnp.pad(q_sorted, ((0, q_blk), (0, 0)))
    qbin_ext = jnp.pad(qbin_sorted, (0, q_blk), constant_values=-1)
    res_d = jnp.full((q_pad + q_blk, top_k), jnp.inf, jnp.float32)
    res_i = jnp.full((q_pad + q_blk, top_k), -1, jnp.int32)

    def per_group(carry, g):
        res_d, res_i = carry
        qs, rs = g
        qb = jax.lax.dynamic_slice(q_ext, (qs, 0), (q_blk, d))
        qbins = jax.lax.dynamic_slice(qbin_ext, (qs,), (q_blk,))
        base = jnp.minimum(rs, n_pad - r_blk)
        rb = jax.lax.dynamic_slice(corpus_sorted, (base, 0), (r_blk, d))
        rbins = jax.lax.dynamic_slice(rbin, (base,), (r_blk,))
        rids = jax.lax.dynamic_slice(orig_ids, (base,), (r_blk,))
        dist = pairwise_distance(qb, rb, metric)
        mask = (qbins[:, None] == rbins[None, :]) & (qbins[:, None] >= 0)
        dist = jnp.where(mask, dist, jnp.inf)
        bd, bi = topk_smallest(dist, kk)
        if kk < top_k:
            bd = jnp.pad(bd, ((0, 0), (0, top_k - kk)), constant_values=jnp.inf)
            bi = jnp.pad(bi, ((0, 0), (0, top_k - kk)))
        ids = jnp.where(jnp.isfinite(bd), rids[jnp.clip(bi, 0, r_blk - 1)], -1)
        res_d = jax.lax.dynamic_update_slice(res_d, bd, (qs, 0))
        res_i = jax.lax.dynamic_update_slice(res_i, ids, (qs, 0))
        return (res_d, res_i), None

    (res_d, res_i), _ = jax.lax.scan(per_group, (res_d, res_i), (gq, gr))
    d_loc = res_d[:q_pad]
    i_loc = res_i[:q_pad]
    # cross-chip candidate merge
    dg = jax.lax.all_gather(d_loc, axis, axis=1, tiled=True)  # (Q, S*k)
    ig = jax.lax.all_gather(i_loc, axis, axis=1, tiled=True)
    fd, sel = topk_smallest(dg, top_k)
    fi = jnp.take_along_axis(ig, sel, axis=1)
    fi = jnp.where(jnp.isfinite(fd), fi, -1)
    return fd, fi


class ShardedIVFFlatIndex(Index):
    def __init__(
        self,
        num_centroids: int,
        centroids: np.ndarray,
        shard_values: List[np.ndarray],   # per shard (n_s, d)
        shard_ids: List[np.ndarray],      # per shard (n_s,) global ids
        mesh: Optional[Mesh] = None,
        metric: str = "sq_euclidean",
    ):
        self.mesh = mesh or make_mesh()
        self.num_centroids = int(num_centroids)
        self.metric = metric
        self._centroids = np.asarray(centroids, np.float32)
        self._shard_values = [np.asarray(v, np.float32) for v in shard_values]
        self._shard_ids = [np.asarray(i, np.int64) for i in shard_ids]
        self.dim = self._centroids.shape[1]
        self._state = None

    # -- build ----------------------------------------------------------

    @classmethod
    def build_index(
        cls,
        num_clusters: int,
        num_attempts: int,
        max_iterations: int,
        vectors: np.ndarray,
        mesh: Optional[Mesh] = None,
        seed: int = 0,
    ) -> "ShardedIVFFlatIndex":
        """Distributed build: psum-reduced Lloyd with best-of-N restarts."""
        mesh = mesh or make_mesh()
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        xs, counts = shard_rows(vectors, mesh)
        best = None
        key = jax.random.PRNGKey(seed)
        for attempt in range(num_attempts):
            c, cost = sharded_build_kmeans(
                jax.random.fold_in(key, attempt), xs, counts,
                num_clusters, max_iterations, mesh,
            )
            if best is None or float(cost) < best[1]:
                best = (np.asarray(c), float(cost))
        centroids = best[0]
        # local assignment + shard splits on host (build-time only)
        n_shards = mesh.shape[SHARD_AXIS]
        counts_h = np.asarray(counts)
        shard_values, shard_ids = [], []
        offset = 0
        for s in range(n_shards):
            c_s = int(counts_h[s])
            rows = vectors[offset : offset + c_s]
            shard_values.append(rows)
            shard_ids.append(np.arange(offset, offset + c_s, dtype=np.int64))
            offset += c_s
        return cls(num_clusters, centroids, shard_values, shard_ids, mesh)

    # -- device layout ----------------------------------------------------

    def _ensure_state(self):
        if self._state is not None:
            return self._state
        k = self.num_centroids
        n_shards = self.mesh.shape[SHARD_AXIS]
        n_pad = 0
        for v in self._shard_values:
            n_pad = max(n_pad, round_up(max(len(v), 1), 128))
        stacked_corpus = np.zeros((n_shards, n_pad, self.dim), np.float32)
        stacked_rbin = np.full((n_shards, n_pad), -1, np.int32)
        stacked_oid = np.full((n_shards, n_pad), -1, np.int32)
        sizes_all = np.zeros((n_shards, k), np.int64)
        starts_all = np.zeros((n_shards, k), np.int64)
        centroids_dev = jnp.asarray(self._centroids)
        for s, (v, ids) in enumerate(zip(self._shard_values, self._shard_ids)):
            n_s = len(v)
            if n_s == 0:
                continue
            assign = np.asarray(
                assign_clusters(jnp.asarray(v), n_s, centroids_dev)
            )
            order = np.argsort(assign, kind="stable")
            sizes = np.bincount(assign, minlength=k)
            starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            stacked_corpus[s, :n_s] = v[order]
            stacked_rbin[s, :n_s] = assign[order]
            stacked_oid[s, :n_s] = ids[order]
            sizes_all[s] = sizes
            starts_all[s] = starts
        sharding = NamedSharding(self.mesh, P(SHARD_AXIS))
        self._state = dict(
            corpus=jax.device_put(stacked_corpus, sharding),
            rbin=jax.device_put(stacked_rbin, sharding),
            oid=jax.device_put(stacked_oid, sharding),
            sizes=sizes_all,
            starts=starts_all,
            centroids=jnp.asarray(self._centroids),
            n_pad=n_pad,
        )
        return self._state

    # -- Index API --------------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        """Appends to the least-loaded shard (rebalancing is a bulk op)."""
        emb = np.asarray(embedding, np.float32).reshape(1, -1)
        s = int(np.argmin([len(v) for v in self._shard_values]))
        self._shard_values[s] = np.concatenate([self._shard_values[s], emb])
        self._shard_ids[s] = np.append(self._shard_ids[s], np.int64(vec_id))
        self._state = None

    def search_batch(
        self, queries, top_k: int, nprobe: int = 1
    ) -> SearchResult:
        state = self._ensure_state()
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        q_n = queries.shape[0]
        nprobe = max(1, min(nprobe, self.num_centroids))

        cdist = np.asarray(
            pairwise_sq_euclidean(jnp.asarray(queries), state["centroids"])
        )
        probes = np.argsort(cdist, axis=1, kind="stable")[:, :nprobe]

        out_d, out_i = [], []
        for r in range(nprobe):
            bins = probes[:, r].astype(np.int64)
            order = np.argsort(bins, kind="stable")
            q_sorted = queries[order]
            qbin_sorted = bins[order].astype(np.int32)
            qcount = np.bincount(bins, minlength=self.num_centroids)
            # per-shard group packing against a COMMON (q_blk, r_blk)
            from vers_tpu.ops.binned import pack_groups

            n_shards = self.mesh.shape[SHARD_AXIS]
            max_bin = max(int(state["sizes"].max()), top_k, 1)
            r_blk = min(round_up(max(max_bin, 512), 128), state["n_pad"])
            q_blk = min(round_up(max(int(qcount.max()), 64), 64), round_up(q_n, 8))
            gqs, grs = [], []
            for s in range(n_shards):
                gq, gr = pack_groups(
                    qcount, state["sizes"][s], state["starts"][s], q_blk, r_blk
                )
                gqs.append(gq)
                grs.append(gr)
            g_pad = round_up(max(max(len(g) for g in gqs), 1), 8)
            gq_arr = np.full((n_shards, g_pad), q_n, np.int32)
            gr_arr = np.zeros((n_shards, g_pad), np.int32)
            for s in range(n_shards):
                gq_arr[s, : len(gqs[s])] = gqs[s]
                gr_arr[s, : len(grs[s])] = grs[s]

            def strip(f):
                # shard_map passes (1, ...) leading blocks; squeeze them
                def inner(qs_, qb_, gq_, gr_, corpus_, rbin_, oid_):
                    return f(
                        qs_, qb_, gq_[0], gr_[0], corpus_[0], rbin_[0], oid_[0]
                    )
                return inner

            fn2 = shard_map(
                strip(
                    functools.partial(
                        _local_packed_scan,
                        top_k=top_k, q_blk=q_blk, r_blk=r_blk,
                        metric=self.metric, axis=SHARD_AXIS,
                    )
                ),
                mesh=self.mesh,
                in_specs=(
                    P(), P(),
                    P(SHARD_AXIS), P(SHARD_AXIS),
                    P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                ),
                out_specs=(P(), P()),
                check_vma=False,
            )
            d, i = jax.jit(fn2)(
                jnp.asarray(q_sorted),
                jnp.asarray(qbin_sorted),
                jnp.asarray(gq_arr),
                jnp.asarray(gr_arr),
                state["corpus"],
                state["rbin"],
                state["oid"],
            )
            inv = np.argsort(order, kind="stable")
            out_d.append(np.asarray(d)[inv])
            out_i.append(np.asarray(i)[inv])

        from vers_tpu.ops.binned import merge_probe_results

        fd, fi = merge_probe_results(
            jnp.asarray(np.concatenate(out_d, axis=1)),
            jnp.asarray(np.concatenate(out_i, axis=1)),
            top_k,
            dedup=False,  # IVF probe ranks are distinct clusters
        )
        return SearchResult(
            ids=np.asarray(fi, dtype=np.int64), distances=np.asarray(fd)
        )

    # -- persistence -------------------------------------------------------

    def save_index(self, file_path: str) -> None:
        manifest = {
            "format": "vers_tpu.sharded_ivfflat.v1",
            "dim": self.dim,
            "metric": self.metric,
            "num_centroids": self.num_centroids,
            "num_shards": len(self._shard_values),
        }
        with open(file_path + ".manifest.json", "w") as fp:
            json.dump(manifest, fp)
        with open(file_path + ".centroids", "wb") as fp:
            Writer(fp).vec_f32_matrix(self._centroids)
        for s, (v, ids) in enumerate(zip(self._shard_values, self._shard_ids)):
            with open(f"{file_path}.shard{s}", "wb") as fp:
                w = Writer(fp)
                w.vec_f32_matrix(v)
                w.vec_u64(ids.astype(np.uint64))

    @classmethod
    def load_index(
        cls, file_path: str, dim: Optional[int] = None, mesh=None
    ) -> "ShardedIVFFlatIndex":
        with open(file_path + ".manifest.json") as fp:
            manifest = json.load(fp)
        dim = dim or manifest["dim"]
        with open(file_path + ".centroids", "rb") as fp:
            centroids = Reader(fp).vec_f32_matrix(dim)
        shard_values, shard_ids = [], []
        for s in range(manifest["num_shards"]):
            with open(f"{file_path}.shard{s}", "rb") as fp:
                r = Reader(fp)
                shard_values.append(r.vec_f32_matrix(dim))
                shard_ids.append(r.vec_u64().astype(np.int64))
        return cls(
            manifest["num_centroids"], centroids, shard_values, shard_ids,
            mesh=mesh, metric=manifest["metric"],
        )

    def export_single_file(self, file_path: str) -> None:
        """Export to the reference's single-file IVFFlat bincode layout
        (`ivfflat.rs:8-15`). Note: ids in the reference format are row
        positions; rows are written in shard-then-insertion order."""
        from vers_tpu.index.ivfflat import IVFFlatIndex

        values = np.concatenate(self._shard_values) if self._shard_values else np.zeros((0, self.dim), np.float32)
        assign = np.argmin(
            np.stack(
                [((values - c[None, :]) ** 2).sum(-1) for c in self._centroids],
                axis=1,
            ),
            axis=1,
        ) if len(values) else np.zeros((0,), np.int64)
        ids: List[List[int]] = [[] for _ in range(self.num_centroids)]
        for row, c in enumerate(assign):
            ids[int(c)].append(row)
        IVFFlatIndex(
            self.num_centroids, values, self._centroids, assign, ids
        ).save_index(file_path)
