"""IVFFlat index — JAX rebuild of `vers/src/indexes/ivfflat.rs`.

Build: jitted Lloyd k-means (`vers_tpu.ops.kmeans`) with vmapped
random restarts — the batched re-expression of the rayon-parallel
assignment loop (`ivfflat.rs:29-46`) and the attempt loop
(`ivfflat.rs:111-121`).

Search (batched): cluster-binned dense scan (`vers_tpu.ops.binned`) —
the corpus is stored cluster-major so each probed cluster is one
contiguous row range hit with a dense matmul; per-query results
from nprobe probes merge with a final top-k. This replaces the
reference's walk-nearest-clusters loop (`ivfflat.rs:166-195`).

Search (single query): exact behavioral parity with the reference's
adaptive cluster walk, including its remainder bookkeeping and the
take-top_k-per-cluster quirk.

Quirk parity: ``add`` ignores the caller's vec_id and assigns
``len(assignments)`` (`ivfflat.rs:209` shadows the argument) — kept.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from vers_tpu.config import IVFFlatConfig
from vers_tpu.core import as_query_matrix, round_up
from vers_tpu.engine import resolve_engine
from vers_tpu.index.base import Index
from vers_tpu.io.bincode import Reader, Writer
from vers_tpu.models.candidates import SearchResult
from vers_tpu.ops import kmeans as kmeans_ops
from vers_tpu.ops.binned import (
    adaptive_probe_depth,
    adaptive_probes,
    binned_topk_fused,
    make_layout,
    make_layout_device,
)
from vers_tpu.ops.distance import pairwise_sq_euclidean
from vers_tpu.ops.topk import topk_smallest


@functools.partial(jax.jit, static_argnames=("nprobe",))
def _probe_clusters(queries, centroids, nprobe: int):
    """(Q, nprobe) nearest-centroid ids per query (ascending distance)."""
    cdist = pairwise_sq_euclidean(queries, centroids)
    _, probes = topk_smallest(cdist, nprobe)
    return probes


class IVFFlatIndex(Index):
    def __init__(
        self,
        num_centroids: int,
        values: np.ndarray,
        centroids: np.ndarray,
        assignments: np.ndarray,
        ids: List[List[int]],
        config: IVFFlatConfig = IVFFlatConfig(),
    ):
        self.config = config
        self.num_centroids = int(num_centroids)
        self._values = np.asarray(values, dtype=np.float32)
        self._centroids = np.asarray(centroids, dtype=np.float32)
        self._assignments = np.asarray(assignments, dtype=np.int64)
        self._ids = [list(map(int, c)) for c in ids]
        self.dim = self._values.shape[1]
        self._layout = None  # lazy cluster-major device layout
        self._centroids_dev = None
        self._values_dev = None
        self._assign_dev = None
        self._n_valid = self._values.shape[0]

    # -- build ---------------------------------------------------------

    @classmethod
    def build_index(
        cls,
        num_clusters: int,
        num_attempts: int,
        max_iterations: int,
        vectors: np.ndarray,
        config: Optional[IVFFlatConfig] = None,
    ) -> "IVFFlatIndex":
        """Parity signature with `ivfflat.rs:102-136`."""
        config = config or IVFFlatConfig(
            num_clusters=num_clusters,
            num_attempts=num_attempts,
            max_iterations=max_iterations,
        )
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        n_pad = round_up(n, 128)
        data = jax.device_put(np.pad(vectors, ((0, n_pad - n), (0, 0))))
        key = jax.random.PRNGKey(config.seed)
        centroids, _ = kmeans_ops.build_kmeans_restarts(
            key, data, n, num_clusters, num_attempts, max_iterations
        )
        assignments = np.asarray(kmeans_ops.assign_clusters(data, n, centroids))[:n]
        ids: List[List[int]] = [[] for _ in range(num_clusters)]
        for vec_id, c in enumerate(assignments):
            ids[int(c)].append(vec_id)
        return cls(
            num_clusters, vectors, np.asarray(centroids), assignments, ids, config
        )

    @classmethod
    def build_index_device(
        cls,
        num_clusters: int,
        num_attempts: int,
        max_iterations: int,
        data_dev: jnp.ndarray,
        n_valid: Optional[int] = None,
        config: Optional[IVFFlatConfig] = None,
    ) -> "IVFFlatIndex":
        """Build from a device-resident (n_pad, d) corpus: k-means,
        assignment, and the cluster-major search layout all stay on
        device; the host sees only the (k,) size vector. Host-side
        state (values/assignments/ids for add/save/single-query paths)
        materializes lazily on first use.

        The host-input ``build_index`` uploads then defers to the same
        ops; this entry point skips the round-trip entirely for data
        produced on device (sharded loaders, on-device transforms)."""
        config = config or IVFFlatConfig(
            num_clusters=num_clusters,
            num_attempts=num_attempts,
            max_iterations=max_iterations,
        )
        n_pad, d = data_dev.shape
        n = int(n_valid) if n_valid is not None else n_pad
        key = jax.random.PRNGKey(config.seed)
        centroids_dev, _ = kmeans_ops.build_kmeans_restarts(
            key, data_dev, n, num_clusters, num_attempts, max_iterations
        )
        assign_dev = kmeans_ops.assign_clusters(data_dev, n, centroids_dev)
        layout = make_layout_device(data_dev, assign_dev, num_clusters, n)
        idx = cls.__new__(cls)
        idx.config = config
        idx.num_centroids = int(num_clusters)
        idx._values = None
        idx._centroids = None
        idx._assignments = None
        idx._ids = None
        idx._values_dev = data_dev
        idx._assign_dev = assign_dev
        idx._n_valid = n
        idx.dim = int(d)
        idx._layout = layout
        idx._centroids_dev = centroids_dev
        return idx

    def _materialize_host(self):
        """Download device-built state for the host-side paths (add,
        save_index, single-query parity search). No-op for host-built
        indexes."""
        if self._values is not None:
            return
        self._values = np.asarray(self._values_dev)[: self._n_valid]
        self._centroids = np.asarray(self._centroids_dev)
        self._assignments = np.asarray(self._assign_dev)[: self._n_valid].astype(
            np.int64
        )
        ids: List[List[int]] = [[] for _ in range(self.num_centroids)]
        for vec_id, c in enumerate(self._assignments):
            ids[int(c)].append(vec_id)
        self._ids = ids

    def _ensure_layout(self):
        if self._layout is None:
            if self._values is None and self._values_dev is not None:
                # device-built index whose layout was dropped (slack
                # exhaustion): rebuild on device — no host round trip
                self._layout = make_layout_device(
                    self._values_dev, self._assign_dev,
                    self.num_centroids, self._n_valid,
                )
            else:
                self._materialize_host()
                self._layout = make_layout(
                    self._values, self._assignments, self.num_centroids
                )
                self._centroids_dev = jnp.asarray(self._centroids)
        return self._layout

    def _centroids_host(self) -> np.ndarray:
        """Host centroids without materializing the corpus (the (k, d)
        download is tiny)."""
        if self._centroids is None:
            self._centroids = np.asarray(self._centroids_dev)
        return self._centroids

    # -- Index API -------------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        """Quirk parity with `ivfflat.rs:200-213`: the caller's vec_id is
        ignored; the new row gets id == len(assignments).

        Incremental: an existing cluster-major layout is
        patched in place — on first add it re-packs once WITH per-bin
        slack (`ops/binned.slacken_layout`, device-side), then each add
        is four device scatters into the assigned bin's slack. A
        device-built corpus is patched on device too; the host mirrors
        stay lazy (no corpus download on the add path)."""
        emb = np.asarray(embedding, dtype=np.float32).reshape(-1)
        cent = self._centroids_host()
        d2 = np.sum((cent - emb[None, :]) ** 2, axis=1)
        c = int(np.argmin(d2))
        new_id = self._n_valid

        if self._values is not None:  # host mirrors exist: keep fresh
            self._values = np.concatenate([self._values, emb[None, :]], axis=0)
            self._assignments = np.append(self._assignments, c)
            self._ids[c].append(new_id)
        if self._values_dev is not None:  # device corpus: patch on device
            n_pad = int(self._values_dev.shape[0])
            if new_id >= n_pad:
                grow = 128
                self._values_dev = jnp.concatenate(
                    [self._values_dev,
                     jnp.zeros((grow, self.dim), self._values_dev.dtype)]
                )
                self._assign_dev = jnp.concatenate(
                    [self._assign_dev,
                     jnp.zeros((grow,), self._assign_dev.dtype)]
                )
            self._values_dev = self._values_dev.at[new_id].set(
                jnp.asarray(emb)
            )
            self._assign_dev = self._assign_dev.at[new_id].set(c)
        self._n_valid = new_id + 1

        if self._layout is not None:
            from vers_tpu.ops.binned import layout_insert, slacken_layout

            if not self._layout.get("slacked"):
                self._layout = slacken_layout(self._layout)
            if not layout_insert(self._layout, emb, c, new_id):
                self._layout = None  # slack exhausted: rebuild lazily

    def add_batch(self, embeddings, vec_ids=None) -> None:
        """Vectorized bulk insert: one assignment pass, one layout
        rebuild. Caller vec_ids are ignored (same quirk parity as
        ``add``: new rows get sequential ids)."""
        self._materialize_host()
        embs = np.asarray(embeddings, dtype=np.float32)
        if embs.ndim == 1:
            embs = embs[None]
        d2 = (
            np.einsum("nd,nd->n", embs, embs)[:, None]
            + np.einsum("kd,kd->k", self._centroids, self._centroids)[None, :]
            - 2.0 * embs @ self._centroids.T
        )
        assign = np.argmin(d2, axis=1)
        base = len(self._assignments)
        self._values = np.concatenate([self._values, embs], axis=0)
        self._assignments = np.concatenate([self._assignments, assign])
        for i, c in enumerate(assign):
            self._ids[int(c)].append(base + i)
        self._n_valid = len(self._assignments)
        self._layout = None
        self._values_dev = None

    def search_batch_device(
        self, queries, top_k: int, nprobe: Optional[int] = None
    ):
        """Device-resident search: (dists (Q,k) f32, ids (Q,k) int32)
        jax arrays, no host transfer — the pipelined-serving path.

        ``nprobe=0`` (the config default) selects per-query adaptive
        probe depth — the batched analogue of the reference's cluster
        walk (`ivfflat.rs:166-195`): each query probes just enough
        nearest clusters for their min(size, top_k) contributions to
        reach top_k. The result is the exact top_k over those clusters'
        union (the walk's per-cluster truncation quirk is not
        reproduced here; recall is >= the walk's — see PARITY.md)."""
        layout = self._ensure_layout()
        qdev = as_query_matrix(queries)
        nprobe = nprobe if nprobe is not None else self.config.nprobe
        probes = None
        if nprobe == 0:
            # Worst-case depth must come from OCCUPIED sizes: after an
            # incremental add the layout is slacked and ``sizes_host``
            # holds per-bin CAPACITIES (ops/binned.slacken_layout), which
            # would understate the probes needed and silently drop recall.
            p_max = adaptive_probe_depth(
                layout.get("true_sizes_host", layout["sizes_host"]), top_k
            )
            probes = adaptive_probes(
                qdev, self._centroids_dev, layout["size"],
                layout["num_bins"], p_max, top_k,
            )
            nprobe = int(probes.shape[1])
        else:
            nprobe = max(1, min(nprobe, self.num_centroids))
        # dedup=False: every row lives in exactly ONE cluster and each
        # query's probe list is distinct clusters, so probe ranks cover
        # disjoint ids — the cross-probe duplicate mask is pure waste
        # (sentinel-gated adaptive ranks only contribute (inf, -1)
        # entries, dropped regardless)
        return binned_topk_fused(
            qdev, self._centroids_dev, nprobe, layout, top_k=top_k,
            precision=self.config.precision, probes=probes, dedup=False,
            engine=resolve_engine(self.config.engine, top_k),
        )

    def search_batch(
        self, queries, top_k: int, nprobe: Optional[int] = None
    ) -> SearchResult:
        dists, rows = self.search_batch_device(queries, top_k, nprobe)
        return SearchResult(
            ids=np.asarray(rows, dtype=np.int64), distances=np.asarray(dists)
        )

    def search_approximate(self, query, top_k: int) -> List[Tuple[int, float]]:
        """Behavioral parity with the adaptive cluster walk
        (`ivfflat.rs:153-198`): scan clusters nearest-first, take at most
        top_k from each, stop once top_k candidates are collected."""
        self._materialize_host()
        q = np.asarray(query, dtype=np.float32).reshape(-1)
        cd = np.sum((self._centroids - q[None, :]) ** 2, axis=1)
        nearest = np.argsort(cd, kind="stable")
        candidates: List[Tuple[int, float]] = []
        remainder = top_k
        for c in nearest:
            members = self._ids[int(c)]
            if members:
                m = np.asarray(members, dtype=np.int64)
                d2 = np.sum((self._values[m] - q[None, :]) ** 2, axis=1)
                o = np.argsort(d2, kind="stable")[:top_k]
                pc = [(int(m[i]), float(d2[i])) for i in o]
            else:
                pc = []
            if len(pc) < remainder:
                remainder -= len(pc)
                candidates.extend(pc)
            elif len(pc) > remainder:
                candidates.extend(pc[:remainder])
                break
            else:
                candidates.extend(pc)
                break
        return candidates

    # -- persistence (bincode parity: `ivfflat.rs:8-15` field order) ----

    def save_index(self, file_path: str) -> None:
        self._materialize_host()
        with open(file_path, "wb") as fp:
            w = Writer(fp)
            w.u64(self.num_centroids)
            w.vec_f32_matrix(self._values)
            w.vec_f32_matrix(self._centroids)
            w.vec_u64(self._assignments.astype(np.uint64))
            w.u64(len(self._ids))
            for cluster in self._ids:
                w.vec_u64(np.asarray(cluster, dtype=np.uint64))

    @classmethod
    def load_index(
        cls,
        file_path: str,
        dim: Optional[int] = None,
        config: IVFFlatConfig = IVFFlatConfig(),
    ) -> "IVFFlatIndex":
        if dim is None:
            # the file doesn't store dim (parity with the reference's
            # const-generic N, `base.rs:45-58`); solve it from the layout
            from vers_tpu.io.infer import infer_dim_ivfflat

            dim = infer_dim_ivfflat(file_path)
        with open(file_path, "rb") as fp:
            r = Reader(fp)
            num_centroids = r.u64()
            values = r.vec_f32_matrix(dim)
            centroids = r.vec_f32_matrix(dim)
            assignments = r.vec_u64().astype(np.int64)
            n_clusters = r.u64()
            ids = [r.vec_u64().astype(np.int64).tolist() for _ in range(n_clusters)]
        return cls(num_centroids, values, centroids, assignments, ids, config)
