"""Exact brute-force index — the reference's ``search_exhaustive``
baseline (`vers/src/utils.rs:68-82`) promoted to a first-class index.

Exact search over ~1M vectors is a single fused distance-matmul +
streaming top-k scan (`ops/topk.fused_scan_topk`) and is the parity
anchor every approximate index is measured against. This is the
"minimum end-to-end slice" of SURVEY.md §7.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from vers_tpu.config import FlatConfig
from vers_tpu.core import VectorStore, as_query_matrix
from vers_tpu.index.base import Index
from vers_tpu.io.bincode import Reader, Writer
from vers_tpu.models.candidates import SearchResult
from vers_tpu.ops.topk import fused_scan_topk


class FlatIndex(Index):
    def __init__(
        self,
        vectors,
        ids=None,
        config: FlatConfig = FlatConfig(),
    ):
        vectors = np.asarray(vectors, dtype=np.float32)
        self.config = config
        self._store = VectorStore(vectors, dtype=jnp.dtype(config.dtype))
        n = vectors.shape[0]
        self._ids = np.asarray(
            ids if ids is not None else np.arange(n), dtype=np.int64
        )
        if self._ids.shape[0] != n:
            raise ValueError("ids length must match vectors")
        self.dim = vectors.shape[1]

    @classmethod
    def build_index(cls, vectors, ids=None, config: FlatConfig = FlatConfig()):
        return cls(vectors, ids=ids, config=config)

    # -- Index API ----------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        self._store.append(embedding)
        self._ids = np.append(self._ids, np.int64(vec_id))

    def search_batch_device(self, queries, top_k: int):
        """Device-resident search: returns (dists (Q,top_k) f32, rows
        (Q,top_k) int32) as jax arrays, rows being corpus positions
        (== external ids unless custom ids were supplied). Always
        exactly top_k columns — when the corpus is smaller than top_k
        the tail is (inf, -1) padded, matching the other indexes'
        device-path contract. No host transfer — the throughput path
        for pipelined serving."""
        queries = as_query_matrix(queries)
        k_eff = max(1, min(top_k, self._store.capacity))
        dists, rows = fused_scan_topk(
            queries,
            self._store.data,
            self._store.count,
            k_eff,
            metric=self.config.metric,
            chunk_size=self.config.chunk_size,
        )
        if k_eff < top_k:
            pad = top_k - k_eff
            dists = jnp.pad(dists, ((0, 0), (0, pad)), constant_values=jnp.inf)
            rows = jnp.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
        return dists, rows

    def search_batch(self, queries, top_k: int) -> SearchResult:
        dists, rows = self.search_batch_device(queries, top_k)
        dists = np.asarray(dists)
        rows = np.asarray(rows)
        ids = np.where(rows >= 0, self._ids[np.clip(rows, 0, len(self._ids) - 1)], -1)
        return SearchResult(ids=ids, distances=dists)

    # -- persistence (vers_tpu extension format; the reference has no
    #    flat index). bincode-style: values Vec<Vector<N>>, ids Vec<u64>.

    def save_index(self, file_path: str) -> None:
        with open(file_path, "wb") as fp:
            w = Writer(fp)
            w.vec_f32_matrix(self._store.rows())
            w.vec_u64(self._ids.astype(np.uint64))

    @classmethod
    def load_index(cls, file_path: str, dim: Optional[int] = None, config: FlatConfig = FlatConfig()):
        if dim is None:
            # the file doesn't store dim (parity with the reference's
            # const-generic N, `base.rs:45-58`); solve it from the layout
            from vers_tpu.io.infer import infer_dim_flat

            dim = infer_dim_flat(file_path)
        with open(file_path, "rb") as fp:
            r = Reader(fp)
            values = r.vec_f32_matrix(dim)
            ids = r.vec_u64().astype(np.int64)
        return cls(values, ids=ids, config=config)
