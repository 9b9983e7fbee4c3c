"""The ``Index`` protocol — the reference's trait surface
(`vers/src/indexes/base.rs:27-59`) plus the batched device entry points.

Reference API (kept verbatim):
  - ``add(embedding, vec_id)``
  - ``search_approximate(query, top_k) -> [(id, distance), ...]``
  - ``save_index(path)`` / ``load_index(path)``

Batched additions (the throughput path — single-query search cannot
fill an accelerator):
  - ``search_batch(queries, top_k) -> SearchResult`` over (Q, d).

Persistence is bincode-1.3-compatible with the reference
(`base.rs:31-58` serializes the whole struct with bincode through
buffered file IO), so index files round-trip between implementations.
"""

from __future__ import annotations

import abc
from typing import List, Optional, Tuple

import numpy as np

from vers_tpu.models.candidates import SearchResult


class Index(abc.ABC):
    """Abstract index. Subclasses: FlatIndex, IVFFlatIndex, ANNIndex
    (RP-forest "LSH"), HNSWIndex."""

    #: feature dimension
    dim: int

    @abc.abstractmethod
    def add(self, embedding, vec_id: int) -> None:
        """Insert one embedding under ``vec_id``."""

    def add_batch(self, embeddings, vec_ids) -> None:
        """Bulk insert (one layout rebuild instead of per-add
        invalidation). Default: loop over ``add``; indexes override
        where a vectorized path exists."""
        embeddings = np.asarray(embeddings, dtype=np.float32)
        for emb, vid in zip(embeddings, np.asarray(vec_ids)):
            self.add(emb, int(vid))

    @abc.abstractmethod
    def search_batch(self, queries, top_k: int) -> SearchResult:
        """Approximate top-k for a (Q, d) batch of queries."""

    def search_approximate(self, query, top_k: int) -> List[Tuple[int, float]]:
        """Single-query parity API (`base.rs:29`): returns
        [(vec_id, distance)] ascending by distance."""
        q = np.asarray(query, dtype=np.float32).reshape(1, -1)
        return self.search_batch(q, top_k).to_pairs(0)

    # -- persistence -------------------------------------------------

    @abc.abstractmethod
    def save_index(self, file_path: str) -> None:
        """Serialize to the reference's bincode on-disk layout."""

    @classmethod
    @abc.abstractmethod
    def load_index(cls, file_path: str, dim: Optional[int] = None) -> "Index":
        """Load an index file (ours or one written by the Rust
        reference). ``dim`` plays the role of the reference's const
        generic N — required because the formats don't self-describe
        the feature dimension."""
