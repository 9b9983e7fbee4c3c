"""Candidate / result data models.

Host-side mirrors of the reference's heap types
(`vers/src/indexes/models.rs:9-153`). On the device there are no heaps — the
device-side equivalents are fixed-size sorted (k,) arrays produced by
``lax.top_k`` — but these types are still needed for:

- the HNSW adjacency state during host-side graph construction
  (``AdjacencyItem``: max-heap + neighbour set, `models.rs:63-112`),
- the bincode-compatible serialization of HNSW layers
  (``AdjacencyItemSer`` layout: sorted heap vec + neighbour vec,
  `models.rs:114-153`),
- ergonomic search results.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, List, Tuple

import numpy as np


@dataclasses.dataclass
class DistanceCandidatePair:
    """(`models.rs:16-20`) — equality/hash by id, order by distance."""

    candidate_id: int
    distance: float

    def __hash__(self):  # parity with `models.rs:37-41`
        return hash(self.candidate_id)

    def __eq__(self, other):  # parity with `models.rs:45-49`
        return isinstance(other, DistanceCandidatePair) and (
            self.candidate_id == other.candidate_id
        )

    def __lt__(self, other):
        return self.distance < other.distance


class AdjacencyItem:
    """A node's neighbourhood: max-heap over (distance, id) plus a
    neighbour id set (parity with `models.rs:63-112`).

    Python's heapq is a min-heap; we store negated distances to get the
    reference's max-heap ("largest distance on top") semantics.
    """

    __slots__ = ("_heap", "neighbours", "_ctr")

    def __init__(self):
        self._heap: List[Tuple[float, int, int]] = []  # (-dist, tie, id)
        self.neighbours: set[int] = set()
        self._ctr = 0

    def insert(self, candidate_id: int, distance: float) -> None:
        self.neighbours.add(candidate_id)
        # tie counter keeps heap pops deterministic for equal distances
        heapq.heappush(self._heap, (-float(distance), self._ctr, int(candidate_id)))
        self._ctr += 1

    def __len__(self) -> int:  # parity with `models.rs:88-90`
        return len(self.neighbours)

    def trim(self, max_neighbours: int) -> None:
        """Drop largest-distance entries until <= max (`models.rs:92-98`)."""
        while len(self._heap) > max_neighbours:
            _, _, cid = heapq.heappop(self._heap)
            self.neighbours.discard(cid)

    def max_distance(self) -> float:
        return -self._heap[0][0]

    def consume_heap_to_vec(self) -> List[DistanceCandidatePair]:
        """Pop everything, max-distance first (descending), parity with
        `models.rs:104-111`. Empties the heap."""
        out = []
        while self._heap:
            nd, _, cid = heapq.heappop(self._heap)
            out.append(DistanceCandidatePair(cid, -nd))
        self.neighbours = set()
        return out

    def items_sorted_ascending(self) -> List[DistanceCandidatePair]:
        """Non-destructive ascending view — the serialization order used
        by ``BinaryHeap::into_sorted_vec`` (`models.rs:120`)."""
        return [
            DistanceCandidatePair(cid, -nd)
            for nd, _, cid in sorted(self._heap, reverse=True)
        ]

    @classmethod
    def create_from_pairs(cls, pairs: Iterable[DistanceCandidatePair]) -> "AdjacencyItem":
        item = cls()
        for p in pairs:
            item.insert(p.candidate_id, p.distance)
        return item


@dataclasses.dataclass
class SearchResult:
    """Batched search results: ids (Q, k) int64 (-1 = missing), distances
    (Q, k) f32 (+inf = missing)."""

    ids: np.ndarray
    distances: np.ndarray

    def to_pairs(self, row: int = 0) -> List[Tuple[int, float]]:
        """Row as the reference's Vec<(usize, f32)> return shape,
        missing entries dropped."""
        ids = self.ids[row]
        dists = self.distances[row]
        return [
            (int(i), float(d)) for i, d in zip(ids, dists) if i >= 0 and np.isfinite(d)
        ]
