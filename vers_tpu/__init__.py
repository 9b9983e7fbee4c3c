"""vers_tpu — a vector index & search engine in JAX, run on NVIDIA GPUs.

A from-scratch rebuild of the capabilities of `ashrielbrian/vers` (a Rust
in-memory vector database with IVFFlat / LSH (RP-forest) / HNSW indexes,
see reference `vers/src/lib.rs`) designed for an accelerator:

- embeddings live as padded ``(n, d)`` device arrays,
- all distance work is batched matmuls (XLA), with a Pallas packed-scan
  kernel (Triton route) on the IVF and forest hot path,
- k-means build is jitted Lloyd iterations (``lax.while_loop``),
- the RP-forest is level-synchronous batched hyperplane projections,
- HNSW queries run as a batched beam scan over a padded adjacency matrix,
- multi-chip scale-out uses ``jax.sharding.Mesh`` + ``shard_map`` with
  ``psum`` / ``all_gather`` collectives between cards.

The public API mirrors the reference's ``Index`` trait
(`vers/src/indexes/base.rs:27-59`): ``add``, ``search_approximate``,
``save_index``, ``load_index`` — plus batched variants that are the
device throughput path. On-disk formats are bincode-1.3-compatible with the
reference so index files interoperate.
"""

from vers_tpu.version import __version__
from vers_tpu.config import (
    FlatConfig,
    HNSWConfig,
    IVFFlatConfig,
    LSHConfig,
)
from vers_tpu.index.base import Index
from vers_tpu.index.flat import FlatIndex
from vers_tpu.index.ivfflat import IVFFlatIndex
from vers_tpu.index.lsh import ANNIndex
from vers_tpu.index.hnsw import HNSWIndex
from vers_tpu.utils.data import load_wiki_vector, load_vec_file
from vers_tpu.utils.harness import search_exhaustive, recall_at_k


def __getattr__(name):
    # heavier multi-chip classes load lazily (they import shard_map)
    if name == "ShardedFlatIndex":
        from vers_tpu.parallel.sharded_index import ShardedFlatIndex

        return ShardedFlatIndex
    if name == "ShardedIVFFlatIndex":
        from vers_tpu.parallel.ivf import ShardedIVFFlatIndex

        return ShardedIVFFlatIndex
    if name == "ShardedHNSWIndex":
        from vers_tpu.parallel.hnsw import ShardedHNSWIndex

        return ShardedHNSWIndex
    if name == "PartitionedHNSWIndex":
        from vers_tpu.parallel.hnsw_partitioned import PartitionedHNSWIndex

        return PartitionedHNSWIndex
    if name == "PartitionedANNIndex":
        from vers_tpu.parallel.lsh_partitioned import PartitionedANNIndex

        return PartitionedANNIndex
    if name == "ShardedANNIndex":
        from vers_tpu.parallel.lsh import ShardedANNIndex

        return ShardedANNIndex
    raise AttributeError(f"module 'vers_tpu' has no attribute {name!r}")

# The reference README's intended Python API (README.md:83-97):
# vers.load_wiki(), vers.HNSW(...), .build_index(...), .search(...)
# — implemented for real in vers_tpu.compat (the reference's PyO3
# crate documents but does not ship this surface).
from vers_tpu.compat import HNSW, IVFFlat, LSH, Embeddings, load_wiki

__all__ = [
    "__version__",
    "Index",
    "FlatIndex",
    "IVFFlatIndex",
    "ANNIndex",
    "HNSWIndex",
    "HNSW",
    "LSH",
    "IVFFlat",
    "FlatConfig",
    "IVFFlatConfig",
    "LSHConfig",
    "HNSWConfig",
    "Embeddings",
    "load_wiki",
    "load_wiki_vector",
    "load_vec_file",
    "search_exhaustive",
    "recall_at_k",
]
