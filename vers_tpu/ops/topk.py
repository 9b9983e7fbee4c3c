"""Top-k selection and the fused distance+top-k corpus scan (XLA path).

The reference's heaps (`vers/src/indexes/models.rs:63-112`) and
sort-and-take pipelines (`ivfflat.rs:172-178`, `utils.rs:68-82`) become
``lax.top_k`` over fixed-size arrays.

``fused_scan_topk`` is the exact flat search: it streams the corpus
through the distance matmul in chunks and carries a running (Q, k) best
set, so the full (Q, N) distance matrix is never materialized — the
batched analogue of the reference's streaming SIMD scans.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vers_tpu.ops.distance import pairwise_distance

_HIGHEST = jax.lax.Precision.HIGHEST


def topk_smallest(dist: jnp.ndarray, k: int):
    """Smallest-k along the last axis. Returns (values, indices),
    ascending by distance (ties: lowest index first, matching the
    reference's stable sorts)."""
    if k == 1:
        # argmin reduction instead of a top-k sort network: same
        # first-lowest-index tie rule, measurably cheaper at the IVF
        # nprobe=1 probe (Q, 256) and single-expand beam picks
        idx = jnp.argmin(dist, axis=-1).astype(jnp.int32)[..., None]
        return jnp.take_along_axis(dist, idx, axis=-1), idx
    neg, idx = jax.lax.top_k(-dist, k)
    return -neg, idx


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "chunk_size", "precision")
)
def fused_scan_topk(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    n_valid,
    k: int,
    metric: str = "sq_euclidean",
    chunk_size: int = 16384,
    precision=_HIGHEST,
):
    """Exact top-k nearest corpus rows for each query, O(Q*k + chunk)
    memory.

    Args:
      queries: (Q, d)
      corpus: (N_pad, d) — rows >= n_valid are padding and are ignored.
      n_valid: number of live corpus rows (may be traced).
      k: neighbours per query (static).
      metric: "sq_euclidean" | "cosine".
      chunk_size: corpus rows per scan step (static).

    Returns:
      (dists (Q, k), indices (Q, k) int32), ascending by distance.
      If k > n_valid the tail is (+inf, -1) — callers slice/filter.
    """
    n_pad, d = corpus.shape
    q = queries.shape[0]
    chunk_size = min(chunk_size, n_pad)
    # Corpus must tile exactly; pad with zero rows (masked below).
    rem = (-n_pad) % chunk_size
    if rem:
        corpus = jnp.pad(corpus, ((0, rem), (0, 0)))
        n_pad += rem
    n_chunks = n_pad // chunk_size
    chunks = corpus.reshape(n_chunks, chunk_size, d)

    init_d = jnp.full((q, k), jnp.inf, dtype=jnp.float32)
    init_i = jnp.full((q, k), -1, dtype=jnp.int32)

    row_in_chunk = jnp.arange(chunk_size, dtype=jnp.int32)

    def step(carry, inp):
        best_d, best_i = carry
        chunk_idx, chunk = inp
        dist = pairwise_distance(queries, chunk, metric, precision)
        rows = chunk_idx * chunk_size + row_in_chunk
        dist = jnp.where(rows[None, :] < n_valid, dist, jnp.inf)
        cand_d = jnp.concatenate([best_d, dist], axis=1)
        cand_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(rows[None, :], dist.shape)], axis=1
        )
        new_d, sel = topk_smallest(cand_d, k)
        new_i = jnp.take_along_axis(cand_i, sel, axis=1)
        new_i = jnp.where(jnp.isfinite(new_d), new_i, -1)
        return (new_d, new_i), None

    (best_d, best_i), _ = jax.lax.scan(
        step,
        (init_d, init_i),
        (jnp.arange(n_chunks, dtype=jnp.int32), chunks),
    )
    return best_d, best_i
