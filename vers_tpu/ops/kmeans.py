"""Jitted Lloyd k-means — the build kernel behind IVFFlat.

Batched re-expression of `vers/src/indexes/ivfflat.rs:18-149`:

- assignment (`assign_to_clusters`, rayon par_iter over rows) becomes a
  chunked (n, k) distance matmul + argmin,
- centroid update (`update_centroids`) becomes a one-hot matmul
  (a matmul segment-sum); empty clusters become zero vectors
  (parity with `ivfflat.rs:63-67`),
- the convergence test is bitwise equality of centroid arrays
  (parity with the HashKey comparison, `ivfflat.rs:84-93`),
- assignment + update are fused in ONE streaming pass over the corpus,
  so the (n, k) distance matrix never sits in device memory whole,
- the whole Lloyd loop runs under `lax.while_loop` on-device,
- random restarts (`build_index`'s num_attempts, `ivfflat.rs:111-121`)
  are vmapped into a batch dimension over centroid sets.

All functions are shard-friendly: `lloyd_step` only needs per-shard
partial (sums, counts); `vers_tpu.parallel.kmeans` wraps it in
shard_map with a psum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vers_tpu.core import bitwise_equal
from vers_tpu.ops.distance import pairwise_sq_euclidean

_HIGHEST = jax.lax.Precision.HIGHEST


def init_centroids(key, data: jnp.ndarray, n_valid, k: int) -> jnp.ndarray:
    """k centroids drawn as random data rows, with replacement (parity
    with `ivfflat.rs:18-27`, which draws gen_range per centroid and can
    repeat)."""
    idx = jax.random.randint(key, (k,), 0, n_valid)
    return jnp.take(data, idx, axis=0)


def _chunk(data: jnp.ndarray, chunk_size: int):
    n_pad, d = data.shape
    chunk_size = min(chunk_size, n_pad)
    rem = (-n_pad) % chunk_size
    if rem:
        data = jnp.pad(data, ((0, rem), (0, 0)))
    return data.reshape(-1, chunk_size, d), chunk_size


def partial_sums(
    data: jnp.ndarray,
    n_valid,
    centroids: jnp.ndarray,
    chunk_size: int = 65536,
):
    """One fused assignment+accumulation pass.

    Returns (sums (k, d), counts (k,), cost scalar): per-cluster vector
    sums, member counts, and total squared-euclidean cost — everything
    a Lloyd update (and the restart scoring, `ivfflat.rs:138-149`)
    needs. Padding rows (>= n_valid) contribute nothing.
    """
    k, d = centroids.shape
    chunks, chunk_size = _chunk(data, chunk_size)
    n_chunks = chunks.shape[0]
    row_in_chunk = jnp.arange(chunk_size, dtype=jnp.int32)

    def step(carry, inp):
        sums, counts, cost = carry
        chunk_idx, chunk = inp
        # assignment only needs the argmin ranking: DEFAULT precision
        # lets the card use its tensor cores (TF32 on an f32 corpus).
        # The reference's exact-f32 SIMD loop has no bitwise-parity
        # contract here — k-means is seeded randomly — and the final
        # assignment (`assign_clusters`) is exact f32.
        dist = pairwise_sq_euclidean(
            chunk, centroids, precision=jax.lax.Precision.DEFAULT
        )  # (C, k)
        assign = jnp.argmin(dist, axis=1)
        rows = chunk_idx * chunk_size + row_in_chunk
        valid = rows < n_valid
        # segment-sum as a bf16 one-hot matmul with f32 accumulation
        # (half the bytes of an f32 one-hot): the one-hot is exact in
        # bf16, the rows round to bf16 before they are summed, and the
        # centroid is a mean over its members
        onehot = (
            (assign[:, None] == jnp.arange(k, dtype=jnp.int32)[None, :])
            & valid[:, None]
        ).astype(jnp.bfloat16)  # (C, k)
        sums = sums + jax.lax.dot_general(
            onehot,
            chunk.astype(jnp.bfloat16),
            dimension_numbers=(((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32,
        )
        counts = counts + jnp.sum(onehot.astype(jnp.float32), axis=0)
        best = jnp.min(dist, axis=1)
        cost = cost + jnp.sum(jnp.where(valid, best, 0.0))
        return (sums, counts, cost), None

    init = (
        jnp.zeros((k, d), jnp.float32),
        jnp.zeros((k,), jnp.float32),
        jnp.array(0.0, jnp.float32),
    )
    (sums, counts, cost), _ = jax.lax.scan(
        step, init, (jnp.arange(n_chunks, dtype=jnp.int32), chunks)
    )
    return sums, counts, cost


def centroids_from_sums(sums: jnp.ndarray, counts: jnp.ndarray) -> jnp.ndarray:
    """Mean per cluster; empty cluster -> zero vector (parity with
    `ivfflat.rs:63-67`)."""
    safe = jnp.maximum(counts, 1.0)
    means = sums / safe[:, None]
    return jnp.where(counts[:, None] > 0.0, means, 0.0)


def lloyd_step(data, n_valid, centroids, chunk_size: int = 65536):
    """One Lloyd iteration: returns (new_centroids, cost_of_old)."""
    sums, counts, cost = partial_sums(data, n_valid, centroids, chunk_size)
    return centroids_from_sums(sums, counts), cost


@functools.partial(
    jax.jit, static_argnames=("k", "max_iterations", "chunk_size")
)
def build_kmeans(
    key,
    data: jnp.ndarray,
    n_valid,
    k: int,
    max_iterations: int,
    chunk_size: int = 65536,
):
    """Full Lloyd run (parity with `build_kmeans`, `ivfflat.rs:73-100`):
    random-row init, iterate until bitwise-stable centroids or
    max_iterations. Returns (centroids (k, d), cost)."""
    centroids0 = init_centroids(key, data, n_valid, k)

    def cond(state):
        i, _, converged = state
        return jnp.logical_and(i < max_iterations, jnp.logical_not(converged))

    def body(state):
        i, centroids, _ = state
        new_centroids, _ = lloyd_step(data, n_valid, centroids, chunk_size)
        converged = bitwise_equal(centroids, new_centroids)
        # Parity with `ivfflat.rs:91-95`: on convergence the reference
        # breaks *before* adopting new_centroids — they are bitwise
        # identical anyway, so adopting is equivalent.
        return i + 1, new_centroids, converged

    _, centroids, _ = jax.lax.while_loop(
        cond, body, (jnp.array(0, jnp.int32), centroids0, jnp.array(False))
    )
    # Cost of the final centroids, for restart selection.
    _, _, cost = partial_sums(data, n_valid, centroids, chunk_size)
    return centroids, cost


def build_kmeans_restarts(
    key,
    data: jnp.ndarray,
    n_valid,
    k: int,
    num_attempts: int,
    max_iterations: int,
    chunk_size: int = 65536,
):
    """Best-of-N restarts by cost (parity with `build_index`'s attempt
    loop, `ivfflat.rs:111-121`), vmapped so all attempts run batched.
    Returns (best_centroids, best_cost)."""
    keys = jax.random.split(key, num_attempts)
    centroids, costs = jax.vmap(
        lambda kk: build_kmeans(kk, data, n_valid, k, max_iterations, chunk_size)
    )(keys)
    best = jnp.argmin(costs)
    return centroids[best], costs[best]


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def assign_clusters(data, n_valid, centroids, chunk_size: int = 65536):
    """Final assignment pass (parity with `ivfflat.rs:98`): (n_pad,)
    int32 cluster ids; padding rows get cluster 0 but callers mask by
    n_valid."""
    chunks, chunk_size = _chunk(data, chunk_size)

    def step(_, chunk):
        dist = pairwise_sq_euclidean(chunk, centroids)
        return None, jnp.argmin(dist, axis=1).astype(jnp.int32)

    _, assigns = jax.lax.scan(step, None, chunks)
    return assigns.reshape(-1)[: data.shape[0]]
