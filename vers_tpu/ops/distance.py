"""Batched distance kernels (XLA path).

Batched replacement for the reference's scalar + hand-SIMD distance
functions (`vers/src/indexes/base.rs:119-293`): instead of one pair at a
time on 64-wide SIMD lanes, distances are computed for whole query ×
corpus blocks as matmuls.

Metric semantics match the reference exactly:

- ``sq_euclidean``: sum((a-b)^2)  (`base.rs:119-126`)
- ``cosine``: **cosine distance** ``1 - a.b`` assuming normalized inputs
  (`base.rs:153-156`; the reference's SIMD cosine ignores its
  ``normalized`` flag, `base.rs:158`). Range [0, 2], smaller is closer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 matmuls on the GPU default to reduced precision (TF32); distance
# parity with the scalar reference wants full f32.
_HIGHEST = jax.lax.Precision.HIGHEST


def pairwise_dot(q: jnp.ndarray, x: jnp.ndarray, precision=_HIGHEST) -> jnp.ndarray:
    """(Q, d) x (N, d) -> (Q, N) dot products as one matmul."""
    return jax.lax.dot_general(
        q,
        x,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )


def pairwise_sq_euclidean(q: jnp.ndarray, x: jnp.ndarray, precision=_HIGHEST) -> jnp.ndarray:
    """(Q, d) x (N, d) -> (Q, N) squared euclidean distances.

    Uses the |q|^2 + |x|^2 - 2 q.x expansion so the O(Q*N*d) work is a
    single matmul; clamped at 0 against cancellation.
    """
    qq = jnp.sum(q.astype(jnp.float32) ** 2, axis=-1, keepdims=True)
    xx = jnp.sum(x.astype(jnp.float32) ** 2, axis=-1)
    d2 = qq + xx[None, :] - 2.0 * pairwise_dot(q, x, precision)
    return jnp.maximum(d2, 0.0)


def pairwise_cosine_distance(q: jnp.ndarray, x: jnp.ndarray, precision=_HIGHEST) -> jnp.ndarray:
    """(Q, d) x (N, d) -> (Q, N) cosine distances ``1 - q.x`` for
    normalized inputs (parity with `base.rs:153-156`)."""
    return 1.0 - pairwise_dot(q, x, precision)


_METRICS = {
    "sq_euclidean": pairwise_sq_euclidean,
    "cosine": pairwise_cosine_distance,
}


def pairwise_distance(q: jnp.ndarray, x: jnp.ndarray, metric: str, precision=_HIGHEST) -> jnp.ndarray:
    try:
        fn = _METRICS[metric]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; expected one of {sorted(_METRICS)}")
    return fn(q, x, precision)
