import numpy as np
import jax.numpy as jnp
import pytest

from vers_tpu.ops.distance import (
    pairwise_cosine_distance,
    pairwise_sq_euclidean,
)
from vers_tpu.ops.topk import fused_scan_topk, topk_smallest


def _np_sq_euclidean(q, x):
    return ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)


def test_pairwise_sq_euclidean_matches_numpy(rng):
    q = rng.normal(size=(7, 19)).astype(np.float32)
    x = rng.normal(size=(23, 19)).astype(np.float32)
    got = np.asarray(pairwise_sq_euclidean(jnp.asarray(q), jnp.asarray(x)))
    np.testing.assert_allclose(got, _np_sq_euclidean(q, x), rtol=1e-4, atol=1e-4)


def test_pairwise_cosine_distance(rng):
    q = rng.normal(size=(4, 8)).astype(np.float32)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    got = np.asarray(pairwise_cosine_distance(jnp.asarray(q), jnp.asarray(x)))
    np.testing.assert_allclose(got, 1.0 - q @ x.T, rtol=1e-5, atol=1e-5)


def test_topk_smallest_orders_ascending(rng):
    d = rng.normal(size=(3, 50)).astype(np.float32)
    vals, idx = topk_smallest(jnp.asarray(d), 5)
    vals, idx = np.asarray(vals), np.asarray(idx)
    ref_idx = np.argsort(d, axis=1)[:, :5]
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(vals, np.take_along_axis(d, ref_idx, 1))


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("chunk", [16, 64, 1000])
def test_fused_scan_topk_exact(rng, metric, chunk):
    n, d, q_n, k = 237, 12, 9, 10
    x = rng.normal(size=(256, d)).astype(np.float32)  # padded corpus
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    dists, idx = fused_scan_topk(
        jnp.asarray(q), jnp.asarray(x), n, k, metric=metric, chunk_size=chunk
    )
    dists, idx = np.asarray(dists), np.asarray(idx)
    if metric == "sq_euclidean":
        full = _np_sq_euclidean(q, x[:n])
    else:
        full = 1.0 - q @ x[:n].T
    ref = np.argsort(full, axis=1, kind="stable")[:, :k]
    # compare sets (ties may reorder) and values
    for r in range(q_n):
        assert set(idx[r]) == set(ref[r])
    np.testing.assert_allclose(
        dists, np.sort(full, axis=1)[:, :k], rtol=1e-4, atol=1e-4
    )


def test_fused_scan_topk_k_exceeds_valid(rng):
    x = rng.normal(size=(8, 4)).astype(np.float32)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    dists, idx = fused_scan_topk(jnp.asarray(q), jnp.asarray(x), 3, 6)
    idx = np.asarray(idx)
    assert (idx[:, 3:] == -1).all()
    assert np.isinf(np.asarray(dists)[:, 3:]).all()
