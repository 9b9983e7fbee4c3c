import numpy as np
import jax
import jax.numpy as jnp

from vers_tpu.ops import kmeans as km


def _pad(x, m=128):
    n = x.shape[0]
    np_ = ((n + m - 1) // m) * m
    return jnp.asarray(np.pad(x, ((0, np_ - n), (0, 0)))), n


def test_partial_sums_matches_numpy(rng):
    x = rng.normal(size=(200, 6)).astype(np.float32)
    c = rng.normal(size=(4, 6)).astype(np.float32)
    data, n = _pad(x)
    sums, counts, cost = km.partial_sums(data, n, jnp.asarray(c), chunk_size=64)
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    assign = d2.argmin(1)
    ref_sums = np.zeros((4, 6), np.float32)
    np.add.at(ref_sums, assign, x)
    ref_counts = np.bincount(assign, minlength=4)
    # the Lloyd pass runs its matmuls at reduced precision (bf16 sums,
    # f32 accumulation) — sums/cost are approximate by design
    np.testing.assert_allclose(np.asarray(sums), ref_sums, rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(np.asarray(counts), ref_counts)
    np.testing.assert_allclose(float(cost), d2.min(1).sum(), rtol=1e-2)


def test_centroids_from_sums_empty_cluster_is_zero():
    sums = jnp.asarray([[2.0, 4.0], [5.0, 5.0]])
    counts = jnp.asarray([2.0, 0.0])
    c = np.asarray(km.centroids_from_sums(sums, counts))
    np.testing.assert_allclose(c[0], [1.0, 2.0])
    np.testing.assert_allclose(c[1], [0.0, 0.0])  # parity ivfflat.rs:63-67


def test_build_kmeans_converges_separated_clusters(rng):
    # two well-separated blobs -> centroids land near blob means
    a = rng.normal(size=(100, 4)).astype(np.float32) + 20.0
    b = rng.normal(size=(100, 4)).astype(np.float32) - 20.0
    x = np.concatenate([a, b])
    data, n = _pad(x)
    key = jax.random.PRNGKey(0)
    centroids, cost = km.build_kmeans(key, data, n, 2, 20, chunk_size=64)
    centroids = np.asarray(centroids)
    means = sorted([a.mean(0).mean(), b.mean(0).mean()])
    got = sorted(centroids.mean(1).tolist())
    np.testing.assert_allclose(got, means, atol=1.0)
    assert float(cost) < 2 * n * 4  # within-blob variance only


def test_restarts_pick_best(rng):
    x = rng.normal(size=(150, 4)).astype(np.float32)
    data, n = _pad(x)
    key = jax.random.PRNGKey(1)
    c1, cost1 = km.build_kmeans_restarts(key, data, n, 8, 1, 10, chunk_size=64)
    c5, cost5 = km.build_kmeans_restarts(key, data, n, 8, 5, 10, chunk_size=64)
    assert float(cost5) <= float(cost1) + 1e-3


def test_assign_clusters(rng):
    x = rng.normal(size=(100, 4)).astype(np.float32)
    c = rng.normal(size=(3, 4)).astype(np.float32)
    data, n = _pad(x)
    assign = np.asarray(km.assign_clusters(data, n, jnp.asarray(c)))[:n]
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(assign, d2.argmin(1))
