import numpy as np
import jax.numpy as jnp

from vers_tpu.core import (
    VectorStore,
    bitwise_equal,
    deduplicate,
    normalize,
    normalize_np,
    pad_dim,
    pad_rows,
    round_up,
    to_hashkey,
)


def test_round_up():
    assert round_up(1, 128) == 128
    assert round_up(128, 128) == 128
    assert round_up(129, 128) == 256


def test_pad_rows_and_dim():
    x = jnp.ones((5, 3))
    p, n = pad_rows(x, 8)
    assert p.shape == (8, 3) and n == 5
    assert float(p[5:].sum()) == 0.0
    d = pad_dim(x, 4)
    assert d.shape == (5, 4)


def test_normalize_matches_reference_semantics():
    # magnitude < 1e-6 passes through unchanged (base.rs:99-105)
    x = np.array([[3.0, 4.0], [1e-8, 1e-8]], dtype=np.float32)
    out = np.asarray(normalize(x))
    np.testing.assert_allclose(out[0], [0.6, 0.8], rtol=1e-6)
    np.testing.assert_allclose(out[1], x[1], rtol=0)
    np.testing.assert_allclose(normalize_np(x), out, rtol=1e-6)


def test_hashkey_and_bitwise_equal():
    a = np.array([[1.0, -0.0]], dtype=np.float32)
    b = np.array([[1.0, 0.0]], dtype=np.float32)
    # -0.0 and 0.0 differ bitwise — the reference's HashKey would too
    assert not bool(bitwise_equal(jnp.asarray(a), jnp.asarray(b)))
    assert bool(bitwise_equal(jnp.asarray(a), jnp.asarray(a.copy())))
    assert to_hashkey(a).dtype == np.uint32


def test_deduplicate_keeps_first():
    v = np.array([[1, 2], [3, 4], [1, 2], [5, 6]], dtype=np.float32)
    ids = np.array([10, 11, 12, 13])
    dv, di = deduplicate(v, ids)
    assert dv.shape == (3, 2)
    assert list(di) == [10, 11, 13]


def test_vector_store_append_and_grow():
    vs = VectorStore(np.ones((3, 4), np.float32), capacity=3)
    assert vs.count == 3
    start_cap = vs.capacity
    for i in range(start_cap + 1):
        vs.append(np.full(4, float(i)))
    assert vs.count == 3 + start_cap + 1
    assert vs.capacity >= vs.count
    rows = vs.rows()
    assert rows.shape == (vs.count, 4)
    np.testing.assert_allclose(rows[3], 0.0)


def test_deterministic_builds():
    """Pinned seeds -> bitwise-identical IVF centroids and identical
    LSH leaf assignments across two builds (the reproducibility story
    replacing the reference's unseeded thread_rng, PARITY.md D1)."""
    from vers_tpu.index.ivfflat import IVFFlatIndex
    from vers_tpu.index.lsh import ANNIndex

    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    a = IVFFlatIndex.build_index(4, 2, 5, x)
    b = IVFFlatIndex.build_index(4, 2, 5, x)
    assert (to_hashkey(a._centroids) == to_hashkey(b._centroids)).all()
    np.testing.assert_array_equal(a._assignments, b._assignments)

    ta = ANNIndex.build_index(2, 16, x, np.arange(300))
    tb = ANNIndex.build_index(2, 16, x, np.arange(300))
    for t1, t2 in zip(ta._trees, tb._trees):
        np.testing.assert_array_equal(t1.leaf_of_vec, t2.leaf_of_vec)
