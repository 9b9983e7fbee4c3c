import numpy as np
import jax.numpy as jnp
import pytest

from vers_tpu.ops import rpforest
from vers_tpu.ops.beam import beam_search_layer
from vers_tpu.core import round_up


def _knn_graph(vecs, deg):
    """Navigable graph: each node links to its deg nearest (+ ring edge
    for connectivity)."""
    n = vecs.shape[0]
    sims = vecs @ vecs.T
    np.fill_diagonal(sims, -np.inf)
    nn = np.argsort(-sims, axis=1)[:, : deg - 1].astype(np.int32)
    ring = ((np.arange(n) + 1) % n).astype(np.int32)[:, None]
    return np.concatenate([nn, ring], axis=1)


def test_beam_expand_variants_agree(rng):
    n, d = 256, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    adj = _knn_graph(vecs, 8)
    q = vecs[rng.integers(0, n, size=20)]
    truth = np.argsort(-(q @ vecs.T), axis=1)[:, :10]
    entry = jnp.zeros((20,), jnp.int32)
    args = (jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(adj), entry)
    from vers_tpu.utils.harness import recall_at_k

    for e in (1, 4):
        dd, ii = beam_search_layer(
            *args, ef=16, max_steps=512, expand_per_step=e
        )
        ii = np.asarray(ii)
        rec = recall_at_k(ii[:, :10], truth)
        assert rec > 0.9, (e, rec)
        # ascending distances, no duplicates in any beam
        dd = np.asarray(dd)
        assert (np.diff(dd, axis=1) >= -1e-6).all()
        for row in ii:
            live = row[row >= 0]
            assert len(set(live)) == len(live)


def test_descend_forest_multiprobe(rng):
    n, d = 512, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    import jax

    n_pad = round_up(n, 128)
    data = jnp.asarray(np.pad(x, ((0, n_pad - n), (0, 0))))
    tables = rpforest.build_tree(jax.random.PRNGKey(0), data, n, 32, 8)
    coeffs = jnp.asarray(np.asarray(tables.coeff))[None]
    consts = jnp.asarray(np.asarray(tables.const))[None]
    splits = jnp.asarray(np.asarray(tables.split))[None]
    buckets = jnp.asarray(np.asarray(tables.bucket))[None]
    offsets = jnp.asarray(np.zeros(1, np.int32))

    q = jnp.asarray(x[:40])
    p1 = np.asarray(
        rpforest.descend_forest(q, coeffs, consts, splits, buckets, offsets, 1)
    )
    p3 = np.asarray(
        rpforest.descend_forest(q, coeffs, consts, splits, buckets, offsets, 3)
    )
    assert p1.shape == (40, 1) and p3.shape == (40, 3)
    # probe 0 is the main leaf in both
    np.testing.assert_array_equal(p1[:, 0], p3[:, 0])
    # corpus points land in their own leaf
    leaf = np.asarray(tables.leaf_of_vec)[:40]
    np.testing.assert_array_equal(p1[:, 0], leaf)
    # sibling probes differ from the main leaf for most queries
    assert (p3[:, 1] != p3[:, 0]).mean() > 0.8
    # multiprobe recall: the flipped leaves are valid bucket ids
    assert (p3 >= 0).all()


def test_descend_forest_flat_matches_dense(rng):
    """The packed hyperplane layout (descend_forest_flat, r5 — the
    dense (T, L, TC, d) tables were ~95% padding at 1M x 16 trees)
    routes every (query, probe) to the SAME bin as the dense
    path, including multiprobe flips."""
    import jax

    from vers_tpu.index.lsh import ANNIndex

    n, d = 900, 20
    x = rng.normal(size=(n, d)).astype(np.float32)
    idx = ANNIndex.build_index(3, 24, x, np.arange(n))
    # exercise the host insert path too (slot growth keeps contiguity)
    for j in range(40):
        idx.add(x[j] * 0.98 + 0.02, n + j)
    coeffs, consts, splits, buckets = idx._stacked_descent_tables()
    cf, cn, cb, sp2, bk2 = idx._flat_descent_tables()
    np.testing.assert_array_equal(sp2, splits)
    from vers_tpu.ops.forest_shared import shared_tree_tables

    tt = shared_tree_tables(
        [tr.leaf_of_vec for tr in idx._trees],
        [tr.num_buckets for tr in idx._trees], 256,
    )
    offsets = jnp.asarray(tt["offsets"])
    q = jnp.asarray(x[:64])
    for p in (1, 3):
        dense = np.asarray(rpforest.descend_forest(
            q, jnp.asarray(coeffs), jnp.asarray(consts),
            jnp.asarray(splits), jnp.asarray(buckets), offsets, p,
        ))
        flat = np.asarray(rpforest.descend_forest_flat(
            q, jnp.asarray(cf), jnp.asarray(cn), jnp.asarray(cb),
            jnp.asarray(sp2), jnp.asarray(bk2), offsets, p,
        ))
        np.testing.assert_array_equal(dense, flat)
