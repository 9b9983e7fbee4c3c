"""Single-dispatch fused binned search vs the two-dispatch reference
path: identical results on every shape (including skewed bins, bins
with more queries than q_blk, empty bins, and non-multiple sizes)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vers_tpu.ops import binned


@pytest.mark.parametrize(
    "n,d,k,q_n,nprobe,skew",
    [
        (5000, 32, 16, 256, 1, False),
        (5000, 32, 16, 1000, 4, False),
        (3000, 48, 64, 512, 2, True),
        (997, 16, 7, 33, 3, True),
        (512, 8, 4, 2000, 1, True),  # one bin gets >> q_blk queries
    ],
)
def test_fused_matches_shared(n, d, k, q_n, nprobe, skew):
    rng = np.random.default_rng(42)
    x = rng.normal(size=(n, d)).astype(np.float32)
    bins = (
        (rng.random(n) ** 3 * k).astype(np.int64)
        if skew
        else rng.integers(0, k, n)
    )
    layout = binned.make_layout(x, bins, k)
    cents = jnp.asarray(rng.normal(size=(k, d)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(q_n, d)).astype(np.float32))
    d1, i1 = binned.binned_topk_shared(q, cents, nprobe, layout, top_k=10)
    d2, i2 = binned.binned_topk_fused(q, cents, nprobe, layout, top_k=10)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(
        np.asarray(d1), np.asarray(d2), rtol=1e-5, atol=1e-5
    )


def test_fused_probes_given_matches_shared():
    rng = np.random.default_rng(7)
    n, d, k, q_n, p = 2000, 24, 32, 300, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    bins = rng.integers(0, k, n)
    layout = binned.make_layout(x, bins, k)
    q = jnp.asarray(rng.normal(size=(q_n, d)).astype(np.float32))
    probes = jnp.asarray(rng.integers(0, k, (q_n, p)).astype(np.int32))
    d1, i1 = binned.binned_topk_shared(
        q, None, p, layout, top_k=8, probes=probes
    )
    d2, i2 = binned.binned_topk_fused(
        q, None, p, layout, top_k=8, probes=probes
    )
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(
        np.asarray(d1), np.asarray(d2), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize(
    "n,d,k,q_n,nprobe,skew",
    [
        (3000, 32, 16, 200, 1, False),
        (3000, 300, 16, 500, 3, True),  # d not a power of two
        (997, 12, 7, 33, 2, True),      # d < 16: columns padded
    ],
)
def test_pallas_packed_matches_shared(n, d, k, q_n, nprobe, skew, metric):
    """The packed-scan kernel (interpret mode on CPU) returns the
    two-dispatch reference results for both metrics."""
    rng = np.random.default_rng(42)
    x = rng.normal(size=(n, d)).astype(np.float32)
    bins = (
        (rng.random(n) ** 3 * k).astype(np.int64)
        if skew
        else rng.integers(0, k, n)
    )
    layout = binned.make_layout(x, bins, k)
    cents = jnp.asarray(rng.normal(size=(k, d)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(q_n, d)).astype(np.float32))
    d1, i1 = binned.binned_topk_shared(
        q, cents, nprobe, layout, top_k=10, metric=metric
    )
    d2, i2 = binned.binned_topk_fused(
        q, cents, nprobe, layout, top_k=10, metric=metric,
        engine="pallas", interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(
        np.asarray(d1), np.asarray(d2), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("probes_per_tree", [2, None])  # fixed, deficit-gated
def test_lsh_pallas_engine_matches_xla(probes_per_tree):
    """Forest search on the kernel engine (interpret mode) returns the
    XLA engine's results, at fixed probes and under the default deficit
    gate (whose deactivated ranks the kernel leaves unwritten)."""
    from vers_tpu.index.lsh import ANNIndex
    from vers_tpu.ops.forest_shared import forest_search_shared

    rng = np.random.default_rng(3)
    n, d = 2000, 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    idx = ANNIndex.build_index(3, 50, x, np.arange(n))
    q = jnp.asarray(x[:100] + 0.01 * rng.normal(size=(100, d)), jnp.float32)
    n_probes, deficit_k = idx._probe_plan(8, probes_per_tree)
    assert (deficit_k > 0) == (probes_per_tree is None)
    out = {}
    for engine in ("xla", "pallas"):
        sh, plan = idx._shared_plan(100, 8, engine)
        out[engine] = forest_search_shared(
            q, *idx.shared_operands(sh), n_probes=n_probes,
            num_bins=sh["num_bins"], top_k=8, deficit_k=deficit_k,
            interpret=True, **plan,
        )
    np.testing.assert_array_equal(
        np.asarray(out["xla"][1]), np.asarray(out["pallas"][1])
    )
    np.testing.assert_allclose(
        np.asarray(out["xla"][0]), np.asarray(out["pallas"][0]),
        rtol=1e-4, atol=1e-4,
    )


def test_forest_plan_per_tree_tables():
    """LSH-style stacked layout: per-tree group tables must tile each
    tree's bin range exactly, and ranks map tree-major."""
    rng = np.random.default_rng(1)
    n, d = 1200, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    t0_bins = rng.integers(0, 5, n)
    t1_bins = rng.integers(0, 7, n) + 5  # tree 1 bins offset by 5
    bins = np.where(rng.random(n) < 0.5, t0_bins, t1_bins)
    layout = binned.make_layout(x, bins, 12)
    plan = binned.forest_tile_plan(
        layout, 64, 5, np.asarray([0, 5, 12]), n_probes=2
    )
    g_first = np.asarray(plan["g_first"])
    assert g_first.shape[0] == 2  # one table per tree
    assert g_first[0, 0] == 0
    assert g_first[1, 0] == 5
    assert plan["rank_rows"] == (0, 0, 1, 1)
    # each tree's table ends at its own bin bound (padding repeats it)
    assert g_first[0].max() == 5
    assert g_first[1].max() == 12


def test_static_groups_cover_all_bins():
    rng = np.random.default_rng(0)
    n, k = 3000, 40
    x = rng.normal(size=(n, 8)).astype(np.float32)
    bins = (rng.random(n) ** 2 * k).astype(np.int64)
    layout = binned.make_layout(x, bins, k)
    plan = binned.fused_tile_plan(layout, 128, 10)
    g_first = np.asarray(plan["g_first"])[0]
    sizes = layout["sizes_host"]
    assert g_first[0] == 0 and g_first[-1] == k
    assert (np.diff(g_first) >= 1).all()
    for g in range(len(g_first) - 1):
        span = sizes[g_first[g] : g_first[g + 1]].sum()
        assert span <= plan["r_blk"]


def test_adaptive_probes_sentinel_and_depth():
    """adaptive_probes: ranks gate by exclusive cumsum of capped sizes;
    inactive ranks park on the sentinel bin num_bins."""
    import jax.numpy as jnp
    from vers_tpu.ops.binned import adaptive_probe_depth, adaptive_probes

    num_bins = 4
    # bins at corners of a 2-d space; sizes 12, 2, 3, 20
    centroids = np.array(
        [[0, 0], [10, 0], [0, 10], [10, 10]], np.float32
    )
    sizes = np.array([12, 2, 3, 20], np.int64)
    top_k = 10
    # adversarial: 2 + 3 + min(12, 10) covers 10 at depth 3
    assert adaptive_probe_depth(sizes, top_k) == 3
    # a query at bin 0 (size 12 >= 10): only rank 0 active
    q = jnp.asarray(np.array([[0.1, 0.1], [9.9, 0.1]], np.float32))
    probes = np.asarray(
        adaptive_probes(q, jnp.asarray(centroids), jnp.asarray(sizes),
                        num_bins, 3, top_k)
    )
    assert probes[0, 0] == 0 and (probes[0, 1:] == num_bins).all()
    # a query at bin 1 (size 2): needs bin 1, then nearest others until
    # the capped sum reaches 10 (2 + 10 >= 10 at rank 2)
    assert probes[1, 0] == 1
    assert probes[1, 1] != num_bins  # second rank active
    assert probes[1, 2] == num_bins  # gated after coverage


def test_deficit_gate_tree_major():
    import jax.numpy as jnp
    from vers_tpu.ops.forest_shared import _deficit_gate

    num_bins = 6
    sizes = jnp.asarray(np.array([4, 4, 4, 50, 50, 50], np.int32))
    # 2 trees x 2 ranks, tree-major: tree0 ranks (small leaves),
    # tree1 ranks (big leaves)
    probes = jnp.asarray(np.array([[0, 1, 3, 4]], np.int32))
    gated = np.asarray(_deficit_gate(probes, sizes, num_bins, 2, 10))
    # tree0: 4 < 10 -> rank 1 stays; tree1: 50 >= 10 -> rank 1 gated
    assert list(gated[0]) == [0, 1, 3, num_bins]


def test_pallas_gated_sentinel_ranks_masked():
    """Gated (sentinel-bin) probe ranks must contribute NOTHING on the
    kernel path. No work item owns a sentinel query row, so the kernel
    never writes it; on the card that memory is uninitialized, and
    garbage there would win the cross-probe merge. The wrapper masks
    rows without a real bin, making the result identical to running
    only the live ranks."""
    rng = np.random.default_rng(11)
    n, d, k, q_n = 3000, 32, 16, 192
    x = rng.normal(size=(n, d)).astype(np.float32)
    bins = rng.integers(0, k, n)
    layout = binned.make_layout(x, bins, k)
    cents = jnp.asarray(rng.normal(size=(k, d)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(q_n, d)).astype(np.float32))

    from vers_tpu.ops.distance import pairwise_distance
    from vers_tpu.ops.topk import topk_smallest

    cd = pairwise_distance(q, cents, "sq_euclidean")
    _, near = topk_smallest(cd, 2)
    near = np.asarray(near).astype(np.int32)

    # rank 1 gated for EVERY query (whole segment unwritten pre-fix),
    # plus a mixed rank where only half the queries stay live
    sent = np.full((q_n, 1), k, np.int32)
    half = near[:, 1:2].copy()
    half[::2] = k
    probes_live = jnp.asarray(near[:, :1])
    probes_gated = jnp.asarray(np.concatenate([near[:, :1], sent], axis=1))
    probes_mixed = jnp.asarray(np.concatenate([near[:, :1], half], axis=1))

    kw = dict(top_k=8, q_blk=32, engine="pallas", interpret=True)
    d1, i1 = binned.binned_topk_fused(
        q, cents, 1, layout, probes=probes_live, **kw
    )
    d2, i2 = binned.binned_topk_fused(
        q, cents, 2, layout, probes=probes_gated, **kw
    )
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(
        np.asarray(d1), np.asarray(d2), rtol=1e-5, atol=1e-5
    )

    # mixed rank == the same probes evaluated by the XLA scan path
    d3, i3 = binned.binned_topk_fused(
        q, cents, 2, layout, probes=probes_mixed, **kw
    )
    d4, i4 = binned.binned_topk_shared(
        q, cents, 2, layout, top_k=8, probes=probes_mixed
    )
    np.testing.assert_array_equal(np.asarray(i3), np.asarray(i4))
    np.testing.assert_allclose(
        np.asarray(d3), np.asarray(d4), rtol=1e-5, atol=1e-5
    )


def test_merge_tournament_matches_sort_path():
    """w = p*k > 64 routes through the batched pairwise rank-select
    tournament; outputs must be BIT-identical to the
    flat topk_smallest path including tie order, for both dedup modes
    and odd rank counts."""
    import jax.numpy as jnp
    from vers_tpu.ops.binned import merge_probe_results
    from vers_tpu.ops.topk import topk_smallest

    rng = np.random.default_rng(7)
    for p, k, dedup in [(8, 10, False), (8, 10, True), (7, 10, False),
                        (16, 6, True)]:
        w, q_n = p * k, 129
        d = rng.integers(0, 40, size=(q_n, w)).astype(np.float32)  # ties
        i = rng.integers(0, 200, size=(q_n, w)).astype(np.int32)
        sent = rng.random((q_n, w)) < 0.05
        d[sent], i[sent] = np.inf, -1
        got_d, got_i = merge_probe_results(
            jnp.asarray(d), jnp.asarray(i), k, dedup=dedup
        )
        dd = d.copy()
        if dedup:
            for q in range(q_n):
                seen = set()
                for j in range(w):
                    if i[q, j] >= 0:
                        if i[q, j] in seen:
                            dd[q, j] = np.inf
                        else:
                            seen.add(i[q, j])
        fd, sel = topk_smallest(jnp.asarray(dd), k)
        fi = jnp.take_along_axis(jnp.asarray(i), sel, axis=1)
        fi = jnp.where(jnp.isfinite(fd), fi, -1)
        np.testing.assert_array_equal(np.asarray(got_i), np.asarray(fi))
        np.testing.assert_allclose(np.asarray(got_d), np.asarray(fd))
