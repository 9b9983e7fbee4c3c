import numpy as np
import pytest

from vers_tpu.config import IVFFlatConfig
from vers_tpu.index.ivfflat import IVFFlatIndex
from vers_tpu.utils.harness import exhaustive_batch, recall_at_k


@pytest.fixture(scope="module")
def built(request):
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 5
    assign = rng.integers(0, 8, size=600)
    x = (centers[assign] + rng.normal(size=(600, 16))).astype(np.float32)
    idx = IVFFlatIndex.build_index(8, 2, 10, x)
    return x, idx


def test_build_structure(built):
    x, idx = built
    assert idx.num_centroids == 8
    assert sum(len(c) for c in idx._ids) == 600
    assert idx._assignments.shape == (600,)
    # ids lists invert assignments
    for c, members in enumerate(idx._ids):
        for m in members[:5]:
            assert idx._assignments[m] == c


def test_search_batch_recall(built):
    x, idx = built
    rng = np.random.default_rng(4)
    q = x[rng.integers(0, 600, size=32)] + 0.01 * rng.normal(size=(32, 16)).astype(np.float32)
    truth = exhaustive_batch(x, q, 10)
    res = idx.search_batch(q, 10, nprobe=4)
    assert recall_at_k(res.ids, truth) > 0.9
    res1 = idx.search_batch(q, 10, nprobe=1)
    assert recall_at_k(res1.ids, truth) > 0.5
    # distances ascending
    d = res.distances
    assert (np.diff(d, axis=1) >= -1e-6).all()


def test_search_single_adaptive_parity(built):
    x, idx = built
    q = x[7]
    res = idx.search_approximate(q, 5)
    assert len(res) == 5
    assert res[0][0] == 7 and res[0][1] < 1e-6
    # nearest cluster members only (reference scans one cluster when it
    # has >= top_k members)
    c = int(idx._assignments[7])
    assert all(r[0] in idx._ids[c] for r in res)


def test_add_ignores_caller_vec_id(built):
    x, idx = built
    n_before = len(idx._assignments)
    v = np.random.default_rng(5).normal(size=16).astype(np.float32)
    idx.add(v, vec_id=123456)  # quirk parity ivfflat.rs:209
    assert len(idx._assignments) == n_before + 1
    got = idx.search_approximate(v, 1)
    assert got[0][0] == n_before


def test_roundtrip(tmp_path, built):
    x, idx = built
    p = str(tmp_path / "ivf.index")
    idx.save_index(p)
    re = IVFFlatIndex.load_index(p, dim=16)
    assert re.num_centroids == idx.num_centroids
    np.testing.assert_array_equal(re._assignments, idx._assignments)
    np.testing.assert_allclose(re._centroids, idx._centroids)
    q = x[3]
    assert re.search_approximate(q, 5) == idx.search_approximate(q, 5)


def test_add_batch(built):
    x, idx = built
    rng = np.random.default_rng(9)
    new = rng.normal(size=(7, 16)).astype(np.float32)
    n_before = len(idx._assignments)
    idx.add_batch(new)
    assert len(idx._assignments) == n_before + 7
    got = idx.search_approximate(new[3], 1)
    assert got[0][0] == n_before + 3
    res = idx.search_batch(new, 1, nprobe=2)
    assert (res.ids[:, 0] == np.arange(n_before, n_before + 7)).sum() >= 6


def test_build_index_device_matches_host_build():
    """build_index_device == build_index end to end: same k-means seed,
    same layout ordering, same batched/single-query results; host state
    materializes lazily for add/save."""
    import jax.numpy as jnp
    from vers_tpu.core import round_up

    rng = np.random.default_rng(7)
    x = rng.normal(size=(500, 32)).astype(np.float32)
    host_idx = IVFFlatIndex.build_index(8, 2, 5, x)
    n_pad = round_up(500, 128)
    dev = jnp.asarray(np.pad(x, ((0, n_pad - 500), (0, 0))))
    dev_idx = IVFFlatIndex.build_index_device(8, 2, 5, dev, n_valid=500)

    q = x[:16]
    a = host_idx.search_batch(q, 5, nprobe=2)
    b = dev_idx.search_batch(q, 5, nprobe=2)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.distances, b.distances, atol=1e-4)

    # single-query parity path triggers lazy host materialization
    pa = host_idx.search_approximate(x[3], 5)
    pb = dev_idx.search_approximate(x[3], 5)
    assert [i for i, _ in pa] == [i for i, _ in pb]

    # save/load round-trip from a device-built index
    import tempfile, os
    p = os.path.join(tempfile.gettempdir(), "dev_built.index")
    dev_idx.save_index(p)
    re = IVFFlatIndex.load_index(p, dim=32)
    rb = re.search_batch(q, 5, nprobe=2)
    np.testing.assert_array_equal(a.ids, rb.ids)


def test_adaptive_batched_nprobe_matches_walk_union(built):
    """nprobe=0 batched = per-query adaptive probe depth (the walk's
    stopping rule), exact top_k over the probed clusters' union."""
    x, idx = built
    top_k = 12
    queries = x[:24]
    res = idx.search_batch(queries, top_k)  # config default nprobe=0

    layout = idx._ensure_layout()
    sizes = np.asarray(layout["sizes_host"], np.int64)
    cd = (
        np.sum(queries**2, 1)[:, None]
        + np.sum(idx._centroids**2, 1)[None, :]
        - 2.0 * queries @ idx._centroids.T
    )
    for qi in range(len(queries)):
        nearest = np.argsort(cd[qi], kind="stable")
        got = 0
        probed = []
        for c in nearest:
            probed.append(int(c))
            got += min(int(sizes[c]), top_k)
            if got >= top_k:
                break
        members = np.concatenate(
            [np.asarray(idx._ids[c], np.int64) for c in probed if idx._ids[c]]
        )
        d2 = np.sum((idx._values[members] - queries[qi][None]) ** 2, axis=1)
        want = set(members[np.argsort(d2, kind="stable")[:top_k]].tolist())
        assert set(res.ids[qi].tolist()) == want


def test_adaptive_probe_depth_tiny_clusters():
    """Queries near tiny clusters keep probing until top_k candidates
    are reachable (the fixed nprobe=1 path would return < top_k)."""
    from vers_tpu.ops.binned import adaptive_probe_depth

    rng = np.random.default_rng(0)
    # 5 clusters of 3 members each, top_k=10 -> needs >= 4 probes
    centers = np.eye(5, 16, dtype=np.float32) * 10
    x = np.repeat(centers, 3, axis=0) + rng.normal(
        size=(15, 16)
    ).astype(np.float32) * 0.01
    idx = IVFFlatIndex.build_index(5, 2, 10, x)
    sizes = np.asarray(idx._ensure_layout()["sizes_host"])
    assert adaptive_probe_depth(sizes, 10) >= 4
    res = idx.search_batch(x[:4], 10)
    assert (res.ids >= 0).all(axis=1).any()  # full top_k rows exist
    for row in res.ids:
        assert (row >= 0).sum() >= 10 or (row >= 0).sum() == 15


def test_incremental_add_patches_layout():
    """`add` on an index with a built layout must patch
    it in place (slacked bins), not invalidate and re-pack."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(400, 16)).astype(np.float32)
    idx = IVFFlatIndex.build_index(8, 2, 8, x)
    idx.search_batch(x[:4], 5)  # builds the layout
    assert idx._layout is not None
    new = rng.normal(size=(16,)).astype(np.float32)
    idx.add(new, 9999)  # vec_id ignored (quirk parity)
    assert idx._layout is not None and idx._layout.get("slacked")
    layout_obj = idx._layout
    res = idx.search_batch(new[None], 3)
    assert res.ids[0, 0] == 400  # new row id == old len(assignments)
    assert res.distances[0, 0] == pytest.approx(0.0, abs=1e-4)
    assert idx._layout is layout_obj  # same layout dict, patched
    # parity path agrees
    one = idx.search_approximate(new, 3)
    assert one[0][0] == 400


def test_incremental_add_device_built_no_download():
    """add on a device-built index must not materialize the host
    mirrors (no corpus download)."""
    import jax

    from vers_tpu.core import round_up

    rng = np.random.default_rng(9)
    x = rng.normal(size=(384, 16)).astype(np.float32)
    n_pad = round_up(384, 128)
    dev = jax.device_put(np.pad(x, ((0, n_pad - 384), (0, 0))))
    idx = IVFFlatIndex.build_index_device(8, 1, 6, dev, n_valid=384)
    idx.search_batch(x[:4], 5)
    new = rng.normal(size=(16,)).astype(np.float32)
    idx.add(new, 0)
    assert idx._values is None  # host mirror still lazy
    assert idx._n_valid == 385
    res = idx.search_batch(new[None], 3)
    assert res.ids[0, 0] == 384
    # save (materializes) -> reload -> the added row survives
    import tempfile, os

    p = os.path.join(tempfile.gettempdir(), "ivf_dev_add.index")
    idx.save_index(p)
    re = IVFFlatIndex.load_index(p)
    assert re._values.shape[0] == 385
    np.testing.assert_allclose(re._values[384], new, rtol=1e-6)


def test_incremental_add_slack_exhaustion_rebuilds():
    """Overflowing one bin's slack drops the layout; the next search
    rebuilds it and every added row is still found."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    idx = IVFFlatIndex.build_index(4, 1, 6, x)
    idx.search_batch(x[:4], 5)
    # adds all land near one centroid -> exhaust its slack
    base = idx._centroids_host()[0]
    added = []
    for i in range(40):
        v = (base + 0.01 * rng.normal(size=8)).astype(np.float32)
        idx.add(v, 0)
        added.append(v)
    res = idx.search_batch(np.stack(added), 1)
    assert (np.asarray(res.ids[:, 0]) == np.arange(200, 240)).all()


def test_adaptive_probe_full_width_after_add():
    """Regression: adaptive probing (nprobe=0) on a slacked layout must
    size its worst-case depth from OCCUPIED bin sizes, not the slack
    capacities — else searches after one `add` silently return rows
    padded with -1/inf (recall loss on the default path)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(256, 16)).astype(np.float32)
    idx = IVFFlatIndex.build_index(64, 1, 4, x)
    q = x[rng.integers(0, 256, size=8)]
    res0 = idx.search_batch(q, 10, nprobe=0)
    assert (res0.ids >= 0).all()
    idx.add(rng.normal(size=(16,)).astype(np.float32), 0)
    assert idx._layout is not None and idx._layout.get("slacked")
    res1 = idx.search_batch(q, 10, nprobe=0)
    assert (res1.ids >= 0).all()  # full-width valid results
    assert np.isfinite(res1.distances).all()
    truth = exhaustive_batch(x, q, 10)
    assert recall_at_k(res1.ids, truth) >= recall_at_k(res0.ids, truth) - 1e-9
