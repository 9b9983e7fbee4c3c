import numpy as np

from vers_tpu.parallel.sharded_index import ShardedFlatIndex
from vers_tpu.utils.data import read_fvecs, read_ivecs
from vers_tpu.utils.harness import exhaustive_batch


def test_sharded_flat_index_roundtrip(rng, tmp_path):
    x = rng.normal(size=(300, 16)).astype(np.float32)
    q = rng.normal(size=(7, 16)).astype(np.float32)
    idx = ShardedFlatIndex.build_index(x, ids=np.arange(300) + 1000)
    res = idx.search_batch(q, 10)
    truth = exhaustive_batch(x, q, 10) + 1000
    for r in range(7):
        assert set(res.ids[r]) == set(truth[r])

    base = str(tmp_path / "sharded")
    idx.save_index(base)
    re = ShardedFlatIndex.load_index(base)
    res2 = re.search_batch(q, 10)
    np.testing.assert_array_equal(res.ids, res2.ids)

    # export to single-file flat format
    from vers_tpu.index.flat import FlatIndex

    idx.export_single_file(str(tmp_path / "flat.index"))
    flat = FlatIndex.load_index(str(tmp_path / "flat.index"), dim=16)
    res3 = flat.search_batch(q, 10)
    for r in range(7):
        assert set(res3.ids[r]) == set(truth[r])


def test_fvecs_ivecs_roundtrip(tmp_path, rng):
    x = rng.normal(size=(10, 4)).astype("<f4")
    raw = b""
    for row in x:
        raw += np.int32(4).tobytes() + row.tobytes()
    p = tmp_path / "t.fvecs"
    p.write_bytes(raw)
    got = read_fvecs(str(p))
    np.testing.assert_allclose(got, x)

    ids = rng.integers(0, 100, size=(5, 3)).astype("<i4")
    raw = b""
    for row in ids:
        raw += np.int32(3).tobytes() + row.tobytes()
    p2 = tmp_path / "t.ivecs"
    p2.write_bytes(raw)
    np.testing.assert_array_equal(read_ivecs(str(p2)), ids)


def test_sharded_add_is_in_place():
    """Non-overflowing adds scatter into shard headroom: no re-shard
    (capacity stays fixed), results stay exact."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(100, 8)).astype(np.float32)
    idx = ShardedFlatIndex.build_index(x, ids=np.arange(100))
    cap_before = idx._data.shape
    placed = {"n": 0}
    orig_place = idx._place

    def counting_place(*a, **k):
        placed["n"] += 1
        return orig_place(*a, **k)

    idx._place = counting_place
    headroom = int(cap_before[0] - idx._counts_host.sum())
    n_adds = min(20, headroom)
    assert n_adds > 0
    for i in range(n_adds):
        v = rng.normal(size=8).astype(np.float32)
        idx.add(v, 1000 + i)
        got = idx.search_batch(v[None], 1)
        assert got.ids[0, 0] == 1000 + i
    assert placed["n"] == 0  # never re-sharded
    assert idx._data.shape == cap_before

    # added rows participate in exact global search alongside the base
    q = x[:5]
    res = idx.search_batch(q, 10)
    from vers_tpu.utils.harness import exhaustive_batch as _ex

    truth = _ex(idx._host_vectors, q, 10)
    ids_all = idx._ids
    for r in range(5):
        assert set(res.ids[r]) == set(ids_all[truth[r]])


def test_sharded_add_overflow_regrows():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    idx = ShardedFlatIndex.build_index(x, ids=np.arange(40))
    cap0 = idx._data.shape[0]
    # overflow every shard's headroom
    for i in range(cap0 - 40 + 25):
        idx.add(rng.normal(size=8).astype(np.float32), 500 + i)
    assert idx._data.shape[0] > cap0  # re-placed with grown capacity
    n = idx._n
    res = idx.search_batch(idx._host_vectors[n - 1][None], 1)
    assert res.ids[0, 0] == idx._ids[n - 1]
