import numpy as np
import pytest

from vers_tpu.index.lsh import ANNIndex
from vers_tpu.utils.harness import exhaustive_batch, recall_at_k


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(800, 16)).astype(np.float32)
    ids = np.arange(800)
    idx = ANNIndex.build_index(4, 40, x, ids)
    return x, idx


def test_build_dedup_and_buckets(built):
    x, idx = built
    assert idx._values.shape[0] == 800  # no duplicates in random data
    for tree in idx._trees:
        assert tree.num_buckets >= 1
        # every vector in exactly one leaf
        assert (tree.leaf_of_vec >= 0).all()
        sizes = [len(m) for m in tree.members]
        assert sum(sizes) == 800


def test_dedup_drops_duplicates():
    x = np.ones((10, 8), np.float32)
    x[5:] = 2.0
    idx = ANNIndex.build_index(2, 4, x, np.arange(10))
    assert idx._values.shape[0] == 2
    assert list(idx._ids) == [0, 5]


def test_search_batch_recall(built):
    x, idx = built
    rng = np.random.default_rng(8)
    q = x[rng.integers(0, 800, size=32)]
    truth = exhaustive_batch(x, q, 10)
    res = idx.search_batch(q, 10)
    # forest probes 4 leaves of ~40: recall should be decent for
    # self-queries (the query's own row always hits its main leaf)
    assert recall_at_k(res.ids[:, :1], truth[:, :1]) == 1.0
    assert recall_at_k(res.ids, truth) > 0.3


def test_search_single_parity_deficit_rule(built):
    x, idx = built
    q = x[11]
    res = idx.search_approximate(q, 10)
    assert len(res) == 10
    assert res[0][0] == 11 and res[0][1] < 1e-6
    d = [r[1] for r in res]
    assert d == sorted(d)


def test_add_appends(built):
    x, idx = built
    v = np.random.default_rng(9).normal(size=16).astype(np.float32)
    idx.add(v, 4242)
    got = idx.search_approximate(v, 1)
    assert got[0][0] == 4242
    got_b = idx.search_batch(v[None], 1)
    assert got_b.ids[0, 0] == 4242


def test_roundtrip(tmp_path, built):
    x, idx = built
    p = str(tmp_path / "lsh.index")
    idx.save_index(p)
    re = ANNIndex.load_index(p, dim=16)
    assert re.max_node_size == idx.max_node_size
    assert len(re._trees) == len(idx._trees)
    np.testing.assert_allclose(re._values, idx._values)
    q = x[3]
    assert re.search_approximate(q, 10) == idx.search_approximate(q, 10)
    res_orig = idx.search_batch(x[:8], 5)
    res_re = re.search_batch(x[:8], 5)
    np.testing.assert_array_equal(res_orig.ids, res_re.ids)


def test_add_overflow_splits_only_that_leaf():
    """Reference parity (`lsh.rs:236-246`): an overflowing add rebuilds
    just the overflowing leaf; every other bucket is bit-identical."""
    rng = np.random.default_rng(33)
    x = rng.normal(size=(30, 8)).astype(np.float32)
    idx = ANNIndex.build_index(2, 4, x, np.arange(30))

    overflowed = 0
    for i in range(12):
        emb = rng.normal(size=8).astype(np.float32)
        # snapshot bucket membership + which leaf each add lands in
        before = [
            ([list(m) for m in t.members], idx._descend_host_pos(t, emb))
            for t in idx._trees
        ]
        idx.add(emb, 100 + i)
        assert not idx._dirty_trees  # split path, never whole-tree rebuild
        for tree, (members_before, (b, _, _, on_path)) in zip(
            idx._trees, before
        ):
            assert on_path
            if len(members_before[b]) + 1 > idx.max_node_size:
                overflowed += 1
            # untouched buckets: identical membership lists
            for bb, mem in enumerate(members_before):
                if bb != b:
                    assert tree.members[bb] == mem
    assert overflowed  # the scenario actually exercised a split

    for tree in idx._trees:
        assert tree.leaf_of_vec.shape[0] == 42
        # leaf bound restored (frozen oversized leaves possible only on
        # non-separable members; none expected at this scale)
        assert max(len(m) for m in tree.members) <= 4
        # members/leaf_of_vec stay consistent after grafting
        for bb, mem in enumerate(tree.members):
            for m in mem:
                assert tree.leaf_of_vec[m] == bb

    res = idx.search_batch(x[:4], 5)
    assert res.ids.shape == (4, 5)
    # single-query path agrees with the grafted tables: every query
    # finds itself
    for qi in range(4):
        assert idx.search_approximate(x[qi], 3)[0][0] == qi


def test_add_overflow_roundtrip(tmp_path):
    """Grafted subtrees serialize through the recursive Node format."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(25, 8)).astype(np.float32)
    idx = ANNIndex.build_index(2, 4, x, np.arange(25))
    for i in range(10):
        idx.add(rng.normal(size=8).astype(np.float32), 200 + i)
    p = str(tmp_path / "lsh_split.index")
    idx.save_index(p)
    idx2 = ANNIndex.load_index(p, dim=8)
    assert len(idx2._values) == 35
    for t1, t2 in zip(idx._trees, idx2._trees):
        assert sorted(map(tuple, map(sorted, t1.members))) == sorted(
            map(tuple, map(sorted, t2.members))
        )
    q = x[3]
    assert [i for i, _ in idx.search_approximate(q, 5)] == [
        i for i, _ in idx2.search_approximate(q, 5)
    ]


def test_batched_deficit_emulation_matches_parity_recall():
    """The default batched path (size-aware deficit emulation) must be
    within 2 recall points of the single-query parity path on clustered
    data with small leaves (the regime where the reference's
    backup-branch rule matters)."""
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(24, 16)).astype(np.float32) * 4
    assign = rng.integers(0, 24, size=600)
    x = (centers[assign] + rng.normal(size=(600, 16)) * 0.3).astype(np.float32)
    # max_node_size 8 < top_k 10: single leaves cannot satisfy top_k
    idx = ANNIndex.build_index(4, 8, x, np.arange(600))
    top_k = 10
    q = x[:64]
    truth = exhaustive_batch(x, q, top_k)

    single_ids = np.full((64, top_k), -1, np.int64)
    for i in range(64):
        for j, (vid, _) in enumerate(idx.search_approximate(q[i], top_k)):
            single_ids[i, j] = vid
    rec_single = recall_at_k(single_ids, truth)

    assert idx._auto_probes(top_k) > 1  # policy engaged
    res = idx.search_batch(q, top_k)  # default = deficit emulation
    rec_batched = recall_at_k(res.ids, truth)

    res1 = idx.search_batch(q, top_k, probes_per_tree=1)
    rec_fixed1 = recall_at_k(res1.ids, truth)

    assert rec_batched >= rec_single - 0.02, (rec_batched, rec_single)
    assert rec_batched > rec_fixed1  # the emulation actually helps


def test_deep_degenerate_tree_codec_and_query(tmp_path):
    """A 5000-deep single-chain tree: the iterative
    writer/parser must roundtrip it byte-identically with the default
    recursion limit untouched, and the parity query path must descend
    it without recursing."""
    import sys

    from vers_tpu.io.bincode import Writer

    dim = 4
    depth = 5000
    n = depth + 1  # one member per leaf
    p = str(tmp_path / "deep.index")
    rng = np.random.default_rng(3)
    values = rng.normal(size=(n, dim)).astype(np.float32)
    with open(p, "wb") as fp:
        w = Writer(fp)
        w.u64(1)  # max_node_size
        w.u64(1)  # num_trees
        for i in range(depth):
            w.u32(0)  # Inner
            w.f32_array(np.full((dim,), 1.0, np.float32))
            w.f32(-0.5)
            w.u32(1)  # left = Leaf{[i]}
            w.vec_u64(np.asarray([i], np.uint64))
            # right child is the next Inner (chain continues)
        w.u32(1)  # final right = Leaf{[depth]}
        w.vec_u64(np.asarray([depth], np.uint64))
        w.vec_f32_matrix(values)
        w.vec_u64(np.arange(n, dtype=np.uint64))

    limit = sys.getrecursionlimit()
    try:
        sys.setrecursionlimit(900)  # stricter than default: prove no recursion
        idx = ANNIndex.load_index(p)  # dim inferred structurally
        assert idx.dim == dim
        p2 = str(tmp_path / "deep_rt.index")
        idx.save_index(p2)
        with open(p, "rb") as a, open(p2, "rb") as b:
            assert a.read() == b.read()
        res = idx.search_approximate(values[0], 3)
        assert len(res) == 3
        assert res[0][0] == 0  # the query point itself
    finally:
        sys.setrecursionlimit(limit)
