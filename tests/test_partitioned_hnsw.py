"""PartitionedHNSWIndex on the 8-virtual-device CPU mesh: one subgraph
per shard (capacity scale-out — per-chip state ~1/n_shards), queries
replicated, all_gather top-k merge."""

import numpy as np
import jax
import pytest

from vers_tpu.index.hnsw import HNSWIndex
from vers_tpu.parallel.hnsw_partitioned import PartitionedHNSWIndex
from vers_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from vers_tpu.utils.harness import exhaustive_batch, recall_at_k

# heavy tier (wave builds / shard_map surfaces / subprocess dryruns):
# skipped by `make test`, run by `make test-all`
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2400, 24)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def built(mesh, corpus):
    return PartitionedHNSWIndex.build_index(
        4, 32, 32, 8, corpus, mesh=mesh, batched=True
    )


def test_capacity_partitioned(built, mesh, corpus):
    """THE point of this class: per-chip graph state is ~1/n_shards of
    the corpus, not a replica."""
    cache = built._ensure_device_cache()
    n_shards = mesh.shape[SHARD_AXIS]
    per = cache["per"]
    # each shard's padded block covers its ~n/S rows (+ ~12.5% add
    # slack, min 64, + sublane pad) — NOT a replica of the corpus
    n_s = corpus.shape[0] // n_shards
    assert per <= n_s + max(64, n_s // 8) + 8
    for arr in (cache["vecs"], cache["vecs_nav"], cache["adj0"]):
        shard_shapes = {s.data.shape for s in arr.addressable_shards}
        assert len(shard_shapes) == 1
        assert next(iter(shard_shapes))[0] == per  # 1/S rows per chip
    # every shard holds a real subgraph
    assert all(s._rows_used == 300 for s in built.shards)
    assert (np.asarray(cache["n1s"]) > 0).all()


def test_recall_vs_single_graph(built, mesh, corpus):
    """The union of per-shard descents must be within ~1pt of the
    single-graph build at equal ef (it typically beats it: each shard
    is exhaustively covered by a full-ef beam over n/S rows)."""
    q = corpus[:128]
    truth = exhaustive_batch(corpus, q, 10)
    rec_part = recall_at_k(built.search_batch(q, 10).ids, truth)
    single = HNSWIndex.build_index_batched(4, 32, 32, 8, corpus, seed=0)
    rec_single = recall_at_k(single.search_batch(q, 10).ids, truth)
    assert rec_part >= rec_single - 0.01, (rec_part, rec_single)
    assert rec_part > 0.9, rec_part


def test_single_query_parity_path(built, corpus):
    res = built.search_approximate(corpus[7], 10)
    assert len(res) == 10
    assert res[0][0] == 7  # self-hit
    assert res[0][1] == pytest.approx(0.0, abs=1e-5)


def test_roundtrip(tmp_path, built, mesh, corpus):
    p = str(tmp_path / "part.index")
    built.save_index(p)
    re = PartitionedHNSWIndex.load_index(p, mesh=mesh)
    q = corpus[:16]
    a = built.search_batch(q, 5)
    b = re.search_batch(q, 5)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-5, atol=1e-6)
    # shard files are standard single-file HNSW layouts
    one = HNSWIndex.load_index(p + ".shard0")
    assert one.dim == corpus.shape[1]


def test_add_routes_to_emptiest_shard(mesh, corpus):
    # host (sequential) build: routing logic is independent of the wave
    # builder, which the module fixture already covers — and each extra
    # 8-shard wave build costs ~3min of jit compile on the 1-core CPU
    idx = PartitionedHNSWIndex.build_index(
        3, 16, 16, 6, corpus[:800], mesh=mesh, batched=False
    )
    sizes_before = [s._rows_used for s in idx.shards]
    probe = corpus[900] / np.linalg.norm(corpus[900])
    idx.add(probe, 4321)
    sizes_after = [s._rows_used for s in idx.shards]
    assert sum(sizes_after) == sum(sizes_before) + 1
    res = idx.search_batch(probe[None], 3)
    assert res.ids[0, 0] == 4321  # the new vector is its own NN


def test_external_ids(mesh, corpus):
    ids = np.arange(800, dtype=np.int64) * 7 + 1_000_000
    idx = PartitionedHNSWIndex.build_index(
        3, 16, 16, 6, corpus[:800], vector_ids=ids, mesh=mesh, batched=False
    )
    res = idx.search_batch(corpus[:20], 5)
    assert (res.ids[:, 0] == ids[:20]).all()
    # device-resident id path too
    _, dev_ids = idx.search_batch_device(corpus[:20], 5)
    assert (np.asarray(dev_ids)[:, 0] == ids[:20]).all()


def test_add_patches_device_cache_in_place(mesh, corpus):
    """An insert on wave-built shards must patch the assembled sharded
    cache in place (row scatters), not drop it — re-assembly downloads
    every device-built shard's corpus. Needs a fresh index (same shapes
    as the module fixture, so jits are warm): `save_index` materializes
    the shards' pending graphs, after which adds take the host path and
    the cache correctly falls back to re-assembly."""
    built = PartitionedHNSWIndex.build_index(
        4, 32, 32, 8, corpus, mesh=mesh, batched=True
    )
    built.search_batch(corpus[:4], 3)  # ensure the cache exists
    cache_before = built._device_cache
    assert cache_before is not None
    probe = corpus[1200] + 0.3 * np.random.default_rng(17).normal(size=24)
    probe = (probe / np.linalg.norm(probe)).astype(np.float32)
    built.add(probe, 99_000)
    assert built._device_cache is cache_before  # patched, not rebuilt
    res = built.search_batch(probe[None], 3)
    assert res.ids[0, 0] == 99_000  # the new vector is its own NN
    assert res.distances[0, 0] == pytest.approx(0.0, abs=1e-4)
    # old content still searchable through the patched cache
    q = corpus[:64]
    truth = exhaustive_batch(corpus, q, 10)
    assert recall_at_k(built.search_batch(q, 10).ids, truth) > 0.9
    # parity path sees it too
    one = built.search_approximate(probe, 3)
    assert one[0][0] == 99_000
