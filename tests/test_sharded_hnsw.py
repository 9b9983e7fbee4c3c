"""ShardedHNSWIndex on the 8-virtual-device CPU mesh: query-sharded
beam search must match the single-chip batched path exactly (same
graph, same kernel, just fanned out)."""

import numpy as np
import jax
import pytest

from vers_tpu.index.hnsw import HNSWIndex
from vers_tpu.parallel.hnsw import ShardedHNSWIndex
from vers_tpu.parallel.mesh import make_mesh
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
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 24)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_matches_single_chip(mesh, corpus):
    base = HNSWIndex.build_index(4, 32, 32, 8, corpus)
    sharded = ShardedHNSWIndex(base, mesh=mesh)
    q = corpus[:50]
    single = base.search_batch(q, 10)
    multi = sharded.search_batch(q, 10)
    np.testing.assert_array_equal(single.ids, multi.ids)
    np.testing.assert_allclose(
        single.distances, multi.distances, rtol=1e-5, atol=1e-6
    )


def test_recall_on_mesh(mesh, corpus):
    sharded = ShardedHNSWIndex.build_index(4, 32, 32, 8, corpus, mesh=mesh)
    q = corpus[:64]
    truth = exhaustive_batch(corpus, q, 10)
    res = sharded.search_batch(q, 10)
    assert recall_at_k(res.ids, truth) > 0.85


def test_uneven_query_count(mesh, corpus):
    # q_n not a multiple of the mesh size: padding/unpadding must hold
    base = HNSWIndex.build_index(4, 16, 16, 8, corpus)
    sharded = ShardedHNSWIndex(base, mesh=mesh)
    res = sharded.search_batch(corpus[:13], 5)
    assert res.ids.shape == (13, 5)
    assert (res.ids[:, 0] == np.arange(13)).all()  # self-hit


def test_roundtrip(tmp_path, mesh, corpus):
    sharded = ShardedHNSWIndex.build_index(3, 16, 16, 6, corpus, mesh=mesh)
    p = str(tmp_path / "sh.index")
    sharded.save_index(p)
    re = ShardedHNSWIndex.load_index(p, mesh=mesh)  # dim inferred
    q = corpus[:8]
    np.testing.assert_array_equal(
        sharded.search_batch(q, 5).ids, re.search_batch(q, 5).ids
    )
