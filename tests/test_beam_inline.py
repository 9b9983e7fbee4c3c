"""Inline-neighbourhood beam (ops/beam_inline.py): equivalence with the
row-gather beam at full projection rank, and end-to-end recall through
the projected navigation + exact rescore path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vers_tpu.ops import beam as beam_mod
from vers_tpu.ops import beam_inline as bi
from vers_tpu.utils.harness import exhaustive_batch, recall_at_k


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(7)
    n, d, deg = 600, 48, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    # adjacency = exact kNN graph (undirected enough for beam tests)
    dots = x @ x.T
    np.fill_diagonal(dots, -np.inf)
    adj = np.argsort(-dots, axis=1)[:, :deg].astype(np.int32)
    return x, jnp.asarray(adj)


def test_full_rank_projection_matches_gather_beam(graph):
    """dp == d: PCA is a pure rotation, cosine is rotation-invariant,
    so the inline beam must walk exactly like the full-dim beam (modulo
    bf16 noise): same final beams on an easy graph."""
    x, adj = graph
    n, d = x.shape
    xd = jnp.asarray(x)
    basis = bi.pca_projection(xd, d)
    proj = bi.project_rows(xd, basis, d)
    inline = bi.build_inline_table(proj, adj, d, row_chunk=256)

    rng = np.random.default_rng(3)
    q = x[:32] + 0.02 * rng.normal(size=(32, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qd = jnp.asarray(q)

    seeds = jnp.tile(jnp.arange(4, dtype=jnp.int32)[None], (32, 1))
    qp = bi.project_rows(qd, basis, d)
    sv = jnp.take(proj, seeds, axis=0)
    sd = 1.0 - jnp.einsum(
        "qsd,qd->qs", sv, qp, preferred_element_type=jnp.float32
    )
    d_i, i_i = bi.beam_search_layer_inline(
        qp, inline, adj, seeds, sd, ef=16, max_steps=64, expand_per_step=4
    )
    d_g, i_g = beam_mod.beam_search_layer(
        qd, xd.astype(jnp.bfloat16), adj, seeds, ef=16, max_steps=64,
        expand_per_step=4,
    )
    # beams agree on membership (bf16 tie order may differ)
    agree = np.mean([
        len(set(np.asarray(i_i)[r]) & set(np.asarray(i_g)[r])) / 16
        for r in range(32)
    ])
    assert agree > 0.9, agree


def test_inline_descent_recall(graph):
    """Projected navigation + exact f32 rescore still finds the true
    neighbours on an exact-kNN graph. Random gaussian data is the WORST
    case for PCA navigation (flat spectrum — dp/d of the energy
    survives, unlike real embeddings' decaying spectra), so this is a
    smoke floor; a 1M measurement on the card is the real one (not
    taken yet), where the inline step's cheapness buys back recall via
    a wider ef."""
    x, adj = graph
    n, d = x.shape
    dp = 2 * d // 3
    xd = jnp.asarray(x)
    basis = bi.pca_projection(xd, dp)
    proj = bi.project_rows(xd, basis, dp)
    inline = bi.build_inline_table(proj, adj, dp, row_chunk=256)

    rng = np.random.default_rng(4)
    q = x[:64] + 0.02 * rng.normal(size=(64, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    truth = exhaustive_batch(x, q, 5)

    # layer-1 = every 8th node (stand-in routing subset)
    l1_rows = jnp.arange(0, n, 8, dtype=jnp.int32)
    l1_tab = jnp.take(xd, l1_rows, axis=0).astype(jnp.bfloat16)
    nav = xd.astype(jnp.bfloat16)
    rd, ri = bi.full_descent_scan_inline(
        jnp.asarray(q), xd, nav, basis, proj, inline, adj,
        l1_tab, l1_rows, l1_rows.shape[0],
        top_k=5, ef=32, seeds=8, expand=4, refine_r=0,
    )
    rec = recall_at_k(np.asarray(ri), truth)
    assert rec > 0.88, rec
    # distances are exact f32 cosine ascending
    rd = np.asarray(rd)
    assert (np.diff(rd, axis=1) >= -1e-6).all()
    # exact-refine: beam retention in exact space must dominate the
    # pure-projected walk even on this flat-spectrum corpus
    rd2, ri2 = bi.full_descent_scan_inline(
        jnp.asarray(q), xd, nav, basis, proj, inline, adj,
        l1_tab, l1_rows, l1_rows.shape[0],
        top_k=5, ef=32, seeds=8, expand=4, refine_r=16,
    )
    rec2 = recall_at_k(np.asarray(ri2), truth)
    assert rec2 >= rec - 0.01, (rec2, rec)
    assert rec2 > 0.95, rec2


def test_inline_table_layout(graph):
    """inline[v] rows are adj[v]'s projected vectors in order; -1
    neighbours are zero blocks."""
    x, adj = graph
    n, d = x.shape
    dp = 16
    xd = jnp.asarray(x)
    basis = bi.pca_projection(xd, dp)
    proj = np.asarray(bi.project_rows(xd, basis, dp))
    adj_np = np.asarray(adj).copy()
    adj_np[5, 3] = -1
    inline = np.asarray(
        bi.build_inline_table(jnp.asarray(proj), jnp.asarray(adj_np), dp,
                              row_chunk=128)
    )
    deg = adj_np.shape[1]
    blocks = inline[5].reshape(deg, dp)
    assert (blocks[3] == 0).all()
    np.testing.assert_allclose(
        blocks[0], proj[adj_np[5, 0]], rtol=1e-2, atol=1e-2
    )


@pytest.mark.slow
def test_hnsw_index_inline_engine():
    """HNSWIndex with config.nav_inline_dp: same API, recall within a
    point of the classic gather beam on a small batched build.

    Uses a CLUSTERED corpus (the embedding-shaped case the engine
    targets): on clustered data, dp=d/3 PCA navigation matched the
    full-dim gather beam at 20k x 300 (0.9934 vs 0.9918); on pure
    isotropic gaussians PCA navigation degrades (flat spectrum) — known
    and documented in config.py, not the target workload."""
    import dataclasses

    from vers_tpu.index.hnsw import HNSWIndex
    from vers_tpu.utils.data import synthetic_gaussian

    n, d = 3000, 96
    x, q = synthetic_gaussian(
        n, d, n_clusters=128, n_queries=128, seed=9, normalized=True,
        query_noise=0.5,
    )
    truth = exhaustive_batch(x, q, 10)

    h = HNSWIndex.build_index_batched(4, 48, 32, 8, x, seed=0)
    rec_gather = recall_at_k(h.search_batch(q, 10).ids, truth)
    h.config = dataclasses.replace(h.config, nav_inline_dp=32)
    h._device_cache = None
    rec_inline = recall_at_k(h.search_batch(q, 10).ids, truth)
    assert rec_inline >= rec_gather - 0.02, (rec_inline, rec_gather)
    assert rec_inline > 0.9, rec_inline


@pytest.mark.slow
def test_inline_device_add_consistency():
    """Incremental add on an inline-enabled device-built index keeps
    the inline table consistent: the new vector is searchable (its
    neighbours' inline rows were patched), and prior recall holds."""
    import dataclasses

    from vers_tpu.index.hnsw import HNSWIndex
    from vers_tpu.utils.data import synthetic_gaussian

    n, d = 2000, 64
    x, q = synthetic_gaussian(
        n + 8, d, n_clusters=64, n_queries=64, seed=11, normalized=True,
        query_noise=0.5,
    )
    base, extra = x[:n], x[n:]
    h = HNSWIndex.build_index_batched(4, 48, 32, 8, base, seed=0)
    h.config = dataclasses.replace(h.config, nav_inline_dp=32)
    h._device_cache = None
    truth = exhaustive_batch(base, q, 10)
    rec0 = recall_at_k(h.search_batch(q, 10).ids, truth)
    for j, v in enumerate(extra):
        h.add(v, n + j)
    res = h.search_batch(extra, 3)
    assert (res.ids[:, 0] == np.arange(n, n + 8)).all(), res.ids[:, 0]
    allx = np.concatenate([base, extra])
    truth2 = exhaustive_batch(allx, q, 10)
    rec1 = recall_at_k(h.search_batch(q, 10).ids, truth2)
    assert rec1 >= rec0 - 0.03, (rec1, rec0)


def test_auto_policy_and_expand_resolution():
    """nav_inline_dp="auto" policy: off below the
    row-gather-bound scale, budget-fitted dp above it; beam_expand=None
    resolves 8 classic / 4 inline; the inline-table memory guard refuses
    oversized allocations with a clear message."""
    import dataclasses

    import jax.numpy as jnp
    import pytest

    from vers_tpu.config import HNSWConfig
    from vers_tpu.index.hnsw import (
        auto_inline_dp,
        auto_nav_policy,
        resolve_beam_expand,
    )
    from vers_tpu.ops.beam_inline import build_inline_table

    cfg = HNSWConfig()
    assert cfg.nav_inline_dp == "auto"
    # small corpora: classic gathers (saves the device memory)
    assert auto_inline_dp(cfg, 100_000, 100_096, 32) is None
    # 1M x deg32: the dp=64 table (3.8GiB) fits the default 4GiB
    # budget — the r3 1M headline configuration, now the default
    assert auto_inline_dp(cfg, 1_000_000, 1_000_064, 32) == 64
    # deg 48 (the reference's M=24 main.rs params): dp=64 is 5.7GiB,
    # the policy steps down to dp=32 (2.9GiB)
    assert auto_inline_dp(cfg, 1_000_000, 1_000_064, 48) == 32
    # a tight budget steps down, then off
    cfg3 = dataclasses.replace(cfg, inline_hbm_budget_gb=2.0)
    assert auto_inline_dp(cfg3, 1_000_000, 1_000_064, 32) == 32
    cfg1 = dataclasses.replace(cfg, inline_hbm_budget_gb=0.5)
    assert auto_inline_dp(cfg1, 1_000_000, 1_000_064, 32) is None
    # beam-routed configs never feed the inline beam
    cfgb = dataclasses.replace(cfg, route_mode="beam")
    assert auto_inline_dp(cfgb, 1_000_000, 1_000_064, 32) is None

    # joint policy (cap, dp): at 1M the gather width is capped at 32
    # and dp=64 fits regardless of the graph's natural degree — the
    # reference-default M=24 graph (width 49) gets the measured-best
    # max_degree=32 + dp=64 operating point from four ints
    assert auto_nav_policy(cfg, 1_000_000, 1_000_064) == (32, 64)
    # small corpora: no cap, no table
    assert auto_nav_policy(cfg, 100_000, 100_096) == (None, None)
    # the user's tighter max_degree survives; a looser one is capped
    cfg_md = dataclasses.replace(cfg, max_degree=16)
    assert auto_nav_policy(cfg_md, 1_000_000, 1_000_064) == (16, 64)
    cfg_md48 = dataclasses.replace(cfg_md, max_degree=48)
    assert auto_nav_policy(cfg_md48, 1_000_000, 1_000_064) == (32, 64)
    # explicit dp: the user's knobs win untouched
    cfg_dp = dataclasses.replace(cfg, nav_inline_dp=64, max_degree=48)
    assert auto_nav_policy(cfg_dp, 1_000_000, 1_000_064) == (48, 64)
    cfg_off = dataclasses.replace(cfg, nav_inline_dp=None)
    assert auto_nav_policy(cfg_off, 1_000_000, 1_000_064) == (None, None)
    # budget too small for any dp at the capped width: no cap either
    cfg_tiny = dataclasses.replace(cfg, inline_hbm_budget_gb=0.05)
    assert auto_nav_policy(cfg_tiny, 1_000_000, 1_000_064) == (None, None)
    # beam routing: classic everything
    assert auto_nav_policy(cfgb, 1_000_000, 1_000_064) == (None, None)

    assert resolve_beam_expand(cfg, inline_on=False) == 8
    assert resolve_beam_expand(cfg, inline_on=True) == 4
    forced = dataclasses.replace(cfg, beam_expand=6)
    assert resolve_beam_expand(forced, inline_on=True) == 6

    with pytest.raises(ValueError, match="inline table would be"):
        build_inline_table(
            jnp.zeros((256, 8), jnp.bfloat16),
            jnp.zeros((256, 4), jnp.int32),
            dp=8, max_bytes=1024,
        )


def test_auto_policy_off_at_small_n_in_cache():
    """A default-config small index resolves to the classic beam (no
    inline table in the device cache) — the policy, end to end."""
    from vers_tpu.index.hnsw import HNSWIndex
    from vers_tpu.utils.data import synthetic_gaussian

    x, q = synthetic_gaussian(
        700, 48, n_clusters=32, n_queries=32, seed=3, normalized=True,
        query_noise=0.5,
    )
    h = HNSWIndex.build_index_batched(4, 32, 24, 8, x, seed=0)
    h.search_batch(q, 10)
    assert h._device_cache["inline"] is None
