"""Shared-corpus RP-forest search — single-chip memory parity with the
reference.

The Rust reference stores the corpus ONCE and trees hold only ids
(`vers/src/indexes/lsh.rs:44,53`). A layout with one bin-major corpus
copy per tree would need ~T corpus footprints (~10GB at 1M x 300 x 8
trees) where the reference needs ~1.2GB. Every layer (single-chip
`index/lsh`, query-sharded `parallel/lsh`, corpus-partitioned
`parallel/lsh_partitioned`) routes through this module.

This module keeps ONE device corpus and makes every per-tree table an
INDEX table:

- per tree: ``order`` maps the tree's leaf-sorted positions to ORIGINAL
  corpus rows, with the matching bin id per position and static group
  tables over the tree's leaves;
- search is ONE dispatch: multiprobe descent through every tree, then a
  ``lax.scan`` over trees whose body (a) gathers the tree's bin-major
  corpus view from the shared corpus (one XLA gather), (b) runs the
  packed-scan engine (`ops/binned.fused_binned_search`) over it, and
  (c) folds the tree's top-k into the running answer with the id-dedup
  merge. The scan keeps only ONE tree's gathered view live at a time,
  so peak device memory is ~corpus + one tree view regardless of tree
  count.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from vers_tpu.core import round_up
from vers_tpu.ops.binned import fused_binned_search, merge_probe_results
from vers_tpu.ops import rpforest


def pack_bins(sizes: np.ndarray, r_blk: int) -> np.ndarray:
    """Greedy pack consecutive whole bins into groups of <= r_blk rows
    (same rule as `ops/binned.static_groups`, local-bin form). Returns
    (G+1,) int64 LOCAL bin boundaries; bins larger than r_blk get a
    group of their own (callers size r_blk >= max_bin)."""
    first = [0]
    used = 0
    for c, s in enumerate(sizes):
        if used and used + int(s) > r_blk:
            first.append(c)
            used = 0
        used += int(s)
    first.append(len(sizes))
    return np.asarray(first, np.int64)


def shared_tree_tables(
    lovs: Sequence[np.ndarray],     # per tree: (n,) leaf id per row
    num_buckets: Sequence[int],     # per tree: leaf count
    r_blk: int,
) -> Dict:
    """Host-side per-tree index tables for the shared-corpus search.

    Returns dict with stacked arrays (T leading axis; -1 padding):
      g_first  (T, G_max+1)     global-bin group boundaries
      order    (T, n_pad)       tree-sorted position -> original row
      rbin_sorted (T, n_pad)    global bin per tree-sorted position
      g_rstart (T, G_max)       tree-local sorted-row start per group
      g_max, g_total, offsets (T,), num_bins, sizes (global concat),
      max_bin
    """
    T = len(lovs)
    n = len(lovs[0]) if T else 0
    n_pad = round_up(max(n, 1), 128)
    kts = [max(int(k), 1) for k in num_buckets]
    offsets = np.concatenate([[0], np.cumsum(kts)]).astype(np.int64)
    num_bins = int(offsets[-1])

    orders, sizes_t, starts_t, firsts = [], [], [], []
    for t in range(T):
        lov = np.asarray(lovs[t], np.int64)
        order = np.argsort(lov, kind="stable").astype(np.int32)
        sizes = np.bincount(lov, minlength=kts[t]).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        orders.append(order)
        sizes_t.append(sizes)
        starts_t.append(starts)
        firsts.append(pack_bins(sizes, r_blk))
    g_max = max((len(f) - 1 for f in firsts), default=1)
    g_total = sum(len(f) - 1 for f in firsts)

    g_first = np.zeros((T, g_max + 1), np.int64)
    g_rstart = np.zeros((T, g_max), np.int64)
    order_pad = np.full((T, n_pad), -1, np.int32)
    rbin_sorted = np.full((T, n_pad), -1, np.int32)
    for t in range(T):
        order, sizes, starts, first = (
            orders[t], sizes_t[t], starts_t[t], firsts[t]
        )
        lov_sorted = (
            np.asarray(lovs[t], np.int64)[order] + offsets[t]
        ).astype(np.int32)
        order_pad[t, :n] = order
        rbin_sorted[t, :n] = lov_sorted
        G = len(first) - 1
        for g in range(G):
            g_rstart[t, g] = int(starts[first[g]]) if first[g] < kts[t] else n
        g_first[t, : G + 1] = first + offsets[t]
        g_first[t, G + 1 :] = g_first[t, G]  # pad: zero-query groups
    return dict(
        g_first=g_first.astype(np.int32),
        g_rstart=g_rstart.astype(np.int32),
        order=order_pad,
        rbin_sorted=rbin_sorted,
        g_max=g_max,
        g_total=g_total,
        offsets=offsets[:-1].astype(np.int32),
        num_bins=num_bins,
        sizes=np.concatenate(sizes_t).astype(np.int64) if T else
        np.zeros((0,), np.int64),
        max_bin=int(max((s.max() for s in sizes_t if len(s)), default=1)),
        r_blk=r_blk,
    )


def _deficit_gate(probes, sizes, num_bins: int, n_probes: int,
                  deficit_k: int):
    """Size-aware probe gating (the batched deficit/backup rule,
    `lsh.rs:203-214`) — same as `index/lsh._deficit_gate`; duplicated
    here to keep import direction ops -> ops."""
    q_n = probes.shape[0]
    contrib = jnp.minimum(sizes[probes], deficit_k)
    c = contrib.reshape(q_n, -1, n_probes)
    before = jnp.cumsum(c, axis=2) - c
    active = (before < deficit_k).reshape(q_n, -1)
    return jnp.where(active, probes, num_bins)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_probes", "num_bins", "top_k", "q_blk", "r_blk", "w_rank",
        "deficit_k", "engine", "interpret",
    ),
)
def forest_search_shared(
    queries,        # (Q, d)
    coeff_flat, const_flat, cbase, splits, buckets, offsets,  # packed
    sizes_dev,      # (num_bins,) int32 leaf sizes (deficit gate)
    corpus,         # (n_pad, d) the ONE corpus copy
    order,          # (T, n_pad) tree-sorted pos -> original row
    rbin_sorted,    # (T, n_pad)
    g_first,        # (T, G_max+1)
    g_rstart,       # (T, G_max)
    n_probes: int,
    num_bins: int,
    top_k: int,
    q_blk: int,
    r_blk: int,
    w_rank: int,
    deficit_k: int = 0,
    engine: str = "xla",
    interpret: bool = False,
):
    """ONE-dispatch shared-corpus forest query: descent for all trees,
    then lax.scan over trees — gather the tree's bin-major corpus view,
    run the packed scan (``engine``/``interpret`` as in
    `fused_binned_search`), dedup-merge into the running top-k. Returns
    (dists (Q, k) f32, original rows (Q, k))."""
    probes = rpforest.descend_forest_flat(
        queries, coeff_flat, const_flat, cbase, splits, buckets, offsets,
        n_probes=n_probes,
    )
    if deficit_k:
        probes = _deficit_gate(probes, sizes_dev, num_bins, n_probes,
                               deficit_k)
    T = splits.shape[0]
    q_n = queries.shape[0]
    n_pad = corpus.shape[0]
    probes_t = jnp.transpose(
        probes.reshape(q_n, T, n_probes), (1, 0, 2)
    )

    def body(carry, xs):
        bd, bi = carry
        order_t, rbs_t, gf_t, gr_t, pr_t = xs
        safe = jnp.clip(order_t, 0, n_pad - 1)
        live = order_t >= 0
        cs_t = jnp.where(
            live[:, None], jnp.take(corpus, safe, axis=0), 0.0
        )
        td, ti = fused_binned_search(
            queries, pr_t, cs_t, rbs_t, order_t,
            gf_t[None, :], gr_t[None, :],
            num_bins=num_bins, nprobe=n_probes, top_k=top_k,
            q_blk=q_blk, r_blk=r_blk, w_rank=w_rank,
            metric="sq_euclidean", probes_given=True,
            engine=engine, interpret=interpret,
        )
        md, mi = merge_probe_results(
            jnp.concatenate([bd, td], axis=1),
            jnp.concatenate([bi, ti], axis=1),
            top_k,
        )
        return (md, mi), None

    init = (
        jnp.full((q_n, top_k), jnp.inf, jnp.float32),
        jnp.full((q_n, top_k), -1, jnp.int32),
    )
    (bd, bi), _ = jax.lax.scan(
        body, init, (order, rbin_sorted, g_first, g_rstart, probes_t)
    )
    return bd, bi
