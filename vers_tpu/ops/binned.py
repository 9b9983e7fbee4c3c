"""Binned (bucketed) dense search — the shared engine behind IVFFlat's
cluster probe and the RP-forest's leaf probe.

The corpus is stored **bin-major** (rows sorted so each bin — k-means
cluster or RP-tree leaf — is one contiguous row range). Queries are
binned and sorted, consecutive whole bins are packed into fixed
(q_blk, r_blk) tiles, and a `lax.scan` over these packed groups runs
one dense distance matmul + top-k per tile with a bin-equality mask:
no corpus gathers, pure matmul work, and no mean-vs-max skew padding.

This replaces the reference's pointer-y walks (`ivfflat.rs:166-195`
cluster scan, `lsh.rs:163-216` tree descent + DashSet merge) with
rectangles.
"""

from __future__ import annotations

import functools
import os
from typing import Dict

import numpy as np
import jax
import jax.numpy as jnp

from vers_tpu.core import round_up
from vers_tpu.ops.distance import pairwise_distance
from vers_tpu.ops.pallas_binned import kernel_scan_packed, next_pow2
from vers_tpu.ops.topk import topk_smallest

_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}

# corpus rows per step of the kernel engine's scan loop
KERNEL_CHUNK = 64


def make_layout(values: np.ndarray, bin_ids: np.ndarray, num_bins: int) -> Dict:
    """Build a bin-major device layout from (n, d) values and their (n,)
    bin assignments. Returns dict with corpus_sorted (n_pad, d),
    sorted_to_orig (n_pad,), start (num_bins,), size (num_bins,),
    max_bin (python int)."""
    values = np.asarray(values, dtype=np.float32)
    n = values.shape[0]
    order = np.argsort(bin_ids[:n], kind="stable")
    sizes = np.bincount(bin_ids[:n], minlength=num_bins).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    n_pad = round_up(max(n, 1), 128)
    corpus_sorted = np.pad(values[order], ((0, n_pad - n), (0, 0)))
    sorted_to_orig = np.full((n_pad,), -1, np.int32)
    sorted_to_orig[:n] = order.astype(np.int32)
    rbin = np.full((n_pad,), -1, np.int32)
    rbin[:n] = np.repeat(np.arange(num_bins, dtype=np.int32), sizes)
    return dict(
        corpus_sorted=jax.device_put(corpus_sorted),
        sorted_to_orig=jnp.asarray(sorted_to_orig),
        start=jnp.asarray(starts),
        size=jnp.asarray(sizes),
        rbin=jnp.asarray(rbin),
        sizes_host=sizes,
        starts_host=starts,
        max_bin=int(sizes.max()) if n else 1,
        num_bins=num_bins,
    )


def make_layout_device(
    values_dev: jnp.ndarray,
    bin_ids_dev: jnp.ndarray,
    num_bins: int,
    n_valid: int,
) -> Dict:
    """``make_layout`` for device-resident data: the corpus never
    touches the host (only the (num_bins,) size vector is downloaded
    for tile planning). ``values_dev`` is (n_pad, d) on device;
    ``bin_ids_dev`` (n_pad,) int32 (entries >= n_valid ignored).

    Exists because host<->device round-trips of a large corpus are
    pure overhead when data was produced on device (sharded loads,
    on-device transforms)."""
    n_pad = values_dev.shape[0]
    rows = jnp.arange(n_pad, dtype=jnp.int32)
    # padding rows sort last as pseudo-bin num_bins
    ids = jnp.where(
        rows < n_valid, bin_ids_dev.astype(jnp.int32), num_bins
    )
    order = jnp.argsort(ids, stable=True).astype(jnp.int32)
    corpus_sorted = jnp.take(values_dev, order, axis=0)
    ids_sorted = jnp.take(ids, order)
    sizes_all = jnp.zeros((num_bins + 1,), jnp.int32).at[ids].add(1)
    sizes = sizes_all[:num_bins]
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(sizes)[:-1].astype(jnp.int32)]
    )
    rbin = jnp.where(ids_sorted == num_bins, -1, ids_sorted)
    sorted_to_orig = jnp.where(rbin >= 0, order, -1)
    sizes_host = np.asarray(sizes)  # (num_bins,) i32 — tiny download
    starts_host = np.concatenate([[0], np.cumsum(sizes_host)[:-1]]).astype(
        np.int32
    )
    return dict(
        corpus_sorted=corpus_sorted,
        sorted_to_orig=sorted_to_orig,
        start=starts,
        size=sizes,
        rbin=rbin,
        sizes_host=sizes_host,
        starts_host=starts_host,
        max_bin=int(sizes_host.max()) if n_valid else 1,
        num_bins=num_bins,
    )


def slacken_layout(layout: Dict, min_slack: int = 8, frac: int = 8) -> Dict:
    """Rebuild a bin-major layout with per-bin slack capacity so
    incremental inserts become in-place device scatters (the IVFFlat
    ``add`` fast path, no re-pack/re-upload — the reference's add is one
    Vec push, `ivfflat.rs:200-213`). One device scatter moves every live
    row to its capacity slot; no host transfer.

    Conventions of a slacked layout:
    - ``sizes_host``/``starts_host``/``max_bin`` describe the CAPACITY
      footprint (what tile packing must span; slack rows carry
      rbin = -1 and are invisible to the scan's bin-equality mask),
    - ``true_sizes_host`` / ``size`` (device) hold the occupied sizes
      (what adaptive probing must see)."""
    true_sizes = np.asarray(
        layout.get("true_sizes_host", layout["sizes_host"]), np.int64
    )
    caps = true_sizes + np.maximum(min_slack, true_sizes // frac)
    cap_starts = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int32)
    cap_total = round_up(int(caps.sum()), 128)
    corpus = layout["corpus_sorted"]
    d = corpus.shape[1]
    rbin_old = layout["rbin"]
    n_old = corpus.shape[0]
    starts_old = jnp.asarray(np.asarray(layout["starts_host"], np.int32))
    capd = jnp.asarray(cap_starts)
    rb_safe = jnp.clip(rbin_old, 0, None)
    tgt = jnp.where(
        rbin_old >= 0,
        capd[rb_safe]
        + jnp.arange(n_old, dtype=jnp.int32)
        - starts_old[rb_safe],
        cap_total,  # out of bounds -> dropped
    )
    new_corpus = (
        jnp.zeros((cap_total, d), corpus.dtype)
        .at[tgt].set(corpus, mode="drop")
    )
    new_rbin = (
        jnp.full((cap_total,), -1, jnp.int32)
        .at[tgt].set(rbin_old, mode="drop")
    )
    new_s2o = (
        jnp.full((cap_total,), -1, jnp.int32)
        .at[tgt].set(layout["sorted_to_orig"], mode="drop")
    )
    return dict(
        corpus_sorted=new_corpus,
        sorted_to_orig=new_s2o,
        start=jnp.asarray(cap_starts),
        size=jnp.asarray(true_sizes.astype(np.int32)),
        rbin=new_rbin,
        sizes_host=caps.astype(np.int32),
        starts_host=cap_starts,
        true_sizes_host=true_sizes.astype(np.int32),
        caps_host=caps.astype(np.int32),
        max_bin=int(caps.max()) if caps.size else 1,
        num_bins=layout["num_bins"],
        slacked=True,
    )


def layout_insert(layout: Dict, row_vec, bin_c: int, orig_row: int) -> bool:
    """In-place insert of one row into bin ``bin_c`` of a slacked
    layout (four device scatters, one int bump). Returns False when the
    bin's slack is exhausted — the caller rebuilds with fresh slack."""
    if not layout.get("slacked"):
        raise ValueError("layout_insert requires a slacken_layout layout")
    c = int(bin_c)
    true_sizes = layout["true_sizes_host"]
    if true_sizes[c] >= layout["caps_host"][c]:
        return False
    pos = int(layout["starts_host"][c]) + int(true_sizes[c])
    row_vec = jnp.asarray(row_vec, layout["corpus_sorted"].dtype)
    layout["corpus_sorted"] = layout["corpus_sorted"].at[pos].set(row_vec)
    layout["rbin"] = layout["rbin"].at[pos].set(c)
    layout["sorted_to_orig"] = (
        layout["sorted_to_orig"].at[pos].set(int(orig_row))
    )
    layout["size"] = layout["size"].at[c].add(1)
    true_sizes[c] += 1
    return True


@functools.partial(
    jax.jit,
    static_argnames=("top_k", "q_blk", "r_blk", "metric", "precision"),
)
def scan_packed(
    q_sorted,        # (Q_pad, d) queries sorted by bin (tail padding)
    qbin_sorted,     # (Q_pad,) bin id per sorted query (-1 pad)
    group_qstart,    # (G,) int32 offsets into q_sorted
    group_rstart,    # (G,) int32 offsets into corpus_sorted
    corpus_sorted,   # (n_pad, d) bin-major
    rbin,            # (n_pad,) int32 bin id per sorted row (-1 pad)
    top_k: int,
    q_blk: int,
    r_blk: int,
    metric: str = "sq_euclidean",
    precision: str = "highest",
):
    """Packed dense per-group scan: each scan step covers a contiguous
    run of WHOLE bins (clusters/leaves) packed to fill a fixed
    (q_blk, r_blk) tile; a bin-equality mask keeps each query scored
    only against its own bin's rows. Compared to one-step-per-bin this
    removes the skew padding (mean-vs-max bin sizes) almost entirely.

    Every query's bin lies wholly inside exactly one group, so each
    sorted query row is written exactly once. Returns (res_d, res_i)
    over sorted query order, shape (Q_pad + q_blk, top_k), positions
    are sorted-corpus rows (-1 invalid).
    """
    q_pad, d = q_sorted.shape
    n_pad = corpus_sorted.shape[0]
    kk = min(top_k, r_blk)

    q_ext = jnp.pad(q_sorted, ((0, q_blk), (0, 0)))
    qbin_ext = jnp.pad(qbin_sorted, (0, q_blk), constant_values=-1)

    res_d = jnp.full((q_pad + q_blk, top_k), jnp.inf, jnp.float32)
    res_i = jnp.full((q_pad + q_blk, top_k), -1, jnp.int32)

    def per_group(carry, g):
        res_d, res_i = carry
        qs, rs = g
        qb = jax.lax.dynamic_slice(q_ext, (qs, 0), (q_blk, d))
        qbins = jax.lax.dynamic_slice(qbin_ext, (qs,), (q_blk,))
        base = jnp.minimum(rs, n_pad - r_blk)
        rb = jax.lax.dynamic_slice(corpus_sorted, (base, 0), (r_blk, d))
        rbins = jax.lax.dynamic_slice(rbin, (base,), (r_blk,))
        dist = pairwise_distance(qb, rb, metric, precision=_PRECISIONS[precision])
        mask = (qbins[:, None] == rbins[None, :]) & (qbins[:, None] >= 0)
        dist = jnp.where(mask, dist, jnp.inf)
        bd, bi = topk_smallest(dist, kk)
        if kk < top_k:
            bd = jnp.pad(bd, ((0, 0), (0, top_k - kk)), constant_values=jnp.inf)
            bi = jnp.pad(bi, ((0, 0), (0, top_k - kk)))
        rows = jnp.where(jnp.isfinite(bd), base + bi, -1)
        res_d = jax.lax.dynamic_update_slice(res_d, bd, (qs, 0))
        res_i = jax.lax.dynamic_update_slice(res_i, rows, (qs, 0))
        return (res_d, res_i), None

    (res_d, res_i), _ = jax.lax.scan(
        per_group, (res_d, res_i), (group_qstart, group_rstart)
    )
    return res_d, res_i


def pack_groups(
    qcount: np.ndarray,   # (k,) queries per bin (this probe)
    sizes: np.ndarray,    # (k,) rows per bin
    starts: np.ndarray,   # (k,) row offsets
    q_blk: int,
    r_blk: int,
):
    """Greedy pack consecutive whole bins into (q_blk, r_blk) tiles.
    Requires q_blk >= max(qcount) and r_blk >= max(sizes). Returns
    (group_qstart, group_rstart) arrays."""
    gq, gr = [], []
    qs = 0
    c = 0
    k = len(sizes)
    while c < k:
        if qcount[c] == 0:
            c += 1  # unqueried bins between groups are never scanned
            continue
        q_used = 0
        r_start = starts[c]
        r_used = 0
        first = True
        while c < k and (
            first
            or (q_used + qcount[c] <= q_blk and r_used + sizes[c] <= r_blk)
        ):
            q_used += int(qcount[c])
            r_used += int(sizes[c])
            c += 1
            first = False
        gq.append(qs)
        gr.append(int(r_start))
        qs += q_used
    return np.asarray(gq, np.int32), np.asarray(gr, np.int32)


def _rank_select_topk(all_d, all_i, top_k: int):
    """Sort-free top-k over a small width w: each column's merged rank
    is its count of strictly-smaller (or equal-and-earlier) columns —
    O(w^2) elementwise compares + a one-hot placement, replacing the
    three row-wise XLA sorts of `topk_smallest` at small widths. Output is ascending with (inf, -1) padding —
    identical to the sort path up to tie order (ties break by column
    index, which is probe-rank order: deterministic)."""
    q_n, w = all_d.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (w, w), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (w, w), 0)
    # rank[j] = #{j': d[j'] < d[j] or (d[j'] == d[j] and j' < j)}
    a = all_d[:, :, None]   # d[j]  (Q, w, 1)
    b = all_d[:, None, :]   # d[j'] (Q, 1, w)
    beats = (b < a) | ((b == a) & (col < row)[None])
    rank = jnp.sum(beats, axis=2).astype(jnp.int32)
    rank = jnp.where(jnp.isfinite(all_d), rank, w)  # park inf: dropped
    # place by one-hot reduction, not a 2D scatter: the (Q, w, k)
    # select+reduce fuses into one elementwise pass
    sel = rank[:, :, None] == jax.lax.broadcasted_iota(
        jnp.int32, (1, 1, top_k), 2
    )
    fin_d = jnp.sum(jnp.where(sel, all_d[:, :, None], 0.0), axis=1)
    fin_d = jnp.where(jnp.any(sel, axis=1), fin_d, jnp.inf)
    fin_i = jnp.sum(jnp.where(sel, all_i[:, :, None], 0), axis=1)
    return fin_d, jnp.where(jnp.isfinite(fin_d), fin_i, -1)


@functools.partial(jax.jit, static_argnames=("top_k", "dedup"))
def merge_probe_results(all_d, all_i, top_k: int, dedup: bool = True):
    """Merge (Q, P*top_k) candidates from P probes: drop duplicate ids
    (a row can surface from several probes/trees), then final top-k.
    Returns (dists (Q, top_k), ids (Q, top_k)).

    ``dedup=False`` skips the duplicate mask — correct whenever the
    probe ranks cover DISJOINT id sets (IVF: each row lives in exactly
    one cluster and the probe list per query is distinct clusters;
    sentinel-gated ranks only contribute (inf, -1) entries, which the
    select drops anyway). RP-forests need dedup=True (trees overlap,
    and gated descent ranks repeat the previous rank's bin)."""
    q_n, w = all_d.shape
    if dedup:
        if w <= 64:
            # small candidate widths (nprobe/tree count * top_k): mark
            # j a duplicate if an earlier column holds the same id —
            # O(w^2) elementwise compares instead of three row-wise XLA
            # sorts (same trick as the beam's visited-set dedup).
            # NOTE: the (Q, w, w) bool intermediate is also a MEMORY
            # bound — at Q=16k, w=64 it is ~67M elements per merge;
            # re-measure memory pressure before widening this cutoff.
            col = jax.lax.broadcasted_iota(jnp.int32, (w, w), 1)
            row = jax.lax.broadcasted_iota(jnp.int32, (w, w), 0)
            dup = jnp.any(
                (all_i[:, :, None] == all_i[:, None, :])
                & (col < row)[None]
                & (all_i[:, :, None] >= 0),
                axis=2,
            )
        else:
            pos_sorted = jnp.sort(all_i, axis=1)
            dup_sorted = jnp.concatenate(
                [jnp.zeros((q_n, 1), bool),
                 (pos_sorted[:, 1:] == pos_sorted[:, :-1])
                 & (pos_sorted[:, 1:] >= 0)],
                axis=1,
            )
            rank = jnp.argsort(
                jnp.argsort(all_i, axis=1, stable=True), axis=1, stable=True
            )
            dup = jnp.take_along_axis(dup_sorted, rank, axis=1)
        all_d = jnp.where(dup, jnp.inf, all_d)
    if w <= 64:
        return _rank_select_topk(all_d, all_i, top_k)
    if (
        top_k <= 32 and w % top_k == 0
        and os.environ.get("VERS_MERGE_TOURNAMENT", "1") == "1"
    ):
        # Tournament of BATCHED pairwise rank-selects (the nprobe=8
        # tail): top-k of a union is the top-k of the halves' top-ks,
        # so fold rank pairs (Q, p*k) -> (Q*p/2, 2k)-select->
        # (Q, p/2*k) until the width fits one final select. Compare
        # volume at p=8, k=10 is (4+2+1)*(2k)^2 = 2800/query vs 6400
        # for a flat w=80 select — and every level is ONE fused
        # elementwise op over a p/2-times-larger batch.
        q_n = all_d.shape[0]
        p = w // top_k
        while p > 1 and p * top_k > 64:
            if p % 2:
                all_d = jnp.pad(
                    all_d, ((0, 0), (0, top_k)), constant_values=jnp.inf
                )
                all_i = jnp.pad(
                    all_i, ((0, 0), (0, top_k)), constant_values=-1
                )
                p += 1
            all_d, all_i = _rank_select_topk(
                all_d.reshape(q_n * p // 2, 2 * top_k),
                all_i.reshape(q_n * p // 2, 2 * top_k),
                top_k,
            )
            p //= 2
            all_d = all_d.reshape(q_n, p * top_k)
            all_i = all_i.reshape(q_n, p * top_k)
        if p == 1:
            return all_d, all_i
        return _rank_select_topk(all_d, all_i, top_k)
    fin_d, sel = topk_smallest(all_d, top_k)
    fin_i = jnp.take_along_axis(all_i, sel, axis=1)
    fin_i = jnp.where(jnp.isfinite(fin_d), fin_i, -1)
    return fin_d, fin_i


def _sort_counts(queries, probes, num_bins: int):
    """Per-probe bin-sort of the query batch (device). probes (Q, P).
    Returns (q_stack (P*Q, d), qbin_stack (P*Q,), orders (P, Q),
    counts (P, num_bins))."""
    p = probes.shape[1]

    def one(r):
        bins = probes[:, r].astype(jnp.int32)
        order = jnp.argsort(bins, stable=True)
        q_sorted = jnp.take(queries, order, axis=0)
        qbin = bins[order]
        counts = jnp.zeros((num_bins,), jnp.int32).at[bins].add(1)
        return q_sorted, qbin, order, counts

    outs = [one(r) for r in range(p)]
    q_stack = jnp.concatenate([o[0] for o in outs], axis=0)
    qbin_stack = jnp.concatenate([o[1] for o in outs], axis=0)
    orders = jnp.stack([o[2] for o in outs], axis=0)
    counts = jnp.stack([o[3] for o in outs], axis=0)
    return q_stack, qbin_stack, orders, counts


@functools.partial(jax.jit, static_argnames=("num_bins", "nprobe", "metric"))
def probe_sort_counts(
    queries, centroids, num_bins: int, nprobe: int,
    metric: str = "sq_euclidean",
):
    """One dispatch: probe the bins (nearest centroids) AND bin-sort
    the queries per probe rank."""
    cdist = pairwise_distance(queries, centroids, metric)
    _, probes = topk_smallest(cdist, nprobe)
    return _sort_counts(queries, probes, num_bins)


@functools.partial(jax.jit, static_argnames=("num_bins",))
def sort_counts_given_probes(queries, probes, num_bins: int):
    """One dispatch for externally-probed bins (RP-forest leaves)."""
    return _sort_counts(queries, probes, num_bins)


@functools.partial(jax.jit, static_argnames=("top_k", "q_n", "dedup"))
def unsort_map_merge(res_d, res_i, orders, sorted_to_orig, top_k: int,
                     q_n: int, dedup: bool = True):
    """(P*Q rows of packed-scan output) -> per-probe unsort, map to
    original rows, dedup, final top-k. Single device program."""
    p = orders.shape[0]
    iota_q = jnp.arange(q_n, dtype=jnp.int32)
    out_d, out_i = [], []
    for r in range(p):
        seg_d = jax.lax.dynamic_slice_in_dim(res_d, r * q_n, q_n, 0)
        seg_i = jax.lax.dynamic_slice_in_dim(res_i, r * q_n, q_n, 0)
        # inverse permutation by scatter, not a second stable argsort
        inv = jnp.zeros((q_n,), jnp.int32).at[orders[r]].set(iota_q)
        pos = seg_i[inv]
        d = seg_d[inv]
        out_i.append(
            jnp.where(pos >= 0, sorted_to_orig[jnp.clip(pos, 0, None)], -1)
        )
        out_d.append(d)
    all_d = jnp.concatenate(out_d, axis=1)
    all_i = jnp.concatenate(out_i, axis=1)
    if p == 1 and all_d.shape[1] == top_k:
        # single probe: the packed scan already emits each query's
        # top_k ascending with distinct positions, so the cross-probe
        # dedup + final top-k would be an identity
        return all_d, all_i
    return merge_probe_results(all_d, all_i, top_k, dedup=dedup)


@functools.partial(
    jax.jit,
    static_argnames=(
        "top_k", "q_blk", "r_blk", "metric", "q_n", "precision", "dedup",
    ),
)
def scan_packed_merge(
    q_stack, qbin_stack, gq, gr, corpus_sorted, rbin, orders,
    sorted_to_orig, top_k: int, q_blk: int, r_blk: int, metric: str,
    q_n: int, precision: str = "highest",
    dedup: bool = True,
):
    """Second (and last) dispatch of a shared-layout search: packed scan
    over all probes' groups + per-probe unsort + id map + final merge."""
    res_d, res_i = scan_packed(
        q_stack, qbin_stack, gq, gr, corpus_sorted, rbin,
        top_k=top_k, q_blk=q_blk, r_blk=r_blk, metric=metric,
        precision=precision,
    )
    return unsort_map_merge(
        res_d, res_i, orders, sorted_to_orig, top_k, q_n, dedup=dedup
    )


def binned_topk_shared(
    queries: jnp.ndarray,
    centroids,
    nprobe: int,
    layout: Dict,
    top_k: int,
    metric: str = "sq_euclidean",
    precision: str = "highest",
    probes=None,
    dedup: bool = True,
):
    """Binned search when all probe ranks share ONE layout (IVFFlat
    clusters, or an RP-forest's stacked per-tree leaf partitions).

    Exactly TWO device dispatches per batch —
    (1) probe + per-probe bin-sort + counts (counts, P*k int32, are the
    only bulk download, driving host-side group packing), then
    (2) packed scan + unsort + merge.

    Either ``centroids`` (nearest-centroid probing) or precomputed
    ``probes`` (Q, P) device bin ids must be given.
    """
    q_n = queries.shape[0]
    k = layout["num_bins"]
    sizes = layout["sizes_host"]
    starts = layout["starts_host"]
    n_pad = layout["corpus_sorted"].shape[0]

    if probes is not None:
        p = probes.shape[1]
        q_stack, qbin_stack, orders, counts_dev = sort_counts_given_probes(
            queries, probes, k
        )
    else:
        p = nprobe
        q_stack, qbin_stack, orders, counts_dev = probe_sort_counts(
            queries, centroids, k, nprobe, metric
        )
    counts = np.asarray(counts_dev)  # (P, k) — the only bulk download

    # tile sizing: target ~32 groups per probe rank (per-step scan
    # overhead dominates below that), bounded by the largest bin
    qmax = max(int(counts.max()), 1)
    n_used = max(int(sizes[counts.sum(0) > 0].sum()), 1)
    r_target = max(layout["max_bin"], top_k, min(8192, max(1024, n_used // 32)))
    r_blk = min(round_up(r_target, 128), n_pad)
    g_est = max(n_used // r_blk, 1)
    q_blk = min(
        round_up(max(qmax, (q_n // g_est) * 2, 64), 64), round_up(q_n, 8)
    )
    gq_all, gr_all = [], []
    for r in range(p):
        gq, gr = pack_groups(counts[r], sizes, starts, q_blk, r_blk)
        gq_all.append(gq + r * q_n)  # offsets into the stacked queries
        gr_all.append(gr)
    gq = np.concatenate(gq_all)
    gr = np.concatenate(gr_all)
    g_pad = round_up(max(len(gq), 1), 16)
    gq = np.pad(gq, (0, g_pad - len(gq)), constant_values=p * q_n)
    gr = np.pad(gr, (0, g_pad - len(gr)))

    return scan_packed_merge(
        q_stack,
        qbin_stack,
        jnp.asarray(gq),
        jnp.asarray(gr),
        layout["corpus_sorted"],
        layout["rbin"],
        orders,
        layout["sorted_to_orig"],
        top_k=top_k,
        q_blk=q_blk,
        r_blk=r_blk,
        metric=metric,
        q_n=q_n,
        precision=precision,
        dedup=dedup,
    )


def adaptive_probe_depth(sizes: np.ndarray, top_k: int) -> int:
    """Static worst-case probe depth of the reference's adaptive
    cluster walk (`ivfflat.rs:166-195`): each probed bin contributes
    min(size, top_k) candidates and the walk stops at top_k total, so
    no query ever needs more probes than it takes the SMALLEST
    contributions (adversarial nearest-order) to reach top_k. Depends
    only on the bin-size histogram — compile-time static."""
    caps = np.minimum(np.asarray(sizes, np.int64), top_k)
    caps_sorted = np.sort(caps)  # ascending = adversarial ordering
    cum = np.cumsum(caps_sorted)
    hit = np.nonzero(cum >= top_k)[0]
    if len(hit) == 0:
        return max(len(caps), 1)  # corpus smaller than top_k: probe all
    return int(hit[0]) + 1


@functools.partial(
    jax.jit, static_argnames=("num_bins", "p_max", "top_k", "metric")
)
def adaptive_probes(
    queries, centroids, sizes, num_bins: int, p_max: int, top_k: int,
    metric: str = "sq_euclidean",
):
    """Per-query adaptive probe selection (the batched analogue of the
    reference's walk): rank bins nearest-first, keep probing while the
    running candidate count (bin sizes capped at top_k, like the walk's
    per-cluster take) is still short of top_k. Inactive ranks are set
    to the sentinel bin ``num_bins``, which the packed scan's
    bin-equality mask (and the scatter-counts' dropped OOB index)
    silently ignores. Returns (Q, p_max) int32."""
    cdist = pairwise_distance(queries, centroids, metric)
    _, probes = topk_smallest(cdist, min(p_max, num_bins))
    contrib = jnp.minimum(sizes[probes], top_k)
    before = jnp.cumsum(contrib, axis=1) - contrib  # exclusive cumsum
    active = before < top_k  # rank r runs iff still short before it
    return jnp.where(active, probes, num_bins).astype(jnp.int32)


def static_groups(layout: Dict, r_blk: int, b_lo: int = 0,
                  b_hi: int | None = None):
    """Pack consecutive whole bins of [b_lo, b_hi) into groups of
    <= r_blk corpus rows, from the layout's (static) bin sizes alone.
    Cached per (r_blk, range). Returns numpy arrays
    (group_first_bin (G+1,), group_rstart (G,))."""
    k_all = len(layout["sizes_host"])
    if b_hi is None:
        b_hi = k_all
    cache = layout.setdefault("_static_groups", {})
    key = (r_blk, b_lo, b_hi)
    if key in cache:
        return cache[key]
    sizes = layout["sizes_host"]
    starts = layout["starts_host"]
    first, rstart = [b_lo], []
    used = 0
    rstart.append(int(starts[b_lo]) if b_lo < k_all else 0)
    for c in range(b_lo, b_hi):
        if used and used + int(sizes[c]) > r_blk:
            first.append(c)
            rstart.append(int(starts[c]))
            used = 0
        used += int(sizes[c])
    first.append(b_hi)
    out = (np.asarray(first, np.int32), np.asarray(rstart, np.int32))
    cache[key] = out
    return out


def stack_group_tables(tables):
    """Stack per-rank (group_first_bin, group_rstart) tables of varying
    group counts into (R, Gmax+1) / (R, Gmax) arrays. Padding groups
    repeat the last bin boundary -> zero queries -> zero tiles."""
    gmax = max(len(r) for _, r in tables)
    f = np.zeros((len(tables), gmax + 1), np.int32)
    rs = np.zeros((len(tables), gmax), np.int32)
    for i, (fi, ri) in enumerate(tables):
        g = len(ri)
        f[i, : g + 1] = fi
        f[i, g + 1 :] = fi[-1]
        rs[i, :g] = ri
    return f, rs


def _fused_workitems(qcounts, qcum_rank_offset, group_first_bin, group_rstart,
                     q_blk: int, w_rank: int, q_scratch: int):
    """Device-side packing for ONE probe rank: from this rank's per-bin
    query counts, emit exactly ``w_rank`` (qstart, rstart, qend) work
    items — ceil(nq_g / q_blk) real tiles per group g, the rest parked on
    the scratch row ``q_scratch`` (scan_packed's dummy-group convention).
    ``qend`` ends the query rows a tile owns (its group's rows only)."""
    qcum = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(qcounts, dtype=jnp.int32)]
    )  # (k+1,) exclusive prefix of sorted-query positions
    qlo = qcum[group_first_bin[:-1]]           # (G,)
    qhi = qcum[group_first_bin[1:]]            # (G,)
    nq = qhi - qlo
    tiles = (nq + q_blk - 1) // q_blk          # (G,)
    tcum = jnp.cumsum(tiles)                   # inclusive
    total = tcum[-1] if tiles.shape[0] else jnp.int32(0)
    w = jnp.arange(w_rank, dtype=jnp.int32)
    g = jnp.searchsorted(tcum, w, side="right").astype(jnp.int32)
    g_c = jnp.clip(g, 0, tiles.shape[0] - 1)
    prev = jnp.where(g_c > 0, tcum[jnp.maximum(g_c - 1, 0)], 0)
    valid = w < total
    qstart = jnp.where(
        valid, qcum_rank_offset + qlo[g_c] + (w - prev) * q_blk, q_scratch
    )
    rstart = jnp.where(valid, group_rstart[g_c], 0)
    qend = jnp.where(
        valid,
        jnp.minimum(qstart + q_blk, qcum_rank_offset + qhi[g_c]),
        q_scratch,
    )
    return qstart, rstart, qend


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_bins", "nprobe", "top_k", "q_blk", "r_blk", "w_rank",
        "metric", "precision", "probes_given", "rank_rows", "dedup",
        "engine", "interpret",
    ),
)
def fused_binned_search(
    queries,           # (Q, d)
    centroids_or_probes,  # (k, d) centroids, or (Q, P) int probes
    corpus_sorted,     # (n_pad, d) bin-major
    rbin,              # (n_pad,)
    sorted_to_orig,    # (n_pad,)
    group_first_bin,   # (R, G+1) static bin->group boundaries per table
    group_rstart,      # (R, G)
    num_bins: int,
    nprobe: int,
    top_k: int,
    q_blk: int,
    r_blk: int,
    w_rank: int,
    metric: str = "sq_euclidean",
    precision: str = "highest",
    probes_given: bool = False,
    rank_rows: tuple = None,
    dedup: bool = True,
    engine: str = "xla",
    interpret: bool = False,
):
    """SINGLE-dispatch binned search: probe, per-rank bin-sort, on-device
    work-item packing (static groups by corpus layout; per-rank query
    tiles via cumsum+searchsorted), packed scan, unsort and merge — no
    host synchronisation at all. The two-dispatch path
    (`binned_topk_shared`) needs a counts download + host `pack_groups`
    between probe and scan.

    ``engine`` runs the packed scan: "xla" (`scan_packed`, a lax.scan
    over the work items) or "pallas" (`ops/pallas_binned`, one program
    per work item). ``interpret`` runs the kernel in the Pallas
    interpreter (tests on the CPU)."""
    q_n = queries.shape[0]
    if probes_given:
        probes = centroids_or_probes
    else:
        cdist = pairwise_distance(queries, centroids_or_probes, metric)
        _, probes = topk_smallest(cdist, nprobe)
    q_stack, qbin_stack, orders, counts = _sort_counts(
        queries, probes, num_bins
    )
    p = probes.shape[1]
    items = [
        _fused_workitems(
            counts[r], r * q_n,
            group_first_bin[0 if rank_rows is None else rank_rows[r]],
            group_rstart[0 if rank_rows is None else rank_rows[r]],
            q_blk, w_rank, p * q_n,
        )
        for r in range(p)
    ]
    gq, gr, ge = (jnp.concatenate(parts) for parts in zip(*items))
    if engine == "pallas":
        res_d, res_i = kernel_scan_packed(
            q_stack, qbin_stack, gq, ge, corpus_sorted, rbin,
            top_k=top_k, q_blk=q_blk, chunk=KERNEL_CHUNK,
            num_bins=num_bins, metric=metric, precision=precision,
            interpret=interpret,
        )
    else:
        res_d, res_i = scan_packed(
            q_stack, qbin_stack, gq, gr, corpus_sorted, rbin,
            top_k=top_k, q_blk=q_blk, r_blk=r_blk, metric=metric,
            precision=precision,
        )
    return unsort_map_merge(
        res_d, res_i, orders, sorted_to_orig, top_k, q_n, dedup=dedup
    )


def kernel_q_blk(q_n: int, n_groups: int) -> int:
    """Query tile of the kernel engine: a power of two in [16, 64] near
    twice a group's mean query count, so most tiles are full while a
    group with few queries wastes few rows."""
    return min(max(next_pow2(2 * q_n // max(n_groups, 1)), 16), 64)


def fused_tile_plan(
    layout: Dict, q_n: int, top_k: int,
    q_blk: int | None = None, r_blk: int | None = None,
    engine: str = "xla",
) -> Dict:
    """Host-side static tile plan for the fused (single-dispatch) path:
    depends only on the corpus layout and query count, never on probe
    results. ``q_blk``/``r_blk`` override the heuristics (tuning).
    Returns dict(q_blk, r_blk, w_rank, g_first, g_rstart).

    The kernel engine's work items scan only the bins their queries
    probe, so its groups are as small as the largest bin (each query
    scores fewer foreign rows), and its query tile is a small power of
    two (`kernel_q_blk`)."""
    sizes = layout["sizes_host"]
    n_pad = layout["corpus_sorted"].shape[0]
    n_total = max(int(sizes.sum()), 1)
    if engine == "pallas":
        r_blk = r_blk or max(layout["max_bin"], 1)
        g_first, g_rstart = static_groups(layout, r_blk)
        q_blk = q_blk or kernel_q_blk(q_n, len(g_rstart))
        return dict(
            q_blk=q_blk, r_blk=r_blk,
            w_rank=(q_n + q_blk - 1) // q_blk + len(g_rstart),
            g_first=jnp.asarray(g_first[None, :]),
            g_rstart=jnp.asarray(g_rstart[None, :]),
        )
    if r_blk is None:
        r_target = max(
            layout["max_bin"], top_k, min(8192, max(1024, n_total // 32))
        )
        r_blk = min(round_up(r_target, 128), n_pad)
    else:
        r_blk = min(round_up(max(r_blk, layout["max_bin"], top_k), 128), n_pad)
    g_first, g_rstart = static_groups(layout, r_blk)
    n_groups = len(g_rstart)
    # q_blk need not cover any bin's query count (a bin's queries may
    # span tiles); size it so full tiles dominate the partial ones
    if q_blk is None:
        q_blk = min(round_up(max(64, q_n // max(n_groups, 1) * 2), 64),
                    round_up(q_n, 8))
    else:
        q_blk = min(round_up(q_blk, 64), round_up(q_n, 8))
    w_rank = (q_n + q_blk - 1) // q_blk + n_groups
    return dict(
        q_blk=q_blk, r_blk=r_blk, w_rank=w_rank,
        g_first=jnp.asarray(g_first[None, :]),
        g_rstart=jnp.asarray(g_rstart[None, :]),
    )


def forest_tile_plan(
    layout: Dict, q_n: int, top_k: int, tree_bin_bounds,
    n_probes: int,
) -> Dict:
    """Tile plan for a stacked multi-tree layout: one group table per
    tree (each probe rank only ever lands in one tree's bins, so sizing
    w_rank by the per-tree group count instead of the combined one cuts
    the dummy work items ~T-fold). ``tree_bin_bounds`` is the (T+1,)
    bin-offset array; ranks are ordered tree-major (t*n_probes + j)."""
    sizes = layout["sizes_host"]
    n_pad = layout["corpus_sorted"].shape[0]
    n_tree = max(int(sizes.sum()) // max(len(tree_bin_bounds) - 1, 1), 1)
    r_target = max(
        layout["max_bin"], top_k, min(8192, max(1024, n_tree // 16))
    )
    r_blk = min(round_up(r_target, 128), n_pad)
    tables = [
        static_groups(layout, r_blk, int(tree_bin_bounds[t]),
                      int(tree_bin_bounds[t + 1]))
        for t in range(len(tree_bin_bounds) - 1)
    ]
    g_first, g_rstart = stack_group_tables(tables)
    g_max = max(len(r) for _, r in tables)
    # q_blk sizing uses the FOREST-wide group count: per-step cost
    # scales with tile area, so per-tree tables must not inflate q_blk
    g_total = sum(len(r) for _, r in tables)
    q_blk = min(round_up(max(64, q_n // max(g_total, 1) * 2), 64),
                round_up(q_n, 8))
    w_rank = (q_n + q_blk - 1) // q_blk + g_max
    rank_rows = tuple(
        t for t in range(len(tables)) for _ in range(n_probes)
    )
    return dict(
        q_blk=q_blk, r_blk=r_blk, w_rank=w_rank,
        g_first=jnp.asarray(g_first), g_rstart=jnp.asarray(g_rstart),
        rank_rows=rank_rows,
    )


def binned_topk_fused(
    queries: jnp.ndarray,
    centroids,
    nprobe: int,
    layout: Dict,
    top_k: int,
    metric: str = "sq_euclidean",
    precision: str = "highest",
    probes=None,
    q_blk: int | None = None,
    r_blk: int | None = None,
    dedup: bool = True,
    engine: str = "xla",
    interpret: bool = False,
):
    """One-dispatch counterpart of `binned_topk_shared` (same results,
    same arguments). Tile sizes depend only on the static layout and the
    query count, so repeated batches of one shape hit one compiled
    executable and cost exactly one device dispatch. ``engine`` and
    ``interpret`` as in `fused_binned_search`."""
    q_n = queries.shape[0]
    p = nprobe if probes is None else int(probes.shape[1])
    plan = fused_tile_plan(
        layout, q_n, top_k, q_blk=q_blk, r_blk=r_blk, engine=engine
    )
    return fused_binned_search(
        queries,
        centroids if probes is None else probes,
        layout["corpus_sorted"],
        layout["rbin"],
        layout["sorted_to_orig"],
        plan["g_first"],
        plan["g_rstart"],
        num_bins=layout["num_bins"],
        nprobe=p,
        top_k=top_k,
        q_blk=plan["q_blk"],
        r_blk=plan["r_blk"],
        w_rank=plan["w_rank"],
        metric=metric,
        precision=precision,
        probes_given=probes is not None,
        dedup=dedup,
        engine=engine,
        interpret=interpret,
    )
