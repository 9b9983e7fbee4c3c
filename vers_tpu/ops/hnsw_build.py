"""Batched HNSW construction on the device.

The reference builds its graph one node at a time on the host
(`vers/src/indexes/hnsw.rs:348-432`): descend with ef_construction
searches, heuristic-select M neighbours, add undirected edges, trim.
That loop is inherently serial, so a 1M-vector build is hours of
pointer-chasing.

This module re-expresses construction as **wave-parallel insertion**:
nodes are inserted in waves (1, 2, 4, ... up to ``wave_cap``); within a
wave every node runs the SAME layer-descent beam search against the
frozen graph of all previous waves, selects neighbours with the paper's
heuristic (vectorized: one (W, ef, ef) candidate-pair distance matmul +
a lax.scan over candidates), and edges are committed with scatters:

- forward rows are written directly (new nodes own empty rows),
- reverse edges go into per-row slack slots (rank within the wave's
  incoming set, computed by a device sort), then affected rows are
  compacted back to degree by distance.

Wave members don't see each other as candidates (the graph is frozen
per wave) — the standard batched-HNSW relaxation; recall parity vs the
sequential build is asserted in tests. Reverse-edge trimming is
distance-based (the reference's `_trim_neighbours` re-runs the
heuristic — a documented deviation, PARITY.md).

Layers use compact row indexing (insertion layers are drawn up front,
so per-layer membership is static): adjacency rows exist only for a
layer's members; neighbour ids are global.
"""

from __future__ import annotations

import functools
import math
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from vers_tpu.core import round_up
from vers_tpu.ops.topk import fused_scan_topk, topk_smallest

_INF = jnp.inf

# Guard for the construction-time inline table (see build_graph
# insert_inline): refuse loudly rather than run the device out of
# memory.
_INLINE_BUILD_MAX_BYTES = 8 << 30


def draw_insertion_layers(n: int, num_layers: int, m: int, seed: int) -> np.ndarray:
    """Parity with `get_insertion_layer` (`hnsw.rs:335-346`):
    min(int(-ln(U) / ln(M)), L-1), drawn up front for the whole corpus."""
    rng = np.random.default_rng(seed)
    u = np.maximum(rng.random(n), 1e-12)
    mult = 1.0 / math.log(m)
    return np.minimum((-np.log(u) * mult).astype(np.int64), num_layers - 1)


def _beam(q, vecs, adj, rank_map, entry, ef: int, max_steps: int,
          expand: int = 8, dedup_self: bool = False, entry_d=None):
    """Masked beam search over one layer. ``adj`` rows are compact
    (layer-local); ``rank_map`` (n_pad,) maps global id -> compact row
    (-1 absent). Entry (W,) or (W, S) global ids — S>1 seeds the beam
    with multiple start nodes (must be distinct per row, -1 padded;
    ``entry_d`` supplies their distances when already computed).
    Returns (beam_d, beam_i) ascending, beam_i global ids (-1 pad).

    ``expand``: best unexpanded entries expanded per step (same
    widened frontier as the query beam, `ops/beam.py` — ~expand× fewer
    while_loop iterations, recall-neutral in practice). With
    ``dedup_self`` off the per-step cost is gather-bound and linear in
    ``expand``, so total gather work is expand-invariant while the
    per-iteration fixed costs (merge top-k, pick, dup mask) amortize
    (at expand=16 the merge width starts to dominate)."""
    w, d = q.shape
    n_pad = vecs.shape[0]
    deg = adj.shape[1]
    e = max(1, min(expand, ef))

    def dist_to(ids):
        # vecs may be a bf16 nav table: halved gather bytes (the beam
        # is gather-bound); accumulate the dot in f32 (HIGHEST keeps an
        # f32 nav table f32 on the GPU, not TF32)
        v = jnp.take(vecs, jnp.clip(ids, 0, n_pad - 1), axis=0)
        dots = jnp.einsum(
            "wmd,wd->wm", v, q, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.where(ids >= 0, 1.0 - dots, _INF)

    entry = entry.astype(jnp.int32)
    if entry.ndim == 1:
        entry = entry[:, None]
    s = min(entry.shape[1], ef)
    entry = entry[:, :s]
    seed_d = dist_to(entry) if entry_d is None else entry_d[:, :s]
    seed_d = jnp.where(entry >= 0, seed_d, _INF)
    beam_i = jnp.full((w, ef), -1, jnp.int32).at[:, :s].set(entry)
    beam_d = jnp.full((w, ef), _INF).at[:, :s].set(seed_d)
    expanded = jnp.zeros((w, ef), bool)
    col = jax.lax.broadcasted_iota(jnp.int32, (w, ef), 1)

    def cond(state):
        step, _, _, _, active = state
        return jnp.logical_and(step < max_steps, active)

    def body(state):
        step, beam_d, beam_i, expanded, _ = state
        rank = jnp.where(expanded | (beam_i < 0), _INF, beam_d)
        pick_d, pick = topk_smallest(rank, e)               # (W, E)
        has = pick_d < _INF
        nodes = jnp.where(
            has, jnp.take_along_axis(beam_i, pick, axis=1), -1
        )
        onehot = jnp.any(
            (col[:, None, :] == pick[:, :, None]) & has[:, :, None], axis=1
        )
        expanded = expanded | onehot

        rows = jnp.take(rank_map, jnp.clip(nodes, 0, n_pad - 1))
        nbrs = jnp.take(
            adj, jnp.clip(rows, 0, adj.shape[0] - 1), axis=0
        )                                                    # (W, E, deg)
        nbrs = jnp.where(
            (has & (rows >= 0))[:, :, None], nbrs, -1
        ).reshape(w, e * deg)
        nd = dist_to(nbrs)
        dup = jnp.any(nbrs[:, :, None] == beam_i[:, None, :], axis=2)
        if dedup_self:
            # also drop repeats WITHIN this step's neighbour set (two
            # expanded nodes sharing a neighbour). OFF by default:
            # cross-step duplicates are still suppressed by the beam
            # mask above, and same-step copies merely waste beam slots
            ncol = jax.lax.broadcasted_iota(jnp.int32, (e * deg, e * deg), 1)
            nrow = jax.lax.broadcasted_iota(jnp.int32, (e * deg, e * deg), 0)
            dup = dup | jnp.any(
                (nbrs[:, :, None] == nbrs[:, None, :]) & (ncol < nrow)[None],
                axis=2,
            )
        nd = jnp.where(dup & (nbrs >= 0), _INF, nd)

        cat_d = jnp.concatenate([beam_d, nd], axis=1)
        cat_i = jnp.concatenate([beam_i, nbrs], axis=1)
        cat_e = jnp.concatenate(
            [expanded, jnp.zeros((w, e * deg), bool)], axis=1
        )
        new_d, sel = topk_smallest(cat_d, ef)
        new_i = jnp.take_along_axis(cat_i, sel, axis=1)
        new_e = jnp.take_along_axis(cat_e, sel, axis=1)
        new_i = jnp.where(jnp.isfinite(new_d), new_i, -1)
        active = jnp.any((~new_e) & (new_i >= 0) & jnp.isfinite(new_d))
        return step + 1, new_d, new_i, new_e, active

    state = (jnp.array(0, jnp.int32), beam_d, beam_i, expanded, jnp.array(True))
    _, beam_d, beam_i, _, _ = jax.lax.while_loop(cond, body, state)
    return beam_d, beam_i


def _project_q(q, basis):
    """(W, d) nav rows -> (W, dp) renormalized bf16 projected queries
    (same transform as ops/beam_inline.project_rows, inline-traceable)."""
    p = jnp.einsum(
        "wd,de->we", q.astype(jnp.float32), basis,
        precision=jax.lax.Precision.HIGHEST,
    )
    norm = jnp.linalg.norm(p, axis=1, keepdims=True)
    return (p / jnp.maximum(norm, 1e-12)).astype(jnp.bfloat16)


def _beam_inline(q, qp, vecs, inline_tab, adj_fwd, rank_map, entry,
                 ef: int, max_steps: int, expand: int = 8,
                 refine: int = 64, entry_d=None):
    """Neighborhood-inlined insertion beam — the build-side twin of the
    query path's `ops/beam_inline.beam_search_layer_inline` (D17).

    The classic `_beam` gathers W*expand*deg individual neighbour nav
    rows per lockstep iteration, most of each iteration at 1M shapes.
    Here
    ``inline_tab`` (rows, width, dp) holds, slot-aligned with the FULL
    adjacency width (forward + slack columns), each node's neighbours'
    PCA-projected renormalized bf16 vectors; one iteration gathers only
    W*expand wide rows, scores all expand*deg candidates in projected
    space, keeps the top ``refine``, and gathers just those full-dim
    nav rows for EXACT distances — the beam ranks and retains in exact
    nav space end to end (projection only filters), like the query
    path's refine mode. ``adj_fwd`` supplies candidate ids (forward
    columns only; slack slots of inline_tab are gathered but discarded).

    Same beam/visited semantics as `_beam` (reference layer search:
    `vers/src/indexes/hnsw.rs:242-307`)."""
    w, d = q.shape
    n_pad = vecs.shape[0]
    rows_total, width, dp = inline_tab.shape
    deg = adj_fwd.shape[1]
    e = max(1, min(expand, ef))
    r = max(1, min(refine, e * deg))

    def dist_to(ids):
        v = jnp.take(vecs, jnp.clip(ids, 0, n_pad - 1), axis=0)
        dots = jnp.einsum(
            "wmd,wd->wm", v, q, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.where(ids >= 0, 1.0 - dots, _INF)

    entry = entry.astype(jnp.int32)
    if entry.ndim == 1:
        entry = entry[:, None]
    s = min(entry.shape[1], ef)
    entry = entry[:, :s]
    seed_d = dist_to(entry) if entry_d is None else entry_d[:, :s]
    seed_d = jnp.where(entry >= 0, seed_d, _INF)
    beam_i = jnp.full((w, ef), -1, jnp.int32).at[:, :s].set(entry)
    beam_d = jnp.full((w, ef), _INF).at[:, :s].set(seed_d)
    expanded = jnp.zeros((w, ef), bool)
    col = jax.lax.broadcasted_iota(jnp.int32, (w, ef), 1)

    def cond(state):
        step, _, _, _, active = state
        return jnp.logical_and(step < max_steps, active)

    def body(state):
        step, beam_d, beam_i, expanded, _ = state
        rank = jnp.where(expanded | (beam_i < 0), _INF, beam_d)
        pick_d, pick = topk_smallest(rank, e)               # (W, E)
        has = pick_d < _INF
        nodes = jnp.where(
            has, jnp.take_along_axis(beam_i, pick, axis=1), -1
        )
        onehot = jnp.any(
            (col[:, None, :] == pick[:, :, None]) & has[:, :, None], axis=1
        )
        expanded = expanded | onehot

        rows = jnp.take(rank_map, jnp.clip(nodes, 0, n_pad - 1))
        safe_rows = jnp.clip(rows, 0, rows_total - 1)
        nbrs = jnp.take(adj_fwd, safe_rows, axis=0)          # (W, E, deg)
        nbrs = jnp.where(
            (has & (rows >= 0))[:, :, None], nbrs, -1
        ).reshape(w, e * deg)
        # THE payoff: E wide rows per query instead of E*deg thin ones
        blocks = jnp.take(inline_tab, safe_rows, axis=0)     # (W,E,width,dp)
        nv = blocks[:, :, :deg, :].reshape(w, e * deg, dp)
        dots = jnp.einsum(
            "wmd,wd->wm", nv, qp,
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32,
        )
        nd = jnp.where(nbrs >= 0, 1.0 - dots, _INF)
        # cross-step dups only (dedup_self economics match `_beam`:
        # same-step copies merely waste refine slots)
        dup = jnp.any(nbrs[:, :, None] == beam_i[:, None, :], axis=2)
        nd = jnp.where(dup & (nbrs >= 0), _INF, nd)

        # projection FILTERS the top-r; the beam merges on exact navs
        sc, sel = topk_smallest(nd, r)
        cand = jnp.take_along_axis(nbrs, sel, axis=1)        # (W, r)
        cand = jnp.where(jnp.isfinite(sc), cand, -1)
        cd = dist_to(cand)

        cat_d = jnp.concatenate([beam_d, cd], axis=1)
        cat_i = jnp.concatenate([beam_i, cand], axis=1)
        cat_e = jnp.concatenate(
            [expanded, jnp.zeros((w, r), bool)], axis=1
        )
        new_d, sel2 = topk_smallest(cat_d, ef)
        new_i = jnp.take_along_axis(cat_i, sel2, axis=1)
        new_e = jnp.take_along_axis(cat_e, sel2, axis=1)
        new_i = jnp.where(jnp.isfinite(new_d), new_i, -1)
        active = jnp.any((~new_e) & (new_i >= 0) & jnp.isfinite(new_d))
        return step + 1, new_d, new_i, new_e, active

    state = (jnp.array(0, jnp.int32), beam_d, beam_i, expanded, jnp.array(True))
    _, beam_d, beam_i, _, _ = jax.lax.while_loop(cond, body, state)
    return beam_d, beam_i


def _heuristic_select(q, vecs, beam_d, beam_i, m: int):
    """Vectorized neighbour-selection heuristic (paper §4, reference
    `hnsw.rs:104-164` incl. the m+1 quirk): accept candidate c iff
    d(c, target) <= min over already-selected s of d(c, s).
    Returns (sel_d, sel_i) of width m+1, ascending, -1/inf padded."""
    w, ef = beam_d.shape
    n_pad = vecs.shape[0]
    cvecs = jnp.take(vecs, jnp.clip(beam_i, 0, n_pad - 1), axis=0)  # (W, ef, d)
    pair = 1.0 - jnp.einsum(
        "wed,wfd->wef", cvecs, cvecs, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )                                                               # (W, ef, ef)
    valid = (beam_i >= 0) & jnp.isfinite(beam_d)

    # fori state: min over selected s of d(c_j, s), for EVERY candidate j
    min_sel0 = jnp.full((w, ef), _INF)
    count0 = jnp.zeros((w,), jnp.int32)
    accepted0 = jnp.zeros((w, ef), bool)

    def body(i, state):
        min_sel, count, accepted = state
        d_i = beam_d[:, i]
        valid_i = valid[:, i]
        ok = (count == 0) | (d_i <= min_sel[:, i])
        accept = valid_i & ok & (count <= m)
        # update per-candidate min distance to the selected set
        dcol = pair[:, :, i]  # d(c_j, c_i) for all j
        min_sel = jnp.where(accept[:, None], jnp.minimum(min_sel, dcol), min_sel)
        count = count + accept.astype(jnp.int32)
        accepted = accepted.at[:, i].set(accept)
        return min_sel, count, accepted

    _, _, accepted = jax.lax.fori_loop(0, ef, body, (min_sel0, count0, accepted0))
    sel_d = jnp.where(accepted, beam_d, _INF)
    out_d, order = topk_smallest(sel_d, min(m + 1, ef))
    out_i = jnp.take_along_axis(beam_i, order, axis=1)
    out_i = jnp.where(jnp.isfinite(out_d), out_i, -1)
    return out_d, out_i


def _commit_edges(adj, dist, rank_map, u_ids, sel_i, sel_d, connect, deg: int, slack: int,
                  inline=None, proj=None):
    """Write forward rows for new nodes and reverse edges into slack
    slots, then compact affected rows back to ``deg`` by distance.
    adj/dist: (rows, deg+slack). u_ids (W,) global; sel_i/sel_d
    (W, S<=deg). Returns (adj, dist).

    When ``inline`` (rows, deg+slack, dp) / ``proj`` (n_pad, dp) are
    given, the construction-time inline table is maintained SLOT-FOR-
    SLOT with the adjacency: forward rows get their neighbours'
    projected blocks, reverse edges drop ``proj[u]`` into the same
    slack slot as the id, and compaction reorders blocks with the very
    permutation the ids go through — no recompute-from-adjacency pass
    (which would cost rows*deg thin gathers, dwarfing the beam's
    savings). Returns (adj, dist, inline) then."""
    w, s = sel_i.shape
    rows_total = adj.shape[0]
    width = deg + slack
    n_pad = rank_map.shape[0]
    dump = rows_total  # scatter dump row (buffers padded by caller)

    # ---- forward rows -------------------------------------------------
    fwd_i = jnp.full((w, width), -1, jnp.int32)
    fwd_d = jnp.full((w, width), _INF)
    fwd_i = jax.lax.dynamic_update_slice(fwd_i, sel_i, (0, 0))
    fwd_d = jax.lax.dynamic_update_slice(fwd_d, sel_d, (0, 0))
    u_row = jnp.take(rank_map, jnp.clip(u_ids, 0, n_pad - 1))
    u_row = jnp.where(connect & (u_ids >= 0) & (u_row >= 0), u_row, dump)
    adj = adj.at[u_row].set(fwd_i, mode="drop")
    dist = dist.at[u_row].set(fwd_d, mode="drop")
    if inline is not None:
        dp = proj.shape[1]
        blk = jnp.take(proj, jnp.clip(sel_i, 0, n_pad - 1), axis=0)
        blk = jnp.where((sel_i >= 0)[:, :, None], blk, 0)    # (W, S, dp)
        fwd_blk = jnp.zeros((w, width, dp), proj.dtype)
        fwd_blk = jax.lax.dynamic_update_slice(fwd_blk, blk, (0, 0, 0))
        inline = inline.at[u_row].set(fwd_blk, mode="drop")

    # ---- reverse edges ------------------------------------------------
    e = w * s
    v_flat = jnp.where(connect[:, None], sel_i, -1).reshape(e)
    d_flat = jnp.where(connect[:, None], sel_d, _INF).reshape(e)
    u_flat = jnp.broadcast_to(u_ids[:, None], (w, s)).reshape(e)
    valid = (v_flat >= 0) & jnp.isfinite(d_flat)

    # sort by (v, d): closest incoming edges win the slack slots.
    # ONE lexicographic two-key lax.sort carrying the payloads replaces
    # a pair of chained stable argsorts + gathers (half the sort work). The distance
    # key is the f32 bit pattern of d+1 — monotone for every d > -1
    # (cosine distance is >= -eps), so integer ordering == float
    # ordering without needing x64.
    v_key = jnp.where(valid, v_flat, jnp.iinfo(jnp.int32).max)
    d_key = jax.lax.bitcast_convert_type(
        jnp.where(valid, d_flat, _INF) + 1.0, jnp.int32
    )
    v2, _, d2, u2, val2 = jax.lax.sort(
        (v_key, d_key, d_flat, u_flat, valid), num_keys=2, is_stable=True
    )

    iota = jnp.arange(e, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), v2[1:] != v2[:-1]])
    seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, iota, -1)
    )
    rank = iota - seg_start
    keep = val2 & (rank < slack)
    v_row = jnp.take(rank_map, jnp.clip(v2, 0, n_pad - 1))
    v_row_k = jnp.where(keep & (v_row >= 0), v_row, dump)
    slot = jnp.where(keep, deg + rank, 0)
    adj = adj.at[v_row_k, slot].set(u2.astype(jnp.int32), mode="drop")
    dist = dist.at[v_row_k, slot].set(d2, mode="drop")
    if inline is not None:
        u_blk = jnp.take(proj, jnp.clip(u2, 0, n_pad - 1), axis=0)
        inline = inline.at[v_row_k, slot].set(u_blk, mode="drop")

    # ---- compact affected rows back to deg ----------------------------
    rows = jnp.where(val2 & (v_row >= 0), v_row, dump)
    ga = adj.at[rows].get(mode="fill", fill_value=-1)
    gd = dist.at[rows].get(mode="fill", fill_value=_INF)
    gd = jnp.where(ga >= 0, gd, _INF)
    # only the deg closest survive compaction — select k=deg directly
    # instead of fully sorting all deg+slack columns
    nd, order = topk_smallest(gd, deg)
    ni = jnp.take_along_axis(ga, order, axis=1)
    ni = jnp.where(jnp.isfinite(nd), ni, -1)
    # slack columns are cleared after compaction
    pad = width - deg
    ni = jnp.pad(ni, ((0, 0), (0, pad)), constant_values=-1)
    nd = jnp.pad(nd, ((0, 0), (0, pad)), constant_values=_INF)
    adj = adj.at[rows].set(ni, mode="drop")
    dist = dist.at[rows].set(nd, mode="drop")
    if inline is not None:
        # blocks ride the ids' compaction permutation; duplicate rows
        # in ``rows`` write identical values (computed from the same
        # gathered state), matching the adj/dist scatters above
        g_blk = inline.at[rows].get(mode="fill", fill_value=0)
        nblk = jnp.take_along_axis(g_blk, order[:, :, None], axis=1)
        nblk = jnp.where(jnp.isfinite(nd[:, :deg])[:, :, None], nblk, 0)
        nblk = jnp.pad(nblk, ((0, 0), (0, pad), (0, 0)))
        inline = inline.at[rows].set(nblk, mode="drop")
        return adj, dist, inline
    return adj, dist


def make_wave_step(num_layers: int, m: int, efc: int, degs: List[int],
                   slack: int, sub_caps: tuple, layer_sizes: tuple,
                   ef_route: int = 8, expand: int = 8,
                   route_expand: int = 4, dedup_self: bool = False,
                   beam_steps: int | None = None,
                   route_steps: int | None = 16,
                   route_scan: bool = False, seed_count: int = 1,
                   scan_chunk: int = 16384,
                   insert_inline: bool = False,
                   inline_refine: int = 64,
                   inline_steps: int | None = None):
    """Build the jitted per-wave function. degs[l] = forward degree cap
    of layer l (m_l + 1 for the heuristic's m+1 quirk); adjacency
    buffers are (rows, degs[l] + slack).

    ``beam_steps`` / ``route_steps`` cap the lockstep while_loop
    iterations of the insertion / routing beams. The wave runs until
    EVERY member converges, so a few stragglers set the whole wave's
    step count; a cap truncates that tail. ``None`` = the conservative
    4*ef ceiling.

    ``sub_caps[l]`` (l >= 1) is the static row count of the wave prefix
    that may insert at layer l — the caller sorts each wave by
    insertion layer DESCENDING, so the first ``sub_caps[l]`` rows cover
    every member with ins >= l. With M=24 a 2048-wave has ~85 layer-1
    inserters and ~4 layer-2 ones, so the full-``efc`` beams at l >= 1
    shrink from W to a tiny static prefix; everyone else only needs an
    entry point for the layer below, found by a narrow
    ``ef_route``-wide routing beam (the same D13 narrowing the query
    path uses; the reference runs efc-wide searches even on its pure
    routing descent, `hnsw.rs:374-385` — recall parity is A/B'd).
    ``sub_caps[l] == 0`` means nothing inserts at l (routing only).

    ``layer_sizes[l]`` = the layer's FINAL member count (membership is
    drawn up front): a size<=1 layer contains exactly the global entry
    node, so routing through it is the identity and is skipped.

    ``route_expand``: expansion fan-out of the routing beams — their
    per-step gather is route_expand*deg wide, so a narrow fan-out cuts
    the dominant cost; the beam is only ef_route deep, so fewer
    parallel expansions cost little extra depth.

    ``route_scan``: replace ALL upper-layer work with brute-force matmul
    scans (the build-side twin of the query path's route_mode="scan").
    Waves insert in global-id order and per-layer membership is drawn
    up front, so the already-built members of layer l are a contiguous
    PREFIX of its member table — ``n_built[l]`` rows of ``tabs[l]``.
    Layer >= 1 insertion candidates come from an EXACT top-efc scan of
    that prefix (better edges than a beam's approximation; the tables
    are ~n/M^l rows so the matmuls are tiny), routing beams disappear
    entirely, and the layer-0 insertion beam starts from the top-
    ``seed_count`` layer-1 members instead of a routed entry point.
    ``seed_count`` defaults to 1 for construction: unlike the query
    path (8 seeds, recall-flat), multi-seeding the INSERTION beam
    narrows its exploration and the selected edges lose diversity.
    The scan wave_step signature gains (tabs, tab_members, n_built).
    Kept non-default: construction is dominated by the layer-0
    insertion beam, which both modes share, and the scan graphs
    compile slower."""

    if route_scan:

        @functools.partial(jax.jit, donate_argnums=(2, 3))
        def wave_step_scan(vecs, rank_maps, adjs, dists, wave_ids, ins_l,
                           entry, tabs, tab_members, n_built):
            w = wave_ids.shape[0]
            n_pad = vecs.shape[0]
            alive = wave_ids >= 0
            q = jnp.take(vecs, jnp.clip(wave_ids, 0, n_pad - 1), axis=0)

            new_adjs = list(adjs)
            new_dists = list(dists)
            for l in range(num_layers - 1, 0, -1):
                c = min(sub_caps[l], w)
                if c == 0:
                    continue
                deg = degs[l]
                rows_l = tabs[l].shape[0]
                kk = min(efc, rows_l)
                cd, ci_pos = fused_scan_topk(
                    q[:c], tabs[l], n_built[l], kk, metric="cosine",
                    chunk_size=min(scan_chunk, rows_l),
                    precision=jax.lax.Precision.DEFAULT,
                )
                ci = jnp.where(
                    ci_pos >= 0,
                    jnp.take(tab_members[l],
                             jnp.clip(ci_pos, 0, rows_l - 1)),
                    -1,
                )
                connect = alive[:c] & (ins_l[:c] >= l)
                sel_d, sel_i = _heuristic_select(q[:c], vecs, cd, ci, m)
                if sel_d.shape[1] < deg:
                    padn = deg - sel_d.shape[1]
                    sel_d = jnp.pad(sel_d, ((0, 0), (0, padn)),
                                    constant_values=_INF)
                    sel_i = jnp.pad(sel_i, ((0, 0), (0, padn)),
                                    constant_values=-1)
                else:
                    sel_d = sel_d[:, :deg]
                    sel_i = sel_i[:, :deg]
                new_adjs[l], new_dists[l] = _commit_edges(
                    new_adjs[l], new_dists[l], rank_maps[l],
                    wave_ids[:c], sel_i, sel_d, connect, deg, slack,
                )

            # layer 0: seed the insertion beam with the exact nearest
            # built layer-1 members (or the global entry when the
            # graph has a single layer)
            deg = degs[0]
            if num_layers > 1:
                rows_1 = tabs[1].shape[0]
                s_k = max(1, min(seed_count, rows_1))
                sd, s_pos = fused_scan_topk(
                    q, tabs[1], n_built[1], s_k, metric="cosine",
                    chunk_size=min(scan_chunk, rows_1),
                    precision=jax.lax.Precision.DEFAULT,
                )
                seeds = jnp.where(
                    s_pos >= 0,
                    jnp.take(tab_members[1],
                             jnp.clip(s_pos, 0, rows_1 - 1)),
                    -1,
                )
                seed_d = sd
            else:
                seeds = jnp.broadcast_to(entry, (w,)).astype(jnp.int32)
                seed_d = None
            beam_d, beam_i = _beam(
                q, vecs, new_adjs[0][:, :deg], rank_maps[0], seeds, efc,
                max_steps=beam_steps or 4 * efc, expand=expand,
                dedup_self=dedup_self, entry_d=seed_d,
            )
            connect = alive & (ins_l >= 0)
            sel_d, sel_i = _heuristic_select(q, vecs, beam_d, beam_i, 2 * m)
            if sel_d.shape[1] < deg:
                padn = deg - sel_d.shape[1]
                sel_d = jnp.pad(sel_d, ((0, 0), (0, padn)),
                                constant_values=_INF)
                sel_i = jnp.pad(sel_i, ((0, 0), (0, padn)),
                                constant_values=-1)
            else:
                sel_d = sel_d[:, :deg]
                sel_i = sel_i[:, :deg]
            new_adjs[0], new_dists[0] = _commit_edges(
                new_adjs[0], new_dists[0], rank_maps[0],
                wave_ids, sel_i, sel_d, connect, deg, slack,
            )
            return new_adjs, new_dists

        return wave_step_scan

    donate = (2, 3, 7) if insert_inline else (2, 3)

    @functools.partial(jax.jit, donate_argnums=donate)
    def wave_step(vecs, rank_maps, adjs, dists, wave_ids, ins_l, entry,
                  *inline_args):
        w = wave_ids.shape[0]
        n_pad = vecs.shape[0]
        alive = wave_ids >= 0
        q = jnp.take(vecs, jnp.clip(wave_ids, 0, n_pad - 1), axis=0)
        ent = jnp.broadcast_to(entry, (w,)).astype(jnp.int32)
        if insert_inline:
            inline_tab, proj, basis = inline_args

        new_adjs = list(adjs)
        new_dists = list(dists)
        for l in range(num_layers - 1, 0, -1):
            c = min(sub_caps[l], w)
            if c == 0 and layer_sizes[l] <= 1:
                continue  # single-member layer == the entry node
            deg = degs[l]
            # beams gather only the forward columns: the slack columns
            # are invariantly -1 outside _commit_edges (forward writes
            # pad them, reverse-edge compaction clears them), so the
            # full-width gather was 33% wasted bytes
            adj_fwd = new_adjs[l][:, :deg]
            if c < w and layer_sizes[l] > 1:
                ef_r = min(ef_route, efc)
                rb_d, rb_i = _beam(
                    q, vecs, adj_fwd, rank_maps[l], ent, ef_r,
                    max_steps=route_steps or max(4 * ef_r, 64),
                    expand=route_expand, dedup_self=dedup_self,
                )
                best = rb_i[:, 0]
                new_ent = jnp.where(alive & (best >= 0), best, ent)
            else:
                new_ent = ent
            if c > 0:
                qs, es = q[:c], ent[:c]
                beam_d, beam_i = _beam(
                    qs, vecs, adj_fwd, rank_maps[l], es, efc,
                    max_steps=beam_steps or 4 * efc, expand=expand,
                    dedup_self=dedup_self,
                )
                connect = alive[:c] & (ins_l[:c] >= l)
                sel_d, sel_i = _heuristic_select(qs, vecs, beam_d, beam_i, m)
                if sel_d.shape[1] < deg:
                    padn = deg - sel_d.shape[1]
                    sel_d = jnp.pad(sel_d, ((0, 0), (0, padn)),
                                    constant_values=_INF)
                    sel_i = jnp.pad(sel_i, ((0, 0), (0, padn)),
                                    constant_values=-1)
                else:
                    sel_d = sel_d[:, :deg]
                    sel_i = sel_i[:, :deg]
                new_adjs[l], new_dists[l] = _commit_edges(
                    new_adjs[l], new_dists[l], rank_maps[l],
                    wave_ids[:c], sel_i, sel_d, connect, deg, slack,
                )
                # inserting members take their full beam's best as the
                # next-layer entry (`hnsw.rs:383,415`)
                best = beam_i[:, 0]
                sub_ent = jnp.where(alive[:c] & (best >= 0), best, es)
                new_ent = jax.lax.dynamic_update_slice(new_ent, sub_ent, (0,))
            ent = new_ent

        # layer 0: every member inserts — full-width beam
        deg = degs[0]
        if insert_inline:
            qp = _project_q(q, basis)
            beam_d, beam_i = _beam_inline(
                q, qp, vecs, inline_tab, new_adjs[0][:, :deg],
                rank_maps[0], ent, efc,
                max_steps=inline_steps or beam_steps or 4 * efc,
                expand=expand, refine=inline_refine,
            )
        else:
            beam_d, beam_i = _beam(
                q, vecs, new_adjs[0][:, :deg], rank_maps[0], ent, efc,
                max_steps=beam_steps or 4 * efc, expand=expand,
                dedup_self=dedup_self,
            )
        connect = alive & (ins_l >= 0)
        sel_d, sel_i = _heuristic_select(q, vecs, beam_d, beam_i, 2 * m)
        if sel_d.shape[1] < deg:
            padn = deg - sel_d.shape[1]
            sel_d = jnp.pad(sel_d, ((0, 0), (0, padn)), constant_values=_INF)
            sel_i = jnp.pad(sel_i, ((0, 0), (0, padn)), constant_values=-1)
        else:
            sel_d = sel_d[:, :deg]
            sel_i = sel_i[:, :deg]
        if insert_inline:
            new_adjs[0], new_dists[0], inline_tab = _commit_edges(
                new_adjs[0], new_dists[0], rank_maps[0],
                wave_ids, sel_i, sel_d, connect, deg, slack,
                inline=inline_tab, proj=proj,
            )
            return new_adjs, new_dists, inline_tab
        new_adjs[0], new_dists[0] = _commit_edges(
            new_adjs[0], new_dists[0], rank_maps[0],
            wave_ids, sel_i, sel_d, connect, deg, slack,
        )
        return new_adjs, new_dists

    return wave_step


def build_graph(
    vectors: np.ndarray,
    num_layers: int,
    ef_construction: int,
    m: int,
    seed: int = 0,
    wave_cap: int | str = "auto",
    slack: int | None = None,
    n_valid: int | None = None,
    expand: int = 8,
    route_expand: int = 8,
    route_layers: bool = True,
    nav_dtype: str = "bfloat16",
    dedup_self: bool = False,
    beam_steps: int | None = "auto",
    route_steps: int | None = "auto",
    as_arrays: bool = False,
    route_scan: bool = False,
    seed_count: int = 1,
    insert_inline: bool = False,
    inline_dp: int = 32,
    inline_refine: int = 64,
    inline_steps: int | None = None,
):
    """Run the full batched build. Returns (ins_layers (n,), per-layer
    adjacency dict {global_id: [(nbr_global_id, dist), ...]}).

    ``as_arrays=True`` skips the per-node Python dict construction and
    returns per-layer ``(member_ids (m,), adj (m, deg+slack) int32
    global ids, dist (m, deg+slack) f32)`` numpy triples instead —
    ~12s/100k of host time saved; the index materializes dicts lazily
    only for host-path consumers (save/add/single-query).

    ``beam_steps="auto"`` caps insertion-layer beams at
    max(12, ceil(efc/expand)) lockstep iterations (straggler
    truncation); pass ``None`` for the conservative 4*efc ceiling or an
    int to override.

    ``vectors`` may be a device-resident jax array (already padded to a
    row multiple of 128); pass ``n_valid`` for the live row count then.

    ``route_scan``: brute-force matmul routing for construction (see
    make_wave_step). Membership is drawn up front and waves insert in
    global-id order, so layer l's already-built members are the first
    ``searchsorted(members[l], wave_start)`` rows of a static per-layer
    member table — upper-layer candidates and layer-0 entry seeds come
    from exact scans of that prefix; routing beams are gone.

    ``insert_inline``: neighborhood-inlined layer-0 insertion beams
    (`_beam_inline` — the build-side D17): a construction-time inline
    table of PCA-projected neighbour blocks, maintained slot-aligned
    with the adjacency through `_commit_edges`, replaces the classic
    beam's W*expand*deg thin row gathers with W*expand wide ones.
    Costs (rows0, (deg0+slack)*inline_dp) bf16 of device memory next to the nav
    table. ``inline_steps`` caps the inline beam's lockstep iterations
    independently of ``beam_steps`` (None = inherit)."""
    if isinstance(vectors, jax.Array):
        n_pad = vectors.shape[0]
        n = int(n_valid) if n_valid is not None else n_pad
        vecs = vectors
    else:
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d_ = vectors.shape
        n_pad = round_up(max(n, 1), 128)
        vecs = None
    if n == 0:
        if as_arrays:
            empty = (
                np.zeros((0,), np.int64),
                np.zeros((0, 1), np.int32),
                np.zeros((0, 1), np.float32),
            )
            return np.zeros((0,), np.int64), [empty] * num_layers
        return np.zeros((0,), np.int64), [dict() for _ in range(num_layers)]
    slack = slack if slack is not None else max(m, 8)
    if wave_cap == "auto":
        # bigger waves amortize the per-wave fixed costs until
        # intra-wave freezing stops paying; small builds keep smaller
        # waves (more growth steps). Tuned before the H100 and not
        # re-measured there (ROADMAP Queue 1 #6).
        wave_cap = 4096 if n >= 512_000 else (
            2048 if n >= 64_000 else 1024
        )
    if beam_steps == "auto":
        # ceil(efc/expand) lockstep steps fill the candidate pool once;
        # the floor keeps small-efc builds from under-filling.
        beam_steps = max(12, math.ceil(ef_construction / max(1, expand)))
    if route_steps == "auto":
        # routing beams only need to land an entry point: 16 lockstep
        # steps, not the 64-step tail
        route_steps = 16
    ins = draw_insertion_layers(n, num_layers, m, seed)
    ins[0] = num_layers - 1  # first node joins every layer (hnsw.rs:417-429)

    if vecs is None:
        vecs = jax.device_put(np.pad(vectors, ((0, n_pad - n), (0, 0))))
    # navigation table: the wave beams and the selection heuristic are
    # bound by their random row gathers, so a bf16 copy halves the
    # dominant cost (same trick as the query beam, index/hnsw.py
    # nav_dtype); distances accumulate in f32. The f32
    # corpus is never gathered during construction.
    if nav_dtype != "float32":
        vecs = vecs.astype(jnp.dtype(nav_dtype))

    # per-layer compact rows
    rank_maps = []
    adjs = []
    dists = []
    degs = []
    members: List[np.ndarray] = []
    for l in range(num_layers):
        mem = np.where(ins >= l)[0]
        members.append(mem)
        rank = np.full((n_pad,), -1, np.int32)
        rank[mem] = np.arange(len(mem), dtype=np.int32)
        rank_maps.append(jnp.asarray(rank))
        # +1: the heuristic admits m+1 (quirk parity)
        deg = (2 * m if l == 0 else m) + 1
        degs.append(deg)
        # power-of-2 rows: layer membership counts vary per dataset, so
        # exact-size buffers would recompile wave_step for every corpus;
        # pow2 rounding keeps jit shapes stable across datasets (≤2x
        # memory on the small upper layers)
        rows = max(8, 1 << (max(len(mem), 1) - 1).bit_length())
        adjs.append(jnp.full((rows, deg + slack), -1, jnp.int32))
        dists.append(jnp.full((rows, deg + slack), np.inf, jnp.float32))

    # static per-layer member vector tables for route_scan: tabs[l]
    # rows follow members[l] order (ascending global id), so the built
    # prefix at any wave is contiguous. Nav dtype (the scan is a dense
    # matmul; bf16 halves its bytes). Layer 0 gets a dummy — the scan
    # path never reads it.
    # construction-time inline table (insert_inline): layer-0 rows,
    # FULL adjacency width (slot alignment with adj — see _commit_edges)
    basis = proj = inline_tab = None
    if insert_inline:
        if route_scan:
            raise NotImplementedError(
                "insert_inline + route_scan are separate layer-0 paths; "
                "pick one (insert_inline implies classic routing beams)"
            )
        from vers_tpu.ops.beam_inline import pca_projection, project_rows

        rows0 = adjs[0].shape[0]
        width0 = degs[0] + slack
        table_bytes = rows0 * width0 * inline_dp * 2
        if table_bytes > _INLINE_BUILD_MAX_BYTES:
            raise ValueError(
                f"construction inline table would be "
                f"{table_bytes / 2**30:.1f} GB ({rows0} rows x width "
                f"{width0} x dp {inline_dp} bf16) > the "
                f"{_INLINE_BUILD_MAX_BYTES / 2**30:.1f} GB guard; "
                f"reduce inline_dp or disable insert_inline"
            )
        basis = pca_projection(vecs, inline_dp)
        proj = project_rows(vecs, basis, inline_dp)
        inline_tab = jnp.zeros((rows0, width0, inline_dp), jnp.bfloat16)

    tabs = None
    tab_members = None
    if route_scan and num_layers > 1:
        d = vecs.shape[1]
        tabs = [jnp.zeros((8, d), vecs.dtype)]
        tab_members = [jnp.zeros((8,), jnp.int32)]
        for l in range(1, num_layers):
            mem = members[l]
            rows = max(8, 1 << (max(len(mem), 1) - 1).bit_length())
            mem_pad = np.zeros((rows,), np.int64)
            mem_pad[: len(mem)] = mem
            mids = jnp.asarray(mem_pad, jnp.int32)
            tabs.append(jnp.take(vecs, mids, axis=0))
            tab_members.append(mids)

    # wave schedule: 1, then 8, 64, 512, ... up to wave_cap — coarse
    # growth keeps the number of distinct jit shapes (compiles) small
    order = np.arange(n)
    waves: List[np.ndarray] = []
    pos = 1
    size = 8
    waves.append(order[:1])
    while pos < n:
        take = min(size, wave_cap, n - pos)
        waves.append(order[pos : pos + take])
        pos += take
        size *= 8

    # bucket wave sizes AND per-layer sub-wave caps to limit jit
    # recompiles: insertion-layer counts concentrate hard (Binomial with
    # p = M^-l), so pow2 caps with a floor of 16 produce only a handful
    # of distinct (bucket, sub_caps) keys over a whole build
    step_fns = {}
    entry = 0
    layer_sizes = tuple(len(mem) for mem in members)

    for wave in waves[1:]:
        wsz = len(wave)
        wave_start = int(wave[0])  # waves are contiguous id ranges
        bucket = 1 << (wsz - 1).bit_length()
        bucket = min(bucket, round_up(wave_cap, 8))
        # sort wave rows by insertion layer DESC so layer-l inserters
        # form a prefix; intra-wave order has no other effect (the wave
        # builds against the frozen prior graph)
        wave = wave[np.argsort(-ins[wave], kind="stable")]
        caps = [0] * num_layers
        for l in range(1, num_layers):
            if not route_layers:
                caps[l] = bucket  # faithful: full beams for everyone
                continue
            cnt = int((ins[wave] >= l).sum())
            if cnt == 0:
                caps[l] = 0
            else:
                # cap must be a deterministic function of the bucket,
                # not of the realized count: counts are Binomial(W,
                # M^-l) and sit near pow2 boundaries (mean 128 at
                # W=2048, M=16), so realized-count caps flip between
                # tuples and each tuple cold-compiles a whole wave
                # graph. mean + 6*sqrt(mean) + 4 overflows with
                # probability ~1e-9; the max(cnt) fallback keeps the
                # rare overflow correct (one extra compile).
                exp_cnt = bucket / float(m) ** l
                stat = exp_cnt + 6.0 * math.sqrt(exp_cnt) + 4.0
                cap = max(16, 1 << (int(max(cnt, stat)) - 1).bit_length())
                caps[l] = min(bucket, cap)
        caps = tuple(caps)
        key = (bucket, caps)
        if key not in step_fns:
            step_fns[key] = make_wave_step(
                num_layers, m, ef_construction, degs, slack,
                sub_caps=caps, layer_sizes=layer_sizes,
                expand=expand, route_expand=route_expand,
                dedup_self=dedup_self, beam_steps=beam_steps,
                route_steps=route_steps,
                route_scan=tabs is not None, seed_count=seed_count,
                insert_inline=insert_inline, inline_refine=inline_refine,
                inline_steps=inline_steps,
            )
        ids = np.full((bucket,), -1, np.int64)
        ids[:wsz] = wave
        ins_w = np.full((bucket,), -1, np.int64)
        ins_w[:wsz] = ins[wave]
        if tabs is not None:
            # built-prefix row counts per layer (traced — shapes stable)
            n_built = jnp.asarray(
                [np.searchsorted(members[l], wave_start)
                 for l in range(num_layers)],
                jnp.int32,
            )
            adjs, dists = step_fns[key](
                vecs, rank_maps, adjs, dists,
                jnp.asarray(ids, jnp.int32), jnp.asarray(ins_w, jnp.int32),
                jnp.asarray(entry, jnp.int32),
                tabs, tab_members, n_built,
            )
        elif insert_inline:
            adjs, dists, inline_tab = step_fns[key](
                vecs, rank_maps, adjs, dists,
                jnp.asarray(ids, jnp.int32), jnp.asarray(ins_w, jnp.int32),
                jnp.asarray(entry, jnp.int32),
                inline_tab, proj, basis,
            )
        else:
            adjs, dists = step_fns[key](
                vecs, rank_maps, adjs, dists,
                jnp.asarray(ids, jnp.int32), jnp.asarray(ins_w, jnp.int32),
                jnp.asarray(entry, jnp.int32),
            )

    if as_arrays:
        return ins, [
            (
                members[l],
                np.asarray(adjs[l])[: len(members[l])],
                np.asarray(dists[l])[: len(members[l])],
            )
            for l in range(num_layers)
        ]

    # pull back to host adjacency dicts
    out_layers = []
    for l in range(num_layers):
        adj_h = np.asarray(adjs[l])
        dist_h = np.asarray(dists[l])
        layer = {}
        for rank_pos, gid in enumerate(members[l]):
            row = adj_h[rank_pos]
            dr = dist_h[rank_pos]
            nbrs = [
                (int(row[j]), float(dr[j]))
                for j in range(row.shape[0])
                if row[j] >= 0 and np.isfinite(dr[j])
            ]
            layer[int(gid)] = nbrs
        out_layers.append(layer)
    return ins, out_layers
