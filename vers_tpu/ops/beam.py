"""Batched greedy beam search over a padded adjacency matrix — the
batched re-expression of HNSW's layer search
(`vers/src/indexes/hnsw.rs:242-307`).

Graph pointer-chasing (BFS queue + heap + visited set) does not batch,
so a layer search becomes an iterative frontier expansion over
rectangles:

- the beam is a sorted (Q, ef) best-candidate set (the ef-bounded
  max-heap),
- each step expands the best not-yet-expanded beam entry per query:
  gather its padded neighbour row (deg,), gather neighbour vectors,
  one batched distance einsum, dedup against beam membership (the
  visited-set equivalent), merge with `lax.top_k`,
- terminates when no query's beam changed (all frontiers exhausted),
  under a static step bound.

Distances are cosine distance ``1 - dot`` on normalized vectors
(parity with `cosine_similarity_simd`, `base.rs:158-223`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vers_tpu.ops.topk import fused_scan_topk, topk_smallest

_BIG = jnp.inf


@functools.partial(
    jax.jit, static_argnames=("ef", "max_steps", "expand_per_step")
)
def beam_search_layer(
    queries,      # (Q, d) f32
    vecs,         # (n_pad, d) node vectors (compact ids)
    adj,          # (n_pad, deg) int32 neighbour compact ids, -1 pad
    entry,        # (Q,) or (Q, S) int32 compact entry node(s) per query
    ef: int,
    max_steps: int,
    expand_per_step: int = 4,
    scales=None,  # (n_pad,) f32 per-row dequant scales for an int8 table
    entry_d=None, # (Q, S) f32 precomputed seed distances (optional)
):
    """Returns (beam_d (Q, ef) ascending, beam_i (Q, ef) int32; -1/inf
    padding). Emulates one HNSWLayer::search with ef candidates.

    ``entry`` may carry S seed nodes per query (e.g. the top-S of a
    brute-force routing scan); the beam starts from all of them. Seeds
    must be distinct per query (or -1 padding); ``entry_d`` supplies
    their distances when the caller already computed them.

    ``expand_per_step``: how many best unexpanded beam entries expand
    per iteration. 1 = classic sequential best-first; 4 = same frontier
    explored in ~4x fewer (wider) steps — recall-neutral in practice,
    large wall-clock win for the batched query path.

    ``scales``: when ``vecs`` is an int8 table (symmetric per-row
    quantization), the per-row dequant scales. The beam loop is bound
    by the random row gathers of neighbour vectors; int8 halves the
    gathered bytes vs bf16. Ranking-only — callers f32-rescore."""
    q_n, d = queries.shape
    n_pad, deg = adj.shape
    e = max(1, min(expand_per_step, ef))

    # navigation runs in the vector table's dtype: a bf16/int8 table
    # cuts the memory traffic of the (Q, m, d) gathers in this loop
    is_int8 = vecs.dtype == jnp.int8
    q_nav = queries.astype(jnp.bfloat16 if is_int8 else vecs.dtype)

    def dist_to(ids):
        # ids (Q, m) -> (Q, m) cosine distances; -1 -> +inf
        safe = jnp.clip(ids, 0, n_pad - 1)
        v = jnp.take(vecs, safe, axis=0)  # (Q, m, d)
        if is_int8:
            v = v.astype(jnp.bfloat16)
        dots = jnp.einsum(
            "qmd,qd->qm", v, q_nav,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        if is_int8:
            dots = dots * jnp.take(scales, safe, axis=0)
        return jnp.where(ids >= 0, 1.0 - dots, _BIG)

    entry = entry.astype(jnp.int32)
    if entry.ndim == 1:
        entry = entry[:, None]
    s = min(entry.shape[1], ef)
    entry = entry[:, :s]
    seed_d = dist_to(entry) if entry_d is None else entry_d[:, :s]
    seed_d = jnp.where(entry >= 0, seed_d, _BIG)
    beam_i = jnp.full((q_n, ef), -1, jnp.int32).at[:, :s].set(entry)
    beam_d = jnp.full((q_n, ef), _BIG).at[:, :s].set(seed_d)
    expanded = jnp.zeros((q_n, ef), bool)
    col = jax.lax.broadcasted_iota(jnp.int32, (q_n, ef), 1)

    def cond(state):
        step, _, _, _, active = state
        return jnp.logical_and(step < max_steps, active)

    def body(state):
        step, beam_d, beam_i, expanded, _ = state
        # pick the E best unexpanded entries per query
        cand_rank = jnp.where(expanded | (beam_i < 0), _BIG, beam_d)
        pick_d, pick = topk_smallest(cand_rank, e)                 # (Q, E)
        has_pick = pick_d < _BIG
        picked = jnp.where(
            has_pick, jnp.take_along_axis(beam_i, pick, axis=1), -1
        )
        onehot = jnp.any(
            (col[:, None, :] == pick[:, :, None]) & has_pick[:, :, None],
            axis=1,
        )
        expanded = expanded | onehot

        nbrs = jnp.take(
            adj, jnp.clip(picked, 0, n_pad - 1), axis=0
        )                                                          # (Q, E, deg)
        nbrs = jnp.where(has_pick[:, :, None], nbrs, -1).reshape(q_n, e * deg)
        nd = dist_to(nbrs)
        # visited-equivalent: drop neighbours already in beam, and
        # duplicates among this step's E expanded adjacency rows
        dup_beam = jnp.any(nbrs[:, :, None] == beam_i[:, None, :], axis=2)
        ncol = jax.lax.broadcasted_iota(jnp.int32, (e * deg, e * deg), 1)
        nrow = jax.lax.broadcasted_iota(jnp.int32, (e * deg, e * deg), 0)
        dup_self = jnp.any(
            (nbrs[:, :, None] == nbrs[:, None, :]) & (ncol < nrow)[None],
            axis=2,
        )
        nd = jnp.where((dup_beam | dup_self) & (nbrs >= 0), _BIG, nd)

        cat_d = jnp.concatenate([beam_d, nd], axis=1)
        cat_i = jnp.concatenate([beam_i, nbrs], axis=1)
        cat_e = jnp.concatenate(
            [expanded, jnp.zeros((q_n, e * deg), bool)], axis=1
        )
        new_d, sel = topk_smallest(cat_d, ef)
        new_i = jnp.take_along_axis(cat_i, sel, axis=1)
        new_e = jnp.take_along_axis(cat_e, sel, axis=1)
        new_i = jnp.where(jnp.isfinite(new_d), new_i, -1)

        # still active while any query has an unexpanded finite entry
        frontier = jnp.any(
            (~new_e) & (new_i >= 0) & jnp.isfinite(new_d), axis=1
        )
        active = jnp.any(frontier)
        return step + 1, new_d, new_i, new_e, active

    state = (
        jnp.array(0, jnp.int32),
        beam_d,
        beam_i,
        expanded,
        jnp.array(True),
    )
    _, beam_d, beam_i, _, _ = jax.lax.while_loop(cond, body, state)
    return beam_d, beam_i


@functools.partial(
    jax.jit,
    static_argnames=(
        "top_k", "ef", "ef_r", "rescore", "has_scales", "expand",
        "steps_cap",
    ),
)
def full_descent(
    queries,     # (Q, d) f32
    vecs_f32,    # (n_pad, d) f32 (rescore table)
    vecs_nav,    # (n_pad, d) nav dtype
    scales,      # (n_pad,) f32 (int8 dequant) or (1,) dummy
    adjs,        # tuple of (n_pad, deg_l) int32, layers 0..L-2
    entry,       # (Q,) int32 entry rows (top-layer entrypoint)
    top_k: int,
    ef: int,
    ef_r: int,
    rescore: bool,
    has_scales: bool,
    expand: int = 4,
    steps_cap=None,
):
    """The WHOLE query descent — routing beams on layers L-2..1, the
    ef-wide layer-0 beam, and the exact f32 rescore — as ONE compiled
    program (one device dispatch instead of one per layer; on a remote
    device link each dispatch costs a round trip, and fusing also lets
    XLA overlap the layer boundaries). ``adjs`` holds the searched
    layers only (the reference never searches the top layer,
    `hnsw.rs:526`). Returns (d (Q, top_k), ids (Q, top_k))."""
    beam_d = beam_i = None
    for layer_idx in range(len(adjs) - 1, -1, -1):
        ef_l = ef if layer_idx == 0 else ef_r
        beam_d, beam_i = beam_search_layer(
            queries,
            vecs_nav,
            adjs[layer_idx],
            entry,
            ef=ef_l,
            max_steps=steps_cap or max(4 * ef_l, 64),
            expand_per_step=min(max(1, expand), ef_l),
            scales=scales if has_scales else None,
        )
        if layer_idx != 0:
            entry = beam_i[:, 0]
    if rescore:
        beam_d, beam_i = rescore_cosine(queries, vecs_f32, beam_i, top_k)
    return beam_d[:, :top_k], beam_i[:, :top_k]


@functools.partial(
    jax.jit,
    static_argnames=(
        "top_k", "ef", "seeds", "rescore", "has_scales", "expand",
        "steps_cap", "scan_chunk",
    ),
)
def full_descent_scan(
    queries,      # (Q, d) f32
    vecs_f32,     # (n_pad, d) f32 (rescore table)
    vecs_nav,     # (n_pad, d) nav dtype
    scales,       # (n_pad,) f32 (int8 dequant) or (1,) dummy
    adj0,         # (n_pad, deg) int32 layer-0 adjacency
    l1_tab,       # (n1_pad, d) bf16 layer-1 member vectors, contiguous
    l1_members,   # (n1_pad,) int32 compact node id of each l1 row
    n1,           # live rows of l1_tab (traced ok)
    top_k: int,
    ef: int,
    seeds: int,
    rescore: bool,
    has_scales: bool,
    expand: int = 8,
    steps_cap=None,
    scan_chunk: int = 16384,
):
    """Query descent with BRUTE-FORCE ROUTING: instead of greedy beam
    routing through layers L-2..1 (the reference's descent,
    `hnsw.rs:516-541`), one matmul scan over the layer-1 node
    subset finds the exact (within bf16) top-``seeds`` entry points,
    which seed the layer-0 beam directly.

    Rationale: upper HNSW layers exist only to cheaply locate an entry
    point. Every node of every layer >= 1 is also a member of layer 1
    (HNSW nesting invariant), so scanning layer 1 strictly dominates
    any routing descent — and that scan is one dense bf16 matmul over
    ~n/(2M) rows while beam routing is a serial chain of random row
    gathers. The multi-seed start also warms the layer-0 beam with ``seeds`` good
    candidates instead of one, cutting its step count.

    Returns (d (Q, top_k), ids (Q, top_k))."""
    q_scan = queries.astype(l1_tab.dtype)
    seed_d, seed_pos = fused_scan_topk(
        q_scan,
        l1_tab,
        n1,
        min(seeds, ef),
        metric="cosine",
        chunk_size=scan_chunk,
        precision=jax.lax.Precision.DEFAULT,
    )
    n1_pad = l1_members.shape[0]
    seed_ids = jnp.where(
        seed_pos >= 0,
        jnp.take(l1_members, jnp.clip(seed_pos, 0, n1_pad - 1)),
        -1,
    )
    beam_d, beam_i = beam_search_layer(
        queries,
        vecs_nav,
        adj0,
        seed_ids,
        ef=ef,
        max_steps=steps_cap or max(4 * ef, 64),
        expand_per_step=min(max(1, expand), ef),
        scales=scales if has_scales else None,
        entry_d=seed_d,
    )
    if rescore:
        beam_d, beam_i = rescore_cosine(queries, vecs_f32, beam_i, top_k)
    return beam_d[:, :top_k], beam_i[:, :top_k]


@functools.partial(
    jax.jit,
    static_argnames=("efc", "l_ins", "expand", "steps_cap", "has_scales"),
)
def insertion_candidates(
    query,       # (1, d) f32 — the vector being inserted
    vecs_f32,    # (n_pad, d) f32 rescore table
    vecs_nav,    # (n_pad, d) nav dtype
    scales,      # (n_pad,) f32 or (1,) dummy
    adjs,        # tuple of (n_pad, deg_l) int32, layers 0..L-1 (ALL layers)
    entry,       # (1,) int32 top-layer entry row
    efc: int,
    l_ins: int,
    expand: int = 8,
    steps_cap=None,
    has_scales: bool = False,
):
    """Device-side insertion descent for an incremental ``add`` on a
    device-built graph (the batched re-expression of `_add_node`'s search
    phase, `hnsw.rs:348-416`): beams route from the TOP layer down
    (insertion searches the top layer too, unlike queries), and every
    layer <= ``l_ins`` emits its f32-rescored efc-wide candidate set
    plus the candidates' f32 vectors (for the host-side heuristic
    neighbour selection, which needs candidate-to-candidate distances).

    Returns (cand_d (l_ins+1, efc), cand_i (l_ins+1, efc),
    cand_vecs (l_ins+1, efc, d)); row j holds layer ``l_ins - j``."""
    outs_d, outs_i = [], []
    n_pad = vecs_f32.shape[0]
    for l in range(len(adjs) - 1, -1, -1):
        beam_d, beam_i = beam_search_layer(
            query,
            vecs_nav,
            adjs[l],
            entry,
            ef=efc,
            max_steps=steps_cap or max(4 * efc, 64),
            expand_per_step=min(max(1, expand), efc),
            scales=scales if has_scales else None,
        )
        if l <= l_ins:
            rd, ri = rescore_cosine(query, vecs_f32, beam_i, efc)
            outs_d.append(rd[0])
            outs_i.append(ri[0])
        entry = beam_i[:, :1]
    cand_d = jnp.stack(outs_d)                     # (l_ins+1, efc)
    cand_i = jnp.stack(outs_i)
    cand_v = jnp.take(
        vecs_f32, jnp.clip(cand_i, 0, n_pad - 1), axis=0
    )                                              # (l_ins+1, efc, d)
    return cand_d, cand_i, cand_v


@functools.partial(jax.jit, static_argnames=("top_k",))
def rescore_cosine(queries, vecs_f32, ids, top_k: int):
    """Exact f32 rescore of beam results (after bf16 navigation):
    gather the top candidates' f32 vectors, recompute 1-dot, and
    re-sort ascending. Returns (d (Q, top_k), ids (Q, top_k))."""
    n_pad = vecs_f32.shape[0]
    cand = ids[:, :top_k]
    v = jnp.take(vecs_f32, jnp.clip(cand, 0, n_pad - 1), axis=0)
    dots = jnp.einsum(
        "qmd,qd->qm", v, queries,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    d = jnp.where(cand >= 0, 1.0 - dots, _BIG)
    d_sorted, sel = topk_smallest(d, top_k)
    i_sorted = jnp.take_along_axis(cand, sel, axis=1)
    i_sorted = jnp.where(jnp.isfinite(d_sorted), i_sorted, -1)
    return d_sorted, i_sorted
