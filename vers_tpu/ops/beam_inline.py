"""Neighborhood-inlined beam search — fewer, wider gathers for the HNSW
layer-0 beam at large n.

The classic batched beam step (`ops/beam.beam_search_layer`) gathers
``Q * expand * deg`` individual neighbour vector rows per iteration: at
1M x 300, ef=32, expand=8, deg=48 that is ~6.3M random row reads per
step. Where a device's random gathers cost per row rather than per
byte, no dtype shrink helps; on a GPU each thin row is also a poorly
coalesced read. Whether the inline table wins on the H100 has not been
measured yet (ROADMAP Queue 1 #5).

This module restructures the data instead (the DiskANN/"neighborhood
footprint" idea): a build-time INLINE table holds,
for every node v, the concatenation of v's neighbours' PCA-projected,
renormalized bf16 vectors:

    inline[v] = concat(proj[adj[v, 0]], ..., proj[adj[v, deg-1]])
                                                    (n_pad, deg * dp)

One beam step then gathers only ``Q * expand`` wide rows (48x fewer
row ops at deg=48) plus the same (Q, expand) adjacency id rows, and the
distance computation becomes a dense (Q, e*deg, dp) x (Q, dp) einsum on
contiguous data. Navigation ranks by PROJECTED cosine
(both sides renormalized after projection); the caller f32-rescores the
final beam exactly, so only candidate SELECTION sees the projection.

Reference being re-expressed: the layer search `vers/src/indexes/
hnsw.rs:242-307` (same beam/visited semantics as `beam_search_layer`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vers_tpu.ops.topk import topk_smallest

_BIG = jnp.inf


def pca_projection(corpus, dp: int, sample: int = 131072):
    """Top-``dp`` PCA basis of the corpus (n_pad, d) -> (d, dp) f32.

    The covariance is one (d, d) matmul over a corpus slice on device;
    the (d, d) eigendecomposition runs on host (d ~ hundreds). No
    centering: rows are unit-norm and the beam only needs a
    rotation that concentrates dot-product energy in few dims."""
    import numpy as np

    n_pad = corpus.shape[0]
    s = min(sample, n_pad)
    xs = corpus[:s].astype(jnp.float32)
    cov = jnp.einsum(
        "nd,ne->de", xs, xs, precision=jax.lax.Precision.HIGHEST
    )
    cov = np.asarray(cov)
    _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
    basis = vecs[:, ::-1][:, :dp].copy()  # (d, dp) top components
    return jnp.asarray(basis, jnp.float32)


@functools.partial(jax.jit, static_argnames=("dp",))
def project_rows(vecs, basis, dp: int):
    """(m, d) x (d, dp) -> renormalized (m, dp) bf16 rows (zero rows
    stay zero)."""
    p = jnp.einsum(
        "md,de->me", vecs.astype(jnp.float32), basis,
        precision=jax.lax.Precision.HIGHEST,
    )
    norm = jnp.linalg.norm(p, axis=1, keepdims=True)
    p = p / jnp.maximum(norm, 1e-12)
    return p.astype(jnp.bfloat16)


@functools.partial(
    jax.jit, static_argnames=("dp", "row_chunk", "max_bytes")
)
def build_inline_table(proj, adj, dp: int, row_chunk: int = 65536,
                       max_bytes: int = 8 << 30):
    """(n_pad, dp) projected rows + (n_pad, deg) adjacency ->
    (n_pad, deg * dp) bf16 inline table (-1 neighbours -> zero rows,
    which renormalization never produces, so they rank at distance 1
    and the id mask in the step kills them anyway).

    Chunked over rows: the one-time n_pad * deg row gather at 1M x 48
    is ~48M row reads and would otherwise materialize a
    (n_pad, deg, dp) f32 intermediate.

    ``max_bytes`` guards the allocation: at 1M x deg48 x dp64 the table
    is ~6GB next to the corpus — refuse loudly rather than run the
    device out of memory (pick a smaller dp, or let
    nav_inline_dp="auto" budget it)."""
    n_pad, deg = adj.shape
    table_bytes = n_pad * deg * dp * 2
    if table_bytes > max_bytes:
        raise ValueError(
            f"inline table would be {table_bytes / 2**30:.1f} GB "
            f"({n_pad} rows x deg {deg} x dp {dp} bf16) "
            f"> the {max_bytes / 2**30:.1f} GB guard; reduce "
            f"nav_inline_dp (or use 'auto', which budgets it via "
            f"inline_hbm_budget_gb)"
        )

    def per_chunk(c, _):
        rows = jax.lax.dynamic_slice_in_dim(adj, c * row_chunk, row_chunk, 0)
        safe = jnp.clip(rows, 0, n_pad - 1)
        v = jnp.take(proj, safe, axis=0)  # (chunk, deg, dp)
        v = jnp.where((rows >= 0)[:, :, None], v, 0)
        return c + 1, v.reshape(row_chunk, deg * dp)

    n_chunks = (n_pad + row_chunk - 1) // row_chunk
    pad = n_chunks * row_chunk - n_pad
    adj = jnp.pad(adj, ((0, pad), (0, 0)), constant_values=-1)
    _, out = jax.lax.scan(per_chunk, 0, None, length=n_chunks)
    return out.reshape(n_chunks * row_chunk, deg * dp)[:n_pad]


@functools.partial(
    jax.jit,
    static_argnames=("ef", "max_steps", "expand_per_step", "refine_r"),
)
def beam_search_layer_inline(
    queries_p,    # (Q, dp) bf16 projected+renormalized queries
    inline_tab,   # (n_pad, deg * dp) bf16 inline neighbourhood table
    adj,          # (n_pad, deg) int32 neighbour ids, -1 pad
    entry,        # (Q, S) int32 seed nodes (-1 pad)
    entry_d,      # (Q, S) f32 seed distances (projected space, or exact
                  #         bf16 when refining — must match the beam's)
    ef: int,
    max_steps: int,
    expand_per_step: int = 8,
    refine_r: int = 0,
    queries_nav=None,  # (Q, d) bf16 full-dim (required when refining)
    vecs_nav=None,     # (n_pad, d) bf16 full-dim nav table (ditto)
):
    """`beam_search_layer` with the inline-neighbourhood step: same beam
    / visited semantics.

    ``refine_r == 0``: distances are projected cosine throughout —
    cheapest, but beam RETENTION is projected too, which collapses
    recall when true neighbours differ at projection-noise scale (dense
    clusters whose members sit closer than the projection's error).

    ``refine_r > 0`` (exact-refine): the projection only FILTERS — each
    step scores all expand*deg candidates in projected space, keeps the
    top ``refine_r``, gathers only those full-dim bf16 rows, and merges
    with EXACT distances; the beam ranks/retains in exact space end to
    end (seeds included). Row gathers per step drop from expand*deg to
    refine_r per query (4x at the 1M defaults) while recall tracks the
    gather beam — the projection's top-r just has to CONTAIN the
    improvements, not rank them."""
    q_n, dp = queries_p.shape
    n_pad, deg = adj.shape
    e = max(1, min(expand_per_step, ef))
    r = min(refine_r, e * deg) if refine_r else 0

    entry = entry.astype(jnp.int32)
    if entry.ndim == 1:
        entry = entry[:, None]
    s = min(entry.shape[1], ef)
    entry = entry[:, :s]
    seed_d = jnp.where(entry >= 0, entry_d[:, :s], _BIG)
    beam_i = jnp.full((q_n, ef), -1, jnp.int32).at[:, :s].set(entry)
    beam_d = jnp.full((q_n, ef), _BIG).at[:, :s].set(seed_d)
    expanded = jnp.zeros((q_n, ef), bool)
    col = jax.lax.broadcasted_iota(jnp.int32, (q_n, ef), 1)

    def cond(state):
        step, _, _, _, active = state
        return jnp.logical_and(step < max_steps, active)

    def body(state):
        step, beam_d, beam_i, expanded, _ = state
        cand_rank = jnp.where(expanded | (beam_i < 0), _BIG, beam_d)
        pick_d, pick = topk_smallest(cand_rank, e)                # (Q, E)
        has_pick = pick_d < _BIG
        picked = jnp.where(
            has_pick, jnp.take_along_axis(beam_i, pick, axis=1), -1
        )
        onehot = jnp.any(
            (col[:, None, :] == pick[:, :, None]) & has_pick[:, :, None],
            axis=1,
        )
        expanded = expanded | onehot

        safe = jnp.clip(picked, 0, n_pad - 1)
        nbrs = jnp.take(adj, safe, axis=0)                 # (Q, E, deg)
        nbrs = jnp.where(has_pick[:, :, None], nbrs, -1).reshape(
            q_n, e * deg
        )
        # THE payoff: E wide rows per query instead of E*deg thin ones
        blocks = jnp.take(inline_tab, safe, axis=0)        # (Q, E, deg*dp)
        nv = blocks.reshape(q_n, e * deg, dp)
        dots = jnp.einsum(
            "qmd,qd->qm", nv, queries_p,
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32,
        )
        nd = jnp.where(nbrs >= 0, 1.0 - dots, _BIG)

        dup_beam = jnp.any(nbrs[:, :, None] == beam_i[:, None, :], axis=2)
        ncol = jax.lax.broadcasted_iota(jnp.int32, (e * deg, e * deg), 1)
        nrow = jax.lax.broadcasted_iota(jnp.int32, (e * deg, e * deg), 0)
        dup_self = jnp.any(
            (nbrs[:, :, None] == nbrs[:, None, :]) & (ncol < nrow)[None],
            axis=2,
        )
        nd = jnp.where((dup_beam | dup_self) & (nbrs >= 0), _BIG, nd)

        if r:
            # exact-refine: projection gates the top-r candidates, the
            # beam merges on EXACT bf16 full-dim distances
            sc, sel = topk_smallest(nd, r)
            cand = jnp.take_along_axis(nbrs, sel, axis=1)    # (Q, r)
            cand = jnp.where(jnp.isfinite(sc), cand, -1)
            cv = jnp.take(
                vecs_nav, jnp.clip(cand, 0, n_pad - 1), axis=0
            )                                                # (Q, r, d)
            cd = jnp.einsum(
                "qmd,qd->qm", cv, queries_nav,
                precision=jax.lax.Precision.DEFAULT,
                preferred_element_type=jnp.float32,
            )
            nd = jnp.where(cand >= 0, 1.0 - cd, _BIG)
            nbrs = cand
        w = nbrs.shape[1]
        cat_d = jnp.concatenate([beam_d, nd], axis=1)
        cat_i = jnp.concatenate([beam_i, nbrs], axis=1)
        cat_e = jnp.concatenate(
            [expanded, jnp.zeros((q_n, w), bool)], axis=1
        )
        new_d, sel = topk_smallest(cat_d, ef)
        new_i = jnp.take_along_axis(cat_i, sel, axis=1)
        new_e = jnp.take_along_axis(cat_e, sel, axis=1)
        new_i = jnp.where(jnp.isfinite(new_d), new_i, -1)

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
    static_argnames=("top_k", "ef", "seeds", "expand", "steps_cap",
                     "scan_chunk", "refine_r"),
)
def full_descent_scan_inline(
    queries,      # (Q, d) f32
    vecs_f32,     # (n_pad, d) f32 rescore table
    vecs_nav,     # (n_pad, d) bf16 full-dim nav table (refine path)
    basis,        # (d, dp) f32 PCA basis
    proj,         # (n_pad, dp) bf16 projected+renormalized node rows
    inline_tab,   # (n_pad, deg * dp) bf16
    adj0,         # (n_pad, deg) int32
    l1_tab,       # (n1_pad, d) bf16 layer-1 member vectors
    l1_members,   # (n1_pad,) int32
    n1,
    top_k: int,
    ef: int,
    seeds: int,
    expand: int = 8,
    steps_cap=None,
    scan_chunk: int = 16384,
    refine_r: int = 0,
):
    """`full_descent_scan` with the inline layer-0 beam: full-dim bf16
    matmul scan over layer 1 for exact seeds, inline beam (projected, or
    projection-filtered exact when ``refine_r`` > 0), exact f32
    rescore. One compiled program."""
    from vers_tpu.ops.beam import rescore_cosine
    from vers_tpu.ops.topk import fused_scan_topk

    q_scan = queries.astype(l1_tab.dtype)
    scan_d, seed_pos = fused_scan_topk(
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
    dp = proj.shape[1]
    qp = project_rows(queries, basis, dp)
    n_pad = proj.shape[0]
    if refine_r:
        # the refined beam ranks in exact bf16 space — so do the seeds
        sd = scan_d
    else:
        # the pure-projected beam ranks in projected space — ditto
        sv = jnp.take(proj, jnp.clip(seed_ids, 0, n_pad - 1), axis=0)
        sd = 1.0 - jnp.einsum(
            "qsd,qd->qs", sv, qp,
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32,
        )
    beam_d, beam_i = beam_search_layer_inline(
        qp, inline_tab, adj0, seed_ids, sd,
        ef=ef,
        max_steps=steps_cap or max(4 * ef, 64),
        expand_per_step=min(max(1, expand), ef),
        refine_r=refine_r,
        queries_nav=q_scan,
        vecs_nav=vecs_nav,
    )
    # the projected ranking is noisier than bf16 full-dim navigation:
    # exact-rescore the WHOLE ef-wide beam (ef rows/query — trivial
    # next to the step gathers), then take top_k
    rd, ri = rescore_cosine(queries, vecs_f32, beam_i, ef)
    return rd[:, :top_k], ri[:, :top_k]
