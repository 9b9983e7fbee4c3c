"""Level-synchronous random-hyperplane tree builder (device side).

Batched re-expression of the reference's recursive RP-tree construction
(`vers/src/indexes/lsh.rs:58-111`): instead of host recursion over
``Vec<usize>`` partitions, ALL nodes of one level split simultaneously:

- every vector carries a compact "alive node id"; a level is one
  batched pass: count members per node (scatter-add), pick two random
  members per splitting node (scatter-max over unique random
  priorities), form each hyperplane as the perpendicular bisector of
  the pair (parity with `build_hyperplane`, `lsh.rs:58-94`), project
  every vector onto its own node's plane (row gather + rowwise dot),
  and route it to child ``2*split + side``.
- nodes with fewer than ``max_node_size`` members freeze into leaves
  (parity with the `indexes.len() < max_size` rule, `lsh.rs:97`).

Static shapes: at most ceil(n/max_size) nodes can split per level (each
needs >= max_size disjoint members), so per-level tables are padded to
that bound and the whole build is one jitted ``lax.scan`` over levels.

The resulting per-level tables (hyperplanes + child/leaf routing) are
also exactly what the batched query descent needs, and they convert
losslessly to/from the reference's recursive Node enum for bincode
persistence (see `vers_tpu.index.lsh`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp



class ForestTables(NamedTuple):
    """Per-tree level tables. L = max_depth, S = alive-node cap,
    T = splitting-node cap.

    coeff:  (L, T, d) hyperplane normals
    const:  (L, T)    hyperplane constants
    split:  (L, S)    alive node -> split slot, or -1 if leaf/empty
    bucket: (L, S)    alive node -> leaf bucket id, or -1
    leaf_of_vec: (n,) bucket id per vector
    num_buckets: ()   int32
    """

    coeff: jnp.ndarray
    const: jnp.ndarray
    split: jnp.ndarray
    bucket: jnp.ndarray
    leaf_of_vec: jnp.ndarray
    num_buckets: jnp.ndarray


def depth_bound(n: int, max_size: int) -> int:
    """Levels needed assuming reasonably balanced random splits, plus
    slack for skew. Nodes still oversized at the bottom freeze into
    (oversized) leaves — a bounded deviation from the reference's
    unbounded recursion, documented in index/lsh.py."""
    if n <= max(max_size, 1):
        return 1
    return int(math.ceil(math.log2(n / max_size))) + 8


@functools.partial(jax.jit, static_argnames=("max_size", "max_depth"))
def build_tree(key, data: jnp.ndarray, n_valid, max_size: int, max_depth: int):
    """Build one RP tree over data (n_pad, d); rows >= n_valid ignored.
    Returns ForestTables."""
    n_pad, d = data.shape
    t_cap = max(int(n_pad // max(max_size, 1)) + 1, 2)
    s_cap = 2 * t_cap
    arange_n = jnp.arange(n_pad, dtype=jnp.int32)
    valid = arange_n < n_valid

    def level(carry, key_l):
        node, leaf_of_vec, bucket_counter = carry
        alive = (node >= 0) & valid
        node_c = jnp.where(alive, node, s_cap)  # dump slot s_cap

        counts = jnp.zeros((s_cap + 1,), jnp.int32).at[node_c].add(1)
        occupied = counts[:s_cap] > 0
        split_mask = counts[:s_cap] >= max_size
        leaf_mask = occupied & ~split_mask

        split_idx = jnp.where(
            split_mask, jnp.cumsum(split_mask.astype(jnp.int32)) - 1, -1
        )
        bucket_ids = jnp.where(
            leaf_mask,
            bucket_counter + jnp.cumsum(leaf_mask.astype(jnp.int32)) - 1,
            -1,
        )
        bucket_counter = bucket_counter + jnp.sum(leaf_mask.astype(jnp.int32))

        # -- pick two random members per splitting node ---------------
        perm = jax.random.permutation(key_l, n_pad).astype(jnp.int32)
        pr = jnp.where(alive, perm, -1)
        best_a = jnp.full((s_cap + 1,), -1, jnp.int32).at[node_c].max(pr)
        a_mask = alive & (pr == best_a[node_c]) & (pr >= 0)
        pr2 = jnp.where(a_mask, -1, pr)
        best_b = jnp.full((s_cap + 1,), -1, jnp.int32).at[node_c].max(pr2)
        b_mask = alive & (pr2 == best_b[node_c]) & (pr2 >= 0)

        a_row = (
            jnp.zeros((s_cap + 1,), jnp.int32)
            .at[jnp.where(a_mask, node_c, s_cap)]
            .add(jnp.where(a_mask, arange_n, 0))
        )[:s_cap]
        b_row = (
            jnp.zeros((s_cap + 1,), jnp.int32)
            .at[jnp.where(b_mask, node_c, s_cap)]
            .add(jnp.where(b_mask, arange_n, 0))
        )[:s_cap]

        # hyperplane per splitting node (parity with `lsh.rs:58-94`):
        # coeff = b - a, const = -coeff . (a + b)/2
        xa = jnp.take(data, a_row, axis=0)  # (S, d)
        xb = jnp.take(data, b_row, axis=0)
        coeff_node = xb - xa
        const_node = -jnp.sum(coeff_node * (xa + xb) * 0.5, axis=1)

        slot = jnp.where(split_mask, split_idx, t_cap)
        coeff_l = (
            jnp.zeros((t_cap + 1, d), jnp.float32)
            .at[slot]
            .add(jnp.where(split_mask[:, None], coeff_node, 0.0))
        )[:t_cap]
        const_l = (
            jnp.zeros((t_cap + 1,), jnp.float32)
            .at[slot]
            .add(jnp.where(split_mask, const_node, 0.0))
        )[:t_cap]

        # -- route every vector ---------------------------------------
        my_split = jnp.where(alive, split_idx[node_c % s_cap], -1)
        my_bucket = jnp.where(alive, bucket_ids[node_c % s_cap], -1)
        my_coeff = jnp.take(coeff_l, jnp.clip(my_split, 0, t_cap - 1), axis=0)
        proj = jnp.sum(data * my_coeff, axis=1) + jnp.take(
            const_l, jnp.clip(my_split, 0, t_cap - 1)
        )
        side = (proj >= 0.0).astype(jnp.int32)  # 1 = above = right

        settles = alive & (my_bucket >= 0)
        leaf_of_vec = jnp.where(settles, my_bucket, leaf_of_vec)
        node_next = jnp.where(
            alive & (my_split >= 0), 2 * my_split + side, -1
        )

        out = (split_idx, bucket_ids, coeff_l, const_l)
        return (node_next, leaf_of_vec, bucket_counter), out

    keys = jax.random.split(key, max_depth)
    init = (
        jnp.where(valid, 0, -1).astype(jnp.int32),
        jnp.full((n_pad,), -1, jnp.int32),
        jnp.array(0, jnp.int32),
    )
    (node, leaf_of_vec, bucket_counter), (split, bucket, coeff, const) = (
        jax.lax.scan(level, init, keys)
    )

    # vectors still alive after max_depth: freeze whole nodes into
    # leaves (extra buckets appended at the end)
    still = (node >= 0) & valid
    node_c = jnp.where(still, node, s_cap)
    occupied = jnp.zeros((s_cap + 1,), jnp.int32).at[node_c].add(1)[:s_cap] > 0
    extra = jnp.where(
        occupied,
        bucket_counter + jnp.cumsum(occupied.astype(jnp.int32)) - 1,
        -1,
    )
    leaf_of_vec = jnp.where(still, extra[jnp.clip(node, 0, s_cap - 1)], leaf_of_vec)
    bucket_counter = bucket_counter + jnp.sum(occupied.astype(jnp.int32))

    # overflow level tables: the frozen nodes live at level L as leaves
    split_last = jnp.full((1, s_cap), -1, jnp.int32)
    bucket_last = extra[None, :]
    coeff_last = jnp.zeros((1, coeff.shape[1], d), jnp.float32)
    const_last = jnp.zeros((1, const.shape[1]), jnp.float32)

    return ForestTables(
        coeff=jnp.concatenate([coeff, coeff_last], axis=0),
        const=jnp.concatenate([const, const_last], axis=0),
        split=jnp.concatenate([split, split_last], axis=0),
        bucket=jnp.concatenate([bucket, bucket_last], axis=0),
        leaf_of_vec=leaf_of_vec,
        num_buckets=bucket_counter,
    )


@functools.partial(jax.jit, static_argnames=())
def descend(queries: jnp.ndarray, coeff, const, split, bucket):
    """Route a (Q, d) query batch to leaf buckets. Returns (Q,) int32
    bucket ids (parity with the main-branch descent of `tree_result`,
    `lsh.rs:203-214`; the deficit/backup rule lives in the host parity
    path)."""
    q_n = queries.shape[0]
    L, t_cap, d = coeff.shape
    s_cap = split.shape[1]

    def level(carry, tables):
        v, out = carry
        coeff_l, const_l, split_l, bucket_l = tables
        alive = v >= 0
        vc = jnp.clip(v, 0, s_cap - 1)
        my_split = jnp.where(alive, split_l[vc], -1)
        my_bucket = jnp.where(alive, bucket_l[vc], -1)
        c = jnp.take(coeff_l, jnp.clip(my_split, 0, t_cap - 1), axis=0)
        proj = jnp.sum(queries * c, axis=1) + jnp.take(
            const_l, jnp.clip(my_split, 0, t_cap - 1)
        )
        side = (proj >= 0.0).astype(jnp.int32)
        out = jnp.where(alive & (my_bucket >= 0), my_bucket, out)
        v = jnp.where(alive & (my_split >= 0), 2 * my_split + side, -1)
        return (v, out), None

    init = (
        jnp.zeros((q_n,), jnp.int32),
        jnp.full((q_n,), -1, jnp.int32),
    )
    (_, out), _ = jax.lax.scan(level, init, (coeff, const, split, bucket))
    return out


def _descend_once(queries, coeff, const, split, bucket, flip_level):
    """Route queries to leaves, flipping the decision at ``flip_level``
    (per query; -1 = no flip). Returns (buckets (Q,), margins (Q, L) =
    |proj| at each traversed split, +inf elsewhere)."""
    q_n = queries.shape[0]
    L, t_cap, d = coeff.shape
    s_cap = split.shape[1]

    def level(carry, inp):
        v, out = carry
        l, coeff_l, const_l, split_l, bucket_l = inp
        alive = v >= 0
        vc = jnp.clip(v, 0, s_cap - 1)
        my_split = jnp.where(alive, split_l[vc], -1)
        my_bucket = jnp.where(alive, bucket_l[vc], -1)
        c = jnp.take(coeff_l, jnp.clip(my_split, 0, t_cap - 1), axis=0)
        proj = jnp.sum(queries * c, axis=1) + jnp.take(
            const_l, jnp.clip(my_split, 0, t_cap - 1)
        )
        side = (proj >= 0.0).astype(jnp.int32)
        side = jnp.where(flip_level == l, 1 - side, side)
        margin = jnp.where(alive & (my_split >= 0), jnp.abs(proj), jnp.inf)
        out = jnp.where(alive & (my_bucket >= 0), my_bucket, out)
        v = jnp.where(alive & (my_split >= 0), 2 * my_split + side, -1)
        return (v, out), margin

    init = (jnp.zeros((q_n,), jnp.int32), jnp.full((q_n,), -1, jnp.int32))
    (_, out), margins = jax.lax.scan(
        level,
        init,
        (jnp.arange(L, dtype=jnp.int32), coeff, const, split, bucket),
    )
    return out, margins.T  # (Q,), (Q, L)


def _descend_once_flat(queries, coeff_flat, const_flat, cbase_t, split,
                       bucket, flip_level):
    """`_descend_once` on the PACKED hyperplane layout: hyperplanes of
    all trees/levels live in one (total_tests, d) array; ``cbase_t``
    (L,) maps this tree's level l to its first row. Identical routing
    (same coefficients, same tie rules) — the dense (T, L, TC, d)
    layout is mostly padding (~2.2GB at 1M x 300 x 8 trees) while the packed one is the sum of actual inner nodes
    (~24MB per 1M-row tree)."""
    q_n = queries.shape[0]
    total = coeff_flat.shape[0]
    L, s_cap = split.shape

    def level(carry, inp):
        v, out = carry
        l, cb_l, split_l, bucket_l = inp
        alive = v >= 0
        vc = jnp.clip(v, 0, s_cap - 1)
        my_split = jnp.where(alive, split_l[vc], -1)
        my_bucket = jnp.where(alive, bucket_l[vc], -1)
        row = jnp.clip(cb_l + jnp.clip(my_split, 0, None), 0, total - 1)
        c = jnp.take(coeff_flat, row, axis=0)
        proj = jnp.sum(queries * c, axis=1) + jnp.take(const_flat, row)
        side = (proj >= 0.0).astype(jnp.int32)
        side = jnp.where(flip_level == l, 1 - side, side)
        margin = jnp.where(alive & (my_split >= 0), jnp.abs(proj), jnp.inf)
        out = jnp.where(alive & (my_bucket >= 0), my_bucket, out)
        v = jnp.where(alive & (my_split >= 0), 2 * my_split + side, -1)
        return (v, out), margin

    init = (jnp.zeros((q_n,), jnp.int32), jnp.full((q_n,), -1, jnp.int32))
    (_, out), margins = jax.lax.scan(
        level,
        init,
        (jnp.arange(L, dtype=jnp.int32), cbase_t, split, bucket),
    )
    return out, margins.T  # (Q,), (Q, L)


@functools.partial(jax.jit, static_argnames=("n_probes",))
def descend_forest_flat(queries, coeff_flat, const_flat, cbase, splits,
                        buckets, offsets, n_probes: int):
    """`descend_forest` on the packed hyperplane layout (see
    `_descend_once_flat`): cbase (T, L) int32, splits/buckets
    (T, L, SC) int32, offsets (T,). Returns (Q, T*n_probes) bins —
    identical to the dense variant's output."""
    T = splits.shape[0]
    q_n = queries.shape[0]
    outs = []
    for t in range(T):
        main, margins = _descend_once_flat(
            queries, coeff_flat, const_flat, cbase[t], splits[t],
            buckets[t], jnp.full((q_n,), -1, jnp.int32),
        )
        outs.append(main + offsets[t])
        if n_probes > 1:
            order = jnp.argsort(margins, axis=1)  # ascending margin
            for j in range(1, n_probes):
                fl = order[:, j - 1].astype(jnp.int32)
                bj, _ = _descend_once_flat(
                    queries, coeff_flat, const_flat, cbase[t], splits[t],
                    buckets[t], fl,
                )
                outs.append(jnp.where(bj >= 0, bj + offsets[t], outs[-1]))
    return jnp.stack(outs, axis=1)


@functools.partial(jax.jit, static_argnames=("n_probes",))
def descend_forest(queries, coeffs, consts, splits, buckets, offsets,
                   n_probes: int):
    """One dispatch: multiprobe descent through EVERY tree.

    Tree tables stacked on a leading axis (T, L, ...); ``offsets`` (T,)
    shift each tree's bucket ids into the combined-layout bin space.
    Probe 0 is the main leaf; probe j flips the split decision with the
    j-th smallest |projection| margin (classic multiprobe — recovers
    the recall the reference's backup-branch rule provides,
    `lsh.rs:203-214`, in batched form). Returns (Q, T*n_probes) bins.
    """
    T = coeffs.shape[0]
    q_n = queries.shape[0]
    outs = []
    for t in range(T):
        main, margins = _descend_once(
            queries, coeffs[t], consts[t], splits[t], buckets[t],
            jnp.full((q_n,), -1, jnp.int32),
        )
        outs.append(main + offsets[t])
        if n_probes > 1:
            order = jnp.argsort(margins, axis=1)  # ascending margin
            for j in range(1, n_probes):
                fl = order[:, j - 1].astype(jnp.int32)
                bj, _ = _descend_once(
                    queries, coeffs[t], consts[t], splits[t], buckets[t], fl
                )
                outs.append(jnp.where(bj >= 0, bj + offsets[t], outs[-1]))
    return jnp.stack(outs, axis=1)
