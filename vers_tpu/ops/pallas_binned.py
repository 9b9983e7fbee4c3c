"""Packed binned scan as a Pallas kernel on the Triton route (Hopper).

The kernel form of `ops/binned.scan_packed`: same work items, same
outputs. The XLA twin runs the work items as a `lax.scan`, one small
matmul + mask + top-k + update per step, serially. Here every work item
is one program, so the items run in parallel across the card's SMs.

A work item is a window of ``q_blk`` bin-sorted query rows that starts
at ``qstart``. It owns the rows ``[qstart, qend)``: they all lie in one
group of whole bins, and no other item owns them, so the programs write
disjoint rows and need no carry between them. The item scans only the
corpus rows of the bins its owned queries probe (not the whole group), ``chunk`` rows at a time, with the feature axis in
``bk``-wide K-steps (power-of-two tiles; no padding of d). A
bin-equality mask keeps each query scored against its own bin only. Each
chunk folds into a running (q_blk, kp) best set by k extract-min passes
that merge the chunk's candidates with the carried set; a chunk that
cannot beat any row's k-th best skips the merge.

Distances are f32: the dot runs at the precision the caller names, and
"highest" lowers to Triton's IEEE f32 dot, not TF32. Ties break toward
the lower sorted-corpus row, as `topk_smallest` does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Largest top_k the kernel serves: the extract-min merge costs k passes
# per chunk, and the carried best set is (q_blk, next_pow2(k)).
MAX_KERNEL_K = 128

_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _kernel(qs_ref, qe_ref, rlo_ref, rhi_ref, q_ref, qbin_ref, x_ref,
            rbin_ref, out_d_ref, out_i_ref, *, k: int, kp: int, q_blk: int,
            chunk: int, bk: int, d: int, n_rows: int, metric: str,
            precision: str):
    w = pl.program_id(0)
    qs = qs_ref[w]
    qe = qe_ref[w]
    rlo = rlo_ref[w]
    rhi = rhi_ref[w]
    prec = _PRECISIONS[precision]

    # K-steps over the feature axis: whole bk-wide steps, then (when bk
    # does not divide d) one step over the LAST bk columns with the
    # columns an earlier step covered masked out — every load stays in
    # bounds and no operand needs padding to a power of two
    kcol = jnp.arange(bk, dtype=jnp.int32)
    steps = [(k0, None) for k0 in range(0, d - d % bk, bk)]
    if d % bk:
        steps.append((d - bk, (d - bk + kcol >= d - d % bk)[None, :]))

    def q_tile(k0, kmask):
        ref = q_ref.at[pl.ds(qs, q_blk), pl.ds(k0, bk)]
        if kmask is None:
            return plgpu.load(ref)
        return plgpu.load(ref, mask=kmask, other=0.0)

    qq = sum(jnp.sum(t * t, axis=1) for t in (q_tile(*s) for s in steps))
    qbin = qbin_ref[pl.ds(qs, q_blk)]
    col = jax.lax.broadcasted_iota(jnp.int32, (q_blk, chunk), 1)
    colk = jax.lax.broadcasted_iota(jnp.int32, (q_blk, kp), 1)
    inf = jnp.float32(jnp.inf)

    def merge(cd, r0, bd, bi):
        """k extract-min passes over (chunk candidates, carried set)."""

        def one(t, carry):
            cd, bd_left, od, oi = carry
            a1 = jnp.argmin(cd, axis=1).astype(jnp.int32)
            m1 = jnp.min(cd, axis=1)
            a2 = jnp.argmin(bd_left, axis=1).astype(jnp.int32)
            m2 = jnp.min(bd_left, axis=1)
            take = m1 < m2  # ties keep the carried (lower) row
            i2 = jnp.sum(jnp.where(colk == a2[:, None], bi, 0), axis=1)
            m = jnp.where(take, m1, m2)
            pos = jnp.where(take, r0 + a1, i2)
            od = jnp.where(colk == t, m[:, None], od)
            oi = jnp.where(colk == t, pos[:, None], oi)
            cd = jnp.where(take[:, None] & (col == a1[:, None]), inf, cd)
            bd_left = jnp.where(
                ~take[:, None] & (colk == a2[:, None]), inf, bd_left
            )
            return cd, bd_left, od, oi

        _, _, od, oi = jax.lax.fori_loop(
            0, k, one,
            (cd, bd, jnp.full((q_blk, kp), inf, jnp.float32),
             jnp.full((q_blk, kp), -1, jnp.int32)),
        )
        return od, oi

    def body(c, carry):
        bd, bi = carry
        r0 = rlo + c * chunk
        rows = r0 + jnp.arange(chunk, dtype=jnp.int32)
        live = rows < jnp.minimum(rhi, n_rows)
        acc = jnp.zeros((q_blk, chunk), jnp.float32)
        xx = jnp.zeros((chunk,), jnp.float32)
        for k0, kmask in steps:
            xmask = live[:, None] if kmask is None else live[:, None] & kmask
            xt = plgpu.load(
                x_ref.at[pl.ds(r0, chunk), pl.ds(k0, bk)],
                mask=xmask, other=0.0,
            )
            acc += jax.lax.dot_general(
                q_tile(k0, kmask), xt, (((1,), (1,)), ((), ())),
                precision=prec, preferred_element_type=jnp.float32,
            )
            xx += jnp.sum(xt * xt, axis=1)
        if metric == "cosine":
            dist = 1.0 - acc
        else:
            dist = jnp.maximum(qq[:, None] + xx[None, :] - 2.0 * acc, 0.0)
        rb = plgpu.load(rbin_ref.at[pl.ds(r0, chunk)], mask=live, other=-1)
        ok = (qbin[:, None] == rb[None, :]) & (qbin[:, None] >= 0)
        dist = jnp.where(ok, dist, inf)
        kth = jnp.sum(jnp.where(colk == k - 1, bd, 0.0), axis=1)
        improves = jnp.sum(jnp.where(dist < kth[:, None], 1, 0)) > 0
        return jax.lax.cond(
            improves, lambda: merge(dist, r0, bd, bi), lambda: (bd, bi)
        )

    n_chunks = jnp.where(qe > qs, (rhi - rlo + chunk - 1) // chunk, 0)
    bd, bi = jax.lax.fori_loop(
        0, n_chunks, body,
        (jnp.full((q_blk, kp), inf, jnp.float32),
         jnp.full((q_blk, kp), -1, jnp.int32)),
    )
    owned = (qs + jnp.arange(q_blk, dtype=jnp.int32) < qe)[:, None]
    plgpu.store(out_d_ref.at[pl.ds(qs, q_blk), :], bd, mask=owned)
    plgpu.store(
        out_i_ref.at[pl.ds(qs, q_blk), :],
        jnp.where(bd < inf, bi, -1), mask=owned,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "top_k", "q_blk", "chunk", "num_bins", "metric", "precision",
        "interpret",
    ),
)
def kernel_scan_packed(
    q_sorted,       # (Q_pad, d) queries sorted by bin
    qbin_sorted,    # (Q_pad,) bin per sorted query (-1 / num_bins: none)
    qstart,         # (W,) int32 first query row of each work item
    qend,           # (W,) int32 end of the rows the item owns
    corpus_sorted,  # (n_pad, d) bin-major
    rbin,           # (n_pad,) int32 bin per sorted row (-1 pad)
    top_k: int,
    q_blk: int,
    chunk: int,
    num_bins: int,
    metric: str = "sq_euclidean",
    precision: str = "highest",
    interpret: bool = False,
):
    """`scan_packed` on the Triton-route kernel. Returns (res_d, res_i)
    of shape (Q_pad + q_blk, top_k) over sorted query rows; res_i holds
    sorted-corpus rows, -1 where invalid. Rows whose bin is not a real
    bin (padding, gated probe ranks) read (inf, -1)."""
    if q_blk != next_pow2(q_blk) or chunk != next_pow2(chunk):
        raise ValueError("q_blk and chunk must be powers of two")
    if min(q_blk, chunk) < 16:
        raise ValueError("q_blk and chunk must be >= 16")
    if top_k > MAX_KERNEL_K:
        raise ValueError(f"top_k {top_k} > MAX_KERNEL_K {MAX_KERNEL_K}")
    q_pad, d = q_sorted.shape
    if d < 16:  # a Triton dot needs K >= 16; zero columns change nothing
        q_sorted = jnp.pad(q_sorted, ((0, 0), (0, 16 - d)))
        corpus_sorted = jnp.pad(corpus_sorted, ((0, 0), (0, 16 - d)))
        d = 16
    n_rows = corpus_sorted.shape[0]
    kp = max(next_pow2(top_k), 16)
    bk = min(64, next_pow2(d + 1) // 2)  # largest power of two <= d
    q_ext = jnp.pad(q_sorted, ((0, q_blk), (0, 0)))
    qbin_ext = jnp.pad(qbin_sorted, (0, q_blk), constant_values=-1)
    # corpus rows of the owned bins: rows are bin-major, and the running
    # max carries each bin's id over its slack and padding rows (-1)
    mono = jax.lax.cummax(rbin, axis=0)
    b_first = qbin_ext[qstart]
    b_last = qbin_ext[jnp.maximum(qend - 1, qstart)]
    rlo = jnp.searchsorted(mono, b_first, side="left").astype(jnp.int32)
    rhi = jnp.searchsorted(mono, b_last, side="right").astype(jnp.int32)
    rows_out = q_pad + q_blk
    kernel = functools.partial(
        _kernel, k=top_k, kp=kp, q_blk=q_blk, chunk=chunk, bk=bk, d=d,
        n_rows=n_rows, metric=metric, precision=precision,
    )
    out_d, out_i = pl.pallas_call(
        kernel,
        grid=(qstart.shape[0],),
        out_shape=[
            jax.ShapeDtypeStruct((rows_out, kp), jnp.float32),
            jax.ShapeDtypeStruct((rows_out, kp), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="binned_packed_scan",
    )(qstart, qend, rlo, rhi, q_ext, qbin_ext, corpus_sorted, rbin)
    # rows no work item owns were never written
    real = ((qbin_ext >= 0) & (qbin_ext < num_bins))[:, None]
    res_d = jnp.where(real, out_d[:, :top_k], jnp.inf)
    res_i = jnp.where(real, out_i[:, :top_k], -1)
    return res_d, res_i
