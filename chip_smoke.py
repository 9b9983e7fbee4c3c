#!/usr/bin/env python3
"""Smoke test of vers-tpu on one NVIDIA GPU: the index-and-query path at
the reference's data size, through the index classes' normal entry
points, with every answer checked against a reference.

    python chip_smoke.py                 # one GPU, the whole smoke
    python chip_smoke.py --four-cards    # four GPUs: sharded classes only
    python chip_smoke.py --time-engines  # one GPU: scan engine timings (IVF, forest)

Phases of the default run (data: a clustered synthetic corpus made on
the device from ``--seed``, rows L2-normalised):

1. device: a GPU or nothing; prints the card, JAX and device memory;
2. ivf: IVFFlat at 1M x 300 (the wiki-news-300d-1M shape the
   reference's main.rs loads), build(2048, 2, 10), add one vector,
   search_batch Q=16384 at nprobe 1 and 4 and at the default adaptive
   depth with recall@10 against exact FlatIndex search on the card,
   search_approximate, save/load with identical ids, the kernel and XLA
   engines with identical ids at nprobe 4, and the adaptive search
   (whose sentinel-gated probe ranks the kernel leaves unwritten)
   against float64 numpy over each query's probed clusters on 2048
   queries (at this depth the XLA twin walks every gated rank's work
   items one after another: on an H100 it added about four minutes of
   compile and run to the phase);
3. kernels: the packed-scan kernel against its XLA twin on that IVF
   layout, and the flat exact scan against a float64 numpy reference on
   1024 queries;
4. graph: HNSW (reference params 12, 100, 32, 24; ef=32) and the RP
   forest (8 trees, leaves <= 100, 4 probes per tree; the default
   deficit-gated probes on both engines, compared) at 100k x 300 — cut
   from 1M to keep the smoke short.

``--four-cards`` runs only the sharded phase on a four-GPU mesh, at the
GloVe-1.2M shape (1.2M x 100, cosine): ShardedFlatIndex against one
card's FlatIndex (identical ids), ShardedIVFFlatIndex (k=1024; recall
at nprobe=1) and PartitionedHNSWIndex recall, each within
SHARD_RECALL_MARGIN of its one-card counterpart's — the
HNSW pair cut to 100k rows, since the partitioned build runs its
shards one after another.

Each phase prints its time beside the card's name; these are smoke
times, not benchmark numbers. A failed check exits non-zero, and the
last line of stdout is then not printed: it is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# distances are f32 at Precision.HIGHEST on both sides of every kernel
# check: only the summation order differs (relative error ~1e-6 at
# d=300 for distances in [0, 4] on unit rows)
KERNEL_RTOL = KERNEL_ATOL = 1e-5
# flat f32 scan vs float64 numpy: the |q|^2 + |x|^2 - 2 q.x expansion
# in f32 loses ~1e-6 absolute on unit rows
FLAT_RTOL, FLAT_ATOL = 1e-5, 2e-5
# a sharded index and its one-card counterpart build different
# clusterings (k-means initialisations) or graphs (one per shard), so
# their recalls differ by the build's luck; a broken shard merge or
# layout loses far more than this
SHARD_RECALL_MARGIN = 0.05

TOP_K = 10


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_name() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
    return out[0] if out else "nvidia-smi printed nothing"


def log(msg: str) -> None:
    print(msg, flush=True)


def clustered(n: int, d: int, n_clusters: int, n_queries: int, seed: int,
              noise: float = 0.5):
    """(corpus (n, d), queries (n_queries, d)) f32 host arrays: Gaussian
    blobs around ``n_clusters`` centres, queries drawn near corpus
    points, all rows L2-normalised. Made on the device in bulk."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
    def make(key, n, d, c, q):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        centres = 2.0 * jax.random.normal(k1, (c, d), jnp.float32)
        assign = jax.random.randint(k2, (n,), 0, c)
        x = centres[assign] + jax.random.normal(k3, (n, d), jnp.float32)
        pick = jax.random.randint(k4, (q,), 0, n)
        qs = x[pick] + noise * jax.random.normal(k5, (q, d), jnp.float32)
        unit = lambda a: a / jnp.linalg.norm(a, axis=1, keepdims=True)
        return unit(x), unit(qs)

    x, q = make(jax.random.PRNGKey(seed), n, d, n_clusters, n_queries)
    return np.asarray(x), np.asarray(q)


def same_up_to_ties(ids_a, d_a, ids_b, d_b, rtol: float, atol: float):
    """Two top-k answers agree when their distances agree rank by rank
    within tolerance, an id in both has the same distance in both, and
    an id in only one sits at the k-th distance (a boundary tie).
    Returns (ok, rows whose ids differ at all)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    d_a, d_b = np.asarray(d_a, np.float64), np.asarray(d_b, np.float64)
    if ids_a.shape != ids_b.shape:
        return False, ids_a.shape[0]
    if not np.allclose(d_a, d_b, rtol=rtol, atol=atol):
        return False, int((ids_a != ids_b).any(axis=1).sum())
    diff = np.nonzero((ids_a != ids_b).any(axis=1))[0]
    for r in diff:
        a = {int(i): v for i, v in zip(ids_a[r], d_a[r]) if i >= 0}
        b = {int(i): v for i, v in zip(ids_b[r], d_b[r]) if i >= 0}
        kth = max(d_a[r][np.isfinite(d_a[r])].max(initial=0.0),
                  d_b[r][np.isfinite(d_b[r])].max(initial=0.0))
        for i in set(a) & set(b):
            if not np.isclose(a[i], b[i], rtol=rtol, atol=atol):
                return False, len(diff)
        for i in set(a) ^ set(b):
            dist = a.get(i, b.get(i))
            if dist < kth - (atol + rtol * abs(kth)):
                return False, len(diff)
    return True, len(diff)


def recall(pred, truth) -> float:
    from vers_tpu.utils.harness import recall_at_k

    return recall_at_k(pred, truth)


def check_result(res, q_n: int, name: str, complete: bool = True):
    """Shapes, ascending distances, ids exactly where distances are
    finite; ``complete`` also asks for top_k answers per query (an IVF
    probe of small clusters may hold fewer)."""
    ids, d = res.ids, res.distances
    check(ids.shape == (q_n, TOP_K), f"{name}: ids shape {ids.shape}")
    check(d.shape == (q_n, TOP_K), f"{name}: distances shape {d.shape}")
    found = ids >= 0
    check((found == np.isfinite(d)).all(), f"{name}: ids and distances disagree")
    check(not np.isnan(d).any(), f"{name}: NaN distances")
    check(found[:, 0].all(), f"{name}: a query found nothing")
    check(found.all() or not complete, f"{name}: fewer than {TOP_K} found")
    check((np.where(found[:, 1:], np.diff(np.where(found, d, 0), axis=1),
                    0) >= 0).all(), f"{name}: distances not ascending")


# -- phases ------------------------------------------------------------


def phase_device(require_gpu: bool = True) -> dict:
    import jax

    devs = jax.devices()
    dev = devs[0]
    if require_gpu and dev.platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX found {dev.platform} ({dev.device_kind})"
        )
    stats = dev.memory_stats() or {}
    log(f"card: {card_name()}")
    log(f"jax {jax.__version__}: {len(devs)} x {dev.platform} "
        f"{dev.device_kind}, bytes_limit {stats.get('bytes_limit', 'n/a')}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs)}


def xla_agrees(idx, search, res, name: str):
    """Where "auto" runs the kernel, runs ``search()`` again with the
    index on the XLA engine and checks both answers agree up to ties.
    Returns the rows whose ids differ (tied), or None on a platform with
    one engine."""
    import dataclasses

    from vers_tpu.engine import resolve_engine

    if resolve_engine("auto", TOP_K) != "pallas":
        return None
    auto = idx.config
    idx.config = dataclasses.replace(auto, engine="xla")
    try:
        res_x = search()
    finally:
        idx.config = auto
    ok, n_diff = same_up_to_ties(res.ids, res.distances, res_x.ids,
                                 res_x.distances, KERNEL_RTOL, KERNEL_ATOL)
    check(ok, f"{name}: kernel and XLA engines differ ({n_diff} rows)")
    return n_diff


def adaptive_matches_reference(idx, queries, res, x_all, n_ref: int):
    """IVF's default adaptive search is the exact top_k over the union
    of each query's active probes; later ranks are gated to a sentinel
    bin that no work item owns, so the kernel never writes their rows.
    Checks the first ``n_ref`` rows of ``res`` against that union scored
    in float64 numpy (the probes are the index's own). Returns (probe
    depth, rows whose ids differ at ties)."""
    import jax.numpy as jnp

    from vers_tpu.ops.binned import adaptive_probe_depth, adaptive_probes

    layout = idx._ensure_layout()
    num_bins = layout["num_bins"]
    p_max = adaptive_probe_depth(
        layout.get("true_sizes_host", layout["sizes_host"]), TOP_K
    )
    probes = np.asarray(adaptive_probes(
        jnp.asarray(queries[:n_ref]), idx._centroids_dev, layout["size"],
        num_bins, p_max, TOP_K,
    ))
    rbin = np.asarray(layout["rbin"])
    rows = np.asarray(layout["sorted_to_orig"])[rbin >= 0]
    rbin = rbin[rbin >= 0]
    order = np.argsort(rbin, kind="stable")
    rows, rbin = rows[order], rbin[order]
    bounds = np.searchsorted(rbin, np.arange(num_bins + 1))
    ref_i = np.full((n_ref, TOP_K), -1, np.int64)
    ref_d = np.full((n_ref, TOP_K), np.inf)
    for r in range(n_ref):
        members = np.concatenate(
            [rows[bounds[b]:bounds[b + 1]] for b in probes[r] if b < num_bins]
        )
        diff = x_all[members].astype(np.float64) - queries[r]
        d2 = np.einsum("nd,nd->n", diff, diff)
        o = np.argsort(d2, kind="stable")[:TOP_K]
        ref_i[r, :len(o)], ref_d[r, :len(o)] = members[o], d2[o]
    ok, n_diff = same_up_to_ties(res.ids[:n_ref], res.distances[:n_ref],
                                 ref_i, ref_d, FLAT_RTOL, FLAT_ATOL)
    check(ok, f"ivf adaptive vs float64 over the probed clusters: "
          f"{n_diff} rows differ")
    return p_max, n_diff


def exact_truth(x, queries):
    """Exact top-k on the card (FlatIndex): the ground truth."""
    from vers_tpu.index.flat import FlatIndex

    res = FlatIndex.build_index(x).search_batch(queries, TOP_K)
    check_result(res, queries.shape[0], "flat exact")
    return res


def phase_ivf(x, queries, truth_ids, n_clusters: int, attempts: int = 2,
              iterations: int = 10, n_ref: int = 2048) -> dict:
    """IVFFlat through its public API; returns the index and recalls."""
    from vers_tpu.engine import resolve_engine
    from vers_tpu.index.ivfflat import IVFFlatIndex

    out = {}
    t0 = time.perf_counter()
    idx = IVFFlatIndex.build_index(n_clusters, attempts, iterations, x)
    out["build_s"] = time.perf_counter() - t0

    # add: the new row takes id n (reference quirk) and is its own NN
    new_vec = queries[0] + 0.01
    new_vec /= np.linalg.norm(new_vec)
    idx.add(new_vec, 0)
    got = idx.search_batch(new_vec[None], TOP_K, nprobe=1)
    check(got.ids[0, 0] == x.shape[0], f"ivf add: got {got.ids[0, :3]}")

    q_n = queries.shape[0]
    for nprobe in (1, 4):
        res = idx.search_batch(queries, TOP_K, nprobe=nprobe)
        check_result(res, q_n, f"ivf nprobe={nprobe}", complete=False)
        out[f"recall_nprobe{nprobe}"] = recall(res.ids, truth_ids)
        out[f"res_nprobe{nprobe}"] = res
    check(out["recall_nprobe4"] >= out["recall_nprobe1"] - 1e-3,
          f"ivf: nprobe=4 recall {out['recall_nprobe4']} below nprobe=1")
    # the default: per-query adaptive depth, later ranks sentinel-gated
    res_a = idx.search_batch(queries, TOP_K)
    check_result(res_a, q_n, "ivf adaptive", complete=False)
    out["recall_adaptive"] = recall(res_a.ids, truth_ids)
    out["adaptive_depth"], out["adaptive_rows_differing"] = (
        adaptive_matches_reference(idx, queries, res_a,
                                   np.vstack([x, new_vec[None]]), n_ref)
    )

    # the reference's adaptive walk gathers top_k candidates
    pairs = idx.search_approximate(queries[1], TOP_K)
    check(len(pairs) == TOP_K, f"ivf search_approximate: {len(pairs)} results")
    dists = [p[1] for p in pairs]
    check(dists == sorted(dists) and np.isfinite(dists).all(),
          "ivf search_approximate: distances not ascending and finite")

    # the same engine on the same data after a save/load round trip
    res4 = out["res_nprobe4"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ivfflat.index")
        idx.save_index(path)
        re = IVFFlatIndex.load_index(path, config=idx.config)
    res_re = re.search_batch(queries, TOP_K, nprobe=4)
    ok, n_diff = same_up_to_ties(res4.ids, res4.distances, res_re.ids,
                                 res_re.distances, 0.0, 0.0)
    check(ok, f"ivf save/load: ids differ beyond exact ties ({n_diff} rows)")
    out["reload_rows_differing"] = n_diff

    # the XLA engine, where "auto" runs the kernel
    out["engines_rows_differing"] = xla_agrees(
        idx, lambda: idx.search_batch(queries, TOP_K, nprobe=4), res4,
        "ivf nprobe=4",
    )
    out["engine"] = resolve_engine("auto", TOP_K)
    out["index"] = idx
    return out


def phase_kernels(idx, queries, x, n_ref: int = 1024) -> dict:
    """Kept kernels against their XLA twins, and the flat scan against
    float64 numpy."""
    import jax.numpy as jnp

    from vers_tpu.engine import resolve_engine
    from vers_tpu.ops.binned import binned_topk_fused
    from vers_tpu.ops.topk import fused_scan_topk

    out = {}
    qdev = jnp.asarray(queries)
    if resolve_engine("auto", TOP_K) == "pallas":
        layout = idx._ensure_layout()
        for nprobe in (1, 4):
            ans = {
                eng: binned_topk_fused(
                    qdev, idx._centroids_dev, nprobe, layout, TOP_K,
                    dedup=False, engine=eng,
                )
                for eng in ("pallas", "xla")
            }
            (kd, ki), (xd, xi) = ans["pallas"], ans["xla"]
            ok, n_diff = same_up_to_ties(ki, kd, xi, xd, KERNEL_RTOL,
                                         KERNEL_ATOL)
            kd, xd = np.asarray(kd), np.asarray(xd)
            live = np.isfinite(xd)
            err = float(np.abs(kd[live] - xd[live]).max(initial=0.0))
            check(ok, f"packed-scan kernel vs XLA at nprobe={nprobe}: "
                  f"{n_diff} rows differ, max |dd| {err}")
            out[f"kernel_nprobe{nprobe}"] = (n_diff, err)

    # flat exact scan vs a float64 reference
    q = queries[:n_ref]
    n = x.shape[0]
    fd, fi = fused_scan_topk(jnp.asarray(q), jnp.asarray(x), n, TOP_K)
    x64 = x.astype(np.float64)
    xx = np.einsum("nd,nd->n", x64, x64)
    ref_i = np.empty((q.shape[0], TOP_K), np.int64)
    ref_d = np.empty((q.shape[0], TOP_K), np.float64)
    for s in range(0, q.shape[0], 128):
        qs = q[s:s + 128].astype(np.float64)
        d2 = np.einsum("qd,qd->q", qs, qs)[:, None] + xx[None] - 2 * qs @ x64.T
        part = np.argpartition(d2, TOP_K, axis=1)[:, :TOP_K]
        pd = np.take_along_axis(d2, part, axis=1)
        o = np.argsort(pd, axis=1, kind="stable")
        ref_i[s:s + 128] = np.take_along_axis(part, o, axis=1)
        ref_d[s:s + 128] = np.take_along_axis(pd, o, axis=1)
    ok, n_diff = same_up_to_ties(fi, fd, ref_i, ref_d, FLAT_RTOL, FLAT_ATOL)
    err = float(np.abs(np.asarray(fd, np.float64) - ref_d).max())
    check(ok, f"flat exact vs float64: {n_diff} rows differ, max |dd| {err}")
    out["flat_vs_f64"] = (n_diff, err)
    return out


def phase_graph(x, queries, truth_ids) -> dict:
    """HNSW and the RP forest through their public APIs."""
    from vers_tpu.index.hnsw import HNSWIndex
    from vers_tpu.index.lsh import ANNIndex

    out = {}
    q_n = queries.shape[0]
    t0 = time.perf_counter()
    hnsw = HNSWIndex.build_index_batched(12, 100, 32, 24, x)
    out["hnsw_build_s"] = time.perf_counter() - t0
    res = hnsw.search_batch(queries, TOP_K)
    check_result(res, q_n, "hnsw ef=32")
    out["hnsw_recall"] = recall(res.ids, truth_ids)

    t0 = time.perf_counter()
    forest = ANNIndex.build_index(8, 100, x, np.arange(x.shape[0]))
    out["forest_build_s"] = time.perf_counter() - t0
    res = forest.search_batch(queries, TOP_K, probes_per_tree=4)
    check_result(res, q_n, "forest probes=4")
    out["forest_recall"] = recall(res.ids, truth_ids)
    # the default: deficit-gated probes, on both engines
    res_d = forest.search_batch(queries, TOP_K)
    check_result(res_d, q_n, "forest default probes")
    out["forest_default_recall"] = recall(res_d.ids, truth_ids)
    out["forest_engines_rows_differing"] = xla_agrees(
        forest, lambda: forest.search_batch(queries, TOP_K), res_d,
        "forest default probes",
    )
    return out


def phase_four_cards(n: int, d: int, q_n: int, n_clusters: int,
                     n_graph: int, seed: int, n_devices: int = 4) -> dict:
    """The sharded classes on an n_devices mesh, each beside its one-card
    counterpart: ShardedFlatIndex must return one card's ids;
    ShardedIVFFlatIndex and PartitionedHNSWIndex report recall."""
    import jax

    from vers_tpu.config import FlatConfig
    from vers_tpu.index.flat import FlatIndex
    from vers_tpu.index.hnsw import HNSWIndex
    from vers_tpu.index.ivfflat import IVFFlatIndex
    from vers_tpu.parallel import (
        PartitionedHNSWIndex,
        ShardedFlatIndex,
        ShardedIVFFlatIndex,
    )
    from vers_tpu.parallel.mesh import make_mesh

    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, found {len(jax.devices())}")
    mesh = make_mesh(n_devices)
    x, queries = clustered(n, d, 1024, q_n, seed)
    out = {}

    one = FlatIndex.build_index(x).search_batch(queries, TOP_K)
    sharded = ShardedFlatIndex.build_index(x, mesh=mesh, metric="cosine")
    placed = {s.device for s in sharded._data.addressable_shards}
    check(len(placed) == n_devices,
          f"sharded corpus sits on {len(placed)} devices, not {n_devices}")
    one_cos = FlatIndex.build_index(
        x, config=FlatConfig(metric="cosine")
    ).search_batch(queries, TOP_K)
    res = sharded.search_batch(queries, TOP_K)
    ok, n_diff = same_up_to_ties(one_cos.ids, one_cos.distances, res.ids,
                                 res.distances, KERNEL_RTOL, KERNEL_ATOL)
    check(ok, f"ShardedFlatIndex vs FlatIndex: {n_diff} rows differ")
    out["flat_rows_differing"] = n_diff
    out["flat_devices"] = len(placed)
    truth = one.ids

    ivf1 = IVFFlatIndex.build_index(n_clusters, 2, 10, x)
    ivf4 = ShardedIVFFlatIndex.build_index(n_clusters, 2, 10, x, mesh=mesh)
    for nprobe in (1, 4):
        for name, idx in (("one", ivf1), ("sharded", ivf4)):
            out[f"ivf_{name}_recall_nprobe{nprobe}"] = recall(
                idx.search_batch(queries, TOP_K, nprobe=nprobe).ids, truth
            )
    placed = {s.device for s in ivf4._ensure_state()["corpus"].addressable_shards}
    check(len(placed) == n_devices,
          f"sharded IVF layout sits on {len(placed)} devices")
    one, shard = out["ivf_one_recall_nprobe1"], out["ivf_sharded_recall_nprobe1"]
    check(shard >= one - SHARD_RECALL_MARGIN,
          f"sharded IVF recall@10 at nprobe=1 {shard} vs one card's {one}")

    xg, qg = x[:n_graph], queries[: min(q_n, 4096)]
    tg = FlatIndex.build_index(xg).search_batch(qg, TOP_K).ids
    h1 = HNSWIndex.build_index_batched(12, 100, 32, 24, xg)
    out["hnsw_one_recall"] = recall(h1.search_batch(qg, TOP_K).ids, tg)
    h4 = PartitionedHNSWIndex.build_index(12, 100, 32, 24, xg, mesh=mesh)
    out["hnsw_partitioned_recall"] = recall(h4.search_batch(qg, TOP_K).ids, tg)
    one, part = out["hnsw_one_recall"], out["hnsw_partitioned_recall"]
    check(part >= one - SHARD_RECALL_MARGIN,
          f"partitioned HNSW recall@10 {part} vs one card's {one}")
    return out


def time_engines(seed: int, card: str,
                 shapes=((1_000_000, 300, 2048), (1_000_000, 128, 1024)),
                 engines=("pallas", "xla"), q_n: int = 16384) -> list:
    """Scan engines on the card, end to end through search_batch from
    host arrays (best of 5 after a warm-up call): IVF at nprobe 1 and 4
    on each shape, and on the first shape the forest (8 trees, leaves
    <= 100, 4 probes per tree) and the flat exact scan. Returns the
    rows it logs."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from vers_tpu.index.ivfflat import IVFFlatIndex
    from vers_tpu.index.lsh import ANNIndex
    from vers_tpu.ops.topk import fused_scan_topk
    from vers_tpu.utils.profiling import timed_device

    rows = []

    def engine_times(idx, row, search):
        for engine in engines:
            idx.config = dataclasses.replace(idx.config, engine=engine)
            t, _ = timed_device(search, warmup=1, iters=5)
            row[f"{engine}_ms"] = t * 1e3
        log("engine-time " + json.dumps(row))
        rows.append(row)

    for i, (n, d, k) in enumerate(shapes):
        x, queries = clustered(n, d, 1024, q_n, seed)
        idx = IVFFlatIndex.build_index(k, 2, 10, x)
        for nprobe in (1, 4):
            engine_times(
                idx, {"card": card, "index": "ivf", "n": n, "d": d, "k": k,
                      "nprobe": nprobe, "q": q_n},
                lambda: idx.search_batch(queries, TOP_K, nprobe=nprobe),
            )
        del idx
        if i == 0:
            forest = ANNIndex.build_index(8, 100, x, np.arange(n))
            engine_times(
                forest, {"card": card, "index": "forest", "n": n, "d": d,
                         "trees": 8, "probes_per_tree": 4, "q": q_n},
                lambda: forest.search_batch(queries, TOP_K,
                                            probes_per_tree=4),
            )
            del forest
            qdev, xdev = jnp.asarray(queries), jnp.asarray(x)
            t, _ = timed_device(
                lambda: fused_scan_topk(qdev, xdev, n, TOP_K),
                warmup=1, iters=5,
            )
            row = {"card": card, "index": "flat", "n": n, "d": d, "q": q_n,
                   "fused_scan_topk_ms": t * 1e3}
            log("engine-time " + json.dumps(row))
            rows.append(row)
            del qdev, xdev
        jax.clear_caches()
    return rows


def run(args) -> dict:
    from vers_tpu.utils.profiling import enable_compilation_cache

    device = phase_device()
    enable_compilation_cache()
    card = card_name()

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s on {card}")
        return out

    if args.four_cards:
        out = timed("four-cards", phase_four_cards, 1_200_000, 100, 16384,
                    1024, 100_000, args.seed)
        for k, v in out.items():
            log(f"four-cards {k}: {v}")
        return device
    if args.time_engines:
        timed("time-engines", time_engines, args.seed, card)
        return device

    n, d, q_n, k = 1_000_000, 300, 16384, 2048
    n_graph, q_graph = 100_000, 4096
    x, queries = timed("data", clustered, n, d, 1024, q_n, args.seed)
    truth = timed("exact", exact_truth, x, queries)
    ivf = timed("ivf", phase_ivf, x, queries, truth.ids, k)
    log(f"ivf {x.shape[0]}x{d} k={k} engine={ivf['engine']}: build "
        f"{ivf['build_s']:.1f} s, recall@10 nprobe=1 "
        f"{ivf['recall_nprobe1']:.4f}, nprobe=4 {ivf['recall_nprobe4']:.4f}, "
        f"adaptive {ivf['recall_adaptive']:.4f}; save/load ids identical "
        f"({ivf['reload_rows_differing']} rows with exact ties reordered); "
        f"kernel and XLA engines agree at nprobe=4 (rows with tied ids: "
        f"{ivf['engines_rows_differing']}); adaptive (depth "
        f"{ivf['adaptive_depth']}) matches float64 over its probed clusters "
        f"on 2048 queries (rows with tied ids: "
        f"{ivf['adaptive_rows_differing']})")
    kern = timed("kernels", phase_kernels, ivf["index"], queries, x)
    for key, (n_diff, err) in kern.items():
        log(f"check {key}: agrees (rows with tied ids {n_diff}, "
            f"max |d - d_ref| {err:.3g})")
    del ivf
    xg, qg = x[:n_graph], queries[:q_graph]
    tg = exact_truth(xg, qg).ids
    graph = timed("graph", phase_graph, xg, qg, tg)
    log(f"hnsw {xg.shape[0]}x{d} (12, 100, 32, 24) ef=32: recall@10 "
        f"{graph['hnsw_recall']:.4f}, build {graph['hnsw_build_s']:.1f} s")
    log(f"forest {xg.shape[0]}x{d} 8 trees: recall@10 probes=4 "
        f"{graph['forest_recall']:.4f}, default probes "
        f"{graph['forest_default_recall']:.4f}, build "
        f"{graph['forest_build_s']:.1f} s; kernel and XLA engines agree at "
        f"default probes (rows with tied ids: "
        f"{graph['forest_engines_rows_differing']})")
    check(graph["hnsw_recall"] > 0.5, f"hnsw recall {graph['hnsw_recall']}")
    check(graph["forest_recall"] > 0.3,
          f"forest recall {graph['forest_recall']}")
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase, on four GPUs")
    ap.add_argument("--time-engines", action="store_true",
                    help="time the scan engines on the card")
    args = ap.parse_args(argv)
    try:
        device = run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
