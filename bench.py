"""Headline benchmark (BASELINE.json): batched QPS at recall@10 >= 0.95
on a wiki-300d-style corpus via IVFFlat, vs a CPU reference proxy.

Prints ONE JSON line:
  {"metric": ..., "value": QPS, "unit": "qps", "vs_baseline": ratio}

The Rust reference publishes no numbers and this image has no Rust
toolchain, so the baseline is a faithful CPU re-enactment of the
reference's per-query IVFFlat search (`ivfflat.rs:153-198`: centroid
argsort + one-cluster numpy scan per query, single-threaded like the
reference's query path), measured on the same data at the same recall
operating point.

Every engine row runs under failure isolation: a crashed extra
(LSH/HNSW rows) logs to stderr and omits its fields; the JSON headline
prints unconditionally once any operating point exists. Device state
is released between engines, so no two engines' layouts are held live
at once.

It runs on the GPU. With no GPU it stops, unless ``VERS_PLATFORM=cpu``
asks for the CPU explicitly; the JSON line names the device either way.

Side diagnostics (recall, build time, flat-scan QPS) go to stderr.
"""

import gc
import json
import os
import sys
import time

import numpy as np

N = int(os.environ.get("BENCH_N", 100_000))
DIM = int(os.environ.get("BENCH_D", 300))
Q = int(os.environ.get("BENCH_Q", 16384))
TOP_K = 10
K_CLUSTERS = int(os.environ.get("BENCH_K", 256))
TARGET_RECALL = 0.95


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_row(name, fn, retries=1):
    """Failure isolation for one engine row: returns fn() or None.
    Retries once on RESOURCE_EXHAUSTED (transient device-memory
    pressure) after a gc pass; any other failure logs and omits the
    row."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — isolation is the point
            msg = f"{type(e).__name__}: {e}"
            log(f"ROW[{name}] attempt {attempt + 1} failed: {msg[:300]}")
            if attempt < retries and "RESOURCE_EXHAUSTED" in msg:
                gc.collect()
                time.sleep(2.0)
                continue
            return None


def main():
    import jax

    if os.environ.get("VERS_PLATFORM"):
        jax.config.update("jax_platforms", os.environ["VERS_PLATFORM"])
    from vers_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp
    from vers_tpu.index.ivfflat import IVFFlatIndex
    from vers_tpu.ops.topk import fused_scan_topk
    from vers_tpu.core import round_up
    from vers_tpu.utils.data import dataset_path, load_wiki_vector, synthetic_gaussian
    from vers_tpu.utils.harness import recall_at_k
    from vers_tpu.utils.profiling import timed_device

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device={device}")
    if dev.platform != "gpu" and os.environ.get("VERS_PLATFORM") != "cpu":
        sys.exit(f"bench.py: no GPU (found {dev.platform}); "
                 "set VERS_PLATFORM=cpu to run on the CPU on purpose")

    wiki = dataset_path("wiki-news-300d-1M.vec")
    if wiki:
        vectors, _, _, _ = load_wiki_vector(wiki, dim=DIM, max_rows=N)
        rng = np.random.default_rng(0)
        queries = vectors[rng.integers(0, len(vectors), size=Q)]
        log(f"dataset=wiki n={len(vectors)}")
    else:
        vectors, queries = synthetic_gaussian(
            N, DIM, n_clusters=1024, n_queries=Q, seed=0, normalized=True,
            query_noise=0.5,
        )
        log(f"dataset=synthetic n={N} d={DIM}")

    # ground truth on device (exact fused scan)
    n = vectors.shape[0]
    n_pad = round_up(n, 128)
    corpus = jax.device_put(np.pad(vectors, ((0, n_pad - n), (0, 0))))
    qdev = jnp.asarray(queries)
    td, ti = fused_scan_topk(qdev, corpus, n, TOP_K)
    truth = np.asarray(ti)

    # flat exact QPS (diagnostic + fallback operating point)
    def row_flat():
        t_flat, _ = timed_device(
            lambda: fused_scan_topk(qdev, corpus, n, TOP_K),
            warmup=1, iters=2, depth=8,
        )
        log(f"flat exact: {Q / t_flat:.0f} qps ({t_flat*1e3:.1f} ms / {Q} queries)")
        return t_flat

    t_flat = run_row("flat-exact", row_flat)

    # release the flat-scan corpus before the binned engines build
    # their own layouts (device-memory isolation between engines)
    del corpus
    gc.collect()

    # IVFFlat build (jitted Lloyd, 2 restarts, 10 iters). The cold
    # number includes the one-time XLA compile; the warm number is the
    # steady-state rebuild cost a serving deployment actually pays, so
    # report both.
    def row_ivf_build():
        t0 = time.perf_counter()
        idx = IVFFlatIndex.build_index(K_CLUSTERS, 2, 10, vectors)
        cold = time.perf_counter() - t0
        log(f"ivfflat build k={K_CLUSTERS}: {cold:.2f}s (cold, incl. compile)")
        t0 = time.perf_counter()
        IVFFlatIndex.build_index(K_CLUSTERS, 2, 10, vectors)._ensure_layout()
        warm = time.perf_counter() - t0
        log(f"ivfflat build k={K_CLUSTERS}: {warm:.2f}s (warm cache)")
        idx._ensure_layout()
        return idx, cold, warm

    built = run_row("ivfflat-build", row_ivf_build)
    index, build_s, build_warm_s = built if built else (None, -1.0, -1.0)

    # CPU build proxy: single-threaded numpy re-enactment of the
    # reference's Lloyd loop (`ivfflat.rs:73-100`: full assignment pass
    # + per-vector centroid accumulation per iteration). Two iterations
    # are timed and extrapolated to the same schedule the device build
    # runs (2 restarts x 10 iterations).
    def lloyd_iter(x, cent):
        d2 = (
            np.sum(x * x, 1)[:, None]
            + np.sum(cent * cent, 1)[None, :]
            - 2.0 * x @ cent.T
        )
        a = np.argmin(d2, 1)
        newc = np.zeros_like(cent)
        np.add.at(newc, a, x)
        cnt = np.bincount(a, minlength=len(cent))
        nz = cnt > 0
        newc[nz] /= cnt[nz][:, None]
        return newc

    rng_c = np.random.default_rng(0)
    cent0 = vectors[rng_c.choice(n, K_CLUSTERS, replace=False)].copy()
    # at 1M-scale a full timed iteration takes minutes on one core;
    # time a row slice and scale (the pass is linear in rows)
    n_proxy = min(n, 200_000)
    t0 = time.perf_counter()
    cent1 = lloyd_iter(vectors[:n_proxy], cent0)
    lloyd_iter(vectors[:n_proxy], cent1)
    cpu_build_proxy_s = (
        (time.perf_counter() - t0) / 2 * (2 * 10) * (n / n_proxy)
    )
    log(f"cpu build proxy (extrapolated 2x10 Lloyd iters): "
        f"{cpu_build_proxy_s:.1f}s")

    # find the cheapest nprobe meeting the recall bar, then time it
    # (queries pre-placed on device: upload is not part of the timed path)
    budget_s = float(os.environ.get("BENCH_BUDGET", 480))

    def row_ivf():
        t_start = time.perf_counter()
        best = None
        for nprobe in (1, 2, 4, 8, 16, 32, 64):
            if nprobe > K_CLUSTERS:
                break
            res = index.search_batch(qdev, TOP_K, nprobe=nprobe)
            rec = recall_at_k(res.ids, truth)
            t_q, _ = timed_device(
                lambda np_=nprobe: index.search_batch_device(
                    qdev, TOP_K, nprobe=np_
                ),
                warmup=0, iters=2, depth=8,
            )
            qps = Q / t_q
            log(f"nprobe={nprobe}: recall@10={rec:.4f} qps={qps:.0f}")
            if best is None or rec >= TARGET_RECALL:
                best = (nprobe, rec, qps)
            if rec >= TARGET_RECALL or time.perf_counter() - t_start > budget_s:
                break
        return best

    ivf = run_row("ivfflat", row_ivf) if index is not None else None

    # pick the best operating point that meets the recall bar across
    # the engines measured so far (IVF sweep / exact flat)
    operating = []
    if ivf is not None:
        operating.append(("ivfflat",) + ivf)
    if t_flat is not None:
        operating.append(("flat-exact", 0, 1.0, Q / t_flat))
    ok = [o for o in operating if o[2] >= TARGET_RECALL] or operating
    if not ok:
        log("FATAL: every engine row failed — no operating point")
        print(json.dumps({
            "metric": f"batched QPS @ recall@10>={TARGET_RECALL} "
            "(all engines failed)",
            "value": 0.0, "unit": "qps", "vs_baseline": 0.0,
            "device": device,
        }))
        return
    engine, nprobe, rec, qps = max(ok, key=lambda o: o[3])
    log(f"operating point: {engine} nprobe={nprobe} recall={rec:.4f}")

    # LSH + HNSW operating points (one row each, so the driver artifact
    # documents all four engines). BENCH_FULL=0 skips.
    extra = ""
    if int(os.environ.get("BENCH_FULL", "1")):
        # drop the IVF device layout before LSH builds its forest state
        # (peak device-memory isolation); it lazily rebuilds from host
        # mirrors if searched again later.
        if index is not None:
            index._layout = None
            index._values_dev = None
        gc.collect()

        def row_lsh():
            from vers_tpu.index.lsh import ANNIndex

            t0 = time.perf_counter()
            lsh = ANNIndex.build_index(8, 100, vectors, np.arange(n))
            lsh_build_s = time.perf_counter() - t0
            res = lsh.search_batch(qdev, TOP_K)  # auto-probes (deficit rule)
            lsh_rec = recall_at_k(res.ids, truth)
            t_l, _ = timed_device(
                lambda: lsh.search_batch_device(qdev, TOP_K),
                warmup=1, iters=2, depth=8,
            )
            log(
                f"lsh auto-probes: recall@10={lsh_rec:.4f} "
                f"qps={Q / t_l:.0f} build={lsh_build_s:.1f}s"
            )
            # fixed probes=4: the deficit rule is parity-faithful but
            # conservative (lsh.rs:203-214); this row documents the
            # engine's real quality-throughput curve
            res4 = lsh.search_batch(qdev, TOP_K, probes_per_tree=4)
            rec4 = recall_at_k(res4.ids, truth)
            t_l4, _ = timed_device(
                lambda: lsh.search_batch_device(qdev, TOP_K, probes_per_tree=4),
                warmup=0, iters=2, depth=8,
            )
            log(f"lsh probes=4: recall@10={rec4:.4f} qps={Q / t_l4:.0f}")
            return (
                f"lsh_qps={Q / t_l:.0f}, lsh_recall={lsh_rec:.4f}, "
                f"lsh_p4_qps={Q / t_l4:.0f}, lsh_p4_recall={rec4:.4f}, "
            )

        part = run_row("lsh", row_lsh)
        if part:
            extra += ", " + part.rstrip(", ")
        gc.collect()  # lsh object (forest device state) now dead

        def row_hnsw():
            from vers_tpu.index.hnsw import HNSWIndex

            t0 = time.perf_counter()
            hnsw = HNSWIndex.build_index_batched(
                8, 100, 32, 16, vectors, wave_cap=2048
            )
            hnsw_build_s = time.perf_counter() - t0
            res = hnsw.search_batch(qdev, TOP_K)  # ef=32
            hnsw_rec = recall_at_k(res.ids, truth)
            t_h, _ = timed_device(
                lambda: hnsw.search_batch_device(qdev, TOP_K),
                warmup=1, iters=2, depth=8,
            )
            log(
                f"hnsw ef=32: recall@10={hnsw_rec:.4f} "
                f"qps={Q / t_h:.0f} build={hnsw_build_s:.1f}s"
            )
            return f"hnsw_qps={Q / t_h:.0f}, hnsw_recall={hnsw_rec:.4f}"

        part = run_row("hnsw", row_hnsw)
        if part:
            extra += ", " + part
        gc.collect()

    # CPU reference proxy: per-query adaptive IVF walk (single-threaded
    # numpy, mirroring ivfflat.rs:153-198)
    def row_proxy():
        if index is None:
            raise RuntimeError("no IVF index for the CPU proxy")
        n_cpu = min(200, Q)
        centroids = index._centroids
        members = [np.asarray(m, dtype=np.int64) for m in index._ids]
        values = index._values

        def proxy_pass():
            t0 = time.perf_counter()
            for qi in range(n_cpu):
                qv = queries[qi]
                cd = np.sum((centroids - qv[None, :]) ** 2, axis=1)
                order = np.argsort(cd)
                got = 0
                ci = 0
                while got < TOP_K and ci < len(order):
                    m = members[order[ci]]
                    if len(m):
                        d2 = np.sum((values[m] - qv[None, :]) ** 2, axis=1)
                        take = np.argsort(d2)[:TOP_K]
                        got += len(take)
                    ci += 1
            return time.perf_counter() - t0

        # best of two passes: the first warms the page and data caches,
        # whose cold-state variance otherwise swings the ratio
        return n_cpu / min(proxy_pass(), proxy_pass())

    cpu_qps = run_row("cpu-proxy", row_proxy)
    log(f"cpu reference proxy: {cpu_qps or 0:.0f} qps")

    ratio = qps / cpu_qps if cpu_qps else 0.0
    print(
        json.dumps(
            {
                "metric": f"batched QPS @ recall@10>={TARGET_RECALL} "
                f"(engine={engine}, n={n}, d={DIM}, k={K_CLUSTERS}, "
                f"nprobe={nprobe}, recall={rec:.4f}, "
                f"ivf_build_warm_s={build_warm_s:.2f}, "
                f"ivf_build_cold_s={build_s:.2f}, "
                f"cpu_build_proxy_s={cpu_build_proxy_s:.1f}"
                f"{extra})",
                "value": round(qps, 1),
                "unit": "qps",
                "vs_baseline": round(ratio, 2),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
