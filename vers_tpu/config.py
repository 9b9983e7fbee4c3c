"""Configuration dataclasses for vers_tpu.

The reference has no config system at all — every hyperparameter is a
positional literal at a call site (e.g. HNSW ``(12, 100, 32, 24)`` at
`vers/src/main.rs:70-79`). We promote them to explicit dataclasses so
benchmarks / CLIs can sweep them, while keeping the same positional
constructor signatures on the index classes for parity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FlatConfig:
    """Exact brute-force index (the `search_exhaustive` equivalent,
    `vers/src/utils.rs:68-82`, promoted to a first-class index)."""

    metric: str = "sq_euclidean"  # or "cosine"
    dtype: str = "float32"  # compute dtype for the distance matmul
    chunk_size: int = 16384  # corpus rows per fused-scan step


@dataclasses.dataclass(frozen=True)
class IVFFlatConfig:
    """IVFFlat: k-means partitioning + nearest-cluster scan
    (`vers/src/indexes/ivfflat.rs`)."""

    num_clusters: int = 64
    num_attempts: int = 2  # random restarts, best by k-means cost
    max_iterations: int = 10  # Lloyd iteration cap
    # The reference has no nprobe: its search adaptively scans more
    # clusters only while fewer than top_k candidates were found
    # (`ivfflat.rs:166-195`). nprobe=0 selects that adaptive behavior:
    # exactly on the single-query parity path (`search_approximate`),
    # and on the batched path via per-query probe depth — each query
    # probes just enough nearest clusters for their live-member sum
    # (capped at top_k per cluster, like the walk) to reach top_k.
    # nprobe>=1 scans a fixed number of nearest clusters for every
    # query (the BASELINE.json config 4 sweep).
    nprobe: int = 0
    seed: int = 0
    dtype: str = "float32"
    # matmul precision of the batched scan: "highest" = f32-exact
    # distance values (default); "default" lets the card use TF32 / bf16
    # inputs, which moves distances in the third decimal digit.
    precision: str = "highest"
    # batched-search engine (`vers_tpu/engine.py`): "pallas" = packed-
    # scan kernel (compiled for the GPU), "xla" = lax.scan path, "auto"
    # = the kernel where it compiles and top_k allows, else xla.
    engine: str = "auto"


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    """Random-hyperplane projection forest (Annoy-style), called "LSH"
    in the reference (`vers/src/indexes/lsh.rs`)."""

    num_trees: int = 8
    max_node_size: int = 100
    seed: int = 0
    dtype: str = "float32"
    # batched-search engine, as IVFFlatConfig.engine.
    engine: str = "auto"


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    """HNSW graph index (`vers/src/indexes/hnsw.rs`). The host build is
    the reference's sequential loop (the wave build in
    `ops/hnsw_build.py` is the batched one); queries run as a batched
    beam scan on the device.

    The defaults below were tuned before the move to the H100 and have
    not been re-measured on it (ROADMAP Queue 1 #5 and #6)."""

    num_layers: int = 8
    ef_construction: int = 100
    ef_search: int = 32
    num_neighbours: int = 16  # M; layer 0 uses 2*M (`hnsw.rs:400-404`)
    seed: int = 0
    dtype: str = "float32"
    # Cap on the padded adjacency width for the batched beam scan.
    # None → 2*num_neighbours (the layer-0 degree bound).
    max_degree: Optional[int] = None
    # dtype of the beam loop's navigation vector table ("bfloat16"
    # halves the gather traffic vs f32; "int8" halves it again via
    # symmetric per-row quantization; final top-k is f32-rescored).
    nav_dtype: str = "bfloat16"
    # Neighborhood-inlined navigation (ops/beam_inline.py): when set,
    # the device cache additionally holds, per node, the concatenation
    # of its layer-0 neighbours' ``nav_inline_dp``-dim PCA-projected
    # bf16 vectors, and the layer-0 beam gathers Q*expand WIDE rows per
    # step instead of Q*expand*deg thin ones — fewer, longer gathers,
    # at the cost of (n, deg*dp) bf16 of device memory and
    # PCA-approximate navigation (the final beam is always exact-f32
    # rescored).
    # "auto" (default): size-aware policy at device-cache build — on
    # at >= ~200k rows, the layer gather width capped at
    # ``min(max_degree or 32, 32)`` (index/hnsw.py INLINE_DEG_CAP) and
    # dp picked to fit ``inline_hbm_budget_gb`` (64, then 32, else
    # classic gathers + no cap). The reference's users pass four ints
    # and get its best behavior (`main.rs:70-79`); so should ours.
    # None/0 -> classic row gathers; an int forces that dp (and leaves
    # max_degree alone).
    nav_inline_dp: Optional[object] = "auto"
    # Device-memory budget for the (n_pad, cap*dp) bf16 inline table
    # when nav_inline_dp="auto" picks dp. The table is exactly 4 GiB at
    # 1M x deg32 x dp64; 4.5 keeps that case on dp=64. On an 80 GB H100
    # a JAX process may use 63.8 GB (bytes_limit read on the card), so
    # the table plus a 1.2 GB corpus is under a tenth of it; the budget
    # is not yet re-sized against that (ROADMAP Queue 1 #5).
    inline_hbm_budget_gb: float = 4.5
    # Exact-refine width for the inline beam. Projection-only beam
    # RETENTION collapses when true neighbours differ at
    # projection-noise scale (tight clusters at 1M x 300, dp=64) — so
    # by default each step exact-bf16 rescores the top ``2*ef``
    # projection-filtered candidates and the beam ranks in exact space
    # end to end (rows gathered per step: refine width instead of
    # expand*deg). None -> auto (2*ef); 0 -> pure projected navigation
    # (fastest, data-dependent recall).
    nav_inline_refine: Optional[int] = None
    # Beam width for the routing layers (> 0). The reference uses
    # ef_search on every layer (`hnsw.rs:526-536`), but routing only
    # has to land the entry point for the layer below; at 20k x 300,
    # ef 16/32/64, recall@10 matched the full-width beam. None ->
    # ef_search everywhere (reference behavior). See PARITY.md D13.
    ef_route: Optional[int] = 8
    # Query-beam expansion fan-out: how many best unexpanded beam
    # entries expand per lockstep iteration (construction beams use the
    # same value; see ops/hnsw_build.py). The per-step gather cost is
    # linear in expand while the step count shrinks ~expand-fold, so
    # the fixed per-iteration costs (merge top-k, dup mask) amortize.
    # None (default) -> 8 on the classic gather beam and construction
    # beams, 4 on the inline beam (whose per-step gather is expand WIDE
    # rows); an int forces that value everywhere.
    beam_expand: Optional[int] = None
    # Cap on the query beam's lockstep iterations. None -> auto: the
    # bound max(4*ef, 64) on the classic gather beam, but
    # ceil(ef/expand) on the INLINE beam (the lockstep while_loop runs
    # until every query in the batch converges, so stragglers alone
    # set wall-clock; ceil(ef/expand) expands ef candidates). A tight
    # cap trades straggler-query recall for wall-clock.
    beam_steps: Optional[int] = None
    # Batched-query routing strategy. "scan" (default): ONE brute-force
    # bf16 matmul scan over the layer-1 node subset (~n/(2M) rows —
    # every node of every layer >= 1 is in layer 1, so the scan
    # strictly dominates a routing descent) picks the top-``route_seeds``
    # entry points and seeds the layer-0 beam with all of them. "beam":
    # the reference-shaped greedy descent through layers L-2..1 (PARITY
    # D13). The routing beams are serial random-gather chains; the scan
    # is one dense matmul, with equal-or-better recall (the seeds are
    # exact layer-1 nearest, not greedy-routed approximations).
    route_mode: str = "scan"
    # Entry seeds the routing scan feeds the layer-0 beam. 0 -> auto
    # (min(ef_search, 8); more seeds only widen the initial gather,
    # recall was flat from 1 to 32 seeds).
    route_seeds: int = 0
