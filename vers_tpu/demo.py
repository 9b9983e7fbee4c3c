"""CLI demo — the rebuild of the reference's scratch binary
(`vers/src/main.rs:54-103`): load wiki vectors (queen held out), build
an index, run the queen smoke harness, print timing.

Usage:
  python -m vers_tpu.demo --index hnsw --path wiki-news-300d-1M.vec
  python -m vers_tpu.demo --index ivfflat            # synthetic corpus
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

# VERS_PLATFORM=cpu runs the demo on the CPU on purpose (jax.config
# works as long as no backend has been touched yet)
if os.environ.get("VERS_PLATFORM"):
    import jax

    jax.config.update("jax_platforms", os.environ["VERS_PLATFORM"])

from vers_tpu.utils.profiling import enable_compilation_cache

enable_compilation_cache()

from vers_tpu.index.flat import FlatIndex
from vers_tpu.index.hnsw import HNSWIndex
from vers_tpu.index.ivfflat import IVFFlatIndex
from vers_tpu.index.lsh import ANNIndex
from vers_tpu.utils.data import (
    load_wiki_vector,
    synthetic_words_dataset,
    write_vec_file,
)
from vers_tpu.utils.harness import run_test
from vers_tpu.utils.logging import get_logger, index_stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", choices=["flat", "ivfflat", "lsh", "hnsw"], default="hnsw")
    p.add_argument(
        "--batched-build", action="store_true",
        help="HNSW: wave-parallel device construction instead of the sequential host build",
    )
    p.add_argument("--path", default=None, help=".vec file (synthetic corpus if absent)")
    p.add_argument("--dim", type=int, default=300)
    p.add_argument("--max-rows", type=int, default=None)
    # reference main.rs defaults: hnsw (12, 100, 32, 24)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--ef-construction", type=int, default=100)
    p.add_argument("--ef-search", type=int, default=32)
    p.add_argument("--num-neighbours", type=int, default=24)
    p.add_argument("--num-clusters", type=int, default=20)
    p.add_argument("--num-attempts", type=int, default=3)
    p.add_argument("--max-iterations", type=int, default=10)
    p.add_argument("--num-trees", type=int, default=8)
    p.add_argument("--max-node-size", type=int, default=100)
    p.add_argument("--top-k", type=int, default=10)
    args = p.parse_args(argv)

    log = get_logger()

    if args.path:
        vectors, w2i, i2w, test_embs = load_wiki_vector(
            args.path, dim=args.dim, max_rows=args.max_rows
        )
    else:
        import tempfile, os

        words, embs = synthetic_words_dataset(n_words=5000, dim=64, seed=0)
        tmp = os.path.join(tempfile.gettempdir(), "vers_tpu_demo.vec")
        write_vec_file(tmp, words, embs)
        vectors, w2i, i2w, test_embs = load_wiki_vector(tmp, dim=64)
    print(f"{len(vectors)} {len(w2i)} {len(i2w)}")

    t0 = time.perf_counter()
    if args.index == "flat":
        index = FlatIndex.build_index(vectors)
    elif args.index == "ivfflat":
        index = IVFFlatIndex.build_index(
            args.num_clusters, args.num_attempts, args.max_iterations, vectors
        )
    elif args.index == "lsh":
        index = ANNIndex.build_index(
            args.num_trees, args.max_node_size, vectors, np.arange(len(vectors))
        )
    else:
        build = (
            HNSWIndex.build_index_batched
            if args.batched_build
            else HNSWIndex.build_index
        )
        index = build(
            args.num_layers,
            args.ef_construction,
            args.ef_search,
            args.num_neighbours,
            vectors,
        )
    print(f"build: {time.perf_counter() - t0:.2f}s")

    import tempfile

    results = run_test(
        index,
        os.path.join(tempfile.gettempdir(), f"vers_tpu_{args.index}.index"),
        vectors,
        dict(w2i),
        dict(i2w),
        test_embs,
        top_k=args.top_k,
    )
    for i, (word, dist) in enumerate(results):
        print(f"{i}. Word: {word}. Distance: {dist}")
    print("stats:", index_stats(index))
    print(f"Time taken to test: {time.perf_counter() - t0:.2f}s")


if __name__ == "__main__":
    main()
