"""Test/benchmark harness: ground truth, recall, and the queen smoke
test (the reference's only end-to-end verification,
`vers/src/utils.rs:68-158`)."""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np

from vers_tpu.core import normalize_np

log = logging.getLogger("vers_tpu")


def search_exhaustive(
    vector_data: np.ndarray, query: np.ndarray, top_k: int
) -> List[Tuple[int, float]]:
    """Brute-force top-k by squared euclidean — the recall ground truth
    (parity with `utils.rs:68-82`). Host-side numpy; use FlatIndex for
    the device version."""
    q = np.asarray(query, dtype=np.float32).reshape(-1)
    diffs = np.asarray(vector_data, dtype=np.float32) - q[None, :]
    d2 = np.einsum("nd,nd->n", diffs, diffs)
    order = np.argsort(d2, kind="stable")[:top_k]
    return [(int(i), float(d2[i])) for i in order]


def exhaustive_batch(
    vector_data: np.ndarray, queries: np.ndarray, top_k: int
) -> np.ndarray:
    """(Q, top_k) int64 ground-truth ids for a query batch (numpy)."""
    x = np.asarray(vector_data, dtype=np.float32)
    q = np.asarray(queries, dtype=np.float32)
    xx = np.einsum("nd,nd->n", x, x)
    out = np.empty((q.shape[0], top_k), dtype=np.int64)
    step = max(1, (1 << 26) // max(x.shape[0], 1))
    for s in range(0, q.shape[0], step):
        qs = q[s : s + step]
        d2 = (
            np.einsum("qd,qd->q", qs, qs)[:, None]
            + xx[None, :]
            - 2.0 * qs @ x.T
        )
        part = np.argpartition(d2, min(top_k, d2.shape[1] - 1), axis=1)[:, :top_k]
        vals = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(vals, axis=1, kind="stable")
        out[s : s + step] = np.take_along_axis(part, order, axis=1)
    return out


def recall_at_k(pred_ids, true_ids) -> float:
    """Mean fraction of ground-truth ids recovered, per query."""
    pred = np.asarray(pred_ids)
    true = np.asarray(true_ids)
    if pred.ndim == 1:
        pred, true = pred[None], true[None]
    hits = 0
    total = 0
    for p, t in zip(pred, true):
        tset = set(int(v) for v in t if v >= 0)
        hits += len(tset & set(int(v) for v in p if v >= 0))
        total += len(tset)
    return hits / max(total, 1)


def run_test(
    index,
    index_file_name: str,
    vectors: np.ndarray,
    word_to_idx: Dict[str, int],
    idx_to_word: Dict[int, str],
    test_embs: Sequence[Tuple[str, np.ndarray]],
    top_k: int = 10,
    query_word: str = "queen",
) -> List[Tuple[str, float]]:
    """The queen smoke harness (parity with `run_test`,
    `utils.rs:117-158`): insert held-out embeddings via ``add``, save,
    reload, search for the query word, return [(word, sqrt(distance))]
    like the reference prints.

    Returns the neighbour words so tests can assert royal words appear
    (`README.md:72-76`: "kings, queen, monarch, ...").
    """
    vectors = np.asarray(vectors, dtype=np.float32)
    for word, emb in test_embs:
        vec_id = vectors.shape[0]
        vectors = np.concatenate([vectors, np.asarray(emb, np.float32)[None]], axis=0)
        idx_to_word[vec_id] = word
        word_to_idx[word] = vec_id
        log.info("Inserting %s %d", word, vec_id)
        # the reference inserts the *normalized* held-out embedding
        # (`utils.rs:136`) but stores/queries the raw one (`utils.rs:131`).
        index.add(normalize_np(np.asarray(emb, np.float32).reshape(1, -1))[0], vec_id)

    index.save_index(index_file_name)
    reloaded = type(index).load_index(index_file_name, dim=vectors.shape[1])

    query = vectors[word_to_idx[query_word]]
    # note: `vectors` holds the RAW held-out embedding (the reference
    # pushes the raw vec at utils.rs:131 and queries with it).
    results = reloaded.search_approximate(query, top_k)
    out = []
    for i, (rid, dist) in enumerate(results):
        word = idx_to_word.get(int(rid), f"<{rid}>")
        out.append((word, float(np.sqrt(max(dist, 0.0)))))
        log.info("%d. Word: %s. Distance: %s", i, word, out[-1][1])
    return out
