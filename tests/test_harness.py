"""End-to-end queen smoke tests — the reference's integration anchor
(`vers/src/utils.rs:117-158`, `README.md:72-76`): build, add held-out
queen, save, reload, search; royal words must surface."""

import numpy as np
import pytest

from vers_tpu.index.flat import FlatIndex
from vers_tpu.index.hnsw import HNSWIndex
from vers_tpu.index.ivfflat import IVFFlatIndex
from vers_tpu.index.lsh import ANNIndex
from vers_tpu.utils.data import (
    ROYAL_WORDS,
    load_wiki_vector,
    synthetic_words_dataset,
    write_vec_file,
)
from vers_tpu.utils.harness import run_test


@pytest.fixture(scope="module")
def wiki(tmp_path_factory):
    words, embs = synthetic_words_dataset(n_words=900, dim=32, seed=0)
    path = str(tmp_path_factory.mktemp("data") / "wiki.vec")
    write_vec_file(path, words, embs)
    return load_wiki_vector(path, dim=32)


def test_loader_holds_out_queen(wiki):
    vectors, word_to_idx, idx_to_word, test_embs = wiki
    assert "queen" not in word_to_idx
    assert [w for w, _ in test_embs] == ["queen"]
    assert vectors.shape[0] == 899
    # loader normalizes (utils.rs:48)
    np.testing.assert_allclose(
        np.linalg.norm(vectors, axis=1), 1.0, rtol=1e-4
    )


def _royal_hits(results):
    royal = set(ROYAL_WORDS)
    return sum(1 for w, _ in results if w in royal)


def test_queen_flat(wiki, tmp_path):
    vectors, w2i, i2w, test_embs = wiki
    idx = FlatIndex.build_index(vectors.copy())
    out = run_test(
        idx, str(tmp_path / "flat.index"), vectors.copy(), dict(w2i), dict(i2w), test_embs
    )
    assert out[0][0] == "queen"
    assert _royal_hits(out) >= 8


def test_queen_ivfflat(wiki, tmp_path):
    vectors, w2i, i2w, test_embs = wiki
    idx = IVFFlatIndex.build_index(8, 2, 10, vectors.copy())
    out = run_test(
        idx, str(tmp_path / "ivf.index"), vectors.copy(), dict(w2i), dict(i2w), test_embs
    )
    assert out[0][0] == "queen"
    assert _royal_hits(out) >= 8


def test_queen_lsh(wiki, tmp_path):
    vectors, w2i, i2w, test_embs = wiki
    idx = ANNIndex.build_index(4, 50, vectors.copy(), np.arange(len(vectors)))
    out = run_test(
        idx, str(tmp_path / "lsh.index"), vectors.copy(), dict(w2i), dict(i2w), test_embs
    )
    assert out[0][0] == "queen"
    assert _royal_hits(out) >= 5


def test_queen_hnsw(wiki, tmp_path):
    vectors, w2i, i2w, test_embs = wiki
    idx = HNSWIndex.build_index(4, 32, 16, 8, vectors.copy())
    out = run_test(
        idx, str(tmp_path / "hnsw.index"), vectors.copy(), dict(w2i), dict(i2w), test_embs
    )
    assert out[0][0] == "queen"
    assert _royal_hits(out) >= 5


def test_queen_hnsw_device_built(wiki, tmp_path):
    """The queen flow on a wave-built graph: `add` must take the
    device fast path (no materialization) and the royal neighbours
    still surface after save + reload."""
    vectors, w2i, i2w, test_embs = wiki
    idx = HNSWIndex.build_index_batched(
        4, 32, 16, 8, vectors.copy(), wave_cap=128
    )
    idx.search_batch(vectors[:2], 3)  # warm the device cache
    out = run_test(
        idx, str(tmp_path / "hnsw_dev.index"), vectors.copy(),
        dict(w2i), dict(i2w), test_embs
    )
    assert out[0][0] == "queen"
    assert _royal_hits(out) >= 5


def test_queen_ivfflat_device_built(wiki, tmp_path):
    """Same flow on a device-built IVF index: add patches the slacked
    layout in place, host mirrors materialize only at save time."""
    import jax

    from vers_tpu.core import round_up

    vectors, w2i, i2w, test_embs = wiki
    n = len(vectors)
    n_pad = round_up(n, 128)
    dev = jax.device_put(np.pad(vectors, ((0, n_pad - n), (0, 0))))
    idx = IVFFlatIndex.build_index_device(8, 2, 10, dev, n_valid=n)
    idx.search_batch(vectors[:2], 3)  # builds the device layout
    out = run_test(
        idx, str(tmp_path / "ivf_dev.index"), vectors.copy(),
        dict(w2i), dict(i2w), test_embs
    )
    assert out[0][0] == "queen"
    assert _royal_hits(out) >= 8
