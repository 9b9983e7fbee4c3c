import numpy as np
import pytest

from vers_tpu.index.flat import FlatIndex
from vers_tpu.utils.harness import exhaustive_batch, search_exhaustive


def test_flat_exact_matches_numpy(rng, tmp_path):
    x = rng.normal(size=(500, 32)).astype(np.float32)
    q = rng.normal(size=(13, 32)).astype(np.float32)
    idx = FlatIndex.build_index(x)
    res = idx.search_batch(q, 10)
    truth = exhaustive_batch(x, q, 10)
    for r in range(q.shape[0]):
        assert set(res.ids[r]) == set(truth[r])

    # single-query parity API
    pairs = idx.search_approximate(q[0], 5)
    ref = search_exhaustive(x, q[0], 5)
    assert [p[0] for p in pairs] == [p[0] for p in ref]
    np.testing.assert_allclose(
        [p[1] for p in pairs], [p[1] for p in ref], rtol=1e-4
    )


def test_flat_add_and_roundtrip(rng, tmp_path):
    x = rng.normal(size=(50, 8)).astype(np.float32)
    idx = FlatIndex.build_index(x)
    new = rng.normal(size=(8,)).astype(np.float32)
    idx.add(new, 777)
    res = idx.search_approximate(new, 1)
    assert res[0][0] == 777
    assert res[0][1] < 1e-5

    path = str(tmp_path / "flat.index")
    idx.save_index(path)
    re = FlatIndex.load_index(path, dim=8)
    res2 = re.search_approximate(new, 1)
    assert res2[0][0] == 777


def test_flat_topk_larger_than_corpus(rng):
    x = rng.normal(size=(5, 4)).astype(np.float32)
    idx = FlatIndex.build_index(x)
    res = idx.search_batch(x[:2], 10)
    assert res.ids.shape == (2, 10)
    assert (res.ids[:, 5:] == -1).all()


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
def test_flat_exact_matches_float64_reference(metric):
    """Exact flat search against a float64 numpy reference: ids up to
    ties, distances within f32 rounding of the expansion."""
    from vers_tpu.config import FlatConfig

    rng = np.random.default_rng(5)
    x = rng.normal(size=(3000, 40)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(17, 40)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    res = FlatIndex.build_index(x, config=FlatConfig(metric=metric)).search_batch(q, 10)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        d = 1.0 - q64 @ x64.T
    else:
        d = ((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    ref_i = np.argsort(d, axis=1, kind="stable")[:, :10]
    ref_d = np.take_along_axis(d, ref_i, axis=1)
    np.testing.assert_allclose(res.distances, ref_d, rtol=1e-5, atol=2e-5)
    for r in range(q.shape[0]):
        assert set(res.ids[r]) == set(ref_i[r])
