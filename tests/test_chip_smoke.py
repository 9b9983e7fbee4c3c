"""chip_smoke.py's phase functions at a tiny size on the CPU: the
checks the card run makes, rehearsed here without the card."""

import importlib.util
import os

import numpy as np
import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture(scope="module")
def data():
    x, q = smoke.clustered(3000, 24, 16, 64, seed=1)
    return x, q, smoke.exact_truth(x, q)


def test_clustered_shapes_and_unit_rows():
    x, q = smoke.clustered(500, 12, 8, 7, seed=3)
    assert x.shape == (500, 12) and q.shape == (7, 12)
    assert x.dtype == np.float32 and q.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(x, axis=1), 1.0, rtol=1e-5)
    x2, _ = smoke.clustered(500, 12, 8, 7, seed=3)
    np.testing.assert_array_equal(x, x2)  # made from the seed


def test_device_phase_refuses_cpu():
    with pytest.raises(smoke.SmokeFailure, match="no GPU"):
        smoke.phase_device()
    assert smoke.phase_device(require_gpu=False)["platform"] == "cpu"


def test_main_exits_nonzero_without_gpu(capsys):
    assert smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out  # no result line


@pytest.mark.parametrize(
    "perturb,expect",
    [
        ("none", True),
        ("swap_tie", True),      # equal distances, ids reordered
        ("boundary_tie", True),  # a different id at the k-th distance
        ("wrong_id", False),     # an id swapped across distinct distances
        ("wrong_dist", False),
    ],
)
def test_same_up_to_ties(perturb, expect):
    ids = np.array([[1, 2, 3, 4]])
    d = np.array([[0.1, 0.2, 0.2, 0.4]])
    ids_b, d_b = ids.copy(), d.copy()
    if perturb == "swap_tie":
        ids_b[0, 1:3] = [3, 2]
    elif perturb == "boundary_tie":
        ids_b[0, 3] = 9
    elif perturb == "wrong_id":
        ids_b[0, 0:2] = [2, 1]
    elif perturb == "wrong_dist":
        d_b[0, 0] = 0.15
    ok, _ = smoke.same_up_to_ties(ids, d, ids_b, d_b, 1e-6, 1e-6)
    assert ok is expect


def test_ivf_phase(data):
    x, q, truth = data
    out = smoke.phase_ivf(x, q, truth.ids, 16, attempts=1, iterations=4,
                          n_ref=32)
    assert 0.0 < out["recall_nprobe1"] <= out["recall_nprobe4"] + 1e-3
    assert 0.0 < out["recall_adaptive"] <= 1.0
    assert out["engine"] == "xla"
    assert out["adaptive_depth"] >= 1
    # one engine on the CPU: nothing to compare the kernel with
    assert out["engines_rows_differing"] is None


def test_adaptive_reference_refuses_a_wrong_answer(data):
    from vers_tpu.index.ivfflat import IVFFlatIndex

    x, q, _ = data
    idx = IVFFlatIndex.build_index(16, 1, 4, x)
    res = idx.search_batch(q, smoke.TOP_K)
    depth, _ = smoke.adaptive_matches_reference(idx, q, res, x, n_ref=16)
    assert depth >= 1
    res.ids[3, 0], res.ids[3, 1] = res.ids[3, 1], res.ids[3, 0]
    with pytest.raises(smoke.SmokeFailure, match="adaptive"):
        smoke.adaptive_matches_reference(idx, q, res, x, n_ref=16)


def test_kernels_phase_flat_vs_float64(data):
    from vers_tpu.index.ivfflat import IVFFlatIndex

    x, q, _ = data
    idx = IVFFlatIndex.build_index(16, 1, 4, x)
    out = smoke.phase_kernels(idx, q, x, n_ref=32)
    n_diff, err = out["flat_vs_f64"]
    assert err < smoke.FLAT_ATOL


def test_four_cards_phase_on_virtual_devices():
    out = smoke.phase_four_cards(
        4000, 16, 64, 16, 1200, seed=2, n_devices=4
    )
    assert out["flat_devices"] == 4
    for nprobe in (1, 4):
        assert out[f"ivf_sharded_recall_nprobe{nprobe}"] > 0.5


def test_time_engines_rows_on_cpu():
    rows = smoke.time_engines(
        0, "cpu", shapes=((3000, 24, 16), (2000, 16, 8)), engines=("xla",),
        q_n=32,
    )
    assert [(r["index"], r.get("nprobe")) for r in rows] == [
        ("ivf", 1), ("ivf", 4), ("forest", None), ("flat", None),
        ("ivf", 1), ("ivf", 4),
    ]
    for r in rows:
        times = [v for key, v in r.items() if key.endswith("_ms")]
        assert len(times) == 1 and times[0] > 0
