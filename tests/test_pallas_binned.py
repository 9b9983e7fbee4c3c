"""The packed-scan kernel wrapper (ops/pallas_binned.py) in interpret
mode: shapes, padding, the rows it leaves to the wrapper, and the
arguments it refuses."""

import numpy as np
import jax.numpy as jnp
import pytest

from vers_tpu.ops.binned import scan_packed
from vers_tpu.ops.pallas_binned import MAX_KERNEL_K, kernel_scan_packed, next_pow2


def _case(d, n=700, bins=5, q_n=40, seed=0):
    rng = np.random.default_rng(seed)
    rbin = np.sort(rng.integers(0, bins, n)).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    qbin = np.sort(rng.integers(0, bins, q_n)).astype(np.int32)
    qbin[-3:] = bins  # gated rows: a sentinel bin no item owns
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    return q, qbin, x, rbin


def _items(qbin, bins, q_blk):
    """One work item per (bin, q_blk window): the rows of that bin."""
    qs, qe = [], []
    for b in range(bins):
        rows = np.nonzero(qbin == b)[0]
        for s in range(0, len(rows), q_blk):
            qs.append(rows[s])
            qe.append(rows[min(s + q_blk, len(rows)) - 1] + 1)
    return np.asarray(qs, np.int32), np.asarray(qe, np.int32)


@pytest.mark.parametrize("d", [12, 64, 300])  # padded, exact, tail step
def test_kernel_matches_dense_reference(d):
    q, qbin, x, rbin = _case(d)
    qs, qe = _items(qbin, 5, 16)
    res_d, res_i = kernel_scan_packed(
        jnp.asarray(q), jnp.asarray(qbin), jnp.asarray(qs), jnp.asarray(qe),
        jnp.asarray(x), jnp.asarray(rbin), top_k=7, q_blk=16, chunk=32,
        num_bins=5, interpret=True,
    )
    res_d, res_i = np.asarray(res_d), np.asarray(res_i)
    assert res_d.shape == (q.shape[0] + 16, 7)  # scan_packed's shape
    for r in range(q.shape[0]):
        if qbin[r] >= 5:  # gated: never written, masked by the wrapper
            assert np.isinf(res_d[r]).all() and (res_i[r] == -1).all()
            continue
        members = np.nonzero(rbin == qbin[r])[0]
        d2 = ((x[members] - q[r]) ** 2).sum(1)
        o = np.argsort(d2, kind="stable")[:7]
        np.testing.assert_array_equal(res_i[r, : len(o)], members[o])
        np.testing.assert_allclose(res_d[r, : len(o)], d2[o], rtol=1e-4, atol=1e-4)


def test_kernel_matches_scan_packed_windows():
    """Same work items as the XLA twin, same answers."""
    q, qbin, x, rbin = _case(24, n=512, bins=4, q_n=30)
    qbin[-3:] = -1
    qs, qe = _items(qbin, 4, 16)
    starts = np.searchsorted(rbin, np.arange(4))
    gr = starts[qbin[qs]].astype(np.int32)
    xd, xi = scan_packed(
        jnp.asarray(q), jnp.asarray(qbin), jnp.asarray(qs), jnp.asarray(gr),
        jnp.asarray(x), jnp.asarray(rbin), top_k=5, q_blk=16, r_blk=256,
    )
    kd, ki = kernel_scan_packed(
        jnp.asarray(q), jnp.asarray(qbin), jnp.asarray(qs), jnp.asarray(qe),
        jnp.asarray(x), jnp.asarray(rbin), top_k=5, q_blk=16, chunk=16,
        num_bins=4, interpret=True,
    )
    live = qbin >= 0
    np.testing.assert_array_equal(np.asarray(ki)[:30][live], np.asarray(xi)[:30][live])
    np.testing.assert_allclose(
        np.asarray(kd)[:30][live], np.asarray(xd)[:30][live], rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(q_blk=24), "powers of two"),
        (dict(chunk=8), ">= 16"),
        (dict(top_k=MAX_KERNEL_K + 1), "MAX_KERNEL_K"),
    ],
)
def test_kernel_refuses_bad_tiles(kw, match):
    q, qbin, x, rbin = _case(16)
    args = dict(top_k=5, q_blk=16, chunk=32, num_bins=5, interpret=True)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        kernel_scan_packed(
            jnp.asarray(q), jnp.asarray(qbin), jnp.zeros(1, jnp.int32),
            jnp.zeros(1, jnp.int32), jnp.asarray(x), jnp.asarray(rbin), **args,
        )


def test_next_pow2():
    assert [next_pow2(v) for v in (1, 2, 3, 16, 17, 300)] == [1, 2, 4, 16, 32, 512]


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_xla(gpu_device):
    """The compiled kernel (no interpreter) against its XLA twin on the
    card; `chip_smoke.py` runs the same check at 1M x 300."""
    import jax

    from vers_tpu.ops import binned

    rng = np.random.default_rng(1)
    x = rng.normal(size=(20000, 300)).astype(np.float32)
    layout = binned.make_layout(x, rng.integers(0, 64, 20000), 64)
    cents = jax.device_put(rng.normal(size=(64, 300)).astype(np.float32), gpu_device)
    q = jax.device_put(rng.normal(size=(512, 300)).astype(np.float32), gpu_device)
    kd, ki = binned.binned_topk_fused(q, cents, 2, layout, 10, engine="pallas")
    xd, xi = binned.binned_topk_fused(q, cents, 2, layout, 10, engine="xla")
    np.testing.assert_allclose(np.asarray(kd), np.asarray(xd), rtol=1e-5, atol=1e-5)
    assert (np.asarray(ki) == np.asarray(xi)).mean() > 0.999
