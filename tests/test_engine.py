"""The engine table (vers_tpu/engine.py): one choice per platform, and a
loud error where nothing compiles."""

import pytest

from vers_tpu.engine import ENGINES, resolve_engine
from vers_tpu.ops.pallas_binned import MAX_KERNEL_K


@pytest.mark.parametrize(
    "requested,platform,top_k,expect",
    [
        ("auto", "gpu", 10, "pallas"),
        ("auto", "gpu", MAX_KERNEL_K + 1, "xla"),  # beyond the kernel
        ("auto", "cpu", 10, "xla"),
        ("pallas", "gpu", 10, "pallas"),
        ("xla", "gpu", 10, "xla"),
        ("xla", "cpu", 10, "xla"),
    ],
)
def test_resolve_engine_choices(requested, platform, top_k, expect):
    assert resolve_engine(requested, top_k, platform) == expect


@pytest.mark.parametrize(
    "requested,platform,top_k,match",
    [
        ("auto", "metal", 10, "no scan engine for platform"),
        ("pallas", "cpu", 10, "no compiled path"),  # never the interpreter
        ("pallas", "gpu", MAX_KERNEL_K + 1, "serves top_k"),
        ("bucket", "gpu", 10, "unknown engine"),
    ],
)
def test_resolve_engine_raises(requested, platform, top_k, match):
    with pytest.raises(ValueError, match=match):
        resolve_engine(requested, top_k, platform)


def test_default_platform_is_jax_backend():
    # the test backend is the CPU (conftest): "auto" resolves to XLA
    assert resolve_engine("auto", 10) == "xla"
    assert set(ENGINES) == {"gpu", "cpu"}


def test_forced_kernel_on_cpu_index_raises():
    """An index configured for the kernel engine refuses the CPU instead
    of silently running the Pallas interpreter."""
    import numpy as np

    from vers_tpu.config import IVFFlatConfig
    from vers_tpu.index.ivfflat import IVFFlatIndex

    x = np.random.default_rng(0).normal(size=(256, 8)).astype(np.float32)
    idx = IVFFlatIndex.build_index(
        4, 1, 3, x, config=IVFFlatConfig(num_clusters=4, engine="pallas")
    )
    with pytest.raises(ValueError, match="no compiled path"):
        idx.search_batch(x[:4], 5, nprobe=1)
