"""Compile-cache placement and the block_until_ready timer."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import jax; from vers_tpu.utils import profiling as p; "
    "used = p.enable_compilation_cache(); "
    "print(used); print(jax.config.jax_compilation_cache_dir)"
)


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    return out[0], out[1]


@pytest.mark.parametrize("from_env", [True, False])
def test_cache_dir_placement(tmp_path, from_env):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands
    and nothing is set in code; without it, <repo>/.jax_cache."""
    want = str(tmp_path / "cache") if from_env else os.path.join(ROOT, ".jax_cache")
    used, configured = _probe(want if from_env else None)
    assert used == want
    assert configured == want


def test_timed_device_waits_and_returns_result():
    import jax.numpy as jnp

    from vers_tpu.utils.profiling import timed_device

    calls = []

    def f(x):
        calls.append(1)
        return x * 2

    t, out = timed_device(f, jnp.ones(4), warmup=1, iters=2, depth=3)
    assert t > 0
    assert len(calls) == 1 + 2 * 3
    assert float(out[0]) == 2.0
