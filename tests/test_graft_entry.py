"""Driver entry points stay runnable.

``dryrun_multichip`` must self-configure the virtual 8-device CPU
backend even when the ambient environment selects another platform.
Running it in a fresh subprocess — with no conftest help and the
ambient environment — is the regression test.
"""

import subprocess
import sys
import pytest

# heavy tier (wave builds / shard_map surfaces / subprocess dryruns):
# skipped by `make test`, run by `make test-all`
pytestmark = pytest.mark.slow


def test_entry_jits():
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn, static_argnums=(2,))(*args)
    jax.block_until_ready(out)


def test_dryrun_multichip_in_process():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dryrun_multichip_subprocess_no_conftest():
    # Fresh interpreter, no JAX_PLATFORMS/XLA_FLAGS handholding: the
    # entry point itself must force the CPU platform + device count.
    code = "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=280,
        cwd="/root/repo",
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout
