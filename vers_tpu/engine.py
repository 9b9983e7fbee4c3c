"""Which packed-scan engine runs on which platform: the one table.

The IVF and forest searches scan their bins with one of two engines:

- ``"pallas"``: the Triton-route kernel (`ops/pallas_binned`), compiled
  for the GPU;
- ``"xla"``: the `lax.scan` twin (`ops/binned.scan_packed`), which
  compiles everywhere.

``"auto"`` picks the compiled kernel where one exists and XLA
otherwise. A forced engine with no compiled path on the platform
raises; nothing here falls back to the Pallas interpreter, which only a
test reaches, by passing ``interpret=True`` to the ops directly.
"""

from __future__ import annotations

import jax

from vers_tpu.ops.pallas_binned import MAX_KERNEL_K

# platform -> engines with a compiled path, the "auto" choice first
ENGINES = {
    "gpu": ("pallas", "xla"),
    "cpu": ("xla",),
}


def resolve_engine(requested: str, top_k: int, platform: str | None = None) -> str:
    """Engine for a search of ``top_k`` neighbours on ``platform``
    (default: JAX's default backend). Raises ValueError for a platform
    outside the table, an unknown engine name, or a forced engine that
    has no compiled path there or cannot serve ``top_k``."""
    platform = platform or jax.default_backend()
    if platform not in ENGINES:
        raise ValueError(
            f"no scan engine for platform {platform!r}; "
            f"supported: {sorted(ENGINES)}"
        )
    compiled = ENGINES[platform]
    if requested == "auto":
        if compiled[0] == "pallas" and top_k > MAX_KERNEL_K:
            return "xla"
        return compiled[0]
    if requested not in ("pallas", "xla"):
        raise ValueError(
            f"unknown engine {requested!r}; expected 'auto', 'pallas' or 'xla'"
        )
    if requested not in compiled:
        raise ValueError(
            f"engine {requested!r} has no compiled path on {platform!r}"
        )
    if requested == "pallas" and top_k > MAX_KERNEL_K:
        raise ValueError(
            f"engine 'pallas' serves top_k <= {MAX_KERNEL_K}, got {top_k}"
        )
    return requested
