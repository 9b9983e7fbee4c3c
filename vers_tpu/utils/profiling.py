"""Profiling helpers: block_until_ready-bracketed timers, the persistent
compile cache, and a jax.profiler trace wrapper (the reference's
analogue was samply + Instant timing, SURVEY §5)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import jax

# <repo>/.jax_cache: a fixed path, because the path is part of the
# cache key (a directory that moves never hits)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


class Timer:
    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


def timed_device(
    fn: Callable, *args, warmup: int = 1, iters: int = 5, depth: int = 1, **kw
):
    """Time a device function after ``warmup`` compile/warm calls, each
    timed iteration ending in ``jax.block_until_ready``. Returns
    (best_seconds_per_call, last_result).

    ``depth``: calls chained per timed iteration with ONE wait at the
    end, so the device queue stays non-empty the way a serving pipeline
    keeps it; depth=1 measures each call's full latency."""
    result = None
    for _ in range(max(warmup, 0)):
        result = jax.block_until_ready(fn(*args, **kw))
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        for _ in range(max(depth, 1)):
            result = fn(*args, **kw)
        jax.block_until_ready(result)
        best = min(best, (time.perf_counter() - t0) / max(depth, 1))
    return best, result


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compile cache; call before the first
    jit. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it
    and nothing is set here; otherwise the cache goes to
    `DEFAULT_CACHE_DIR`. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


@contextlib.contextmanager
def trace(path: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
