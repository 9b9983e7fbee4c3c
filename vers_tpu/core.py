"""Core vector utilities: the batched analogue of the reference's
``Vector<N>`` math core (`vers/src/indexes/base.rs:15-294`).

Where the reference hand-rolls per-pair scalar/SIMD ops on 256-byte
aligned ``[f32; N]`` arrays, we operate on whole ``(n, d)`` matrices so
XLA can tile the work into matrix products. Single-vector ops exist for
parity testing only; all hot paths are batched.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Row-padding multiple. Corpus row counts are padded to a multiple of
# this so fused scans always see full tiles (zero padding does not
# change dot products or squared euclidean distances).
LANE = 128
SUBLANE = 8

NORMALIZE_EPS = 1e-6  # parity with `base.rs:99-105`


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def as_query_matrix(queries) -> jnp.ndarray:
    """Normalize query input to a (Q, d) f32 device array WITHOUT a
    host round-trip when it's already a jax array (callers can
    pre-place queries once)."""
    if isinstance(queries, jax.Array):
        q = queries
        if q.dtype != jnp.float32:
            q = q.astype(jnp.float32)
    else:
        q = jnp.asarray(np.asarray(queries, dtype=np.float32))
    if q.ndim == 1:
        q = q[None, :]
    return q


def device_id_map(ids):
    """Device-resident int32 copy of an internal-row -> external-id
    map, or ``None`` when any id falls outside int32 range.

    The bincode formats store external ids as u64 (`models.rs` /
    `lsh.rs` serde layouts), so ids >= 2**31 are valid inputs; casting
    them to int32 on device would silently wrap and return wrong ids.
    Callers must fall back to host-side int64 mapping (or raise on the
    device-resident path) when this returns None.
    """
    ids = np.asarray(ids)
    if ids.size and (
        int(ids.min()) < -(2**31) or int(ids.max()) > 2**31 - 1
    ):
        return None
    return jnp.asarray(ids, jnp.int32)


def pad_rows(x: jnp.ndarray, multiple: int = LANE, value: float = 0.0):
    """Pad axis 0 of ``x`` to a multiple of ``multiple``. Returns
    (padded, original_n)."""
    n = x.shape[0]
    n_pad = round_up(max(n, 1), multiple)
    if n_pad == n:
        return x, n
    pad_width = [(0, n_pad - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=value), n


def pad_dim(x: jnp.ndarray, multiple: int = LANE):
    """Zero-pad the last (feature) axis to a multiple of ``multiple``.

    Safe for dot-product and L2 work: zero features contribute nothing.
    """
    d = x.shape[-1]
    d_pad = round_up(d, multiple)
    if d_pad == d:
        return x
    pad_width = [(0, 0)] * (x.ndim - 1) + [(0, d_pad - d)]
    return jnp.pad(x, pad_width)


def normalize(x, eps: float = NORMALIZE_EPS):
    """L2-normalize rows; rows with magnitude < eps pass through
    unchanged (parity with `base.rs:99-105`)."""
    x = jnp.asarray(x)
    mag = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return jnp.where(mag < eps, x, x / jnp.where(mag < eps, 1.0, mag))


def normalize_np(x: np.ndarray, eps: float = NORMALIZE_EPS) -> np.ndarray:
    """Host-side normalize with the same epsilon guard."""
    x = np.asarray(x, dtype=np.float32)
    mag = np.sqrt(np.sum(x * x, axis=-1, keepdims=True))
    safe = np.where(mag < eps, 1.0, mag)
    return np.where(mag < eps, x, x / safe).astype(np.float32)


def to_hashkey(x: np.ndarray) -> np.ndarray:
    """Bitwise f32→u32 view used for exact-duplicate detection and
    k-means convergence (parity with ``to_hashkey``, `base.rs:113-117`)."""
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def bitwise_equal(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact bitwise equality of two f32 arrays (the reference's k-means
    convergence test, `ivfflat.rs:84-93`). Jit-safe; returns a scalar
    bool array."""
    au = jax.lax.bitcast_convert_type(a, jnp.uint32)
    bu = jax.lax.bitcast_convert_type(b, jnp.uint32)
    return jnp.all(au == bu)


def deduplicate(vectors: np.ndarray, ids: np.ndarray):
    """Drop bitwise-duplicate rows, keeping first occurrence (parity
    with `lsh.rs:113-130`). Returns (unique_vectors, their_ids)."""
    keys = to_hashkey(vectors)
    _, first = np.unique(keys, axis=0, return_index=True)
    keep = np.sort(first)
    return vectors[keep], np.asarray(ids)[keep]


class VectorStore:
    """A growable, device-resident ``(capacity, d)`` corpus with masked
    count — the device replacement for the reference's ``Vec<Vector<N>>``
    push-based storage (e.g. `ivfflat.rs:200-213`).

    JAX arrays are immutable, so ``add`` uses capacity-padded buffers:
    appending within capacity is a cheap ``dynamic_update_slice``;
    exceeding capacity doubles the buffer. Rows past ``count`` are zero
    and must be masked out by consumers.
    """

    def __init__(self, data, capacity: int | None = None, dtype=jnp.float32):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim != 2:
            raise ValueError(f"expected (n, d) array, got shape {data.shape}")
        n, d = data.shape
        cap = round_up(max(capacity or n, 1), LANE)
        buf = np.zeros((cap, d), dtype=np.float32)
        buf[:n] = data
        self._buf = jnp.asarray(buf, dtype=dtype)
        self._count = n
        self._dtype = dtype

    @property
    def count(self) -> int:
        return self._count

    @property
    def dim(self) -> int:
        return self._buf.shape[1]

    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    @property
    def data(self) -> jnp.ndarray:
        """Full padded buffer (capacity, d). Rows >= count are zeros."""
        return self._buf

    def valid(self) -> jnp.ndarray:
        """(capacity,) bool mask of live rows."""
        return jnp.arange(self.capacity) < self._count

    def rows(self) -> np.ndarray:
        """Host copy of the live rows (count, d) in float32."""
        return np.asarray(self._buf[: self._count], dtype=np.float32)

    def append(self, row) -> int:
        """Append one row; returns its position."""
        row = jnp.asarray(row, dtype=self._dtype).reshape(1, -1)
        if self._count >= self.capacity:
            new_cap = round_up(self.capacity * 2, LANE)
            buf = jnp.zeros((new_cap, self.dim), dtype=self._dtype)
            self._buf = jax.lax.dynamic_update_slice(buf, self._buf, (0, 0))
        self._buf = jax.lax.dynamic_update_slice(self._buf, row, (self._count, 0))
        pos = self._count
        self._count += 1
        return pos
