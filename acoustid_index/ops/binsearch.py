"""Vectorized bounded binary search over concatenated sorted runs.

The engine keeps many immutable sorted (hash, docid) term tables packed into
one flat device buffer; each logical segment owns a [start, start+length)
slice.  These primitives run a fixed-iteration binary search (32 steps — the
key space is u32) simultaneously for every (segment, key) pair, which is the
accelerator-native replacement for the reference's per-hash `std.sort.lowerBound` /
`equalRange` scans (see /root/reference/src/FileSegment.zig:135-180 and
MemorySegment.zig:44-54).

Everything is static-shaped: `data` is the padded flat buffer, `start`/
`length` broadcast against `keys`, and out-of-range slots simply search an
empty window.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_STEPS = 32  # ceil(log2(max run length)); u32-indexed buffers


def _bound(data: jax.Array, keys: jax.Array, start: jax.Array, length: jax.Array, *, upper: bool, steps: int = _STEPS) -> jax.Array:
    """Insertion point of `keys` in data[start : start+length) (sorted asc).

    Returns absolute indices into `data`, in [start, start+length].
    `keys`, `start`, `length` broadcast together to the output shape.
    """
    keys = jnp.asarray(keys, jnp.uint32)
    start = jnp.asarray(start, jnp.int32)
    length = jnp.asarray(length, jnp.int32)
    shape = jnp.broadcast_shapes(keys.shape, start.shape, length.shape)
    lo = jnp.broadcast_to(start, shape).astype(jnp.int32)
    hi = lo + jnp.broadcast_to(length, shape).astype(jnp.int32)
    keys = jnp.broadcast_to(keys, shape)

    def step(_, carry):
        lo, hi = carry
        active = lo < hi
        mid = lo + (hi - lo) // 2
        v = data[jnp.clip(mid, 0, data.shape[0] - 1)]
        go_right = v <= keys if upper else v < keys
        new_lo = jnp.where(jnp.logical_and(active, go_right), mid + 1, lo)
        new_hi = jnp.where(jnp.logical_and(active, jnp.logical_not(go_right)), mid, hi)
        return new_lo, new_hi

    lo, hi = jax.lax.fori_loop(0, steps, step, (lo, hi))
    return lo


def lower_bound(data: jax.Array, keys: jax.Array, start: jax.Array, length: jax.Array, steps: int = _STEPS) -> jax.Array:
    """First index in [start, start+length) whose value is >= key."""
    return _bound(data, keys, start, length, upper=False, steps=steps)


def upper_bound(data: jax.Array, keys: jax.Array, start: jax.Array, length: jax.Array, steps: int = _STEPS) -> jax.Array:
    """First index in [start, start+length) whose value is > key."""
    return _bound(data, keys, start, length, upper=True, steps=steps)


def steps_for(n: int) -> int:
    """Binary-search iterations needed for runs of length <= n."""
    s = 0
    while (1 << s) < n + 1:
        s += 1
    return max(s, 1)


def member_count(data: jax.Array, keys: jax.Array, start: jax.Array, length: jax.Array) -> jax.Array:
    """Number of occurrences of each key in its run (0 = absent)."""
    lo = lower_bound(data, keys, start, length)
    hi = upper_bound(data, keys, start, length)
    return (hi - lo).astype(jnp.int32)
