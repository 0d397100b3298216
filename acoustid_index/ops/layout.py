"""Interleaved postings block layout for large tiers.

Large tiers interleave their hash and docid arrays at block granularity:

    inter[u32, 2*cap]:  per 1024-posting block b,
        entries [b*2048,      b*2048+1024) = hashes  of block b
        entries [b*2048+1024, b*2048+2048) = docids of block b

A landing-block scan (ops/block_lookup.py) then finds a lookup's docid
rows right after the hash block it searched and emits the run's leading
docids as a side output, so the serving pipeline skips most of its
separate postings gather.

Small tiers (hash column at most RESIDENT_MAX_BYTES) keep the plain
"hashes"/"docids" pair: their lookups hit L2 either way, and the plain
layout keeps the dense and binary-search range paths simple.
`use_interleaved` decides; every consumer handles both via the helpers
here.

Reference scope note: the reference's FileSegment stores block-compressed
postings and scans blocks linearly (/root/reference/src/FileSegment.zig:
135-180, block.zig); the interleave is this engine's replacement for its
"everything a scan needs sits in one cache line" property.
"""

from __future__ import annotations

import numpy as np

# Postings per block: THE source of truth.  4 KB of hashes = 8 rows of 128;
# hash_index/docid_index below depend on it through _BLOCK_SHIFT.
BLOCK = 1024
_BLOCK_SHIFT = BLOCK.bit_length() - 1  # log2(BLOCK)
assert BLOCK == 1 << _BLOCK_SHIFT, "BLOCK must be a power of two"


# Tiers whose hash column is at most this size keep the plain layout.  On
# the H100 a 6 MB table (1.5M postings) stays resident in the 50 MB L2
# beside the serving program's other operands, so its lookups never wait
# on DRAM and the interleave buys nothing.
RESIDENT_MAX_BYTES = 6 << 20


def use_interleaved(cap: int) -> bool:
    """True when a tier of postings capacity `cap` should pack interleaved:
    at least 64 blocks, and a hash column past RESIDENT_MAX_BYTES."""
    return cap >= 64 * BLOCK and cap * 4 > RESIDENT_MAX_BYTES


def interleave_np(hashes: np.ndarray, docids: np.ndarray) -> np.ndarray:
    """Host-side pack: (cap,) + (cap,) -> (2*cap,) interleaved blocks."""
    cap = hashes.shape[0]
    assert cap % BLOCK == 0, cap
    out = np.empty(2 * cap, dtype=np.uint32)
    v = out.reshape(-1, 2, BLOCK)
    v[:, 0, :] = hashes.reshape(-1, BLOCK)
    v[:, 1, :] = docids.reshape(-1, BLOCK)
    return out


def interleave_jnp(hashes, docids):
    """Device-side pack (for device-built tables: sharded packing, bench)."""
    import jax.numpy as jnp

    cap = hashes.shape[0]
    assert cap % BLOCK == 0, cap
    return jnp.stack(
        [hashes.reshape(-1, BLOCK), docids.reshape(-1, BLOCK)], axis=1
    ).reshape(-1)


def postings_cap(tier) -> int:
    """Static postings capacity of a packed tier, either layout."""
    if "inter" in tier:
        return tier["inter"].shape[0] // 2
    return tier["hashes"].shape[0]


def hash_index(idx):
    """Map a flat posting index to its position in the interleaved array.

    Unsigned on purpose: the interleaved array is TWICE the postings cap,
    so at 1B+ postings its length crosses 2^31 and a signed-int32 gather
    index makes jax constant-fold the (int32) array size for negative-index
    normalization — an OverflowError at trace time.  Callers clip idx to
    [0, cap), so unsigned is exact."""
    import jax.numpy as jnp

    idx = idx.astype(jnp.uint32)
    return ((idx >> _BLOCK_SHIFT) << (_BLOCK_SHIFT + 1)) + (idx & (BLOCK - 1))


def docid_index(idx):
    import jax.numpy as jnp

    idx = idx.astype(jnp.uint32)
    return ((idx >> _BLOCK_SHIFT) << (_BLOCK_SHIFT + 1)) + BLOCK + (idx & (BLOCK - 1))


def _inter_gather(inter, idx, payload: bool):
    """Gather from the interleaved array via a 2-D reshape: a FLAT index
    into a >=2^31-entry array needs int64 indexing, which jax silently
    truncates to int32 without x64 — positions past 2^31 wrapped NEGATIVE,
    corrupting reads of the final blocks at exactly 2^30 packed postings
    (= the 134M bench corpus).  Row/column indices stay far below 2^31 at
    any realizable capacity.

    The row-major (-1, 128) view of a flat array is a bitcast, so XLA never
    materializes it, even inside the serving cascade's cond branches (a
    view that forces a relayout would copy the whole multi-GB table)."""
    import jax.numpy as jnp

    idx = idx.astype(jnp.uint32)
    ipos = (
        ((idx >> _BLOCK_SHIFT) << (_BLOCK_SHIFT + 1))
        + jnp.uint32(BLOCK if payload else 0)
        + (idx & (BLOCK - 1))
    )
    rows = (ipos >> 7).astype(jnp.int32)  # < 2^25 at any realizable cap
    cols = (ipos & 127).astype(jnp.int32)
    return inter.reshape(-1, 128)[rows, cols]


def hash_gather(tier, idx):
    """tier hash at posting index `idx` (caller clips idx to the cap)."""
    if "inter" in tier:
        return _inter_gather(tier["inter"], idx, payload=False)
    return tier["hashes"][idx]


def docid_gather(tier, idx):
    if "inter" in tier:
        return _inter_gather(tier["inter"], idx, payload=True)
    return tier["docids"][idx]
