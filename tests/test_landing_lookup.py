"""The landing-block scan (ops/block_lookup.landing_lookup) against a
numpy reference: straddling runs, absent and sentinel hashes, dead lanes,
both layouts, with and without docid-row emission."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from acoustid_index.ops.layout import BLOCK, interleave_np
from acoustid_index.ops.block_lookup import ROWS, landing_lookup

SENTINEL = 0xFFFFFFFF


def _table(nblk: int, seed: int):
    """Sorted hashes with a run straddling the block 1/2 boundary and a
    sentinel-padded last block; random docids."""
    rng = np.random.default_rng(seed)
    hashes = np.sort(rng.integers(0, 1 << 20, nblk * BLOCK, dtype=np.uint32))
    hashes[2 * BLOCK - 7 : 2 * BLOCK + 9] = hashes[2 * BLOCK]
    hashes = np.sort(hashes)
    hashes[-100:] = SENTINEL
    docids = rng.integers(1, 1 << 30, nblk * BLOCK, dtype=np.uint32)
    return hashes, docids


def _lookups(hashes, L: int, nblk: int, seed: int):
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, nblk, L).astype(np.int32)
    q = rng.choice(hashes[:-100], L).astype(np.uint32)
    q[1::5] = rng.integers(0, 1 << 20, q[1::5].shape[0], dtype=np.uint32)  # mostly absent
    q[2::7] = hashes[2 * BLOCK]  # the straddling run
    q[3::11] = SENTINEL
    blk[: L // 4] = 0  # dead-lane shape: runs of block 0
    return blk, q


def _reference(hashes, docids, blk, q):
    lt = np.array([(hashes[b * BLOCK : (b + 1) * BLOCK] < v).sum() for b, v in zip(blk, q)], np.int32)
    eq = np.array([(hashes[b * BLOCK : (b + 1) * BLOCK] == v).sum() for b, v in zip(blk, q)], np.int32)
    dd = docids.reshape(-1, ROWS, 128)
    r = np.minimum(lt >> 7, ROWS - 1)
    rows = np.stack([dd[blk, r], dd[blk, np.minimum(r + 1, ROWS - 1)]], axis=1)
    return blk * BLOCK + lt, eq, rows


CASES = [(1, False), (2, False), (2, True)]  # (stride, emit)


@pytest.mark.parametrize("stride,emit", CASES)
@pytest.mark.parametrize("L", [8, 61, 200])
def test_landing_lookup_matches_reference(L, stride, emit):
    nblk = 6
    hashes, docids = _table(nblk, seed=L)
    table = hashes if stride == 1 else interleave_np(hashes, docids)
    blk, q = _lookups(hashes, L, nblk, seed=L + 1)

    fn = jax.jit(lambda t, b, qq: landing_lookup(t, b, qq, stride=stride, emit=emit))
    out = fn(jnp.asarray(table), jnp.asarray(blk), jnp.asarray(q))
    lo_ref, eq_ref, rows_ref = _reference(hashes, docids, blk, q)
    np.testing.assert_array_equal(np.asarray(out[0]), lo_ref)
    np.testing.assert_array_equal(np.asarray(out[1]), eq_ref)
    if emit:
        np.testing.assert_array_equal(np.asarray(out[2]), rows_ref)
    else:
        assert len(out) == 2


def test_emit_needs_interleaved_layout():
    with pytest.raises(AssertionError):
        landing_lookup(
            jnp.zeros(BLOCK, jnp.uint32), jnp.zeros(8, jnp.int32), jnp.zeros(8, jnp.uint32),
            stride=1, emit=True,
        )
