"""The two-level blocked lookup must be exact for equal-hash runs that
straddle block boundaries (regression: the single-block window silently
dropped the head of a straddling run)."""

import numpy as np
import pytest

import jax.numpy as jnp

from acoustid_index.ops.block_lookup import BLOCK, tier_ranges_blocked
from acoustid_index.ops.binsearch import lower_bound, upper_bound


def make_tier(hashes: np.ndarray):
    n = hashes.shape[0]
    cap = BLOCK
    while cap < n:
        cap *= 2
    padded = np.full(cap, 0xFFFFFFFF, np.uint32)
    padded[:n] = hashes
    h = jnp.asarray(padded)
    return {
        "hashes": h,
        "block_index": h[::BLOCK],
        "seg_start": jnp.zeros(1, jnp.int32),
        "seg_len": jnp.zeros(1, jnp.int32).at[0].set(n),
    }, n


def run_blocked(tier, queries, cap_k=2048):
    q = np.zeros(64, np.uint32)
    q[: len(queries)] = queries
    lo, cnt, trunc = tier_ranges_blocked(
        tier, jnp.asarray(q)[None, :], jnp.asarray(np.arange(64) < len(queries))[None, :], cap_k
    )
    return int(np.asarray(lo)[0, 0]), int(np.asarray(cnt)[0, 0]), bool(trunc)


def reference_bounds(tier, n, queries):
    q = jnp.asarray(np.asarray(queries, np.uint32))
    lo = lower_bound(tier["hashes"], q, jnp.int32(0), jnp.int32(n))
    hi = upper_bound(tier["hashes"], q, jnp.int32(0), jnp.int32(n))
    return np.asarray(lo), np.asarray(hi - lo)


@pytest.mark.parametrize(
    "run_start,run_len",
    [
        (BLOCK - 4, 11),  # run straddles the block 0/1 boundary
        (BLOCK, 7),  # run begins exactly at a block boundary
        (BLOCK - 1, 2),  # minimal straddle
        (500, 5),  # fully inside one block
        (2 * BLOCK - 3, 6),  # straddles a later boundary
    ],
)
def test_straddling_runs_are_exact(run_start, run_len):
    H = 1_000_000
    n = 4 * BLOCK
    hashes = np.arange(n, dtype=np.uint32)  # strictly increasing
    hashes[run_start : run_start + run_len] = H
    hashes[run_start + run_len :] = np.arange(
        H + 1, H + 1 + (n - run_start - run_len), dtype=np.uint32
    )
    tier, n_live = make_tier(np.sort(hashes))

    lo, cnt, trunc = run_blocked(tier, [H])
    want_lo, want_cnt = reference_bounds(tier, n_live, [H])
    assert cnt == want_cnt[0], (cnt, want_cnt[0])
    assert lo == want_lo[0], (lo, want_lo[0])
    assert not trunc


def test_long_run_truncates_with_flag():
    H = 5_000
    n = 6 * BLOCK
    hashes = np.full(n, H, np.uint32)
    hashes[: BLOCK // 2] = np.arange(BLOCK // 2, dtype=np.uint32)  # head below H
    tier, n_live = make_tier(hashes)
    lo, cnt, trunc = run_blocked(tier, [H])
    assert trunc  # the >2-block run cannot be fully scanned
    assert cnt <= 2 * BLOCK
    # Whatever window was scanned, it contains only equal postings.
    h = np.asarray(tier["hashes"])
    assert np.all(h[lo : lo + cnt] == H)


def test_absent_hash_and_sentinel():
    n = 3 * BLOCK
    hashes = np.sort(np.random.default_rng(0).integers(10, 2**31, n, dtype=np.uint32))
    tier, n_live = make_tier(hashes)
    lo, cnt, trunc = run_blocked(tier, [5])  # below everything
    assert cnt == 0
    lo, cnt, trunc = run_blocked(tier, [0xFFFFFFFF])  # sentinel-valued query
    assert cnt == 0  # padding must not count


def _multi_straddle_tier():
    """A table with an equal-hash run straddling every block boundary."""
    n = 6 * BLOCK
    hashes = np.arange(n, dtype=np.uint32) * 3  # strictly increasing, gaps
    straddlers = []
    for b in range(1, 6):
        h = hashes[b * BLOCK]  # value at the boundary
        hashes[b * BLOCK - 2 : b * BLOCK + 2] = h  # 4-long run across it
        straddlers.append(int(h))
    tier, n_live = make_tier(hashes)
    return tier, n_live, straddlers


def test_many_straddlers_all_exact():
    tier, n_live, straddlers = _multi_straddle_tier()
    want_lo, want_cnt = reference_bounds(tier, n_live, straddlers)
    for i, h in enumerate(straddlers):
        lo, cnt, trunc = run_blocked(tier, [h])
        assert (lo, cnt) == (int(want_lo[i]), int(want_cnt[i]))
        assert not trunc


def test_window_cap_overflow_flags_truncation(monkeypatch):
    """With the straddle-fixup stream capped below the number of straddling
    lookups, the overflowed ones degrade to landing-block-truncated counts
    and the truncation flag is raised (never silent corruption)."""
    monkeypatch.setenv("AITPU_WINDOW_CAP", "1")
    tier, n_live, straddlers = _multi_straddle_tier()
    q = np.zeros(64, np.uint32)
    q[: len(straddlers)] = straddlers
    import jax.numpy as jnp

    lo, cnt, trunc = tier_ranges_blocked(
        tier,
        jnp.asarray(q)[None, :],
        jnp.asarray(np.arange(64) < len(straddlers))[None, :],
        2048,
    )
    lo = np.asarray(lo)[0]
    cnt = np.asarray(cnt)[0]
    assert bool(trunc)  # overflow surfaced
    want_lo, want_cnt = reference_bounds(tier, n_live, straddlers)
    h = np.asarray(tier["hashes"])
    exact = 0
    for i, hq in enumerate(straddlers):
        # Every reported range contains only equal postings (sane truncation).
        assert np.all(h[lo[i] : lo[i] + cnt[i]] == hq)
        assert cnt[i] <= want_cnt[i]
        exact += int(cnt[i] == want_cnt[i] and lo[i] == want_lo[i])
    assert exact >= 1  # the fixup stream served its one slot


def make_tier_multi(runs):
    """Comb-layout multi-segment tier (like pack_tier): ONE merged sorted
    run; seg_len keeps per-segment counts (sum = live entries)."""
    merged = np.sort(np.concatenate(runs))
    total = merged.shape[0]
    cap = BLOCK
    while cap < total:
        cap *= 2
    hashes = np.full(cap, 0xFFFFFFFF, np.uint32)
    hashes[:total] = merged
    seg_len = np.asarray([r.shape[0] for r in runs], np.int32)
    h = jnp.asarray(hashes)
    return {
        "hashes": h,
        "block_index": h[::BLOCK],
        "seg_start": jnp.zeros(len(runs), jnp.int32),
        "seg_len": jnp.asarray(seg_len),
    }


def test_multisegment_merged_run_exact():
    """Multi-segment tiers pack as ONE merged run (comb layout): every
    query's (lo, cnt) over the combined table must match bisect on the
    merged live array, including straddling equal-hash runs."""
    rng = np.random.default_rng(11)
    n0, n1 = 600_000, 700_000
    h0 = np.sort(rng.integers(0, 2**20, n0, dtype=np.uint32))
    h1 = np.sort(rng.integers(2**21, 2**22, n1, dtype=np.uint32))
    straddle_vals = []
    for k in (1, 5, 100):
        p = k * BLOCK
        v = h1[p]
        h1[p - 2 : p + 2] = v
        straddle_vals.append(int(v))
    h1 = np.sort(h1)
    tier = make_tier_multi([h0, h1])
    n_live = n0 + n1
    merged = np.asarray(tier["hashes"])[:n_live]

    queries = (
        straddle_vals
        + [int(h0[0]), int(h0[-1]), int(h1[0]), int(h1[-1])]
        + [int(h0[1234]), int(h1[4321]), 5, 2**20 + 17, 0xFFFFFFFE]
    )
    q = np.zeros(64, np.uint32)
    q[: len(queries)] = queries
    lo, cnt, trunc = tier_ranges_blocked(
        tier,
        jnp.asarray(q)[None, :],
        jnp.asarray(np.arange(64) < len(queries))[None, :],
        2048,
    )
    lo = np.asarray(lo)[0]  # (Q,)
    cnt = np.asarray(cnt)[0]
    from bisect import bisect_left, bisect_right

    for qi, hv in enumerate(queries):
        want_lo = bisect_left(merged, hv)
        want_cnt = bisect_right(merged, hv) - want_lo
        assert cnt[qi] == want_cnt, (qi, hv, cnt[qi], want_cnt)
        if want_cnt:
            assert lo[qi] == want_lo, (qi, hv, lo[qi], want_lo)
    assert not bool(trunc)
