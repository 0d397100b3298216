"""Two-level postings lookup over BLOCK-posting blocks.

The range phase of a search finds, for every (batch, query hash), the run
of equal hashes in a tier's merged sorted postings.  A bounded binary
search over the whole table costs ~log2(cap) dependent random gathers per
lookup.  This module replaces it with the block index of the reference
(/root/reference/src/block.zig: fixed-size blocks plus a per-block first
hash, built for memory-system friendliness):

  1. a bounded binary search over the sampled top index `hashes[::BLOCK]`
     (one u32 per block, ~1 MB per 268M postings, so it stays in L2)
     picks each lookup's LANDING block;
  2. `landing_lookup` counts the entries < q and == q inside that block
     and, for the direct serving path, emits the two docid rows that
     cover the run's first postings.

The landing scan is plain XLA: a bounded binary search inside the
landing block (unrolled, so XLA emits straight-line gathers) plus a
two-row gather.  A hand-written Triton kernel that read each lookup's
whole 4 KB block was measured against it on the H100 and did not beat it
end to end (PERF.md), so it was removed.

A hash run can straddle a block boundary (when the run's tail begins a
block, the top index points there and the head lives in the previous
block).  The top index identifies those lookups up front (the landing
block's first sampled hash equals the query), and each one gets an extra
single-block scan of the previous block appended to the same landing
stream; the two scans compose exactly (see tier_ranges_blocked).  Runs
longer than that two-block window are truncated and flagged — the
analogue of the reference's MAX_DOCS_PER_HASH / MAX_BLOCKS_PER_HASH scan
bounds.

Tiers are packed as ONE merged hash-sorted run (the comb layout,
engine/segments.py pack_tier), so the lookup stream is (batch, hash) —
independent of the tier's segment count.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .binsearch import lower_bound, steps_for, upper_bound
from .layout import BLOCK

ROWS = BLOCK // 128  # 128-wide rows per block; the emitted docid row width
_SCAN_STEPS = steps_for(BLOCK)


def landing_lookup(table, blk, queries, *, stride: int, emit: bool):
    """Per lookup j: entries < queries[j] and == queries[j] inside block
    blk[j] of `table`.

    `table` is a flat u32 postings array of BLOCK-entry blocks: hashes only
    (stride=1) or the interleaved layout (stride=2, ops/layout.py: each
    block's hashes followed by its docids).  Returns (lo, eq) with
    lo = blk*BLOCK + lt (a posting index); with `emit=True` (interleaved
    only) also rows (L, 2, 128) u32: docid rows r and min(r+1, ROWS-1) of
    the landing block, r = lt // 128.  Those rows cover postings
    [blk*BLOCK + 128*r, blk*BLOCK + 128*(r+2)) — a superset of
    [lo, lo+128] — which the direct serving path reads its leading docids
    from (search_kernel._direct_candidates).

    The bounds come from a bounded binary search inside the block
    (steps_for(BLOCK) gather steps), the rows from one two-row gather; the
    (-1, 128) view keeps row indices far below 2^31 at any table size (see
    layout._inter_gather)."""
    assert stride in (1, 2) and not (emit and stride != 2), (stride, emit)
    blk = blk.astype(jnp.int32)
    queries = queries.astype(jnp.uint32)
    tab = table.reshape(-1, 128)
    row0 = blk * (stride * ROWS)

    def value(pos):
        p = jnp.minimum(pos, BLOCK - 1)
        return tab[row0 + (p >> 7), p & 127]

    def step(_, carry):
        lo_l, hi_l, lo_u, hi_u = carry
        mid_l = (lo_l + hi_l) >> 1
        mid_u = (lo_u + hi_u) >> 1
        go_l = jnp.logical_and(lo_l < hi_l, value(mid_l) < queries)
        go_u = jnp.logical_and(lo_u < hi_u, value(mid_u) <= queries)
        return (
            jnp.where(go_l, mid_l + 1, lo_l),
            jnp.where(jnp.logical_or(go_l, lo_l >= hi_l), hi_l, mid_l),
            jnp.where(go_u, mid_u + 1, lo_u),
            jnp.where(jnp.logical_or(go_u, lo_u >= hi_u), hi_u, mid_u),
        )

    zero = jnp.zeros(queries.shape, jnp.int32)
    full = jnp.full(queries.shape, BLOCK, jnp.int32)
    # Unrolled: a rolled loop runs as a device while loop whose per-step
    # control costs far more than the step's tiny gathers.
    lt, _, ub, _ = jax.lax.fori_loop(0, _SCAN_STEPS, step, (zero, full, zero, full), unroll=True)
    lo = blk * BLOCK + lt
    if not emit:
        return lo, ub - lt
    r = jnp.minimum(lt >> 7, ROWS - 1)
    r2 = jnp.minimum(r + 1, ROWS - 1)
    drow = row0 + ROWS  # the block's docid rows follow its hash rows
    return lo, ub - lt, jnp.stack([tab[drow + r], tab[drow + r2]], axis=1)


def tier_ranges_blocked(tier, queries, valid_q, cap_k, emit: bool = False):
    """Two-level replacement for the tier's range phase over its MERGED
    sorted postings run.

    `queries`/`valid_q` are (B, Q); returns lo/counts of shape (B, Q) plus
    a truncation flag.  Requires tier["block_index"].  One lookup per
    query hash regardless of the tier's segment count — the comb layout
    (engine/segments.py pack_tier) makes the range phase S-independent.

    `emit=True` (interleaved tiers only) additionally returns each lookup's
    landing-block docid rows and a covered mask — see landing_lookup; the
    return becomes (lo, cnt, trunc, rows (B*Q, 2, 128) u32, covered (B, Q)
    bool).
    """
    B, Q = queries.shape
    block_index = tier["block_index"]
    nblk = block_index.shape[0]
    if "inter" in tier:
        postings, stride = tier["inter"], 2  # interleaved blocks (ops/layout.py)
    else:
        assert not emit, "emit requires the interleaved layout"
        postings, stride = tier["hashes"], 1
    n_items = jnp.sum(tier["seg_len"]).astype(jnp.int32)
    blk_last = jnp.maximum((n_items - 1) // BLOCK, 0)

    # Stage 1: landing block per (batch, hash) from the small top index.
    # `blk` is the LAST block whose first sampled hash is <= q, so a run
    # never extends past it; it can extend BEFORE it exactly when that
    # first sample == q, in which case the window steps back one block.
    # The top index (<= a few MB) stays in L2, so its bounded binary search
    # is cheap next to the landing scans.
    qf = queries.reshape(-1)
    steps = steps_for(nblk)
    ub = upper_bound(block_index, qf, jnp.int32(0), jnp.int32(nblk), steps=steps)
    lb = lower_bound(block_index, qf, jnp.int32(0), jnp.int32(nblk), steps=steps)
    ub = ub.astype(jnp.int32).reshape(B, Q)
    eq_top = (ub - lb.astype(jnp.int32).reshape(B, Q))  # equal top-index entries
    blk = jnp.clip(jnp.clip(ub - 1, 0, blk_last), 0, nblk - 1).astype(jnp.int32)

    # Window decisions from the top index alone: equal entries occupy
    # [ub - eq_top, ub), so block_index[blk] == q <=> eq_top > 0 (the
    # step-back case), and the run reaches below the two-block window
    # exactly when block_index[blk - 1] == q as well (eq_top >= 2).
    step_back = jnp.logical_and(eq_top > 0, blk > 0)
    b0 = jnp.where(step_back, blk - 1, blk)
    b1 = jnp.minimum(b0 + 1, nblk - 1)
    enabled = jnp.logical_and(step_back, jnp.logical_and(b1 <= blk_last, b1 != b0))
    spill = jnp.logical_and(jnp.logical_and(step_back, b0 > 0), eq_top >= 2)

    # Dead query lanes all read block 0 (it stays cached); their counts
    # are masked to 0 below anyway.
    live = jnp.logical_and(valid_q, n_items > 0)
    b0 = jnp.where(live, b0, 0)

    # Stage 2: single-block scan of each lookup's LANDING block, with the
    # straddle fixup riding the SAME stream.  Only straddling runs need to
    # see the previous block, and the top index already told us which
    # lookups those are (step_back): for a straddler the landing block's
    # first entry == q, so nothing in it is < q and the two-block window
    # result decomposes exactly as
    #     lo  = b0*BLOCK + lt(b0)          (lt+eq == BLOCK in b0, so this
    #                                       equals the landing lo when the
    #                                       run starts at the boundary)
    #     cnt = eq(b0) + eq(landing)
    # i.e. one extra single-block scan of b0 per straddler, appended to
    # the landing stream as a compacted W_CAP-slot tail (one launch).
    lookups = qf
    L = lookups.shape[0]
    window = jnp.logical_and(live, jnp.logical_or(step_back, enabled)).reshape(-1)
    blk_main = jnp.where(live, blk, 0).reshape(-1)

    # The fixup tail must cover realistic straddler loads: a hot hash
    # whose run crosses a block boundary consumes one slot per batch row
    # that queries it, so the cap scales with the stream (L/16 = full
    # coverage of 16 such hashes shared across a whole batch) with a 2048
    # floor.  Overflow degrades to flagged truncation, never corruption.
    w_cap = min(max(int(os.environ.get("AITPU_WINDOW_CAP", "2048")), L // 16), L)
    r = jnp.cumsum(window.astype(jnp.int32)) - 1
    slot = jnp.where(jnp.logical_and(window, r < w_cap), r, w_cap)
    sel = (
        jnp.zeros(w_cap + 1, jnp.int32)
        .at[slot]
        .set(jnp.arange(L, dtype=jnp.int32), mode="drop")[:w_cap]
    )
    n_w = jnp.sum(window.astype(jnp.int32))
    valid_w = jnp.arange(w_cap, dtype=jnp.int32) < n_w
    fb0 = jnp.where(valid_w, b0.reshape(-1)[sel], 0)
    fq = jnp.where(valid_w, lookups[sel], jnp.uint32(0))

    ext_blk = jnp.concatenate([blk_main, fb0])
    ext_q = jnp.concatenate([lookups, fq])
    rows = None
    if emit:
        # `covered` (below) marks lookups whose (lo, cnt) still describe
        # the landing block after the straddle fixup — only those may read
        # their leading docids from the rows; straddlers' values move to
        # the previous block.  The fixup tail's rows are sliced off.
        lo_all, cnt_all, rows_all = landing_lookup(postings, ext_blk, ext_q, stride=stride, emit=True)
        rows = rows_all[:L]
    else:
        lo_all, cnt_all = landing_lookup(postings, ext_blk, ext_q, stride=stride, emit=False)
    lo_flat, cnt_flat = lo_all[:L], cnt_all[:L]

    # Compose each straddler's exact (lo, cnt) from its b0 tail scan + its
    # landing scan (see the decomposition above), then scatter over the
    # landing-truncated values.  Dead tail slots target index L -> dropped.
    lo_fix = lo_all[L : L + w_cap]
    cnt_fix = cnt_all[L : L + w_cap] + cnt_flat[jnp.clip(sel, 0, L - 1)]
    tgt = jnp.where(valid_w, sel, L)
    lo_flat = lo_flat.at[tgt].set(lo_fix, mode="drop")
    cnt_flat = cnt_flat.at[tgt].set(cnt_fix, mode="drop")
    # Straddlers beyond w_cap keep their landing-block-truncated values —
    # flagged below like every other scan-bound truncation.
    w_over = n_w > w_cap

    lo = lo_flat.reshape(B, Q)
    cnt = cnt_flat.reshape(B, Q)

    # Clamp into the live run [0, n_items).
    lo = jnp.clip(lo, 0, n_items)
    cnt = jnp.minimum(cnt, n_items - lo)
    cnt = jnp.where(valid_q, cnt, 0)
    kcap = jnp.int32(min(cap_k, 2 * BLOCK))
    cnt = jnp.minimum(cnt, kcap)
    # Truncation: the window cap clipped a long run, or the run started
    # before the two-block window (the reference's scan bounds truncate the
    # same way, surfaced the same way).
    truncated = jnp.logical_or(
        jnp.logical_or(
            jnp.any(jnp.logical_and(cnt >= kcap, live)),
            jnp.any(jnp.logical_and(spill, live)),
        ),
        w_over,
    )
    if emit:
        # A lookup is covered exactly when its (lo, cnt) still point into
        # the landing block the emitted rows came from: every non-straddler
        # (a run never extends past its landing block — see the top-index
        # invariant above — so rows r, r+1 always span [lo, lo+128]).
        covered = jnp.logical_and(live, jnp.logical_not(window.reshape(B, Q)))
        return lo, cnt, truncated, rows, covered
    return lo, cnt, truncated
