"""The device search kernel: exact fpindex scoring as one jitted XLA program.

Reference semantics being reproduced (see /root/reference/src):
  * per query hash, find its postings run in every segment and count one hit
    per posting occurrence (FileSegment.zig:135-180, MemorySegment.zig:44-54);
  * per doc, the *newest* segment with any hit wins and its hit count is the
    score (SearchResults.incr, common.zig:121-129);
  * candidates with score >= min_score are ranked (score desc, id asc); a doc
    is dropped if any newer segment *mentions* it (insert or tombstone —
    Segments.hasNewerCommit, Index.zig:133-149); the relative score_pct
    cutoff anchors on the best surviving candidate; at most `limit` results
    (SearchResults.finish, common.zig:131-167).

Mapping to the device: segments are immutable sorted (hash, docid) runs
packed into flat device buffers — one buffer pair per tier.  The file tier is large and
changes only at checkpoint/merge; the memory tier repacks per write batch and
stays small (bounded by the checkpoint threshold), so a write never touches
the big buffer.  Global segment ordinals run file-tier-first then memory
tier, oldest to newest — the same order the reference scans segments and the
order commit ids ascend, so ordinal comparison decides supersession exactly
like commit-id comparison does in SearchResults.incr.

For a query we run a fixed-step binary search for all (segment, hash) pairs
at once, expand the ragged hit ranges into a fixed postings budget P via a
prefix-sum gather, sort once by (docid, ordinal), score runs by run length,
and resolve supersession with one binary search per tier over a merged
(docid -> newest ordinal) mention table.  Everything is static-shaped and
jit-compiled; the same program runs on the CPU for tests and on the GPU for
serving.  Block-indexed tiers take the two-level block lookup
(ops/block_lookup.py).

Work bounds: K caps postings per (hash, segment) — the analogue of the
reference's MAX_DOCS_PER_HASH=1000 scan bound (FileSegment.zig:25-26) — and
P caps total postings per query; `truncated` reports when either bound
clipped real postings.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .binsearch import lower_bound, steps_for, upper_bound
from .layout import BLOCK, docid_gather, postings_cap

# numpy scalar ON PURPOSE: a module-level jnp scalar is a DEVICE array that
# every closing jaxpr captures as a constant, so each lowering fetches its
# value from the device.  A numpy scalar lowers as an inline literal with no
# device interaction and identical jnp semantics.
import numpy as _np

SENTINEL = _np.uint32(0xFFFFFFFF)

# Pytree layout of one tier of a packed segment view (see engine/segments.py):
#   hashes:   u32[CAP]   postings sort key (one merged hash-sorted run)
#   docids:   u32[CAP]   postings payload
#   seg_start i32[S], seg_len i32[S]   slot table (len 0 = unused slot)
#   block_index u32[CAP/BLOCK] sampled top index (see ops/block_lookup.py)
#   mention_ids u32[MCAP]  merged sorted mentioned-doc table (membership);
#                          MCAP >= 1 (packers allocate max(n, 1))
#   mention_len i32[]      live entries in the mention table
# (canonical field list: engine/segments.py SEARCH_TIER_FIELDS)
#
# WITHIN-TIER supersession is resolved at PACK time (pack_tier drops any
# posting whose doc a newer segment of the same tier mentions), so each
# doc's surviving postings live in exactly one segment per tier.  The
# "newest segment with a hit wins" ordinal is therefore structural — the
# tier id itself (TIER_FILE=0, TIER_MEM=1) — and query-time supersession
# reduces to "does the MEMORY tier mention this file-tier candidate".

TIER_FILE = 0
TIER_MEM = 1
ORD_INVALID = 2  # > any real tier ordinal; tags invalid gather slots


@dataclass(frozen=True)
class SearchParams:
    """Static kernel configuration (one compiled program per distinct value)."""

    query_len: int = 256  # padded query hashes
    postings_budget: int = 16384  # P: max postings gathered per query
    per_hash_cap: int = 1024  # K: max postings per (hash, segment)
    candidate_cap: int = 1024  # C: max candidates ranked
    out_len: int = 128  # padded results (the API caps limit at 100)


def _shift_left(x: jax.Array, fill) -> jax.Array:
    return jnp.concatenate([x[1:], jnp.full((1,), fill, x.dtype)])


def _tier_n_items(tier):
    """Live postings in the tier's merged run (= sum of per-slot counts)."""
    return jnp.sum(tier["seg_len"]).astype(jnp.int32)


def _tier_ranges(tier, queries, valid_q, cap_k):
    """(lo, counts, trunc) of each query hash's run in the tier's MERGED
    sorted postings ((B, Q) shapes): one bounded binary search per hash,
    independent of the segment count."""
    n_items = _tier_n_items(tier)
    assert "hashes" in tier, "interleaved tiers always take the blocked path"
    steps = steps_for(tier["hashes"].shape[0])
    lo = lower_bound(tier["hashes"], queries, jnp.int32(0), n_items, steps=steps)
    hi = upper_bound(tier["hashes"], queries, jnp.int32(0), n_items, steps=steps)
    counts = (hi - lo).astype(jnp.int32)
    counts = jnp.where(valid_q, counts, 0)
    return lo, jnp.minimum(counts, cap_k), jnp.any(counts > cap_k)


def _plan_and_gather(p: SearchParams, file_tier, mem_tier, f_lo, f_counts, m_lo, m_counts, use_mem: bool = True, use_file: bool = True):
    """Stage 2 for ONE query: ragged->dense gather from per-tier (Q,) run
    ranges over each tier's merged postings.  Returns per-posting (docid,
    tier ordinal, invalid flag) and the number of postings gathered.
    Ordinals are STRUCTURAL (TIER_FILE/TIER_MEM): pack-time filtering
    guarantees one segment per doc per tier, so no ordinal column exists.

    `use_mem=False` compiles a variant with no memory-tier gather, selected
    at runtime by the caller's lax.cond when the memory tier is empty (the
    fully-merged steady state); `use_file=False` is the mirror for
    mem-only gathers (the direct path's memory-tier side, where the caller
    passes zeroed file counts)."""
    Q, P = p.query_len, p.postings_budget

    # Flat index j in [0, 2Q): file-tier hash j < Q, memory-tier hash j - Q.
    flat_counts = jnp.concatenate([f_counts.reshape(-1), m_counts.reshape(-1)])
    flat_lo = jnp.concatenate([f_lo.reshape(-1), m_lo.reshape(-1)])
    n_flat = 2 * Q
    cum = jnp.cumsum(flat_counts, dtype=jnp.int32)
    grand_total = cum[-1]
    total = jnp.minimum(grand_total, P)

    pos = jnp.arange(P, dtype=jnp.int32)
    if n_flat <= 1024:
        # Dense compare-sum + one-hot matmul extraction of the per-j values
        # (a (P, 2Q) one-hot against the tiny cum array) instead of
        # per-element gathers.
        j = jnp.sum((cum[None, :] <= pos[:, None]).astype(jnp.int32), axis=1)
        j = jnp.clip(j, 0, n_flat - 1)
        onehot = (jnp.arange(n_flat, dtype=jnp.int32)[None, :] == j[:, None]).astype(jnp.float32)
        cum_before = (cum - flat_counts).astype(jnp.float32)  # < 2^24: exact in f32
        # precision=HIGHEST pins true-f32 dots: extraction exactness relies
        # on exact f32 integer arithmetic, which a bf16 or TF32 (10-bit
        # mantissa) DEFAULT matmul precision would silently break.
        hi_p = jax.lax.Precision.HIGHEST
        cb = jnp.dot(onehot, cum_before, preferred_element_type=jnp.float32, precision=hi_p).astype(jnp.int32)
        # flat_lo can exceed 2^24 (table positions): extract in two exact
        # 16-bit halves.
        lo_lo = jnp.dot(onehot, (flat_lo & 0xFFFF).astype(jnp.float32), preferred_element_type=jnp.float32, precision=hi_p)
        lo_hi = jnp.dot(onehot, (flat_lo >> 16).astype(jnp.float32), preferred_element_type=jnp.float32, precision=hi_p)
        within = pos - cb
        src = (lo_hi.astype(jnp.int32) << 16) + lo_lo.astype(jnp.int32) + within
    else:
        # Hand-rolled bounded search over the cumulative counts.
        j = upper_bound(
            cum.astype(jnp.uint32), pos.astype(jnp.uint32), jnp.int32(0), jnp.int32(n_flat),
            steps=steps_for(n_flat),
        ).astype(jnp.int32)
        j = jnp.clip(j, 0, n_flat - 1)
        within = pos - (cum[j] - flat_counts[j])
        src = flat_lo[j] + within
    p_valid = pos < total

    is_mem = j >= Q
    if use_file:
        src_f = jnp.clip(src, 0, postings_cap(file_tier) - 1)
        f_vals = docid_gather(file_tier, src_f)
    if use_mem:
        src_m = jnp.clip(src, 0, postings_cap(mem_tier) - 1)
        m_vals = docid_gather(mem_tier, src_m)
    if use_file and use_mem:
        vals = jnp.where(is_mem, m_vals, f_vals)
        ords = jnp.where(is_mem, TIER_MEM, TIER_FILE)
    elif use_file:
        vals = f_vals
        ords = jnp.broadcast_to(jnp.int32(TIER_FILE), f_vals.shape)
    else:
        vals = m_vals
        ords = jnp.broadcast_to(jnp.int32(TIER_MEM), m_vals.shape)
    d = jnp.where(p_valid, vals, SENTINEL)
    o = jnp.where(p_valid, ords, ORD_INVALID).astype(jnp.int32)
    inv = jnp.logical_not(p_valid).astype(jnp.int32)
    return d, o, inv, total, grand_total > P


def _tier_ranges_dense(tier, queries, valid_q, cap_k):
    """(lo, counts, trunc) for a SMALL tier via one dense compare + matmul
    reduction for the whole (B, Q) batch ((B, Q) shapes over the tier's
    merged run): every query compares against the entire (<= 4096-entry)
    table instead of paying dependent binary-search gathers."""
    assert "hashes" in tier, "interleaved tiers always take the blocked path"
    cap = tier["hashes"].shape[0]
    B, Q = queries.shape
    n_items = _tier_n_items(tier)
    pos = jnp.arange(cap, dtype=jnp.int32)
    live = (pos < n_items).astype(jnp.float32)[:, None]  # (cap, 1)

    qf = queries.reshape(-1)  # (B*Q,)
    lt = (tier["hashes"][None, :] < qf[:, None]).astype(jnp.float32)
    le = (tier["hashes"][None, :] <= qf[:, None]).astype(jnp.float32)
    # Counts <= cap <= 4096 are exact in f32.
    hi_p = jax.lax.Precision.HIGHEST  # exact f32 dots (see _plan_and_gather)
    lt_c = jnp.dot(lt, live, preferred_element_type=jnp.float32, precision=hi_p)[:, 0]
    le_c = jnp.dot(le, live, preferred_element_type=jnp.float32, precision=hi_p)[:, 0]
    cnt = (le_c - lt_c).astype(jnp.int32).reshape(B, Q)
    lo = lt_c.astype(jnp.int32).reshape(B, Q)
    cnt = jnp.where(valid_q, cnt, 0)
    trunc = jnp.any(cnt > cap_k)
    return lo, jnp.minimum(cnt, cap_k), trunc


def _batch_ranges(p: SearchParams, file_tier, mem_tier, queries, q_lens, want_emit: bool = False):
    """Stage 1 for a (B, Q) query batch: per-tier (B, Q) run ranges over
    each tier's MERGED sorted postings.  Uses a dense compare + matmul
    reduction for tiny tiers, the two-level block lookup (one flattened
    lookup stream serves the whole batch) for every block-indexed tier
    above that, and the bounded binary search for anything else.

    `want_emit=True` appends a sixth return value: (rows, covered) from the
    file tier's emitting blocked lookup (None when the file tier doesn't
    take the interleaved blocked path) — the input to _direct_candidates."""
    from .block_lookup import tier_ranges_blocked

    Q, K = p.query_len, p.per_hash_cap
    B = queries.shape[0]
    valid_q = jnp.arange(Q, dtype=jnp.int32)[None, :] < q_lens[:, None]

    outs = []
    emit_info = None
    for tier in (file_tier, mem_tier):
        cap = postings_cap(tier)
        # Static-shape decision (smallest-cost path that fits):
        #   * tiny tiers compare densely;
        #   * block-indexed tiers (every packed tier past the dense size,
        #     interleaved or not) take the two-level block lookup;
        #   * anything else (hand-built tiers without a block index)
        #     binary-searches.
        if "inter" in tier:
            # layout.use_interleaved guarantees the blocked path's gating.
            if want_emit and tier is file_tier:
                lo, cnt, tr, rows, covered = tier_ranges_blocked(
                    tier, queries, valid_q, K, emit=True
                )
                emit_info = (rows, covered)
                outs.append((lo, cnt, tr))
            else:
                outs.append(tier_ranges_blocked(tier, queries, valid_q, K))
        elif cap <= 4096 and B * Q * cap <= (1 << 28):
            # The dense compare materializes (B*Q, cap) f32 operands; the
            # volume bound keeps that under ~1GB (a 4096-bucket batch of
            # 256 queries against a 4096-entry tier would otherwise build
            # 16GB operands and OOM HBM).
            outs.append(_tier_ranges_dense(tier, queries, valid_q, K))
        elif "block_index" in tier and cap % BLOCK == 0:
            outs.append(tier_ranges_blocked(tier, queries, valid_q, K))
        else:
            outs.append(_tier_ranges(tier, queries, valid_q, K))
    (f_lo, f_cnt, f_tr), (m_lo, m_cnt, m_tr) = outs
    if want_emit:
        return f_lo, f_cnt, m_lo, m_cnt, jnp.logical_or(f_tr, m_tr), emit_info
    return f_lo, f_cnt, m_lo, m_cnt, jnp.logical_or(f_tr, m_tr)


def tier_mentions(tier, cand_ids):
    """Bool: the tier mentions each candidate doc (insert or tombstone).
    ONE binary search over the tier's merged mention table."""
    cap = tier["mention_ids"].shape[0]
    lo = lower_bound(
        tier["mention_ids"], cand_ids, jnp.int32(0), tier["mention_len"],
        steps=steps_for(cap),
    )
    lo_c = jnp.clip(lo, 0, cap - 1)
    return jnp.logical_and(lo < tier["mention_len"], tier["mention_ids"][lo_c] == cand_ids)


def tier_mentions_dense(tier, cand_ids):
    """Dense variant for SMALL mention tables: one vectorized compare of
    every candidate against the whole table beats per-candidate binary
    search (XLA lowers each search step to a dependent per-element gather
    — ~32 of them per candidate cost more than a whole search batch; an
    EMPTY memory-tier table still paid all of it)."""
    ids = tier["mention_ids"]
    cap = ids.shape[0]
    live = jnp.arange(cap, dtype=jnp.int32)[None, :] < tier["mention_len"]
    eq = jnp.logical_and(ids[None, :] == cand_ids[:, None], live)
    return jnp.any(eq, axis=1)


def _score_rank(p: SearchParams, d, o, inv, min_score):
    """Stage 3-4: sort, run-length score, candidate ranking.  Returns the
    top-C (docid, winning ordinal, score, validity)."""
    P = d.shape[0]
    C = p.candidate_cap

    # 3. One single-key sort: key = docid - 1 (docid 0 is rejected at ingest,
    # so the subtraction never collides with the 0xFFFFFFFF invalid
    # sentinel), ordinal rides as payload.  Within a doc group the winning
    # ordinal is just the max, and the score is how many hits carry it —
    # segment_max/segment_sum reproduce SearchResults.incr without needing
    # ordinals sorted, which keeps the sort to one key + one payload.
    key = jnp.where(inv == 0, d - jnp.uint32(1), SENTINEL)
    key, o = jax.lax.sort((key, o), num_keys=1)
    p_valid = key != SENTINEL

    key_prev = jnp.concatenate([jnp.full((1,), 0, key.dtype), key[:-1]])
    first = jnp.arange(P, dtype=jnp.int32) == 0
    grp_start = jnp.logical_or(first, key != key_prev)
    gid = jnp.cumsum(grp_start.astype(jnp.int32)) - 1
    max_o = jax.ops.segment_max(jnp.where(p_valid, o, -1), gid, num_segments=P)
    is_win = jnp.logical_and(p_valid, o == max_o[gid])
    grp_score = jax.ops.segment_sum(is_win.astype(jnp.int32), gid, num_segments=P)

    key_next = _shift_left(key, 0)
    last_pos = jnp.arange(P, dtype=jnp.int32) == P - 1
    doc_last = jnp.logical_and(p_valid, jnp.logical_or(last_pos, key != key_next))

    d = jnp.where(p_valid, key + jnp.uint32(1), SENTINEL)
    o = max_o[gid]
    score = grp_score[gid]
    cand = jnp.logical_and(doc_last, score >= min_score)

    # 4. Rank candidates (score desc, id asc) and take the top C.  One u32
    # key encodes validity + descending score (score <= P < 2^31); the score
    # is RECOVERED from the key after the sort rather than carried as a
    # fourth payload array (sort cost scales with operand count).
    rank_key = jnp.where(cand, jnp.uint32(P) - score.astype(jnp.uint32), jnp.uint32(0xFFFFFFFF))
    rk, cd, co = jax.lax.sort((rank_key, d, o), num_keys=2)
    rk, cd, co = rk[:C], cd[:C], co[:C]
    c_valid = rk != jnp.uint32(0xFFFFFFFF)
    csc = jnp.where(c_valid, jnp.uint32(P) - rk, jnp.uint32(0)).astype(jnp.int32)
    # More candidates reached min_score than C slots: the tail was dropped
    # before supersession/limit filtering, so results are approximate —
    # surface it like the per-hash/budget caps do.
    c_over = jnp.sum(cand.astype(jnp.int32)) > C
    return cd, co, csc, c_valid, c_over


def _final_select(p: SearchParams, cd, co, csc, c_valid, newest, limit, min_score, pct):
    """Stage 5-7 given the newest mention ordinal per candidate."""
    C = p.candidate_cap
    # 5. Supersession: a strictly newer segment mentions the doc -> dead.
    dead = newest > co
    alive = jnp.logical_and(c_valid, jnp.logical_not(dead))

    # 6. Final cutoffs: the best survivor anchors the relative threshold
    # (finish() raises min_score once, on the first surviving candidate).
    best = jnp.max(jnp.where(alive, csc, 0))
    cutoff = jnp.maximum(min_score, best * pct // 100)
    rank = jnp.cumsum(alive.astype(jnp.int32)) - 1
    # `limit` is clamped to the padded output width; the searcher picks an
    # out_len bucket covering the requested limit (128 for the HTTP API's
    # 100-cap, 512 for the legacy protocol's 500 default), so the clamp only
    # bites on limits beyond every bucket.
    limit_eff = jnp.minimum(limit, jnp.int32(p.out_len))
    keep = jnp.logical_and(alive, jnp.logical_and(csc >= cutoff, rank < limit_eff))

    # 7. Compact kept results to the front (order is already score desc, id asc).
    order = jnp.arange(C, dtype=jnp.int32)
    _, _, out_ids, out_scores = jax.lax.sort(
        (jnp.logical_not(keep).astype(jnp.int32), order, cd, csc), num_keys=2
    )
    n = jnp.sum(keep.astype(jnp.int32))

    out_ids = out_ids[: p.out_len]
    out_scores = out_scores[: p.out_len]
    mask = jnp.arange(p.out_len, dtype=jnp.int32) < n
    return {
        "ids": jnp.where(mask, out_ids, 0),
        "scores": jnp.where(mask, out_scores, 0),
        "count": n,
    }


def _batch_newest(mem_tier, cand_flat, valid_flat, mem_mentions_any=None):
    """Newest mention TIER ordinal for a flattened candidate stream: with
    within-tier supersession resolved at pack time, the only query-time
    supersession left is "a memory-tier mention kills a file-tier
    candidate" — a membership test against the (small) memory-tier mention
    table.  Returns TIER_MEM where mentioned, -1 otherwise.

    With no memory-tier mentions at all (the fully-merged steady state AND
    every pure-file state), the lookup is skipped at runtime (lax.cond; the
    table branch still compiles).  Sharded callers must pass
    `mem_mentions_any` computed GLOBALLY (candidate docs are docid-range
    sharded: another shard can hold the mention this shard lacks).

    The lookup branch must stay free of collectives: under shard_map its
    predicate includes `any_in_range`, which each shard computes from its
    LOCAL mention table, so shards can take different branches (a
    collective inside would deadlock the mesh)."""
    assert mem_tier["mention_ids"].shape[0] >= 1, (
        "mention_ids needs capacity >= 1 (the range gate reads its first entry)"
    )

    def lookup(_):
        cap = mem_tier["mention_ids"].shape[0]
        if cap <= 4096 and cap * cand_flat.shape[0] <= (1 << 28):
            found = tier_mentions_dense(mem_tier, cand_flat)
        else:
            found = tier_mentions(mem_tier, cand_flat)
        return jnp.where(found, TIER_MEM, -1).astype(jnp.int32)

    if mem_mentions_any is None:
        mem_mentions_any = mem_tier["mention_len"] > 0
    # Mention-range gate (exact): the mention table is sorted ascending
    # with 0xFFFFFFFF sentinel padding (build_mention_table), so no
    # candidate outside [ids[0], ids[len-1]] can be mentioned.  The
    # write-heavy serving state's memory tier mentions only a recent id
    # window; a batch whose candidates are all older docs skips the whole
    # lookup.  Sharded callers pass a GLOBAL
    # mem_mentions_any; the range test is against the LOCAL table, which
    # is exactly what the local lookup could find — pmax still combines
    # the per-shard answers.  mention_len == 0 reads sentinels for lo/hi,
    # and the mem_mentions_any conjunct already holds the gate shut.
    ids = mem_tier["mention_ids"]
    lo = ids[0]
    hi = ids[jnp.maximum(mem_tier["mention_len"] - 1, 0)]
    cand_u = cand_flat.astype(jnp.uint32)
    in_range = jnp.logical_and(cand_u >= lo, cand_u <= hi)
    any_in_range = jnp.any(jnp.logical_and(in_range, valid_flat.astype(bool)))
    return jax.lax.cond(
        jnp.logical_and(mem_mentions_any, any_in_range),
        lookup,
        lambda _: jnp.full(cand_flat.shape, -1, jnp.int32),
        operand=None,
    )


P_SMALL = 256  # fast-path postings budget (see _search_batch_impl)


def small_budget(p: SearchParams, f_cnt, m_cnt, B: int):
    """(p_small, per-query rough totals) for the P_SMALL fast-path
    decision — shared by the single-chip and sharded programs so the
    engagement rule cannot drift between them (each adds its own
    candidate_cap guard and, for sharded, a pmax over shards)."""
    import dataclasses

    p_small = dataclasses.replace(p, postings_budget=P_SMALL)
    totals_rough = f_cnt.reshape(B, -1).sum(axis=1) + m_cnt.reshape(B, -1).sum(axis=1)
    return p_small, totals_rough


F_DIRECT = 16  # fallback gather slots per query on the direct path
P_MEM_DIRECT = 64  # memory-tier gather slots per query on the direct path


def _direct_candidates(p: SearchParams, file_tier, rows, covered, f_lo, f_cnt, lanes_per_hash: int):
    """Gather-free stage 2 for the fully-merged steady state (all postings
    in file slot 0, empty memory tier): each hash's first `lanes_per_hash`
    docids come straight out of the emitted landing-block rows via
    elementwise one-hot lane selection — no ragged plan, no per-posting
    device-memory loads (65k random scalar gathers per batch at B=256) —
    and the rare
    remainder (runs longer than the lane budget, block-straddling runs)
    goes through ONE compacted fallback gather of F_DIRECT absolute
    positions per query.

    Exactness: the caller only selects this path (lax.cond) when every
    query's remainder fits F_DIRECT; anything else runs the ordinary
    plan+gather pipeline.  Returns (d (B, P'), inv, totals (B,)) with
    P' = lanes_per_hash*Q + F_DIRECT; ordinals are implicitly all zero
    (slot-0-only postings), the caller supplies the zeros."""
    B, Q = f_lo.shape
    E = lanes_per_hash
    rowsf = rows.reshape(B * Q, 2, 128)
    lo_f = f_lo.reshape(-1)
    cnt_f = f_cnt.reshape(-1)
    cov = covered.reshape(-1)
    off = (lo_f % 128).astype(jnp.int32)
    lane_iota = jnp.arange(128, dtype=jnp.int32)[None, :]
    lanes = []
    for e in range(E):
        ce = off + e
        sel = lane_iota == (ce & 127)[:, None]
        v0 = jnp.sum(jnp.where(sel, rowsf[:, 0, :], jnp.uint32(0)), axis=1)
        v1 = jnp.sum(jnp.where(sel, rowsf[:, 1, :], jnp.uint32(0)), axis=1)
        v = jnp.where(ce >= 128, v1, v0)
        ok = jnp.logical_and(cov, cnt_f > e)
        lanes.append((v.reshape(B, Q), ok.reshape(B, Q)))

    # Compacted fallback: per query, the stream of positions every hash
    # still owes (covered hashes start at E, straddlers at 0).  Source
    # selection is a dense one-hot over Q — small enough that VPU compare
    # volume beats per-slot gathers, like _plan_and_gather's dense branch.
    start = jnp.where(covered, E, 0)
    ov = jnp.maximum(f_cnt - start, 0)
    cum = jnp.cumsum(ov, axis=1)  # (B, Q)
    total_ov = cum[:, -1]
    fpos = jnp.arange(F_DIRECT, dtype=jnp.int32)
    jsel = jnp.sum((cum[:, None, :] <= fpos[None, :, None]).astype(jnp.int32), axis=2)
    oh = jsel[:, :, None] == jnp.arange(Q, dtype=jnp.int32)[None, None, :]

    def pick(x):
        return jnp.sum(jnp.where(oh, x[:, None, :], 0), axis=2)

    within = fpos[None, :] - pick(cum - ov) + pick(start)
    src = pick(f_lo) + within
    f_ok = fpos[None, :] < jnp.minimum(total_ov, F_DIRECT)[:, None]
    srcc = jnp.clip(jnp.where(f_ok, src, 0), 0, postings_cap(file_tier) - 1)
    fvals = docid_gather(file_tier, srcc.reshape(-1)).reshape(B, F_DIRECT)

    d = jnp.concatenate([l[0] for l in lanes] + [fvals], axis=1)
    ok = jnp.concatenate([l[1] for l in lanes] + [f_ok], axis=1)
    d = jnp.where(ok, d, SENTINEL)
    inv = jnp.logical_not(ok).astype(jnp.int32)
    return d, inv, jnp.sum(f_cnt, axis=1)


def _score_matrix(p: SearchParams, d, o, inv, min_score):
    """Stages 3-4 sort-free, for ANY ordinal mix, at the small budget:
    instead of sorting by docid and run-length scoring, build a (P, P)
    same-doc equality matrix on the VPU.  The winning ordinal per doc is a
    masked row max (SearchResults.incr's newest-segment-wins,
    common.zig:121-129), the score counts hits carrying it, and each doc's
    first occurrence is its representative row — so there is NO candidate
    cap at all on this path (every one of the <= P distinct docs has a
    slot), unlike the sort path's top-C compaction.

    Returns per-row (winning ordinal, score, candidate mask)."""
    P = d.shape[0]
    valid = inv == 0
    both = jnp.logical_and(valid[:, None], valid[None, :])
    eq = jnp.logical_and(d[:, None] == d[None, :], both)  # (P, P) same doc
    o_b = jnp.where(valid, o, -1)
    win = jnp.max(jnp.where(eq, o_b[None, :], -1), axis=1)
    score = jnp.sum(jnp.logical_and(eq, o_b[None, :] == win[:, None]).astype(jnp.int32), axis=1)
    pos = jnp.arange(P, dtype=jnp.int32)
    dup_before = jnp.any(jnp.logical_and(eq, pos[None, :] < pos[:, None]), axis=1)
    cand = jnp.logical_and(valid, jnp.logical_and(~dup_before, score >= min_score))
    return win, score, cand


def _rank_extract(p: SearchParams, d, score, keep, limit):
    """Comparison-count ranking of kept candidates (score desc, id asc —
    the composite key of SearchResults.finish) + one-hot matmul extraction
    into output order.  No sorts; u32 ids stay exact in f32 matmuls via
    16-bit halves."""
    P = d.shape[0]
    hi = jnp.where(keep, jnp.uint32(P) - score.astype(jnp.uint32), jnp.uint32(0xFFFFFFFF))
    less = jnp.logical_or(
        hi[None, :] < hi[:, None],
        jnp.logical_and(hi[None, :] == hi[:, None], d[None, :] < d[:, None]),
    )
    rank = jnp.sum(jnp.logical_and(less, keep[None, :]).astype(jnp.int32), axis=1)
    limit_eff = jnp.minimum(limit, jnp.int32(p.out_len))
    final = jnp.logical_and(keep, rank < limit_eff)
    n = jnp.sum(final.astype(jnp.int32))

    r_iota = jnp.arange(p.out_len, dtype=jnp.int32)
    onehot = jnp.logical_and(final[None, :], r_iota[:, None] == rank[None, :]).astype(
        jnp.float32
    )  # (out_len, P)
    hi_p = jax.lax.Precision.HIGHEST  # exact f32 dots (see _plan_and_gather)
    id_lo = jnp.dot(onehot, (d & jnp.uint32(0xFFFF)).astype(jnp.float32), preferred_element_type=jnp.float32, precision=hi_p)
    id_hi = jnp.dot(onehot, (d >> 16).astype(jnp.float32), preferred_element_type=jnp.float32, precision=hi_p)
    out_ids = (id_hi.astype(jnp.uint32) << 16) + id_lo.astype(jnp.uint32)
    out_scores = jnp.dot(onehot, score.astype(jnp.float32), preferred_element_type=jnp.float32, precision=hi_p).astype(jnp.int32)
    return {"ids": out_ids, "scores": out_scores, "count": n}


def _final_select_matrix(p: SearchParams, d, score, win, cand, newest, limit, min_score, pct):
    """Stages 5-7 sort-free: supersession kill (a strictly newer segment
    mentions the doc), pct cutoff anchored on the best survivor, ranked
    extraction.  Semantics identical to _final_select / the reference's
    finish (common.zig:131-167); rank-among-alive and rank-among-kept
    agree because {score >= cutoff} is a prefix of the score-sorted order."""
    alive = jnp.logical_and(cand, jnp.logical_not(newest > win))
    best = jnp.max(jnp.where(alive, score, 0))
    cutoff = jnp.maximum(min_score, best * pct // 100)
    keep = jnp.logical_and(alive, score >= cutoff)
    return _rank_extract(p, d, score, keep, limit)


def _search_batch_impl(p: SearchParams, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts):
    """(B, Q) batch: one range phase for the whole batch (Pallas-friendly),
    then plan + score vmapped per query."""
    B = queries.shape[0]
    # The emitting range phase powers the gather-free direct path; the
    # emission itself costs nothing over the plain landing kernel, but the
    # direct candidate width E*Q+F only stays matrix-friendly for the
    # fingerprint-sized query buckets.
    want_emit = "inter" in file_tier and p.query_len <= 256
    emit_info = None
    if want_emit:
        f_lo, f_cnt, m_lo, m_cnt, trunc, emit_info = _batch_ranges(
            p, file_tier, mem_tier, queries, q_lens, want_emit=True
        )
    else:
        f_lo, f_cnt, m_lo, m_cnt, trunc = _batch_ranges(p, file_tier, mem_tier, queries, q_lens)

    def rank_all(use_mem, p_eff):
        def rank_query(f_lo1, f_cnt1, m_lo1, m_cnt1, min_score):
            d, o, inv, total, over = _plan_and_gather(
                p_eff, file_tier, mem_tier, f_lo1, f_cnt1, m_lo1, m_cnt1, use_mem=use_mem
            )
            cd, co, csc, c_valid, c_over = _score_rank(p_eff, d, o, inv, min_score)
            return cd, co, csc, c_valid, total, jnp.logical_or(over, c_over)

        return lambda _: jax.vmap(rank_query)(f_lo, f_cnt, m_lo, m_cnt, min_scores)

    # Runtime branches OUTSIDE the vmap (cond under vmap degrades to select,
    # executing both sides):
    #   * an empty memory tier — the fully-merged steady state — skips its
    #     gather entirely;
    #   * a batch whose every query gathers <= P_SMALL postings (the
    #     overwhelmingly common case: a ~120-hash fingerprint query touches
    #     ~125 postings on a collision-bearing corpus, 8x below the 1024+
    #     serving budget) runs the gather + both sorts at P_SMALL — the
    #     gather and the scoring sorts scale with the static budget, so the
    #     narrow variant is ~4x cheaper.  Candidate outputs keep the same
    #     (C,) shapes, and the fast path requires C <= P_SMALL so the rank
    #     sort's top-C slice stays well-formed.
    # "Memory tier live FOR THIS BATCH": at least one queried hash has a
    # memory-tier posting.  Strictly sharper than the tier-nonempty test —
    # the write-heavy serving state holds small recent segments that most
    # query batches never touch (m_cnt all zero), and for those batches the
    # mem-side gathers return pure sentinels, so skipping them is exact.
    # Supersession is NOT gated by this — a mem segment can supersede file
    # candidates without holding any queried hash (_batch_newest has its
    # own mention-range gate).
    has_mem = jnp.sum(m_cnt) > 0
    small_ok = p.postings_budget > P_SMALL and p.candidate_cap <= P_SMALL
    if small_ok:
        p_small, totals_rough = small_budget(p, f_cnt, m_cnt, B)
        small = jnp.max(totals_rough) <= P_SMALL

    # Per-query max of per-hash scan work (postings for one hash across
    # both tiers): the reference's scanned-docs-per-hash histogram
    # (FileSegment.zig:177-178, metrics.zig:96-101) — the load-skew
    # signal.  One cheap reduction over counts already computed.
    max_per_hash = jnp.max(f_cnt + m_cnt, axis=1).astype(jnp.int32)
    # Blocks (BLOCK-sized tiles) a hash's run spans, summed across tiers —
    # the reference's scanned-blocks-per-hash series (metrics.zig:96-101;
    # its per-hash cap is MAX_BLOCKS_PER_HASH=4, FileSegment.zig:25).
    def tier_blocks(lo, cnt):
        hi = lo + jnp.maximum(cnt, 1) - 1
        return jnp.where(cnt > 0, hi // BLOCK - lo // BLOCK + 1, 0)

    max_blocks_per_hash = jnp.max(
        tier_blocks(f_lo, f_cnt) + tier_blocks(m_lo, m_cnt), axis=1
    ).astype(jnp.int32)

    def sort_path(_):
        """Stages 3-7 via the sorting pipeline at the FULL budget (any
        query gathering > P_SMALL postings lands here)."""
        cd, co, csc, c_valid, totals, overs = jax.lax.cond(
            has_mem, rank_all(True, p), rank_all(False, p), None
        )

        # Supersession runs once for the whole batch's candidate stream so
        # the mention lookup never sits under vmap.
        newest = _batch_newest(mem_tier, cd.reshape(-1), c_valid.reshape(-1)).reshape(cd.shape)

        def select_query(cd1, co1, csc1, cv1, nw1, limit, min_score, pct, total, over):
            out = _final_select(p, cd1, co1, csc1, cv1, nw1, limit, min_score, pct)
            out["postings_scanned"] = total
            out["truncated"] = jnp.logical_or(trunc, over)
            return out

        return jax.vmap(select_query)(cd, co, csc, c_valid, newest, limits, min_scores, pcts, totals, overs)

    # Small-budget matrix path: every query's postings fit P_SMALL (the
    # overwhelmingly common serving case — a ~120-hash fingerprint query
    # touches ~125 postings), so stages 3-7 run entirely SORT-FREE for any
    # segment mix (see _score_matrix / _final_select_matrix), with no
    # candidate cap.  Mention lookups still self-skip at runtime when at
    # most one segment mentions docs (_batch_newest's lax.cond), making
    # the fully-merged steady state cheaper still.
    def matrix_path(use_mem):
        def branch(_):
            def score_one(f_lo1, f_cnt1, m_lo1, m_cnt1, min_score):
                d, o, inv, total, over = _plan_and_gather(
                    p_small, file_tier, mem_tier, f_lo1, f_cnt1, m_lo1, m_cnt1, use_mem=use_mem
                )
                win, score, cand = _score_matrix(p_small, d, o, inv, min_score)
                return d, win, score, cand, total, over

            d, win, score, cand, totals, overs = jax.vmap(score_one)(
                f_lo, f_cnt, m_lo, m_cnt, min_scores
            )
            newest = _batch_newest(mem_tier, d.reshape(-1), cand.reshape(-1)).reshape(d.shape)

            def select_one(d1, win1, score1, cand1, nw1, limit, min_score, pct, total, over):
                out = _final_select_matrix(p, d1, score1, win1, cand1, nw1, limit, min_score, pct)
                out["postings_scanned"] = total
                out["truncated"] = jnp.logical_or(trunc, over)
                return out

            return jax.vmap(select_one)(
                d, win, score, cand, newest, limits, min_scores, pcts, totals, overs
            )

        return branch

    def base_path(_):
        """The pre-existing cascade: small-budget matrix path when every
        query fits P_SMALL, else the full-budget sort path."""
        if not small_ok:
            return sort_path(None)
        return jax.lax.cond(
            small,
            lambda _: jax.lax.cond(has_mem, matrix_path(True), matrix_path(False), None),
            sort_path,
            None,
        )

    if emit_info is not None:
        # Direct path: gather-free FILE-tier candidates straight from the
        # emitted landing-block rows (see _direct_candidates).  Pack-time
        # filtering makes file ordinals structurally 0 for ANY slot count,
        # so the path engages whenever every query's fallback remainder
        # fits F_DIRECT — including the write-heavy multi-checkpoint state;
        # memory-tier postings ride along through a tiny-budget gather
        # (P_MEM_DIRECT) that self-skips when the tier is empty.
        rows, covered = emit_info
        E_direct = 2 if p.query_len <= 128 else 1
        ov_tot = jnp.sum(
            jnp.maximum(f_cnt - jnp.where(covered, E_direct, 0), 0), axis=1
        )
        m_tot = jnp.sum(m_cnt, axis=1)
        direct_ok = jnp.logical_and(
            jnp.max(ov_tot) <= F_DIRECT, jnp.max(m_tot) <= P_MEM_DIRECT
        )

        # _direct_candidates runs UNCONDITIONALLY, outside the lax.cond, so
        # the emitted `rows` never cross a conditional boundary as a branch
        # operand; the non-direct case pays only the lane select and a tiny
        # gather.
        d_f, inv_f, totals_f = _direct_candidates(
            p, file_tier, rows, covered, f_lo, f_cnt, E_direct
        )

        def direct_path(_):
            import dataclasses

            p_mem = dataclasses.replace(p, postings_budget=P_MEM_DIRECT)

            def run_select(d, o, inv, totals):
                """Stages 3-7 on a candidate stream of EITHER width — the
                matrix cost scales with the static width the caller chose."""
                win, score, cand = jax.vmap(
                    lambda d1, o1, i1, ms: _score_matrix(p, d1, o1, i1, ms)
                )(d, o, inv, min_scores)
                newest = _batch_newest(mem_tier, d.reshape(-1), cand.reshape(-1)).reshape(d.shape)

                def select_one(d1, win1, score1, cand1, nw1, limit, min_score, pct, total, tr):
                    out = _final_select_matrix(p, d1, score1, win1, cand1, nw1, limit, min_score, pct)
                    out["postings_scanned"] = total
                    out["truncated"] = tr
                    return out

                return jax.vmap(select_one)(
                    d, win, score, cand, newest, limits, min_scores, pcts,
                    totals, jnp.broadcast_to(trunc, (B,)),
                )

            def wide(_):
                # Mem-live batch: gather the memory-tier postings (this
                # branch is only selected when has_mem, so the gather is
                # unconditional here) and score the concatenated stream.
                def one(f_lo1, m_lo1, m_cnt1):
                    dm, _om, im, tot, _over = _plan_and_gather(
                        p_mem, file_tier, mem_tier, f_lo1, jnp.zeros_like(m_cnt1),
                        m_lo1, m_cnt1, use_mem=True, use_file=False,
                    )
                    return dm, im, tot

                d_m, inv_m, totals_m = jax.vmap(one)(f_lo, m_lo, m_cnt)
                d = jnp.concatenate([d_f, d_m], axis=1)
                inv = jnp.concatenate([inv_f, inv_m], axis=1)
                o = jnp.concatenate(
                    [
                        jnp.zeros(d_f.shape, jnp.int32),
                        jnp.full(d_m.shape, TIER_MEM, jnp.int32),
                    ],
                    axis=1,
                )
                return run_select(d, o, inv, totals_f + totals_m)

            def narrow(_):
                # Mem-quiet batch (no queried hash holds a memory-tier
                # posting — the dominant case in the write-heavy serving
                # state): the P_MEM_DIRECT columns would be pure sentinels,
                # so score the file-only stream at its native width.  The
                # (W, W) matrix stages scale quadratically with width, so
                # skipping the 64 dead columns is the difference between
                # (E*Q+F)^2 and (E*Q+F+64)^2.  Supersession still
                # runs: _batch_newest on the file-only stream (its
                # mention-range gate usually skips the lookup too).
                return run_select(
                    d_f, jnp.zeros(d_f.shape, jnp.int32), inv_f, totals_f
                )

            return jax.lax.cond(has_mem, wide, narrow, None)

        res = jax.lax.cond(direct_ok, direct_path, base_path, None)
        res["max_per_hash"] = max_per_hash
        res["max_blocks_per_hash"] = max_blocks_per_hash
        return res

    res = base_path(None)
    res["max_per_hash"] = max_per_hash
    res["max_blocks_per_hash"] = max_blocks_per_hash
    return res


@functools.partial(jax.jit, static_argnums=0)
def search_segments(params: SearchParams, file_tier, mem_tier, query, q_len, limit, min_score, pct):
    """Single-query search over a two-tier packed segment view."""
    out = _search_batch_impl(
        params,
        file_tier,
        mem_tier,
        query[None, :],
        jnp.asarray(q_len).reshape(1),
        jnp.asarray(limit).reshape(1),
        jnp.asarray(min_score).reshape(1),
        jnp.asarray(pct).reshape(1),
    )
    return {k: v[0] for k, v in out.items()}


def _search_one(p: SearchParams, file_tier, mem_tier, query, q_len, limit, min_score, pct):
    """Unjitted single-query form (driver entry / embedding use)."""
    out = _search_batch_impl(
        p,
        file_tier,
        mem_tier,
        query[None, :],
        jnp.asarray(q_len).reshape(1),
        jnp.asarray(limit).reshape(1),
        jnp.asarray(min_score).reshape(1),
        jnp.asarray(pct).reshape(1),
    )
    return {k: v[0] for k, v in out.items()}


@functools.partial(jax.jit, static_argnums=0)
def search_segments_batch(params: SearchParams, file_tier, mem_tier, query, q_len, limit, min_score, pct):
    """Batched search: query/q_len/limit/min_score/pct carry a leading batch
    dimension; the tables are shared.  The serving path batches concurrent
    searches into one device program."""
    return _search_batch_impl(params, file_tier, mem_tier, query, q_len, limit, min_score, pct)


def pack_outputs(out) -> jax.Array:
    """Flatten the per-query output dict into ONE u32 array of shape
    (B, 2*out_len + 5): ids | scores | count | postings_scanned | truncated
    | max_per_hash | max_blocks_per_hash.  Every device->host array transfer
    costs a dispatch and a copy; one packed array per batch instead of seven
    cuts the serving sync cost accordingly."""
    return jnp.concatenate(
        [
            out["ids"].astype(jnp.uint32),
            out["scores"].astype(jnp.uint32),
            out["count"].astype(jnp.uint32)[:, None],
            out["postings_scanned"].astype(jnp.uint32)[:, None],
            out["truncated"].astype(jnp.uint32)[:, None],
            out["max_per_hash"].astype(jnp.uint32)[:, None],
            out["max_blocks_per_hash"].astype(jnp.uint32)[:, None],
        ],
        axis=1,
    )


def unpack_outputs_np(arr, out_len: int):
    """Host-side inverse of pack_outputs (arr is a numpy (B, 2*out_len+5))."""
    return {
        "ids": arr[:, :out_len],
        "scores": arr[:, out_len : 2 * out_len],
        "count": arr[:, 2 * out_len],
        "postings_scanned": arr[:, 2 * out_len + 1],
        "truncated": arr[:, 2 * out_len + 2],
        "max_per_hash": arr[:, 2 * out_len + 3],
        "max_blocks_per_hash": arr[:, 2 * out_len + 4],
    }


@functools.partial(jax.jit, static_argnums=0)
def search_segments_batch_packed(params: SearchParams, file_tier, mem_tier, query, q_len, limit, min_score, pct):
    """Batched search with the outputs packed into one u32 array."""
    return pack_outputs(
        _search_batch_impl(params, file_tier, mem_tier, query, q_len, limit, min_score, pct)
    )


def pack_inputs_np(qs, lens, limits, min_scores, pcts):
    """Host-side: one (B, Q+4) u32 array = queries | len | limit | min_score
    | pct.  Each host->device array costs a transfer of its own, exactly like
    the outputs; one packed operand per batch instead of five cuts the
    dispatch cost the same way pack_outputs cuts the fetch."""
    import numpy as np

    return np.concatenate(
        [
            qs,
            lens[:, None].astype(np.uint32),
            limits[:, None].astype(np.uint32),
            min_scores[:, None].astype(np.uint32),
            pcts[:, None].astype(np.uint32),
        ],
        axis=1,
    )


@functools.partial(jax.jit, static_argnums=0)
def search_segments_batch_packed_io(params: SearchParams, file_tier, mem_tier, packed_in):
    """Batched search with BOTH sides packed: one u32 input array (see
    pack_inputs_np), one u32 output array (see pack_outputs)."""
    Q = params.query_len
    qs = packed_in[:, :Q]
    lens = packed_in[:, Q].astype(jnp.int32)
    limits = packed_in[:, Q + 1].astype(jnp.int32)
    min_scores = packed_in[:, Q + 2].astype(jnp.int32)
    pcts = packed_in[:, Q + 3].astype(jnp.int32)
    return pack_outputs(
        _search_batch_impl(params, file_tier, mem_tier, qs, lens, limits, min_scores, pcts)
    )


def make_search_fn(params: SearchParams, batch: bool = False):
    """A search callable bound to static `params`.  Compiled programs are
    cached process-wide (keyed on params + input shapes), so constructing
    many callers never recompiles."""
    base = search_segments_batch if batch else search_segments
    return functools.partial(base, params)
