"""Oracle parity through the INTERLEAVED block layout (ops/layout.py).

Large tiers pack hashes+docids interleaved at block granularity so the
landing scan finds both in one place; at CPU test sizes the layout only
engages when the resident cut is forced down, so these tests pin
layout.RESIDENT_MAX_BYTES below the table size and check:
  * pack_tier emits "inter" (and drops the plain pair),
  * search results stay bit-identical to the literal oracle, including
    multi-segment ordinals, supersession, tombstones, and hot-hash runs.
"""

import os
import sys

import numpy as np

from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Delete, Insert, SegmentInfo, SearchOptions
from acoustid_index.engine.searcher import Searcher
from acoustid_index.engine.segments import (
    FILE_SLOTS,
    MEMORY_SLOTS,
    Snapshot,
    pack_tier,
)
from acoustid_index.ops import layout
from acoustid_index.ops.layout import BLOCK, postings_cap

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import OracleSegment, oracle_search


def _force_interleave(monkeypatch):
    # 96k-posting test tables are far below the 6MB default resident cut;
    # force the blocked+interleaved path like a production table.
    monkeypatch.setattr(layout, "RESIDENT_MAX_BYTES", 64 * 1024)


def test_pack_emits_interleaved(monkeypatch):
    _force_interleave(monkeypatch)
    rng = np.random.default_rng(5)
    doc_hashes = rng.integers(0, 2**32, (3000, 24), dtype=np.uint32)
    seg = build_segment(
        [Insert(id=i + 1, hashes=doc_hashes[i].tolist()) for i in range(3000)],
        SegmentInfo(commit_id=1),
    )
    view = pack_tier([seg], FILE_SLOTS)
    assert "inter" in view and "hashes" not in view and "docids" not in view
    cap = postings_cap(view)
    assert cap >= 64 * BLOCK and view["inter"].shape[0] == 2 * cap
    # Interleave round-trip: block b's first half is the hash run.
    inter = np.asarray(view["inter"]).reshape(-1, 2, BLOCK)
    h = inter[:, 0, :].reshape(-1)[: seg.num_items]
    d = inter[:, 1, :].reshape(-1)[: seg.num_items]
    assert np.array_equal(h, np.asarray(seg.hashes))
    assert np.array_equal(d, np.asarray(seg.docids))


def test_direct_candidates_unit(monkeypatch):
    """_direct_candidates' valid docids per query are exactly the multiset
    of the ranges' postings whenever the fallback stream fits F_DIRECT —
    checked directly against numpy, including a medium-hot hash whose run
    overflows the per-hash lane budget into the fallback gather."""
    _force_interleave(monkeypatch)
    import jax.numpy as jnp
    from acoustid_index.ops.block_lookup import tier_ranges_blocked
    from acoustid_index.ops.search_kernel import F_DIRECT, _direct_candidates, SENTINEL

    rng = np.random.default_rng(11)
    n_docs = 3000
    doc_hashes = rng.integers(0, 2**32, (n_docs, 24), dtype=np.uint32)
    warm = np.uint32(0x6060_6060)  # run of 10: lanes 0-1 + 8 fallback slots
    doc_hashes[50:60, 5] = warm
    seg = build_segment(
        [Insert(id=i + 1, hashes=doc_hashes[i].tolist()) for i in range(n_docs)],
        SegmentInfo(commit_id=1),
    )
    tier = pack_tier([seg], FILE_SLOTS)
    assert "inter" in tier

    Q = 32
    B = 4
    qs = np.full((B, Q), 0xFFFFFFFF, np.uint32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        t = int(rng.integers(0, n_docs))
        row = np.concatenate([doc_hashes[t][:12], [warm]])
        qs[b, : row.shape[0]] = row
        lens[b] = row.shape[0]
    valid = np.arange(Q)[None, :] < lens[:, None]

    lo, cnt, trunc, rows, covered = tier_ranges_blocked(
        tier, jnp.asarray(qs), jnp.asarray(valid), 1024, emit=True
    )
    d, inv, totals = _direct_candidates(
        None, tier, rows, covered, lo, cnt, lanes_per_hash=2
    )
    d, inv = np.asarray(d), np.asarray(inv)
    h_sorted = np.asarray(seg.hashes)
    d_sorted = np.asarray(seg.docids)
    for b in range(B):
        want = []
        for qh in qs[b, : lens[b]]:
            lo_t = np.searchsorted(h_sorted, qh, side="left")
            hi_t = np.searchsorted(h_sorted, qh, side="right")
            want += d_sorted[lo_t:hi_t].tolist()
        got = sorted(int(x) for x, iv in zip(d[b], inv[b]) if not iv)
        assert got == sorted(want), b
        assert int(np.asarray(totals)[b]) == len(want)


def test_direct_path_matches_oracle_with_tombstones(monkeypatch):
    """End-to-end exactness through the direct (gather-free) path: ONE live
    file segment, a tombstone-only memory segment (postings-free, so the
    direct path stays engaged while its mentions still supersede), a
    medium-hot hash exercising the fallback stream, and a hot-80 hash whose
    overflow forces the lax.cond back to the plan+gather path."""
    _force_interleave(monkeypatch)
    rng = np.random.default_rng(23)
    n_docs = 3000
    doc_hashes = {
        i: rng.integers(0, 2**32, 24, dtype=np.uint32).tolist()
        for i in range(1, n_docs + 1)
    }
    warm = np.uint32(0x6060_6060)
    for i in range(50, 60):
        doc_hashes[i][5] = int(warm)
    hot = np.uint32(0x5050_5050)
    for i in range(200, 280):
        doc_hashes[i][3] = int(hot)

    f1 = build_segment(
        [Insert(id=i, hashes=doc_hashes[i]) for i in range(1, n_docs + 1)],
        SegmentInfo(commit_id=1),
    )
    del_ids = [int(i) for i in rng.choice(np.arange(1, n_docs + 1), 40, replace=False)]
    m1 = build_segment([Delete(id=i) for i in del_ids], SegmentInfo(commit_id=2))
    assert m1.num_items == 0  # tombstone-only: direct path stays engaged

    snap = Snapshot(
        file=(f1,),
        memory=(m1,),
        file_view=pack_tier([f1], FILE_SLOTS),
        mem_view=pack_tier([m1], MEMORY_SLOTS),
    )
    assert "inter" in snap.file_view

    oracle_segs = [
        OracleSegment(
            list(zip(s.hashes.tolist(), s.docids.tolist())),
            dict(zip(s.docs_ids.tolist(), s.docs_alive.tolist())),
        )
        for s in (f1, m1)
    ]
    searcher = Searcher()
    opts = SearchOptions(max_results=10, min_score=1, min_score_pct=10)
    for trial in range(8):
        t = int(rng.integers(1, n_docs + 1))
        extra = [warm] if trial % 2 == 0 else [warm, hot]  # hot => overflow
        q = np.unique(
            np.concatenate(
                [
                    np.asarray(doc_hashes[t][:15], np.uint32),
                    np.asarray(extra, np.uint32),
                    rng.integers(0, 2**32, 4, dtype=np.uint32),
                ]
            )
        )
        got, _ = searcher.search(snap, q.tolist(), opts)
        want = oracle_search(
            oracle_segs, q.tolist(), limit=opts.max_results,
            min_score=opts.min_score, pct=opts.min_score_pct,
        )
        assert [(r.id, r.score) for r in got] == want, trial


def test_interleaved_matches_oracle_multisegment(monkeypatch):
    _force_interleave(monkeypatch)
    rng = np.random.default_rng(77)
    n_docs = 3500
    doc_hashes = {
        i: rng.integers(0, 2**32, 24, dtype=np.uint32).tolist()
        for i in range(1, n_docs + 1)
    }
    # A hot hash shared by ~80 docs: exercises in-block runs (and, with the
    # merged comb layout, possible block-boundary straddles).
    hot = np.uint32(0x5050_5050)
    for i in range(100, 180):
        doc_hashes[i][3] = int(hot)

    half = n_docs // 2
    f1 = build_segment(
        [Insert(id=i, hashes=doc_hashes[i]) for i in range(1, half + 1)],
        SegmentInfo(commit_id=1),
    )
    f2 = build_segment(
        [Insert(id=i, hashes=doc_hashes[i]) for i in range(half + 1, n_docs + 1)],
        SegmentInfo(commit_id=2),
    )
    re_ids = rng.choice(np.arange(1, n_docs + 1), 50, replace=False)
    del_ids = [
        int(i)
        for i in rng.choice(np.arange(1, n_docs + 1), 30, replace=False)
        if i not in set(re_ids.tolist())
    ]
    changes = []
    for i in re_ids:
        doc_hashes[int(i)] = rng.integers(0, 2**32, 24, dtype=np.uint32).tolist()
        changes.append(Insert(id=int(i), hashes=doc_hashes[int(i)]))
    changes += [Delete(id=i) for i in del_ids]
    m1 = build_segment(changes, SegmentInfo(commit_id=3))

    snap = Snapshot(
        file=(f1, f2),
        memory=(m1,),
        file_view=pack_tier([f1, f2], FILE_SLOTS),
        mem_view=pack_tier([m1], MEMORY_SLOTS),
    )
    assert "inter" in snap.file_view  # the layout under test engages
    assert "ord" not in snap.file_view  # pack-time filtering: no ordinal column

    oracle_segs = [
        OracleSegment(
            list(zip(s.hashes.tolist(), s.docids.tolist())),
            dict(zip(s.docs_ids.tolist(), s.docs_alive.tolist())),
        )
        for s in (f1, f2, m1)
    ]

    searcher = Searcher()
    opts = SearchOptions(max_results=10, min_score=2, min_score_pct=10)
    for trial in range(8):
        t = int(rng.integers(1, n_docs + 1))
        q = np.unique(
            np.concatenate(
                [
                    np.asarray(doc_hashes[t][:15], np.uint32),
                    np.asarray([hot] if trial % 2 else [], np.uint32),
                    rng.integers(0, 2**32, 5, dtype=np.uint32),
                ]
            )
        )
        got, _ = searcher.search(snap, q.tolist(), opts)
        want = oracle_search(
            oracle_segs,
            q.tolist(),
            limit=opts.max_results,
            min_score=opts.min_score,
            pct=opts.min_score_pct,
        )
        assert [(r.id, r.score) for r in got] == want, trial
