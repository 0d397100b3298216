"""Device search kernel vs. the reference-semantics oracle."""

import numpy as np
import pytest

from acoustid_index.engine.memseg import Segment, build_segment
from acoustid_index.engine.model import Delete, Insert, SegmentInfo, SearchOptions
from acoustid_index.engine.searcher import Searcher
from acoustid_index.engine.segments import Snapshot, pack_tier, FILE_SLOTS, MEMORY_SLOTS

from oracle import OracleSegment, oracle_search


def seg_from_docs(docs, commit_id, deletes=()):
    """docs: dict[id -> list of hashes]; deletes: ids tombstoned here."""
    changes = [Insert(id=i, hashes=h) for i, h in docs.items()]
    changes += [Delete(id=i) for i in deletes]
    return build_segment(changes, SegmentInfo(commit_id=commit_id))


def to_oracle(seg):
    items = list(zip(seg.hashes.tolist(), seg.docids.tolist()))
    docs = dict(zip(seg.docs_ids.tolist(), seg.docs_alive.tolist()))
    return OracleSegment(items, docs)


def make_snapshot(file_segs, mem_segs):
    return Snapshot(
        file=tuple(file_segs),
        memory=tuple(mem_segs),
        file_view=pack_tier(file_segs, FILE_SLOTS),
        mem_view=pack_tier(mem_segs, MEMORY_SLOTS),
    )


def run_both(file_segs, mem_segs, query, limit=10, min_score=1, pct=10):
    searcher = Searcher()
    snap = make_snapshot(file_segs, mem_segs)
    got, _ = searcher.search(
        snap, query, SearchOptions(max_results=limit, min_score=min_score, min_score_pct=pct)
    )
    got = [(r.id, r.score) for r in got]
    # Oracle ordinal space: file slots 0..FILE_SLOTS-1 then memory; empty
    # trailing slots never mention docs so plain concatenation is equivalent.
    want = oracle_search(
        [to_oracle(s) for s in file_segs] + [to_oracle(s) for s in mem_segs],
        query,
        limit=limit,
        min_score=min_score,
        pct=pct,
    )
    assert got == want, f"query={query}\n got={got}\nwant={want}"
    return got


def test_single_segment_intersection():
    seg = seg_from_docs({1: [10, 20, 30], 2: [20, 30, 40], 3: [99]}, commit_id=1)
    res = run_both([], [seg], [20, 30, 40])
    assert res[0] == (2, 3)
    assert (1, 2) in res


def test_duplicate_hashes_in_doc_count_twice():
    # MemorySegment.build keeps duplicate hashes; each posting scores one hit.
    seg = seg_from_docs({7: [5, 5, 5]}, commit_id=1)
    res = run_both([], [seg], [5], min_score=1)
    assert res == [(7, 3)]


def test_duplicate_query_hashes_count_once():
    seg = seg_from_docs({7: [5, 6]}, commit_id=1)
    res = run_both([], [seg], [5, 5, 5, 6], min_score=1)
    assert res == [(7, 2)]


def test_newer_segment_wins_score():
    old = seg_from_docs({1: [10, 20, 30]}, commit_id=1)
    new = seg_from_docs({1: [10]}, commit_id=2)
    # Doc 1 re-inserted with fewer hashes: only the new version scores.
    res = run_both([], [old, new], [10, 20, 30], min_score=1)
    assert res == [(1, 1)]


def test_tombstone_suppresses_older_hits():
    old = seg_from_docs({1: [10, 20], 2: [10, 20]}, commit_id=1)
    tomb = seg_from_docs({}, commit_id=2, deletes=[1])
    res = run_both([], [old, tomb], [10, 20], min_score=1)
    assert res == [(2, 2)]


def test_file_and_memory_tiers_combine():
    f1 = seg_from_docs({1: [10, 20], 2: [30]}, commit_id=1)
    f2 = seg_from_docs({3: [10, 40]}, commit_id=2)
    m1 = seg_from_docs({2: [10, 20, 40]}, commit_id=3)
    run_both([f1, f2], [m1], [10, 20, 30, 40], min_score=1)


def test_mem_mention_kills_file_candidate_without_hash_overlap():
    # The memory-tier update shares NO hash with the query, so the batch's
    # mem-side gathers are skipped (m_cnt all zero — the "mem live for this
    # batch" gate), but the mention-range gate must still let supersession
    # kill the file-tier candidate.
    f = seg_from_docs({1: [10, 20], 2: [10, 30]}, commit_id=1)
    m = seg_from_docs({1: [99]}, commit_id=2)
    res = run_both([f], [m], [10, 20, 30], min_score=1, pct=0)
    assert res == [(2, 2)]


def test_mem_delete_only_segment_kills_file_candidate():
    # A delete-only memory segment holds zero postings (the old
    # tier-nonempty gate would read it as "no memory tier") yet must still
    # supersede the file-tier candidate through the mention table.
    f = seg_from_docs({1: [10, 20], 2: [10, 30]}, commit_id=1)
    m = seg_from_docs({}, commit_id=2, deletes=[1])
    res = run_both([f], [m], [10, 20, 30], min_score=1, pct=0)
    assert res == [(2, 2)]


def test_min_score_filters():
    seg = seg_from_docs({1: [10], 2: [10, 20], 3: [10, 20, 30]}, commit_id=1)
    res = run_both([], [seg], [10, 20, 30], min_score=2, pct=0)
    assert res == [(3, 3), (2, 2)]


def test_score_pct_anchors_on_best_survivor():
    # Best raw scorer is superseded; the pct anchor must use the survivor.
    old = seg_from_docs({1: [10, 20, 30, 40, 50], 2: [10, 20]}, commit_id=1)
    newer = seg_from_docs({1: [99]}, commit_id=2)
    res = run_both([], [old, newer], [10, 20, 30, 40, 50], min_score=1, pct=60)
    # Survivors: doc 2 (score 2, anchor -> cutoff max(1, 2*60//100)=1).
    assert res[0] == (2, 2)


def test_limit_and_tiebreak_by_id():
    seg = seg_from_docs({i: [10] for i in range(1, 20)}, commit_id=1)
    res = run_both([], [seg], [10], limit=5, min_score=1, pct=0)
    assert res == [(i, 1) for i in range(1, 6)]


def test_empty_query_and_empty_index():
    searcher = Searcher()
    snap = make_snapshot([], [])
    got, _ = searcher.search(snap, [], SearchOptions())
    assert got == []
    got, _ = searcher.search(snap, [1, 2, 3], SearchOptions())
    assert got == []


def test_sentinel_hash_value_is_searchable():
    seg = seg_from_docs({1: [0xFFFFFFFF, 5]}, commit_id=1)
    res = run_both([], [seg], [0xFFFFFFFF, 5], min_score=1)
    assert res == [(1, 2)]


@pytest.mark.parametrize("seed", range(6))
def test_randomized_parity(seed):
    rng = np.random.default_rng(seed)
    n_file = int(rng.integers(0, 4))
    n_mem = int(rng.integers(0, 5))
    if n_file + n_mem == 0:
        n_mem = 1
    hash_space = 60  # small space -> heavy collisions, duplicates, supersession
    id_space = 40
    commit = 1
    file_segs, mem_segs = [], []
    for out, n in ((file_segs, n_file), (mem_segs, n_mem)):
        for _ in range(n):
            docs = {}
            for _ in range(int(rng.integers(1, 12))):
                did = int(rng.integers(1, id_space))
                docs[did] = [int(h) for h in rng.integers(0, hash_space, rng.integers(1, 10))]
            deletes = [int(d) for d in rng.integers(1, id_space, rng.integers(0, 3))]
            deletes = [d for d in deletes if d not in docs]
            out.append(seg_from_docs(docs, commit_id=commit, deletes=deletes))
            commit += 1
    for _ in range(8):
        qlen = int(rng.integers(1, 15))
        query = [int(h) for h in rng.integers(0, hash_space, qlen)]
        limit = int(rng.integers(1, 8))
        min_score = int(rng.integers(0, 3))
        pct = int(rng.choice([0, 10, 50, 90]))
        run_both(file_segs, mem_segs, query, limit=limit, min_score=min_score, pct=pct)


def test_uniform_fast_path_matches_sort_path():
    """The sort-free uniform-ordinal branch (exactly one live segment) and
    the sort branch (several segments) must agree: split the same corpus
    into two disjoint segments — scoring semantics don't depend on
    segmentation when nothing supersedes — and compare result lists."""
    rng = np.random.default_rng(42)
    docs = {
        i: [int(h) for h in rng.integers(0, 50, rng.integers(2, 9))] for i in range(1, 30)
    }
    one = [seg_from_docs(docs, commit_id=1)]
    half = {i: h for i, h in docs.items() if i < 15}
    rest = {i: h for i, h in docs.items() if i >= 15}
    two = [seg_from_docs(half, commit_id=1), seg_from_docs(rest, commit_id=2)]
    for _ in range(12):
        q = [int(h) for h in rng.integers(0, 50, rng.integers(2, 12))]
        pct = int(rng.choice([0, 10, 80]))
        r1 = run_both([], one, q, limit=7, min_score=1, pct=pct)
        r2 = run_both(two, [], q, limit=7, min_score=1, pct=pct)
        assert r1 == r2, (q, r1, r2)


def test_big_budget_sort_path_matches_oracle():
    """A hot hash with > P_SMALL postings forces the full-budget sorting
    pipeline (the matrix path only serves small batches); pin it to the
    oracle, with supersession across segments in play."""
    rng = np.random.default_rng(7)
    hot = 999
    docs_a = {i: [hot, int(rng.integers(0, 400))] for i in range(1, 350)}
    docs_b = {i: [int(h) for h in rng.integers(0, 400, 4)] for i in range(340, 360)}
    segs_file = [seg_from_docs(docs_a, commit_id=1)]
    segs_mem = [seg_from_docs(docs_b, commit_id=2, deletes=[5, 17])]
    for q in ([hot, 42, 43], [hot], [hot, 0, 1, 2, 3]):
        run_both(segs_file, segs_mem, q, limit=8, min_score=1, pct=0)


def test_hot_hash_degenerate_skew():
    """A 10^5-posting hot hash in one segment (the skew case SURVEY §7 calls
    out).  The reference pins <=4 blocks / <=1000 docs scanned per query
    hash (FileSegment.zig:25-26,171-174).  Our documented bound differs in
    anchor but not in shape: the range phase scans a 2-chunk window at the
    run's upper landing chunk, capped at K postings per (hash, segment)
    (ops/block_lookup.py tier_ranges_blocked, searcher._params_for), so a
    degenerate hash yields a CONTIGUOUS docid-ascending slice of its run,
    `truncated` is set, max_per_hash reports the cap (feeding the load-skew
    histogram, multi/multi_index.py:181), and every other hash in the query
    still scores exactly."""
    from acoustid_index.engine.searcher import _params_for

    n_hot = 100_000
    hot = 4_000_000_000  # larger than the decoy hashes: its run sorts last
    a, b, c = 10, 20, 30
    docs = {i: [hot] for i in range(1, n_hot + 1)}
    docs[50] = [hot, a, b, c]
    seg = seg_from_docs(docs, commit_id=1)
    empty = seg_from_docs({}, commit_id=2)
    searcher = Searcher()
    snap = make_snapshot([seg], [empty])
    K = _params_for(64).per_hash_cap

    # Postings sort as (hash, docid): positions 0-2 are doc 50's (a, b, c),
    # the hot run occupies positions 3..n_hot+2 with docids 1..n_hot.  The
    # K-capped window lands at the run's tail chunks; doc 50's hot hit
    # (position 52) is outside it, so its exact score is 3 (a+b+c).
    got, stats = searcher.search(
        snap, [hot, a, b, c], SearchOptions(max_results=10, min_score=2)
    )
    assert stats.truncated, "capped hot-hash scan must surface truncation"
    assert stats.max_per_hash == K, stats
    assert [(r.id, r.score) for r in got] == [(50, 3)]

    # min_score=1: survivors below the bound are a contiguous slice of the
    # run, docid-ascending, score 1 each — window chunk start 96*1024 =
    # position 98304 = docid 98302 (the postings budget P trims the slice's
    # tail, not its head).
    got1, stats1 = searcher.search(
        snap, [hot, a, b, c], SearchOptions(max_results=5, min_score=1, min_score_pct=0)
    )
    assert stats1.truncated
    assert [(r.id, r.score) for r in got1] == [
        (50, 3), (98302, 1), (98303, 1), (98304, 1), (98305, 1),
    ]

    # A hot-hash-only query returns the window slice head directly.
    got2, _ = searcher.search(snap, [hot], SearchOptions(max_results=3, min_score=1, min_score_pct=0))
    assert [(r.id, r.score) for r in got2] == [(98302, 1), (98303, 1), (98304, 1)]
