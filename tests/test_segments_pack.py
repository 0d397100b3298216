

def test_bucket_half_octave_steps():
    from acoustid_index.engine.segments import _bucket

    assert _bucket(1, 1024) == 1024
    assert _bucket(1024, 1024) == 1024
    assert _bucket(1025, 1024) == 2048  # 1536 not a multiple of 1024
    assert _bucket(2049, 1024) == 3072  # first half step
    assert _bucket(3073, 1024) == 4096
    assert _bucket(5000, 1024) == 6144
    assert _bucket(7000, 1024) == 8192
    for n in (10_000, 100_000, 5_000_000, 1_200_000_000):
        cap = _bucket(n, 1024)
        assert cap >= n and cap % 1024 == 0
        assert cap <= n * 2  # never more than 2x waste


def _seg(commit_id, docs):
    """docs: list of (id, hashes, alive)."""
    import numpy as np

    from acoustid_index.engine.memseg import build_segment
    from acoustid_index.engine.model import Delete, Insert, SegmentInfo

    changes = []
    for i, hs, alive in docs:
        changes.append(Insert(id=i, hashes=hs) if alive else Delete(id=i))
    return build_segment(changes, SegmentInfo(commit_id=commit_id))


def test_pack_tier_filters_within_tier_supersession():
    """The packed comb drops postings whose doc a NEWER segment of the same
    tier mentions (reinsert or tombstone): the kernel-side analogue of the
    reference's hasNewerCommit drop (Index.zig:133-149) moved to pack time.
    Each doc's surviving postings therefore live in exactly one segment, so
    no ordinal column exists."""
    import numpy as np

    from acoustid_index.engine.segments import FILE_SLOTS, pack_tier

    s1 = _seg(1, [(5, [10, 11], True), (6, [20], True), (7, [30, 31], True)])
    s2 = _seg(2, [(5, [12], True), (8, [40], True)])  # reinsert 5
    s3 = _seg(3, [(7, [], False)])  # tombstone 7

    view = pack_tier([s1, s2, s3], FILE_SLOTS)
    assert "ord" not in view
    n = int(np.sum(np.asarray(view["seg_len"])))
    hashes = np.asarray(view["hashes"][:n] if "hashes" in view else [])
    docids = np.asarray(view["docids"][:n])
    pairs = sorted(zip(hashes.tolist(), docids.tolist()))
    # doc 5's old postings (10, 11) and doc 7's (30, 31) are gone;
    # doc 6 (untouched), doc 5's reinsert, doc 8 survive.
    assert pairs == [(12, 5), (20, 6), (40, 8)]
    # seg_len reflects surviving counts per slot.
    assert np.asarray(view["seg_len"])[:3].tolist() == [1, 2, 0]
    # Mentions stay membership-complete (all mentioned docs, incl. tombstone).
    m = int(view["mention_len"])
    assert sorted(np.asarray(view["mention_ids"][:m]).tolist()) == [5, 6, 7, 8]


def test_pack_tier_filter_skips_disjoint_segments():
    """Doc-range-disjoint segments skip the filter entirely (the common
    append-only ingest shape) and keep every posting."""
    import numpy as np

    from acoustid_index.engine.segments import FILE_SLOTS, pack_tier

    s1 = _seg(1, [(1, [10], True), (2, [11], True)])
    s2 = _seg(2, [(10, [12], True)])
    view = pack_tier([s1, s2], FILE_SLOTS)
    assert np.asarray(view["seg_len"])[:2].tolist() == [2, 1]


def test_search_across_filtered_tiers():
    """End-to-end semantics over a filtered pack: memory-tier reinsert and
    tombstone supersede file-tier docs via the membership test."""
    from acoustid_index.engine.model import SearchOptions
    from acoustid_index.engine.searcher import Searcher
    from acoustid_index.engine.segments import (
        FILE_SLOTS,
        MEMORY_SLOTS,
        Snapshot,
        pack_tier,
    )

    f1 = _seg(1, [(1, [100, 101, 102], True), (2, [200, 201], True)])
    f2 = _seg(2, [(3, [100, 101], True)])
    m1 = _seg(3, [(1, [100, 300], True)])   # reinsert doc 1 (new hashes)
    m2 = _seg(4, [(2, [], False)])          # tombstone doc 2

    snap = Snapshot(
        file=(f1, f2), memory=(m1, m2),
        file_view=pack_tier([f1, f2], FILE_SLOTS),
        mem_view=pack_tier([m1, m2], MEMORY_SLOTS),
    )
    s = Searcher()
    opts = SearchOptions(max_results=10, min_score=1, min_score_pct=0)
    res, _ = s.search(snap, [100, 101, 102, 200, 201, 300], opts)
    got = {r.id: r.score for r in res}
    # doc 1: memory version wins -> hits on {100, 300} = 2 (not 3).
    # doc 2: tombstoned -> absent.  doc 3: file tier, hits {100, 101} = 2.
    assert got == {1: 2, 3: 2}
