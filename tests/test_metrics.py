"""Prometheus exposition validity.

The reference records histograms through a vetted library
(/root/reference/src/metrics.zig); ours is hand-rolled, so these tests pin
the histogram invariants Prometheus requires: cumulative le-buckets are
monotone non-decreasing, every bucket count is <= the +Inf count, and
+Inf equals _count.  (Round 3 regression: per-bucket counts were stored
cumulatively AND re-accumulated at render time, inflating every bucket
past _count.)
"""

import re

from acoustid_index.server import metrics


def setup_function(_):
    metrics.reset()


def _histogram_series(text, name):
    buckets = []
    inf = count = total_sum = None
    for line in text.splitlines():
        if line.startswith(f"{name}_bucket"):
            m = re.search(r'le="([^"]+)"\} (\S+)', line)
            if m.group(1) == "+Inf":
                inf = int(m.group(2))
            else:
                buckets.append((float(m.group(1)), int(m.group(2))))
        elif line.startswith(f"{name}_count"):
            count = int(line.split()[-1])
        elif line.startswith(f"{name}_sum"):
            total_sum = float(line.split()[-1])
    return buckets, inf, count, total_sum


def _assert_valid(text, name, want_count, want_sum=None):
    buckets, inf, count, total_sum = _histogram_series(text, name)
    assert inf == count == want_count, (name, inf, count, want_count)
    cum = [c for _, c in buckets]
    assert cum == sorted(cum), f"{name}: non-monotone buckets {cum}"
    assert all(c <= inf for c in cum), f"{name}: bucket > +Inf ({cum} vs {inf})"
    if want_sum is not None:
        assert abs(total_sum - want_sum) < 1e-9


def test_scalar_observe_is_valid_histogram():
    metrics.observe_max_postings_per_hash(3)
    text = metrics.render()
    _assert_valid(text, "aitpu_scanned_postings_per_hash", 1, want_sum=3.0)
    # The single observation lands in exactly one cumulative step.
    buckets, _, _, _ = _histogram_series(text, "aitpu_scanned_postings_per_hash")
    assert [c for b, c in buckets if b >= 3] == [1] * sum(1 for b, _ in buckets if b >= 3)
    assert all(c == 0 for b, c in buckets if b < 3)


def test_bulk_observe_matches_scalar():
    metrics.observe_max_postings_per_hash_many([1, 5, 7, 5000, 10**9])
    bulk = metrics.render()
    metrics.reset()
    for v in (1, 5, 7, 5000, 10**9):
        metrics.observe_max_postings_per_hash(v)
    scalar = metrics.render()
    name = "aitpu_scanned_postings_per_hash"
    assert _histogram_series(bulk, name) == _histogram_series(scalar, name)
    _assert_valid(bulk, name, 5)


def test_postings_scanned_bulk_valid():
    metrics.observe_postings_scanned_many([0, 50, 2_000_000])
    metrics.observe_postings_scanned(10)
    _assert_valid(metrics.render(), "aitpu_postings_scanned", 4)


def test_search_seconds_batch_observation():
    # A native-front batch: every request shares the batch's wall time.
    metrics.observe_search_seconds("idx", 0.025, n=256)
    metrics.observe_search_seconds("idx", 0.002)
    text = metrics.render()
    name = 'aitpu_search_seconds'
    # Per-index series: rewrite the labeled lines to a parseable form.
    text = text.replace('{index="idx",le=', "{le=").replace('{index="idx"}', "")
    _assert_valid(text, name, 257, want_sum=0.025 * 256 + 0.002)
    buckets, _, _, _ = _histogram_series(text, name)
    by_le = dict(buckets)
    assert by_le[0.05] == 257 and by_le[0.01] == 1  # 25ms not understated


def test_scanned_blocks_per_hash_series():
    # The reference exports both scanned docs AND blocks per hash
    # (metrics.zig:96-101); pin the blocks series' validity + bulk parity.
    metrics.observe_scanned_blocks_per_hash(2)
    metrics.observe_scanned_blocks_per_hash_many([1, 1, 3, 12])
    text = metrics.render()
    name = "aitpu_scanned_blocks_per_hash"
    _assert_valid(text, name, 5, want_sum=19.0)
    buckets, _, _, _ = _histogram_series(text, name)
    by_le = dict(buckets)
    assert by_le[1] == 2 and by_le[2] == 3 and by_le[3] == 4 and by_le[10] == 4


def test_search_stats_carry_blocks_per_hash():
    # End-to-end through the real searcher: a multi-block run must report
    # blocks >= 2 while a within-block run reports 1.
    import numpy as np

    from acoustid_index.engine.memseg import build_segment
    from acoustid_index.engine.model import Insert, SearchOptions, SegmentInfo
    from acoustid_index.engine.searcher import Searcher
    from acoustid_index.engine.segments import FILE_SLOTS, MEMORY_SLOTS, Snapshot, pack_tier
    from acoustid_index.ops.block_lookup import BLOCK

    # hash 5's run fills positions [0, 600); the hot hash's 600-posting run
    # then straddles the first BLOCK boundary -> 2 blocks scanned.
    hot = 7
    changes = [Insert(id=i, hashes=[5]) for i in range(1, 601)]
    changes += [Insert(id=i, hashes=[hot]) for i in range(601, 1201)]
    changes.append(Insert(id=BLOCK + 200, hashes=[99]))
    seg = build_segment(changes, SegmentInfo(commit_id=1))
    empty = build_segment([], SegmentInfo(commit_id=2))
    snap = Snapshot(
        file=(seg,),
        memory=(empty,),
        file_view=pack_tier([seg], FILE_SLOTS),
        mem_view=pack_tier([empty], MEMORY_SLOTS),
    )
    s = Searcher()
    _, stats = s.search(snap, [hot], SearchOptions(max_results=10, min_score=1))
    assert stats.max_blocks_per_hash >= 2, stats
    _, stats1 = s.search(snap, [99], SearchOptions(max_results=10, min_score=1))
    assert stats1.max_blocks_per_hash == 1, stats1
