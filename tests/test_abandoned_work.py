"""Abandoned-work bounding in the batching pipeline.

The reference cancels a RUNNING scan at per-hash yield points when the
search timeout fires (/root/reference/src/MultiIndex.zig:311-316,
FileSegment.zig:167-169 via zio.maybeYield).  Our scan is one bounded
device launch, so the last cancellation point is just before dispatch:
requests whose absolute deadline passed while queued or claimed are
resolved as timeouts without spending device time, and a batch whose every
member expired skips its launch entirely (engine/searcher.py
_purge_expired).
"""

import time

import numpy as np
import pytest

from acoustid_index.engine.errors import SearchTimeout
from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Insert, SearchOptions, SegmentInfo
from acoustid_index.engine.searcher import BatchingSearcher, _PendingSearch
from acoustid_index.engine.segments import (
    FILE_SLOTS,
    MEMORY_SLOTS,
    Snapshot,
    pack_tier,
)


def make_snapshot():
    seg = build_segment(
        [Insert(id=i, hashes=[i, i + 1, i + 2]) for i in range(1, 50)],
        SegmentInfo(commit_id=1),
    )
    empty = build_segment([], SegmentInfo(commit_id=2))
    return Snapshot(
        file=(seg,),
        memory=(empty,),
        file_view=pack_tier([seg], FILE_SLOTS),
        mem_view=pack_tier([empty], MEMORY_SLOTS),
    )


class StubLaunchSearcher(BatchingSearcher):
    """Counts launches; the FIRST launch stalls (a cold-compile stand-in)
    so later submissions expire while the dispatcher is busy."""

    def __init__(self, first_launch_stall: float):
        super().__init__()
        self.launches = []
        self._stall = first_launch_stall

    def _launch(self, snapshot, params, packed_in):
        self.launches.append(packed_in.shape)
        if len(self.launches) == 1 and self._stall:
            time.sleep(self._stall)
        return np.zeros((packed_in.shape[0], 2 * params.out_len + 5), np.uint32)


def test_purge_expired_resolves_and_counts():
    s = BatchingSearcher()
    now = time.monotonic()
    reqs = [
        _PendingSearch(s, None, None, None, 3, SearchOptions(), deadline)
        for deadline in (now - 1.0, now + 60.0, None, now - 0.1)
    ]
    for r in reqs:
        r.state = _PendingSearch.CLAIMED
    live = s._purge_expired(reqs)
    assert live == [reqs[1], reqs[2]]
    assert s.abandoned_prelaunch == 2
    for r in (reqs[0], reqs[3]):
        assert r.done.is_set() and isinstance(r.error, SearchTimeout)
        assert r.state == _PendingSearch.ABANDONED


def test_fully_expired_batch_skips_device_launch():
    snap = make_snapshot()
    s = StubLaunchSearcher(first_launch_stall=1.0)
    try:
        # Request A (its own batch group) occupies the dispatcher inside a
        # slow launch; B..E expire meanwhile and must never be launched.
        a = s.submit(snap, [1, 2, 3], SearchOptions(max_results=10), deadline=None)
        deadline = time.monotonic() + 0.2
        expired = [
            s.submit(
                snap,
                [4, 5, 6],
                SearchOptions(max_results=500),  # out bucket 512: not A's group
                deadline=deadline,
            )
            for _ in range(4)
        ]
        a.result()  # A served normally (canned rows -> empty results)
        for r in expired:
            with pytest.raises(SearchTimeout):
                r.result()
        # Give the dispatcher a moment to process the expired group.
        t_end = time.monotonic() + 5.0
        while s.launches_skipped == 0 and time.monotonic() < t_end:
            time.sleep(0.01)
        assert len(s.launches) == 1, "expired batch must not reach the device"
        assert s.launches_skipped >= 1
        assert s.abandoned_prelaunch == 4
    finally:
        s.close()
