"""Cold-query-bucket serving through a warm SUPERSET program.

The reference never fails a search on a warm index (MultiIndex.zig:287-330);
here a fresh query-length bucket's first search used to stall the
dispatcher for a full compile and 503.  Now
_pick_program pads the queries through any warm larger bucket while the
exact program compiles in the background.
"""

import numpy as np

from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Insert, SearchOptions, SegmentInfo
from acoustid_index.engine.searcher import (
    BatchingSearcher,
    _params_for,
)
from acoustid_index.engine.segments import FILE_SLOTS, MEMORY_SLOTS, Snapshot, pack_tier


def _snapshot():
    seg = build_segment(
        [Insert(id=i, hashes=[i * 7 + j for j in range(6)]) for i in range(1, 40)],
        SegmentInfo(commit_id=1),
    )
    empty = build_segment([], SegmentInfo(commit_id=2))
    return Snapshot(
        file=(seg,), memory=(empty,),
        file_view=pack_tier([seg], FILE_SLOTS),
        mem_view=pack_tier([empty], MEMORY_SLOTS),
    )


def test_cold_bucket_serves_through_warm_superset():
    snap = _snapshot()
    s = BatchingSearcher()
    launched = []
    orig_launch = s._launch

    def spy_launch(snapshot, params, packed_in):
        # Row 0's q_len field distinguishes the SERVING launch (the real
        # query, q_len=6) from the background precompiler's dummy launches
        # (q_len=1), which race into this list when the persistent XLA
        # cache makes the exact-bucket compile instant.
        launched.append(
            (params.query_len, params.out_len, packed_in.shape,
             int(packed_in[0, params.query_len]))
        )
        return orig_launch(snapshot, params, packed_in)

    s._launch = spy_launch
    try:
        # Warm ONLY the 256 bucket at b=1 (what warm_async converges to).
        params256 = _params_for(256)
        s._run_batch_traced(snap, params256, [(np.zeros(256, np.uint32), 1, SearchOptions())])
        assert s._shape_key(snap, params256, 1) in s._warm
        launched.clear()

        # A 6-hash query lands in the COLD 64 bucket; it must be served by
        # the warm 256 program (padded rows), with exact results, and the
        # exact 64 bucket queued for background compile.
        q = [10 * 7 + j for j in range(6)]  # doc 10's hashes
        res, stats = s.search(snap, q, SearchOptions(max_results=5, min_score=2))
        assert res and res[0].id == 10 and res[0].score == 6
        serving = [l for l in launched if l[3] == 6]
        assert serving, f"no serving launch: {launched}"
        assert serving[0][0] == 256, launched  # superset program served it
        key64 = s._shape_key(snap, _params_for(64), 1)
        # The exact bucket either already compiled (fast CPU) or is queued.
        assert key64 in s._warm or key64 in s._precompiling

        # Once the exact bucket is warm, it takes over.
        s._run_batch_traced(snap, _params_for(64), [(np.zeros(64, np.uint32), 1, SearchOptions())])
        launched.clear()
        res, _ = s.search(snap, q, SearchOptions(max_results=5, min_score=2))
        assert res and res[0].id == 10
        serving = [l for l in launched if l[3] == 6]
        assert serving and serving[0][0] == 64, launched
    finally:
        s.close()


def test_rebucketed_rows_preserve_fields():
    rows = [np.concatenate([np.arange(1, 65, dtype=np.uint32), np.array([7, 10, 2, 30], np.uint32)])]
    packed = BatchingSearcher._pack_rows_rebucketed(_params_for(256), 64, rows, 2)
    assert packed.shape == (2, 260)
    assert packed[0, :64].tolist() == list(range(1, 65))
    assert packed[0, 64:256].tolist() == [0] * 192
    assert packed[0, 256:].tolist() == [7, 10, 2, 30]
    assert packed[1, 257] == 1  # padding row keeps limit >= 1
