"""The batching searcher must return per-request-correct results under
concurrency (and match the plain searcher exactly)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Insert, SegmentInfo, SearchOptions
from acoustid_index.engine.searcher import BatchingSearcher, Searcher
from acoustid_index.engine.segments import Snapshot, pack_tier, FILE_SLOTS, MEMORY_SLOTS


def test_batching_matches_plain_under_concurrency():
    rng = np.random.default_rng(3)
    docs = {i: rng.integers(0, 2**32, 12, dtype=np.uint32).tolist() for i in range(1, 200)}
    seg = build_segment([Insert(id=i, hashes=h) for i, h in docs.items()], SegmentInfo(commit_id=1))
    snap = Snapshot(
        file=(seg,),
        memory=(),
        file_view=pack_tier([seg], FILE_SLOTS),
        mem_view=pack_tier([], MEMORY_SLOTS),
    )
    plain = Searcher()
    batching = BatchingSearcher()

    queries = []
    for i in range(1, 100):
        q = docs[i][:8] + [int(x) for x in rng.integers(0, 2**32, 3, dtype=np.uint32)]
        queries.append((i, q))

    opts = SearchOptions(max_results=5, min_score=1, min_score_pct=0)
    want = {i: plain.search(snap, q, opts)[0] for i, q in queries}

    def one(iq):
        i, q = iq
        res, _ = batching.search(snap, q, opts)
        return i, res

    with ThreadPoolExecutor(max_workers=16) as pool:
        got = dict(pool.map(one, queries))

    for i, q in queries:
        assert got[i] == want[i], (i, got[i], want[i])
        assert got[i][0].id == i  # self-retrieval


def test_batching_solo_request():
    seg = build_segment([Insert(id=1, hashes=[5, 6, 7])], SegmentInfo(commit_id=1))
    snap = Snapshot(
        file=(),
        memory=(seg,),
        file_view=pack_tier([], FILE_SLOTS),
        mem_view=pack_tier([seg], MEMORY_SLOTS),
    )
    b = BatchingSearcher()
    res, stats = b.search(snap, [5, 6, 99], SearchOptions())
    assert [(r.id, r.score) for r in res] == [(1, 2)]


def test_warm_precompiles_without_error(tmp_path):
    from acoustid_index.engine.index import Index
    from acoustid_index.engine.model import Insert, SearchOptions

    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None)
    try:
        idx.update([Insert(id=1, hashes=[1, 2, 3])])
        snap = idx.acquire_reader()
        idx.searcher.warm(snap, q_buckets=(64,), batch_sizes=(1, 4))
        res, _ = idx.search([1, 2, 3], SearchOptions())
        assert res[0].id == 1
    finally:
        idx.close()
