"""Regression tests for the self-review findings: queue-deadline timeouts,
checkpoint serialization under concurrent flush, legacy-size limits, and
Content-Length validation."""

import socket
import threading
import time

import pytest
import requests

from acoustid_index.engine import errors
from acoustid_index.engine.index import Index
from acoustid_index.engine.model import Insert, SearchOptions

from server_fixture import Server


def test_search_deadline_enforced(tmp_path):
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None)
    try:
        idx.update([Insert(id=1, hashes=[1, 2])])
        # A request whose deadline already passed while queueing is refused.
        with pytest.raises(errors.SearchTimeout):
            idx.search([1, 2], SearchOptions(), deadline=time.monotonic() - 0.001)
        # A live deadline passes.
        results, _ = idx.search([1, 2], SearchOptions(), deadline=time.monotonic() + 30)
        assert results[0].id == 1
    finally:
        idx.close()


def test_concurrent_flush_and_maintenance_checkpoints(tmp_path):
    """A public flush() racing maintenance checkpoints must never lose
    manifest-committed files (regression: identical segment file names, the
    loser's abort deleted the winner's file)."""
    idx = Index.open(str(tmp_path / "idx"), checkpoint_threshold=5, checkpoint_age=None)
    try:
        stop = threading.Event()
        failures = []

        def flusher():
            while not stop.is_set():
                try:
                    idx.flush()
                except Exception as exc:  # noqa: BLE001
                    failures.append(exc)
                    return

        t = threading.Thread(target=flusher)
        t.start()
        try:
            for i in range(1, 120):
                idx.update([Insert(id=i, hashes=[i, 7])])
                if i % 10 == 0:
                    idx.run_maintenance()
        finally:
            stop.set()
            t.join()
        assert not failures
        idx.flush()
    finally:
        idx.close()

    # The decisive check: a fresh open must find every manifest file intact.
    idx2 = Index.open(str(tmp_path / "idx"), checkpoint_age=None)
    try:
        results, _ = idx2.search([7], SearchOptions(max_results=100, min_score=1, min_score_pct=0))
        assert len(results) == 100  # capped at limit; all docs present
        assert idx2.acquire_reader().num_docs() == 119
    finally:
        idx2.close()


def test_large_limit_served_by_bigger_out_bucket(tmp_path):
    """limit > 128 (the legacy default is 500) selects the 512-wide output
    bucket and serves every matching doc (reference legacy sessions return up
    to max_results, legacy.zig:44)."""
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None)
    try:
        idx.update([Insert(id=i, hashes=[42]) for i in range(1, 300)])
        results, _ = idx.search([42], SearchOptions(max_results=500, min_score=1, min_score_pct=0))
        assert [r.id for r in results] == list(range(1, 300))
        # Beyond every bucket the limit clamps to the largest (512).
        idx.update([Insert(id=i, hashes=[42]) for i in range(300, 700)])
        results, _ = idx.search([42], SearchOptions(max_results=5000, min_score=1, min_score_pct=0))
        assert len(results) == 512
        assert [r.id for r in results] == list(range(1, 513))
    finally:
        idx.close()


def test_candidate_cap_overflow_sets_truncated(tmp_path):
    """More than candidate_cap docs reaching min_score must surface in the
    `truncated` stat instead of silently dropping ranked tail candidates."""
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None)
    try:
        # 300 docs all score 1 on hash 7: > candidate_cap=256 for the small
        # out bucket.
        idx.update([Insert(id=i, hashes=[7]) for i in range(1, 301)])
        _, stats = idx.search([7], SearchOptions(max_results=10, min_score=1, min_score_pct=0))
        assert stats.truncated
        # Under the cap: not truncated.
        _, stats = idx.search([7], SearchOptions(max_results=500, min_score=1, min_score_pct=0))
        assert not stats.truncated  # big out bucket has candidate_cap=1024
    finally:
        idx.close()


def test_deadline_expires_while_batched(tmp_path):
    """A request still queued behind a wedged dispatch at its deadline gets a
    SearchTimeout, not an indefinite hang."""
    import threading

    from acoustid_index.engine.model import SearchOptions as SO
    from acoustid_index.engine.searcher import BatchingSearcher

    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None)
    try:
        idx.update([Insert(id=1, hashes=[1, 2])])
        s = BatchingSearcher()
        snap = idx.acquire_reader()

        release = threading.Event()
        real_launch = s._launch

        def wedged_launch(snapshot, params, arrays):
            release.wait(timeout=30)  # a dispatch that stalls the pipeline
            return real_launch(snapshot, params, arrays)

        s._launch = wedged_launch
        first = s.submit(snap, [1, 2], SO())  # claims the dispatcher
        for _ in range(200):  # wait until the wedged dispatch claimed it
            if first.state != first.PENDING:
                break
            time.sleep(0.01)

        t0 = time.monotonic()
        with pytest.raises(errors.SearchTimeout):
            s.search(snap, [1, 2], SO(), deadline=time.monotonic() + 0.2)
        assert time.monotonic() - t0 < 5.0
        release.set()
        assert first.result()[0][0].id == 1  # the wedged batch still resolves
        s.close()
    finally:
        idx.close()


def test_bad_content_length(tmp_path):
    s = Server(tmp_path / "data").start()
    try:
        for bad in (b"-1", b"abc"):
            conn = socket.create_connection(("127.0.0.1", s.port), timeout=10)
            conn.sendall(
                b"POST /x/_search HTTP/1.1\r\nHost: h\r\nContent-Length: " + bad + b"\r\n\r\n"
            )
            data = conn.recv(4096)
            assert b"400" in data.split(b"\r\n", 1)[0], data
            conn.close()
    finally:
        s.stop()


def test_model_ingest_rejects_doc_zero():
    import numpy as np

    from acoustid_index.models.fingerprint_search import FingerprintSearchModel

    m = FingerprintSearchModel()
    with pytest.raises(ValueError):
        m.ingest(np.array([1, 2], np.uint32), np.array([0, 1], np.uint32))


def test_coordinator_read_is_sliced_not_scanned():
    """read/read_meta are O(batch) via dense-seq slicing; correctness across
    retention truncation, and a 100k-op lineage stays fast."""
    from acoustid_index.cluster.coordinator import MemoryCoordinator
    from acoustid_index.engine.model import Insert

    c = MemoryCoordinator()
    gen = c.create_index("idx")
    changes = [Insert(id=i, hashes=[i]) for i in range(1, 100_001)]
    for lo in range(0, 100_000, 10_000):
        c.append("idx", gen, changes[lo : lo + 10_000], expected=lo)

    t0 = time.monotonic()
    for after in (0, 1, 49_999, 99_990, 100_000):
        out = c.read("idx", gen, after, 64, deadline=time.monotonic() + 0.01 if after == 100_000 else time.monotonic() + 5)
        if after == 100_000:
            assert out == []
        else:
            assert out[0].id == after + 1
            assert len(out) == min(64, 100_000 - after)
    assert time.monotonic() - t0 < 2.0  # slicing, not scanning

    # Truncate and keep exactness: below floor raises, above slices correctly.
    c.set_retention_floor("idx", gen, 60_000)
    out = c.read("idx", gen, 60_000, 10, deadline=time.monotonic() + 5)
    assert [e.id for e in out] == list(range(60_001, 60_011))
    with pytest.raises(errors.BelowRetention):
        c.read("idx", gen, 59_999, 10, deadline=time.monotonic() + 5)

    # Meta feed slices by pos too.
    c.create_index("other")
    ops = c.read_meta(1, 10, deadline=time.monotonic() + 5)
    assert [op.pos for op in ops] == [2]


def test_pick_batch_size_starts_pipeline_for_external_callers():
    """The native front's pumps call _pick_batch_size without ever having
    submit()ed, so the precompile queue may not exist yet; the warm-but-not-
    exact path must start the pipeline rather than raise AttributeError on
    a None _precompile_q (and permanently poison _precompiling)."""
    from acoustid_index.engine.memseg import build_segment
    from acoustid_index.engine.model import SegmentInfo
    from acoustid_index.engine.searcher import BatchingSearcher, _params_for
    from acoustid_index.engine.segments import (
        FILE_SLOTS,
        MEMORY_SLOTS,
        Snapshot,
        pack_tier,
    )

    seg = build_segment([Insert(id=1, hashes=[1, 2, 3])], SegmentInfo(commit_id=1))
    snap = Snapshot(
        file=(seg,),
        memory=(),
        file_view=pack_tier([seg], FILE_SLOTS),
        mem_view=pack_tier([], MEMORY_SLOTS),
    )
    s = BatchingSearcher()
    try:
        p = _params_for(64)
        s._warm.add(s._shape_key(snap, p, 1))  # some bucket warm, exact cold
        assert s._precompile_q is None
        assert s._pick_batch_size(snap, p, 2) == 1  # chunk at the warm size
        assert s._precompile_q is not None  # pipeline started for the bg compile
    finally:
        s.close()


def test_sticky_shapes_are_per_index():
    """The default searcher is a process-wide singleton: one big index's
    sticky high-water device capacities must not inflate every other
    index's packed views (GBs of sentinel padding per small index)."""
    import numpy as np

    from acoustid_index.engine.memseg import build_segment
    from acoustid_index.engine.model import SegmentInfo
    from acoustid_index.engine.searcher import Searcher
    from acoustid_index.ops.layout import postings_cap

    rng = np.random.default_rng(3)
    big = build_segment(
        [Insert(id=i, hashes=rng.integers(1, 2**32, 24).tolist()) for i in range(1, 3001)],
        SegmentInfo(commit_id=1),
    )
    small = build_segment([Insert(id=1, hashes=[1, 2, 3])], SegmentInfo(commit_id=1))
    s = Searcher()
    v_big = s.pack_file_tier([big], owner="big-index")
    v_small = s.pack_file_tier([small], owner="small-index")
    assert postings_cap(v_big) >= 3000 * 24
    assert postings_cap(v_small) <= 1024  # floor, not the big index's cap
    assert v_small["owner"] == "small-index"
    # Same owner keeps the sticky behavior: repack never shrinks.
    v_small2 = s.pack_file_tier([small], owner="big-index")
    assert postings_cap(v_small2) == postings_cap(v_big)
