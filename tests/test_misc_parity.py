"""Coverage parity with the reference's remaining suites: parallel segment
loading on restart (tests/test_parallel_loading.py), the snapshot wire
format parsed externally (tests/test_snapshot.py), and reader-snapshot
stability across concurrent writes (Index.zig concurrency tests)."""

import io
import threading

import msgpack
import numpy as np
import pytest
import requests

from server_fixture import Server, post_search


def test_parallel_loading_restart(tmp_path):
    # Force many file segments, then restart with bounded load concurrency.
    s = Server(
        tmp_path / "data",
        extra_args=["--checkpoint-threshold", "5", "--checkpoint-age-ms", "0"],
    )
    s.start()
    try:
        requests.put(s.url("/idx"))
        for i in range(1, 31):
            requests.put(s.url(f"/idx/{i}"), json={"hashes": [i, 500 + i, 9000]})
        # Several checkpoints happened (threshold 5 items); capture state.
        want = post_search(
            s.url("/idx/_search"), json={"query": [9000, 505], "score_pct": 0, "min_score": 1}
        ).json()
        # Several checkpoints ran; background merges may or may not have
        # compacted them already — the restart must be correct either way.

        s.stop()
        s.extra_args += ["--load-concurrency", "2"]
        s.start()
        got = post_search(
            s.url("/idx/_search"), json={"query": [9000, 505], "score_pct": 0, "min_score": 1}
        ).json()
        assert got == want
        assert requests.get(s.url("/idx")).json()["stats"]["num_docs"] == 30
    finally:
        s.stop()


def test_snapshot_wire_format_parses_externally(tmp_path):
    # The snapshot stream must be consumable with nothing but msgpack —
    # header {f, g, s: [[info, size]]} then raw segment bytes.
    s = Server(tmp_path / "data", extra_args=["--checkpoint-threshold", "5", "--checkpoint-age-ms", "0"])
    s.start()
    try:
        requests.put(s.url("/idx"))
        for i in range(1, 12):
            requests.put(s.url(f"/idx/{i}"), json={"hashes": [i, 777]})
        raw = requests.get(s.url("/idx/_snapshot")).content
        hlen = int.from_bytes(raw[:4], "little")
        header = msgpack.unpackb(raw[4 : 4 + hlen], strict_map_key=False)
        assert header["f"] == 1
        assert header["g"] == 1
        total = sum(size for _info, size in header["s"])
        assert len(raw) == 4 + hlen + total
        # Each segment payload is a valid segment file (magic check).
        off = 4 + hlen
        for _info, size in header["s"]:
            assert raw[off : off + 4] in (b"ATS1", b"ATS2")
            off += size
    finally:
        s.stop()


def test_reader_snapshot_stable_across_writes(tmp_path):
    """A search that grabbed a snapshot must not see concurrent writes
    (the reference's 'reader snapshot stable across writes')."""
    from acoustid_index.engine.index import Index
    from acoustid_index.engine.model import Insert, SearchOptions

    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None)
    try:
        for i in range(1, 6):
            idx.update([Insert(id=i, hashes=[i, 100])])
        snap = idx.acquire_reader()
        before = snap.num_docs()
        stop = threading.Event()
        errors = []

        def writer():
            i = 100
            while not stop.is_set():
                try:
                    idx.update([Insert(id=i, hashes=[i, 100])])
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return
                i += 1

        t = threading.Thread(target=writer)
        t.start()
        try:
            for _ in range(20):
                assert snap.num_docs() == before  # the held snapshot never moves
                results, _ = idx.searcher.search(snap, [100], SearchOptions(max_results=100, min_score_pct=0))
                assert len(results) <= before
        finally:
            stop.set()
            t.join()
        assert not errors
        # A fresh reader sees the writes.
        assert idx.acquire_reader().num_docs() > before
    finally:
        idx.close()


def test_memory_tier_stays_bounded_under_write_load(tmp_path):
    from acoustid_index.engine.index import Index
    from acoustid_index.engine.model import Insert
    from acoustid_index.engine.segments import MEMORY_SLOTS

    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None)
    try:
        for i in range(1, 200):
            idx.update([Insert(id=i, hashes=[i])])
            assert len(idx.acquire_reader().memory) <= MEMORY_SLOTS
    finally:
        idx.close()


def test_shared_load_semaphore_bounds_total_loads(tmp_path, monkeypatch):
    """--load-concurrency N bounds TOTAL concurrent segment loads across all
    indexes the manager opens — one shared semaphore, not a per-index pool
    product (the reference's single semaphore, MultiIndex.zig:201-223)."""
    import os

    from acoustid_index.engine import filefmt
    from acoustid_index.engine.index import Index
    from acoustid_index.engine.model import Insert
    from acoustid_index.multi import redirect as index_redirect
    from acoustid_index.multi.multi_index import MultiIndex

    # Three lineages, four file segments each (checkpoint per batch; no
    # maintenance thread, so nothing merges them away before the reopen).
    root = str(tmp_path / "data")
    for n in ("a", "b", "c"):
        name_dir = os.path.join(root, n)
        os.makedirs(name_dir, exist_ok=True)
        index_redirect.write_redirect(
            name_dir, index_redirect.IndexRedirect(name=n, generation=1, deleted=False)
        )
        idx = Index.open(os.path.join(name_dir, "v000001"), checkpoint_age=None)
        try:
            for k in range(4):
                base = 100 * k
                idx.update([Insert(id=base + i, hashes=[base + i]) for i in range(1, 4)])
                assert idx.checkpoint(force=True)
        finally:
            idx.close()

    real = filefmt.read_segment
    lock = threading.Lock()
    state = {"cur": 0, "peak": 0, "n": 0}

    def tracked(data_dir, info):
        with lock:
            state["cur"] += 1
            state["n"] += 1
            state["peak"] = max(state["peak"], state["cur"])
        try:
            import time as _t

            _t.sleep(0.02)  # widen the race window
            return real(data_dir, info)
        finally:
            with lock:
                state["cur"] -= 1

    monkeypatch.setattr(filefmt, "read_segment", tracked)
    mi = MultiIndex.open(str(tmp_path / "data"), checkpoint_age=None, load_concurrency=2)
    try:
        assert state["n"] >= 6  # several segments actually loaded
        assert state["peak"] <= 2, f"peak concurrent loads {state['peak']} > 2"
    finally:
        mi.close()
