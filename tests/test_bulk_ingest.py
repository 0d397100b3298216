"""Columnar bulk ingest: BulkInsert change, vectorized segment build, lazy
device packing, oplog durability, and the POST /:index/_bulk route.

The reference has no bulk form — its ingest is MemorySegment.build over a
change list (/root/reference/src/MemorySegment.zig:81-148) at one HTTP
change-array per 16 MiB body (main.zig:70).  BulkInsert is the same
operation with the list in columnar u32 arrays end-to-end, added because
per-document Python objects are the measured ingest bottleneck here.
"""

import numpy as np
import pytest

from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import (
    BulkInsert,
    Delete,
    Insert,
    SearchOptions,
    SegmentInfo,
    SetMetadata,
    Transaction,
    change_from_wire,
    change_to_wire,
)


def make_bulk(docs):
    """docs: list of (id, hashes)."""
    ids = np.array([d for d, _ in docs], np.uint32)
    offs = np.zeros(len(docs) + 1, np.uint32)
    offs[1:] = np.cumsum([len(h) for _, h in docs])
    flat = np.array([h for _, hs in docs for h in hs], np.uint32)
    return BulkInsert(ids=ids, hashes=flat, offsets=offs)


def seg_key(s):
    return (
        s.hashes.tolist(),
        s.docids.tolist(),
        s.docs_ids.tolist(),
        s.docs_alive.tolist(),
        s.min_doc_id,
        s.max_doc_id,
        s.metadata,
    )


def test_columnar_build_matches_classic():
    docs = [(5, [9, 3, 3, 7]), (2, [1]), (9, []), (5, [100])]  # dup id: last wins
    classic = build_segment(
        [Insert(id=i, hashes=h) for i, h in docs] + [Delete(id=2)],
        SegmentInfo(commit_id=3),
    )
    columnar = build_segment([make_bulk(docs), Delete(id=2)], SegmentInfo(commit_id=3))
    assert seg_key(columnar) == seg_key(classic)


def test_columnar_build_mixed_order_semantics():
    # Delete BEFORE a bulk re-insert must lose; metadata folds forward.
    changes = [
        Delete(id=7),
        make_bulk([(7, [1, 2]), (8, [3])]),
        SetMetadata(entries=(("k", "v"),)),
        Delete(id=8),
    ]
    classic = build_segment(
        [Delete(id=7), Insert(id=7, hashes=[1, 2]), Insert(id=8, hashes=[3]),
         SetMetadata(entries=(("k", "v"),)), Delete(id=8)],
        SegmentInfo(commit_id=1),
    )
    assert seg_key(build_segment(changes, SegmentInfo(commit_id=1))) == seg_key(classic)


def test_bulk_wire_roundtrip_and_shape():
    b = make_bulk([(1, [10, 20]), (2, [30])])
    w = change_to_wire(b)
    # Pinned wire shape: single-char keys, raw little-endian u32 bins.
    assert set(w) == {"b"} and set(w["b"]) == {"i", "h", "o"}
    assert w["b"]["i"] == np.array([1, 2], "<u4").tobytes()
    assert w["b"]["h"] == np.array([10, 20, 30], "<u4").tobytes()
    assert w["b"]["o"] == np.array([0, 2, 3], "<u4").tobytes()
    b2 = change_from_wire(w)
    assert isinstance(b2, BulkInsert)
    assert b2.ids.tolist() == [1, 2] and b2.hashes.tolist() == [10, 20, 30]
    # Transaction round-trip through msgpack (the oplog frame payload).
    import msgpack

    t = Transaction(id=4, changes=(b,))
    t2 = Transaction.from_wire(
        msgpack.unpackb(msgpack.packb(t.to_wire(), use_bin_type=True), strict_map_key=False)
    )
    assert isinstance(t2.changes[0], BulkInsert)
    assert t2.changes[0].offsets.tolist() == [0, 2, 3]


def test_bulk_validation():
    with pytest.raises(ValueError):
        BulkInsert(ids=np.array([1], np.uint32), hashes=np.array([1], np.uint32),
                   offsets=np.array([0], np.uint32))  # offsets too short
    with pytest.raises(ValueError):
        BulkInsert(ids=np.array([1, 2], np.uint32), hashes=np.array([1], np.uint32),
                   offsets=np.array([0, 1, 0], np.uint32))  # non-monotone / span


def test_index_bulk_insert_lazy_views_and_durability(tmp_path):
    from acoustid_index.engine.index import Index
    from acoustid_index.engine.segments import PENDING_VIEW

    idx = Index.open(str(tmp_path), checkpoint_age=None)
    try:
        ids = np.arange(1, 2001, dtype=np.uint32)
        hashes = (ids[:, None] * np.uint32(2654435761)
                  + np.arange(8, dtype=np.uint32)[None, :]).astype(np.uint32)
        v = idx.bulk_insert(ids, hashes)
        assert v == 1
        # The write deferred device packing...
        assert idx.acquire_reader().mem_view is PENDING_VIEW
        # ...and the first search resolves it with exact results.
        res, _ = idx.search(hashes[41].tolist(), SearchOptions(max_results=3, min_score=2))
        assert res and res[0].id == 42 and res[0].score == 8
        assert isinstance(idx.acquire_reader().mem_view, dict)

        # Second bulk batch + checkpoint drain.
        ids2 = np.arange(2001, 3001, dtype=np.uint32)
        h2 = (ids2[:, None] * np.uint32(2654435761)
              + np.arange(8, dtype=np.uint32)[None, :]).astype(np.uint32)
        idx.bulk_insert(ids2, h2)
        idx.flush()
        assert not idx.acquire_reader().memory
        res, _ = idx.search(h2[0].tolist(), SearchOptions(max_results=3, min_score=2))
        assert res and res[0].id == 2001
    finally:
        idx.close()

    # Restart: WAL replay (no checkpoint covers nothing here — all flushed)
    # and manifest load reproduce the same state.
    idx2 = Index.open(str(tmp_path), checkpoint_age=None)
    try:
        res, _ = idx2.search(hashes[0].tolist(), SearchOptions(max_results=3, min_score=2))
        assert res and res[0].id == 1
    finally:
        idx2.close()


def test_index_bulk_insert_wal_replay(tmp_path):
    # Kill before any checkpoint: the bulk frame must replay from the WAL.
    from acoustid_index.engine.index import Index

    idx = Index.open(str(tmp_path), checkpoint_age=None)
    ids = np.arange(1, 101, dtype=np.uint32)
    hashes = (ids[:, None] + np.arange(4, dtype=np.uint32)[None, :] * 1000).astype(np.uint32)
    idx.bulk_insert(ids, hashes)
    idx.oplog.close()  # simulate hard stop without flush/checkpoint
    idx.stop()

    idx2 = Index.open(str(tmp_path), checkpoint_age=None)
    try:
        assert idx2.acquire_reader().num_docs() == 100
        res, _ = idx2.search(hashes[6].tolist(), SearchOptions(max_results=3, min_score=2))
        assert res and res[0].id == 7 and res[0].score == 4
    finally:
        idx2.close()


def test_bulk_insert_rejects_mid_batch_and_versions(tmp_path):
    from acoustid_index.engine.errors import VersionMismatch
    from acoustid_index.engine.index import Index

    idx = Index.open(str(tmp_path), checkpoint_age=None)
    try:
        ids = np.array([1, 2], np.uint32)
        h = np.array([[1, 2], [3, 4]], np.uint32)
        idx.bulk_insert(ids, h)
        with pytest.raises(VersionMismatch):
            idx.bulk_insert(ids, h, expected_version=0)
        assert idx.bulk_insert(ids, h, expected_version=1) == 2
    finally:
        idx.close()


def test_http_bulk_route(tmp_path):
    """POST /:index/_bulk over real HTTP: msgpack bin columns, JSON lists,
    width form, validation, and SIGKILL durability of the bulk WAL frame."""
    import msgpack
    import requests

    from server_fixture import Server

    s = Server(tmp_path, extra_args=["--checkpoint-age-ms", "0"])
    s.start()
    try:
        assert requests.put(s.url("/bulk1")).status_code == 200
        ids = np.arange(1, 501, dtype=np.uint32)
        hashes = (ids[:, None] * np.uint32(2654435761)
                  + np.arange(6, dtype=np.uint32)[None, :]).astype(np.uint32)
        # msgpack bin + offsets form
        offs = np.arange(0, (500 + 1) * 6, 6, dtype=np.uint32)
        r = requests.post(
            s.url("/bulk1/_bulk"),
            data=msgpack.packb({
                "i": ids.tobytes(), "h": hashes.reshape(-1).tobytes(), "o": offs.tobytes(),
            }, use_bin_type=True),
            headers={"Content-Type": "application/vnd.msgpack"},
        )
        assert r.status_code == 200, r.text
        assert msgpack.unpackb(r.content, strict_map_key=False)["v"] == 1

        r = requests.post(s.url("/bulk1/_search"),
                          json={"query": hashes[41].tolist(), "limit": 3, "timeout": 10000})
        assert r.status_code == 200, r.text
        top = r.json()["results"][0]
        assert top["id"] == 42 and top["score"] == 6

        # JSON list + width form
        r = requests.post(s.url("/bulk1/_bulk"),
                          json={"ids": [1001, 1002], "hashes": [7, 8, 9, 10], "width": 2})
        assert r.status_code == 200, r.text

        # Validation: bad offsets -> 400, id 0 -> 400, junk binary -> 400
        r = requests.post(s.url("/bulk1/_bulk"),
                          json={"ids": [1, 2], "hashes": [1, 2], "width": 3})
        assert r.status_code == 400
        r = requests.post(s.url("/bulk1/_bulk"),
                          json={"ids": [0], "hashes": [5], "width": 1})
        assert r.status_code == 400
        r = requests.post(
            s.url("/bulk1/_bulk"),
            data=msgpack.packb({"i": b"\x01\x02\x03", "h": b"", "o": b""}, use_bin_type=True),
            headers={"Content-Type": "application/vnd.msgpack"},
        )
        assert r.status_code == 400

        # SIGKILL: the bulk frame must replay from the WAL on restart.
        s.restart(hard=True)
        r = requests.post(s.url("/bulk1/_search"),
                          json={"query": hashes[0].tolist(), "limit": 3, "timeout": 30000})
        assert r.status_code == 200, r.text
        assert r.json()["results"][0]["id"] == 1
    finally:
        s.stop()
