"""Durability and lifecycle invariants of the single-index engine, mirroring
the reference's unit-test strategy (SURVEY.md §4): torn-WAL recovery, dense
commit ids, version monotonicity, checkpoint-as-commit-point, restart
replay, supersession across restarts and merges."""

import os
import struct

import pytest

from acoustid_index.engine import filefmt, manifest
from acoustid_index.engine.errors import VersionMismatch, VersionRequired, VersionWentBackwards
from acoustid_index.engine.index import Index
from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Delete, Insert, SegmentInfo, SetMetadata, SearchOptions, Transaction
from acoustid_index.engine.oplog import Oplog


def collect(dirpath):
    txns = []
    log = Oplog.open(dirpath, sync=False, handler=txns.append)
    return log, txns


def test_oplog_roundtrip_and_dense_commit_ids(tmp_path):
    d = str(tmp_path / "oplog")
    log, _ = collect(d)
    c1, v1 = log.append([Insert(id=1, hashes=[1, 2])])
    c2, v2 = log.append([Delete(id=1)])
    assert (c1, c2) == (1, 2)
    assert (v1, v2) == (1, 2)
    log.close()

    log2, txns = collect(d)
    assert [t.id for t in txns] == [1, 2]
    assert txns[0].changes[0] == Insert(id=1, hashes=(1, 2))
    assert txns[1].changes[0] == Delete(id=1)
    assert log2.last_commit_id == 2
    log2.close()


def test_oplog_torn_tail_recovery(tmp_path):
    d = str(tmp_path / "oplog")
    log, _ = collect(d)
    log.append([Insert(id=1, hashes=[1])])
    log.append([Insert(id=2, hashes=[2])])
    log.close()

    # Tear the tail: truncate the file mid-record.
    name = os.listdir(d)[0]
    path = os.path.join(d, name)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 3)

    log2, txns = collect(d)
    assert [t.id for t in txns] == [1]  # valid prefix recovered
    # The next append continues from the recovered state.
    c, _ = log2.append([Insert(id=3, hashes=[3])])
    assert c == 2
    log2.close()


def test_oplog_corrupt_crc_stops_replay(tmp_path):
    d = str(tmp_path / "oplog")
    log, _ = collect(d)
    log.append([Insert(id=1, hashes=[1])])
    log.append([Insert(id=2, hashes=[2])])
    log.close()
    name = os.listdir(d)[0]
    path = os.path.join(d, name)
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        # Flip a byte inside the second record's payload.
        (len1,) = struct.unpack_from("<I", data, 0)
        second = 8 + len1
        data[second + 8 + 2] ^= 0xFF
        f.seek(0)
        f.write(data)

    _, txns = collect(d)
    assert [t.id for t in txns] == [1]


def test_oplog_version_monotonic(tmp_path):
    d = str(tmp_path / "oplog")
    log, _ = collect(d)
    log.append([Insert(id=1, hashes=[1])], version=10)
    # Equal versions are fine (snapshot restores share one position).
    log.append([Insert(id=2, hashes=[2])], version=10)
    with pytest.raises(VersionWentBackwards):
        log.append([Insert(id=3, hashes=[3])], version=9)
    # A rejected append leaves no trace; commit ids stay dense even with
    # jumping positions.
    c, v = log.append([Insert(id=3, hashes=[3])], version=99)
    assert (c, v) == (3, 99)
    log.close()


def test_oplog_expected_version(tmp_path):
    d = str(tmp_path / "oplog")
    log, _ = collect(d)
    log.append([Insert(id=1, hashes=[1])])
    with pytest.raises(VersionMismatch):
        log.append([Insert(id=2, hashes=[2])], expected_version=0)
    c, _ = log.append([Insert(id=2, hashes=[2])], expected_version=1)
    assert c == 2
    log.close()


def test_oplog_rotation_and_truncate(tmp_path):
    d = str(tmp_path / "oplog")
    log, _ = collect(d)
    log.max_file_size = 1  # force rotation every append
    for i in range(1, 6):
        log.append([Insert(id=i, hashes=[i])])
    assert len(os.listdir(d)) == 5
    log.truncate(4)
    starts = sorted(os.listdir(d))
    # Files fully below commit 4 are gone; the spanning one stays.
    log2, txns = collect(d)
    assert txns[0].id <= 4 and txns[-1].id == 5
    log2.close()
    log.close()


def test_segment_file_roundtrip(tmp_path):
    seg = build_segment(
        [Insert(id=5, hashes=[9, 3, 3]), Delete(id=7), SetMetadata(entries=[("k", "v")])],
        SegmentInfo(commit_id=3, merges=1, version=42),
    )
    filefmt.write_segment(str(tmp_path), seg)
    back = filefmt.read_segment(str(tmp_path), seg.info)
    assert back.info == seg.info
    assert back.hashes.tolist() == seg.hashes.tolist()
    assert back.docids.tolist() == seg.docids.tolist()
    assert back.docs_ids.tolist() == [5, 7]
    assert back.docs_alive.tolist() == [True, False]
    assert back.metadata_dict() == {"k": "v"}
    assert (back.min_doc_id, back.max_doc_id) == (5, 7)


def test_segment_file_corruption_detected(tmp_path):
    seg = build_segment([Insert(id=5, hashes=[9])], SegmentInfo(commit_id=1))
    name = filefmt.write_segment(str(tmp_path), seg)
    path = os.path.join(str(tmp_path), name)
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        data[-6] ^= 0x01  # payload byte
        f.seek(0)
        f.write(data)
    with pytest.raises(ValueError):
        filefmt.read_segment(str(tmp_path), seg.info)


def test_manifest_roundtrip(tmp_path):
    infos = [SegmentInfo(1, 0, None), SegmentInfo(2, 3, 77)]
    manifest.write_manifest(str(tmp_path), infos)
    assert manifest.read_manifest(str(tmp_path)) == infos
    assert manifest.read_manifest(str(tmp_path / "missing")) == []


# ---- Index lifecycle ----


def search_ids(index, query, **kw):
    results, _ = index.search(query, SearchOptions(**kw) if kw else SearchOptions())
    return [(r.id, r.score) for r in results]


def test_index_update_search_restart(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    v1 = idx.update([Insert(id=1, hashes=[100, 200, 300])])
    v2 = idx.update([Insert(id=2, hashes=[200, 300, 400])])
    assert (v1, v2) == (1, 2)
    assert search_ids(idx, [200, 300, 400]) == [(2, 3), (1, 2)]
    idx.close()

    # Restart: WAL replay restores everything (no checkpoint happened).
    idx2 = Index.open(path, checkpoint_age=None)
    assert idx2.version == 2
    assert search_ids(idx2, [200, 300, 400]) == [(2, 3), (1, 2)]
    idx2.close()


def test_index_checkpoint_restart_and_oplog_truncate(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    idx.update([Insert(id=1, hashes=[100, 200])])
    idx.update([Insert(id=2, hashes=[200, 300])])
    assert idx.checkpoint(force=True)
    assert idx.file_commit_id == 2
    assert len(idx.acquire_reader().file) == 1
    assert len(idx.acquire_reader().memory) == 0
    # Writes after the checkpoint land in memory.
    idx.update([Delete(id=1)])
    assert search_ids(idx, [100, 200]) == [(2, 1)]
    idx.close()

    idx2 = Index.open(path, checkpoint_age=None)
    assert idx2.file_commit_id == 2
    assert idx2.version == 3
    assert search_ids(idx2, [100, 200]) == [(2, 1)]  # tombstone replayed from WAL
    idx2.close()


def test_index_hard_restart_preserves_exact_scores(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    for i in range(1, 30):
        idx.update([Insert(id=i, hashes=list(range(i, i + 10)))])
    want = search_ids(idx, list(range(12, 22)))
    assert want
    idx.checkpoint(force=True)
    assert search_ids(idx, list(range(12, 22))) == want
    idx.close()  # no graceful anything beyond fsyncs already done

    idx2 = Index.open(path, checkpoint_age=None)
    assert search_ids(idx2, list(range(12, 22))) == want
    idx2.close()


def test_index_memory_merge_preserves_results(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    for i in range(1, 25):
        idx.update([Insert(id=i, hashes=[i, 1000, 1000 + i])])
    idx.update([Delete(id=3)])
    want = search_ids(idx, [1000, 5, 1005])
    while idx.merge_memory():
        pass
    assert len(idx.acquire_reader().memory) < 25
    assert search_ids(idx, [1000, 5, 1005]) == want
    idx.close()


def test_index_file_merges_and_file_cleanup(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    # Many checkpoints -> many file segments -> policy merges some.
    for i in range(1, 40):
        idx.update([Insert(id=i, hashes=[i, 7777])])
        if i % 3 == 0:
            idx.checkpoint(force=True)
    want = search_ids(idx, [7777, 10], max_results=100, min_score=1, min_score_pct=0)
    n_before = len(idx.acquire_reader().file)
    merged_any = False
    while idx.merge_files():
        merged_any = True
    if merged_any:
        assert len(idx.acquire_reader().file) < n_before
    assert search_ids(idx, [7777, 10], max_results=100, min_score=1, min_score_pct=0) == want
    # Disk state matches the manifest exactly (retired files deleted).
    data_dir = os.path.join(path, "data")
    on_disk = {f for f in os.listdir(data_dir) if f.endswith(".seg")}
    expected = {filefmt.segment_file_name(s.info) for s in idx.acquire_reader().file}
    assert on_disk == expected
    idx.close()

    idx2 = Index.open(path, checkpoint_age=None)
    assert search_ids(idx2, [7777, 10], max_results=100, min_score=1, min_score_pct=0) == want
    idx2.close()


def test_index_expected_version_conflict(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    v = idx.update([Insert(id=1, hashes=[1])])
    with pytest.raises(VersionMismatch):
        idx.update([Insert(id=2, hashes=[2])], expected_version=v + 5)
    assert idx.update([Insert(id=2, hashes=[2])], expected_version=v) == v + 1
    idx.close()


def test_index_upstream_fed_rejects_local_writes(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    idx.update([Insert(id=1, hashes=[1])], version=100)
    with pytest.raises(VersionRequired):
        idx.update([Insert(id=2, hashes=[2])])
    idx.close()
    # Poisoning survives restart (derived from replayed transactions).
    idx2 = Index.open(path, checkpoint_age=None)
    assert idx2.external_versions
    with pytest.raises(VersionRequired):
        idx2.update([Insert(id=2, hashes=[2])])
    idx2.close()


def test_index_upstream_fed_survives_checkpoint(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    idx.update([Insert(id=1, hashes=[1])], version=100)
    idx.checkpoint(force=True)
    assert idx.file_version == 100
    idx.close()
    idx2 = Index.open(path, checkpoint_age=None)
    assert idx2.external_versions
    assert idx2.version == 100
    assert idx2.file_version == 100
    idx2.close()


def test_index_metadata_rides_op_stream(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    idx.update([Insert(id=1, hashes=[1]), SetMetadata(entries=[("a", "1")])])
    idx.update([SetMetadata(entries=[("a", "2"), ("b", "3")])])
    assert idx.acquire_reader().metadata() == {"a": "2", "b": "3"}
    idx.checkpoint(force=True)
    assert idx.acquire_reader().metadata() == {"a": "2", "b": "3"}
    idx.close()
    idx2 = Index.open(path, checkpoint_age=None)
    assert idx2.acquire_reader().metadata() == {"a": "2", "b": "3"}
    idx2.close()


def test_index_doc_info(tmp_path):
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    idx.update([Insert(id=1, hashes=[1, 2])])
    idx.update([Delete(id=1)])
    snap = idx.acquire_reader()
    version, deleted = snap.get_doc_info(1)
    assert deleted and version == 2
    assert snap.get_doc_info(99) is None
    idx.close()


def test_slot_pressure_merges_cheapest_window(tmp_path, monkeypatch):
    """When the policy is idle but the device view runs out of slots, the
    fallback merge picks the cheapest adjacent window — NOT the head of the
    tier, which holds the biggest segments (rewriting those per event is the
    O(N^2) cascade the tiered policy exists to avoid)."""
    from acoustid_index.engine import index as index_mod

    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None)
    try:
        # Segment 0 is big; the rest are small.
        idx.update([Insert(id=i, hashes=list(range(1000, 1200))) for i in range(1, 6)])
        assert idx.checkpoint(force=True)
        for k in range(1, 12):
            idx.update([Insert(id=100 + k, hashes=[7, k])])
            assert idx.checkpoint(force=True)
        snap = idx.acquire_reader()
        assert len(snap.file) == 12
        big = snap.file[0]

        class IdlePolicy:
            def should_merge(self, sizes):
                return None

        idx.file_merge_policy = IdlePolicy()
        monkeypatch.setattr(index_mod, "FILE_SLOTS", 13)  # force slot pressure
        assert idx.merge_files()
        snap2 = idx.acquire_reader()
        assert snap2.file[0] is big  # the big head segment was NOT rewritten
        assert len(snap2.file) == 3  # 12 - 10 + 1
        # All data still served.
        results, _ = idx.search([7], SearchOptions(max_results=100, min_score=1, min_score_pct=0))
        assert len(results) == 11
    finally:
        idx.close()
