"""Device merge kernel vs the host merger (segment_merger.zig semantics)."""

import numpy as np

import jax.numpy as jnp

from acoustid_index.engine.memseg import build_segment, merge_segments
from acoustid_index.engine.model import Delete, Insert, SegmentInfo
from acoustid_index.engine.segments import Snapshot
from acoustid_index.ops.build import merge_postings_live, sort_postings


def pack_contiguous(segments, cap, dcap):
    """Contiguous (non-aligned) packing for the merge kernel."""
    S = len(segments)
    out = {
        "hashes": np.full(cap, 0xFFFFFFFF, np.uint32),
        "docids": np.full(cap, 0xFFFFFFFF, np.uint32),
        "seg_start": np.zeros(S, np.int32),
        "seg_len": np.zeros(S, np.int32),
        "docs_ids": np.full(dcap, 0xFFFFFFFF, np.uint32),
        "docs_alive": np.zeros(dcap, np.int32),
        "docs_start": np.zeros(S, np.int32),
        "docs_len": np.zeros(S, np.int32),
    }
    pos = dpos = 0
    for k, s in enumerate(segments):
        out["seg_start"][k] = pos
        out["seg_len"][k] = s.num_items
        out["hashes"][pos : pos + s.num_items] = s.hashes
        out["docids"][pos : pos + s.num_items] = s.docids
        pos += s.num_items
        out["docs_start"][k] = dpos
        out["docs_len"][k] = s.num_docs
        out["docs_ids"][dpos : dpos + s.num_docs] = s.docs_ids
        out["docs_alive"][dpos : dpos + s.num_docs] = s.docs_alive.astype(np.int32)
        dpos += s.num_docs
    return {k: jnp.asarray(v) for k, v in out.items()}


def test_device_merge_matches_host_merger():
    rng = np.random.default_rng(1)
    segs = []
    commit = 1
    for _ in range(4):
        docs = {
            int(rng.integers(1, 50)): rng.integers(0, 1000, int(rng.integers(1, 8)), dtype=np.uint32).tolist()
            for _ in range(int(rng.integers(2, 10)))
        }
        deletes = [int(x) for x in rng.integers(1, 50, 2) if int(x) not in docs]
        segs.append(
            build_segment(
                [Insert(id=i, hashes=h) for i, h in docs.items()] + [Delete(id=i) for i in deletes],
                SegmentInfo(commit_id=commit),
            )
        )
        commit += 1

    # Host merger over the whole set (the collection IS the sources here).
    collection = Snapshot(file=tuple(segs), memory=())
    want = merge_segments(segs, collection)

    packed = pack_contiguous(segs, cap=1024, dcap=256)
    h, d, n_kept, did, dalive, n_docs = merge_postings_live(
        packed["hashes"], packed["docids"], packed["seg_start"], packed["seg_len"],
        packed["docs_ids"], packed["docs_alive"], packed["docs_start"], packed["docs_len"],
    )
    n_kept, n_docs = int(n_kept), int(n_docs)
    assert n_kept == want.num_items
    assert np.array_equal(np.asarray(h)[:n_kept], want.hashes)
    assert np.array_equal(np.asarray(d)[:n_kept], want.docids)
    assert n_docs == want.num_docs
    assert np.array_equal(np.asarray(did)[:n_docs], want.docs_ids)
    assert np.array_equal(np.asarray(dalive)[:n_docs].astype(bool), want.docs_alive)


def _segments_equal(a, b):
    assert a.info == b.info
    assert np.array_equal(a.hashes, b.hashes)
    assert np.array_equal(a.docids, b.docids)
    assert np.array_equal(a.docs_ids, b.docs_ids)
    assert np.array_equal(a.docs_alive, b.docs_alive)
    assert (a.min_doc_id, a.max_doc_id) == (b.min_doc_id, b.max_doc_id)
    assert dict(a.metadata) == dict(b.metadata)


def test_engine_device_merge_matches_host_bit_for_bit():
    """merge_segments_device == merge_segments including OUTSIDE-run
    supersession: docs rewritten/deleted in segments newer than the merged
    run must be dropped by both paths."""
    from acoustid_index.engine.device_merge import merge_segments_device

    rng = np.random.default_rng(3)
    segs = []
    for commit in range(1, 6):
        docs = {
            int(rng.integers(1, 80)): rng.integers(0, 5000, int(rng.integers(1, 10)), dtype=np.uint32).tolist()
            for _ in range(int(rng.integers(3, 12)))
        }
        deletes = [int(x) for x in rng.integers(1, 80, 2) if int(x) not in docs]
        segs.append(
            build_segment(
                [Insert(id=i, hashes=h) for i, h in docs.items()] + [Delete(id=i) for i in deletes],
                SegmentInfo(commit_id=commit),
            )
        )
    # Merge only the first 3; segments 4-5 stay outside the run and shadow.
    collection = Snapshot(file=tuple(segs), memory=())
    run = segs[:3]
    want = merge_segments(run, collection)
    got = merge_segments_device(run, collection)
    _segments_equal(got, want)


def test_checkpoint_runs_device_merge_and_matches(tmp_path, monkeypatch):
    """An Index checkpoint above the device threshold runs the device merge
    and produces the same file segment as the host path."""
    from acoustid_index.engine import device_merge
    from acoustid_index.engine.index import Index

    calls = {"device": 0}
    orig = device_merge.merge_segments_device

    def spy(sources, collection):
        calls["device"] += 1
        return orig(sources, collection)

    monkeypatch.setattr(device_merge, "DEVICE_MERGE_MIN_POSTINGS", 100)
    monkeypatch.setattr(device_merge, "merge_segments_device", spy)

    rng = np.random.default_rng(4)
    all_changes = []
    idx = Index.open(str(tmp_path / "dev"), checkpoint_age=None)
    try:
        for batch in range(3):
            changes = [
                Insert(
                    id=batch * 30 + i,
                    hashes=rng.integers(0, 2**32, 8, dtype=np.uint32).tolist(),
                )
                for i in range(1, 31)
            ]
            all_changes.append(changes)
            idx.update(changes)
        assert idx.checkpoint(force=True)
        assert calls["device"] == 1
        dev_seg = idx.acquire_reader().file[0]
    finally:
        idx.close()

    # Host reference: same batches, threshold too high for the device path.
    monkeypatch.setattr(device_merge, "DEVICE_MERGE_MIN_POSTINGS", 10**12)
    idx2 = Index.open(str(tmp_path / "host"), checkpoint_age=None)
    try:
        for changes in all_changes:
            idx2.update(changes)
        assert idx2.checkpoint(force=True)
        host_seg = idx2.acquire_reader().file[0]
    finally:
        idx2.close()
    _segments_equal(dev_seg, host_seg)
