"""Sharded search through the blocked-lookup path: per-shard tables above
the gating threshold so shard_map runs the two-level lookup (the plain
landing scan on the CPU), compared against the single-device searcher."""

import numpy as np
import pytest

import jax

from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Insert, SegmentInfo, SearchOptions
from acoustid_index.engine.searcher import Searcher
from acoustid_index.engine.segments import Snapshot, pack_tier, FILE_SLOTS, MEMORY_SLOTS
from acoustid_index.ops import layout
from acoustid_index.ops.layout import BLOCK


def postings_cap_sharded(tier, n_shards=8):
    # Device search fields are flat (n_shards * X,) — see
    # sharded._pack_tier_sharded.
    if "inter" in tier:
        return tier["inter"].shape[0] // (2 * n_shards)
    return tier["hashes"].shape[0] // n_shards

from acoustid_index.ops.search_kernel import SearchParams
from acoustid_index.parallel.sharded import build_sharded_view, make_mesh, sharded_search

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def test_sharded_blocked_path_matches_single_device():
    rng = np.random.default_rng(21)
    n_docs = 25_000  # ~600k postings -> ~75k per shard > 64*BLOCK
    doc_hashes = rng.integers(0, 2**32, (n_docs, 24), dtype=np.uint32)
    seg = build_segment(
        [Insert(id=i + 1, hashes=doc_hashes[i].tolist()) for i in range(n_docs)],
        SegmentInfo(commit_id=1),
    )
    mesh = make_mesh(8)
    snap = Snapshot(file=(seg,), memory=())
    view = build_sharded_view(snap, mesh)
    assert postings_cap_sharded(view.file_tier) >= 64 * BLOCK  # blocked path gating

    single = Snapshot(
        file=(seg,),
        memory=(),
        file_view=pack_tier([seg], FILE_SLOTS),
        mem_view=pack_tier([], MEMORY_SLOTS),
    )
    searcher = Searcher()
    params = SearchParams(query_len=64, postings_budget=512, candidate_cap=256)

    for trial in range(3):
        t = int(rng.integers(1, n_docs + 1))
        q = np.unique(
            np.concatenate([doc_hashes[t - 1][:14], rng.integers(0, 2**32, 4, dtype=np.uint32)])
        )
        padded = np.zeros(64, np.uint32)
        padded[: q.shape[0]] = q
        out = jax.device_get(
            sharded_search(params, mesh, view, padded, int(q.shape[0]), 10, 2, 10)
        )
        got = [(int(out["ids"][i]), int(out["scores"][i])) for i in range(int(out["count"]))]
        want, _ = searcher.search(
            single, q.tolist(), SearchOptions(max_results=10, min_score=2, min_score_pct=10)
        )
        want = [(r.id, r.score) for r in want]
        assert got == want, (trial, got[:3], want[:3])
        assert got and got[0][0] == t


def test_sharded_direct_path_supersession_matches_single_device(monkeypatch):
    """The round-4 sharded DIRECT path (emitting blocked lookup -> gather-free
    candidates -> all_gather -> matrix scoring) with a live MEMORY tier:
    updates and tombstones whose file-tier postings live on *other* hash
    shards, so cross-shard supersession (docid-range mention pmax) is load
    bearing.  Forced interleaved like test_interleaved.py so the emit path
    engages at CPU test sizes."""
    monkeypatch.setattr(layout, "RESIDENT_MAX_BYTES", 64 * 1024)
    rng = np.random.default_rng(31)
    n_docs = 25_000
    doc_hashes = rng.integers(0, 2**32, (n_docs, 24), dtype=np.uint32)
    seg1 = build_segment(
        [Insert(id=i + 1, hashes=doc_hashes[i].tolist()) for i in range(n_docs)],
        SegmentInfo(commit_id=1),
    )
    # Memory tier: re-insert 40 docs with fresh hashes, tombstone 40 others.
    from acoustid_index.engine.model import Delete

    upd = rng.choice(np.arange(1, n_docs + 1), 80, replace=False)
    new_hashes = rng.integers(0, 2**32, (40, 24), dtype=np.uint32)
    changes = [Insert(id=int(upd[i]), hashes=new_hashes[i].tolist()) for i in range(40)]
    changes += [Delete(id=int(upd[40 + i])) for i in range(40)]
    seg2 = build_segment(changes, SegmentInfo(commit_id=2))

    mesh = make_mesh(8)
    snap = Snapshot(file=(seg1,), memory=(seg2,))
    view = build_sharded_view(snap, mesh)
    assert "inter" in {k: v for k, v in view.file_tier.items()}  # emit path gating

    single = Snapshot(
        file=(seg1,),
        memory=(seg2,),
        file_view=pack_tier([seg1], FILE_SLOTS),
        mem_view=pack_tier([seg2], MEMORY_SLOTS),
    )
    searcher = Searcher()
    params = SearchParams(query_len=64, postings_budget=512, candidate_cap=256)

    # Targets: one unchanged doc, one updated doc (old hashes must NOT find
    # it; new hashes must), one tombstoned doc (must not appear).
    victims = [int(upd[0]), int(upd[40]), int(rng.integers(1, n_docs))]
    probes = [new_hashes[0], doc_hashes[upd[40] - 1], doc_hashes[victims[2] - 1]]
    for t, hs in zip(victims, probes):
        q = np.unique(np.concatenate([hs[:14], rng.integers(0, 2**32, 4, dtype=np.uint32)]))
        padded = np.zeros(64, np.uint32)
        padded[: q.shape[0]] = q
        out = jax.device_get(
            sharded_search(params, mesh, view, padded, int(q.shape[0]), 10, 2, 10)
        )
        got = [(int(out["ids"][i]), int(out["scores"][i])) for i in range(int(out["count"]))]
        want, _ = searcher.search(
            single, q.tolist(), SearchOptions(max_results=10, min_score=2, min_score_pct=10)
        )
        assert got == [(r.id, r.score) for r in want], (t, got[:3])


def test_sharded_hot_hash_full_budget_matches_single_device(monkeypatch):
    """A hot hash (> P_SMALL postings in one shard) forces the sharded
    program off the direct/small paths onto the full-budget sorted combine;
    results must still match the single-device searcher bit for bit."""
    monkeypatch.setattr(layout, "RESIDENT_MAX_BYTES", 64 * 1024)
    from acoustid_index.ops.search_kernel import P_SMALL

    rng = np.random.default_rng(47)
    n_docs = 25_000
    doc_hashes = rng.integers(0, 2**32, (n_docs, 24), dtype=np.uint32)
    hot = np.uint32(0x7F000001)
    doc_hashes[: P_SMALL + 200, 0] = hot  # one shard sees > P_SMALL postings
    seg = build_segment(
        [Insert(id=i + 1, hashes=doc_hashes[i].tolist()) for i in range(n_docs)],
        SegmentInfo(commit_id=1),
    )
    mesh = make_mesh(8)
    view = build_sharded_view(Snapshot(file=(seg,), memory=()), mesh)
    single = Snapshot(
        file=(seg,),
        memory=(),
        file_view=pack_tier([seg], FILE_SLOTS),
        mem_view=pack_tier([], MEMORY_SLOTS),
    )
    searcher = Searcher()
    params = SearchParams(query_len=64, postings_budget=2048, candidate_cap=1024)

    t = 17  # a hot-hash member: its query includes the hot run
    q = np.unique(
        np.concatenate([doc_hashes[t - 1][:14], rng.integers(0, 2**32, 4, dtype=np.uint32)])
    )
    padded = np.zeros(64, np.uint32)
    padded[: q.shape[0]] = q
    out = jax.device_get(sharded_search(params, mesh, view, padded, int(q.shape[0]), 10, 2, 10))
    got = [(int(out["ids"][i]), int(out["scores"][i])) for i in range(int(out["count"]))]
    want, _ = searcher.search(
        single, q.tolist(), SearchOptions(max_results=10, min_score=2, min_score_pct=10)
    )
    assert got == [(r.id, r.score) for r in want]
    assert got and got[0][0] == t
