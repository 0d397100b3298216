"""Mesh-sharded search must match the single-device kernel exactly (and the
oracle, transitively) on an 8-device virtual mesh."""

import numpy as np
import pytest

import jax

from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Delete, Insert, SegmentInfo, SearchOptions
from acoustid_index.engine.searcher import Searcher
from acoustid_index.engine.segments import Snapshot, pack_tier, FILE_SLOTS, MEMORY_SLOTS
from acoustid_index.ops.search_kernel import SearchParams
from acoustid_index.parallel.sharded import (
    build_sharded_view,
    make_mesh,
    sharded_ingest_step,
    sharded_search,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def seg_from_docs(docs, commit_id, deletes=()):
    changes = [Insert(id=i, hashes=h) for i, h in docs.items()]
    changes += [Delete(id=i) for i in deletes]
    return build_segment(changes, SegmentInfo(commit_id=commit_id))


def run_sharded(file_segs, mem_segs, query, limit=10, min_score=1, pct=10):
    mesh = make_mesh(8)
    snap = Snapshot(file=tuple(file_segs), memory=tuple(mem_segs))
    view = build_sharded_view(snap, mesh)
    params = SearchParams(query_len=64, postings_budget=4096)
    q = np.unique(np.asarray(query, dtype=np.uint32))
    padded = np.zeros(64, np.uint32)
    padded[: q.shape[0]] = q
    out = jax.device_get(
        sharded_search(params, mesh, view, padded, q.shape[0], limit, min_score, pct)
    )
    n = int(out["count"])
    return [(int(out["ids"][i]), int(out["scores"][i])) for i in range(n)]


def run_single(file_segs, mem_segs, query, limit=10, min_score=1, pct=10):
    snap = Snapshot(
        file=tuple(file_segs),
        memory=tuple(mem_segs),
        file_view=pack_tier(file_segs, FILE_SLOTS),
        mem_view=pack_tier(mem_segs, MEMORY_SLOTS),
    )
    res, _ = Searcher().search(
        snap, query, SearchOptions(max_results=limit, min_score=min_score, min_score_pct=pct)
    )
    return [(r.id, r.score) for r in res]


def test_sharded_matches_single_device_basic():
    rng = np.random.default_rng(42)
    # Hashes spread over the whole u32 space so every shard owns some.
    docs1 = {i: rng.integers(0, 2**32, 20, dtype=np.uint32).tolist() for i in range(1, 30)}
    docs2 = {i: rng.integers(0, 2**32, 20, dtype=np.uint32).tolist() for i in range(25, 40)}
    f1 = seg_from_docs(docs1, 1)
    m1 = seg_from_docs(docs2, 2, deletes=[3, 7])
    query = docs1[5][:10] + docs2[30][:10] + docs1[3][:5]
    got = run_sharded([f1], [m1], query, limit=20, min_score=1, pct=0)
    want = run_single([f1], [m1], query, limit=20, min_score=1, pct=0)
    assert got == want
    assert got  # non-trivial


@pytest.mark.parametrize("seed", range(3))
def test_sharded_matches_single_device_randomized(seed):
    rng = np.random.default_rng(seed)
    segs = []
    commit = 1
    for _ in range(int(rng.integers(1, 4))):
        docs = {
            int(rng.integers(1, 60)): rng.integers(0, 2**32, int(rng.integers(1, 15)), dtype=np.uint32).tolist()
            for _ in range(int(rng.integers(1, 10)))
        }
        deletes = [int(x) for x in rng.integers(1, 60, int(rng.integers(0, 3)))]
        deletes = [x for x in deletes if x not in docs]
        segs.append(seg_from_docs(docs, commit, deletes))
        commit += 1
    n_file = int(rng.integers(0, len(segs) + 1))
    file_segs, mem_segs = segs[:n_file], segs[n_file:]
    all_hashes = np.concatenate([s.hashes for s in segs if s.num_items]) if any(s.num_items for s in segs) else np.array([1], np.uint32)
    for _ in range(5):
        query = rng.choice(all_hashes, size=min(12, all_hashes.shape[0]), replace=False).tolist()
        got = run_sharded(file_segs, mem_segs, query, limit=10, min_score=1, pct=10)
        want = run_single(file_segs, mem_segs, query, limit=10, min_score=1, pct=10)
        assert got == want


def test_sharded_ingest_sorts_per_shard():
    mesh = make_mesh(8)
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2**32, 5000, dtype=np.uint32)
    i = rng.integers(1, 1000, 5000, dtype=np.uint32)
    sh, si = jax.device_get(sharded_ingest_step(mesh, h, i))
    from acoustid_index.parallel.sharded import hash_bounds

    bounds = hash_bounds(8)
    total = 0
    for k in range(8):
        row = sh[k]
        valid = row != 0xFFFFFFFF
        vals = row[valid].astype(np.uint64)
        assert np.all(np.diff(vals.astype(np.int64)) >= 0)  # sorted
        if vals.size:
            assert vals.min() >= bounds[k] and vals.max() < bounds[k + 1]
        total += int(valid.sum())
    # Sentinel-valued real hashes (0xFFFFFFFF) can be undercounted; with this
    # rng draw none collide.
    assert total == 5000


def test_sharded_big_budget_branch_matches_single_device():
    """A hot hash with > P_SMALL postings forces the full-budget branch of
    the sharded program (the small/full lax.cond must agree across shards
    via the pmax'd predicate, and both must match the single-device path)."""
    rng = np.random.default_rng(9)
    hot = 123456
    docs = {i: [hot, int(rng.integers(0, 10_000))] for i in range(1, 400)}
    docs[777] = [hot, 42, 43, 44]
    segs = [seg_from_docs(docs, commit_id=1)]
    q = [hot, 42, 43, 44]
    got = run_sharded(segs, [], q, limit=5, min_score=2, pct=0)
    want = run_single(segs, [], q, limit=5, min_score=2, pct=0)
    assert got == want, (got, want)
    assert got and got[0][0] == 777 and got[0][1] == 4
