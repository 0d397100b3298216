"""End-to-end mesh-sharded serving: an Index whose searcher is the
ShardedBatchingSearcher (8-device virtual mesh) must match the oracle and
the single-chip searcher through writes, deletes, supersession, checkpoints
and merges — and the HTTP server must serve identically under --mesh-shards.
"""

import threading

import numpy as np
import pytest
import requests

import jax

from oracle import OracleSegment, oracle_search
from server_fixture import Server, post_search

from acoustid_index.engine.index import Index
from acoustid_index.engine.model import Delete, Insert, SearchOptions
from acoustid_index.engine.searcher import Searcher
from acoustid_index.engine.segments import FILE_SLOTS, MEMORY_SLOTS, pack_tier
from acoustid_index.parallel.serving import ShardedBatchingSearcher

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def snapshot_oracle(snapshot, query, limit=10, min_score=1, pct=10):
    segs = [
        OracleSegment(
            list(zip(s.hashes.tolist(), s.docids.tolist())),
            dict(zip(s.docs_ids.tolist(), s.docs_alive.tolist())),
        )
        for s in snapshot.all_segments()
    ]
    return oracle_search(segs, query, limit=limit, min_score=min_score, pct=pct)


def single_chip(snapshot, query, limit=10, min_score=1, pct=10):
    from dataclasses import replace

    snap = replace(
        snapshot,
        file_view=pack_tier(list(snapshot.file), FILE_SLOTS),
        mem_view=pack_tier(list(snapshot.memory), MEMORY_SLOTS),
    )
    res, _ = Searcher().search(
        snap, query, SearchOptions(max_results=limit, min_score=min_score, min_score_pct=pct)
    )
    return [(r.id, r.score) for r in res]


def test_sharded_index_lifecycle_matches_oracle(tmp_path):
    rng = np.random.default_rng(11)
    searcher = ShardedBatchingSearcher(n_shards=8)
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None, searcher=searcher)
    try:
        docs = {}
        # Several write batches; hashes span the whole u32 space.
        for batch in range(4):
            changes = []
            for i in range(batch * 40 + 1, batch * 40 + 41):
                h = rng.integers(0, 2**32, 12, dtype=np.uint32).tolist()
                docs[i] = h
                changes.append(Insert(id=i, hashes=h))
            idx.update(changes)
        # Checkpoint moves everything into the file tier (sharded repack).
        assert idx.checkpoint(force=True)

        # Supersession pressure: re-insert some, delete others, leave in memory.
        re_ins = []
        for i in (3, 50, 90):
            h = rng.integers(0, 2**32, 12, dtype=np.uint32).tolist()
            docs[i] = h
            re_ins.append(Insert(id=i, hashes=h))
        idx.update(re_ins)
        idx.update([Delete(id=7), Delete(id=120)])
        docs.pop(7), docs.pop(120)

        snapshot = idx.acquire_reader()
        for target in (3, 7, 12, 50, 90, 120, 155):
            base = docs.get(target, rng.integers(0, 2**32, 12, dtype=np.uint32).tolist())
            query = list(base[:9]) + rng.integers(0, 2**32, 3, dtype=np.uint32).tolist()
            want = snapshot_oracle(snapshot, query, limit=20, min_score=1, pct=0)
            got_single = single_chip(snapshot, query, limit=20, min_score=1, pct=0)
            res, _ = idx.search(query, SearchOptions(max_results=20, min_score=1, min_score_pct=0))
            got_sharded = [(r.id, r.score) for r in res]
            assert got_sharded == want, (target, got_sharded, want)
            assert got_sharded == got_single
    finally:
        idx.close()


def test_sharded_concurrent_searches_coalesce(tmp_path):
    rng = np.random.default_rng(5)
    searcher = ShardedBatchingSearcher(n_shards=8, max_wait=0.02)
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None, searcher=searcher)
    try:
        docs = {
            i: rng.integers(0, 2**32, 16, dtype=np.uint32).tolist() for i in range(1, 120)
        }
        idx.update([Insert(id=i, hashes=h) for i, h in docs.items()])

        # Warm the compiled program so the concurrent burst coalesces.
        idx.search(docs[1], SearchOptions())

        results = {}
        errors = []

        def one(i):
            try:
                res, _ = idx.search(docs[i], SearchOptions(max_results=5))
                results[i] = [(r.id, r.score) for r in res]
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(1, 33)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        for i in range(1, 33):
            assert results[i][0] == (i, 16), (i, results[i])
    finally:
        idx.close()


def test_http_server_mesh_shards(tmp_path):
    s = Server(
        tmp_path / "data",
        extra_args=["--mesh-shards", "8", "--search-port", "-1"],
        env_extra={"AITPU_HOST_DEVICE_COUNT": "8"},
    ).start()
    try:
        u = s.url
        requests.put(u("/main"), json={})
        for i in range(1, 40):
            r = requests.put(u(f"/main/{i}"), json={"hashes": [i * 7, i * 7 + 1, 2**31 + i]})
            assert r.status_code == 200, r.text
        r = post_search(
            u("/main/_search"),
            json={"query": [21, 22, 2**31 + 3], "min_score": 1, "score_pct": 0},
        )
        assert r.status_code == 200, r.text
        assert r.json()["results"][0] == {"id": 3, "score": 3}

        # The native search plane pumps through the SAME sharded searcher
        # (ShardedBatchingSearcher only overrides _launch); its response must
        # match the Python plane byte-for-byte.
        assert s.search_port, "native plane port not announced"
        body = {"query": [21, 22, 2**31 + 3], "min_score": 1, "score_pct": 0}
        rn = post_search(f"http://127.0.0.1:{s.search_port}/main/_search", json=body)
        assert rn.status_code == 200, rn.content
        assert rn.content == post_search(u("/main/_search"), json=body).content

        # Durability through restart with the sharded searcher.
        s.restart()
        r = post_search(
            u("/main/_search"),
            json={"query": [21, 22, 2**31 + 3], "min_score": 1, "score_pct": 0},
        )
        assert r.json()["results"][0] == {"id": 3, "score": 3}
    finally:
        s.stop()
