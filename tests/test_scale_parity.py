"""Oracle parity THROUGH the blocked-lookup path: the packed table must
exceed the 64-block interleave threshold so _batch_ranges takes the
two-level route over the interleaved layout (the plain landing scan on the
CPU test backend) — the small-table kernel tests take the dense range
phase and would never catch a blocked-lookup regression."""

import numpy as np

import jax.numpy as jnp

from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Insert, SegmentInfo, SearchOptions
from acoustid_index.engine.searcher import Searcher
from acoustid_index.engine.segments import (
    FILE_SLOTS,
    MEMORY_SLOTS,
    Snapshot,
    pack_tier,
)
from acoustid_index.ops.layout import BLOCK
from acoustid_index.ops.layout import postings_cap


def test_pallas_path_matches_oracle():
    rng = np.random.default_rng(9)
    n_docs = 4000
    hashes_per_doc = 24  # 96k postings > 64*BLOCK -> blocked path engages
    doc_hashes = rng.integers(0, 2**32, (n_docs, hashes_per_doc), dtype=np.uint32)
    seg = build_segment(
        [Insert(id=i + 1, hashes=doc_hashes[i].tolist()) for i in range(n_docs)],
        SegmentInfo(commit_id=1),
    )
    snap = Snapshot(
        file=(seg,),
        memory=(),
        file_view=pack_tier([seg], FILE_SLOTS),
        mem_view=pack_tier([], MEMORY_SLOTS),
    )
    assert postings_cap(snap.file_view) >= 64 * BLOCK  # blocked path gating

    searcher = Searcher()
    h_sorted = np.asarray(seg.hashes)
    d_sorted = np.asarray(seg.docids)

    for trial in range(6):
        t = int(rng.integers(1, n_docs + 1))
        q = np.unique(
            np.concatenate(
                [
                    doc_hashes[t - 1][:15],
                    doc_hashes[int(rng.integers(1, n_docs + 1)) - 1][:5],
                    rng.integers(0, 2**32, 4, dtype=np.uint32),
                ]
            )
        )
        got, _ = searcher.search(
            snap, q.tolist(), SearchOptions(max_results=10, min_score=2, min_score_pct=10)
        )
        got = [(r.id, r.score) for r in got]

        hits = {}
        for hq in q:
            lo = np.searchsorted(h_sorted, hq, "left")
            hi = np.searchsorted(h_sorted, hq, "right")
            for did in d_sorted[lo:hi]:
                hits[int(did)] = hits.get(int(did), 0) + 1
        cands = sorted(((d, s) for d, s in hits.items() if s >= 2), key=lambda x: (-x[1], x[0]))
        want = []
        ms = 2
        for d, s in cands:
            if len(want) == 10:
                break
            if s < ms:
                break
            if not want:
                ms = max(ms, s * 10 // 100)
            want.append((d, s))
        assert got == want, (trial, got[:5], want[:5])
        assert got and got[0][0] == t


def test_pallas_path_randomized_multisegment_with_supersession():
    """Randomized parity at blocked-path scale with the full engine
    semantics: multiple file segments, re-inserts and deletes in a newer
    memory segment (supersession + tombstones), vs the literal oracle."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from oracle import OracleSegment, oracle_search

    from acoustid_index.engine.model import Delete

    rng = np.random.default_rng(31)
    n_docs = 3500
    hashes_per_doc = 24
    doc_hashes = {
        i: rng.integers(0, 2**32, hashes_per_doc, dtype=np.uint32).tolist()
        for i in range(1, n_docs + 1)
    }
    half = n_docs // 2
    f1 = build_segment(
        [Insert(id=i, hashes=doc_hashes[i]) for i in range(1, half + 1)],
        SegmentInfo(commit_id=1),
    )
    f2 = build_segment(
        [Insert(id=i, hashes=doc_hashes[i]) for i in range(half + 1, n_docs + 1)],
        SegmentInfo(commit_id=2),
    )
    # Memory segment: re-insert 60 docs with NEW hashes, delete 40 others.
    re_ids = rng.choice(np.arange(1, n_docs + 1), 60, replace=False)
    del_ids = [int(i) for i in rng.choice(np.arange(1, n_docs + 1), 40, replace=False) if i not in set(re_ids.tolist())]
    changes = []
    for i in re_ids:
        doc_hashes[int(i)] = rng.integers(0, 2**32, hashes_per_doc, dtype=np.uint32).tolist()
        changes.append(Insert(id=int(i), hashes=doc_hashes[int(i)]))
    changes += [Delete(id=i) for i in del_ids]
    m1 = build_segment(changes, SegmentInfo(commit_id=3))

    segs = [f1, f2, m1]
    snap = Snapshot(
        file=(f1, f2),
        memory=(m1,),
        file_view=pack_tier([f1, f2], FILE_SLOTS),
        mem_view=pack_tier([m1], MEMORY_SLOTS),
    )
    assert postings_cap(snap.file_view) >= 64 * BLOCK  # blocked path gating

    oracle_segs = [
        OracleSegment(
            list(zip(s.hashes.tolist(), s.docids.tolist())),
            dict(zip(s.docs_ids.tolist(), s.docs_alive.tolist())),
        )
        for s in segs
    ]

    searcher = Searcher()
    targets = (
        [int(i) for i in re_ids[:3]]
        + del_ids[:3]
        + [int(rng.integers(1, n_docs + 1)) for _ in range(6)]
    )
    for t in targets:
        q = np.unique(
            np.concatenate(
                [
                    np.asarray(doc_hashes[t][:16], np.uint32),
                    rng.integers(0, 2**32, 5, dtype=np.uint32),
                ]
            )
        )
        got, _ = searcher.search(
            snap, q.tolist(), SearchOptions(max_results=15, min_score=1, min_score_pct=10)
        )
        got = [(r.id, r.score) for r in got]
        want = oracle_search(oracle_segs, q.tolist(), limit=15, min_score=1, pct=10)
        assert got == want, (t, got[:5], want[:5])
        if t not in del_ids:
            assert got and got[0][0] == t
        else:
            assert all(d != t for d, _ in got)
