"""Device-side segment compaction for big merges.

The reference compacts with an incremental host k-way merger
(/root/reference/src/segment_merger.zig:131-151); on the device the same
job is a sort (ops/build.merge_postings_live).  At 100M+ docs a checkpoint is
a ~1B-row host lexsort — minutes of maintenance-thread stall — while the
device sorts it in seconds, so merges above DEVICE_MERGE_MIN_POSTINGS take
the device path and small merges stay on the host (transfer overhead wins).

Exactness: merge_postings_live drops docs superseded WITHIN the merged run
(the merger's skip_docs rule); docs superseded by segments OUTSIDE the run
(newer file segments / the memory tier during a file merge) are dropped by a
host-side post-filter against the whole collection — together bit-for-bit
the host merge_segments result (test_device_merge.py pins this).
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence

import numpy as np

from .memseg import Segment, merge_segments
from .model import SegmentInfo
from .segments import _bucket, slot_bucket

log = logging.getLogger("acoustid_index.device_merge")

DEVICE_MERGE_MIN_POSTINGS = 1_000_000


def _device_merge_threshold() -> int:
    """Posting count from which the device sort beats the host sort.

    The crossover is transfer-bound, not sort-bound: the merge moves
    2x4 B per posting each way over PCIe, so the device wins from ~1M
    postings.  Override with AITPU_DEVICE_MERGE_MIN_POSTINGS; the constant
    is read live (tests tune it per case)."""
    import os

    env = os.environ.get("AITPU_DEVICE_MERGE_MIN_POSTINGS")
    return int(env) if env else DEVICE_MERGE_MIN_POSTINGS


def merge_segments_auto(sources: Sequence[Segment], collection) -> Segment:
    """Device merge when the run is big, host merge otherwise (or on any
    device failure — compaction must never take the index down).  Runs of
    >64 sources exceed the merge kernel's slot bucket (a bulk stream's
    deferred tier); the host merger handles any count."""
    from ..server import metrics

    total = sum(s.num_items for s in sources)
    if 2 <= len(sources) <= 64 and total >= _device_merge_threshold():
        try:
            merged = merge_segments_device(sources, collection)
        except Exception:
            log.exception("device merge failed; falling back to host merge")
            metrics.inc_device_merge_fallbacks()
        else:
            metrics.inc_device_merges()
            return merged
    return merge_segments(sources, collection)


def _pack_for_merge(sources: Sequence[Segment]):
    import jax.numpy as jnp

    # Bucket the slot dimension so XLA compiles a handful of merge programs;
    # zero-length padding slots contribute no postings or docs.
    S = slot_bucket(len(sources), 64)
    total = sum(s.num_items for s in sources)
    dtotal = sum(s.num_docs for s in sources)
    cap = _bucket(max(total, 1), 1024)
    dcap = _bucket(max(dtotal, 1), 1024)

    hashes = np.full(cap, 0xFFFFFFFF, np.uint32)
    docids = np.full(cap, 0xFFFFFFFF, np.uint32)
    docs_ids = np.full(dcap, 0xFFFFFFFF, np.uint32)
    docs_alive = np.zeros(dcap, np.int32)
    seg_start = np.zeros(S, np.int32)
    seg_len = np.zeros(S, np.int32)
    docs_start = np.zeros(S, np.int32)
    docs_len = np.zeros(S, np.int32)

    pos = dpos = 0
    for k, s in enumerate(sources):
        # Contiguous packing (NOT block-aligned): merge_postings_live derives
        # each posting's ordinal from cumulative seg_len.
        seg_start[k] = pos
        seg_len[k] = s.num_items
        hashes[pos : pos + s.num_items] = s.hashes
        docids[pos : pos + s.num_items] = s.docids
        pos += s.num_items
        docs_start[k] = dpos
        docs_len[k] = s.num_docs
        docs_ids[dpos : dpos + s.num_docs] = s.docs_ids
        docs_alive[dpos : dpos + s.num_docs] = s.docs_alive.astype(np.int32)
        dpos += s.num_docs

    return tuple(
        jnp.asarray(a)
        for a in (hashes, docids, seg_start, seg_len, docs_ids, docs_alive, docs_start, docs_len)
    )


def merge_segments_device(sources: Sequence[Segment], collection) -> Segment:
    """Bit-for-bit equivalent of memseg.merge_segments, with the O(n log n)
    work on device."""
    import jax

    from ..ops.build import merge_postings_live

    assert sources, "no sources"
    info = sources[0].info
    for s in sources[1:]:
        info = info.merge(s.info)
    metadata: Dict[str, str] = {}
    for s in sources:  # oldest -> newest, newest key wins
        metadata.update(s.metadata)

    args = _pack_for_merge(sources)
    h, d, n_kept, out_id, out_alive, n_docs = jax.device_get(merge_postings_live(*args))
    n_kept, n_docs = int(n_kept), int(n_docs)
    hashes = np.ascontiguousarray(h[:n_kept])
    docids = np.ascontiguousarray(d[:n_kept])
    docs_ids = np.ascontiguousarray(out_id[:n_docs])
    docs_alive = out_alive[:n_docs].astype(bool)

    # Outside-run supersession: a doc rewritten/deleted in a segment NEWER
    # than the whole run (commit id past the run's last) must be dropped here
    # too — the host merger consults the whole collection per source.
    if hasattr(collection, "has_newer_commit_batch") and docs_ids.shape[0]:
        newer = collection.has_newer_commit_batch(docs_ids, info.last_commit_id())
        if newer.any():
            drop_ids = docs_ids[newer]
            docs_ids = docs_ids[~newer]
            docs_alive = docs_alive[~newer]
            idx = np.searchsorted(drop_ids, docids)
            idx_c = np.clip(idx, 0, drop_ids.shape[0] - 1)
            keep = drop_ids[idx_c] != docids
            hashes = hashes[keep]
            docids = docids[keep]

    return Segment(
        info=info,
        hashes=hashes,
        docids=docids,
        docs_ids=docs_ids,
        docs_alive=docs_alive,
        min_doc_id=int(docs_ids[0]) if docs_ids.shape[0] else 0,
        max_doc_id=int(docs_ids[-1]) if docs_ids.shape[0] else 0,
        metadata=tuple(metadata.items()),
    )
