"""Mesh-sharded serving: a drop-in Searcher that packs segment views by
hash range across a device mesh and runs the batched sharded search program.

This is the scale-out axis the reference lacks (it is single-node by design,
/root/reference/README.md:100-105); SURVEY.md §7 stage 4.  The engine stays
oblivious: Index routes view packing through its Searcher, so

  * the FILE tier's sharded view rebuilds only at checkpoint/merge and is
    shared by reference across write snapshots (incremental by construction,
    same as the single-chip view);
  * the MEMORY tier repacks per write batch (bounded by the checkpoint
    threshold), host-partitioned by hash range and re-placed on the mesh;
  * search coalesces concurrent requests exactly like BatchingSearcher and
    dispatches ONE sharded program for the whole batch.

Scores are exact across shards (all_gather'd hit lists + pmax'd supersession
— see sharded.sharded_search_batch).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..engine.searcher import BatchingSearcher
from ..engine.segments import (
    FILE_SLOTS,
    MEMORY_SLOTS,
    slot_bucket,
    tier_view_for_search,
)
from .sharded import (
    AXIS,
    _pack_tier_sharded,
    make_mesh,
    put_sharded,
    sharded_search_batch_packed,
)


class ShardedBatchingSearcher(BatchingSearcher):
    """BatchingSearcher whose device views are hash-range sharded over a
    mesh and whose batch program is the sharded search."""

    def __init__(self, mesh=None, n_shards: Optional[int] = None, max_wait: float = 0.002):
        super().__init__(max_wait=max_wait)
        self.mesh = mesh if mesh is not None else make_mesh(n_shards)
        self.n_shards = int(self.mesh.devices.size)

    # ---- view packing (called by the engine on tier changes) ----

    def _pack(self, segments: Sequence, slots: int, tier: str, owner) -> Dict:
        # Sticky high-water shapes, like the single-chip searcher (see
        # Searcher._pack_sticky, keyed per owner index so one big index
        # doesn't inflate every other index's device arrays): write-heavy
        # serving converges to one shape set per tier.
        with self._lock:
            hwm = list(self._hwm.get((owner, tier), (1024, 1024, 1024, 0)))
        view_np = _pack_tier_sharded(
            segments,
            self.n_shards,
            max(slot_bucket(len(segments), slots), min(hwm[3], slots)),
            min_caps=(hwm[0], hwm[1], hwm[2]),
        )
        # Device search fields are FLAT (n_shards * X,) — per-shard caps
        # divide by the shard count (see sharded._pack_tier_sharded).
        n = self.n_shards
        cap0 = (
            view_np["inter"].shape[0] // (2 * n)
            if "inter" in view_np
            else view_np["hashes"].shape[0] // n
        )
        grown = (
            int(cap0),
            int(view_np["docs_ids"].shape[1]),
            int(view_np["mention_ids"].shape[0] // n),
            int(view_np["seg_start"].shape[0] // n),
        )
        with self._lock:
            cur = self._hwm.setdefault((owner, tier), [1024, 1024, 1024, 0])
            for i in range(4):
                cur[i] = max(cur[i], grown[i])
        view = put_sharded(view_np, self.mesh)
        from ..engine.segments import _VIEW_TOKENS

        view["view_token"] = next(_VIEW_TOKENS)
        view["owner"] = owner
        return view

    def pack_file_tier(self, segments, owner=None) -> Dict:
        return self._pack(segments, FILE_SLOTS, "file", owner)

    def pack_mem_tier(self, segments, owner=None) -> Dict:
        return self._pack(segments, MEMORY_SLOTS, "mem", owner)

    # ---- batch execution ----

    def _launch(self, snapshot, params, packed_in):
        import numpy as np

        Q = params.query_len
        qs = packed_in[:, :Q]
        lens = packed_in[:, Q].astype(np.int32)
        limits = packed_in[:, Q + 1].astype(np.int32)
        min_scores = packed_in[:, Q + 2].astype(np.int32)
        pcts = packed_in[:, Q + 3].astype(np.int32)
        fview = tier_view_for_search(snapshot.file_view, mentions=False)
        mview = tier_view_for_search(snapshot.mem_view)
        return sharded_search_batch_packed(
            params, self.mesh, fview, mview, qs, lens, limits, min_scores, pcts
        )
