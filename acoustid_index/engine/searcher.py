"""Query pipeline: preprocessing, kernel dispatch, result materialization.

Queries are sorted and de-duplicated up front, matching the reference's rule
that a duplicate query hash must count once no matter which tier serves it
(IndexReader.search, /root/reference/src/Index.zig:162-177), then padded to
a bucketed static length so XLA compiles a handful of programs.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.search_kernel import SearchParams, make_search_fn
from .model import SearchOptions, SearchResult
from .segments import Snapshot, tier_view_for_search

QUERY_BUCKETS = (64, 128, 256, 1024, 4096)  # 128: real fingerprint queries run ~120 hashes
MAX_QUERY_HASHES = QUERY_BUCKETS[-1]

# The HTTP API caps limit at 100 (-> the 128 bucket); the legacy protocol's
# session max_results defaults to 500 (legacy.zig:44) and must be honored, so
# a second bucket serves large limits.  Limits beyond the last bucket clamp.
OUT_BUCKETS = (128, 512)
MAX_RESULTS = OUT_BUCKETS[-1]


@dataclass(frozen=True)
class SearchStats:
    postings_scanned: int
    truncated: bool
    # Max postings any single query hash scanned (summed across segments,
    # both tiers) — the reference's scanned-docs-per-hash load-skew signal
    # (metrics.zig:96-101), computed on device.
    max_per_hash: int = 0
    # Max postings BLOCKS any single hash's run spanned (both tiers) — the
    # reference's scanned-blocks-per-hash series (metrics.zig:96-101).
    max_blocks_per_hash: int = 0


def _out_bucket_for(limit: int) -> int:
    return next(b for b in OUT_BUCKETS if b >= min(limit, MAX_RESULTS))


def _params_for(q_bucket: int, out_bucket: int = 128) -> SearchParams:
    # The gather + scoring phases scale with the budget (the per-posting
    # random gather grows with P), so keep it tight:
    # typical fingerprint queries gather a few postings per hash; heavier
    # queries report `truncated` (the reference's own per-hash scan caps
    # truncate far earlier, FileSegment.zig:25-26).
    budget = min(max(1024, q_bucket * 4), 16384)
    return SearchParams(
        query_len=q_bucket,
        postings_budget=budget,
        per_hash_cap=1024,
        # C bounds ranked candidates and must cover the output tile; the
        # extra headroom absorbs superseded high-scorers that finish() skips.
        candidate_cap=256 if out_bucket <= 128 else 2 * out_bucket,
        out_len=out_bucket,
    )


class Searcher:
    """Owns compiled search programs, keyed by static params.

    The searcher also owns the device LAYOUT of segment views: the engine
    calls pack_file_tier/pack_mem_tier whenever a tier's segment set changes
    (file tier only at checkpoint/merge; memory tier per write), so a
    mesh-sharded searcher can substitute hash-range-sharded views without
    the engine knowing — and view sharing across snapshots (update() reuses
    cur.file_view) makes the sharded file view incremental for free."""

    def __init__(self):
        self._fns: Dict[SearchParams, object] = {}
        self._lock = threading.Lock()
        # Sticky HIGH-WATER device shapes per (owner index, tier):
        # [postings cap, docs cap, mention cap, slots].  Capacities and slot
        # counts only ever grow, so a write-heavy serving state converges to
        # ONE shape set instead of producing a fresh shape — and a fresh
        # compile — every half-octave of growth and every slot-bucket
        # change.  Keyed by owner because this searcher is a process-wide
        # singleton: without the key, one 100M-posting index would force
        # every small index in the MultiIndex to allocate ITS bucketed
        # capacities (GBs of sentinel padding per index).
        self._hwm: Dict[tuple, list] = {}

    def _pack_sticky(self, segments, slots_cap: int, tier: str, owner) -> Dict:
        from .segments import pack_tier

        with self._lock:
            hwm = list(self._hwm.get((owner, tier), (1024, 1024, 1024, 0)))
        view = pack_tier(
            segments,
            slots_cap,
            min_slots=hwm[3],
            min_caps=(hwm[0], hwm[1], hwm[2]),
            # Only the memory tier's mention table is consulted on device
            # (pack-time filtering; see segments.pack_tier) — the file
            # tier's stays host-side instead of burning HBM.
            device_mentions=(tier == "mem"),
        )
        from ..ops.layout import postings_cap

        grown = (
            postings_cap(view),
            int(view["docs_ids"].shape[0]),
            int(view["mention_ids"].shape[0]),
            int(view["seg_start"].shape[0]),
        )
        with self._lock:
            cur = self._hwm.setdefault((owner, tier), [1024, 1024, 1024, 0])
            for i in range(4):
                cur[i] = max(cur[i], grown[i])
        view["owner"] = owner
        return view

    def pack_file_tier(self, segments, owner=None) -> Dict:
        from .segments import FILE_SLOTS

        return self._pack_sticky(segments, FILE_SLOTS, "file", owner)

    def pack_mem_tier(self, segments, owner=None) -> Dict:
        from .segments import MEMORY_SLOTS

        return self._pack_sticky(segments, MEMORY_SLOTS, "mem", owner)

    def _fn(self, params: SearchParams):
        with self._lock:
            fn = self._fns.get(params)
            if fn is None:
                fn = make_search_fn(params)
                self._fns[params] = fn
            return fn

    def prepare_query(self, query: Sequence[int]) -> Tuple[np.ndarray, int]:
        # Sorted + deduped (the reference's dedup rule, Index.zig:170-176).
        # Hand-rolled sort+mask: np.unique's dispatch layers cost ~10us per
        # call, which matters at tens of kqps of tiny queries.
        q = np.asarray(query, dtype=np.uint32)
        n = q.shape[0]
        if n > 1:
            q = np.sort(q)
            keep = np.empty(n, bool)
            keep[0] = True
            np.not_equal(q[1:], q[:-1], out=keep[1:])
            q = q[keep]
        if q.shape[0] > MAX_QUERY_HASHES:
            q = q[:MAX_QUERY_HASHES]
        return q, int(q.shape[0])

    def search(
        self,
        snapshot: Snapshot,
        query: Sequence[int],
        options: SearchOptions,
        deadline: Optional[float] = None,
    ) -> Tuple[List[SearchResult], SearchStats]:
        assert isinstance(snapshot.mem_view, dict) or snapshot.mem_view is None, (
            "unresolved deferred view: search must go through Index.ensure_views"
        )
        q, q_len = self.prepare_query(query)
        if q_len == 0 or snapshot.file_view is None or snapshot.mem_view is None:
            return [], SearchStats(0, False)

        bucket = next(b for b in QUERY_BUCKETS if b >= q_len)
        params = _params_for(bucket, _out_bucket_for(options.max_results))
        fn = self._fn(params)

        padded = np.zeros(bucket, dtype=np.uint32)
        padded[:q_len] = q
        out = fn(
            tier_view_for_search(snapshot.file_view, mentions=False),
            tier_view_for_search(snapshot.mem_view),
            padded,
            np.int32(q_len),
            np.int32(options.max_results),
            np.int32(options.min_score),
            np.int32(options.min_score_pct),
        )
        import jax

        out = jax.device_get(out)
        n = int(out["count"])
        results = [
            SearchResult(id=int(out["ids"][i]), score=int(out["scores"][i]))
            for i in range(n)
        ]
        stats = SearchStats(
            postings_scanned=int(out["postings_scanned"]),
            truncated=bool(out["truncated"]),
            max_per_hash=int(out.get("max_per_hash", 0)),
            max_blocks_per_hash=int(out.get("max_blocks_per_hash", 0)),
        )
        return results, stats

    def submit(self, snapshot, query, options, deadline=None):
        """Future-returning form; the plain searcher resolves synchronously
        (BatchingSearcher overrides with the real pipeline)."""
        return _ImmediateResult(self.search(snapshot, query, options, deadline))

    def warm_async(self, snapshot) -> None:
        """Kick a background compile for this snapshot's view shapes (no-op
        here; BatchingSearcher overrides with the real precompiler)."""


class _ImmediateResult:
    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
MAX_BATCH = BATCH_SIZES[-1]


class _PendingSearch:
    """A submitted search — the future its caller waits on.

    State transitions (guarded by the searcher's queue lock):
      PENDING   — sitting in the dispatch queue
      CLAIMED   — packed into a batch that has been (or is being) launched
      ABANDONED — deadline expired while still PENDING; the dispatcher drops it
    """

    PENDING, CLAIMED, ABANDONED = 0, 1, 2

    __slots__ = (
        "searcher", "key", "snapshot", "padded", "q_len", "options",
        "deadline", "state", "done", "row", "error", "direct",
    )

    def __init__(self, searcher, key, snapshot, padded, q_len, options, deadline):
        self.searcher = searcher
        self.key = key
        self.snapshot = snapshot
        self.padded = padded
        self.q_len = q_len
        self.options = options
        self.deadline = deadline
        self.state = self.PENDING
        self.done = threading.Event()
        self.row = None
        self.error = None
        self.direct = None  # short-circuit result (empty query)

    def result(self) -> Tuple[List[SearchResult], SearchStats]:
        """Block until the result is ready (same deadline semantics as
        BatchingSearcher.search)."""
        return self.searcher._await(self)


class BatchingSearcher(Searcher):
    """Coalesces concurrent searches into batched device programs and
    PIPELINES them.

    The reference's throughput comes from many CPU threads scanning
    independently; on the device the equivalent is one vectorized program
    over a query batch.  A single synchronous launch-then-fetch cycle,
    however, serializes the device->host round trip with the kernel itself, so this searcher splits the cycle across threads:

      * a DISPATCHER thread drains the request queue, packs same-group
        requests (same table identity + query/out bucket) into the largest
        ready batch, and launches it — JAX dispatch is asynchronous, so the
        launch returns while the program runs;
      * COLLECTOR threads fetch finished batches (`device_get`) and resolve
        the callers' futures.

    Batch N+1 is packed and launched while batch N's transfer is still in
    flight; up to MAX_IN_FLIGHT batches queue on the device.  `submit` is
    the async form (for open-loop load and callers that want many searches
    in flight from one thread); `search` is submit + wait.
    """

    MAX_IN_FLIGHT = int(os.environ.get("AITPU_SEARCH_IN_FLIGHT", "8"))
    # Each collector blocks a full device->host round trip per batch;
    # overlapping four keeps the drain rate above the device's batch
    # completion rate so the in-flight window, not the fetch path, paces
    # the pipeline.
    COLLECTORS = int(os.environ.get("AITPU_SEARCH_COLLECTORS", "4"))
    # A dispatched batch must eventually resolve even with no deadline set
    # (cold-bucket compiles take minutes; the API caps timeouts at 10s but
    # legacy sessions may run with timeout 0 = none).
    MAX_RESULT_WAIT = 300.0

    def __init__(self, max_wait: float = 0.002):
        super().__init__()
        self.max_wait = max_wait
        self._qlock = threading.Lock()
        self._qcond = threading.Condition(self._qlock)
        self._pending = []  # type: List[_PendingSearch]
        self._inflight = 0  # launched, not yet collected (under _qlock)
        self._inflight_sem = threading.BoundedSemaphore(self.MAX_IN_FLIGHT)
        self._collect_q = None  # type: Optional[object]
        self._precompile_q = None  # type: Optional[object]
        self._threads = None
        self._stopping = False
        # Batch shapes whose program is already compiled (see _shape_key).
        # A cold shape would stall the single dispatcher for the whole
        # compile (seconds to minutes cold) and time out
        # everything queued behind it, so cold sizes round UP to the nearest
        # warm bucket (padding is cheap) while the exact bucket compiles in
        # the background.
        self._warm = set()
        self._precompiling = set()
        self._shape_cache: Dict[int, tuple] = {}
        # Abandoned-work accounting (see _purge_expired): requests resolved
        # as expired before their batch launched, and batches whose every
        # member expired so the device launch was skipped entirely.
        self.abandoned_prelaunch = 0
        self.launches_skipped = 0
        # (file token, mem token) of the most recently submitted request —
        # lets the precompiler drop requests for superseded views.
        # Latest (file,mem) view tokens PER OWNER index: the precompiler
        # skips items whose views were superseded, and a single global pair
        # would mark every other index's precompiles stale under
        # multi-index traffic.
        self._latest_group = {}

    # ---- submission ----

    def submit(
        self,
        snapshot: Snapshot,
        query: Sequence[int],
        options: SearchOptions,
        deadline: Optional[float] = None,
    ) -> _PendingSearch:
        """Enqueue a search; returns a future-like handle (`.result()`)."""
        assert isinstance(snapshot.mem_view, dict) or snapshot.mem_view is None, (
            "unresolved deferred view: search must go through Index.ensure_views"
        )
        q, q_len = self.prepare_query(query)
        if q_len == 0 or snapshot.file_view is None or snapshot.mem_view is None:
            req = _PendingSearch(self, None, None, None, 0, options, deadline)
            req.direct = ([], SearchStats(0, False))
            req.done.set()
            return req
        bucket = next(b for b in QUERY_BUCKETS if b >= q_len)
        out_bucket = _out_bucket_for(options.max_results)
        # The FULL device input row (queries | len | limit | min_score |
        # pct) is built here, in the (parallel) submitting threads, so the
        # single dispatcher only stacks rows (see _pack_rows).
        padded = np.zeros(bucket + 4, dtype=np.uint32)
        padded[:q_len] = q
        padded[bucket] = q_len
        padded[bucket + 1] = options.max_results
        padded[bucket + 2] = options.min_score
        padded[bucket + 3] = options.min_score_pct
        key = (
            snapshot.file_view.get("view_token", id(snapshot.file_view)),
            snapshot.mem_view.get("view_token", id(snapshot.mem_view)),
            bucket,
            out_bucket,
        )
        req = _PendingSearch(self, key, snapshot, padded, q_len, options, deadline)
        with self._qcond:
            if self._stopping:
                # A request accepted while stopping would never be claimed
                # (the dispatcher is exiting) — fail fast instead of letting
                # the caller block MAX_RESULT_WAIT.
                req.error = RuntimeError("searcher closed")
                req.snapshot = None
                req.done.set()
                return req
            self._ensure_threads_locked()
            self._latest_group[snapshot.file_view.get("owner")] = key[:2]
            self._pending.append(req)
            self._qcond.notify()
        return req

    def search(
        self,
        snapshot: Snapshot,
        query: Sequence[int],
        options: SearchOptions,
        deadline: Optional[float] = None,
    ):
        return self._await(self.submit(snapshot, query, options, deadline))

    def _await(self, req: _PendingSearch):
        if req.deadline is None:
            # No deadline (legacy sessions may run with timeout 0 = none):
            # a healthy-but-slow pipeline (a cold compile) must keep being
            # waited on, but a DEAD pipeline
            # must surface as an error instead of blocking forever — so
            # re-check thread liveness each wait period.
            while not req.done.wait(self.MAX_RESULT_WAIT):
                threads = self._threads
                if threads is None or not any(t.is_alive() for t in threads):
                    raise RuntimeError("batched search pipeline died")
        elif not req.done.wait(max(0.0, req.deadline - time.monotonic())):
            from .errors import SearchTimeout

            with self._qlock:
                if req.state == _PendingSearch.PENDING:
                    # Deadline expired while still queued: refuse (the
                    # reference cancels at scan yield points; our pre-launch
                    # queue is the analogous cancellation point).
                    req.state = _PendingSearch.ABANDONED
                    req.snapshot = None
                    raise SearchTimeout("search deadline expired while batched")
            # Already claimed: the deadline is ABSOLUTE (the reference arms
            # an AutoCancel over the whole search, MultiIndex.zig:314-316),
            # so the caller is released NOW even if the batch is stuck
            # behind a cold compile — the compile itself stays alive and
            # warms the bucket for future requests; the collector resolves
            # this request harmlessly when the batch lands.
            raise SearchTimeout("search deadline expired while batched")
        if req.error is not None:
            raise req.error
        if req.direct is not None:
            return req.direct
        # out_len comes from the ROW width, not the request's out bucket:
        # a cold-bucket request may have been served through a warm
        # SUPERSET program with wider output rows (see _pick_program).
        return self._materialize_row(req.row, (req.row.shape[0] - 5) // 2)

    # ---- pipeline threads ----

    def _ensure_threads_locked(self) -> None:
        if self._threads is not None:
            return
        import queue

        self._collect_q = queue.Queue()
        self._precompile_q = queue.Queue()
        ts = [
            threading.Thread(target=self._dispatch_loop, name="aitpu-dispatch", daemon=True),
            threading.Thread(target=self._precompile_loop, name="aitpu-precompile", daemon=True),
        ]
        for i in range(self.COLLECTORS):
            ts.append(
                threading.Thread(target=self._collect_loop, name=f"aitpu-collect-{i}", daemon=True)
            )
        for t in ts:
            t.start()
        self._threads = ts
        # Drain the daemons at interpreter exit for EVERY instance (not just
        # the default singleton): CPython kills daemon threads by pthread_exit
        # at their next GIL acquisition, and a thread force-unwound under
        # jax's pybind11 C++ frames aborts/segfaults the process at shutdown.
        # Unregistered again when close() joins the threads.
        atexit.register(self.close)

    def close(self) -> None:
        """Stop the pipeline threads (daemonized, so optional).  The
        DISPATCHER enqueues the collector sentinels itself as its last act
        (failing still-queued requests first, so no caller is stranded) —
        queue FIFO then guarantees collectors drain every launched batch
        before exiting, even if this close() times out waiting for a
        mid-compile dispatcher (the sentinels land AFTER its final batch,
        not before).  If a join times out the searcher stays marked
        stopping so no second pipeline can start; submit() rejects new
        requests while stopping."""
        with self._qcond:
            if self._threads is None:
                return
            self._stopping = True
            self._qcond.notify_all()
            threads = self._threads
        self._precompile_q.put(None)
        threads[0].join(timeout=30)  # dispatcher (enqueues collector sentinels)
        for t in threads[1:]:
            t.join(timeout=10)
        if not any(t.is_alive() for t in threads):
            with self._qcond:
                self._threads = None
                self._stopping = False
            atexit.unregister(self.close)

    def _purge_expired(self, batch: List[_PendingSearch]) -> List[_PendingSearch]:
        """Resolve CLAIMED requests whose absolute deadline already passed
        (as the timeout their waiting caller has seen or is about to see)
        and return the still-live remainder."""
        now = time.monotonic()
        if not any(r.deadline is not None and now >= r.deadline for r in batch):
            return batch
        from .errors import SearchTimeout

        live = []
        n_expired = 0
        for r in batch:
            if r.deadline is not None and now >= r.deadline:
                r.state = _PendingSearch.ABANDONED
                r.snapshot = None
                r.error = SearchTimeout("search deadline expired while batched")
                r.done.set()
                n_expired += 1
            else:
                live.append(r)
        self.abandoned_prelaunch += n_expired
        try:
            from ..server import metrics

            metrics.inc_searches_abandoned(n_expired)
        except Exception:  # noqa: BLE001 — metrics never fail the op
            pass
        return live

    def _claim_locked(self, key=None, space=MAX_BATCH) -> List[_PendingSearch]:
        """Pop up to `space` same-group requests (group of the queue head
        when `key` is None).  Abandoned requests are dropped on the floor."""
        batch: List[_PendingSearch] = []
        keep = []
        for req in self._pending:
            if req.state == _PendingSearch.ABANDONED:
                continue
            if len(batch) < space and (key is None or req.key == key):
                if key is None:
                    key = req.key
                req.state = _PendingSearch.CLAIMED
                batch.append(req)
            else:
                keep.append(req)
        self._pending = keep
        return batch

    def _dispatch_loop(self) -> None:
        while True:
            with self._qcond:
                while not self._pending and not self._stopping:
                    self._qcond.wait()
                if self._stopping:
                    for r in self._pending:
                        if r.state == _PendingSearch.PENDING:
                            r.error = RuntimeError("searcher closed")
                            r.done.set()
                    self._pending = []
                    # Last act: release the collectors.  Enqueued HERE (not
                    # in close()) so FIFO puts the sentinels after the final
                    # launched batch even when close() stops waiting early.
                    for _ in range(self.COLLECTORS):
                        self._collect_q.put(None)
                    return
                batch = self._claim_locked()
                busy = bool(self._pending) or self._inflight > 0
            if not batch:
                continue
            key = batch[0].key
            # Coalesce: under load (device busy or other groups queued) wait
            # a moment for the batch to fill; solo traffic launches at once.
            if len(batch) < MAX_BATCH and busy:
                t_end = time.monotonic() + self.max_wait
                while len(batch) < MAX_BATCH and time.monotonic() < t_end:
                    time.sleep(0.0002)
                    with self._qlock:
                        batch.extend(self._claim_locked(key, MAX_BATCH - len(batch)))
            # Bound the device queue; while blocked here more requests pile
            # up, so top the batch off after acquiring a slot (batches size
            # themselves to the arrival rate when the pipe is full).
            self._inflight_sem.acquire()
            with self._qlock:
                batch.extend(self._claim_locked(key, MAX_BATCH - len(batch)))
                self._inflight += 1
            # Purge members already past their absolute deadline: launching
            # them spends device time and an in-flight slot on work nobody
            # can consume.  The reference's timeout cancels a RUNNING scan
            # at per-hash yields (MultiIndex.zig:311-316, zio.maybeYield);
            # our kernel is one bounded launch, so the last cancellation
            # point is here, just before dispatch.  Under deadline pressure
            # (e.g. a cold-compile stall backing the queue up) whole batches
            # expire and the launch is skipped entirely.
            batch = self._purge_expired(batch)
            if not batch:
                with self._qlock:
                    self._inflight -= 1
                self._inflight_sem.release()
                self.launches_skipped += 1
                try:
                    from ..server import metrics

                    metrics.inc_search_launches_skipped()
                except Exception:  # noqa: BLE001 — metrics never fail the op
                    pass
                continue
            snapshot = batch[0].snapshot
            params, b = self._pick_program(snapshot, key, len(batch))
            if b < len(batch):
                # Exact bucket is cold but a smaller one is warm: serve the
                # head at the warm size NOW (chunks pipeline back-to-back
                # with no compile stall) and requeue the tail — the exact
                # bucket is already compiling in the background.
                now = time.monotonic()
                with self._qcond:
                    for r in reversed(batch[b:]):
                        if r.deadline is not None and now >= r.deadline:
                            # The caller may have seen CLAIMED and committed
                            # to the long wait — resolve, don't re-strand.
                            from .errors import SearchTimeout

                            r.state = _PendingSearch.ABANDONED
                            r.snapshot = None
                            r.error = SearchTimeout("search deadline expired while batched")
                            r.done.set()
                            continue
                        r.state = _PendingSearch.PENDING
                        self._pending.insert(0, r)
                    self._qcond.notify()
                batch = batch[:b]
            try:
                from ..utils.profiling import trace

                with trace(f"search_dispatch[{len(batch)}/{b}]"):
                    handle = self._launch(
                        snapshot,
                        params,
                        self._pack_rows_rebucketed(
                            params, key[2], [r.padded for r in batch], b
                        ),
                    )
                self._warm.add(self._shape_key(snapshot, params, b))
            except Exception as exc:  # noqa: BLE001 — propagated per-request
                with self._qlock:
                    self._inflight -= 1
                self._inflight_sem.release()
                for r in batch:
                    r.error = exc
                    r.done.set()
                continue
            self._collect_q.put((handle, params, batch))

    def _shape_key(self, snapshot, params: SearchParams, b: int):
        """Everything the compiled program's identity depends on: static
        params, batch bucket, and the (bucketed) view array shapes.  Views
        are immutable and carry a process-unique `view_token` (see
        engine/segments.py), so the shape tuple is cached by token — unique
        forever, so no id-recycling hazard, and the cache never holds the
        view itself (a strong reference would pin superseded device buffers
        in HBM past their last reader)."""
        cache = self._shape_cache

        def shapes(view):
            tok = view.get("view_token")
            if tok is not None:
                got = cache.get(tok)
                if got is not None:
                    return got
            shp = tuple(
                sorted(
                    (k, tuple(getattr(v, "shape", ())))
                    for k, v in view.items()
                    if k not in ("view_token", "owner")
                )
            )
            if tok is not None:
                if len(cache) >= 64:
                    cache.clear()
                cache[tok] = shp
            return shp

        return (params, b, shapes(snapshot.file_view), shapes(snapshot.mem_view))

    def _queue_precompile(self, snapshot, params: SearchParams, b: int, key) -> None:
        if key in self._precompiling:
            return
        import weakref

        if self._precompile_q is None:
            # Callers outside the dispatch pipeline (the native front's
            # pumps) can reach here before any submit() started the
            # threads — start them so the background precompile runs.
            with self._qcond:
                self._ensure_threads_locked()
        self._precompiling.add(key)
        # Weakref: a minutes-long background compile must not pin a
        # superseded snapshot's device buffers in HBM.
        self._precompile_q.put((weakref.ref(snapshot), params, b, key))

    def _pick_batch_size(self, snapshot, params: SearchParams, n: int) -> int:
        """The exact bucket if its program is warm (or nothing is warm at
        all, the true cold start — compile inline).  Otherwise avoid
        stalling the dispatcher on a compile: the smallest warm bucket that
        fits, or — when only smaller buckets are warm — the largest warm
        one (the caller splits the batch into warm-sized chunks).  Either
        way the exact bucket goes to the background precompiler."""
        b_exact = next(x for x in BATCH_SIZES if x >= n)
        key_exact = self._shape_key(snapshot, params, b_exact)
        if key_exact in self._warm:
            return b_exact
        warm = [b for b in BATCH_SIZES if self._shape_key(snapshot, params, b) in self._warm]
        if not warm:
            return b_exact  # nothing warm at all: compile inline
        self._queue_precompile(snapshot, params, b_exact, key_exact)
        fitting = [b for b in warm if b >= n]
        return fitting[0] if fitting else warm[-1]

    def _pick_program(self, snapshot, key, n: int):
        """(params, batch size) to serve a claimed batch with NO inline
        compile whenever anything compatible is warm.

        The exact query/out bucket first (the _pick_batch_size ladder).  If
        the whole bucket is COLD — the reference never fails a search on a
        warm index (MultiIndex.zig:287-330), but a fresh query-length
        bucket here used to stall the dispatcher for a full compile and
        503 everything behind it — a warm SUPERSET bucket (query bucket
        large enough to hold the queries, out bucket at least as wide)
        serves the batch NOW: queries pad with zeros beyond q_len (masked
        by the kernel), budgets/caps only grow with the bucket so results
        are identical-or-less-truncated, and _await reads out_len from the
        row width.  The exact program still compiles in the background.
        Inline compile remains only for the true cold start (fresh process
        AND no persistent-cache hit AND nothing warm)."""
        params = _params_for(key[2], key[3])
        b_exact = next(x for x in BATCH_SIZES if x >= n)
        if self._shape_key(snapshot, params, b_exact) in self._warm:
            return params, b_exact
        warm = [b for b in BATCH_SIZES if self._shape_key(snapshot, params, b) in self._warm]
        if warm:
            self._queue_precompile(
                snapshot, params, b_exact, self._shape_key(snapshot, params, b_exact)
            )
            fitting = [b for b in warm if b >= n]
            return params, (fitting[0] if fitting else warm[-1])
        for qb in QUERY_BUCKETS:
            if qb < key[2]:
                continue
            for ob in OUT_BUCKETS:
                if ob < key[3] or (qb == key[2] and ob == key[3]):
                    continue
                sp = _params_for(qb, ob)
                warm2 = [
                    b for b in BATCH_SIZES if self._shape_key(snapshot, sp, b) in self._warm
                ]
                if warm2:
                    self._queue_precompile(
                        snapshot, params, b_exact, self._shape_key(snapshot, params, b_exact)
                    )
                    fitting = [b for b in warm2 if b >= n]
                    return sp, (fitting[0] if fitting else warm2[-1])
        return params, b_exact  # true cold start: compile inline

    def warm_async(self, snapshot) -> None:
        """Background-compile the default serving program (the ~120-hash
        bucket at b=1) for this snapshot's view shapes if it is cold.

        The engine calls this on every snapshot install: without it the
        first search after a shape change pays the whole compile inline
        (seconds to minutes) and every request
        queued behind it hits its deadline — the reference has no compile
        concept, so the analogous operational bar is "a freshly written
        index serves as soon as possible", and starting the compile at
        WRITE time instead of first-search time is the cheap half of that.
        Sticky high-water view shapes (see _pack_sticky) make this one
        compile per converged shape set, not one per write; the
        precompiler holds only a weakref, so a superseded snapshot is
        never pinned."""
        if not isinstance(snapshot.file_view, dict) or not isinstance(snapshot.mem_view, dict):
            return  # empty index, or a deferred (PENDING_VIEW) bulk view
        import weakref

        with self._qcond:
            if self._stopping:
                return
            self._ensure_threads_locked()
            # These views ARE the owner's latest (a swap precedes the call);
            # without this a write-then-no-search flow would look superseded
            # to the precompiler's staleness check and be skipped.
            self._latest_group[snapshot.file_view.get("owner")] = (
                snapshot.file_view.get("view_token", id(snapshot.file_view)),
                snapshot.mem_view.get("view_token", id(snapshot.mem_view)),
            )
        # 128 first (the real-fingerprint bucket), then 256: once the 256
        # program is warm it SUPERSETS every fingerprint-sized bucket, so a
        # first query on any cold bucket serves through it (_pick_program)
        # instead of 503ing behind an inline compile.
        #
        # Dedupe on _warm only, NOT on _precompiling: a queued item for the
        # same shape may hold a weakref to a snapshot this very swap just
        # superseded — the loop will skip it dead, and deduping against it
        # would leave the shape cold forever.  This item carries its own
        # (live) snapshot; the loop re-checks _warm before launching, so a
        # burst of swaps at one shape costs one compile + fast skips.
        for bucket in (QUERY_BUCKETS[1], QUERY_BUCKETS[2]):
            params = _params_for(bucket)
            key = self._shape_key(snapshot, params, 1)
            if key in self._warm:
                continue
            self._precompiling.add(key)
            self._precompile_q.put((weakref.ref(snapshot), params, 1, key))

    def _precompile_loop(self) -> None:
        """Compiles exact batch buckets off the dispatch path.  The dummy
        launch's result is never fetched; its device time is one wasted
        micro-batch, its compile fills the process + persistent XLA caches."""
        while True:
            item = self._precompile_q.get()
            if item is None:
                return
            snapshot_ref, params, b, key = item
            try:
                if key in self._warm:
                    continue  # a sibling item already warmed this shape
                snapshot = snapshot_ref()
                if snapshot is None or snapshot.file_view is None:
                    continue  # snapshot superseded and collected: moot
                group = (
                    snapshot.file_view.get("view_token"),
                    snapshot.mem_view.get("view_token"),
                )
                latest = self._latest_group.get(snapshot.file_view.get("owner"))
                if group[0] is not None and latest not in (None, group):
                    continue  # views superseded: don't pin them through a compile
                req = (np.zeros(params.query_len, np.uint32), 1, SearchOptions())
                self._launch(snapshot, params, self._pack_batch(params, [req] * b, b))
                self._warm.add(key)
            except Exception:  # noqa: BLE001 — precompile is best-effort
                pass
            finally:
                self._precompiling.discard(key)

    def _collect_loop(self) -> None:
        import jax

        while True:
            item = self._collect_q.get()
            if item is None:
                return
            handle, params, batch = item
            try:
                packed = np.asarray(jax.device_get(handle))
                now = time.monotonic()
                for i, req in enumerate(batch):
                    if req.deadline is not None and now >= req.deadline:
                        # The batch landed past this request's absolute
                        # deadline (it was stuck behind a cold compile):
                        # resolve as a timeout, matching what _await already
                        # told the caller — never serve results late.
                        from .errors import SearchTimeout

                        req.error = SearchTimeout("search deadline expired while batched")
                    else:
                        # Hand out the packed ROW view; the waiting caller's
                        # thread parses it (_materialize_row), keeping the
                        # collector's per-request work to a slice + set().
                        req.row = packed[i]
                    req.snapshot = None
                    req.done.set()
            except Exception as exc:  # noqa: BLE001 — propagated per-request
                for req in batch:
                    req.error = exc
                    req.done.set()
            finally:
                with self._qlock:
                    self._inflight -= 1
                self._inflight_sem.release()

    # ---- batch execution ----

    @staticmethod
    def _pack_rows(params: SearchParams, rows, b: int):
        """Pre-built (Q+4) request rows -> ONE packed (b, Q+4) u32 input
        array.  The serving hot path: submit() builds each row in the
        submitting thread, so the single dispatcher's only per-batch work
        is this stack."""
        n = len(rows)
        Q = params.query_len
        packed = np.zeros((b, Q + 4), np.uint32)
        packed[:, Q + 1] = 1  # limit >= 1 for padding rows
        if n:
            packed[:n] = rows if n > 1 else rows[0]
        return packed

    @staticmethod
    def _pack_rows_rebucketed(params: SearchParams, bucket_from: int, rows, b: int):
        """_pack_rows, re-padding (bucket_from+4) request rows into a LARGER
        query bucket's row width (the superset-serving path: queries keep
        their leading position, the len/limit/min_score/pct tail moves to
        the wider row's tail; the zero padding in between is masked by the
        kernel's q_len check)."""
        if params.query_len == bucket_from:
            return BatchingSearcher._pack_rows(params, rows, b)
        Qf, Qt = bucket_from, params.query_len
        packed = np.zeros((b, Qt + 4), np.uint32)
        packed[:, Qt + 1] = 1  # limit >= 1 for padding rows
        for i, r in enumerate(rows):
            packed[i, :Qf] = r[:Qf]
            packed[i, Qt:] = r[Qf:]
        return packed

    @staticmethod
    def _pack_batch(params: SearchParams, requests, b: Optional[int] = None):
        """(padded, q_len, options) tuples -> ONE packed (b, Q+4) u32 input
        array (each host->device array costs a transfer of its own — see
        ops.search_kernel.pack_inputs_np).  Warmup/
        precompile path; serving uses _pack_rows."""
        n = len(requests)
        if b is None:
            b = next(x for x in BATCH_SIZES if x >= n)
        Q = params.query_len
        packed = np.zeros((b, Q + 4), np.uint32)
        packed[:, Q + 1] = 1  # limit >= 1 for padding rows
        if n:
            packed[:n, :Q] = np.stack([r[0][:Q] for r in requests])
            packed[:n, Q:] = np.array(
                [
                    (q_len, o.max_results, o.min_score, o.min_score_pct)
                    for _, q_len, o in requests
                ],
                dtype=np.uint32,
            )
        return packed

    def _launch(self, snapshot, params: SearchParams, packed_in):
        """Launch the batched program; returns the device handle of the ONE
        packed output array.  Overridden by the mesh-sharded searcher."""
        from ..ops.search_kernel import search_segments_batch_packed_io

        return search_segments_batch_packed_io(
            params,
            tier_view_for_search(snapshot.file_view, mentions=False),
            tier_view_for_search(snapshot.mem_view),
            packed_in,
        )

    def _run_batch_traced(self, snapshot, params, requests):
        """Synchronous pack + launch + fetch (warmup / tests)."""
        import jax

        from ..ops.search_kernel import unpack_outputs_np

        b = next(x for x in BATCH_SIZES if x >= len(requests))
        packed = np.asarray(
            jax.device_get(self._launch(snapshot, params, self._pack_batch(params, requests, b)))
        )
        self._warm.add(self._shape_key(snapshot, params, b))
        out = unpack_outputs_np(packed, params.out_len)
        return [
            self._materialize({k: v[i] for k, v in out.items()}) for i in range(len(requests))
        ]

    def warm(
        self,
        snapshot: Snapshot,
        q_buckets: Sequence[int] = (64, 128, 256),
        batch_sizes: Sequence[int] = (1, 16, 256),
        out_bucket: int = 128,
    ) -> None:
        """Precompile the batch programs live traffic will hit (the
        persistent XLA cache makes later processes near-instant).  Intended
        for a background warmup thread at startup."""
        if snapshot.file_view is None or snapshot.mem_view is None:
            return
        from .model import SearchOptions

        options = SearchOptions()
        for qb in q_buckets:
            padded = np.zeros(qb, np.uint32)
            padded[:3] = (1, 2, 3)
            req = (padded, 3, options)
            params = _params_for(qb, out_bucket)
            for b in batch_sizes:
                self._run_batch_traced(snapshot, params, [req] * min(b, MAX_BATCH))

    @staticmethod
    def _materialize(out):
        n = int(out["count"])
        results = [
            SearchResult(id=int(out["ids"][i]), score=int(out["scores"][i])) for i in range(n)
        ]
        stats = SearchStats(
            postings_scanned=int(out["postings_scanned"]),
            truncated=bool(out["truncated"]),
            max_per_hash=int(out.get("max_per_hash", 0)),
            max_blocks_per_hash=int(out.get("max_blocks_per_hash", 0)),
        )
        return results, stats

    @staticmethod
    def _materialize_row(row, out_len: int):
        """Parse one packed output row (see ops.search_kernel.pack_outputs:
        ids | scores | count | postings_scanned | truncated | max_per_hash
        | max_blocks_per_hash) in the caller's thread."""
        n = int(row[2 * out_len])
        results = [
            SearchResult(id=int(row[i]), score=int(row[out_len + i])) for i in range(n)
        ]
        stats = SearchStats(
            postings_scanned=int(row[2 * out_len + 1]),
            truncated=bool(row[2 * out_len + 2]),
            max_per_hash=int(row[2 * out_len + 3]),
            max_blocks_per_hash=int(row[2 * out_len + 4]),
        )
        return results, stats


_default_searcher: Optional[Searcher] = None
_default_lock = threading.Lock()


def default_searcher() -> Searcher:
    global _default_searcher
    with _default_lock:
        if _default_searcher is None:
            # Exit-time draining of the pipeline daemons is registered by
            # _ensure_threads_locked (per instance, when threads start).
            _default_searcher = BatchingSearcher()
        return _default_searcher
