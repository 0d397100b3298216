"""Hash-range sharded search over a device mesh.

The reference is a single-node design (the whole index must fit in RAM,
/root/reference/README.md:100-105); its only multi-node mechanism is full
replication.  This module adds the scale-out axis the reference lacks:

  * postings are sharded by HASH RANGE across the mesh — uniform fingerprint
    hashes give balanced shards, and every query hash has exactly one home
    shard;
  * mentioned-docs tables are sharded by DOCID RANGE — supersession lookups
    for a candidate doc also have one home shard;
  * a query broadcasts to all shards; each shard gathers its hit postings
    locally; the (docid, segment-ordinal) hit lists are all-gathered (a few
    hundred KB; NCCL over NVLink on GPUs) and scored identically on every
    shard — bitwise
    the same pipeline as the single-chip kernel, so scores are EXACT;
  * supersession mention masks combine with a psum (integer OR) across the
    docid shards.

Everything runs inside one jitted shard_map over a 1-D "shards" mesh axis
(every card reaches every other at the same rate, so the mesh has no
torus shape).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.search_kernel import (
    F_DIRECT,
    P_MEM_DIRECT,
    P_SMALL,
    SENTINEL,
    TIER_MEM,
    SearchParams,
    _batch_newest,
    _batch_ranges,
    _direct_candidates,
    _final_select,
    _final_select_matrix,
    _plan_and_gather,
    _score_matrix,
    _score_rank,
    small_budget,
)
from ..ops.layout import BLOCK
from ..engine.memseg import Segment
from ..engine.segments import Snapshot

AXIS = "shards"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.array(devices[:n]), (AXIS,))


from ..engine.segments import _bucket as _bucket_impl


def _bucket(n: int, minimum: int = 1024) -> int:
    return _bucket_impl(n, minimum)


def hash_bounds(n_shards: int) -> np.ndarray:
    """Shard k owns hashes in [bounds[k], bounds[k+1])."""
    return np.array([(k * (1 << 32)) // n_shards for k in range(n_shards + 1)], dtype=np.uint64)


@dataclass
class ShardedView:
    """Stacked per-shard packed tiers: every array carries a leading shard
    dimension and is placed with that dimension sharded over the mesh."""

    file_tier: Dict[str, jax.Array]
    mem_tier: Dict[str, jax.Array]
    n_shards: int


def _pack_tier_sharded(
    segments: Sequence[Segment],
    n_shards: int,
    slots: int,
    min_cap: int = 1024,
    min_caps: Optional[Tuple[int, int, int]] = None,
) -> Dict[str, np.ndarray]:
    """Partition each segment's postings by hash range and docs by docid
    range; pack per shard (slot k = ordinal k, same as pack_tier).

    Pack-time supersession filtering happens GLOBALLY before partitioning
    (exactly pack_tier's rule: a posting survives iff no newer segment of
    the tier mentions its doc) — the packer holds the full segment set, so
    a shard's comb never contains postings another shard's mention entry
    would have killed.  Mention tables stay membership-only."""
    from ..engine.segments import filter_superseded

    bounds = hash_bounds(n_shards)
    per_shard_items: List[List[np.ndarray]] = [[] for _ in range(n_shards)]
    per_shard_ids: List[List[np.ndarray]] = [[] for _ in range(n_shards)]
    per_shard_docs: List[List[np.ndarray]] = [[] for _ in range(n_shards)]
    per_shard_alive: List[List[np.ndarray]] = [[] for _ in range(n_shards)]

    if len(segments) > slots:
        raise ValueError(f"too many segments for tier: {len(segments)} > {slots}")

    live_items = filter_superseded(segments)
    for s_idx, seg in enumerate(segments):
        hashes, docids = live_items[s_idx]
        h64 = hashes.astype(np.uint64)
        cuts = np.searchsorted(h64, bounds)
        d64 = seg.docs_ids.astype(np.uint64)
        dcuts = np.searchsorted(d64, bounds)
        for k in range(n_shards):
            per_shard_items[k].append(hashes[cuts[k] : cuts[k + 1]])
            per_shard_ids[k].append(docids[cuts[k] : cuts[k + 1]])
            per_shard_docs[k].append(seg.docs_ids[dcuts[k] : dcuts[k + 1]])
            per_shard_alive[k].append(seg.docs_alive[dcuts[k] : dcuts[k + 1]].astype(np.int32))

    cmin, dmin, mmin = min_caps or (min_cap, min_cap, min_cap)
    dcap = _bucket(max((sum(a.shape[0] for a in chunks) for chunks in per_shard_docs), default=1), dmin)

    # Per-shard merged mention MEMBERSHIP table (unique sorted docids).
    mention = []
    for k in range(n_shards):
        ids_k = np.concatenate(per_shard_docs[k]) if per_shard_docs[k] else np.empty(0, np.uint32)
        ids_k = np.unique(ids_k)
        mention.append(ids_k)
    mcap = _bucket(max((m.shape[0] for m in mention), default=1), mmin)

    # Each shard packs its hash range as ONE merged sorted run (the
    # pack-time-filtered comb layout, engine/segments.py pack_tier): the
    # range phase is then S-independent per shard and no ordinal column
    # exists — within-tier supersession was resolved above.
    def total(chunks):
        return sum(a.shape[0] for a in chunks)

    cap = _bucket(
        max((-(-total(chunks) // BLOCK) * BLOCK for chunks in per_shard_items), default=1),
        max(cmin, BLOCK),
    )

    S = slots
    out = {
        "hashes": np.full((n_shards, cap), 0xFFFFFFFF, np.uint32),
        "docids": np.full((n_shards, cap), 0xFFFFFFFF, np.uint32),
        "seg_start": np.zeros((n_shards, S), np.int32),
        "seg_len": np.zeros((n_shards, S), np.int32),
        "docs_ids": np.full((n_shards, dcap), 0xFFFFFFFF, np.uint32),
        "docs_alive": np.zeros((n_shards, dcap), np.int32),
        "docs_start": np.zeros((n_shards, S), np.int32),
        "docs_len": np.zeros((n_shards, S), np.int32),
        "mention_ids": np.full((n_shards, mcap), 0xFFFFFFFF, np.uint32),
        "mention_len": np.zeros((n_shards,), np.int32),
        "block_index": np.full((n_shards, cap // BLOCK), 0xFFFFFFFF, np.uint32),
    }
    for k, mi in enumerate(mention):
        out["mention_ids"][k, : mi.shape[0]] = mi
        out["mention_len"][k] = mi.shape[0]
    for k in range(n_shards):
        pos = 0
        for s_idx, a in enumerate(per_shard_items[k]):
            out["seg_start"][k, s_idx] = pos
            out["seg_len"][k, s_idx] = a.shape[0]
            pos += a.shape[0]
        chunks_h = [a for a in per_shard_items[k] if a.shape[0]]
        if chunks_h:
            all_h = np.concatenate(per_shard_items[k])
            all_d = np.concatenate(per_shard_ids[k])
            if len(chunks_h) > 1:
                order = np.argsort(all_h, kind="stable")  # ties stay segment-asc
                all_h, all_d = all_h[order], all_d[order]
            out["hashes"][k, : all_h.shape[0]] = all_h
            out["docids"][k, : all_d.shape[0]] = all_d
        dpos = 0
        for s_idx, a in enumerate(per_shard_docs[k]):
            out["docs_start"][k, s_idx] = dpos
            out["docs_len"][k, s_idx] = a.shape[0]
            out["docs_ids"][k, dpos : dpos + a.shape[0]] = a
            out["docs_alive"][k, dpos : dpos + a.shape[0]] = per_shard_alive[k][s_idx]
            dpos += a.shape[0]
        out["block_index"][k] = out["hashes"][k, ::BLOCK]

    # Per-shard interleave decision mirrors pack_tier: the per-shard slice
    # is what each device's blocked range path actually scans.
    from ..ops.layout import interleave_np, use_interleaved

    if use_interleaved(cap):
        inter = np.empty((n_shards, 2 * cap), np.uint32)
        for k in range(n_shards):
            inter[k] = interleave_np(out["hashes"][k], out["docids"][k])
        out["inter"] = inter
        del out["hashes"], out["docids"]

    # Device SEARCH fields ship FLAT (n_shards * X,) so shard_map's P(AXIS)
    # split hands every shard a (X,) local in exactly the kernel's shape —
    # a leading (1, X) dim instead can cost a materialized reshape copy of
    # the whole operand per batch.  mention_len stays (n_shards,)
    # (per-shard scalar).  docs_* bookkeeping stays host-side 2D numpy, as
    # in pack_tier — no kernel reads it.
    for k in SHARDED_DEVICE_FIELDS:
        if k in out and k != "mention_len":
            out[k] = np.ascontiguousarray(out[k]).reshape(-1)
    return out


# Fields the sharded search program reads on device (flat 1D, P(AXIS)
# over the leading per-shard blocks); everything else in a packed tier dict
# is host-side bookkeeping and must NOT be passed into the jitted program.
SHARDED_DEVICE_FIELDS = (
    "hashes",
    "docids",
    "inter",
    "block_index",
    "seg_start",
    "seg_len",
    "mention_ids",
    "mention_len",
)


def _device_fields(tier: Dict) -> Dict:
    return {k: tier[k] for k in SHARDED_DEVICE_FIELDS if k in tier}


def put_sharded(tier_np: Dict, mesh: Mesh) -> Dict:
    """Device-place a packed sharded tier: search fields go on the mesh
    (P(AXIS) over the flat per-shard blocks), docs_* bookkeeping stays
    host-side numpy."""
    sharding = jax.sharding.NamedSharding(mesh, P(AXIS))
    return {
        k: (jax.device_put(v, sharding) if k in SHARDED_DEVICE_FIELDS else v)
        for k, v in tier_np.items()
    }


def build_sharded_view(
    snapshot: Snapshot,
    mesh: Mesh,
    file_slots: int = 16,
    mem_slots: int = 8,
    min_cap: int = 1024,
) -> ShardedView:
    n = mesh.devices.size
    file_np = _pack_tier_sharded(snapshot.file, n, file_slots, min_cap)
    mem_np = _pack_tier_sharded(snapshot.memory, n, mem_slots, min_cap)
    return ShardedView(
        file_tier=put_sharded(file_np, mesh),
        mem_tier=put_sharded(mem_np, mesh),
        n_shards=n,
    )


def search_tiers(view: ShardedView) -> Tuple[Dict, Dict]:
    """The (file, mem) device-field subsets to pass into
    sharded_search_batch.  The file tier's mention table is not consulted
    by the kernel (supersession only asks the MEMORY tier) so it is
    dropped, mirroring tier_view_for_search(..., mentions=False)."""
    f = {k: v for k, v in _device_fields(view.file_tier).items() if not k.startswith("mention")}
    return f, _device_fields(view.mem_tier)


def _tier_spec(tier) -> Dict[str, P]:
    return {k: P(AXIS) for k in tier}


def _local_tier(tier: Dict) -> Dict:
    """Inside shard_map: the flat device fields already arrive in the
    kernel's per-shard shapes; only the per-shard scalar mention_len
    ((1,) local) needs indexing."""
    return {k: (v[0] if k == "mention_len" else v) for k, v in tier.items()}


MATRIX_MAX = 1024  # widest combined stream scored sort-free (see below)


@functools.partial(jax.jit, static_argnums=(0, 1))
def sharded_search_batch(params: SearchParams, mesh: Mesh, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts):
    """(B, Q) batched hash-range-sharded search — the serving path.

    Per shard: one range phase for the whole batch (blocked lookup on big
    shards), local candidate extraction, then the per-query hit lists
    all-gather (a few hundred KB per shard) and every shard scores
    the combined stream identically — bitwise the same scoring pipeline as
    the single-chip kernel, so scores are EXACT.  Supersession runs once for
    the whole batch's candidate stream against the local docid-range mention
    shard and pmaxes across shards.

    The shard body mirrors the single-chip cascade
    (search_kernel._search_batch_impl) stage for stage — the round-3 sharded
    program only had the plan+gather -> sort pipeline and ran ~12x slower
    than the single-chip program at mesh-1:

      * DIRECT path: each shard's emitting blocked lookup yields the landing
        rows; candidates come straight out of them (no per-posting HBM
        gathers), the per-shard streams all_gather, and the combined stream
        scores sort-free via the equality matrix.  A query hash lives on
        exactly ONE hash-range shard (zero counts elsewhere), so the union
        of per-shard direct streams is exactly the single-chip stream.
      * SMALL path: plan+gather at P_SMALL per shard, all_gather, matrix
        scoring when the combined width fits MATRIX_MAX, else the sort path.
      * FULL path: plan+gather at the full budget + sort scoring.

    Every runtime predicate that guards a collective is made GLOBAL with a
    pmax (collectives inside lax.cond branches require a replicated
    predicate).  The one shard-local predicate is _batch_newest's mention
    gate, whose branch holds no collective (see its docstring)."""

    def shard_fn(file_t, mem_t, queries, q_lens, limits, min_scores, pcts):
        import dataclasses

        # Flat per-shard locals arrive in the kernel's shapes (see
        # _pack_tier_sharded) — no squeeze, no reshape copies.
        f_search = _local_tier(file_t)
        m_search = _local_tier(mem_t)

        B = queries.shape[0]
        n_dev = mesh.devices.size

        # Local hit-lists over this shard's hash range, whole batch at once.
        # The emitting variant powers the direct path (landing-block docid
        # rows ride along for free).
        want_emit = "inter" in f_search and params.query_len <= 256
        emit_info = None
        if want_emit:
            f_lo, f_cnt, m_lo, m_cnt, r_trunc, emit_info = _batch_ranges(
                params, f_search, m_search, queries, q_lens, want_emit=True
            )
        else:
            f_lo, f_cnt, m_lo, m_cnt, r_trunc = _batch_ranges(
                params, f_search, m_search, queries, q_lens
            )

        # Global predicates (see docstring).  has_mem is the per-BATCH test
        # (any queried hash holds a memory-tier posting on any shard) — the
        # same sharpening as the single-chip program (_search_batch_impl);
        # pmax keeps the cond globally consistent, which the collectives
        # inside the branches (all_gather / combined_newest's pmax) require.
        # Supersession is NOT gated by it: _batch_newest runs under
        # mem_mentions_any with its own local mention-range gate.
        has_mem = jax.lax.pmax(jnp.sum(m_cnt), AXIS) > 0
        mem_mentions_any = jax.lax.pmax(m_search["mention_len"], AXIS) > 0

        def combined_newest(d_flat, mask_flat):
            # Supersession: within-tier supersession was resolved at pack
            # time, so all that's left is "does the MEMORY tier mention this
            # doc".  Each candidate doc lives in exactly one docid-range
            # shard; the mention lookup answers locally, pmax combines.
            local = _batch_newest(m_search, d_flat, mask_flat, mem_mentions_any)
            return jax.lax.pmax(local, AXIS)

        def select_matrix(d_all, o_all, inv_all, totals, overs):
            """Stages 3-7 sort-free on the combined stream: equality-matrix
            scoring (no candidate cap at all) + comparison-count ranking —
            the same exactness-pinned pipeline as the single-chip matrix
            path (_score_matrix/_final_select_matrix)."""
            win, score, cand = jax.vmap(
                lambda d1, o1, i1, ms: _score_matrix(params, d1, o1, i1, ms)
            )(d_all, o_all, inv_all, min_scores)
            newest = combined_newest(
                d_all.reshape(-1), cand.reshape(-1)
            ).reshape(d_all.shape)
            out = jax.vmap(
                lambda d1, s1, w1, c1, n1, l1, ms1, p1: _final_select_matrix(
                    params, d1, s1, w1, c1, n1, l1, ms1, p1
                )
            )(d_all, score, win, cand, newest, limits, min_scores, pcts)
            return out, totals, overs

        def select_sorted(p_eff, d_all, o_all, inv_all, totals, overs):
            """Stages 3-7 via the sorting pipeline on the combined stream."""
            cd, co, csc, c_valid, c_over = jax.vmap(
                lambda d1, o1, i1, ms: _score_rank(p_eff, d1, o1, i1, ms)
            )(d_all, o_all, inv_all, min_scores)
            newest = combined_newest(
                cd.reshape(-1), c_valid.reshape(-1)
            ).reshape(cd.shape)
            out = jax.vmap(lambda *a: _final_select(params, *a))(
                cd, co, csc, c_valid, newest, limits, min_scores, pcts
            )
            return out, totals, jnp.logical_or(overs, c_over)

        def select_any(p_eff, d_all, o_all, inv_all, totals, overs):
            # Static width decision: the (W, W) equality matrix wins while
            # the combined stream stays narrow; wide streams (big meshes at
            # the full budget) sort instead.
            if d_all.shape[1] <= MATRIX_MAX:
                return select_matrix(d_all, o_all, inv_all, totals, overs)
            return select_sorted(p_eff, d_all, o_all, inv_all, totals, overs)

        def gather_path(p_eff):
            """Per-shard plan+gather at budget p_eff, exact cross-shard
            combine (concatenate every shard's hit list along the postings
            axis — a hash's postings live on one shard, so the combined
            stream is exactly the single-chip stream of the union)."""

            def branch(use_mem):
                def inner(_):
                    def plan_one(f_lo1, f_cnt1, m_lo1, m_cnt1):
                        return _plan_and_gather(
                            p_eff, f_search, m_search, f_lo1, f_cnt1, m_lo1, m_cnt1,
                            use_mem=use_mem,
                        )

                    d, o, inv, totals, overs = jax.vmap(plan_one)(f_lo, f_cnt, m_lo, m_cnt)
                    d_all = jax.lax.all_gather(d, AXIS, axis=1, tiled=True)
                    o_all = jax.lax.all_gather(o, AXIS, axis=1, tiled=True)
                    inv_all = jax.lax.all_gather(inv, AXIS, axis=1, tiled=True)
                    return select_any(p_eff, d_all, o_all, inv_all, totals, overs)

                return inner

            return jax.lax.cond(has_mem, branch(True), branch(False), None)

        # candidate_cap bound is INTENTIONALLY n_dev*P_SMALL (not the
        # single-chip P_SMALL): the sorted ranker's top-C slice must fit the
        # all_gather'd union of every shard's P_SMALL-budget hit list (the
        # matrix ranker has no cap, but the small path may select either).
        small_ok = params.postings_budget > P_SMALL and params.candidate_cap <= n_dev * P_SMALL
        if small_ok:
            p_small, totals_rough = small_budget(params, f_cnt, m_cnt, B)
            small = jax.lax.pmax(jnp.max(totals_rough), AXIS) <= P_SMALL

            def base_path(_):
                return jax.lax.cond(
                    small,
                    lambda _: gather_path(p_small),
                    lambda _: gather_path(params),
                    None,
                )
        else:
            def base_path(_):
                return gather_path(params)

        if emit_info is not None:
            # Direct path: gather-free file-tier candidates straight from
            # the emitted landing rows (search_kernel._direct_candidates),
            # engaged when every query's fallback remainder fits F_DIRECT on
            # every shard.  Memory-tier postings ride along through a
            # tiny-budget gather that self-skips when the tier is empty.
            rows, covered = emit_info
            E_direct = 2 if params.query_len <= 128 else 1
            ov_tot = jnp.sum(
                jnp.maximum(f_cnt - jnp.where(covered, E_direct, 0), 0), axis=1
            )
            m_tot = jnp.sum(m_cnt, axis=1)
            direct_ok = jnp.logical_and(
                jax.lax.pmax(jnp.max(ov_tot), AXIS) <= F_DIRECT,
                jax.lax.pmax(jnp.max(m_tot), AXIS) <= P_MEM_DIRECT,
            )

            # Hoisted out of the lax.cond so the emitted `rows` never cross
            # a conditional boundary (see search_kernel._search_batch_impl).
            d_f, inv_f, totals_f = _direct_candidates(
                params, f_search, rows, covered, f_lo, f_cnt, E_direct
            )

            def direct_path(_):
                p_mem = dataclasses.replace(params, postings_budget=P_MEM_DIRECT)

                def finish(d, o, inv, totals):
                    d_all = jax.lax.all_gather(d, AXIS, axis=1, tiled=True)
                    o_all = jax.lax.all_gather(o, AXIS, axis=1, tiled=True)
                    inv_all = jax.lax.all_gather(inv, AXIS, axis=1, tiled=True)
                    return select_any(
                        params, d_all, o_all, inv_all,
                        totals, jnp.zeros((B,), jnp.bool_),
                    )

                def wide(_):
                    # Mem-live batch (has_mem is the global per-batch test,
                    # so the gather runs unconditionally here).
                    def one(f_lo1, m_lo1, m_cnt1):
                        dm, _om, im, tot, _over = _plan_and_gather(
                            p_mem, f_search, m_search, f_lo1, jnp.zeros_like(m_cnt1),
                            m_lo1, m_cnt1, use_mem=True, use_file=False,
                        )
                        return dm, im, tot

                    d_m, inv_m, totals_m = jax.vmap(one)(f_lo, m_lo, m_cnt)
                    d = jnp.concatenate([d_f, d_m], axis=1)
                    inv = jnp.concatenate([inv_f, inv_m], axis=1)
                    o = jnp.concatenate(
                        [
                            jnp.zeros(d_f.shape, jnp.int32),
                            jnp.full(d_m.shape, TIER_MEM, jnp.int32),
                        ],
                        axis=1,
                    )
                    return finish(d, o, inv, totals_f + totals_m)

                def narrow(_):
                    # Mem-quiet batch: the P_MEM_DIRECT columns would be
                    # pure sentinels on every shard, so gather/score the
                    # file-only stream at its native width — the combined
                    # matrix width drops by n_dev*P_MEM_DIRECT (see the
                    # single-chip twin in search_kernel._search_batch_impl).
                    # pmax'd has_mem keeps all shards in the same branch,
                    # which the all_gathers require.
                    return finish(
                        d_f, jnp.zeros(d_f.shape, jnp.int32), inv_f, totals_f
                    )

                return jax.lax.cond(has_mem, wide, narrow, None)

            out, totals, overs = jax.lax.cond(direct_ok, direct_path, base_path, None)
        else:
            out, totals, overs = base_path(None)

        shard_trunc = jnp.logical_or(r_trunc, overs)  # (B,) per query
        out["postings_scanned"] = jax.lax.psum(totals, AXIS)
        out["truncated"] = jax.lax.psum(shard_trunc.astype(jnp.int32), AXIS) > 0
        # Per-hash scan skew: a hash lives on exactly ONE hash-range shard
        # (others count 0 for it), so pmax of the local per-query maxima is
        # the exact global max-per-hash.
        local_mph = jnp.max(f_cnt + m_cnt, axis=1).astype(jnp.int32)
        out["max_per_hash"] = jax.lax.pmax(local_mph, AXIS)
        # Blocks a hash's run spans (its postings live on ONE shard, so the
        # local block count IS the global one; pmax combines the maxima).
        def tier_blocks(lo, cnt):
            hi = lo + jnp.maximum(cnt, 1) - 1
            return jnp.where(cnt > 0, hi // BLOCK - lo // BLOCK + 1, 0)

        local_mbh = jnp.max(
            tier_blocks(f_lo, f_cnt) + tier_blocks(m_lo, m_cnt), axis=1
        ).astype(jnp.int32)
        out["max_blocks_per_hash"] = jax.lax.pmax(local_mbh, AXIS)
        return out

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(_tier_spec(file_tier), _tier_spec(mem_tier), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts)


def sharded_search(
    params: SearchParams,
    mesh: Mesh,
    view: ShardedView,
    query: np.ndarray,
    q_len: int,
    limit: int,
    min_score: int,
    pct: int,
):
    """Single-query wrapper over the batched program (tests / dryrun)."""
    f_t, m_t = search_tiers(view)
    out = sharded_search_batch(
        params,
        mesh,
        f_t,
        m_t,
        jnp.asarray(query, jnp.uint32)[None, :],
        jnp.full((1,), q_len, jnp.int32),
        jnp.full((1,), limit, jnp.int32),
        jnp.full((1,), min_score, jnp.int32),
        jnp.full((1,), pct, jnp.int32),
    )
    return {k: v[0] for k, v in out.items()}


@functools.partial(jax.jit, static_argnums=(0,))
def _sharded_ingest_impl(mesh: Mesh, hashes, ids, counts):
    """Per-shard device sort of an ingest batch: each shard receives the
    (hash, docid) pairs in its hash range (host-partitioned, padded) and
    sorts them into its term-table run — the device-side radix-sort stage of
    a distributed MemorySegment.build."""
    from ..ops.build import sort_postings

    def shard_fn(h, i, n):
        sh, si = sort_postings(h[0], i[0], n[0][0])
        return sh[None, :], si[None, :]

    sh, si = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS),
        check_vma=False,
    )(hashes, ids, counts)
    return sh, si


def sharded_ingest_step(mesh: Mesh, batch_hashes: np.ndarray, batch_ids: np.ndarray):
    """Host partition by hash range + device sort per shard.  Returns stacked
    sorted per-shard runs (the building block for distributed segment
    construction)."""
    n = mesh.devices.size
    bounds = hash_bounds(n)
    order = np.argsort(batch_hashes.astype(np.uint64), kind="stable")
    h_sorted = batch_hashes[order]
    i_sorted = batch_ids[order]
    cuts = np.searchsorted(h_sorted.astype(np.uint64), bounds)
    cap = _bucket(max(int(np.max(np.diff(cuts))), 1), 1024)
    h = np.full((n, cap), 0xFFFFFFFF, np.uint32)
    i = np.full((n, cap), 0xFFFFFFFF, np.uint32)
    counts = np.zeros((n, 1), np.int32)
    for k in range(n):
        seg_h = h_sorted[cuts[k] : cuts[k + 1]]
        h[k, : seg_h.shape[0]] = seg_h
        i[k, : seg_h.shape[0]] = i_sorted[cuts[k] : cuts[k + 1]]
        counts[k, 0] = seg_h.shape[0]
    sharding = jax.sharding.NamedSharding(mesh, P(AXIS))
    return _sharded_ingest_impl(
        mesh,
        jax.device_put(h, sharding),
        jax.device_put(i, sharding),
        jax.device_put(counts, sharding),
    )


@functools.partial(jax.jit, static_argnums=(0, 1))
def sharded_search_batch_packed(params: SearchParams, mesh: Mesh, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts):
    """Batched sharded search with outputs packed into one u32 array (one
    device->host transfer per batch; see search_kernel.pack_outputs)."""
    from ..ops.search_kernel import pack_outputs

    return pack_outputs(
        sharded_search_batch(
            params, mesh, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts
        )
    )
