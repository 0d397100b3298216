"""Trace-time regression for >2^31-entry interleaved tiers.

At 1B+ postings the interleaved array (2 u32 per posting) crosses 2^31
entries; a signed-int32 gather index once made jax constant-fold the array
size into int32 during negative-index normalization — an OverflowError at
trace time that killed the 134M bench (layout.hash_index/docid_index are
unsigned now).  jax.eval_shape traces the FULL serving program at 134M
scale with no data, so this stays cheap.
"""
import jax
import jax.numpy as jnp

from acoustid_index.engine.searcher import _params_for
from acoustid_index.ops.layout import BLOCK
from acoustid_index.ops.search_kernel import _search_batch_impl


def test_134m_interleaved_traces():
    n_docs = 134_217_728
    n_postings = n_docs * 8  # 2^30 postings -> 2^31 interleaved entries
    params = _params_for(128)
    B, Q = 256, params.query_len

    u32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.uint32)
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    file_tier = {
        "inter": u32(2 * n_postings),
        "block_index": u32(n_postings // BLOCK),
        "seg_start": i32(1),
        "seg_len": i32(1),
        "mention_ids": u32(n_docs),
        "mention_len": jax.ShapeDtypeStruct((), jnp.int32),
    }
    mem_tier = {
        "hashes": u32(1024),
        "docids": u32(1024),
        "block_index": u32(1),
        "seg_start": i32(1),
        "seg_len": i32(1),
        "mention_ids": u32(1024),
        "mention_len": jax.ShapeDtypeStruct((), jnp.int32),
    }
    out = jax.eval_shape(
        lambda ft, mt, q, ql, lim, ms, pct: _search_batch_impl(
            params, ft, mt, q, ql, lim, ms, pct
        ),
        file_tier,
        mem_tier,
        u32(B, Q),
        i32(B),
        i32(B),
        i32(B),
        i32(B),
    )
    assert out["ids"].shape == (B, params.out_len)
