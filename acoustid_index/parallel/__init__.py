"""Mesh-parallel search and ingest: hash-range sharded term tables with
exact cross-shard score combination over collectives."""

from .sharded import (
    ShardedView,
    build_sharded_view,
    make_mesh,
    sharded_search,
    sharded_ingest_step,
)

__all__ = [
    "ShardedView",
    "build_sharded_view",
    "make_mesh",
    "sharded_search",
    "sharded_ingest_step",
]
