"""acoustid_index — an accelerator-native audio-fingerprint search engine.

A from-scratch re-design of acoustid/acoustid-index (fpindex): an inverted
index mapping u32 hashes to u32 fingerprint ids, searched by hash-set
intersection and scored by intersection size, with WAL durability, segment
checkpoints, tiered merges, an HTTP API, and changelog replication.

Unlike the reference (a Zig CPU binary built around SIMD streamvbyte block
postings, cf. /root/reference/src/block.zig), the compute path here is
JAX/XLA/Pallas: every index snapshot is a set of immutable, device-resident
sorted (hash, docid) term tables, and search/ingest/merge run as jitted
device kernels that scale across a GPU mesh by hash-range sharding.
"""

__version__ = "0.1.0"
