"""Native codec: roundtrips, corruption detection, native/Python parity,
and on-disk size wins."""

import numpy as np
import pytest

from acoustid_index.utils import native


def make_postings(n, seed=0):
    rng = np.random.default_rng(seed)
    hashes = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    docids = rng.integers(1, 2**32, n, dtype=np.uint32)
    # Sort within equal-hash runs (the segment invariant).
    order = np.lexsort((docids, hashes))
    return hashes[order], docids[order]


def test_native_builds():
    assert native.available(), "native codec should build in this image"


def test_postings_roundtrip():
    h, d = make_postings(50_000)
    buf = native.encode_postings(h, d)
    h2, d2 = native.decode_postings(buf, h.shape[0])
    assert np.array_equal(h, h2)
    assert np.array_equal(d, d2)


def test_postings_roundtrip_dense_runs():
    # Heavy collisions: long equal-hash runs exercise the docid-delta branch.
    rng = np.random.default_rng(1)
    hashes = np.sort(rng.integers(0, 50, 10_000, dtype=np.uint32))
    docids = rng.integers(1, 1000, 10_000, dtype=np.uint32)
    order = np.lexsort((docids, hashes))
    h, d = hashes[order], docids[order]
    buf = native.encode_postings(h, d)
    h2, d2 = native.decode_postings(buf, h.shape[0])
    assert np.array_equal(h, h2)
    assert np.array_equal(d, d2)
    # Dense runs compress hard: well under 4 bytes per posting.
    assert len(buf) < 4 * h.shape[0]


def test_sorted_u32_roundtrip():
    rng = np.random.default_rng(2)
    values = np.sort(rng.integers(0, 2**32, 10_000, dtype=np.uint32))
    buf = native.encode_sorted_u32(values)
    assert np.array_equal(native.decode_sorted_u32(buf, values.shape[0]), values)


def test_python_fallback_parity():
    h, d = make_postings(2_000, seed=3)
    native_buf = native.encode_postings(h, d)
    py_buf = native._py_encode_postings(h, d)
    assert native_buf == py_buf
    h2, d2 = native._py_decode_postings(native_buf, h.shape[0])
    assert np.array_equal(h, h2) and np.array_equal(d, d2)


def test_corrupt_stream_detected():
    h, d = make_postings(1_000, seed=4)
    buf = bytearray(native.encode_postings(h, d))
    with pytest.raises(ValueError):
        native.decode_postings(bytes(buf[:-2]), h.shape[0])  # truncated
    with pytest.raises(ValueError):
        native.decode_postings(bytes(buf) + b"\x00", h.shape[0])  # trailing


def test_scan_frames_matches_python_scanner(tmp_path):
    import struct
    import zlib

    frames = b""
    for payload in (b"hello", b"x" * 1000, b"world"):
        frames += struct.pack("<II", len(payload), zlib.crc32(payload)) + payload
    assert native.scan_frames(frames, 1 << 20) == len(frames)
    # Torn tail: cut mid-payload.
    assert native.scan_frames(frames[:-3], 1 << 20) == len(frames) - 5 - 8
    # Corrupt CRC stops the scan at the boundary.
    bad = bytearray(frames)
    bad[8 + 2] ^= 0xFF
    assert native.scan_frames(bytes(bad), 1 << 20) == 0


def test_segment_file_dv1_size_win(tmp_path):
    from acoustid_index.engine import filefmt
    from acoustid_index.engine.memseg import build_segment
    from acoustid_index.engine.model import Insert, SegmentInfo

    rng = np.random.default_rng(5)
    changes = [
        Insert(id=i, hashes=rng.integers(0, 2**32, 30, dtype=np.uint32).tolist())
        for i in range(1, 2000)
    ]
    seg = build_segment(changes, SegmentInfo(commit_id=1))
    name = filefmt.write_segment(str(tmp_path), seg)
    size = filefmt.segment_file_size(str(tmp_path), seg.info)
    raw_size = seg.num_items * 8 + seg.num_docs * 5
    assert size < raw_size * 0.8, (size, raw_size)  # compressed on disk
    back = filefmt.read_segment(str(tmp_path), seg.info)
    assert np.array_equal(back.hashes, seg.hashes)
    assert np.array_equal(back.docids, seg.docids)
    assert np.array_equal(back.docs_ids, seg.docs_ids)
    assert np.array_equal(back.docs_alive, seg.docs_alive)
