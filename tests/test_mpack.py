"""The in-repo MessagePack codec (utils/mpack.py) against the msgpack
package: byte-identical encoding for every type the engine writes, the same
decoding, and WAL files written by msgpack still replaying."""

import zlib

import numpy as np
import pytest

msgpack = pytest.importorskip("msgpack")

from acoustid_index.engine.model import BulkInsert, Delete, Insert, SetMetadata, Transaction
from acoustid_index.engine.oplog import RECORD_HEADER, Oplog, _file_name
from acoustid_index.utils import mpack

INTS = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
]
VALUES = [
    None, True, False, 0.5, -1e300, 1.0,
    *INTS,
    *("x" * n for n in (0, 31, 32, 255, 256, 65535, 65536)),
    "é中",
    *(b"\x01" * n for n in (0, 255, 256, 65535, 65536)),
    bytearray(b"abc"),
    [], list(range(15)), list(range(16)), list(range(65536)),
    (1, "a", b"b"),
    {}, {i: i for i in range(15)}, {str(i): [i] for i in range(16)},
    {"c": [{"i": {"i": 7, "h": [42, 43]}}], "m": {"k": "v"}, "e": None},
    {1: "int key", "nested": {"deeper": [[], {}, [None]]}},
]


@pytest.mark.parametrize("value", VALUES, ids=lambda v: type(v).__name__ + str(len(v) if hasattr(v, "__len__") else v)[:12])
def test_encoding_is_byte_identical(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert mpack.packb(value) == want
    assert mpack.unpackb(want) == msgpack.unpackb(want, strict_map_key=False)


def test_decodes_float32_and_rejects_garbage():
    assert mpack.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    for bad in (b"", b"\x92\x01", b"\xc1", b"\xa3ab", msgpack.packb([1]) + b"x"):
        with pytest.raises(ValueError):
            mpack.unpackb(bad)
    with pytest.raises(TypeError):
        mpack.packb(object())


def test_streaming_unpacker_splits_anywhere():
    objs = [{"p": 3}, [{"i": 1}], [], b"\x00" * 300]
    data = b"".join(msgpack.packb(o, use_bin_type=True) for o in objs)
    for cut in range(0, len(data), 7):
        u = mpack.Unpacker()
        got = []
        for i in range(0, len(data), cut or 1):
            u.feed(data[i : i + (cut or 1)])
            got.extend(u)
        assert got == objs


def _txns():
    ids = np.array([5, 6], np.uint32)
    hashes = np.arange(6, dtype=np.uint32)
    offsets = np.array([0, 3, 6], np.uint32)
    return [
        Transaction(id=1, changes=(Insert(id=1, hashes=(10, 20, 30)),), version=None),
        Transaction(id=2, changes=(Delete(id=1), SetMetadata(entries=(("k", "v"),))), version=7),
        Transaction(id=3, changes=(BulkInsert(ids=ids, hashes=hashes, offsets=offsets),), version=None),
    ]


def test_wal_written_with_msgpack_replays(tmp_path):
    """A WAL whose records were encoded by msgpack (as every WAL on disk
    before the in-repo codec was) replays through the current reader, and
    the current writer produces the same bytes."""
    wal = tmp_path / "old"
    wal.mkdir()
    frames = b""
    for t in _txns():
        payload = msgpack.packb(t.to_wire(), use_bin_type=True)
        frames += RECORD_HEADER.pack(len(payload), zlib.crc32(payload)) + payload
    (wal / _file_name(1)).write_bytes(frames)

    seen = []
    log = Oplog.open(str(wal), sync=False, handler=seen.append)
    log.close()
    assert [t.id for t in seen] == [1, 2, 3]
    assert seen[0].changes[0].hashes == (10, 20, 30)
    assert seen[1].version == 7 and seen[1].changes[1].entries == (("k", "v"),)
    np.testing.assert_array_equal(np.asarray(seen[2].changes[0].hashes), np.arange(6))

    new = tmp_path / "new"
    log = Oplog.open(str(new), sync=False, handler=lambda t: None)
    for t in _txns():
        log.append(t.changes, version=t.version)
    log.close()
    assert (new / _file_name(1)).read_bytes() == frames
