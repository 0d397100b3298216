"""Hand-pinned wire bytes for every persistent / cross-process format.

The reference pins protocol bytes against literals because "a round-trip
would pass just as happily if every key were wrong"
(/root/reference/src/RemoteCoordinator.zig:402-450, streamvbyte.zig:518-908).
Every byte string below is a HAND-PINNED literal: a silent key rename, field
reorder, or endianness change in any codec fails these tests even though
round-trips would still pass — exactly the on-disk / cross-version breakage
they exist to catch.  Do NOT regenerate these constants from the code under
test; update them only for a deliberate, versioned format change.
"""

import glob
import os
import struct
import zlib

import msgpack
import requests

from acoustid_index.engine import filefmt
from acoustid_index.engine.memseg import build_segment
from acoustid_index.engine.model import Insert, SegmentInfo
from acoustid_index.engine.oplog import Oplog
from acoustid_index.utils import native


# ---- oplog frame: [len u32 LE][crc32 u32 LE][msgpack {"i","c","v"}] ----

OPLOG_FILE_NAME = "0000000000000001.xlog"
OPLOG_FRAME = (
    b"\x16\x00\x00\x00\xf17\x82\xd9"  # len=22, crc32(payload)=0xd98237f1
    b"\x83\xa1i\x01"  # {"i": 1,
    b"\xa1c\x91\x81\xa1i\x82\xa1i\x07\xa1h\x92*+"  #  "c":[{"i":{"i":7,"h":[42,43]}}],
    b"\xa1v\x07"  #  "v": 7}
)


def test_oplog_frame_bytes(tmp_path):
    lg = Oplog.open(str(tmp_path), sync=False, handler=lambda t: None)
    lg.append([Insert(id=7, hashes=[42, 43])], version=7)
    files = glob.glob(str(tmp_path / "*.xlog"))
    assert [os.path.basename(f) for f in files] == [OPLOG_FILE_NAME]
    assert open(files[0], "rb").read() == OPLOG_FRAME


# ---- segment file (ATS1 raw-column layout) ----

SEGMENT_FILE_NAME = "0000000000000002-00000000.seg"
SEGMENT_FILE = (
    b"ATS1"  # magic
    b"J\x00\x00\x00"  # header length = 74
    b"\x87"  # 7-key header map
    b"\xa4info\x93\x02\x00\xc0"  # "info": [2, 0, None]
    b"\xa8metadata\x80"  # "metadata": {}
    b"\xa9num_items\x02"
    b"\xa8num_docs\x01"
    b"\xaamin_doc_id\x07"
    b"\xaamax_doc_id\x07"
    b"\xa3crc\xceP\xe6I\xaf"  # crc32 of the payload columns
    b"*\x00\x00\x00+\x00\x00\x00"  # hashes  u32 LE: [42, 43]
    b"\x07\x00\x00\x00\x07\x00\x00\x00"  # docids  u32 LE: [7, 7]
    b"\x07\x00\x00\x00"  # docs_ids u32 LE: [7]
    b"\x01"  # docs_alive u8: [1]
    b"g*\xab\x8e"  # footer: crc32(header bytes)
)


def test_segment_file_bytes_raw_layout(tmp_path, monkeypatch):
    # Pin the always-available ATS1 raw layout (the ATS2 delta-varint
    # payload is pinned by tests/test_native.py's codec vectors).
    monkeypatch.setattr(native, "encode_postings", lambda *a: None)
    seg = build_segment(
        [Insert(id=7, hashes=[42, 43])], SegmentInfo(commit_id=2, merges=0, version=None)
    )
    name = filefmt.write_segment(str(tmp_path), seg)
    assert name == SEGMENT_FILE_NAME
    assert open(tmp_path / name, "rb").read() == SEGMENT_FILE
    # Internal consistency of the pinned literal itself.
    hdr_len = struct.unpack("<I", SEGMENT_FILE[4:8])[0]
    hdr = SEGMENT_FILE[8 : 8 + hdr_len]
    assert SEGMENT_FILE[-4:] == struct.pack("<I", zlib.crc32(hdr))


# ---- snapshot wire header: [len u32 LE][msgpack {"f","g","s"}] ----

SNAPSHOT_HEADER = (
    b"\x12\x00\x00\x00"  # header length = 18
    b"\x83\xa1f\x01"  # {"f": 1,
    b"\xa1g\x03"  #  "g": 3,
    b"\xa1s\x91\x92\x93\x02\x01\xc0\xcd\x04\xd2"  #  "s": [[[2, 1, None], 1234]]}
)


def test_snapshot_header_bytes(tmp_path):
    from types import SimpleNamespace

    from acoustid_index.engine.segments import Snapshot
    from acoustid_index.multi import snapshot as snap_mod

    info = SegmentInfo(commit_id=2, merges=1, version=None)
    seg_path = tmp_path / filefmt.segment_file_name(info)
    seg_path.write_bytes(b"x" * 1234)
    snapshot = Snapshot(file=(SimpleNamespace(info=info),))
    chunks = list(snap_mod.write_snapshot(snapshot, 3, str(tmp_path)))
    assert chunks[0] + chunks[1] == SNAPSHOT_HEADER
    assert b"".join(chunks[2:]) == b"x" * 1234


# ---- changelog HTTP bodies ----

APPEND_BODY = b"\x82\xa1c\x91\x81\xa1d\x81\xa1i\t\xa1e\x04"  # {"c":[{"d":{"i":9}}],"e":4}
APPEND_RESP = b"\x81\xa1i\x05"  # {"i": 5}
READ_RESP = (
    b"\x82\xa1e\x91\x82\xa1i\x05\xa1c\x81\xa1i\x82\xa1i\x07\xa1h\x92*+"
    b"\xa1r\x00"
)  # {"e":[{"i":5,"c":{"i":{"i":7,"h":[42,43]}}}],"r":0}
BOOTSTRAP_POS = b"\x81\xa1p("  # {"p": 40}
BOOTSTRAP_END = b"\x90"  # [] — the PROPER-end marker


def _coordinator_server(corpus=None):
    from acoustid_index.cluster.coordinator import MemoryCoordinator
    from acoustid_index.cluster.coordinator_server import CoordinatorApp
    from acoustid_index.server.http import HttpServer

    coordinator = MemoryCoordinator(bootstrap_corpus=corpus)
    app = CoordinatorApp(coordinator)
    server = HttpServer("127.0.0.1", 0, app.router, app.error_response, app.not_found)
    server.serve_background()
    return coordinator, server, f"http://127.0.0.1:{server.port}"


def test_changelog_append_body_bytes():
    coordinator, server, url = _coordinator_server()
    try:
        gen = coordinator.create_index("idx")
        # Seed 4 entries so the pinned append (expected version 4) lands at 5.
        for k in range(4):
            coordinator.append("idx", gen, [Insert(id=1 + k, hashes=[1])], None)
        r = requests.post(f"{url}/_changelog/idx/{gen}", data=APPEND_BODY)
        assert r.status_code == 200, r.text
        assert r.content == APPEND_RESP
    finally:
        server.shutdown()


def test_changelog_read_body_bytes():
    coordinator, server, url = _coordinator_server()
    try:
        gen = coordinator.create_index("idx")
        for k in range(4):
            coordinator.append("idx", gen, [Insert(id=1 + k, hashes=[1])], None)
        coordinator.append("idx", gen, [Insert(id=7, hashes=[42, 43])], None)  # seq 5
        r = requests.get(f"{url}/_changelog/idx/{gen}?after=4&max=1")
        assert r.status_code == 200
        assert r.content == READ_RESP
    finally:
        server.shutdown()


def test_bootstrap_stream_bytes():
    corpus = {("idx", 1): (40, [[Insert(id=7, hashes=[42, 43])]])}
    coordinator, server, url = _coordinator_server(corpus)
    try:
        gen = coordinator.create_index("idx")
        assert gen == 1
        r = requests.get(f"{url}/_bootstrap/idx/{gen}")
        assert r.status_code == 200
        body = r.content
        assert body.startswith(BOOTSTRAP_POS)
        assert body.endswith(BOOTSTRAP_END)
        # One batch between header and end marker, msgpack'd change list.
        middle = body[len(BOOTSTRAP_POS) : -len(BOOTSTRAP_END)]
        assert middle == b"\x91\x81\xa1i\x82\xa1i\x07\xa1h\x92*+"
    finally:
        server.shutdown()


# ---- REST API msgpack short keys ----

SEARCH_REQ = b"\x82\xa1q\x92*+\xa1s\x00"  # {"q":[42,43],"s":0}
SEARCH_RESP = b"\x81\xa1r\x91\x82\xa1i\x07\xa1s\x02"  # {"r":[{"i":7,"s":2}]}
UPDATE_REQ = (
    b"\x81\xa1c\x91\x81\xa1i\x82\xa1i\x07\xa1h\x92*+"
)  # {"c":[{"i":{"i":7,"h":[42,43]}}]}
UPDATE_RESP = b"\x81\xa1v\x01"  # {"v": 1}
ERROR_RESP = b"\x81\xa1e\xaaBadRequest"  # {"e": "BadRequest"}


def test_api_short_key_bytes(tmp_path):
    from server_fixture import Server, post_search

    MSGPACK_CT = "application/vnd.msgpack"
    s = Server(tmp_path / "data")
    s.start()
    try:
        assert requests.put(s.url("/main")).status_code == 200
        r = requests.post(
            s.url("/main/_update"), data=UPDATE_REQ, headers={"Content-Type": MSGPACK_CT}
        )
        assert r.status_code == 200, r.text
        assert r.content == UPDATE_RESP
        r = post_search(
            s.url("/main/_search"), data=SEARCH_REQ, headers={"Content-Type": MSGPACK_CT}
        )
        assert r.status_code == 200
        assert r.content == SEARCH_RESP
        r = requests.post(
            s.url("/main/_search"),
            data=msgpack.packb({"q": "notalist"}),
            headers={"Content-Type": MSGPACK_CT},
        )
        assert r.status_code == 400
        assert r.content == ERROR_RESP
    finally:
        s.stop()
