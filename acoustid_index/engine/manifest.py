"""Manifest: the list of live file segments — THE commit point of a
checkpoint/merge (cf. /root/reference/src/manifest.zig:1-5).  A msgpack
array of SegmentInfo wire triples, written atomically (temp + fsync +
rename).  Nothing index-level is stored: "upstream-fed" is derived from any
segment carrying a version."""

from __future__ import annotations

import os
from typing import List, Sequence

from ..utils import mpack

from .model import SegmentInfo

MANIFEST_NAME = "manifest"


def read_manifest(dir_path: str) -> List[SegmentInfo]:
    path = os.path.join(dir_path, MANIFEST_NAME)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return []
    return [SegmentInfo.from_wire(v) for v in mpack.unpackb(data)]


def write_manifest(dir_path: str, infos: Sequence[SegmentInfo]) -> None:
    path = os.path.join(dir_path, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(mpack.packb([i.to_wire() for i in infos]))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
