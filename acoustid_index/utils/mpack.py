"""MessagePack codec for the types this engine writes.

Byte-identical to `msgpack.packb(obj, use_bin_type=True)` for None, bool,
int (u64/i64 range), float (float64), str, bytes-like (bin), list/tuple
(array) and dict (map), and decodes what `msgpack.unpackb(data,
strict_map_key=False)` decodes for those types (str as str, bin as bytes,
arrays as lists).  The WAL, manifests, segment headers, snapshots, the
coordinator protocol and msgpack HTTP bodies all go through it, so files
written by either encoder read back through the other.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator

__all__ = ["packb", "unpackb", "Unpacker", "FormatError"]


class FormatError(ValueError):
    """Malformed, truncated, or trailing MessagePack data."""


class _NeedMore(FormatError):
    """The buffer ends inside an object (streaming: wait for more bytes)."""


_B = struct.Struct(">B").pack
_H = struct.Struct(">BH").pack
_I = struct.Struct(">BI").pack
_Q = struct.Struct(">BQ").pack
_b = struct.Struct(">Bb").pack
_h = struct.Struct(">Bh").pack
_i = struct.Struct(">Bi").pack
_q = struct.Struct(">Bq").pack
_d = struct.Struct(">Bd").pack


def _pack_len(out: bytearray, n: int, fix_tag: int, fix_max: int, tags) -> None:
    if n <= fix_max:
        out += _B(fix_tag | n)
    elif tags[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", tags[0], n)
    elif n <= 0xFFFF:
        out += _H(tags[1], n)
    elif n <= 0xFFFFFFFF:
        out += _I(tags[2], n)
    else:
        raise ValueError("object too large for MessagePack")


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True:
        out += b"\xc3"
    elif obj is False:
        out += b"\xc2"
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out += _B(obj)
        elif -0x20 <= obj < 0:
            out += _B(obj & 0xFF)
        elif obj > 0:
            if obj <= 0xFF:
                out += struct.pack(">BB", 0xCC, obj)
            elif obj <= 0xFFFF:
                out += _H(0xCD, obj)
            elif obj <= 0xFFFFFFFF:
                out += _I(0xCE, obj)
            elif obj <= 0xFFFFFFFFFFFFFFFF:
                out += _Q(0xCF, obj)
            else:
                raise OverflowError("int too big for MessagePack")
        elif obj >= -0x80:
            out += _b(0xD0, obj)
        elif obj >= -0x8000:
            out += _h(0xD1, obj)
        elif obj >= -0x80000000:
            out += _i(0xD2, obj)
        elif obj >= -0x8000000000000000:
            out += _q(0xD3, obj)
        else:
            raise OverflowError("int too big for MessagePack")
    elif isinstance(obj, float):
        out += _d(0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B") if isinstance(obj, memoryview) else obj
        _pack_len(out, len(data), 0, -1, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# Fixed-width scalar tags: tag -> (struct, size).
_SCALARS = {
    0xCA: struct.Struct(">f"),
    0xCB: struct.Struct(">d"),
    0xCC: struct.Struct(">B"),
    0xCD: struct.Struct(">H"),
    0xCE: struct.Struct(">I"),
    0xCF: struct.Struct(">Q"),
    0xD0: struct.Struct(">b"),
    0xD1: struct.Struct(">h"),
    0xD2: struct.Struct(">i"),
    0xD3: struct.Struct(">q"),
}
# Length-prefixed tags: tag -> (kind, length struct).
_SIZED = {
    0xC4: ("bin", struct.Struct(">B")),
    0xC5: ("bin", struct.Struct(">H")),
    0xC6: ("bin", struct.Struct(">I")),
    0xD9: ("str", struct.Struct(">B")),
    0xDA: ("str", struct.Struct(">H")),
    0xDB: ("str", struct.Struct(">I")),
    0xDC: ("array", struct.Struct(">H")),
    0xDD: ("array", struct.Struct(">I")),
    0xDE: ("map", struct.Struct(">H")),
    0xDF: ("map", struct.Struct(">I")),
}


def _unpack(buf, pos: int, end: int):
    """(object, next position) for the object starting at buf[pos]."""
    if pos >= end:
        raise _NeedMore("truncated MessagePack data")
    tag = buf[pos]
    pos += 1
    if tag <= 0x7F:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif tag == 0xC0:
        return None, pos
    elif tag == 0xC2:
        return False, pos
    elif tag == 0xC3:
        return True, pos
    elif tag in _SCALARS:
        st = _SCALARS[tag]
        if pos + st.size > end:
            raise _NeedMore("truncated MessagePack data")
        return st.unpack_from(buf, pos)[0], pos + st.size
    elif tag in _SIZED:
        kind, st = _SIZED[tag]
        if pos + st.size > end:
            raise _NeedMore("truncated MessagePack data")
        n = st.unpack_from(buf, pos)[0]
        pos += st.size
    else:
        raise FormatError(f"unsupported MessagePack tag 0x{tag:02x}")
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos, end)
            out.append(v)
        return out, pos
    if kind == "map":
        d = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos, end)
            v, pos = _unpack(buf, pos, end)
            if isinstance(k, list):
                raise FormatError("unhashable map key")
            d[k] = v
        return d, pos
    if pos + n > end:
        raise _NeedMore("truncated MessagePack data")
    raw = bytes(buf[pos : pos + n])
    if kind == "str":
        try:
            return raw.decode("utf-8"), pos + n
        except UnicodeDecodeError as exc:
            raise FormatError(str(exc)) from exc
    return raw, pos + n


def unpackb(data) -> Any:
    """Decode exactly one object; trailing bytes are an error."""
    buf = memoryview(data).cast("B") if not isinstance(data, (bytes, bytearray)) else data
    try:
        obj, pos = _unpack(buf, 0, len(buf))
    except RecursionError as exc:
        raise FormatError("MessagePack nesting too deep") from exc
    if pos != len(buf):
        raise FormatError("extra data after MessagePack object")
    return obj


class Unpacker:
    """Streaming decoder: `feed` bytes as they arrive, iterate to take every
    complete object buffered so far."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data) -> None:
        self._buf += data

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        try:
            obj, pos = _unpack(self._buf, 0, len(self._buf))
        except _NeedMore:
            raise StopIteration
        del self._buf[:pos]
        return obj
