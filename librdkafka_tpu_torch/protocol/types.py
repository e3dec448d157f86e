"""Kafka wire-protocol primitive types and declarative schemas.

The declarative-schema equivalent of the reference's read/write macro layer
(rd_kafka_buf_read_* / rd_kafka_buf_write_* in src/rdkafka_buf.h:162-302):
every request/response is described once as a Schema and both the client
and the in-process mock broker build/parse through it, so the two sides
cannot drift. Underflow raises BufUnderflow — the same "goto err_parse"
error contract.
"""
from __future__ import annotations

import struct
from typing import Any, Optional

from ..utils.buf import SegBuf, Slice


class _Prim:
    fmt: str

    def __init__(self):
        self.size = struct.calcsize(self.fmt)

    def write(self, buf: SegBuf, val) -> None:
        buf.write(struct.pack(self.fmt, val))

    def read(self, sl: Slice):
        return struct.unpack(self.fmt, sl.read(self.size))[0]


class _Int8(_Prim):
    fmt = ">b"


class _Int16(_Prim):
    fmt = ">h"


class _Int32(_Prim):
    fmt = ">i"


class _Int64(_Prim):
    fmt = ">q"


class _UInt32(_Prim):
    fmt = ">I"


class _Float64(_Prim):
    fmt = ">d"


class _Boolean:
    def write(self, buf, val):
        buf.write(b"\x01" if val else b"\x00")

    def read(self, sl):
        return sl.read(1) != b"\x00"


class _String:
    """Non-null string: int16 length + utf8 bytes."""

    def write(self, buf, val: str):
        b = val.encode("utf-8")
        buf.write_i16(len(b))
        buf.write(b)

    def read(self, sl) -> str:
        n = sl.read_i16()
        if n < 0:
            raise ValueError("unexpected null string")
        return sl.read(n).decode("utf-8")


class _NullableString:
    def write(self, buf, val: Optional[str]):
        if val is None:
            buf.write_i16(-1)
        else:
            b = val.encode("utf-8")
            buf.write_i16(len(b))
            buf.write(b)

    def read(self, sl) -> Optional[str]:
        n = sl.read_i16()
        return None if n < 0 else sl.read(n).decode("utf-8")


class _Bytes:
    """Nullable bytes: int32 length (-1 = null) + bytes."""

    #: payloads at or above this ride as spliced read-only segments
    #: (no copy into the write buffer; they go to the socket via the
    #: SegWriter iovec path) — RecordBatch bytes in Produce requests
    #: and Fetch responses are the case that matters
    SPLICE_MIN = 4096

    def write(self, buf, val: Optional[bytes]):
        if val is None:
            buf.write_i32(-1)
        else:
            buf.write_i32(len(val))
            if len(val) >= self.SPLICE_MIN:
                buf.push_ro(val)
            else:
                buf.write(val)

    def read(self, sl) -> Optional[bytes]:
        n = sl.read_i32()
        if n < 0:
            return None
        if n >= self.SPLICE_MIN:
            # large payloads (RecordBatch blobs) come out as views into
            # the response frame — the codec/parse layers consume them
            # through the buffer protocol without a flat copy
            return sl.view(n)
        return sl.read(n)


Int8, Int16, Int32, Int64 = _Int8(), _Int16(), _Int32(), _Int64()
UInt32, Float64 = _UInt32(), _Float64()
Boolean = _Boolean()
String, NullableString, Bytes = _String(), _NullableString(), _Bytes()


class Array:
    """int32 count (-1 = null) + elements."""

    def __init__(self, elem):
        self.elem = elem

    def write(self, buf, val):
        if val is None:
            buf.write_i32(-1)
            return
        buf.write_i32(len(val))
        for v in val:
            self.elem.write(buf, v)

    def read(self, sl):
        n = sl.read_i32()
        if n < 0:
            return None
        if n > sl.remains():  # count cannot exceed remaining bytes
            raise ValueError(f"array count {n} exceeds buffer")
        return [self.elem.read(sl) for _ in range(n)]


class Schema:
    """Named-field record; values are plain dicts. ``defaults`` supplies
    values for fields a caller may omit (e.g. flags added by a later
    protocol version, so version-agnostic request bodies keep working)."""

    def __init__(self, *fields: tuple[str, Any],
                 defaults: dict | None = None):
        self.fields = fields
        self.defaults = defaults or {}

    def write(self, buf, val: dict):
        for name, typ in self.fields:
            if name in val:
                typ.write(buf, val[name])
            else:                   # KeyError unless a default exists
                typ.write(buf, self.defaults[name])

    def read(self, sl) -> dict:
        return {name: typ.read(sl) for name, typ in self.fields}


def encode(schema, val: dict) -> bytes:
    buf = SegBuf()
    schema.write(buf, val)
    return buf.as_bytes()


def decode(schema, data) -> dict:
    sl = data if isinstance(data, Slice) else Slice(data)
    return schema.read(sl)
