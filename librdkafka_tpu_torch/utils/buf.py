"""Segmented zero-copy buffer + read slice.

The rebuild of the reference's single most load-bearing internal API, the
segmented grow-only buffer of src/rdbuf.c (1598 LoC): a chain of segments
where writers can append, rewind (rd_buf_write_seek, rdbuf.c:603),
back-patch earlier bytes (rd_buf_write_update, rdbuf.c:536), and splice in
*read-only referenced* segments without copying (rd_buf_push, rdbuf.c:563)
— which is how compressed MessageSet output replaces the uncompressed
records in place, both on the CPU path and on the GPU codec provider's
path. Readers use a cheap ``Slice`` cursor that can narrow to nested
regions (rd_slice_narrow*, rdbuf.c:982) and export iovecs for scatter-
gather socket IO (rd_slice_get_iov, rdbuf.c:1059).
"""
from __future__ import annotations

import struct
from typing import Iterable, Optional

from .crc import crc32, crc32c
from . import varint


class SegBuf:
    """Grow-only segmented write buffer."""

    __slots__ = ("_segs", "_len")

    def __init__(self):
        self._segs: list[bytearray | bytes] = []
        self._len = 0

    def __len__(self) -> int:
        return self._len

    # -- writing ----------------------------------------------------------
    def write(self, data) -> int:
        """Append bytes; returns the absolute offset they were written at."""
        pos = self._len
        if data:
            if self._segs and isinstance(self._segs[-1], bytearray):
                self._segs[-1] += data
            else:
                self._segs.append(bytearray(data))
            self._len += len(data)
        return pos

    def push_ro(self, data) -> int:
        """Splice a read-only segment (no copy) — bytes, bytearray or
        memoryview are kept by reference. Reference: rd_buf_push
        (rdbuf.c:563); this is how a finished RecordBatch rides inside
        a ProduceRequest without being re-copied."""
        pos = self._len
        if len(data):
            # a caller-owned bytearray is wrapped in a memoryview so
            # write() can never extend it in place
            self._segs.append(memoryview(data)
                              if isinstance(data, bytearray) else data)
            self._len += len(data)
        return pos

    def write_seek(self, pos: int) -> None:
        """Rewind the write position, discarding bytes at >= pos."""
        if pos > self._len or pos < 0:
            raise ValueError(f"write_seek({pos}) out of range 0..{self._len}")
        drop = self._len - pos
        while drop:
            seg = self._segs[-1]
            if len(seg) <= drop:
                drop -= len(seg)
                self._segs.pop()
            else:
                keep = len(seg) - drop
                if isinstance(seg, bytearray):
                    del seg[keep:]
                else:  # copy-on-truncate for ro (bytes/memoryview) segment
                    self._segs[-1] = bytearray(seg[:keep])
                drop = 0
        self._len = pos

    def write_update(self, pos: int, data: bytes) -> None:
        """Back-patch ``data`` over bytes previously written at ``pos``.

        Reference: rd_buf_write_update (rdbuf.c:536), used to finalize
        MessageSet headers (length/CRC/attributes) after the records are
        known.
        """
        end = pos + len(data)
        if end > self._len:
            raise ValueError("write_update beyond written length")
        off = 0
        di = 0
        for i, seg in enumerate(self._segs):
            seg_end = off + len(seg)
            if seg_end > pos and off < end:
                s = max(pos, off) - off
                e = min(end, seg_end) - off
                n = e - s
                if not isinstance(seg, bytearray):  # ro: copy-on-write
                    seg = bytearray(seg)
                    self._segs[i] = seg
                seg[s:e] = data[di:di + n]
                di += n
            off = seg_end
            if off >= end:
                break

    # -- struct helpers (big-endian, Kafka wire order) ---------------------
    def write_i8(self, v): return self.write(struct.pack(">b", v))
    def write_i16(self, v): return self.write(struct.pack(">h", v))
    def write_i32(self, v): return self.write(struct.pack(">i", v))
    def write_u32(self, v): return self.write(struct.pack(">I", v & 0xFFFFFFFF))
    def write_i64(self, v): return self.write(struct.pack(">q", v))
    def write_varint(self, v): return self.write(varint.enc_i64(v))
    def write_uvarint(self, v): return self.write(varint.enc_u64(v))

    def update_i32(self, pos, v): self.write_update(pos, struct.pack(">i", v))
    def update_u32(self, pos, v): self.write_update(pos, struct.pack(">I", v & 0xFFFFFFFF))
    def update_i64(self, pos, v): self.write_update(pos, struct.pack(">q", v))
    def update_i16(self, pos, v): self.write_update(pos, struct.pack(">h", v))
    def update_i8(self, pos, v): self.write_update(pos, struct.pack(">b", v))

    # -- reading out ------------------------------------------------------
    def as_bytes(self, start: int = 0, end: Optional[int] = None) -> bytes:
        end = self._len if end is None else end
        if len(self._segs) == 1 and start == 0 and end == self._len:
            return bytes(self._segs[0])
        out = bytearray()
        off = 0
        for seg in self._segs:
            seg_end = off + len(seg)
            if seg_end > start and off < end:
                out += seg[max(start, off) - off:min(end, seg_end) - off]
            off = seg_end
            if off >= end:
                break
        return bytes(out)

    def iovecs(self) -> list[memoryview]:
        """Segment views for scatter-gather sendmsg (rd_buf_get_write_iov)."""
        return [memoryview(s) for s in self._segs if len(s)]

    def slice(self, start: int = 0, end: Optional[int] = None) -> "Slice":
        return Slice(self.as_bytes(start, end))

    def crc32c(self, start: int, end: Optional[int] = None) -> int:
        """CRC32C over a written region (rd_slice_crc32c, rdbuf.c:1113)."""
        return crc32c(self.as_bytes(start, end))


class Slice:
    """Read cursor over a contiguous byte region, with narrowing.

    Reference: rd_slice_t (rdbuf.h) — all response/MessageSet parsing goes
    through this, with underflow raising rather than reading garbage (the
    declarative-macro goto err_parse strategy of rdkafka_buf.h:162).
    """

    __slots__ = ("_mv", "_pos", "_end")

    def __init__(self, data, start: int = 0, end: Optional[int] = None):
        self._mv = memoryview(data) if not isinstance(data, memoryview) else data
        self._pos = start
        self._end = len(self._mv) if end is None else end
        if not (0 <= start <= self._end <= len(self._mv)):
            raise ValueError("bad slice bounds")

    def __len__(self) -> int:
        return self._end - self._pos

    @property
    def offset(self) -> int:
        return self._pos

    def remains(self) -> int:
        return self._end - self._pos

    def _need(self, n: int) -> None:
        if self._end - self._pos < n:
            raise BufUnderflow(
                f"buffer underflow: need {n} bytes, {self._end - self._pos} remain")

    def read(self, n: int) -> bytes:
        self._need(n)
        out = bytes(self._mv[self._pos:self._pos + n])
        self._pos += n
        return out

    def view(self, n: int) -> memoryview:
        self._need(n)
        out = self._mv[self._pos:self._pos + n]
        self._pos += n
        return out

    def skip(self, n: int) -> None:
        self._need(n)
        self._pos += n

    def peek_all(self) -> bytes:
        return bytes(self._mv[self._pos:self._end])

    def read_i8(self): return struct.unpack(">b", self.read(1))[0]
    def read_u8(self): return self.read(1)[0]
    def read_i16(self): return struct.unpack(">h", self.read(2))[0]
    def read_i32(self): return struct.unpack(">i", self.read(4))[0]
    def read_u32(self): return struct.unpack(">I", self.read(4))[0]
    def read_i64(self): return struct.unpack(">q", self.read(8))[0]

    def read_varint(self) -> int:
        v, n = varint.dec_i64(self._mv, self._pos)
        if self._pos + n > self._end:
            raise BufUnderflow("varint crosses slice end")
        self._pos += n
        return v

    def read_uvarint(self) -> int:
        v, n = varint.dec_u64(self._mv, self._pos)
        if self._pos + n > self._end:
            raise BufUnderflow("varint crosses slice end")
        self._pos += n
        return v

    def narrow(self, n: int) -> "Slice":
        """Sub-slice of the next n bytes; advances this cursor past them.

        Reference: rd_slice_narrow_copy + rd_slice_widen (rdbuf.c:982-1056),
        used for nested MessageSet / compressed-payload parsing.
        """
        self._need(n)
        sub = Slice(self._mv, self._pos, self._pos + n)
        self._pos += n
        return sub

    def crc32c(self, crc: int = 0) -> int:
        return crc32c(self._mv[self._pos:self._end], crc)

    def crc32(self, crc: int = 0) -> int:
        return crc32(self._mv[self._pos:self._end], crc)


class BufUnderflow(Exception):
    """Raised on short reads — the parse-error contract for all protocol code."""
