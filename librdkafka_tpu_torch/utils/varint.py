"""Zig-zag varint encoding for MessageSet v2 record framing.

Same wire format as the reference's src/rdvarint.c (rd_uvarint_enc_i64 /
rd_slice_read_varint at src/rdbuf.c:877): protobuf-style base-128 varints,
signed values zig-zag mapped.
"""
from __future__ import annotations


def zigzag(v: int) -> int:
    """Map signed to unsigned: 0,-1,1,-2,... -> 0,1,2,3,..."""
    return (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1


def unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def enc_u64(v: int) -> bytes:
    """Unsigned base-128 varint."""
    out = bytearray()
    v &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def enc_i64(v: int) -> bytes:
    """Signed (zig-zag) varint — the MessageSet v2 record framing encoding."""
    return enc_u64(zigzag(v))


def size_u64(v: int) -> int:
    v &= 0xFFFFFFFFFFFFFFFF
    n = 1
    while v >= 0x80:
        v >>= 7
        n += 1
    return n


def size_i64(v: int) -> int:
    return size_u64(zigzag(v))


def dec_u64(buf, offset: int = 0) -> tuple[int, int]:
    """Decode unsigned varint; returns (value, bytes_consumed).

    Raises ValueError on truncation or overlong (>10 byte) encoding, the
    same failure contract as rd_slice_read_uvarint's underflow path.
    """
    shift = 0
    val = 0
    i = offset
    end = len(buf)
    while True:
        if i >= end:
            raise ValueError("varint truncated")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, i - offset
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def dec_i64(buf, offset: int = 0) -> tuple[int, int]:
    u, n = dec_u64(buf, offset)
    return unzigzag(u), n
