"""LZ4 frame and block decoding in plain Python (the LZ4 frame format
1.6.x and block format, as published with the reference lz4 library).

Kafka's lz4 codec stores one LZ4 frame per batch payload.  The frame's
header checksum, each block's checksum and the content checksum are
xxHash32 values; they are verified here when their flags are set, so a
frame that decodes to the right length but carries a wrong block still
fails.
"""
from __future__ import annotations

import struct

MAGIC = 0x184D2204


class Lz4Error(ValueError):
    pass


_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917,
                           668265263, 374761393)
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 of ``data``."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        limit = n - 16
        words = struct.unpack_from("<%dI" % ((limit // 16 + 1) * 4), data)
        for k in range(0, len(words), 4):
            v1 = (_rotl((v1 + words[k] * _P2) & _M, 13) * _P1) & _M
            v2 = (_rotl((v2 + words[k + 1] * _P2) & _M, 13) * _P1) & _M
            v3 = (_rotl((v3 + words[k + 2] * _P2) & _M, 13) * _P1) & _M
            v4 = (_rotl((v4 + words[k + 3] * _P2) & _M, 13) * _P1) & _M
        i = len(words) * 4
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while i + 4 <= n:
        (w,) = struct.unpack_from("<I", data, i)
        h = (_rotl((h + w * _P3) & _M, 17) * _P4) & _M
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M, 11) * _P1) & _M
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h


def decode_block(src: bytes, out: bytearray) -> None:
    """Append the decoded LZ4 block ``src`` to ``out`` (matches may reach
    back into what ``out`` already holds: a frame's linked blocks)."""
    i = 0
    n = len(src)
    while True:
        if i >= n:
            raise Lz4Error("block ends inside a sequence")
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise Lz4Error("literals run past the block")
        out += src[i:i + lit]
        i += lit
        if i == n:
            return                      # the last sequence has no match
        if i + 2 > n:
            raise Lz4Error("block ends inside a match offset")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        if off == 0 or off > len(out):
            raise Lz4Error(f"match offset {off} outside the output")
        mlen = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - off
        if mlen <= off:
            out += out[start:start + mlen]
        else:                           # overlapping: repeat the period
            period = bytes(out[start:])
            reps, rest = divmod(mlen, off)
            out += period * reps + period[:rest]


def decode_frame(data: bytes) -> bytes:
    """The content of one LZ4 frame; raises :class:`Lz4Error` on any
    malformed header, block or checksum."""
    if len(data) < 7 or struct.unpack_from("<I", data, 0)[0] != MAGIC:
        raise Lz4Error("not an LZ4 frame")
    flg, bd = data[4], data[5]
    if flg >> 6 != 1:
        raise Lz4Error(f"frame version {flg >> 6}")
    block_checksum = bool(flg & 0x10)
    has_size = bool(flg & 0x08)
    content_checksum = bool(flg & 0x04)
    if flg & 0x01:
        raise Lz4Error("dictionary frames are not used by Kafka")
    max_block = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}.get(
        (bd >> 4) & 7)
    if max_block is None:
        raise Lz4Error(f"block maximum code {(bd >> 4) & 7}")
    i = 6 + (8 if has_size else 0)
    if (xxh32(data[4:i]) >> 8) & 0xFF != data[i]:
        raise Lz4Error("frame header checksum")
    i += 1
    out = bytearray()
    while True:
        if i + 4 > len(data):
            raise Lz4Error("frame ends without an end mark")
        (word,) = struct.unpack_from("<I", data, i)
        i += 4
        if word == 0:
            break
        size = word & 0x7FFFFFFF
        if size > max_block or i + size > len(data):
            raise Lz4Error(f"block of {size} B")
        block = data[i:i + size]
        i += size
        if block_checksum:
            if struct.unpack_from("<I", data, i)[0] != xxh32(block):
                raise Lz4Error("block checksum")
            i += 4
        if word & 0x80000000:
            out += block                # stored uncompressed
        else:
            decode_block(block, out)
    if content_checksum:
        if i + 4 > len(data) or struct.unpack_from("<I", data, i)[0] != \
                xxh32(bytes(out)):
            raise Lz4Error("content checksum")
        i += 4
    if has_size and struct.unpack_from("<Q", data, 6)[0] != len(out):
        raise Lz4Error("content size")
    return bytes(out)
