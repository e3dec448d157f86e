"""CRC32C (Castagnoli) and CRC32 — bit-exact with the reference.

The reference implements CRC32C in src/crc32c.c (sw table + SSE4.2 hw path,
unit test vectors at crc32c.c:388) for the MessageSet v2 batch checksum, and
zlib-poly CRC32 (src/rdcrc32.c) for legacy MsgVer0/1 messages.

This module provides:

- ``crc32c(data, crc=0)`` — pure-Python/numpy reference implementation
  (the native C++ provider in ops/native is the fast CPU path).
- ``crc32c_combine(crc_a, crc_b, len_b)`` — GF(2) matrix-power combine, so
  CRCs of adjacent chunks can be merged: this is what makes the checksum
  *parallelizable* — chunk CRCs computed independently (one per GPU
  thread in csrc/crc_rows.cu) are folded with an associative combine, the
  device analog of the hw-pipelined path in crc32c.c:39.
- Kafka conventions: the v2 record-batch CRC is CRC32C over the batch from
  the Attributes offset onward (RD_KAFKAP_MSGSET_V2_OF_Attributes,
  src/rdkafka_proto.h), stored big-endian unsigned.
"""
from __future__ import annotations

import zlib

import numpy as np

CRC32C_POLY = 0x82F63B78  # reflected Castagnoli polynomial


def _make_table(poly: int) -> np.ndarray:
    table = np.empty(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table


def _make_table8(poly: int) -> np.ndarray:
    """Slice-by-8 tables: TABLE8[k][b] = crc of byte b advanced through
    k+1 zero bytes."""
    t8 = np.empty((8, 256), dtype=np.uint32)
    t8[0] = _make_table(poly)
    for k in range(1, 8):
        t8[k] = t8[0][t8[k - 1] & 0xFF] ^ (t8[k - 1] >> 8)
    return t8


_TABLE8 = _make_table8(CRC32C_POLY)

_T = [t.tolist() for t in _TABLE8]  # python lists are faster to index scalar-wise


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data``, continuing from ``crc`` (pre/post inverted)."""
    crc = (~crc) & 0xFFFFFFFF
    buf = bytes(data)
    n = len(buf)
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    i = 0
    # slice-by-8 main loop
    while n - i >= 8:
        crc ^= buf[i] | (buf[i + 1] << 8) | (buf[i + 2] << 16) | (buf[i + 3] << 24)
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF]
               ^ t3[buf[i + 4]] ^ t2[buf[i + 5]]
               ^ t1[buf[i + 6]] ^ t0[buf[i + 7]])
        i += 8
    while i < n:
        crc = t0[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8)
        i += 1
    return (~crc) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# GF(2) combine: crc(A||B) from crc(A), crc(B), len(B).
# Shifting a CRC register through one zero *bit* is a linear map over GF(2);
# we exponentiate the one-byte map to len_b bytes by repeated squaring.
# ---------------------------------------------------------------------------

def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_matrix_square(mat: list[int]) -> list[int]:
    return [_gf2_matrix_times(mat, mat[i]) for i in range(32)]


def _zero_operator(poly: int) -> list[list[int]]:
    """Precompute matrices M[k] advancing a CRC through 2^k zero bytes."""
    # one-bit shift operator
    odd = [poly] + [1 << (i - 1) for i in range(1, 32)]
    even = _gf2_matrix_square(odd)   # 2 bits
    odd2 = _gf2_matrix_square(even)  # 4 bits
    m = _gf2_matrix_square(odd2)     # 8 bits = 1 zero byte: M[0]
    mats = [m]
    for _ in range(63):
        m = _gf2_matrix_square(m)
        mats.append(m)
    return mats


_ZERO_OP_C = _zero_operator(CRC32C_POLY)
_ZERO_OP_Z = _zero_operator(0xEDB88320)


def _combine(crc_a: int, crc_b: int, len_b: int, mats: list[list[int]]) -> int:
    if len_b == 0:
        return crc_a
    k = 0
    while len_b:
        if len_b & 1:
            crc_a = _gf2_matrix_times(mats[k], crc_a)
        len_b >>= 1
        k += 1
    return (crc_a ^ crc_b) & 0xFFFFFFFF


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """CRC32C of concat(A, B) given crc32c(A), crc32c(B), len(B)."""
    return _combine(crc_a, crc_b, len_b, _ZERO_OP_C)


def crc32_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """zlib-poly CRC32 combine (equivalent of zlib.crc32_combine)."""
    return _combine(crc_a, crc_b, len_b, _ZERO_OP_Z)


def crc32(data, crc: int = 0) -> int:
    """Legacy MsgVer0/1 per-message CRC (zlib polynomial, src/rdcrc32.c)."""
    return zlib.crc32(bytes(data), crc) & 0xFFFFFFFF


#: The byte-advance operator matrices, for the GPU CRC kernel
#: (csrc/crc_rows.cu), which implements the same combine across threads.
ZERO_OP_CRC32C = np.array(_ZERO_OP_C, dtype=np.uint32)  # [64][32]
TABLE_CRC32C = _TABLE8  # [8][256] uint32
#: zlib-polynomial twins, for the legacy MsgVer0/1 per-message CRC
#: (reference: src/rdcrc32.c) on the same kernel.
ZERO_OP_CRC32 = np.array(_ZERO_OP_Z, dtype=np.uint32)   # [64][32]
TABLE8_CRC32 = _make_table8(0xEDB88320)                 # [8][256] uint32
TABLE_CRC32 = TABLE8_CRC32[0]                           # [256] uint32
