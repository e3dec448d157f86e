"""CRC32C (Castagnoli, reflected, init and final xor 0xFFFFFFFF), the
checksum of a v2 RecordBatch, in plain Python and NumPy.

``crc32c`` is the textbook byte-at-a-time table loop.  ``crc32c_many``
computes the same value for many regions at once: every region is cut
into chunks of ``CHUNK`` bytes (zeros in front of its first chunk, which
leave a CRC started at 0 unchanged), the table loop runs over all chunks
of all regions side by side, eight bytes a step, and each
region's chunk CRCs are folded together with the linear map that moves a
CRC past ``CHUNK`` zero bytes.  The initial value is applied by
inverting the region's first four bytes, which for a reflected CRC is
the same as starting from 0xFFFFFFFF.
"""
from __future__ import annotations

import numpy as np

POLY = 0x82F63B78          # CRC32C, reflected
CHUNK = 1024
#: chunks whose table loops run side by side (bounds the scratch)
LANES = 16384


def _table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(POLY), t >> 1)
    return t.astype(np.uint32)


TABLE = _table()
_TABLE_PY = [int(v) for v in TABLE]


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``, one byte at a time."""
    c = 0xFFFFFFFF
    t = _TABLE_PY
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _run(states: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The table loop over ``cols`` (positions x lanes) from ``states``."""
    for col in cols:
        states = TABLE[(states ^ col) & 0xFF] ^ (states >> 8)
    return states


def _shift_tables(nbytes: int) -> np.ndarray:
    """(4, 256) tables of the linear map that carries a CRC state past
    ``nbytes`` zero bytes, one table per byte of the state."""
    basis = (np.arange(256, dtype=np.uint32)[None, :]
             << (8 * np.arange(4, dtype=np.uint32))[:, None]).reshape(-1)
    out = _run(basis, np.zeros((nbytes, 1), dtype=np.uint32))
    return out.reshape(4, 256)


_SHIFT = _shift_tables(CHUNK)
#: two table steps at once, indexed by the state's low 16 bits
TABLE16 = _run(np.arange(65536, dtype=np.uint32),
               np.zeros((2, 1), dtype=np.uint32))
TABLE16_64 = TABLE16.astype(np.uint64)


def _shift(states: np.ndarray) -> np.ndarray:
    s = _SHIFT
    return (s[0][states & 0xFF] ^ s[1][(states >> 8) & 0xFF]
            ^ s[2][(states >> 16) & 0xFF] ^ s[3][states >> 24])


def crc32c_many(buf: bytes | np.ndarray, starts, ends) -> np.ndarray:
    """CRC32C of ``buf[starts[i]:ends[i]]`` for every i (uint32 array).
    Regions shorter than four bytes fall back to :func:`crc32c`."""
    data = np.frombuffer(buf, dtype=np.uint8)
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    out = np.zeros(len(starts), dtype=np.uint32)
    short = (ends - starts) < 4
    for i in np.flatnonzero(short):
        out[i] = crc32c(bytes(data[starts[i]:ends[i]]))
    big = np.flatnonzero(~short)
    if not len(big):
        return out
    lens = ends[big] - starts[big]
    pad = -lens % CHUNK
    # every region front-padded with zeros to whole chunks, end to end
    zeros = np.zeros(CHUNK, dtype=np.uint8)
    flat = np.concatenate([piece for i, p in zip(big, pad)
                           for piece in (zeros[:p],
                                         data[starts[i]:ends[i]])])
    at = np.cumsum(lens + pad) - lens
    # the initial 0xFFFFFFFF: invert each region's first four bytes
    flat[at[:, None] + np.arange(4)] ^= 0xFF
    grid = flat.view("<u8").reshape(-1, CHUNK // 8)
    crcs = np.empty(len(grid), dtype=np.uint32)
    mask, step = np.uint64(0xFFFF), np.uint64(16)
    for b in range(0, len(grid), LANES):
        st = np.zeros(min(LANES, len(grid) - b), dtype=np.uint64)
        for col in np.ascontiguousarray(grid[b:b + LANES].T):
            for _ in range(4):          # the word's four 16-bit halves
                st = TABLE16_64[(st ^ col) & mask] ^ (st >> step)
                col = col >> step
        crcs[b:b + LANES] = st
    # fold each region's chunk CRCs, oldest first; regions with fewer
    # chunks join later (a CRC of 0 carried past zeros stays 0)
    nchunks = (lens + pad) // CHUNK
    first = np.cumsum(nchunks) - nchunks
    depth = int(nchunks.max())
    acc = np.zeros(len(big), dtype=np.uint32)
    for k in range(depth):
        idx = k - (depth - nchunks)
        live = idx >= 0
        add = np.zeros(len(big), dtype=np.uint32)
        add[live] = crcs[first[live] + idx[live]]
        acc = _shift(acc) ^ add
    out[big] = acc ^ np.uint32(0xFFFFFFFF)
    return out
