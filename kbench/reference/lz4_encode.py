"""The program's deterministic LZ4 frame encoder, in plain Python and
NumPy: the spec every lz4 route of ``compression.backend=gpu`` with
``gpu.compress.device`` follows (the kernel, its plain version and the
native encoder beside them), written again here from that spec and not
from their code, so that a stored frame can be re-encoded from its
decoded payload and compared with the stored bytes.

The block format and the frame format are the public ones (LZ4 block
format, LZ4 frame format 1.6.x), and :func:`kbench.reference.lz4.
decode_frame` reads these frames.  What the encoder chooses, where a
compliant encoder may choose otherwise, and so where its bytes depart
from what the public reference library's ``LZ4F_compressFrame`` writes:

- the hash: ``(w * 2654435761) mod 2**32 >> 20`` of the little-endian
  32-bit word at a position, a table of 4,096 entries reset at each
  block;
- every position of the block enters the table, match interiors
  included (the reference inserts only some positions);
- the candidate at a position is the latest earlier position with the
  same hash; there is no acceleration (the reference skips ahead
  through literals) and no backward extension of a match;
- a match needs a candidate at most 65,535 bytes back whose first four
  bytes equal the position's; its length is the common prefix, at most
  273 bytes (MAXMATCH; the reference has no such cap) and at most up to
  the block's last five bytes;
- the parse is greedy: the first match found is taken, then the search
  resumes after it; no match starts within the block's last 12 bytes
  and the last five bytes are literals (the public block format's
  rules);
- the frame: magic, FLG 0x60 (version 1, independent blocks, no block
  or content checksum, no content size), BD 0x40 (64 KB blocks), the
  header checksum, then each 64 KB block compressed when that is
  strictly smaller than the block and stored raw (the length word's
  high bit) otherwise, then the end mark.

Because every earlier position is in the table, a position's candidate
does not depend on the parse: :func:`candidates` finds them for the
whole block at once, and only the parse runs position by position.
"""
from __future__ import annotations

import struct

import numpy as np

from .lz4 import MAGIC, xxh32

BLOCK = 1 << 16
HASH_BITS = 12
MAXMATCH = 273
#: no match may start within this many bytes of the block's end
MFLIMIT = 12
#: the block's last bytes are always literals
LASTLITERALS = 5
FLG, BD = 0x60, 0x40


def candidates(src: np.ndarray) -> np.ndarray:
    """For each position ``p`` with ``p + 4 <= len(src)``, the latest
    ``q < p`` whose 32-bit word hashes as ``p``'s does, or -1."""
    n = len(src) - 3
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    s = src.astype(np.uint32)
    w = s[:n] | (s[1:n + 1] << 8) | (s[2:n + 2] << 16) | (s[3:n + 3] << 24)
    h = (w.astype(np.uint64) * 2654435761 & 0xFFFFFFFF) >> (32 - HASH_BITS)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    prev = np.full(n, -1, dtype=np.int64)
    same = hs[1:] == hs[:-1]
    prev[order[1:][same]] = order[:-1][same]
    return prev


def _length(out: bytearray, v: int) -> None:
    """The 255-run extension of a token's 15."""
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)


def _sequence(out: bytearray, lits: bytes, off: int, mlen: int) -> None:
    lit = len(lits)
    m = mlen - 4
    out.append((min(lit, 15) << 4) | min(m, 15))
    if lit >= 15:
        _length(out, lit - 15)
    out += lits
    out += struct.pack("<H", off)
    if m >= 15:
        _length(out, m - 15)


def encode_block(block: bytes) -> bytes:
    """One LZ4 block of ``block`` (at most 64 KB)."""
    n = len(block)
    src = np.frombuffer(block, dtype=np.uint8)
    out = bytearray()
    anchor = p = 0
    if n >= MFLIMIT:
        cand = candidates(src)
        pos = np.arange(len(cand))
        ok = cand >= 0
        ok[ok] = (pos[ok] - cand[ok]) <= 65535
        w = src[:len(cand)].astype(np.uint32)
        for k in (1, 2, 3):
            w |= src[k:len(cand) + k].astype(np.uint32) << (8 * k)
        ok[ok] = w[cand[ok]] == w[ok]
        starts = np.flatnonzero(ok[:n - MFLIMIT + 1])
        i = 0
        while True:
            i += int(np.searchsorted(starts[i:], p))
            if i >= len(starts):
                break
            p = int(starts[i])
            c = int(cand[p])
            mmax = min(n - LASTLITERALS - p, MAXMATCH)
            differ = np.flatnonzero(src[c + 4:c + mmax]
                                    != src[p + 4:p + mmax])
            mlen = 4 + int(differ[0]) if len(differ) else mmax
            _sequence(out, block[anchor:p], p - c, mlen)
            p += mlen
            anchor = p
    lit = n - anchor
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        _length(out, lit - 15)
    out += block[anchor:]
    return bytes(out)


def encode_frame(data: bytes) -> bytes:
    """One LZ4 frame of ``data`` as the program writes it."""
    data = bytes(data)
    head = bytes([FLG, BD])
    out = bytearray(struct.pack("<I", MAGIC) + head)
    out.append((xxh32(head) >> 8) & 0xFF)
    for at in range(0, len(data), BLOCK):
        raw = data[at:at + BLOCK]
        comp = encode_block(raw)
        if len(comp) < len(raw):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", len(raw) | 0x80000000) + raw
    out += b"\0\0\0\0"
    return bytes(out)
