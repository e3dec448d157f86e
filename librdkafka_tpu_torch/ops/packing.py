"""Host-side batch packing helpers shared by the device codec kernels.

The port's copy of librdkafka_tpu/ops/packing.py.  An lz4 row kernel
wants RIGHT-padded rows (positions are absolute from the block start).
LEFT-padded rows are the TPU CRC kernels' layout (leading zeros are a
no-op under a zero initial register), which ``crc32c_torch.crc_rows``
keeps; the port's CRC route itself packs buffers with no padding
(``crc32c_torch._crc_many``).

Also home of the LZ4F frame shape of the fused device compress route:
:class:`FrameBlob` is an assembled frame that carries the crc32c of each
of its parts, so the MessageSet v2 batch CRC can be folded host-side
with crc32c_combine instead of re-scanning the frame bytes.  The engine's
compress route (ops/engine.py) builds them with :func:`lz4f_frame` from
the LZ4 kernel's rows and CRCs; the writer phase folds them
(client/codec_phase.py).
"""
from __future__ import annotations

import struct

import numpy as np

from ..utils.crc import crc32c, crc32c_combine

#: LZ4F defaults matching the native encoder (tk_lz4f_compress_many):
#: FLG 0x60 (v01, block-independent), BD 0x40 (64KB max block),
#: HC = (xxh32(FLG||BD) >> 8) & 0xFF = 0x82 — the bit-exactness tests
#: assert whole-frame equality with the native encoder, which pins it.
LZ4F_MAGIC = 0x184D2204
LZ4F_BLOCKSIZE = 65536
LZ4F_HEADER = struct.pack("<IBBB", LZ4F_MAGIC, 0x60, 0x40, 0x82)
LZ4F_ENDMARK = b"\x00\x00\x00\x00"
_HEADER_CRC = crc32c(LZ4F_HEADER)
_ENDMARK_CRC = crc32c(LZ4F_ENDMARK)


class FrameBlob(bytes):
    """An assembled LZ4F frame plus the crc32c of each of its parts
    (``crc_parts``: ``(crc, len)`` pairs whose concatenation is exactly
    these bytes).  :meth:`region_crc` folds them after an arbitrary
    prefix — the writer patches the v2 batch CRC without the host ever
    scanning the frame body."""

    def __new__(cls, parts):
        self = super().__new__(cls, b"".join(p for p, _ in parts))
        self.crc_parts = tuple((c, len(p)) for p, c in parts)
        return self

    def region_crc(self, prefix: bytes = b"") -> int:
        acc = crc32c(prefix)
        for c, ln in self.crc_parts:
            acc = crc32c_combine(acc, c, ln)
        return acc


def lz4f_frame(bodies) -> FrameBlob:
    """Assemble one LZ4F frame from per-block ``(comp, comp_crc, raw,
    raw_crc)`` tuples.  Block choice matches the native encoders
    bit-for-bit: the compressed body iff it is strictly smaller, else
    the raw bytes with the store-raw high bit on the length word."""
    parts = [(LZ4F_HEADER, _HEADER_CRC)]
    for comp, comp_crc, raw, raw_crc in bodies:
        if len(comp) < len(raw):
            word, body, crc = len(comp), comp, comp_crc
        else:
            word, body, crc = len(raw) | 0x80000000, bytes(raw), raw_crc
        prefix = struct.pack("<I", word)
        parts.append((prefix, crc32c(prefix)))
        parts.append((body, crc))
    parts.append((LZ4F_ENDMARK, _ENDMARK_CRC))
    return FrameBlob(parts)


def next_pow2(n: int, lo: int = 64) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _pack(buffers: list[bytes], N: int, left: bool) -> tuple[np.ndarray, np.ndarray]:
    B = len(buffers)
    out = np.zeros((B, N), dtype=np.uint8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, b in enumerate(buffers):
        n = len(b)
        lens[i] = n
        if n:
            arr = np.frombuffer(bytes(b), dtype=np.uint8)
            if left:
                out[i, N - n:] = arr
            else:
                out[i, :n] = arr
    return out, lens


def pad_left(buffers: list[bytes], N: int):
    """Right-aligned rows (leading zeros) — the TPU crc32c row layout."""
    return _pack(buffers, N, True)


def pad_right(buffers: list[bytes], N: int):
    """Left-aligned rows (trailing zeros) — the lz4 kernel layout."""
    return _pack(buffers, N, False)


def iter_run_records(base, klens, vlens, count, tss=None, hbuf=None,
                     hlens=None):
    """Walk a fast-lane arena run descriptor (the ArenaBatch layout:
    concatenated key||value payloads + raw little-endian length arrays,
    optional int64 timestamp and header-blob side arrays) and yield
    ``(key, value, ts_ms, hblob)`` per record.  Host-side inspection
    seam for the wire-equality gates and parity tests — the produce hot
    path never walks records in Python."""
    kl = np.frombuffer(klens, np.int32)[:count]
    vl = np.frombuffer(vlens, np.int32)[:count]
    ts = np.frombuffer(tss, np.int64)[:count] if tss is not None else None
    hl = (np.frombuffer(hlens, np.int32)[:count]
          if hbuf is not None else None)
    off = 0
    hoff = 0
    for i in range(count):
        k = v = hb = None
        if kl[i] >= 0:
            k = bytes(base[off:off + int(kl[i])])
            off += int(kl[i])
        if vl[i] >= 0:
            v = bytes(base[off:off + int(vl[i])])
            off += int(vl[i])
        if hl is not None and hl[i] > 0:
            hb = bytes(hbuf[hoff:hoff + int(hl[i])])
            hoff += int(hl[i])
        yield k, v, (int(ts[i]) if ts is not None else 0), hb
