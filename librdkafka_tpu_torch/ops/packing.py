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
with crc32c_combine instead of re-scanning the frame bytes.  The port's
writer phase accepts one (client/codec_phase.py); the device route that
produces them comes with the engine slice.
"""
from __future__ import annotations

import numpy as np

from ..utils.crc import crc32c, crc32c_combine


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
