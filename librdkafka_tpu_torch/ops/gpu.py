"""GPU codec provider — the port of librdkafka_tpu/ops/tpu.py's synchronous
routes (``tpu.pipeline.depth=0``).

The same MsgsetCodecProvider interface as the CPU provider; only the
batched checksums leave the host:

  * ``crc32c_many`` / ``crc32_many``: at and above ``min_batches``
    buffers, one launch of the hand-written segment kernel per 64 MB of
    buffers, packed with no padding (ops/crc32c_torch.py,
    csrc/crc_rows.cu), as tpu.py:453-467 and :480-500 route them; below
    it, the CPU provider.
  * lz4 compression stays on the native CPU path, exactly as tpu.py:284-294
    routes it without ``tpu.lz4.force``; decompression is always the CPU
    provider's (tpu.py:296-304).

Not here yet (engine slice): the transport probe, the warmup thread and
the async engine.  Until then the device route is always open, like the
JAX provider with ``min_transport_mb_s=0``, and the legacy crc32 route
has no background-compile gate (the kernel is built at first use).
Wire bytes are identical to the CPU provider's by construction.
"""
from __future__ import annotations

from . import cpu as _cpu
from . import crc32c_torch


class GpuCodecProvider:
    """MsgsetCodecProvider with the CRC batches on the GPU.

    ``device=None`` is the card (``cuda``); a host without CUDA raises
    rather than serving from the CPU.  ``device="cpu"`` runs the
    kernel's plain PyTorch version on the host (the tests' route)."""

    name = "gpu"

    def __init__(self, min_batches: int = 4, device=None):
        # below this many independent buffers a launch isn't worth it;
        # fall back to the CPU provider (identical bytes either way).
        self.min_batches = max(1, int(min_batches))
        self.device = crc32c_torch.resolve_device(device)
        self._cpu = _cpu.CpuCodecProvider()

    def compress_many(self, codec: str, bufs: list[bytes], level: int = -1
                      ) -> list[bytes]:
        return self._cpu.compress_many(codec, bufs, level)

    def decompress_many(self, codec: str, bufs: list[bytes],
                        size_hints: list[int] | None = None) -> list[bytes]:
        return self._cpu.decompress_many(codec, bufs, size_hints)

    def crc32c_many(self, bufs: list[bytes]) -> list[int]:
        if len(bufs) >= self.min_batches:
            return crc32c_torch.crc32c_many(bufs, self.device).tolist()
        return self._cpu.crc32c_many(bufs)

    def crc32_many(self, bufs: list[bytes]) -> list[int]:
        """Legacy MsgVer0/1 zlib-poly CRC on the same kernel."""
        if len(bufs) >= self.min_batches:
            return crc32c_torch.crc32_many(bufs, self.device).tolist()
        return self._cpu.crc32_many(bufs)

    def fused_codec_id(self, codec: str) -> int | None:
        """None: the device route keeps the 3-phase pipeline (frame,
        compress, batched device CRC), as the JAX provider does whenever
        its device route is open."""
        return None

    def close(self) -> None:
        """Nothing to release: the synchronous provider owns no thread,
        stream or staging buffer."""
