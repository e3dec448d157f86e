"""librdkafka_tpu_torch — the PyTorch / CUDA port of librdkafka_tpu.

The port goes slice by slice beside the JAX package, which stays the
reference it is held against.  The slices so far hold the layer that owns
the device: the MessageSet v2 codec, its batched CRC offload and its
device lz4 compression.

- ``utils``    — CRC32C/CRC32 tables and combines, varint, segmented buffers
- ``protocol`` — protocol constants, MessageSet v2 and v0/v1 writer/reader
- ``ops``      — native C++ CPU codec provider (ctypes), the GPU provider,
                 its async offload engine (``ops/engine.py``) and the
                 hand-written CUDA kernels: CRC (``csrc/crc_rows.cu``) and
                 LZ4 with a fused CRC epilogue (``csrc/lz4_rows.cu``)
- ``models``   — the batched codec step (compress + CRC in one launch)
- ``client``   — the broker's writer phase and fetch verify, ticketed
                 (``submit_batches`` / ``submit_read``) or resolved at once
                 (``write_batches`` / ``read_batches``)
- ``analysis``, ``obs`` — lockdep / lockset checkers, tracing and metrics

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .client.codec_phase import (read_batches, submit_batches,  # noqa: F401
                                 submit_read, write_batches)
from .ops.cpu import CpuCodecProvider  # noqa: F401
from .ops.gpu import GpuCodecProvider  # noqa: F401
