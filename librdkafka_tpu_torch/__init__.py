"""librdkafka_tpu_torch — the PyTorch / CUDA port of librdkafka_tpu.

The port goes slice by slice beside the JAX package, which stays the
reference it is held against.  It holds the Kafka client (producer,
consumer, consumer groups, transactions, admin, stats) with the in-process
mock cluster, and the layer that owns the device: the MessageSet v2 codec,
its batched CRC offload and its device lz4 compression, selected by
``compression.backend=gpu``.

- ``utils``    — CRC32C/CRC32 tables and combines, varint, segmented
                 buffers, murmur2 partitioning, socket buffers
- ``protocol`` — protocol constants, request/response schemas, MessageSet
                 v2 and v0/v1 writer/reader
- ``ops``      — native C++ CPU codec provider (ctypes) and the native
                 enqueue lane (``tk_torch_enqlane``), the GPU provider, its
                 async offload engine (``ops/engine.py``) and the
                 hand-written CUDA kernels: CRC (``csrc/crc_rows.cu``) and
                 LZ4 with a fused CRC epilogue (``csrc/lz4_rows.cu``)
- ``models``   — the batched codec step (compress + CRC in one launch)
- ``client``   — Producer, Consumer, AdminClient, the broker threads, and
                 the broker's writer phase and fetch verify on their own
                 (``submit_batches`` / ``submit_read``, ``write_batches`` /
                 ``read_batches``)
- ``mock``     — the in-process mock cluster, the sockem shim, the
                 standalone supervised cluster and its client-side
                 handle (``mock.external.ClusterHandle``)
- ``chaos``, ``fleet`` — fault schedules, the delivery oracle and the
                 storm library; multi-process client fleets
- ``analysis``, ``obs`` — lockdep / lockset checkers, the project lint and
                 the stress gate, tracing, metrics and trace collection
- ``capi``     — the C ABI (libtkafka.so + tkafka.h, built by gcc from a
                 hand-written shim over an embedded CPython) and its C++
                 wrapper ``tkafka.hpp``
- ``examples`` — producer, consumer, admin, performance and the
                 verifiable client, run as ``python -m
                 librdkafka_tpu_torch.examples.<name>``

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, or the conf key ``gpu.device=cpu``).  Importing the
package, and running a client on the CPU provider, loads no torch: the
GPU provider is exported lazily, so broker and fleet processes start
without it.
"""

__version__ = "0.1.0"
# Wire-compatible with the reference's feature level (rdkafka.h:151,
# RD_KAFKA_VERSION 0x010300ff == v1.3.0).
REFERENCE_VERSION = "1.3.0"

from .client.errors import KafkaError, KafkaException  # noqa: F401
from .client.conf import Conf, TopicConf  # noqa: F401
from .client.producer import Producer  # noqa: F401
from .client.consumer import Consumer  # noqa: F401
from .client.admin import (AdminClient, ConfigEntry, ConfigResource,  # noqa: F401
                           NewPartitions, NewTopic)
from .client.event import Event  # noqa: F401
from .client.codec_phase import (read_batches, submit_batches,  # noqa: F401
                                 submit_read, write_batches)
from .ops.cpu import CpuCodecProvider  # noqa: F401


def __getattr__(name: str):
    """``GpuCodecProvider`` on first use: ops/gpu.py imports torch."""
    if name == "GpuCodecProvider":
        from .ops.gpu import GpuCodecProvider
        globals()[name] = GpuCodecProvider
        return GpuCodecProvider
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
