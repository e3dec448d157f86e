"""Message objects and partitioners (reference: src/rdkafka_msg.c).

``Message`` is the app-visible object (rd_kafka_message_t analog) carrying
payload/key/headers/offset/timestamp/error plus the internal delivery
state used by the idempotent producer (persistence status, msgid,
retries). Partitioners mirror the reference set (rdkafka_msg.c:797-869):
random, consistent, consistent_random, murmur2, murmur2_random.
"""
from __future__ import annotations

import enum
import random
import time
from typing import Optional, Sequence

from ..protocol import proto
from ..utils.hash import consistent_partition, murmur2_partition
from .errors import Err, KafkaError

PARTITION_UA = -1  # unassigned: partitioner decides


class MsgStatus(enum.Enum):
    """Delivery status (rd_kafka_msg_status_t): drives idempotent retry
    safety — POSSIBLY_PERSISTED messages may not be retried blindly."""
    NOT_PERSISTED = 0
    POSSIBLY_PERSISTED = 1
    PERSISTED = 2


class Message:
    __slots__ = ("topic", "partition", "key", "value", "headers", "offset",
                 "timestamp", "timestamp_type", "error", "opaque", "msgid",
                 "retries", "status", "enq_time", "ts_backoff", "latency_us",
                 "on_delivery",
                 "size")

    def __init__(self, topic: str, value: Optional[bytes] = None,
                 key: Optional[bytes] = None,
                 headers: Sequence[tuple[str, Optional[bytes]]] = (),
                 partition: int = PARTITION_UA, timestamp: int = 0,
                 opaque=None):
        self.topic = topic
        self.partition = partition
        self.key = key
        self.value = value
        self.headers = list(headers) if headers else []
        self.offset = proto.OFFSET_INVALID
        self.timestamp = timestamp or int(time.time() * 1000)
        self.timestamp_type = proto.TSTYPE_CREATE_TIME
        self.error: Optional[KafkaError] = None
        self.opaque = opaque
        self.msgid = 0            # producer-assigned FIFO id (idempotence)
        self.retries = 0
        self.status = MsgStatus.NOT_PERSISTED
        self.enq_time = time.monotonic()
        self.ts_backoff = 0.0
        self.latency_us = 0
        self.on_delivery = None       # per-message DR callback
        self.size = (len(value) if value else 0) + (len(key) if key else 0)

    def __len__(self) -> int:
        return self.size

    def __bool__(self) -> bool:
        # an empty message (size 0) must not be falsy: the idiomatic
        # `m = c.poll(...); if m and not m.error:` loop would silently
        # drop empty-value records via __len__ otherwise
        return True

    def __repr__(self):
        return (f"Message({self.topic}[{self.partition}]@{self.offset}"
                f"{' err=' + self.error.code.name if self.error else ''})")


class FetchMessage:
    """Consumer-side message with LAZY key/value/headers: the native
    bulk materializer stores the shared records buffer plus packed
    (offset << 32 | length) ints per record; the bytes objects are
    created only when the app reads ``.value``/``.key`` and are cached
    on first access. Offset-commit-only consumers and key filters
    never pay the per-record payload copy (the reference's rko_msg
    points into the fetch buffer the same way,
    rdkafka_msgset_reader.c:715).

    Also the delivery-report message for fast-lane batches
    (materialize_arena_lazy): ``status`` and ``error`` are per-instance
    slots stamped per batch at materialization. The remaining
    producer-internal fields (msgid, retries, on_delivery, ...) are
    class-level constants — readable, never set on these messages."""

    __slots__ = ("topic", "partition", "offset", "timestamp",
                 "timestamp_type", "error", "status",
                 "_buf", "_v", "_k", "_h")

    msgid = 0
    retries = 0
    opaque = None
    on_delivery = None
    enq_time = 0.0
    ts_backoff = 0.0
    latency_us = 0

    @property
    def value(self) -> Optional[bytes]:
        v = self._v
        if type(v) is int:
            o = v >> 32
            v = self._buf[o:o + (v & 0xFFFFFFFF)]
            if type(v) is not bytes:
                v = bytes(v)          # memoryview slice (zero-copy path)
            self._v = v               # cache: second read is free
        return v

    @property
    def key(self) -> Optional[bytes]:
        k = self._k
        if type(k) is int:
            o = k >> 32
            k = self._buf[o:o + (k & 0xFFFFFFFF)]
            if type(k) is not bytes:
                k = bytes(k)
            self._k = k
        return k

    @property
    def headers(self) -> list:
        h = self._h
        return h if h is not None else []

    @property
    def size(self) -> int:
        v, k = self._v, self._k
        n = (v & 0xFFFFFFFF) if type(v) is int else (len(v) if v else 0)
        n += (k & 0xFFFFFFFF) if type(k) is int else (len(k) if k else 0)
        return n

    def __len__(self) -> int:
        return self.size

    def __bool__(self) -> bool:
        return True

    def __repr__(self):
        return (f"Message({self.topic}[{self.partition}]@{self.offset}"
                f"{' err=' + self.error.code.name if self.error else ''})")


def partition_random(key, cnt, rnd=random.random):
    return int(rnd() * cnt) % cnt


def partitioner_fn(name: str):
    """Resolve a partitioner by config name; returns f(key, cnt) -> int."""
    if name == "random":
        return lambda key, cnt: partition_random(key, cnt)
    if name == "consistent":
        return lambda key, cnt: consistent_partition(key or b"", cnt)
    if name == "consistent_random":
        return lambda key, cnt: (consistent_partition(key, cnt) if key
                                 else partition_random(key, cnt))
    if name == "murmur2":
        return lambda key, cnt: murmur2_partition(key or b"", cnt)
    if name == "murmur2_random":
        return lambda key, cnt: (murmur2_partition(key, cnt) if key
                                 else partition_random(key, cnt))
    raise ValueError(f"unknown partitioner {name!r}")
