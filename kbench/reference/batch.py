"""Kafka RecordBatch v2 (magic 2) parsing in plain Python, as the
protocol's published message format defines it.

Header, 61 bytes, big-endian::

    baseOffset int64, batchLength int32, partitionLeaderEpoch int32,
    magic int8, crc uint32, attributes int16, lastOffsetDelta int32,
    firstTimestamp int64, maxTimestamp int64, producerId int64,
    producerEpoch int16, baseSequence int32, recordCount int32

The CRC32C covers everything from ``attributes`` to the batch's end.
Records (after decompression when the attributes' codec bits are set)::

    length varint, attributes int8, timestampDelta varlong,
    offsetDelta varint, keyLength varint, key, valueLength varint,
    value, headerCount varint, headers
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

HEADER = struct.Struct(">qiibIhiqqqhii")
HEADER_SIZE = HEADER.size            # 61
CRC_START = 21                       # attributes' offset in the batch
CODECS = {0: "none", 1: "gzip", 2: "snappy", 3: "lz4", 4: "zstd"}


class BatchError(ValueError):
    pass


@dataclass
class Batch:
    base_offset: int
    length: int                      # batchLength + 12: the whole batch
    leader_epoch: int
    magic: int
    crc: int
    attributes: int
    last_offset_delta: int
    first_timestamp: int
    max_timestamp: int
    producer_id: int
    producer_epoch: int
    base_sequence: int
    record_count: int
    start: int                       # where the batch starts in its log

    @property
    def codec(self) -> str:
        return CODECS.get(self.attributes & 7, "unknown")

    @property
    def transactional(self) -> bool:
        return bool(self.attributes & 0x10)

    @property
    def control(self) -> bool:
        return bool(self.attributes & 0x20)


def iter_batches(log: bytes):
    """Every batch of a partition's log bytes, in order; raises
    :class:`BatchError` where a header is cut off or is not magic 2."""
    pos = 0
    n = len(log)
    while pos < n:
        if pos + HEADER_SIZE > n:
            raise BatchError(f"header cut off at {pos}")
        f = HEADER.unpack_from(log, pos)
        b = Batch(f[0], f[1] + 12, *f[2:], start=pos)
        if b.magic != 2:
            raise BatchError(f"magic {b.magic} at {pos}")
        if b.length < HEADER_SIZE or pos + b.length > n:
            raise BatchError(f"batch length {b.length} at {pos}")
        yield b
        pos += b.length


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    """A zigzag varint at ``i``: (value, next position)."""
    shift = 0
    v = 0
    while True:
        if i >= len(buf):
            raise BatchError("varint cut off")
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return (v >> 1) ^ -(v & 1), i
        shift += 7
        if shift > 63:
            raise BatchError("varint too long")


@dataclass
class Record:
    offset_delta: int
    timestamp_delta: int
    key: bytes | None
    value: bytes | None
    headers: list


def parse_records(payload: bytes, count: int) -> list[Record]:
    """``count`` records of an uncompressed records section, which they
    must fill exactly."""
    out = []
    i = 0
    for _ in range(count):
        length, i = _varint(payload, i)
        end = i + length
        if length < 0 or end > len(payload):
            raise BatchError("record length")
        i += 1                                   # attributes
        ts, i = _varint(payload, i)
        od, i = _varint(payload, i)
        kl, i = _varint(payload, i)
        key = None if kl < 0 else payload[i:i + kl]
        i += max(kl, 0)
        vl, i = _varint(payload, i)
        value = None if vl < 0 else payload[i:i + vl]
        i += max(vl, 0)
        nh, i = _varint(payload, i)
        headers = []
        for _h in range(nh):
            hk, i = _varint(payload, i)
            name = payload[i:i + hk]
            i += hk
            hv, i = _varint(payload, i)
            headers.append((name, None if hv < 0 else payload[i:i + hv]))
            i += max(hv, 0)
        if i != end:
            raise BatchError("record fields do not fill its length")
        out.append(Record(od, ts, key, value, headers))
    if i != len(payload):
        raise BatchError(f"{len(payload) - i} B after the last record")
    return out
