"""MessageSet (RecordBatch) v2 writer + reader, plus legacy v0/v1.

This is the north-star seam (SURVEY.md §3.2): the reference builds each
partition batch in rd_kafka_msgset_create_ProduceRequest
(src/rdkafka_msgset_writer.c:1418) — write header, write records, compress
(writer_compress :1129), rewind + splice the compressed segment
(:1191-1203), then finalize by back-patching the v2 header and computing
CRC32C over [Attributes..end] (:1252,1230). The consumer side parses and
verifies in rd_kafka_msgset_reader.c (:950-1016, decompress :258-530).

The writer here is deliberately split into three phases so that *many*
partition batches can be compressed/checksummed in ONE batched codec-
provider call (the device offload axis, ops/gpu.py):

    w = MsgsetWriterV2(...); w.build(msgs)       # phase 1: frame records
    blobs = provider.compress_many(codec, [w.records_bytes ...])
    wire = w.finalize(compressed=blob)           # phase 3: splice + CRC

``finalize(None)`` is the uncompressed path. Single-shot ``write_batch()``
wraps all three for the simple case.

The port's copy of librdkafka_tpu/protocol/msgset.py.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from ..utils import varint
from ..utils.buf import SegBuf, Slice
from ..utils.crc import crc32
from ..utils.crc import crc32c as _crc32c_py
from . import proto
from .proto import (ATTR_CODEC_MASK, ATTR_CONTROL, ATTR_TRANSACTIONAL,
                    CODEC_IDS, CODEC_NAMES)

_crc32c_fast = None


def crc32c(data, crc: int = 0) -> int:
    """CRC32C via the native library (utils/crc.py's byte loop is a
    conformance oracle, never a hot path)."""
    global _crc32c_fast
    if _crc32c_fast is None:
        try:
            from ..ops.cpu import crc32c as _n
            _n(b"")          # force the native build now
            _crc32c_fast = _n
        except Exception:
            _crc32c_fast = _crc32c_py
    return _crc32c_fast(bytes(data), crc)


# precomputed zig-zag varints for common small framing values
_VI_CACHE = {v: varint.enc_i64(v) for v in range(-64, 8192)}

_frame_native = None     # resolved lazily: ops.cpu.frame_v2 | False


@dataclass
class Record:
    """A parsed (or to-be-written) record."""
    key: Optional[bytes] = None
    value: Optional[bytes] = None
    headers: Sequence[tuple[str, Optional[bytes]]] = ()
    timestamp: int = -1          # ms since epoch; -1 = now/unset
    offset: int = -1             # absolute offset (reader fills this)
    # batch-level context the reader attaches:
    msgver: int = 2
    is_control: bool = False
    is_transactional: bool = False
    producer_id: int = -1
    timestamp_type: int = proto.TSTYPE_CREATE_TIME


# ===================================================================== v2 ==

class MsgsetWriterV2:
    """RecordBatch v2 writer with deferred compression/CRC."""

    def __init__(self, *, base_offset: int = 0, producer_id: int = -1,
                 producer_epoch: int = -1, base_sequence: int = -1,
                 transactional: bool = False, control: bool = False,
                 codec: Optional[str] = None,
                 timestamp_type: int = proto.TSTYPE_CREATE_TIME):
        self.base_offset = base_offset
        self.producer_id = producer_id
        self.producer_epoch = producer_epoch
        self.base_sequence = base_sequence
        self.transactional = transactional
        # control batches (COMMIT/ABORT transaction markers) are broker-
        # written; the mock cluster's txn coordinator builds them here
        self.control = control
        self.codec = None if codec in (None, "none") else codec
        self.timestamp_type = timestamp_type
        self.records_bytes: bytes = b""
        self.record_count = 0
        self.first_timestamp = -1
        self.max_timestamp = -1
        self._wire: Optional[bytearray] = None

    # -- phase 1: frame records (uncompressed) ---------------------------
    def build(self, msgs, now_ms: int) -> "MsgsetWriterV2":
        """Frame all records (reference hot loop:
        rd_kafka_msgset_writer_write_msg_v2, rdkafka_msgset_writer.c:653).
        Headerless batches take the native single-call path (GIL released
        during framing); batches with headers use the Python framer."""
        global _frame_native
        if not isinstance(msgs, (list, tuple)):
            msgs = list(msgs)       # may be iterated twice (header fallback)
        if _frame_native is None:
            try:
                from ..ops.cpu import frame_v2 as _f
                _f(b"", [], [], [])
                _frame_native = _f
            except Exception:
                _frame_native = False
        if _frame_native:
            parts = []
            klens: list[int] = []
            vlens: list[int] = []
            tds: list[int] = []
            first_ts = -1
            max_ts = -1
            for m in msgs:
                if m.headers:
                    break               # headers: python framer
                ts = m.timestamp if m.timestamp and m.timestamp > 0 else now_ms
                if first_ts < 0:
                    first_ts = ts
                if ts > max_ts:
                    max_ts = ts
                tds.append(ts - first_ts)
                k = m.key
                if k is None:
                    klens.append(-1)
                else:
                    klens.append(len(k))
                    parts.append(k)
                v = m.value
                if v is None:
                    vlens.append(-1)
                else:
                    vlens.append(len(v))
                    parts.append(v)
            else:
                if not tds:
                    raise ValueError("empty batch")
                self.records_bytes = _frame_native(
                    b"".join(parts), klens, vlens, tds)
                self.record_count = len(tds)
                self.first_timestamp = first_ts
                self.max_timestamp = max_ts
                return self
        return self._build_py(msgs, now_ms)

    def build_arena(self, batch, now_ms: int) -> "MsgsetWriterV2":
        """Frame a fast-lane ArenaBatch: ONE native call straight off the
        arena's buffers, zero per-record Python work (the reference's
        zero-allocation hot loop, rdkafka_msgset_writer.c:653).  The
        all-default shape (no explicit timestamps, no headers) frames
        with every delta zero; widened runs carry per-record timestamps
        (0 = batch build time) and pre-encoded header blobs in side
        arrays, framed by the run-native framer in one call."""
        if batch.tss is None and batch.hbuf is None:
            from ..ops.cpu import frame_v2_raw
            self.records_bytes = frame_v2_raw(batch.base, batch.klens,
                                              batch.vlens, batch.count)
            self.first_timestamp = now_ms
            self.max_timestamp = now_ms
        else:
            from ..ops.cpu import frame_v2_run
            (self.records_bytes, self.first_timestamp,
             self.max_timestamp) = frame_v2_run(
                batch.base, batch.klens, batch.vlens, batch.count, now_ms,
                batch.tss, batch.hbuf, batch.hlens)
        self.record_count = batch.count
        return self

    def _build_py(self, msgs, now_ms: int) -> "MsgsetWriterV2":
        rb = bytearray()
        body = bytearray()            # reused scratch for each record body
        cache = _VI_CACHE
        enc = varint.enc_i64
        count = 0
        first_ts = -1
        max_ts = -1
        for m in msgs:
            ts = m.timestamp if m.timestamp and m.timestamp > 0 else now_ms
            if first_ts < 0:
                first_ts = ts
            if ts > max_ts:
                max_ts = ts
            del body[:]
            body.append(0)                    # record attributes (unused)
            d = ts - first_ts
            body += cache.get(d) or enc(d)    # timestamp delta
            body += cache.get(count) or enc(count)   # offset delta
            key = m.key
            if key is None:
                body.append(1)                # varint(-1)
            else:
                n = len(key)
                body += cache.get(n) or enc(n)
                body += key
            value = m.value
            if value is None:
                body.append(1)                # varint(-1)
            else:
                n = len(value)
                body += cache.get(n) or enc(n)
                body += value
            hdrs = m.headers
            if hdrs:
                body += cache.get(len(hdrs)) or enc(len(hdrs))
                for hk, hv in hdrs:
                    hkb = hk.encode() if isinstance(hk, str) else hk
                    body += cache.get(len(hkb)) or enc(len(hkb))
                    body += hkb
                    if hv is None:
                        body.append(1)
                    else:
                        body += cache.get(len(hv)) or enc(len(hv))
                        body += hv
            else:
                body.append(0)                # varint(0) headers
            n = len(body)
            rb += cache.get(n) or enc(n)
            rb += body
            count += 1
        if count == 0:
            raise ValueError("empty batch")
        self.records_bytes = bytes(rb)
        self.record_count = count
        self.first_timestamp = first_ts
        self.max_timestamp = max_ts
        return self

    # -- phase 3: assemble header + (compressed) records, patch CRC ------
    # [BaseOffset i64][Length i32][PLeaderEpoch i32][Magic i8][CRC u32]
    # [Attrs i16][LastOffsetDelta i32][FirstTs i64][MaxTs i64][PID i64]
    # [PEpoch i16][BaseSeq i32][RecordCount i32] = 61 bytes
    _HDR = struct.Struct(">qiibIhiqqqhii")

    def assemble(self, compressed: Optional[bytes] = None) -> memoryview:
        """Build the wire batch with CRC=0; returns the CRC region
        ([Attributes..end]) so MANY batches can be checksummed in one
        provider call (reference computes per-batch at finalize,
        rdkafka_msgset_writer.c:1230-1252 — here the CRC joins the
        compress step on the batched offload axis)."""
        attrs = 0
        if compressed is not None:
            assert self.codec, "compressed bytes supplied without codec"
            attrs |= CODEC_IDS[self.codec]
        if self.timestamp_type == proto.TSTYPE_LOG_APPEND_TIME:
            attrs |= proto.ATTR_TIMESTAMP_TYPE
        if self.transactional:
            attrs |= ATTR_TRANSACTIONAL
        if self.control:
            attrs |= ATTR_CONTROL
        payload = compressed if compressed is not None else self.records_bytes
        wire = bytearray(self._HDR.pack(
            self.base_offset,
            (proto.V2_HEADER_SIZE - proto.V2_OF_PartitionLeaderEpoch)
            + len(payload),                              # Length
            # PartitionLeaderEpoch=0 exactly like the reference writer
            # (rdkafka_msgset_writer.c:368, KIP-101) — producers don't
            # know the epoch; 0 keeps wire bytes bit-identical to it.
            0, 2, 0, attrs, self.record_count - 1,
            self.first_timestamp, self.max_timestamp, self.producer_id,
            self.producer_epoch, self.base_sequence, self.record_count))
        wire += payload
        self._wire = wire
        return memoryview(wire)[proto.V2_OF_Attributes:]

    def patch_crc(self, crc: int) -> bytes:
        struct.pack_into(">I", self._wire, proto.V2_OF_CRC, crc)
        return bytes(self._wire)

    def finalize(self, compressed: Optional[bytes] = None,
                 crc: Optional[int] = None) -> bytes:
        """Return the wire RecordBatch. ``compressed`` is the codec output
        for ``records_bytes`` (None = write uncompressed); ``crc`` is a
        precomputed CRC32C over [Attributes..end] (None = compute here,
        native)."""
        region = self.assemble(compressed)
        return self.patch_crc(crc if crc is not None else crc32c(region))

    def write_batch(self, msgs, now_ms: int, compress_fn=None) -> bytes:
        """One-shot build+compress+finalize (CPU path convenience)."""
        self.build(msgs, now_ms)
        comp = None
        if self.codec and compress_fn is not None:
            c = compress_fn(self.records_bytes)
            if len(c) < len(self.records_bytes):  # only keep if smaller
                comp = c
            else:
                self.codec = None
        return self.finalize(comp)


@dataclass
class BatchInfo:
    """Parsed RecordBatch header (reader side)."""
    base_offset: int
    length: int
    magic: int
    crc: int
    attrs: int
    last_offset_delta: int
    first_timestamp: int
    max_timestamp: int
    producer_id: int
    producer_epoch: int
    base_sequence: int
    record_count: int
    codec: Optional[str]
    is_transactional: bool
    is_control: bool


class CrcMismatch(Exception):
    pass


def read_batch_header(sl: Slice) -> BatchInfo:
    base_offset = sl.read_i64()
    length = sl.read_i32()
    sl.read_i32()                 # partition leader epoch
    magic = sl.read_i8()
    if magic != 2:
        raise ValueError(f"not a v2 batch (magic={magic})")
    crc = sl.read_u32()
    attrs = sl.read_i16()
    last_delta = sl.read_i32()
    first_ts = sl.read_i64()
    max_ts = sl.read_i64()
    pid = sl.read_i64()
    epoch = sl.read_i16()
    base_seq = sl.read_i32()
    count = sl.read_i32()
    return BatchInfo(
        base_offset=base_offset, length=length, magic=magic, crc=crc,
        attrs=attrs, last_offset_delta=last_delta, first_timestamp=first_ts,
        max_timestamp=max_ts, producer_id=pid, producer_epoch=epoch,
        base_sequence=base_seq, record_count=count,
        codec=CODEC_NAMES.get(attrs & ATTR_CODEC_MASK),
        is_transactional=bool(attrs & ATTR_TRANSACTIONAL),
        is_control=bool(attrs & ATTR_CONTROL))


def parse_records_v2(info: BatchInfo, records_bytes: bytes) -> list[Record]:
    """Parse the (decompressed) records section of a v2 batch.

    Hot path: the varint field walk runs in native code (tk_parse_v2 in
    ops/native/codec.cpp — it was ~40% of consume time in Python);
    Python slices the key/value bytes and decodes headers only for the
    rare records that have them. Falls back to the pure-Python walk if
    the native library is unavailable."""
    if not isinstance(records_bytes, bytes):
        # Record.key/value must be owned bytes (this is the
        # inspection/test path; the consume hot path materializes
        # Messages straight off views via parse_fetch_messages_v2)
        records_bytes = bytes(records_bytes)
    try:
        return _parse_records_v2_native(info, records_bytes)
    except _NativeUnavailable:
        pass
    return _parse_records_v2_py(info, records_bytes)


class _NativeUnavailable(Exception):
    pass


def _parse_records_v2_native(info: BatchInfo,
                             records_bytes: bytes) -> list[Record]:
    import ctypes

    import numpy as np

    from ..ops import cpu as _cpu
    try:
        L = _cpu.lib()
    except Exception as e:
        raise _NativeUnavailable from e
    n = info.record_count
    if n <= 0:
        return []
    # a v2 record is >= 7 bytes; a forged record_count must not drive
    # the allocation (the Fetch payload is untrusted network data)
    if n > len(records_bytes) // 7 + 1:
        raise CrcMismatch(
            f"record_count {n} impossible for {len(records_bytes)} bytes")
    fields = np.empty((n, 8), dtype=np.int64)
    got = L.tk_parse_v2(
        records_bytes, len(records_bytes), n,
        fields.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if got != n:
        raise CrcMismatch(f"malformed v2 records: parsed {got} of {n}")
    log_append = bool(info.attrs & proto.ATTR_TIMESTAMP_TYPE)
    tstype = (proto.TSTYPE_LOG_APPEND_TIME if log_append
              else proto.TSTYPE_CREATE_TIME)
    base_ts = info.first_timestamp
    base_off = info.base_offset
    rows = fields.tolist()          # one bulk conversion, not n array reads
    out = []
    for ts_d, off_d, ko, kl, vo, vl, ho, nh in rows:
        key = records_bytes[ko:ko + kl] if kl >= 0 else None
        value = records_bytes[vo:vo + vl] if vl >= 0 else None
        headers = _parse_headers(records_bytes, ho, nh) if nh else []
        out.append(Record(
            key=key, value=value, headers=headers,
            timestamp=(info.max_timestamp if log_append
                       else base_ts + ts_d),
            offset=base_off + off_d, msgver=2,
            is_control=info.is_control,
            is_transactional=info.is_transactional,
            producer_id=info.producer_id, timestamp_type=tstype))
    return out


def parse_fetch_messages_v2(info: BatchInfo, records_bytes: bytes,
                            topic: str, partition: int,
                            fo: int) -> tuple[list, int]:
    """Fetch hot path: build delivery-ready client Message objects
    straight off the native field walk — no intermediate Record and no
    Message.__init__ (its two clock reads and len() calls cost ~1.5
    us/record against the ~2.5 us/msg consume budget). Records below
    ``fo`` are skipped here so the caller doesn't re-walk the list.
    Returns (messages, payload_bytes_total).

    Falls back to the Record path when the native walk is unavailable.
    (Late client import: the client layer imports protocol at module
    level, so this call-time import cannot cycle.)"""
    from ..client.msg import Message, MsgStatus

    import ctypes

    import numpy as np

    from ..ops import cpu as _cpu
    try:
        L = _cpu.lib()
    except Exception:
        out0, total0 = [], 0
        for r in parse_records_v2(info, records_bytes):
            if r.offset < fo:
                continue
            m = Message(topic, value=r.value, key=r.key,
                        partition=partition, headers=r.headers,
                        timestamp=r.timestamp)
            m.offset = r.offset
            m.timestamp_type = r.timestamp_type
            out0.append(m)
            total0 += m.size
        return out0, total0
    n = info.record_count
    if n <= 0:
        return [], 0
    if n > len(records_bytes) / 7 + 1:
        raise CrcMismatch(
            f"record_count {n} impossible for {len(records_bytes)} bytes")
    fields = np.empty((n, 8), dtype=np.int64)
    # records_bytes may be a memoryview into the response frame (the
    # zero-copy fetch path): hand the walk its address via numpy, which
    # wraps read-only buffers without copying
    src = np.frombuffer(records_bytes, dtype=np.uint8)
    got = L.tk_parse_v2(
        src.ctypes.data_as(ctypes.c_char_p), len(records_bytes), n,
        fields.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if got != n:
        raise CrcMismatch(f"malformed v2 records: parsed {got} of {n}")
    # LOG_APPEND_TIME: the broker stamps only MaxTimestamp; per-record
    # deltas still carry producer create times and must be IGNORED —
    # every record reports the batch append time (reference:
    # rdkafka_msgset_reader.c:902-908)
    log_append = bool(info.attrs & proto.ATTR_TIMESTAMP_TYPE)
    tstype = (proto.TSTYPE_LOG_APPEND_TIME if log_append
              else proto.TSTYPE_CREATE_TIME)
    base_ts = info.first_timestamp
    append_ts = info.max_timestamp
    base_off = info.base_offset
    not_persisted = MsgStatus.NOT_PERSISTED
    lazy = _materializer_lazy()
    if lazy is not None:
        # hot path: FetchMessage with LAZY key/value (packed
        # buffer offsets; bytes created on first .value access) —
        # offset-commit-only consumers never pay the payload copy
        from ..client.msg import FetchMessage
        out, total, fixups = lazy(
            FetchMessage, records_bytes, fields.ctypes.data, n, topic,
            partition, base_off, fo, base_ts, append_ts,
            1 if log_append else 0, tstype, not_persisted)
        if fixups is not None:
            for idx, ho, nh in fixups:
                out[idx]._h = _parse_headers(records_bytes, ho, nh)
        return out, total
    mat = _materializer()
    if mat is not None:
        # bulk native materialization: tp_alloc + direct slot stores per
        # record instead of 18 bytecode attribute sets (enqlane.cpp)
        out, total, fixups = mat(
            Message, records_bytes, fields.ctypes.data, n, topic,
            partition, base_off, fo, base_ts, append_ts,
            1 if log_append else 0, tstype, not_persisted)
        if fixups is not None:
            for idx, ho, nh in fixups:
                out[idx].headers = _parse_headers(records_bytes, ho, nh)
        return out, total
    new = Message.__new__
    out = []
    append = out.append
    total = 0
    if not isinstance(records_bytes, bytes):
        records_bytes = bytes(records_bytes)   # keys/values sliced below
    for ts_d, off_d, ko, kl, vo, vl, ho, nh in fields.tolist():
        off = base_off + off_d
        if off < fo:
            continue
        m = new(Message)
        m.topic = topic
        m.partition = partition
        m.key = records_bytes[ko:ko + kl] if kl >= 0 else None
        m.value = records_bytes[vo:vo + vl] if vl >= 0 else None
        m.headers = _parse_headers(records_bytes, ho, nh) if nh else []
        m.offset = off
        m.timestamp = append_ts if log_append else base_ts + ts_d
        m.timestamp_type = tstype
        m.error = None
        m.opaque = None
        m.msgid = 0
        m.retries = 0
        m.status = not_persisted
        m.enq_time = 0.0
        m.ts_backoff = 0.0
        m.latency_us = 0
        m.on_delivery = None
        sz = (vl if vl > 0 else 0) + (kl if kl > 0 else 0)
        m.size = sz
        total += sz
        append(m)
    return out, total


_MAT = None
_MAT_ERR = False
_LAZY = None
_LAZY_ERR = False


def _materializer_lazy():
    """tk_torch_enqlane.materialize_v2_lazy, or None when unavailable."""
    global _LAZY, _LAZY_ERR
    if _LAZY is None and not _LAZY_ERR:
        try:
            from ..client.arena import _mod
            m = _mod()
            _LAZY = getattr(m, "materialize_v2_lazy", None) if m else None
            if _LAZY is None:
                _LAZY_ERR = True
        except Exception:
            _LAZY_ERR = True
    return _LAZY


def _materializer():
    """tk_torch_enqlane.materialize_v2, or None when the extension is
    unavailable (pure-Python fallback below stays authoritative)."""
    global _MAT, _MAT_ERR
    if _MAT is None and not _MAT_ERR:
        try:
            from ..client.arena import _mod
            m = _mod()
            _MAT = getattr(m, "materialize_v2", None) if m else None
            if _MAT is None:
                _MAT_ERR = True
        except Exception:
            _MAT_ERR = True
    return _MAT


def _parse_headers(buf: bytes, off: int, nh: int) -> list:
    sl = Slice(buf)
    sl.skip(off)
    return _read_headers(sl, nh)


def _read_headers(sl: "Slice", nh: int) -> list:
    headers = []
    for _ in range(nh):
        hklen = sl.read_varint()
        hk = sl.read(hklen).decode("utf-8", "replace")
        hvlen = sl.read_varint()
        hv = None if hvlen < 0 else sl.read(hvlen)
        headers.append((hk, hv))
    return headers


def _parse_records_v2_py(info: BatchInfo,
                         records_bytes: bytes) -> list[Record]:
    sl = Slice(records_bytes)
    log_append = bool(info.attrs & proto.ATTR_TIMESTAMP_TYPE)
    tstype = (proto.TSTYPE_LOG_APPEND_TIME if log_append
              else proto.TSTYPE_CREATE_TIME)
    out = []
    for _ in range(info.record_count):
        rec_len = sl.read_varint()
        rsl = sl.narrow(rec_len)
        rsl.read_i8()                       # record attributes
        ts_delta = rsl.read_varint()
        off_delta = rsl.read_varint()
        klen = rsl.read_varint()
        key = None if klen < 0 else rsl.read(klen)
        vlen = rsl.read_varint()
        value = None if vlen < 0 else rsl.read(vlen)
        nh = rsl.read_varint()
        headers = _read_headers(rsl, nh) if nh else []
        out.append(Record(
            key=key, value=value, headers=headers,
            timestamp=(info.max_timestamp if log_append
                       else info.first_timestamp + ts_delta),
            offset=info.base_offset + off_delta, msgver=2,
            is_control=info.is_control,
            is_transactional=info.is_transactional,
            producer_id=info.producer_id, timestamp_type=tstype))
    return out


def iter_batches(data):
    """Yield (BatchInfo, records_payload, full_batch) for each complete
    batch in a Fetch-response records blob. Brokers may return a partial
    batch at the tail — it is skipped (reference reader behavior).

    payload/full come back as memoryviews into ``data`` (no per-batch
    copy); every downstream consumer — the batched CRC verify, the
    native decompress, the record walk/materializer — reads them via
    the buffer protocol.  Callers that need owned bytes wrap with
    ``bytes(...)``."""
    mv = data if isinstance(data, memoryview) else memoryview(data)
    sl = Slice(mv)
    while sl.remains() >= proto.V2_HEADER_SIZE:
        start = sl.offset
        try:
            info = read_batch_header(sl)
        except Exception:
            return
        batch_total = proto.V2_OF_Length + 4 + info.length
        payload_len = batch_total - proto.V2_HEADER_SIZE
        if payload_len < 0 or sl.remains() < payload_len:
            return  # partial batch at tail
        payload = sl.view(payload_len)
        yield info, payload, mv[start:start + batch_total]


def verify_crc_v2(info: BatchInfo, full_batch: bytes) -> bool:
    """CRC32C over [Attributes..end] must equal the stored CRC."""
    return crc32c(full_batch[proto.V2_OF_Attributes:]) == info.crc


# ================================================================= v0/v1 ==
# Legacy MessageSet: [Offset i64][MessageSize i32][Crc u32(zlib)][Magic i8]
# [Attributes i8][Timestamp i64 (v1 only)][Key bytes][Value bytes].
# Compression wraps an inner MessageSet in a single wrapper message.
# (reference: rdkafka_msgset_writer.c MsgVersion<2 paths, reader :530-720)

def write_message_v01(buf: SegBuf, *, offset: int, magic: int, attrs: int,
                      timestamp: int, key: Optional[bytes],
                      value: Optional[bytes]) -> None:
    buf.write_i64(offset)
    size_pos = buf.write_i32(0)
    crc_pos = buf.write_u32(0)
    crc_start = buf.write_i8(magic)
    buf.write_i8(attrs)
    if magic == 1:
        buf.write_i64(timestamp)
    for b in (key, value):
        if b is None:
            buf.write_i32(-1)
        else:
            buf.write_i32(len(b))
            buf.write(b)
    end = len(buf)
    buf.update_i32(size_pos, end - (size_pos + 4))
    buf.update_u32(crc_pos, crc32(buf.as_bytes(crc_start, end)))


def write_msgset_v01(msgs: Iterable[Record], *, magic: int, codec: Optional[str],
                     now_ms: int, compress_fn=None,
                     base_offset: int = 0) -> bytes:
    inner = SegBuf()
    n = 0
    compressed = codec not in (None, "none") and compress_fn is not None
    for i, m in enumerate(msgs):
        ts = m.timestamp if m.timestamp and m.timestamp > 0 else now_ms
        # v1 compression wrappers carry *relative* inner offsets 0..n-1;
        # the wrapper offset is the absolute offset of the LAST message
        # (reference reader fixup at rdkafka_msgset_reader.c:666).
        off = i if (compressed and magic == 1) else base_offset + i
        write_message_v01(inner, offset=off, magic=magic, attrs=0,
                          timestamp=ts, key=m.key, value=m.value)
        n += 1
    raw = inner.as_bytes()
    if not codec or codec == "none" or compress_fn is None:
        return raw
    comp = compress_fn(raw)
    wrapper = SegBuf()
    # wrapper offset: v1 uses last inner offset (relative-offset era), v0 uses 0
    woffset = (base_offset + n - 1) if magic == 1 else base_offset
    write_message_v01(wrapper, offset=woffset, magic=magic,
                      attrs=CODEC_IDS[codec], timestamp=now_ms, key=None,
                      value=comp)
    return wrapper.as_bytes()


def split_msgset_segments(data) -> list[tuple[str, bytes]]:
    """Split a fetch records blob into maximal same-format runs —
    ("legacy", bytes) for v0/v1 messagesets, ("v2", bytes) for
    RecordBatches — preserving order. Logs written across a 0.11
    upgrade hold both; the reference reader dispatches per MessageSet
    from each header's MsgVersion (rdkafka_msgset_reader.c:1410).
    Both formats share the [i64 offset][i32 size] frame prefix with the
    magic byte at offset 16, so one uniform walk discriminates.
    A partial trailing frame is dropped (broker may truncate)."""
    segs: list[tuple[str, bytes]] = []
    off, n = 0, len(data)
    start = 0
    cur: Optional[str] = None
    while n - off >= 17:
        size = int.from_bytes(data[off + 8:off + 12], "big", signed=True)
        if size < 5 or off + 12 + size > n:
            break                       # partial/garbled tail
        kind = "v2" if data[off + 16] == 2 else "legacy"
        if cur is None:
            cur = kind
        elif kind != cur:
            segs.append((cur, bytes(data[start:off])))
            start, cur = off, kind
        off += 12 + size
    if cur is not None and off > start:
        if start == 0 and off == n:
            # single same-format run covering the whole blob (the
            # common case): hand back the caller's object uncopied —
            # it may be a memoryview into the response frame
            segs.append((cur, data))
        else:
            segs.append((cur, bytes(data[start:off])))
    return segs


def iter_legacy_crc_regions(data) -> list[tuple[int, int, bytes]]:
    """[(offset, stored_crc, crc_region)] for each top-level message of
    a legacy v0/v1 MessageSet. The per-message CRC (zlib polynomial,
    reference src/rdcrc32.c) covers [Magic..end-of-message]; for a
    compression wrapper that region includes the compressed payload, so
    verifying top-level frames checks the whole wire blob. Partial
    trailing messages are skipped (reference reader behavior)."""
    out = []
    data = bytes(data)
    sl = Slice(data)
    while sl.remains() >= 12:
        offset = sl.read_i64()
        size = sl.read_i32()
        if size < 4 or sl.remains() < size:
            break
        start = sl.offset
        crc = sl.read_u32()
        out.append((offset, crc, data[start + 4:start + size]))
        sl.skip(size - 4)
    return out


def parse_msgset_v01(data: bytes, decompress_fn=None) -> list[Record]:
    """Parse a legacy MessageSet, recursing into compression wrappers."""
    out: list[Record] = []
    sl = Slice(data)
    while sl.remains() >= 12:
        offset = sl.read_i64()
        size = sl.read_i32()
        if sl.remains() < size:
            break  # partial trailing message
        msl = sl.narrow(size)
        msl.read_u32()  # crc (verified optionally at a higher layer)
        magic = msl.read_i8()
        attrs = msl.read_i8()
        ts = -1
        if magic >= 1:
            ts = msl.read_i64()
        klen = msl.read_i32()
        key = None if klen < 0 else msl.read(klen)
        vlen = msl.read_i32()
        value = None if vlen < 0 else msl.read(vlen)
        codec = CODEC_NAMES.get(attrs & ATTR_CODEC_MASK)
        if codec and value is not None:
            if decompress_fn is None:
                raise ValueError(f"compressed ({codec}) legacy messageset "
                                 "but no decompressor supplied")
            inner = parse_msgset_v01(decompress_fn(codec, value),
                                     decompress_fn)
            if magic == 1 and inner:
                # v1 wrapper carries absolute offset of LAST inner message;
                # inner offsets are 0..n-1 relative (reference reader :666)
                base = offset - (len(inner) - 1)
                for r in inner:
                    r.offset += base
            out.extend(inner)
        else:
            out.append(Record(key=key, value=value, timestamp=ts,
                              offset=offset, msgver=magic))
    return out
