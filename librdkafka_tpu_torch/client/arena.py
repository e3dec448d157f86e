"""Fast-lane produce batches backed by the native enqueue arena.

The reference enqueues produce()d records with zero per-record
allocations (rd_kafka_toppar_enq_msg, rdkafka_msg.c:241); the Python
client's per-record ``Message`` object was the GIL ceiling on the app
thread (~7 µs/record).  The fast lane appends key/value straight into a
per-toppar native arena (ops/native/enqlane.cpp) and the broker thread
take()s contiguous runs that the native framer consumes directly —
``ArenaBatch`` is that run flowing through the same produce pipeline as
a ``list[Message]`` batch (codec phase → send → response → retry/DR).

Eligibility (checked in Kafka.produce / the native Lane): no
interceptors (on_send must fire per message at produce() time),
bytes/None key+value, no on_delivery/opaque.  Widened:
explicit partition OR murmur2 auto-partition (native hash, bit-exact
vs utils/hash.murmur2), explicit timestamps (per-record int64 side
array, 0 = batch build time), and record headers (pre-encoded wire
blobs in a side arena — the framer memcpys them).  DR consumers
(dr_msg_cb/dr_cb/"dr" events/background) do NOT demote: delivery
reports materialize Message objects from the arena run at DR time
(dr_msgq → to_messages → materialize_arena), off the produce() path.
Anything else falls back to the Message path; a toppar that sees a
fallback message is permanently demoted (arena drained into Messages
first — FIFO order is preserved exactly).
"""
from __future__ import annotations

import time
from typing import Optional

from ..analysis.locks import new_lock
# the tk_torch_enqlane extension, or None (ops/native/build.py)
from ..ops.native.build import enqlane as _mod


def arena_new():
    """A new native Arena, or None when the extension can't build."""
    m = _mod()
    return m.Arena() if m else None


class _PyLane:  # lint: ok shared-state
    """Pure-Python Lane stand-in when the C extension is unavailable:
    same interface, always routes produce() to the fallback.

    shared-state pragma: mirrors the C lane's contract — counter RMWs
    ride arena.pylane, the enable flags are single-writer rdk:main
    ints read atomically under the GIL (same contract the native lane
    documents for its struct fields)."""

    def __init__(self):
        self.map: dict = {}
        self.enabled = 0
        self.fatal = 0
        self.msg_cnt = 0
        self.msg_bytes = 0
        self.max_msgs = 100000
        self.max_bytes = 1 << 30
        self._fallback = None
        self._lock = new_lock("arena.pylane")

    def configure(self, fallback, wake, max_msgs, max_bytes,
                  copy_max=None):
        # copy_max (message.copy.max.bytes) is irrelevant here: this
        # stand-in never copies into an arena — everything already takes
        # the reference-holding Message path
        self._fallback = fallback
        self.max_msgs = max_msgs
        self.max_bytes = max_bytes

    def acct(self, dn: int, dbytes: int):
        with self._lock:
            self.msg_cnt += dn
            self.msg_bytes += dbytes
            return (self.msg_cnt, self.msg_bytes)

    def full(self, sz: int = 0) -> bool:
        return (self.msg_cnt >= self.max_msgs
                or self.msg_bytes + sz > self.max_bytes)

    def map_set(self, topic, partition, entry):
        self.map[(topic, partition)] = entry

    def map_del(self, topic, partition):
        return self.map.pop((topic, partition), None)

    def part_set(self, topic, partition_cnt, mode):
        """No-op: the stand-in never auto-partitions natively."""

    def part_del(self, topic):
        """No-op counterpart of part_set."""

    def counters(self):
        """Same shape as the native Lane.counters() — all zero (every
        produce() routed to the fallback)."""
        return {"engaged": 0,
                "fallback": {"disabled": 0, "shape": 0, "oversize": 0,
                             "queue_full": 0, "no_entry": 0,
                             "auto_partition": 0}}

    def produce(self, *args, **kwargs):
        return self._fallback(*args, **kwargs)


def lane_new():
    """A native Lane (C produce entry point + shared counters), or the
    Python stand-in."""
    m = _mod()
    return m.Lane() if m else _PyLane()


def encode_headers(hdrs) -> Optional[bytes]:
    """Pre-encode a headers sequence into the arena side-blob framing —
    varint(nh) + per-header varint(len(key))+key + varint(len(val)|-1)
    [+val] — exactly the record-tail bytes the native framer memcpys.
    Returns None when the shape is fast-lane ineligible (non-str/bytes
    keys, non-bytes values, not a sequence of 2-tuples)."""
    from ..utils import varint
    enc = varint.enc_i64
    try:
        out = bytearray(enc(len(hdrs)))
        for hk, hv in hdrs:
            hkb = hk.encode() if isinstance(hk, str) else hk
            if not isinstance(hkb, bytes):
                return None
            out += enc(len(hkb))
            out += hkb
            if hv is None:
                out.append(1)                   # varint(-1)
            elif isinstance(hv, bytes):
                out += enc(len(hv))
                out += hv
            else:
                return None
        return bytes(out)
    except (TypeError, ValueError):
        return None


def decode_hblob(blob) -> list:
    """Inverse of encode_headers: [(str key, bytes|None value)] —
    demotion drains and DR materialization rebuild Message.headers
    from the side-arena blob."""
    from ..utils.buf import Slice
    sl = Slice(bytes(blob))
    out = []
    for _ in range(sl.read_varint()):
        hk = sl.read(sl.read_varint()).decode("utf-8", "replace")
        vl = sl.read_varint()
        out.append((hk, None if vl < 0 else sl.read(vl)))
    return out


class ArenaBatch:
    """One taken arena run: the fast-lane analog of list[Message].

    ``base`` is the concatenated key||value payload bytes; ``klens`` /
    ``vlens`` are raw little-endian int32 arrays (-1 = null) that
    tk_frame_v2 reads in place.  Widened runs additionally carry
    ``tss`` (raw int64 per-record create timestamps, 0 = batch build
    time), and ``hbuf``/``hlens`` (concatenated pre-encoded header
    blobs + raw int32 per-record blob lengths); all three are None for
    the all-default hot shape.  msgid_base is assigned at take() time
    under the toppar lock — idempotent sequence numbering is identical
    to the Message path's per-enqueue assignment because takes are
    FIFO and exclusive."""

    __slots__ = ("base", "klens", "vlens", "count", "nbytes",
                 "msgid_base", "enq_first", "enq_last", "retries",
                 "possibly_persisted", "tss", "hbuf", "hlens")

    def __init__(self, base: bytes, klens: bytes, vlens: bytes,
                 count: int, nbytes: int, enq_first_us: int,
                 enq_last_us: int, tss: Optional[bytes] = None,
                 hbuf: Optional[bytes] = None,
                 hlens: Optional[bytes] = None):
        self.base = base
        self.klens = klens
        self.vlens = vlens
        self.count = count
        self.nbytes = nbytes
        self.enq_first = enq_first_us / 1e6     # time.monotonic() seconds
        self.enq_last = enq_last_us / 1e6
        self.tss = tss
        self.hbuf = hbuf
        self.hlens = hlens
        self.msgid_base = 0
        self.retries = 0
        self.possibly_persisted = False

    def __len__(self) -> int:
        return self.count

    def to_messages_lazy(self, topic: str, partition: int,
                         base_offset: int, status, error) -> list:
        """DR-path materialization: FetchMessage objects holding the
        arena base buffer + packed offsets — key/value bytes exist only
        if the DR callback reads them (most read error/offset/topic).
        Falls back to the eager path when the extension is absent."""
        from ..protocol import proto
        from .msg import FetchMessage

        m_ = _mod()
        mat = getattr(m_, "materialize_arena_lazy", None) if m_ else None
        # widened runs (explicit ts / headers) take the eager path so
        # every Message carries its real timestamp + decoded headers
        if mat is not None and self.tss is None and self.hbuf is None:
            out = mat(FetchMessage, self.base, self.klens, self.vlens,
                      self.count, topic, partition, base_offset,
                      int(time.time() * 1000), proto.TSTYPE_CREATE_TIME,
                      status, error)
            if out is not None:
                return out
        return self.to_messages(topic, partition, base_offset,
                                status=status, error=error)

    def to_messages(self, topic: str = "", partition: int = -1,
                    base_offset: int = -1, status=None, error=None) -> list:
        """Materialize per-record Message objects (legacy MsgVer0/1
        brokers, delivery reports).  Bulk native creation when the
        extension is loaded (materialize_arena: tp_alloc + direct slot
        stores — the DR path for fast-lane batches); ``status``/
        ``error``/``base_offset`` stamp every record."""
        from .msg import Message, MsgStatus

        m_ = _mod()
        mat = getattr(m_, "materialize_arena", None) if m_ else None
        if (mat is not None and self.tss is None and self.hbuf is None):
            out = mat(Message, self.base, self.klens, self.vlens,
                      self.count, topic, partition, base_offset,
                      self.msgid_base, self.enq_first, self.retries,
                      status if status is not None
                      else MsgStatus.NOT_PERSISTED,
                      error)
            if out is not None:
                return out
        import numpy as np

        kl = np.frombuffer(self.klens, np.int32)
        vl = np.frombuffer(self.vlens, np.int32)
        tsv = (np.frombuffer(self.tss, np.int64)
               if self.tss is not None else None)
        hl = (np.frombuffer(self.hlens, np.int32)
              if self.hbuf is not None else None)
        out = []
        off = 0
        hoff = 0
        for i in range(self.count):
            k = v = None
            if kl[i] >= 0:
                k = self.base[off:off + kl[i]]
                off += int(kl[i])
            if vl[i] >= 0:
                v = self.base[off:off + vl[i]]
                off += int(vl[i])
            hdrs = ()
            if hl is not None and hl[i] > 0:
                hdrs = decode_hblob(
                    self.hbuf[hoff:hoff + int(hl[i])])
                hoff += int(hl[i])
            ts = int(tsv[i]) if tsv is not None else 0
            m = Message(topic, value=v, key=k, partition=partition,
                        headers=hdrs, timestamp=ts)
            m.msgid = self.msgid_base + i
            m.enq_time = self.enq_first
            m.retries = self.retries
            if base_offset >= 0:
                m.offset = base_offset + i
            if status is not None:
                m.status = status
            if error is not None:
                m.error = error
            out.append(m)
        return out

    def __repr__(self):
        return (f"ArenaBatch(n={self.count}, bytes={self.nbytes}, "
                f"msgid_base={self.msgid_base})")


def batch_head_msgid(batch) -> int:
    """First msgid of a produce batch (list[Message] | ArenaBatch)."""
    if isinstance(batch, ArenaBatch):
        return batch.msgid_base
    return batch[0].msgid


def batch_msgids(batch) -> list:
    """All msgids of a batch — the DRAIN rebase's pending scan."""
    if isinstance(batch, ArenaBatch):
        return [batch.msgid_base + i for i in range(batch.count)]
    return [m.msgid for m in batch]
