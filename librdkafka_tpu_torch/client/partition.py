"""Topic+partition ("toppar") state (reference: src/rdkafka_partition.c).

Producer side: two queues per toppar — ``msgq`` (app enqueues under lock,
reference rktp_msgq) and ``xmit_msgq`` (broker thread drains, rktp_xmit_msgq,
rdkafka_partition.h:105-107) — moved wholesale under the toppar lock at the
top of the producer serve loop (rdkafka_broker.c:3322-3327).

Consumer side: a fetch state machine (NONE→OFFSET_QUERY→OFFSET_WAIT→ACTIVE,
rdkafka_partition.h:227-233) and a per-toppar fetch queue that is forwarded
into the single consumer queue (rd_kafka_q_fwd_set).
"""
from __future__ import annotations

import enum
import threading
import time
from collections import deque
from typing import Optional

from ..protocol import proto
from ..analysis.locks import new_lock
from ..analysis.races import register_slots
from .msg import Message
from .queue import OpQueue


class FetchState(enum.Enum):
    NONE = "none"
    STOPPING = "stopping"
    STOPPED = "stopped"
    OFFSET_QUERY = "offset-query"
    OFFSET_WAIT = "offset-wait"
    ACTIVE = "active"


class Toppar:
    # slotted: the native delivery cursor (enqlane.cpp cursor_next)
    # reads/writes version/app_offset/stored_offset by member offset,
    # and the per-toppar footprint matters at 64+ partitions
    __slots__ = (
        "topic", "partition", "lock",
        # producer
        "msgq", "xmit_msgq", "msgq_bytes", "arena", "arena_ok",
        "next_msgid", "epoch_base_msgid", "inflight", "inflight_msgids",
        "retry_batches", "retry_backoff_until", "leader_id",
        "ts_last_xmit",
        # consumer
        "fetch_state", "fetchq", "fetch_offset", "app_offset",
        "stored_offset", "committed_offset", "hi_offset", "ls_offset",
        "paused", "fetch_backoff_until", "fetch_in_flight",
        "fetch_broker_id", "fetchq_cnt", "fetchq_bytes",
        "eof_reported_at", "aborted_txns", "version", "stats_active")

    def __init__(self, topic: str, partition: int):
        self.topic = topic
        self.partition = partition
        self.lock = new_lock("kafka.toppar")

        # ---- producer ----
        self.msgq: deque[Message] = deque()        # app → (lock) → broker
        self.xmit_msgq: deque[Message] = deque()   # broker-thread owned
        self.msgq_bytes = 0
        # native enqueue fast lane (client/arena.py): created on first
        # eligible produce; permanently demoted (arena_ok=False) the
        # moment a Message-path record targets this toppar so FIFO order
        # can never interleave between the two lanes
        self.arena = None
        self.arena_ok = True
        self.next_msgid = 1
        self.epoch_base_msgid = 0                  # idempotence seq base
        self.inflight = 0                          # in-flight ProduceRequests
        self.inflight_msgids: set[int] = set()     # first msgid per in-flight batch
        self.retry_batches: deque[list[Message]] = deque()  # frozen retries
        self.retry_backoff_until = 0.0   # retry.backoff.ms gate on re-pops
        self.leader_id: int = -1
        self.ts_last_xmit = 0.0

        # ---- consumer ----
        self.fetch_state = FetchState.NONE
        self.fetchq = OpQueue(f"{topic}[{partition}]-fetchq")
        self.fetch_offset: int = proto.OFFSET_INVALID
        self.app_offset: int = proto.OFFSET_INVALID     # next offset app sees
        self.stored_offset: int = proto.OFFSET_INVALID  # to be committed
        self.committed_offset: int = proto.OFFSET_INVALID
        self.hi_offset: int = proto.OFFSET_INVALID      # high watermark
        self.ls_offset: int = proto.OFFSET_INVALID      # last stable
        self.paused = False
        self.fetch_backoff_until = 0.0
        self.fetch_in_flight = False   # included in an outstanding Fetch
        # KIP-392 fetch-from-follower: broker id currently serving this
        # partition's Fetches (None = the leader). Producing always
        # targets the leader regardless.
        self.fetch_broker_id = None
        self.fetchq_cnt = 0        # msgs sitting in fetchq (queued.min)
        self.fetchq_bytes = 0      # queued.max.messages.kbytes accounting
        self.eof_reported_at = proto.OFFSET_INVALID
        self.aborted_txns: dict[int, list[int]] = {}  # pid -> abort offsets
        self.version = 1                 # barrier for stale fetch ops
        # in Kafka._active_toppars (stats/serve iterate only ACTIVE
        # toppars — a metadata-registered one costs nothing per emit);
        # flag checked lock-free on hot paths, index under kafka.toppars
        self.stats_active = False

    # ------------------------------------------------------- producer ----
    def enq_msg(self, msg: Message) -> bool:
        """Enqueue; returns True when the queue was empty (the caller
        wakes the leader broker only on that transition — per-message
        wakeups dominated the produce() profile)."""
        with self.lock:
            msg.msgid = self.next_msgid
            self.next_msgid += 1
            self.msgq.append(msg)
            self.msgq_bytes += msg.size
            return len(self.msgq) == 1

    def xmit_move(self) -> int:
        """Move msgq → xmit_msgq under lock; returns moved count."""
        with self.lock:
            n = len(self.msgq)
            if n:
                self.xmit_msgq.extend(self.msgq)
                self.msgq.clear()
                self.msgq_bytes = 0
            return n

    def insert_retry(self, msgs: list[Message]) -> None:
        """Requeue retried messages preserving msgid (FIFO) order
        (reference: rd_kafka_msgq_insert_msgq order-preserving merge)."""
        with self.lock:
            merged = sorted(list(msgs) + list(self.xmit_msgq),
                            key=lambda m: m.msgid)
            self.xmit_msgq = deque(merged)

    def release_inflight(self, msgs) -> None:
        """Release one batch's in-flight accounting. MUST run only after
        the requeue-or-DR decision (the DRAIN rebase on the main thread
        keys off inflight==0 — releasing early lets it rebase past
        messages still owned by a broker/codec thread)."""
        from .arena import batch_head_msgid
        with self.lock:
            self.inflight -= 1
            self.inflight_msgids.discard(batch_head_msgid(msgs))

    def enqueue_retry_batch(self, msgs) -> None:
        """Requeue a failed produce batch FROZEN — original membership and
        order — so a resend carries the same (BaseSequence, record_count)
        and broker-side idempotent dup detection stays sound.  The
        reference likewise never re-slices a retried batch (the msgset is
        rebuilt from the same message run, rdkafka_msgset_writer.c).
        Accepts list[Message] or a fast-lane ArenaBatch."""
        from .arena import ArenaBatch, batch_head_msgid
        with self.lock:
            self.retry_batches.append(
                msgs if isinstance(msgs, ArenaBatch) else list(msgs))
            if len(self.retry_batches) > 1:
                self.retry_batches = deque(
                    sorted(self.retry_batches, key=batch_head_msgid))

    def demote_arena(self) -> None:
        """Permanently route this toppar through the Message path; any
        arena content is converted to Messages FIRST so produce order is
        preserved exactly.  Caller must hold neither lock."""
        from .msg import Message
        with self.lock:
            self.arena_ok = False
            if self.arena is None or len(self.arena) == 0:
                return
            from .arena import decode_hblob
            recs = self.arena.drain_records()
            for k, v, mts, hb in recs:
                m = Message(self.topic, value=v, key=k,
                            partition=self.partition, timestamp=mts,
                            headers=decode_hblob(hb) if hb else ())
                m.msgid = self.next_msgid
                self.next_msgid += 1
                self.msgq.append(m)
                self.msgq_bytes += m.size

    def total_queued(self) -> int:
        with self.lock:
            return len(self.msgq) + len(self.xmit_msgq)

    def __repr__(self):
        return f"Toppar({self.topic}[{self.partition}])"


# lockset declarations (analysis/races.py; slot form — Toppar is
# __slots__).  Strict set: the producer queues and the fetch-budget
# counters are RMW'd from app + broker + codec threads and every
# access holds kafka.toppar (the fetchq counters' bare cross-thread
# ``+=`` was the headline lockset-sweep finding).
register_slots(Toppar, "msgq", "xmit_msgq", "msgq_bytes",
               "fetchq_cnt", "fetchq_bytes",
               prefix="toppar")
# Relaxed: in-flight accounting, msgid assignment and the retry queue
# are written under kafka.toppar, but the broker serve loop takes
# lock-free ADVISORY peeks (max-inflight gate, retry/dedup scans) that
# are re-validated under the lock before acting — the double-checked
# pattern Eraser classically false-positives on.  Tracked, reported
# informationally.
register_slots(Toppar, "inflight", "inflight_msgids", "next_msgid",
               "retry_batches", "fetch_in_flight", "stats_active",
               prefix="toppar", relaxed=True)
