"""Public Consumer API: balanced KafkaConsumer + simple consumer.

Reference: the KafkaConsumer API surface of rdkafka.h (subscribe / poll /
commit / assign / seek / pause / position / committed) built over the cgrp
FSM, with all per-partition fetch queues forwarded into one consumer queue
(rd_kafka_q_fwd_set, rdkafka_queue.c:127) so a single poll serves
everything.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from collections import deque

from ..obs import trace as _trace
from ..protocol import proto
from ..protocol.proto import ApiKey
from .broker import Request
from .conf import Conf
from .cgrp import ConsumerGroup
from .errors import Err, KafkaError, KafkaException
from .kafka import CONSUMER, Kafka
from .msg import Message
from .partition import FetchState, Toppar
from .queue import Op, OpQueue, OpType, SyncReply


class _PyCursor:
    """Pure-Python delivery cursor: the fallback for
    tk_torch_enqlane.cursor_new (identical contract, see _next_pending)."""
    __slots__ = ("tp", "msgs", "ver", "key", "i", "n")

    def __init__(self, tp, msgs, ver, key):
        self.tp = tp
        self.msgs = msgs
        self.ver = ver
        self.key = key
        self.i = 0
        self.n = len(msgs)

    def next(self, assignment, auto_store):
        tp = self.tp
        while self.i < self.n:
            m = self.msgs[self.i]
            self.i += 1
            if tp.version != self.ver or self.key not in assignment:
                continue            # stale/revoked: drop
            off1 = m.offset + 1
            tp.app_offset = off1
            if auto_store:
                tp.stored_offset = off1
            return m
        return None


def _cursor_factory():
    try:
        from .arena import _mod
        m = _mod()
        f = getattr(m, "cursor_new", None) if m else None
        return f if f is not None else _PyCursor
    except Exception:
        return _PyCursor


_new_cursor = _cursor_factory()


@dataclass
class TopicPartition:
    """Public topic+partition+offset tuple (rd_kafka_topic_partition_t)."""
    topic: str
    partition: int
    offset: int = proto.OFFSET_INVALID
    error: Optional[KafkaError] = None
    #: app-supplied commit metadata (rd_kafka_topic_partition_t.metadata,
    #: reference test 0099-commit_metadata); round-trips via
    #: commit(offsets=...) / committed()
    metadata: Optional[str] = None

    def __hash__(self):
        return hash((self.topic, self.partition))


@dataclass
class ConsumerGroupMetadata:
    """Opaque consumer-group identity handed to
    Producer.send_offsets_to_transaction
    (rd_kafka_consumer_group_metadata_t)."""
    group_id: str
    generation: int = -1
    member_id: str = ""


class Consumer:
    def __init__(self, conf):
        if isinstance(conf, dict):
            c = Conf()
            c.update(conf)
            conf = c
        self._rk = Kafka(conf, CONSUMER)
        self._rk.consumer = self
        self.queue = OpQueue("consumer")
        # single-queue consumer polling: the main reply queue (errors,
        # stats, logs) forwards into the consumer queue (reference:
        # rd_kafka_poll_set_consumer, rk_rep → rk_consumer fwd)
        self._rk.rep.forward_to(self.queue)
        group_id = conf.get("group.id")
        self._rk.cgrp = ConsumerGroup(self._rk, group_id) if group_id else None
        self._assignment: dict[tuple[str, int], Toppar] = {}
        # messages from a batched FETCH op awaiting delivery via poll()
        self._pending: deque = deque()   # (tp, msgs, version, mbytes)
        self._cur = None                 # delivery cursor over the
                                         # current batch (native
                                         # tk_torch_enqlane.Cursor / _PyCursor)
        self._auto_store = conf.get("enable.auto.offset.store")
        self._next_tick = 0.0            # cgrp tick time-gate (poll)
        self._closed = False

    # ---------------------------------------------------------- subscribe --
    def subscribe(self, topics: list[str], on_assign=None, on_revoke=None):
        if self._rk.cgrp is None:
            raise KafkaException(Err._UNKNOWN_GROUP,
                                 "subscribe requires group.id")
        if on_assign or on_revoke:
            self._rk.conf.set("rebalance_cb",
                              self._make_rebalance_cb(on_assign, on_revoke))
        self._rk.cgrp.subscribe(topics)

    def _make_rebalance_cb(self, on_assign, on_revoke):
        def cb(consumer, code, partitions):
            coop = consumer.rebalance_protocol() == "COOPERATIVE"
            if code == Err._ASSIGN_PARTITIONS:
                if on_assign:
                    on_assign(consumer, partitions)
                elif coop:
                    consumer.incremental_assign(partitions)
                else:
                    consumer.assign(partitions)
            else:
                if on_revoke:
                    on_revoke(consumer, partitions)
                elif coop:
                    consumer.incremental_unassign(partitions)
                else:
                    consumer.unassign()
        return cb

    def unsubscribe(self):
        if self._rk.cgrp:
            self._rk.cgrp.unsubscribe()

    def subscription(self) -> list[str]:
        return list(self._rk.cgrp.subscription) if self._rk.cgrp else []

    # ------------------------------------------------------------- assign --
    def assign(self, partitions: list[TopicPartition]):
        assignment = {}
        for tp in partitions:
            assignment.setdefault(tp.topic, []).append(tp.partition)
        self.apply_assignment(assignment,
                              offsets={(tp.topic, tp.partition): tp.offset
                                       for tp in partitions})
        if self._rk.cgrp:
            self._rk.cgrp.rebalance_done(assigned=True)

    def unassign(self):
        self.apply_assignment({})
        if self._rk.cgrp:
            self._rk.cgrp.rebalance_done(assigned=False)

    def incremental_assign(self, partitions: list[TopicPartition]):
        """KIP-429: ADD ``partitions`` to the current assignment —
        every already-assigned partition is untouched and keeps
        fetching (reference: rd_kafka_incremental_assign).  The
        cooperative rebalance callback's assign-side answer."""
        add: dict[str, list[int]] = {}
        for tp in partitions:
            add.setdefault(tp.topic, []).append(tp.partition)
        self.apply_incremental_assign(
            add, offsets={(tp.topic, tp.partition): tp.offset
                          for tp in partitions})
        if self._rk.cgrp:
            self._rk.cgrp._coop_ack(True)

    def incremental_unassign(self, partitions: list[TopicPartition]):
        """KIP-429: REMOVE only ``partitions`` from the assignment
        (reference: rd_kafka_incremental_unassign) — the cooperative
        revoke-side answer; unrevoked fetchers never stop."""
        rem: dict[str, list[int]] = {}
        for tp in partitions:
            rem.setdefault(tp.topic, []).append(tp.partition)
        self.apply_incremental_unassign(rem)
        if self._rk.cgrp:
            self._rk.cgrp._coop_ack(False)

    def rebalance_protocol(self) -> str:
        """``NONE`` / ``EAGER`` / ``COOPERATIVE`` — the protocol of the
        broker-elected assignor (rd_kafka_rebalance_protocol)."""
        cg = self._rk.cgrp
        return cg.rebalance_protocol if cg is not None else "NONE"

    def assignment(self) -> list[TopicPartition]:
        return [TopicPartition(t, p, tp.app_offset)
                for (t, p), tp in self._assignment.items()]

    def _sync_cgrp_assignment(self):
        """Mirror the live membership into cgrp.assignment (the
        owned_partitions source + stats gauge) under the cgrp lock."""
        cgrp = self._rk.cgrp
        if cgrp is None:
            return
        current: dict[str, list[int]] = {}
        for t, p in sorted(self._assignment):
            current.setdefault(t, []).append(p)
        with cgrp._lock:
            cgrp.assignment = current

    def _stop_partitions(self, keys):
        for key in keys:
            tp = self._assignment.pop(key, None)
            if tp is None:
                continue
            tp.fetch_state = FetchState.STOPPED
            tp.version += 1
            tp.fetchq.forward_to(None)
            with tp.lock:
                tp.fetchq_cnt = 0
                tp.fetchq_bytes = 0
            # out of the O(active) index: stats emit and the broker
            # serve scans stop visiting it; the next fetch-session
            # request forgets it broker-side (absent from the wanted
            # set → forgotten_topics)
            self._rk.toppar_set_active(tp, False)

    def _start_partitions(self, need, explicit: dict, gen: Optional[int]):
        """Register ``need`` synchronously, resolve committed offsets
        asynchronously, then start the fetchers.  ``gen`` is the
        full-assignment generation guard (None on incremental paths:
        a later incremental change must not cancel unrelated pending
        starts — per-key liveness is checked instead)."""
        rk = self._rk

        # membership is registered SYNCHRONOUSLY (rd_kafka_assign sets
        # the assignment list before any async offset resolution —
        # assignment() and the _deliver revocation check must see it
        # immediately); only the committed-offset lookup is async
        for key in need:
            tp = self._assignment.get(key) or rk.get_toppar(*key)
            self._assignment[key] = tp
            tp.fetchq.forward_to(self.queue)
            rk.toppar_set_active(tp, True)
        # interest-set registration: an assign()-based consumer has no
        # subscription, so its topics reach the sparse/interest-only
        # metadata refresh through the topic-handle table (subscribe
        # literals and regex matches already pass through get_topic);
        # creating the handle also fires the "new topic" refresh that
        # resolves leaders for never-seen topics
        for t in {k[0] for k in need}:
            rk.get_topic(t)

        def start(committed: dict):
            if gen is not None and self._assign_gen != gen:
                return              # superseded by a newer assignment
            for key in need:
                t, p = key
                tp = self._assignment.get(key)
                if tp is None:
                    continue        # unassigned while offsets resolved
                off = explicit.get(key, proto.OFFSET_INVALID)
                if off < 0:
                    off = committed.get(key, proto.OFFSET_INVALID)
                if off >= 0:
                    tp.fetch_offset = off
                    tp.fetch_state = FetchState.ACTIVE
                else:
                    policy = rk.topic_conf_for(t).get("auto.offset.reset")
                    tp.fetch_offset = (
                        proto.OFFSET_BEGINNING
                        if policy in ("smallest", "earliest", "beginning")
                        else proto.OFFSET_END)
                    tp.fetch_state = FetchState.OFFSET_QUERY
                tp.version += 1
                rk._wake_leader(tp)

        if rk.cgrp and need:
            def on_fetched(err, resp):
                committed = {}
                if err is None:
                    for tr in resp["topics"]:
                        for pr in tr["partitions"]:
                            if pr["error_code"] == 0 and pr["offset"] >= 0:
                                committed[(tr["topic"], pr["partition"])] = \
                                    pr["offset"]
                start(committed)

            if not rk.cgrp.fetch_committed(list(need), on_fetched):
                start({})
        else:
            start({})

    def apply_assignment(self, assignment: dict[str, list[int]],
                         offsets: Optional[dict] = None):
        """Start/stop fetchers to match the assignment (reference:
        rd_kafka_cgrp_assign → toppar OP_FETCH_START)."""
        # generation stamp: an async committed-offset lookup from an
        # OLDER apply_assignment call must not touch fetch state after
        # an unassign/reassign bounce superseded it (it could resurrect
        # an outdated committed offset and re-deliver messages)
        self._assign_gen = getattr(self, "_assign_gen", 0) + 1
        gen = self._assign_gen
        new_keys = {(t, p) for t, ps in assignment.items() for p in ps}
        # stop removed partitions
        self._stop_partitions([k for k in list(self._assignment)
                               if k not in new_keys])
        cgrp = self._rk.cgrp
        if cgrp:
            with cgrp._lock:
                cgrp.assignment = assignment
        if not new_keys:
            return
        # gather committed offsets for every partition whose fetcher
        # hasn't STARTED — not merely "not registered": a registered
        # partition whose async offset lookup was superseded (gen
        # guard) still needs a restart or it would sit in
        # FetchState.NONE forever
        need = [k for k in new_keys
                if k not in self._assignment
                or self._assignment[k].fetch_state
                in (FetchState.NONE, FetchState.STOPPED)]
        self._start_partitions(need, offsets or {}, gen)

    def apply_incremental_assign(self, assignment: dict[str, list[int]],
                                 offsets: Optional[dict] = None):
        """Start fetchers for ``assignment`` without touching any other
        partition — the mechanics of ``incremental_assign`` (no join-
        FSM side effects; cgrp calls this on the auto-apply path)."""
        new_keys = {(t, p) for t, ps in assignment.items() for p in ps}
        need = [k for k in sorted(new_keys)
                if k not in self._assignment
                or self._assignment[k].fetch_state
                in (FetchState.NONE, FetchState.STOPPED)]
        self._start_partitions(need, offsets or {}, None)
        self._sync_cgrp_assignment()

    def apply_incremental_unassign(self, assignment: dict[str, list[int]]):
        """Stop ONLY the named fetchers; everything else keeps flowing
        (the zero stop-the-world property the chaos continuity
        invariant asserts)."""
        self._stop_partitions([(t, p) for t, ps in assignment.items()
                               for p in ps])
        self._sync_cgrp_assignment()

    # --------------------------------------------------------------- poll --
    def _next_pending(self) -> Optional[Message]:
        """Next deliverable message from the fetched-batch queue.
        Batches stay whole (one deque entry per partition response, the
        op-per-batch axis); a delivery cursor (native tk_torch_enqlane.Cursor
        when available) walks the current batch — the staleness barrier,
        the revocation check and the offset advance run per message in
        ONE C call. A message is stale — dropped — when the partition
        was seeked/paused since the fetch (version barrier) OR revoked
        from the current assignment; assign()/unassign() maintain
        _assignment in group and simple modes alike (reference:
        rd_kafka_op_version_outdated plus the fetchq disconnect on
        rd_kafka_toppar_fetch_stop). Fetchq accounting is released per
        BATCH when its delivery begins (it feeds the queued.min.messages
        fetch gate, where batch granularity is equivalent)."""
        cur = self._cur
        pending = self._pending
        while True:
            if cur is None:
                if not pending:
                    return None
                tp, msgs, ver, mbytes = pending.popleft()
                # under the toppar lock: the broker thread's enqueue
                # accounting (kafka._enq_fetched) is a concurrent RMW
                # on the same counters (--races sweep finding: a GIL
                # switch between load and store lost an update and the
                # clamp silently re-zeroed the fetch budget)
                with tp.lock:
                    fc = tp.fetchq_cnt - len(msgs)
                    tp.fetchq_cnt = fc if fc > 0 else 0
                    fb = tp.fetchq_bytes - mbytes
                    tp.fetchq_bytes = fb if fb > 0 else 0
                cur = _new_cursor(tp, msgs, ver, (tp.topic, tp.partition))
                self._cur = cur
            m = cur.next(self._assignment, self._auto_store)
            if m is not None:
                return m
            cur = None
            self._cur = None

    def poll(self, timeout: float = 1.0) -> Optional[Message]:
        if not _trace.enabled:
            return self._poll(timeout)
        c0 = time.thread_time_ns()
        try:
            return self._poll(timeout)
        finally:
            self._rk.fetch_cpu_ns += time.thread_time_ns() - c0

    def _poll(self, timeout: float) -> Optional[Message]:
        # fast path: drain already-fetched batches without touching the
        # op queue (the per-message consume budget); the cgrp tick
        # (max.poll bookkeeping, rebalance callbacks) is TIME-gated to
        # ~4/s — a count gate would let a slow-consuming app's
        # last-poll timestamp go stale past max.poll.interval.ms even
        # though it polls continuously. The slow path always ticks.
        msg = self._next_pending()
        if msg is not None:
            now = time.monotonic()
            if now >= self._next_tick:
                self._next_tick = now + 0.25
                cgrp = self._rk.cgrp
                if cgrp is not None:
                    cgrp.poll_tick()
            return msg
        cgrp = self._rk.cgrp
        if cgrp is not None:
            cgrp.poll_tick()
        deadline = time.monotonic() + timeout
        while True:
            remain = deadline - time.monotonic()
            op = self.queue.pop(max(0.0, min(remain, 0.1)))
            if op is None:
                if time.monotonic() >= deadline:
                    return None
                continue
            msg = self._serve_op(op)
            if msg is not None:
                return msg
            msg = self._next_pending()
            if msg is not None:
                return msg
            if time.monotonic() >= deadline:
                return None

    def consume_callback(self, timeout: float = 1.0, consume_cb=None,
                         max_messages: Optional[int] = None) -> int:
        """Callback-based consume mode (reference:
        rd_kafka_consume_callback, rdkafka.h): dispatch messages to
        ``consume_cb`` (argument, or the ``consume_cb`` conf property)
        instead of returning them. Waits up to ``timeout`` for the
        first message, then drains without waiting, capped by
        ``max_messages`` (argument, or ``consume.callback.max.messages``
        conf; 0 = unlimited). Returns the number dispatched."""
        cb = consume_cb or self._rk.conf.get("consume_cb")
        if cb is None:
            raise KafkaException(
                Err._INVALID_ARG,
                "consume_callback requires a consume_cb (argument or "
                "conf property)")
        cap = max_messages
        if cap is None:
            cap = self._rk.conf.get("consume.callback.max.messages")
            # topic-scope row (the reference's per-topic cap,
            # rdkafka_conf.c:1365 — its consume_callback is a per-topic
            # call): an explicitly-set subscribed topic's cap bounds
            # this instance-level call conservatively
            for t in (self._rk.cgrp.subscription if self._rk.cgrp else ()):
                tc = self._rk.topic_conf_for(t)
                if tc.is_set("consume.callback.max.messages"):
                    tcap = tc.get("consume.callback.max.messages")
                    if tcap and (not cap or tcap < cap):
                        cap = tcap
        if not cap:
            cap = float("inf")
        n = 0
        t = timeout
        while n < cap:
            m = self.poll(t)
            if m is None:
                break
            t = 0.0          # drain without waiting after the first
            cb(m)
            n += 1
        return n

    def consume(self, num_messages: int = 1, timeout: float = 1.0
                ) -> list[Message]:
        """Batch consume (reference: rd_kafka_consume_batch_queue).
        Drains already-fetched batches without per-message clock reads
        or op-queue round trips; blocks via poll() only while short."""
        if not _trace.enabled:
            return self._consume(num_messages, timeout)
        c0 = time.thread_time_ns()
        try:
            return self._consume(num_messages, timeout)
        finally:
            self._rk.fetch_cpu_ns += time.thread_time_ns() - c0

    def _consume(self, num_messages: int, timeout: float) -> list[Message]:
        cgrp = self._rk.cgrp
        if cgrp is not None:
            cgrp.poll_tick()
        out = []
        nxt = self._next_pending
        while len(out) < num_messages:
            m = nxt()
            if m is None:
                break
            out.append(m)
        deadline = None
        while len(out) < num_messages:
            if deadline is None:
                deadline = time.monotonic() + timeout
            remain = deadline - time.monotonic()
            if remain <= 0:
                break
            m = self._poll(remain)
            if m is None:
                break
            out.append(m)
            while len(out) < num_messages:
                m = nxt()
                if m is None:
                    break
                out.append(m)
        return out

    def _serve_op(self, op: Op) -> Optional[Message]:
        rk = self._rk
        if op.type == OpType.FETCH:
            tp, msgs, version, mbytes = op.payload
            if msgs:
                self._pending.append((tp, msgs, version, mbytes))
            return None
        if op.type == OpType.CONSUMER_ERR:
            tp, msg, version = op.payload
            return msg if tp.version == version else None
        if op.type == OpType.REBALANCE:
            code, assignment, incremental = op.payload
            cb = rk.conf.get("rebalance_cb")
            parts = [TopicPartition(t, p) for t, ps in assignment.items()
                     for p in ps]
            if cb:
                cb(self, code, parts)
                if rk.cgrp is not None and rk.cgrp._wait_rebalance_cb:
                    # the app's callback returned without answering
                    # (no assign/unassign family call): apply the
                    # default action so the join FSM can't wedge in
                    # wait-assign-rebalance-cb (reference:
                    # rd_kafka_poll_cb's rebalance op fallback)
                    if code == Err._ASSIGN_PARTITIONS:
                        (self.incremental_assign if incremental
                         else self.assign)(parts)
                    elif incremental:
                        self.incremental_unassign(parts)
                    else:
                        self.unassign()
            return None
        # forwarded main-queue ops (errors/stats/logs): dispatch to the
        # same handlers rd_kafka_poll would use
        rk._serve_rep_op(op)
        return None

    # ------------------------------------------------------------ offsets --
    def stored_offsets(self) -> dict[tuple[str, int], int]:
        """Offsets pending commit (stored > committed)."""
        out = {}
        for key, tp in self._assignment.items():
            if tp.stored_offset >= 0 and tp.stored_offset != tp.committed_offset:
                out[key] = tp.stored_offset
        return out

    def store_offsets(self, message: Optional[Message] = None,
                      offsets: Optional[list[TopicPartition]] = None):
        if message is not None:
            tp = self._assignment.get((message.topic, message.partition))
            if tp:
                tp.stored_offset = message.offset + 1
        for tpo in offsets or []:
            tp = self._assignment.get((tpo.topic, tpo.partition))
            if tp:
                tp.stored_offset = tpo.offset

    def commit(self, message: Optional[Message] = None,
               offsets: Optional[list[TopicPartition]] = None,
               asynchronous: bool = False):
        if self._rk.cgrp is None:
            raise KafkaException(Err._UNKNOWN_GROUP, "commit requires group.id")
        if message is not None:
            to_commit = {(message.topic, message.partition): message.offset + 1}
        elif offsets is not None:
            to_commit = {(o.topic, o.partition): (o.offset, o.metadata)
                         for o in offsets}
        else:
            to_commit = self.stored_offsets()
        if not to_commit:
            return None
        if asynchronous:
            self._rk.cgrp.commit_offsets(to_commit, None)
            return None
        done = []
        reply = SyncReply()

        def cb(err, resp):
            done.append(err)
            reply.post()

        cgrp = self._rk.cgrp
        # offsets= entries carry (offset, metadata) tuples internally;
        # the returned TopicPartitions must carry the plain offset
        result = [TopicPartition(t, p, off[0] if isinstance(off, tuple)
                                 else off)
                  for (t, p), off in to_commit.items()]
        store = self._rk.offset_store
        deadline = time.monotonic() + 10
        while True:
            if cgrp.commit_offsets(to_commit, cb):
                reply.wait(lambda: bool(done),
                           max(0.0, deadline - time.monotonic()))
                break
            # coordinator not known yet (fresh/assign()-based consumer):
            # commit_offsets already reported _WAIT_COORD into `done` —
            # drop it, wait for the coord FSM (driven by the main-thread
            # serve loop) to come up, and retry until the deadline.
            # File-backed items were committed locally by the failed
            # attempt (commit_offsets does those before the coordinator
            # check) — strip them so retries don't redo the side effects
            done.clear()
            if store is not None:
                to_commit = {k: v for k, v in to_commit.items()
                             if not store.uses_file(k[0])}
                if not to_commit:      # everything was file-backed: done
                    done.append(None)
                    break
            if time.monotonic() >= deadline:
                done.append(KafkaError(Err._WAIT_COORD, "no coordinator"))
                break
            cgrp.coord_ready.wait(
                lambda: cgrp.state == "up",
                min(0.5, max(0.0, deadline - time.monotonic())))
        if not done:
            # request sent but no reply within the deadline — surface it
            # (reference rd_kafka_commit returns _TIMED_OUT), never imply
            # a successful commit the broker may not have applied
            raise KafkaException(Err._TIMED_OUT, "commit reply timed out")
        if done[0] is not None:
            raise KafkaException(done[0])
        return result

    def committed(self, partitions: list[TopicPartition],
                  timeout: float = 10.0) -> list[TopicPartition]:
        if self._rk.cgrp is None:
            raise KafkaException(Err._UNKNOWN_GROUP, "requires group.id")
        result = {}
        done = []
        reply = SyncReply()

        def cb(err, resp):
            if err is None:
                for tr in resp["topics"]:
                    for pr in tr["partitions"]:
                        result[(tr["topic"], pr["partition"])] = (
                            pr["offset"], pr.get("metadata"))
            done.append(err)
            reply.post()

        cgrp = self._rk.cgrp
        keys = [(p.topic, p.partition) for p in partitions]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cgrp.fetch_committed(keys, cb):
                reply.wait(lambda: bool(done),
                           max(0.0, deadline - time.monotonic()))
                break
            # no coordinator yet — wait for the FSM and retry (the
            # failed attempt resets cgrp.state, so this doesn't spin)
            cgrp.coord_ready.wait(
                lambda: cgrp.state == "up",
                min(0.5, max(0.0, deadline - time.monotonic())))
        if not done:
            raise KafkaException(Err._TIMED_OUT,
                                 "committed offsets not available")
        if done[0] is not None:
            raise KafkaException(done[0])
        out = []
        for p in partitions:
            off, meta = result.get((p.topic, p.partition),
                                   (proto.OFFSET_INVALID, None))
            out.append(TopicPartition(p.topic, p.partition, off,
                                      metadata=meta))
        return out

    # ------------------------------------------------------ seek & pause --
    def seek(self, partition: TopicPartition):
        tp = self._assignment.get((partition.topic, partition.partition))
        if tp is None:
            raise KafkaException(Err._STATE, "partition not assigned")
        tp.version += 1
        tp.fetchq.pop_all()
        with tp.lock:
            tp.fetchq_cnt = 0
            tp.fetchq_bytes = 0
        if partition.offset in (proto.OFFSET_BEGINNING, proto.OFFSET_END):
            tp.fetch_offset = partition.offset
            tp.fetch_state = FetchState.OFFSET_QUERY
        else:
            tp.fetch_offset = partition.offset
            tp.fetch_state = FetchState.ACTIVE
        self._rk._wake_leader(tp)

    def pause(self, partitions: list[TopicPartition]):
        for p in partitions:
            tp = self._assignment.get((p.topic, p.partition))
            if tp:
                tp.paused = True

    def resume(self, partitions: list[TopicPartition]):
        for p in partitions:
            tp = self._assignment.get((p.topic, p.partition))
            if tp:
                tp.paused = False
                self._rk._wake_leader(tp)

    def position(self, partitions: list[TopicPartition]
                 ) -> list[TopicPartition]:
        out = []
        for p in partitions:
            tp = self._assignment.get((p.topic, p.partition))
            out.append(TopicPartition(p.topic, p.partition,
                                      tp.app_offset if tp else
                                      proto.OFFSET_INVALID))
        return out

    def get_watermark_offsets(self, partition: TopicPartition,
                              timeout: float = 10.0,
                              cached: bool = False) -> tuple[int, int]:
        """Low/high watermarks (reference: rd_kafka_query_watermark_
        offsets / rd_kafka_get_watermark_offsets). ``cached=True``
        returns the fetcher's last-known value without a query; the
        query path is two ListOffsets lookups through the same
        machinery as offsets_for_times (BEGINNING/END timestamps)."""
        if cached:
            tp = self._rk.get_toppar(partition.topic, partition.partition)
            return (0, tp.hi_offset)
        deadline = time.monotonic() + timeout
        out = []
        for ts in (proto.OFFSET_BEGINNING, proto.OFFSET_END):
            r = self.offsets_for_times(
                [TopicPartition(partition.topic, partition.partition, ts)],
                timeout=max(0.0, deadline - time.monotonic()))[0]
            if r.error is not None:
                raise KafkaException(r.error)
            out.append(r.offset)
        return (out[0], out[1])

    def offsets_for_times(self, partitions: list[TopicPartition],
                          timeout: float = 10.0) -> list[TopicPartition]:
        """Earliest offsets at/after the given timestamps (reference:
        rd_kafka_offsets_for_times -> ListOffsets v1 with real
        timestamps). Input offsets carry the timestamps (ms), like the
        reference API. A timestamp past the end of the log yields
        offset -1 with NO error (reference semantics)."""
        rk = self._rk
        results: dict = {}
        reply = SyncReply()
        deadline = time.monotonic() + timeout   # ONE budget for the call

        def make_cb(keys):
            def cb(err, resp):
                if err is None:
                    for tr in resp["topics"]:
                        for pr in tr["partitions"]:
                            off = pr.get("offset")
                            if off is None:     # ListOffsets v0: plural
                                offs = pr.get("offsets") or [-1]
                                off = offs[0]
                            key = (tr["topic"], pr["partition"])
                            results[key] = (pr["error_code"], off)
                else:
                    for k in keys:
                        results[k] = (-1, proto.OFFSET_INVALID)
                reply.post()
            return cb

        # group by leader broker like the fetch path
        by_broker: dict = {}
        for tpo in partitions:
            tp = rk.get_toppar(tpo.topic, tpo.partition)
            while tp.leader_id < 0 and time.monotonic() < deadline:
                # block on the metadata condvar (notified on every
                # metadata update) instead of sleep-polling; the 0.5s
                # cap re-issues the refresh if an update didn't help
                rk.metadata_refresh("offsets_for_times",
                                    topics=[tpo.topic])
                rk.metadata_wait(
                    lambda: tp.leader_id >= 0,
                    min(0.5, max(0.0, deadline - time.monotonic())))
            by_broker.setdefault(tp.leader_id, []).append(tpo)
        for leader, tpos in by_broker.items():
            b = rk.brokers.get(leader)
            if b is None:
                for tpo in tpos:
                    results[(tpo.topic, tpo.partition)] = (
                        -1, proto.OFFSET_INVALID)
                continue
            body = {"replica_id": -1,
                    "topics": [{"topic": tpo.topic, "partitions": [
                        {"partition": tpo.partition,
                         "timestamp": tpo.offset,
                         "max_num_offsets": 1}]}
                        for tpo in tpos]}
            keys = [(tpo.topic, tpo.partition) for tpo in tpos]
            b.enqueue_request(Request(ApiKey.ListOffsets, body,
                                      retries_left=2, cb=make_cb(keys)))
        reply.wait(lambda: len(results) >= len(partitions),
                   max(0.0, deadline - time.monotonic()))
        out = []
        for tpo in partitions:
            key = (tpo.topic, tpo.partition)
            r = TopicPartition(tpo.topic, tpo.partition,
                               proto.OFFSET_INVALID)
            if key not in results:
                r.error = KafkaError(Err._TIMED_OUT)
            else:
                ec, off = results[key]
                r.offset = off
                if ec == -1:
                    r.error = KafkaError(Err._TRANSPORT)
                elif ec > 0:
                    r.error = KafkaError(Err.from_wire(ec))
                # ec == 0 with offset -1 is the legitimate "no offset
                # at or after this timestamp" result - NOT an error
            out.append(r)
        return out

    def io_event_enable(self, fd: int, payload: bytes = b"1") -> None:
        """select()/epoll() integration: every op landing on the
        consumer queue writes ``payload`` to ``fd`` (reference:
        rd_kafka_queue_io_event_enable on the consumer queue)."""
        self.queue.io_event_enable(fd, payload)

    def list_topics(self, timeout: float = 10.0) -> dict:
        """rd_kafka_metadata analog: full cluster metadata snapshot."""
        return self._rk.list_topics(timeout)

    def cluster_id(self, timeout: float = 5.0):
        """rd_kafka_clusterid analog."""
        return self._rk.cluster_id(timeout)

    def controller_id(self, timeout: float = 5.0) -> int:
        """rd_kafka_controllerid analog."""
        return self._rk.controller_id(timeout)

    def memberid(self) -> str:
        """Group member id after joining (rd_kafka_memberid analog;
        empty string before the first JoinGroup completes)."""
        cg = self._rk.cgrp
        return cg.member_id if cg is not None else ""

    def consumer_group_metadata(self):
        """Opaque group metadata for
        Producer.send_offsets_to_transaction (the
        rd_kafka_consumer_group_metadata analog: group id plus the
        current generation/member identity)."""
        from .errors import Err, KafkaException
        cg = self._rk.cgrp
        if cg is None:
            raise KafkaException(Err._UNKNOWN_GROUP,
                                 "consumer_group_metadata requires group.id")
        return ConsumerGroupMetadata(cg.group_id, cg.generation,
                                     cg.member_id)

    def poll_kafka(self, timeout: float = 0.0) -> int:
        return self._rk.poll(timeout)

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._rk.cgrp:
            self._rk.cgrp.terminate()
        self.apply_assignment({})
        self._rk.close()

    def trace_dump(self, path: str) -> int:
        """Export the flight-recorder trace rings as Chrome trace-event
        JSON (trace.enable=true; see TRACING.md)."""
        return self._rk.trace_dump(path)

    @property
    def rk(self) -> Kafka:
        return self._rk
