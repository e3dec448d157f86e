"""Transactional producer (EOS) state machine.

The subsystem librdkafka v1.3.0 stops just short of (its txn manager
lands in 1.4, src/rdkafka_txnmgr.c): a coordinator-backed transaction
FSM layered over the idempotent producer —

    UNINIT ──init_transactions()──> READY
    READY ──begin_transaction()──> IN_TXN
    IN_TXN ──commit_transaction()──> COMMITTING ──> READY
    IN_TXN ──abort_transaction()──> ABORTING ──> READY
    (any) ──abortable error──> ABORTABLE_ERROR ──abort_transaction()──> READY
    (any) ──fenced / fatal──> FATAL

init_transactions() finds the transaction coordinator
(FindCoordinator key_type=1) and acquires a (pid, epoch) bound to
``transactional.id`` via InitProducerId — re-initialization of the same
id bumps the epoch, fencing zombie instances (their next request fails
fatally with PRODUCER_FENCED).  During a transaction every partition
touched by a produced batch is registered with the coordinator
(AddPartitionsToTxn) before its ProduceRequests may leave — the broker
serve loop gates on partition_ready(), and the main-thread serve() pass
flushes the pending-partition set, mirroring the reference's
rd_kafka_txn_register_toppar flow.  commit/abort resolve through
EndTxn, which makes the coordinator write COMMIT/ABORT control records
into every registered partition log.

Error taxonomy (the reference's three txn error classes):
retriable (coordinator moved/loading, timeouts) are retried internally
until the API timeout; abortable (a failed produce inside the txn)
park the FSM in ABORTABLE_ERROR until abort_transaction(); fatal
(fencing, authorization) poison the producer permanently.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Optional, TYPE_CHECKING

from ..protocol.proto import ApiKey
from ..analysis.locks import new_cond, new_rlock
from ..analysis.races import shared
from ..obs import trace as _trace
from .broker import Request
from .errors import Err, KafkaError, KafkaException
from .queue import Op, OpType

if TYPE_CHECKING:
    from .kafka import Kafka

#: Errors a transactional request may be retried on (coordinator
#: election/loading, an ongoing txn still completing, plain transport).
RETRIABLE = frozenset({
    Err._TRANSPORT, Err._TIMED_OUT, Err.REQUEST_TIMED_OUT,
    Err.COORDINATOR_NOT_AVAILABLE, Err.NOT_COORDINATOR,
    Err.COORDINATOR_LOAD_IN_PROGRESS, Err.CONCURRENT_TRANSACTIONS,
    Err.UNKNOWN_TOPIC_OR_PART,
})

#: Errors that permanently poison this producer instance (reference:
#: rd_kafka_txn_set_fatal_error callers).
FATAL = frozenset({
    Err.PRODUCER_FENCED, Err.INVALID_PRODUCER_EPOCH,
    Err.TRANSACTION_COORDINATOR_FENCED,
    Err.TRANSACTIONAL_ID_AUTHORIZATION_FAILED,
    Err.INVALID_TRANSACTION_TIMEOUT, Err.INVALID_PRODUCER_ID_MAPPING,
    Err.UNSUPPORTED_VERSION,
})


class TransactionManager:
    """Owns the txn FSM for one transactional producer instance."""

    # relaxed lockset declarations (analysis/races.py): every FSM
    # transition and registration mutation happens under the txn.mgr
    # RLock, but the produce gate (kafka.produce: ``state != IN_TXN``)
    # and the stats emitter read lock-free — str/int/len snapshots,
    # atomic under the GIL, and the gate is re-validated by the broker
    # protocol (PRODUCER_FENCED / INVALID_TXN_STATE) if it races a
    # transition.  Tracked so a second writer thread would surface.
    state = shared("txn.state", relaxed=True)
    pid = shared("txn.pid", relaxed=True)
    epoch = shared("txn.epoch", relaxed=True)
    coord_id = shared("txn.coord_id", relaxed=True)
    _registered = shared("txn.registered", relaxed=True)
    _pending = shared("txn.pending", relaxed=True)

    def __init__(self, rk: "Kafka"):
        self.rk = rk
        self.transactional_id: str = rk.conf.get("transactional.id")
        self.state = "UNINIT"
        self.pid = -1
        self.epoch = -1
        self.coord_id: Optional[int] = None
        # (key_type, key) -> the coordinator's node id, until a request
        # to it fails retriably
        self._coords: dict[tuple[int, str], int] = {}
        self._lock = new_rlock("txn.mgr")
        # notified on AddPartitionsToTxn completion and fatal errors;
        # retriable backoffs ride timed waits on it (no sleep-polling
        # in client/ — test_0120 — and close()/fatal can wake them)
        self._cv = new_cond("txn.mgr", self._lock)
        # partitions of the CURRENT transaction
        self._registered: set[tuple[str, int]] = set()
        self._pending: set[tuple[str, int]] = set()
        self._register_inflight = False
        self._abortable_reason: Optional[KafkaError] = None
        # offsets staged via send_offsets_to_transaction (group ids,
        # for the empty-txn EndTxn skip decision)
        self._sent_offsets = False
        # transactions begun, committed and aborted, and the wall time
        # of the commits that returned, ns (always counted); the calling
        # thread's CPU inside the transaction API and its coordinator
        # requests, ns (tracing only; CPU_ACCOUNTING.md)
        self.begins = self.commits = self.aborts = 0
        self.commit_wall_ns = 0
        self.cpu_ns = 0
        self._t_register = 0    # AddPartitionsToTxn sent (trace clock)

    def _cpu0(self) -> int:
        """The calling thread's CPU clock while tracing, else 0."""
        return time.thread_time_ns() if _trace.enabled else 0

    def _cpu_add(self, c0: int) -> None:
        if c0:
            self.cpu_ns += time.thread_time_ns() - c0

    # ------------------------------------------------------- state helpers --
    def _set_state(self, state: str) -> None:
        """FSM transition (callers hold self._lock). Keeps the native
        produce fast lane's enable flag in sync: it is only open while
        produce() is legal (IN_TXN) because the C entry point cannot
        check the state gate per call."""
        self.state = state
        self.rk._txn_lane_sync()

    def _require(self, *states: str):
        if self.rk.fatal_error is not None:
            raise KafkaException(self.rk.fatal_error)
        if self.state not in states:
            raise KafkaException(
                Err._STATE,
                f"operation not valid in transaction state {self.state} "
                f"(expected {'/'.join(states)})")

    def _fatal(self, code: Err, reason: str) -> KafkaError:
        err = KafkaError(code, reason, retriable=False)
        with self._lock:
            self._set_state("FATAL")
            self._cv.notify_all()
        self.rk.set_fatal_error(err)
        # fail everything still queued NOW (reference: a fatal error
        # purges the producer queues) so flush()/commit callers blocked
        # on outstanding messages unwedge immediately
        try:
            self.rk.purge(in_queue=True, in_flight=False)
        except Exception:
            pass
        return err

    def fenced(self, where: str) -> KafkaError:
        """A broker told us a newer instance of this transactional.id
        exists: this producer is a zombie (reference: PRODUCER_FENCED
        is always fatal)."""
        return self._fatal(
            Err.PRODUCER_FENCED,
            f"{where}: producer fenced by a newer instance of "
            f"transactional.id {self.transactional_id!r} "
            f"(pid {self.pid} epoch {self.epoch})")

    def msg_failed(self, err: KafkaError) -> None:
        """A message in the current transaction failed delivery: the
        transaction may no longer be committed — only aborted
        (reference: rd_kafka_txn_set_abortable_error)."""
        with self._lock:
            if self.state in ("IN_TXN", "COMMITTING") and err.code not in (
                    Err._PURGE_QUEUE, Err._PURGE_INFLIGHT):
                self._abortable_reason = err
                if self.state == "IN_TXN":
                    self._set_state("ABORTABLE_ERROR")

    # ---------------------------------------------------------- transport --
    def _backoff(self, deadline: float, max_wait: float = 0.05) -> None:
        """Timed retry backoff on the manager condvar (wakeable by a
        fatal error / AddPartitionsToTxn completion, never a bare
        sleep-poll)."""
        remain = min(max_wait, deadline - time.monotonic())
        if remain <= 0:
            return
        with self._cv:
            self._cv.wait(remain)

    def _wait_any_broker(self, deadline: float):
        b = self.rk.any_up_broker()
        if b is not None:
            return b
        # wakes on every metadata cache update — which broker-up
        # transitions trigger (kafka.broker_state_change)
        self.rk.metadata_wait(
            lambda: self.rk.any_up_broker() is not None,
            max(0.0, deadline - time.monotonic()))
        b = self.rk.any_up_broker()
        if b is None:
            raise KafkaException(Err._TIMED_OUT,
                                 "no broker became available")
        return b

    def _coord_broker(self, deadline: float, *, key: str, key_type: int):
        """The coordinator broker, demanding a connection under sparse
        connections: the one found last for ``key`` while no request to
        it has failed retriably (as rd_kafka_txn_coord_query keeps
        rk_eos.txn_coord), else resolved by FindCoordinator. Blocks (app
        thread)."""
        with self.rk._brokers_lock:
            cb = self.rk.brokers.get(self._coords.get((key_type, key)))
        if cb is not None:
            cb.schedule_connect()
            return cb
        while True:
            remain = deadline - time.monotonic()
            if remain <= 0:
                raise KafkaException(Err._TIMED_OUT,
                                     "coordinator lookup timed out")
            b = self._wait_any_broker(deadline)
            err, resp = self._sync_request(
                b, ApiKey.FindCoordinator,
                {"key": key, "key_type": key_type}, deadline)
            if err is None and resp["error_code"] == 0:
                coord_id = resp["node_id"]
                with self.rk._brokers_lock:
                    cb = self.rk.brokers.get(coord_id)
                if cb is None:
                    self.rk.metadata_refresh("txn coordinator unknown")
                    self._backoff(deadline)
                    continue
                if key_type == 1:
                    self.coord_id = coord_id
                self._coords[(key_type, key)] = coord_id
                cb.schedule_connect()
                return cb
            code = (err.code if err is not None
                    else Err.from_wire(resp["error_code"]))
            if code in FATAL:
                raise KafkaException(self._fatal(
                    code, f"FindCoordinator({key!r}): {code.name}"))
            self._backoff(deadline)

    @staticmethod
    def _sync_request(broker, api: ApiKey, body: dict, deadline: float):
        """enqueue_request + block for the response (app thread).
        Returns (err, resp) like a Request callback receives them."""
        q: _queue.Queue = _queue.Queue(1)
        broker.enqueue_request(Request(
            api, body, retries_left=3, abs_timeout=deadline,
            cb=lambda e, r: q.put((e, r))))
        try:
            return q.get(timeout=max(0.0, deadline - time.monotonic()) + 1.0)
        except _queue.Empty:
            return KafkaError(Err._TIMED_OUT,
                              f"{api.name} timed out"), None

    def _txn_request(self, api: ApiKey, body: dict, deadline: float,
                     what: str) -> dict:
        """Issue a coordinator request, retrying retriable errors and
        re-resolving the coordinator, until the deadline. Raises on
        fatal/abortable errors; returns the response body."""
        while True:
            if time.monotonic() >= deadline:
                raise KafkaException(
                    KafkaError(Err._TIMED_OUT, f"{what} timed out",
                               retriable=True))
            b = self._coord_broker(deadline, key=self.transactional_id,
                                   key_type=1)
            err, resp = self._sync_request(b, api, body, deadline)
            if err is None:
                code = Err.from_wire(resp.get("error_code", 0))
                if code == Err.NO_ERROR:
                    return resp
            else:
                code = err.code
            if code in (Err.PRODUCER_FENCED, Err.INVALID_PRODUCER_EPOCH,
                        Err.TRANSACTION_COORDINATOR_FENCED):
                raise KafkaException(self.fenced(what))
            if code in FATAL:
                raise KafkaException(self._fatal(
                    code, f"{what}: {code.name}"))
            if code in RETRIABLE:
                # NOT_COORDINATOR: re-resolve
                self.coord_id = None
                self._coords.pop((1, self.transactional_id), None)
                self._backoff(deadline)
                continue
            # anything else: the transaction can only be aborted
            kerr = KafkaError(code, f"{what}: {code.name}",
                              retriable=False)
            with self._lock:
                self._abortable_reason = kerr
                if self.state in ("IN_TXN", "COMMITTING"):
                    self._set_state("ABORTABLE_ERROR")
            raise KafkaException(kerr)

    # ----------------------------------------------------------- public API --
    def _deadline(self, timeout: float) -> float:
        if timeout is None or timeout < 0:
            timeout = self.rk.conf.get("transaction.timeout.ms") / 1000.0
        return time.monotonic() + timeout

    def init_transactions(self, timeout: float = -1) -> None:
        """FindCoordinator(txn) + InitProducerId(transactional.id):
        acquire the fencing (pid, epoch) (reference:
        rd_kafka_init_transactions)."""
        self._require("UNINIT", "READY")
        deadline = self._deadline(timeout)
        c0 = self._cpu0()
        try:
            resp = self._txn_request(
                ApiKey.InitProducerId,
                {"transactional_id": self.transactional_id,
                 "transaction_timeout_ms":
                     self.rk.conf.get("transaction.timeout.ms")},
                deadline, "init_transactions")
        finally:
            self._cpu_add(c0)
        with self._lock:
            self.pid = resp["producer_id"]
            self.epoch = resp["producer_epoch"]
            self._set_state("READY")
        # hand the identity to the idempotence layer: the writer stamps
        # every batch from rk.idemp (one source of truth for pid/epoch)
        idemp = self.rk.idemp
        with idemp._lock:
            idemp.pid = self.pid
            idemp.epoch = self.epoch
            idemp.state = "ASSIGNED"
        self.rk.dbg("eos", f"transactional pid {self.pid} "
                           f"epoch {self.epoch} "
                           f"({self.transactional_id!r})")

    def begin_transaction(self) -> None:
        self._require("READY")
        t0 = _trace.now() if _trace.enabled else 0
        c0 = self._cpu0()
        with self._lock:
            self._registered.clear()
            self._pending.clear()
            self._abortable_reason = None
            self._sent_offsets = False
            self._set_state("IN_TXN")
        self.begins += 1
        self.rk.dbg("eos", "transaction begun")
        if t0:
            self._cpu_add(c0)
            _trace.complete("txn", "begin", t0)

    def send_offsets_to_transaction(self, offsets, group_metadata,
                                    timeout: float = -1) -> None:
        """Commit consumed offsets as part of this transaction
        (reference: rd_kafka_send_offsets_to_transaction —
        AddOffsetsToTxn to the txn coordinator, then TxnOffsetCommit to
        the group coordinator)."""
        self._require("IN_TXN")
        group_id = getattr(group_metadata, "group_id", group_metadata)
        if not isinstance(group_id, str) or not group_id:
            raise KafkaException(Err._INVALID_ARG,
                                 "group metadata must carry a group id")
        deadline = self._deadline(timeout)
        t0 = _trace.now() if _trace.enabled else 0
        c0 = self._cpu0()
        try:
            self._send_offsets(offsets, group_id, deadline)
        finally:
            if t0:
                self._cpu_add(c0)
                _trace.complete("txn", "send_offsets", t0,
                                {"group": group_id,
                                 "partitions": len(offsets)})

    def _send_offsets(self, offsets, group_id: str, deadline: float) -> None:
        """AddOffsetsToTxn, then TxnOffsetCommit until the deadline."""
        self._txn_request(
            ApiKey.AddOffsetsToTxn,
            {"transactional_id": self.transactional_id,
             "producer_id": self.pid, "producer_epoch": self.epoch,
             "group_id": group_id},
            deadline, "send_offsets_to_transaction(AddOffsetsToTxn)")
        by_topic: dict[str, list] = {}
        for tp in offsets:
            by_topic.setdefault(tp.topic, []).append(
                {"partition": tp.partition, "offset": tp.offset,
                 "metadata": getattr(tp, "metadata", None)})
        body = {"transactional_id": self.transactional_id,
                "group_id": group_id,
                "producer_id": self.pid, "producer_epoch": self.epoch,
                "topics": [{"topic": t, "partitions": ps}
                           for t, ps in by_topic.items()]}
        while True:
            gb = self._coord_broker(deadline, key=group_id, key_type=0)
            err, resp = self._sync_request(gb, ApiKey.TxnOffsetCommit,
                                           body, deadline)
            codes = []
            if err is None:
                codes = [Err.from_wire(p["error_code"])
                         for t in resp["topics"] for p in t["partitions"]]
                if all(c == Err.NO_ERROR for c in codes):
                    with self._lock:
                        self._sent_offsets = True
                    return
            bad = (err.code if err is not None
                   else next(c for c in codes if c != Err.NO_ERROR))
            if bad in (Err.PRODUCER_FENCED, Err.INVALID_PRODUCER_EPOCH):
                raise KafkaException(self.fenced("TxnOffsetCommit"))
            if bad in FATAL:
                raise KafkaException(self._fatal(
                    bad, f"TxnOffsetCommit: {bad.name}"))
            if bad not in RETRIABLE or time.monotonic() >= deadline:
                kerr = KafkaError(bad, f"TxnOffsetCommit: {bad.name}",
                                  retriable=bad in RETRIABLE)
                with self._lock:
                    if bad not in RETRIABLE:
                        self._abortable_reason = kerr
                        self._set_state("ABORTABLE_ERROR")
                raise KafkaException(kerr)
            self._coords.pop((0, group_id), None)
            self._backoff(deadline)

    def commit_transaction(self, timeout: float = -1) -> None:
        """Flush every in-flight message, then EndTxn(committed=True)
        (reference: rd_kafka_commit_transaction)."""
        self._require("IN_TXN")
        deadline = self._deadline(timeout)
        t0 = time.monotonic_ns()
        c0 = self._cpu0()
        parts = {}
        try:
            self._commit(deadline, parts)
        finally:
            self._cpu_add(c0)
            if _trace.enabled:
                _trace.complete("txn", "commit", t0, parts)
        self.commits += 1
        self.commit_wall_ns += time.monotonic_ns() - t0

    def _commit(self, deadline: float, parts: dict) -> None:
        """Flush, then EndTxn(committed=True); ``parts`` gets the wall
        time of each, ns (``flush_ns``, ``end_txn_ns``)."""
        # all outstanding messages must be delivered before the commit
        # marker is written — including batches still inside the codec
        # offload pipeline (their tickets resolve through the normal
        # flush path)
        remain = max(0.1, deadline - time.monotonic())
        t_flush = time.monotonic_ns()
        flushed = self.rk.flush(remain)
        parts["flush_ns"] = time.monotonic_ns() - t_flush
        if flushed != 0:
            raise KafkaException(KafkaError(
                Err._TIMED_OUT,
                "commit_transaction: outstanding messages did not "
                "drain within the timeout", retriable=True))
        with self._lock:
            if self.state == "ABORTABLE_ERROR" or \
                    self._abortable_reason is not None:
                reason = self._abortable_reason
                raise KafkaException(KafkaError(
                    Err._STATE,
                    "commit_transaction: transaction must be aborted "
                    f"(a message failed: {reason!r})", retriable=False))
            self._require("IN_TXN")
            empty = (not self._registered and not self._pending
                     and not self._sent_offsets)
            self._set_state("COMMITTING")
        t_end = time.monotonic_ns()
        try:
            if not empty:
                self._txn_request(
                    ApiKey.EndTxn,
                    {"transactional_id": self.transactional_id,
                     "producer_id": self.pid,
                     "producer_epoch": self.epoch, "committed": True},
                    deadline, "commit_transaction")
            parts["end_txn_ns"] = time.monotonic_ns() - t_end
        except KafkaException as e:
            with self._lock:
                if self.state == "COMMITTING":
                    self._set_state("ABORTABLE_ERROR"
                                    if not e.error.retriable
                                    and e.error.code not in FATAL
                                    else "IN_TXN" if e.error.retriable
                                    else self.state)
            raise
        with self._lock:
            self._set_state("READY")
            self._registered.clear()
            self._pending.clear()
        self.rk.dbg("eos", "transaction committed")

    def abort_transaction(self, timeout: float = -1) -> None:
        """Purge queued messages, drain in-flight ones (codec tickets
        included — fail-or-drain, never wedge the dispatch thread),
        then EndTxn(committed=False) (reference:
        rd_kafka_abort_transaction)."""
        self._require("IN_TXN", "ABORTABLE_ERROR", "COMMITTING")
        deadline = self._deadline(timeout)
        t0 = _trace.now() if _trace.enabled else 0
        c0 = self._cpu0()
        try:
            self._abort(deadline)
        finally:
            if t0:
                self._cpu_add(c0)
                _trace.complete("txn", "abort", t0)
        self.aborts += 1

    def _abort(self, deadline: float) -> None:
        with self._lock:
            self._set_state("ABORTING")
        # queued-but-unsent messages will never be wanted: purge them
        # (their DRs carry _PURGE_QUEUE). In-flight requests AND batches
        # inside the codec pipeline are left to complete — their records
        # land before the ABORT marker and are hidden by it — so the
        # flush below drains every outstanding ticket deterministically.
        self.rk.purge(in_queue=True, in_flight=False)
        remain = max(0.1, deadline - time.monotonic())
        if self.rk.flush(remain) != 0:
            with self._lock:
                self._set_state("ABORTABLE_ERROR")
            raise KafkaException(KafkaError(
                Err._TIMED_OUT,
                "abort_transaction: in-flight messages did not drain "
                "within the timeout", retriable=True))
        # registration quiescence: an in-flight AddPartitionsToTxn must
        # resolve before EndTxn (its response decides the final
        # registered set). Partitions still merely *pending* after the
        # purge+flush carry no broker-side data — produce is gated on
        # registration — so with the queue purged they never will:
        # drop them instead of registering partitions the coordinator
        # would mark with an empty transaction.
        with self._cv:
            while self._register_inflight:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise KafkaException(KafkaError(
                        Err._TIMED_OUT,
                        "abort_transaction: partition registration did "
                        "not quiesce within the timeout", retriable=True))
                self._cv.wait(remain)
            self._pending.clear()
            had_work = bool(self._registered or self._sent_offsets)
        try:
            if had_work:
                self._txn_request(
                    ApiKey.EndTxn,
                    {"transactional_id": self.transactional_id,
                     "producer_id": self.pid,
                     "producer_epoch": self.epoch, "committed": False},
                    deadline, "abort_transaction")
        except KafkaException as e:
            with self._lock:
                if self.state == "ABORTING":
                    self._set_state("IN_TXN" if e.error.retriable
                                    else self.state)
            raise
        # bump the epoch (KIP-360 shape): purged messages consumed
        # msgids, so per-partition sequences have gaps the broker would
        # reject — a fresh epoch restarts sequencing at 0, and the
        # DRAIN-style rebase realigns every toppar's msgid origin
        resp = self._txn_request(
            ApiKey.InitProducerId,
            {"transactional_id": self.transactional_id,
             "transaction_timeout_ms":
                 self.rk.conf.get("transaction.timeout.ms")},
            deadline, "abort_transaction(epoch bump)")
        with self.rk._toppars_lock:
            tps = list(self.rk._toppars.values())
        for tp in tps:
            with tp.lock:
                tp.epoch_base_msgid = tp.next_msgid - 1
        with self._lock:
            self.pid = resp["producer_id"]
            self.epoch = resp["producer_epoch"]
            self._registered.clear()
            self._pending.clear()
            self._abortable_reason = None
            self._set_state("READY")
        idemp = self.rk.idemp
        with idemp._lock:
            idemp.pid = self.pid
            idemp.epoch = self.epoch
            idemp.state = "ASSIGNED"
        self.rk.dbg("eos", f"transaction aborted (epoch -> {self.epoch})")

    # --------------------------------------------- broker-thread interface --
    def can_produce(self) -> bool:
        return self.state in ("IN_TXN", "COMMITTING", "ABORTING")

    def partition_ready(self, tp) -> bool:
        """May this toppar's batches be sent? True once the partition
        is registered with the coordinator; otherwise queues it for the
        main-thread serve() pass to register (the broker serve loop
        must never block on a coordinator round trip)."""
        key = (tp.topic, tp.partition)
        with self._lock:
            if not self.can_produce():
                return False
            if key in self._registered:
                return True
            first = key not in self._pending
            self._pending.add(key)
        if first:
            # wake the main thread NOW: its serve() pass sends the
            # AddPartitionsToTxn — without the nudge the partition's
            # first batches stall up to a full main-loop tick (100ms)
            self.rk.ops.push(Op(OpType.BROKER_WAKEUP))
        return False

    def serve(self) -> None:
        """Main-thread pass: flush the pending-partition set with ONE
        AddPartitionsToTxn (reference: rd_kafka_txn_register_toppars)."""
        with self._lock:
            # IN_TXN only: commit flushes (and so registers) before it
            # leaves IN_TXN, and an abort's purged messages must not
            # re-register partitions the coordinator would then hold
            # an empty transaction open for
            if (not self._pending or self._register_inflight
                    or self.state != "IN_TXN"):
                return
            batch = sorted(self._pending)
            self._register_inflight = True
        with self.rk._brokers_lock:
            b = self.rk.brokers.get(self.coord_id)
        if b is None:
            with self._lock:
                self._register_inflight = False
                self._cv.notify_all()
            return
        if not b.is_up():
            b.schedule_connect()
        self._t_register = _trace.now() if _trace.enabled else 0
        by_topic: dict[str, list[int]] = {}
        for t, p in batch:
            by_topic.setdefault(t, []).append(p)
        b.enqueue_request(Request(
            ApiKey.AddPartitionsToTxn,
            {"transactional_id": self.transactional_id,
             "producer_id": self.pid, "producer_epoch": self.epoch,
             "topics": [{"topic": t, "partitions": ps}
                        for t, ps in by_topic.items()]},
            retries_left=3,
            cb=self._handle_add_partitions))

    def _handle_add_partitions(self, err, resp):
        if self._t_register and _trace.enabled:
            # sent on the main thread, answered on the coordinator's
            _trace.complete("txn", "add_partitions", self._t_register,
                            {"error": err is not None})
        with self._lock:
            self._register_inflight = False
            self._cv.notify_all()           # wakes abort's quiescence wait
            if err is not None:
                return                      # retried by the next serve()
            woke = []
            for t in resp["results"]:
                for p in t["partitions"]:
                    key = (t["topic"], p["partition"])
                    code = Err.from_wire(p["error_code"])
                    if code == Err.NO_ERROR:
                        self._pending.discard(key)
                        self._registered.add(key)
                        woke.append(key)
                    elif code in (Err.PRODUCER_FENCED,
                                  Err.INVALID_PRODUCER_EPOCH):
                        self._pending.discard(key)
                        self.fenced("AddPartitionsToTxn")
                    elif code not in RETRIABLE:
                        self._pending.discard(key)
                        kerr = KafkaError(
                            code, f"AddPartitionsToTxn {key}: {code.name}",
                            retriable=False)
                        self._abortable_reason = kerr
                        if self.state == "IN_TXN":
                            self._set_state("ABORTABLE_ERROR")
                    # retriable: stays pending for the next serve()
        for t, p in woke:
            tp = self.rk.get_toppar(t, p, create=False)
            if tp is not None:
                self.rk._wake_leader(tp)
