"""Broker engine: one thread per broker (reference: src/rdkafka_broker.c).

Each ``Broker`` runs a connection state machine
(INIT→TRY_CONNECT→CONNECT→AUTH→APIVERSION_QUERY→UP, rdkafka_broker.h:88-100)
inside its own thread (rd_kafka_broker_thread_main, rdkafka_broker.c:4653),
multiplexing socket IO with an op-queue wakeup pipe
(rd_kafka_broker_ops_io_serve, :3009). Requests flow through three queues:
outq (to send), waitresp (corrid-matched in-flight, :1449), retryq
(backoff retry, :2352).

The producer hot loop (rd_kafka_toppar_producer_serve, :3242) is rebuilt
here with the device seam widened: each serve pass collects *all* ready
partition batches, frames them (phase 1), compresses+CRCs them in ONE
batched codec-provider call (phase 2 — one CRC kernel launch per round
when compression.backend=gpu, ops/gpu.py), then finalizes and sends (phase 3).
"""
from __future__ import annotations

import enum
import errno
import queue as _stdqueue
import random
import select
import socket
import ssl as _ssl
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, TYPE_CHECKING

from ..obs import trace as _trace
from ..analysis import lockdep as _lockdep
from ..analysis.races import shared
from ..ops import cpu as _cpu_ops
from ..protocol import apis, proto
from ..protocol.apis import APIS
from ..utils import sockbuf
from ..protocol.msgset import MsgsetWriterV2, iter_legacy_crc_regions
from ..protocol.proto import ApiKey, ATTR_TRANSACTIONAL
from .errors import Err, KafkaError, KafkaException
from .feature import (MSGVER1, MSGVER2, fallback_api_versions,
                      features_from_api_versions, pick_version)
from . import codec_phase
from .arena import ArenaBatch, batch_head_msgid
from .msg import Message, MsgStatus
from .queue import Op, OpQueue, OpType

if TYPE_CHECKING:
    from .kafka import Kafka


class BrokerState(enum.Enum):
    INIT = "INIT"
    DOWN = "DOWN"
    TRY_CONNECT = "TRY_CONNECT"
    CONNECT = "CONNECT"
    AUTH_HANDSHAKE = "AUTH_HANDSHAKE"
    AUTH_REQ = "AUTH_REQ"
    APIVERSION_QUERY = "APIVERSION_QUERY"
    UP = "UP"


@dataclass
class Request:
    api: ApiKey
    body: dict
    cb: Optional[Callable] = None      # cb(err: KafkaError|None, resp: dict)
    expect_response: bool = True
    retries_left: int = 0
    abs_timeout: float = 0.0
    corrid: int = 0
    version: Optional[int] = None      # api version override
    opaque: object = None
    ts_enq: float = 0.0                # enqueue_request() time (outbuf lat.)
    ts_sent: float = 0.0               # wire write time (rtt)


# max in-flight ProduceRequests per partition with idempotence
# (reference: RD_KAFKA_IDEMP_MAX_INFLIGHT, rdkafka_idempotence.h:38)
IDEMP_MAX_INFLIGHT = 5

#: the wait that ends an UP broker's serve pass: the poll of a broker
#: with work, and the block of one with nothing a timer must serve,
#: which only an op (the wakeup pipe) or its socket ends (reference:
#: rd_kafka_max_block_ms, rdkafka_broker.c)
IO_WAIT_S = 0.005
IDLE_WAIT_S = 1.0

#: what ended a serve pass's wait (stats ``brokers.{name}.woke``): the
#: wakeup pipe or op queue, the socket readable or writable, the wait's
#: timeout, or no wait at all
PASS_WOKE = ("pipe", "read", "write", "timeout", "none")
#: ops a serve pass handles, by kind (stats ``brokers.{name}.ops``)
PASS_OPS = ("codec_done", "xmit", "wakeup", "other")


class _CpuTally:
    """While tracing: one thread's CPU (``time.thread_time_ns``) by phase
    of its passes, emitted every ``EVERY_NS`` as a zero-length event
    (``pass_tally`` / ``codec_tally``, CPU_ACCOUNTING.md) with the owner's
    counters since the previous one.  The clock runs on from pass to
    pass, so the thread's CPU between passes lands in the next pass's
    first phase; a pass that did nothing puts all of its CPU under
    ``idle``."""

    __slots__ = ("cat", "name", "first", "cur", "mark", "pass_cpu", "cpu",
                 "t_start", "base")

    EVERY_NS = 100_000_000

    def __init__(self, cat: str, name: str, first: str, counts: dict):
        _cpu_ops.pool_cpu_take()    # pool CPU from before tracing began
        self.cat, self.name, self.first = cat, name, first
        self.cur = first
        self.pass_cpu: dict = {}
        self.cpu: dict = {}
        self.t_start = _trace.now()
        self.base = counts
        self.mark = time.thread_time_ns()

    def switch(self, phase: str) -> str:
        """Charge the CPU since the last switch to the current phase and
        enter ``phase``; returns the phase left."""
        t = time.thread_time_ns()
        pc = self.pass_cpu
        pc[self.cur] = pc.get(self.cur, 0) + t - self.mark
        self.mark = t
        prev, self.cur = self.cur, phase
        return prev

    def end_pass(self, idle: bool, counts) -> None:
        """Close the pass; ``counts()`` gives the owner's counters when
        an event is due."""
        self.switch(self.first)
        pc, self.pass_cpu = self.pass_cpu, {}
        cpu = self.cpu
        if idle:
            cpu["idle"] = cpu.get("idle", 0) + sum(pc.values())
        else:
            for k, v in pc.items():
                cpu[k] = cpu.get(k, 0) + v
        if _trace.now() - self.t_start >= self.EVERY_NS:
            self.emit(counts())

    def emit(self, counts: dict) -> None:
        """The event: the counters' deltas since the previous one, the
        CPU by phase, the native pool's CPU, ``t_start`` (trace us) and
        ``dropped``, the events this thread's ring has overwritten so
        far (a reader that sees it grow between two tallies knows the
        trail between them may have lost some)."""
        args = {"t_start": self.t_start / 1e3}
        for k, v in counts.items():
            b = self.base[k]
            args[k] = ({kk: vv - b[kk] for kk, vv in v.items()}
                       if isinstance(v, dict) else v - b)
        args["cpu_ns"] = self.cpu
        args["pool_cpu_ns"] = _cpu_ops.pool_cpu_take()
        if _trace.enabled:
            args["dropped"] = _trace.thread_dropped()
            # zero length: the benchmark's gap labels take the span open
            # at a gap's middle, which a tally never is
            _trace.evt(self.cat, self.name, "X", dur=0, args=args)
        self.cpu = {}
        self.base = counts
        self.t_start = _trace.now()


def _begin_codec_phase(rk, ready: list) -> codec_phase.PendingBatches:
    """Phase 2 of a produce round (client/codec_phase.py) over ``ready``,
    ``(tp, msgs, writer)`` triples, with each topic's compression.level
    and topic.qos.weight."""
    conf = rk.topic_conf_for
    weights: dict = {}

    def qos(item):
        topic = item[0].topic
        w = weights.get(topic)
        if w is None:
            w = weights[topic] = float(
                conf(topic).get("topic.qos.weight") or 1.0)
        return topic, w

    return codec_phase.begin_round(
        rk.codec_provider, ready,
        lambda item: conf(item[0].topic).get("compression.level"), qos)


class _PendingFetch:
    """A fetch partition whose phase-B CRC verify and phase-C decompress
    are in flight as offload tickets (the consumer mirror of
    codec_phase.PendingBatches): phase-A framing/splitting is done, the partition's
    ``fetch_in_flight`` claim is still held, and phase D (parse +
    delivery) runs at resolve time — strictly FIFO per broker, so
    per-partition delivery order is preserved exactly."""

    __slots__ = ("entry", "crc_ticket", "crc_infos", "crc_bytes",
                 "legacy_ticket", "legacy_owners", "dec_tickets",
                 "t_submit_ns")

    def __init__(self, entry):
        self.entry = entry          # (tp, pres, batches, fo, ver)
        self.crc_ticket = None      # v2 batch-CRC (crc32c) ticket
        self.crc_infos = ()         # batch infos in crc_ticket order
        self.crc_bytes = 0          # bytes of the v2 regions checked
        self.legacy_ticket = None   # MsgVer0/1 zlib-poly CRC ticket
        self.legacy_owners = ()     # (offset, wanted_crc) per region
        self.dec_tickets = ()       # [(codec, items, ticket)]
        self.t_submit_ns = 0        # ticket submit (fetch_latency/trace)

    def done(self) -> bool:
        for t in (self.crc_ticket, self.legacy_ticket):
            if t is not None and not t.done():
                return False
        return all(t.done() for _c, _i, t in self.dec_tickets)


class CodecWorker(threading.Thread):
    """The codec pipeline thread (one per producer instance): runs the
    batched compress+CRC phase off the broker threads so socket IO and
    batch formation overlap with device/native launches (the
    double-buffered offload of SURVEY.md §5 axis 2, absent in the
    reference — its compression runs inline on each broker thread,
    rdkafka_msgset_writer.c:1129)."""

    # relaxed: written only by the codec worker thread; tests read the
    # high-water mark after flush/close joins
    inflight_hwm = shared("codec_worker.inflight_hwm", relaxed=True)

    def __init__(self, rk):
        super().__init__(daemon=True, name="rdk:codec")
        self.rk = rk
        self.jobs = _stdqueue.Queue()
        # max codec jobs whose CRC tickets may be outstanding before
        # the worker blocks on the oldest — mirrors the broker-side
        # codec.pipeline.depth gate so results can't pile up unbounded
        self.max_inflight = max(
            2, int(getattr(rk, "codec_pipeline_depth", 2) or 2))
        # test/bench observability: high-water mark of concurrently
        # in-flight async CRC tickets (>=2 proves pipeline overlap)
        self.inflight_hwm = 0
        # loop turns: each takes a job or resolves a ticket (with
        # tickets in flight the poll ends in resolving the oldest;
        # without them the worker blocks until a job comes)
        self.c_turns = 0
        self.start()

    def submit(self, broker: "Broker", ready: list,
               ts_codec: float, purge_epoch: int) -> None:
        self.jobs.put((broker, ready, ts_codec, purge_epoch))

    def stop(self) -> None:
        self.jobs.put(None)

    def run(self):
        if self.rk.interceptors:
            self.rk.interceptors.on_thread_start("codec", self.name)
        try:
            self._run()
        finally:
            if self.rk.interceptors:
                self.rk.interceptors.on_thread_exit("codec", self.name)

    def _post(self, broker, results, ts_codec, pepoch) -> None:
        broker.ops.push(Op(OpType.BROKER_WAKEUP,
                           payload=("codec_done", results, ts_codec,
                                    pepoch)))

    def _finish(self, entry) -> None:
        broker, pending, ts_codec, pepoch = entry
        self._post(broker, pending.finish(), ts_codec, pepoch)

    def _counts(self) -> dict:
        return {"passes": self.c_turns}

    def _run(self):
        """Pipelined consume loop: phase-2 work whose CRC went to the
        async offload engine parks in ``pending`` as a ticket; the
        worker frames + compresses the NEXT job while the device
        executes, and patches checksums when tickets resolve — the
        double-buffered overlap (a synchronous loop would block inside
        the codec phase for every device round-trip).  ``pending``
        drains strictly FIFO so per-partition send order — and with it
        idempotent sequence order — is preserved."""
        pending: deque = deque()
        tally: Optional[_CpuTally] = None   # while tracing (codec_tally)
        while True:
            if tally is not None:
                tally.end_pass(False, self._counts)     # the last turn
            if not _trace.enabled:
                tally = None
            elif tally is None:
                tally = _CpuTally("codec", "codec_tally", "busy",
                                  self._counts())
            self.c_turns += 1
            # reap resolved tickets (FIFO — stop at the first unresolved)
            while pending and pending[0][1].done():
                self._finish(pending.popleft())
            # cap the in-flight window: block on the oldest ticket
            while len(pending) >= self.max_inflight:
                self._finish(pending.popleft())
            try:
                # with tickets in flight, poll briefly so the next job
                # overlaps the device; idle otherwise blocks for real
                job = self.jobs.get(timeout=0.002 if pending else None)
            except _stdqueue.Empty:
                if pending:
                    self._finish(pending.popleft())
                continue
            if job is None:
                while pending:
                    self._finish(pending.popleft())
                if tally is not None:
                    tally.end_pass(False, self._counts)
                    tally.emit(self._counts())
                return
            broker, ready, ts_codec, pepoch = job
            try:
                pend = _begin_codec_phase(self.rk, ready)
            except Exception as e:      # belt & braces: fail every batch
                self._post(broker, [(tp, msgs, None, e)
                                    for tp, msgs, _w in ready],
                           ts_codec, pepoch)
                continue
            if pend.resolved:
                self._post(broker, pend.finish(), ts_codec, pepoch)
            else:
                pending.append((broker, pend, ts_codec, pepoch))
                self.inflight_hwm = max(self.inflight_hwm, len(pending))


class Broker:
    """One broker connection + its serve thread."""

    # lockset declarations (analysis/races.py), all RELAXED with one
    # justification: the broker is single-writer by design — every
    # field below is mutated ONLY on this broker's serve thread (ops
    # from other threads arrive through the locked OpQueue and are
    # applied here), while the stats emitter and kafka accessors take
    # lock-free len()/enum/int snapshots.  Those are atomic under the
    # GIL and a one-emit-stale gauge is acceptable; adding a broker
    # state lock would put an acquisition on every serve-loop step.
    # The sweep still tracks these through the state machine, so a
    # future SECOND writer thread shows up in the relaxed report.
    state = shared("broker.state", relaxed=True)
    ts_state = shared("broker.ts_state", relaxed=True)
    waitresp = shared("broker.waitresp", relaxed=True)
    toppars = shared("broker.toppars", relaxed=True)
    _unsent_req_ends = shared("broker.unsent_req_ends", relaxed=True)
    _fetch_pending = shared("broker.fetch_pending", relaxed=True)
    _fetch_deferred = shared("broker.fetch_deferred", relaxed=True)
    reconnect_backoff = shared("broker.reconnect_backoff", relaxed=True)
    c_tx = shared("broker.c_tx", relaxed=True)
    c_rx = shared("broker.c_rx", relaxed=True)
    c_tx_bytes = shared("broker.c_tx_bytes", relaxed=True)
    c_rx_bytes = shared("broker.c_rx_bytes", relaxed=True)
    c_connects = shared("broker.c_connects", relaxed=True)
    c_req_timeouts = shared("broker.c_req_timeouts", relaxed=True)
    # KIP-227 fetch session + per-API fetch wire counters:
    # mutated on the serve thread (request build / response handling),
    # snapshot-read by the stats emitter like the counters above
    _fetch_session = shared("broker.fetch_session", relaxed=True)
    c_fetch_tx_bytes = shared("broker.c_fetch_tx_bytes", relaxed=True)
    c_fetch_rx_bytes = shared("broker.c_fetch_rx_bytes", relaxed=True)
    # serve-pass accounting: counted on the serve thread, snapshot-read
    # by the stats emitter like the counters above
    c_wakeups = shared("broker.c_wakeups", relaxed=True)
    c_idle_wakeups = shared("broker.c_idle_wakeups", relaxed=True)
    c_idle_waits = shared("broker.c_idle_waits", relaxed=True)
    # the serve pass in progress (reset by each pass): what it did, what
    # ended its wait, and while tracing its CPU tally
    _pass_work = 0
    _pass_woke = "none"
    _tally: Optional[_CpuTally] = None

    def __init__(self, rk: "Kafka", nodeid: int, host: str, port: int,
                 name: str = ""):
        self.rk = rk
        self.nodeid = nodeid
        self.host = host
        self.port = port
        self.name = name or f"{host}:{port}/{nodeid}"
        self.state = BrokerState.INIT
        self.ops = OpQueue(f"broker-{self.name}-ops")
        self.sock: Optional[socket.socket] = None
        self.outq: deque[Request] = deque()
        self.waitresp: dict[int, Request] = {}
        self.retryq: list[tuple[float, Request]] = []
        self._corrid = 0
        self._rbuf = bytearray()
        # segment-queue write buffer: request segments drain via
        # sendmsg iovecs without being flattened (sockbuf.SegWriter)
        self._wbuf = sockbuf.SegWriter()
        # built-but-untransmitted request accounting for
        # queue.buffering.backpressure.threshold (reference: rkb_outbufs
        # count, rdkafka_broker.c:3262). The deque holds each queued
        # request's end position in the writer's monotonic queued-bytes
        # space.
        self._unsent_req_ends: deque[int] = deque()
        self._wakeup_r, self._wakeup_w = socket.socketpair()
        self._wakeup_r.setblocking(False)
        # non-blocking: a full pipe must drop the wakeup byte (reader is
        # already pending), never block the op-pushing thread
        self._wakeup_w.setblocking(False)
        self.ops.set_wakeup_cb(self._wakeup)
        self.api_versions: dict[int, int] = {}
        # None = not yet negotiated (vs set() = negotiated, no
        # features — a 0.8.x broker); the writer must not assume v2
        # before negotiation resolves (reference: rkb_features set by
        # rd_kafka_broker_features_set after ApiVersions/fallback)
        self.features: set[str] | None = None
        self._apiversion_failed = False   # broker closed on ApiVersions
        self._fallback_until = 0.0        # api.version.fallback.ms window
        self.reconnect_backoff = rk.conf.get("reconnect.backoff.ms") / 1000.0
        self._next_connect = 0.0
        # (monotonic, applied_delay_s) per backoff decision, newest
        # last — observability for the chaos retry-shape tests
        self.reconnect_history: deque = deque(maxlen=64)
        self._connect_wanted = False    # sparse-connections override
        self.terminate = False
        self.fetch_inflight_cnt = 0     # outstanding FetchRequests
        # fetch responses' partitions awaiting decompress+parse under
        # the decompressed-ahead budget (see _serve_deferred_fetch)
        self._fetch_deferred: deque = deque()
        # partitions whose codec phases (CRC verify / decompress) are in
        # flight as offload tickets (_PendingFetch FIFO; claims held
        # until phase D resolves — see _reap_fetch_pending)
        self._fetch_pending: deque = deque()
        self._tls_handshaking = False
        self._codec_outstanding = 0     # async codec jobs in flight
        self._last_throttle = 0         # throttle_cb change detection
        self.toppars: set = set()           # toppars led by this broker
        self.ts_connected = 0.0
        self.ts_state = time.monotonic()    # last state CHANGE (stats)
        # stats
        self.c_tx = self.c_rx = self.c_tx_bytes = self.c_rx_bytes = 0
        self.c_connects = 0             # connection attempts (stats)
        self.c_req_timeouts = 0
        # Fetch-API wire bytes (both directions), split out from the
        # totals so the bench can prove the incremental-session savings
        # (stats: brokers[].fetch_session + top-level wire_fetch_bytes)
        self.c_fetch_tx_bytes = 0
        self.c_fetch_rx_bytes = 0
        # serve passes (upstream's `wakeups`), the passes that did
        # nothing, the passes that blocked for IDLE_WAIT_S, what ended
        # each pass's wait, and the ops served by kind (CPU_ACCOUNTING.md)
        self.c_wakeups = self.c_idle_wakeups = self.c_idle_waits = 0
        self.c_woke = dict.fromkeys(PASS_WOKE, 0)
        self.c_ops = dict.fromkeys(PASS_OPS, 0)
        # bytes of fetched v2 batches whose CRC32C the card (crc_rows) or
        # the host checked (CPU_ACCOUNTING.md)
        self.c_fetch_crc_bytes_device = self.c_fetch_crc_bytes_host = 0
        # KIP-227 incremental fetch session with this broker
        # (client/fetch_session.py); torn down on disconnect
        from .fetch_session import FetchSession
        self._fetch_session = FetchSession()
        # consecutive request timeouts since the last good response;
        # socket.max.fails of these mark the connection broken
        # (reference: rkb_req_timeouts, rdkafka_broker.c timeout scan)
        self._req_timeouts_pending = 0
        # latency decomposition (reference: rkb_avg_rtt/outbuf_latency/
        # throttle, rdkafka_broker.h; emitted rdkafka.c:1582-1630)
        from .stats import Avg
        self.rtt_avg = Avg()            # request sent -> response (µs)
        self.outbuf_avg = Avg()         # enqueue -> wire write (µs)
        self.throttle_avg = Avg(1, 5 * 60 * 1000, 3)  # broker throttle (ms)
        # consumer fetch-pipeline window: codec-ticket submit
        # (_begin_fetch_partition) -> reap (_reap_fetch_pending), the
        # per-broker mirror of the producer's codec_latency
        self.fetch_latency_avg = Avg()
        self.thread = threading.Thread(target=self._thread_main,
                                       name=f"rdk:broker/{self.name}",
                                       daemon=True)

    def start(self):
        self.thread.start()

    # ------------------------------------------------------------ wakeup --
    def _wakeup(self):
        try:
            self._wakeup_w.send(b"x")
        except (BlockingIOError, OSError):
            pass

    # -------------------------------------------------------- public API --
    def enqueue_request(self, req: Request) -> None:
        """Thread-safe: queue a request for transmission (any thread)."""
        req.ts_enq = time.monotonic()
        self.ops.push(Op(OpType.BROKER_WAKEUP, payload=("xmit", req)))

    def add_toppar(self, toppar) -> None:
        self.ops.push(Op(OpType.PARTITION_JOIN, payload=toppar))

    def remove_toppar(self, toppar) -> None:
        self.ops.push(Op(OpType.PARTITION_LEAVE, payload=toppar))

    def stop(self):
        self.ops.push(Op(OpType.TERMINATE))

    def is_up(self) -> bool:
        return self.state == BrokerState.UP

    def _has_work(self) -> bool:
        """Anything that needs a live connection (sparse-connections
        gate): led/fetched toppars, queued or in-flight requests, or an
        explicit connection request from a component that needs this
        specific broker up (admin controller/coordinator targeting)."""
        return bool(self.toppars or self.outq or self.waitresp
                    or self.retryq or self._connect_wanted)

    def _nothing_to_serve(self) -> bool:
        """An UP broker with no work and nothing else a timer must serve:
        no unsent bytes, no codec results or fetched partitions to come
        back, no TERMINATE served earlier in this pass (a TLS handshake
        never reaches the wait: its state is not UP).  Every path that
        gives a broker work pushes an op, and each push writes the
        wakeup pipe, so such a broker may block until woken."""
        return (self.state == BrokerState.UP and not self._has_work()
                and not (self._wbuf.pending() or self._codec_outstanding
                         or self._fetch_deferred or self._fetch_pending
                         or self.terminate))

    def schedule_connect(self) -> None:
        """On-demand connection under sparse connections (reference:
        rd_kafka_broker_schedule_connection, rdkafka_broker.c:880):
        called by waiters that need THIS broker UP before they can
        enqueue a request (admin worker, cgrp coordinator)."""
        if not self._connect_wanted:
            self._connect_wanted = True
            self._wakeup()

    # --------------------------------------------------------- the thread --
    def _pass_counts(self) -> dict:
        return {"passes": self.c_wakeups, "idle_passes": self.c_idle_wakeups,
                "idle_waits": self.c_idle_waits,
                "woke": dict(self.c_woke), "ops": dict(self.c_ops)}

    def _thread_main(self):
        if self.rk.interceptors:
            self.rk.interceptors.on_thread_start("broker", self.name)
        while not self.terminate:
            tally = self._tally
            if _trace.enabled:
                if tally is None:
                    tally = self._tally = _CpuTally(
                        "broker", "pass_tally", "ops", self._pass_counts())
            elif tally is not None:
                tally = self._tally = None
            self._pass_work = 0
            self._pass_woke = "none"
            try:
                self._serve()
            except Exception as e:  # keep the broker thread alive
                self._pass_work += 1
                self.rk.log("ERROR", f"broker {self.name} serve error: {e!r}")
                self._disconnect(KafkaError(Err._FAIL, repr(e)))
                # error backoff, not a wait-for-state: nothing signals
                # "the fault cleared", so there is no condvar to wait on
                time.sleep(0.05)  # lint: ok sleep-poll
            self.c_wakeups += 1
            if not self._pass_work:
                self.c_idle_wakeups += 1
            self.c_woke[self._pass_woke] += 1
            if tally is not None:
                tally.end_pass(not self._pass_work, self._pass_counts)
        if self._tally is not None:
            self._tally.emit(self._pass_counts())
            self._tally = None
        self._disconnect(KafkaError(Err._DESTROY, "terminating"))
        # release deferred partitions' in-flight claims so another
        # broker (or a later instance) can fetch them.  Guarded: close()
        # tears these structures down concurrently once the join times
        # out, and a release raced that way must not kill the exit path
        # ("deque mutated during iteration")
        try:
            for entry in list(self._fetch_deferred):
                entry[0].fetch_in_flight = False
            self._fetch_deferred.clear()
            for pend in list(self._fetch_pending):
                pend.entry[0].fetch_in_flight = False
            self._fetch_pending.clear()
        except Exception:
            pass
        if self.rk.interceptors:
            self.rk.interceptors.on_thread_exit("broker", self.name)

    def _serve(self):
        now = time.monotonic()
        # while tracing, the pass's CPU by phase (CPU_ACCOUNTING.md)
        tally = self._tally
        # deferred fetch partitions need no socket — drain them FIRST
        # so a DOWN/backing-off/sparse-idle broker still delivers what
        # it already received (their toppars hold fetch_in_flight until
        # processed, so leaving them parked would starve the partitions
        # on every broker)
        if self._fetch_deferred or self._fetch_pending:
            if tally is not None:
                tally.switch("fetch")
            self._serve_deferred_fetch()
            if tally is not None:
                tally.switch("ops")
        if self.state in (BrokerState.INIT, BrokerState.DOWN):
            # sparse connections (reference enable.sparse.connections,
            # hidden, default true; rdkafka_broker.c:880): a metadata-
            # discovered broker with nothing to do stays unconnected.
            # Bootstrap brokers (nodeid < 0) always connect — they are
            # the metadata path.
            if (self.nodeid >= 0 and not self._has_work()
                    and self.rk.conf.get("enable.sparse.connections")):
                self._serve_ops(0.05)
                if not self._has_work():
                    return
            if now >= self._next_connect:
                self._try_connect()
            else:
                self._serve_ops(min(0.05, self._next_connect - now))
                return
        self._serve_ops(0)
        if self._tls_handshaking:
            self._tls_handshake_serve()
            return
        if tally is not None:
            tally.switch("scan")
        self._serve_retries(now)
        if self.state == BrokerState.UP:
            if self.rk.is_producer:
                if tally is not None:
                    tally.switch("produce")
                self._producer_serve(now)
            if self.rk.is_consumer:
                if tally is not None:
                    tally.switch("fetch")
                self._consumer_serve(now)
        if tally is not None:
            tally.switch("wait")
        if self._nothing_to_serve():
            self.c_idle_waits += 1
            self._io_serve(IDLE_WAIT_S)
        else:
            self._io_serve(IO_WAIT_S)
        if tally is not None:
            tally.switch("scan")
        self._scan_timeouts(now)

    def _serve_ops(self, timeout: float):
        deadline = time.monotonic() + timeout
        while True:
            op = self.ops.pop(0)
            if op is None:
                if timeout > 0 and time.monotonic() < deadline:
                    op = self.ops.pop(deadline - time.monotonic())
                    if op is None:
                        self._pass_woke = "timeout"
                        return
                    self._pass_woke = "pipe"
                else:
                    return
            self._op_serve(op)
            timeout = 0

    def _op_serve(self, op: Op):
        """(reference: rd_kafka_broker_op_serve, rdkafka_broker.c:2597)"""
        self._pass_work += 1
        if op.type == OpType.BROKER_WAKEUP:
            self.c_ops[op.payload[0] if op.payload else "wakeup"] += 1
        else:
            self.c_ops["other"] += 1
        if op.type == OpType.TERMINATE:
            self.terminate = True
        elif op.type == OpType.PURGE:
            # abandon in-flight ProduceRequests (rd_kafka_purge
            # RD_KAFKA_PURGE_F_INFLIGHT): fail them locally; the late
            # response hits an unknown corrid and is dropped
            for corrid, req in list(self.waitresp.items()):
                if req.api == ApiKey.Produce:
                    del self.waitresp[corrid]
                    if req.cb:
                        req.cb(KafkaError(Err._PURGE_INFLIGHT,
                                          "purged in flight",
                                          retriable=False), None)
        elif op.type == OpType.PARTITION_JOIN:
            self.toppars.add(op.payload)
        elif op.type == OpType.PARTITION_LEAVE:
            self.toppars.discard(op.payload)
        elif (op.type == OpType.BROKER_WAKEUP and op.payload
                and op.payload[0] == "codec_done"):
            _, results, ts_codec, pepoch = op.payload
            self._codec_outstanding -= 1
            self._codec_results(results, ts_codec, pepoch)
        elif op.type == OpType.BROKER_WAKEUP and op.payload:
            kind, req = op.payload
            if kind == "xmit":
                if self.state == BrokerState.UP:
                    self._xmit(req)
                else:
                    # park until UP; fail fast if down too long
                    self.outq.append(req)

    # ------------------------------------------------------ connect logic --
    def _try_connect(self):
        # one-shot demand satisfied by this attempt; a still-waiting
        # component re-schedules on its next resolve pass
        self._connect_wanted = False
        self._set_state(BrokerState.TRY_CONNECT)
        self.c_connects += 1
        if _lockdep.enabled:
            _lockdep.note_blocking("broker.connect")
        try:
            self.sock = self.rk.connect_cb(self.host, self.port,
                                           self.rk.conf.get(
                                               "socket.timeout.ms") / 1000.0)
            self.sock.setblocking(False)
            if self.rk.conf.get("socket.nagle.disable"):
                try:
                    self.sock.setsockopt(socket.IPPROTO_TCP,
                                         socket.TCP_NODELAY, 1)
                except OSError:
                    pass    # not TCP (e.g. a sockem AF_UNIX pair)
        except OSError as e:
            self.sock = None
            self._connect_failed(f"connect failed: {e}")
            return
        except KafkaException as e:
            self.sock = None
            self._connect_failed(e.error.reason)
            return
        self.ts_connected = time.monotonic()
        # TLS: wrap the socket and drive the non-blocking handshake from
        # the serve loop (reference: rdkafka_transport.c:612-719 drives
        # rd_kafka_transport_ssl_handshake from CONNECT state)
        ctx = self.rk.ssl_ctx()
        if ctx is not None:
            try:
                self.sock = ctx.wrap_socket(self.sock, server_hostname=self.host,
                                            do_handshake_on_connect=False)
            except (OSError, ValueError) as e:
                self._disconnect(KafkaError(Err._SSL, f"TLS wrap: {e}"))
                return
            self._tls_handshaking = True
            self._set_state(BrokerState.CONNECT)
            return
        self._connected()

    def _tls_handshake_serve(self):
        """Advance the TLS handshake; non-blocking with a short select
        so the broker thread keeps serving ops during slow handshakes.
        Bounded by socket.timeout.ms like every other setup stage."""
        if (time.monotonic() - self.ts_connected >
                self.rk.conf.get("socket.timeout.ms") / 1000.0):
            self._disconnect(KafkaError(Err._SSL, "TLS handshake timed out"))
            return
        try:
            self.sock.do_handshake()
        except _ssl.SSLWantReadError:
            r, _, _ = select.select([self.sock], [], [], 0.05)
            self._pass_woke = "read" if r else "timeout"
            return
        except _ssl.SSLWantWriteError:
            _, w, _ = select.select([], [self.sock], [], 0.05)
            self._pass_woke = "write" if w else "timeout"
            return
        except (OSError, _ssl.SSLError) as e:
            self._disconnect(KafkaError(Err._SSL, f"TLS handshake: {e}"))
            return
        self._tls_handshaking = False
        cert = None
        try:
            cert = self.sock.getpeercert()
        except (ValueError, OSError):
            pass
        # ssl.certificate.verify_cb: app veto over the peer certificate
        # (reference rd_kafka_conf_set_ssl_cert_verify_cb; called after
        # OpenSSL's own verification with its result — returning False
        # rejects the connection as an SSL failure)
        vcb = self.rk.conf.get("ssl.certificate.verify_cb")
        if vcb is not None:
            try:
                der = self.sock.getpeercert(binary_form=True)
            except (ValueError, OSError):
                der = None
            try:
                # openssl_ok: whether OpenSSL actually VERIFIED the
                # chain — getpeercert() returns {} (truthy-empty) for a
                # presented-but-unverified cert under CERT_NONE
                ok = vcb(self.name, self.nodeid, 0, der, bool(cert))
            except Exception as e:
                ok = False
                self.rk.log("ERROR",
                            f"{self.name}: verify_cb raised: {e!r}")
            if not ok:
                self._disconnect(KafkaError(
                    Err._SSL,
                    "broker certificate rejected by "
                    "ssl.certificate.verify_cb"))
                return
        self.rk.dbg("security",
                    f"{self.name}: TLS established "
                    f"({self.sock.version()}, peer={'verified' if cert else 'unverified'})")
        self._connected()

    def _connected(self):
        self._set_state(BrokerState.APIVERSION_QUERY)
        # ApiVersions negotiation (reference: rdkafka_request.c:1809).
        # Pre-0.10 brokers close the connection on unknown requests; the
        # reference retries the connect WITHOUT ApiVersions and applies
        # broker.version.fallback (rdkafka_feature.c legacy versions)
        if (self.rk.conf.get("api.version.request")
                and not self._apiversion_failed
                and time.monotonic() >= self._fallback_until):
            self._xmit(Request(
                ApiKey.ApiVersions, {},
                abs_timeout=time.monotonic() + self.rk.conf.get(
                    "api.version.request.timeout.ms") / 1000.0,
                cb=self._handle_apiversions))
        else:
            self._apply_version_fallback()
            self._broker_up()

    def _apply_version_fallback(self):
        fb = self.rk.conf.get("broker.version.fallback")
        self.api_versions = fallback_api_versions(fb)
        self.features = features_from_api_versions(self.api_versions)
        # one-shot: the NEXT reconnect (after api.version.fallback.ms)
        # probes ApiVersions again, so a transient blip can't pin a
        # modern broker to legacy mode forever
        if self._apiversion_failed:
            self._fallback_until = time.monotonic() + \
                self.rk.conf.get("api.version.fallback.ms") / 1000.0
        self._apiversion_failed = False
        self.rk.dbg("feature",
                    f"{self.name}: assuming broker {fb}: "
                    f"features {sorted(self.features)}")

    def _handle_apiversions(self, err, resp):
        if err is not None and err.code in (Err._TRANSPORT, Err._TIMED_OUT):
            # broker closed/ignored the request — a pre-0.10 broker.
            # Reconnect once without ApiVersions (reference behavior)
            self._apiversion_failed = True
            if err.code == Err._TIMED_OUT:
                # a timeout does not tear the connection down by itself
                self._disconnect(KafkaError(
                    Err._TRANSPORT, "ApiVersions timed out"))
            return      # the disconnect path triggers the reconnect
        if err or resp["error_code"] != 0:
            self._apply_version_fallback()
        else:
            self.api_versions = {v["api_key"]: v["max_version"]
                                 for v in resp["api_versions"]}
            self.features = features_from_api_versions(self.api_versions)
            self.rk.dbg("feature",
                        f"{self.name}: features {sorted(self.features)}")
        if self.rk.sasl_required():
            self._set_state(BrokerState.AUTH_HANDSHAKE)
            self.rk.sasl_start(self)
        else:
            self._broker_up()

    def sasl_done(self, err: Optional[KafkaError]):
        if err:
            self.rk.op_err(err)
            self._disconnect(err)
        else:
            self._broker_up()

    def _broker_up(self):
        self._set_state(BrokerState.UP)
        self.reconnect_backoff = self.rk.conf.get("reconnect.backoff.ms") / 1000.0
        # flush parked requests
        parked, self.outq = self.outq, deque()
        for req in parked:
            self._xmit(req)
        self.rk.broker_state_change(self)

    def _update_reconnect_backoff(self) -> float:
        """Schedule the next connect attempt: -25%..+50% jitter on the
        current backoff, capped at reconnect.backoff.max.ms, base
        doubled for the next round — the reference's exact scheme
        (rd_kafka_broker_update_reconnect_backoff, rdkafka_broker.c:
        1708; reconnect.backoff.jitter.ms is a deprecated no-op there
        too).  Returns the applied delay; every (when, delay) lands in
        ``reconnect_history`` so the chaos kill9 retry-shape test can
        assert the schedule was honored against a real dead process."""
        backoff_max = self.rk.conf.get("reconnect.backoff.max.ms") / 1000.0
        backoff = min(self.reconnect_backoff * random.uniform(0.75, 1.5),
                      backoff_max)
        self._next_connect = time.monotonic() + backoff
        self.reconnect_backoff = min(self.reconnect_backoff * 2,
                                     backoff_max)
        self.reconnect_history.append((time.monotonic(), backoff))
        return backoff

    def _connect_failed(self, reason: str):
        self._set_state(BrokerState.DOWN)
        self._update_reconnect_backoff()
        self.rk.broker_down(self, KafkaError(Err._TRANSPORT, reason))

    def _disconnect(self, err: KafkaError, quiet: bool = False):
        # consecutive-timeout accounting is per-connection (reference
        # resets rkb_req_timeouts in rd_kafka_broker_fail)
        self._req_timeouts_pending = 0
        if quiet:
            # log.connection.close=false: idle disconnects are expected
            # (broker idle reaper); reconnect with a debug line only
            self.rk.dbg("broker", f"{self.name}: {err.reason} (quiet)")
        elif self.sock is not None and not self.terminate:
            self.rk.log("INFO", f"{self.name}: disconnected: {err.reason}")
        if self.sock:
            # closesocket_cb: app-supplied close hook, paired with
            # connect_cb/socket_cb (reference closesocket_cb,
            # rdkafka_conf.c:520)
            ccb = self.rk.conf.get("closesocket_cb")
            try:
                if ccb:
                    ccb(self.sock)
                self.sock.close()
            except Exception as e:
                # an app close-hook that raises must not abort teardown
                # midway (socket leak + in-flight requests never failed)
                if not isinstance(e, OSError):
                    self.rk.log("ERROR",
                                f"{self.name}: closesocket_cb raised: {e!r}")
            self.sock = None
        self._rbuf.clear()
        self._wbuf.clear()
        self._unsent_req_ends.clear()
        self.fetch_inflight_cnt = 0
        # the broker's session cache entry died with the connection (or
        # will be evicted); renegotiate from epoch 0 after reconnect
        self._fetch_session.reset("disconnect")
        self._tls_handshaking = False
        # fail all in-flight + queued requests (callers decide on retry);
        # waitresp is emptied first: a callback may disconnect again
        # (a SASL step's failure does) and must find nothing left to fail
        waiting = list(self.waitresp.values())
        self.waitresp.clear()
        for req in waiting:
            self._req_fail(req, err)
        outq, self.outq = self.outq, deque()
        for req in outq:
            self._req_fail(req, err)
        if self.state != BrokerState.DOWN and not self.terminate:
            self._connect_failed(err.reason)

    def _set_state(self, st: BrokerState):
        if self.state != st:
            self.rk.dbg("broker", f"{self.name}: {self.state.value} -> {st.value}")
            self.state = st
            self.ts_state = time.monotonic()   # stats: time in state

    # ------------------------------------------------------------ xmit/IO --
    def _next_corrid(self) -> int:
        self._corrid += 1
        return self._corrid

    def _xmit(self, req: Request):
        if self.state != BrokerState.UP and req.api not in (
                ApiKey.ApiVersions, ApiKey.SaslHandshake,
                ApiKey.SaslAuthenticate):
            self.outq.append(req)
            return
        req.corrid = self._next_corrid()
        ver = req.version
        if ver is None:
            our = APIS[req.api][0]
            ver = min(our, self.api_versions.get(int(req.api), our))
        req.version = ver          # response parses with the same schema
        wire = apis.build_request_buf(req.api, req.corrid,
                                      self.rk.conf.get("client.id"),
                                      req.body, version=ver)
        wire_len = len(wire)
        self._wbuf.append(wire.iovecs())
        self._unsent_req_ends.append(self._wbuf.queued_total)
        self.c_tx += 1
        self.c_tx_bytes += wire_len
        if req.api == ApiKey.Fetch:
            self.c_fetch_tx_bytes += wire_len
        req.ts_sent = time.monotonic()
        if req.ts_enq:
            self.outbuf_avg.add((req.ts_sent - req.ts_enq) * 1e6)
        if self.rk.interceptors:
            self.rk.interceptors.on_request_sent(
                self.nodeid, int(req.api), req.corrid, wire_len)
        if req.expect_response:
            self.waitresp[req.corrid] = req
            if not req.abs_timeout:
                req.abs_timeout = time.monotonic() + \
                    self.rk.conf.get("socket.timeout.ms") / 1000.0
        tally = self._tally
        if tally is None:
            self._flush_wbuf()
        else:
            prev = tally.switch("send")
            self._flush_wbuf()
            tally.switch(prev)

    def _flush_wbuf(self):
        # scatter-gather drain: request segments (incl. spliced
        # RecordBatch bytes) go to sendmsg in place — no flat-buffer
        # copy, no consumed-prefix memmove
        if not self.sock or not self._wbuf.pending():
            return
        n, _blocked, err = self._wbuf.send(self.sock)
        if n:
            self._pass_work += 1
        if err is not None:
            self._disconnect(KafkaError(Err._TRANSPORT,
                                        f"send failed: {err}"))
            return
        while (self._unsent_req_ends
               and self._unsent_req_ends[0] <= self._wbuf.sent_total):
            self._unsent_req_ends.popleft()

    def _io_serve(self, timeout: float):
        """select() over socket + wakeup pipe
        (reference: rd_kafka_transport_io_serve, rdkafka_transport.c:795)."""
        rlist = [self._wakeup_r]
        wlist = []
        tally = self._tally
        if self.sock:
            # decrypted TLS bytes may already be buffered in the SSL
            # layer where select() cannot see them
            if isinstance(self.sock, _ssl.SSLSocket) and self.sock.pending():
                if tally is not None:
                    tally.switch("recv")
                self._recv()
                if tally is not None:
                    tally.switch("wait")
                timeout = 0
            if self.sock is None:    # _recv may have disconnected
                return
            rlist.append(self.sock)
            if self._wbuf.pending():
                wlist.append(self.sock)
        if _lockdep.enabled:
            _lockdep.note_blocking("broker.select")
        try:
            r, w, _ = select.select(rlist, wlist, [], timeout)
        except (OSError, ValueError):
            return
        # what ended the wait: the first ready of read, write, the pipe
        self._pass_woke = ("read" if self.sock in r else "write" if w
                           else "pipe" if r
                           else "timeout" if timeout > 0 else "none")
        if self._wakeup_r in r:
            try:
                while self._wakeup_r.recv(4096):
                    pass
            except (BlockingIOError, OSError):
                pass
        if self.sock in w:
            if tally is not None:
                tally.switch("send")
            self._flush_wbuf()
        if self.sock and self.sock in r:
            if tally is not None:
                tally.switch("recv")
            self._recv()

    def _recv(self):
        # Loop until the socket would block: a TLS record may decrypt to
        # more bytes than one recv() surfaces, and SSLSocket buffers
        # decrypted data invisible to select() (hence the pending() check
        # in _io_serve).
        got = 0
        while True:
            try:
                data = self.sock.recv(1 << 20)
            except (_ssl.SSLWantReadError, _ssl.SSLWantWriteError,
                    BlockingIOError, InterruptedError):
                break
            except OSError as e:
                self._disconnect(KafkaError(Err._TRANSPORT,
                                            f"recv failed: {e}"))
                return
            if not data:
                quiet = not self.rk.conf.get("log.connection.close")
                self._disconnect(KafkaError(
                    Err._TRANSPORT, "connection closed by peer",
                    retriable=True), quiet=quiet)
                return
            self._rbuf += data
            got += len(data)
            # SSLSocket.recv returns one decrypted record (~16KB) per
            # call, so only a would-block exception ends the loop; cap
            # the drain so a firehose peer can't starve the serve loop
            if got >= (8 << 20):
                break
        if not got:
            return
        self._pass_work += 1
        self.c_rx_bytes += got
        # offset-based frame walk: ONE buffer compaction per recv burst
        # instead of a memmove per response
        frames, bad = sockbuf.extract_frames(
            self._rbuf, self.rk.conf.get("receive.message.max.bytes"))
        for payload in frames:
            self._handle_response(payload)
            if self.sock is None:           # handler disconnected us
                return
        if bad is not None:
            self._disconnect(KafkaError(Err._BAD_MSG,
                                        f"invalid frame size {bad}"))

    def _handle_response(self, payload: bytes):
        (corrid,) = struct.unpack(">i", payload[:4])
        req = self.waitresp.pop(corrid, None)
        if req is None:
            self.rk.dbg("broker", f"{self.name}: unknown corrid {corrid}")
            return
        self.c_rx += 1
        self._req_timeouts_pending = 0  # connection is alive
        if req.ts_sent:
            self.rtt_avg.add((time.monotonic() - req.ts_sent) * 1e6)
        if req.api == ApiKey.Fetch:
            # + frame length prefix: count what crossed the wire
            self.c_fetch_rx_bytes += len(payload) + 4
            tally = self._tally
            if tally is not None:
                # the fetch response's parse, CRC tickets, decompress
                # and delivery: the consumer's, not the ack path's
                prev = tally.switch("fetch_recv")
                try:
                    self._answer(req, payload)
                finally:
                    tally.switch(prev)
                return
        self._answer(req, payload)

    def _answer(self, req: Request, payload: bytes):
        """Parse a response and hand it to its request's callback."""
        try:
            _, body = apis.parse_response(req.api, payload,
                                          version=req.version)
        except Exception as e:
            self._req_fail(req, KafkaError(Err._BAD_MSG,
                                           f"response parse: {e!r}"))
            return
        tt = body.get("throttle_time_ms") if isinstance(body, dict) else None
        if tt:
            self.throttle_avg.add(tt)
        # throttle event on changes (reference rd_kafka_op_throttle —
        # fires when the broker starts/changes/stops throttling). Only
        # responses that CARRY a throttle field count: tt is None for
        # schemas without one (Metadata v2, ApiVersions, ...) and must
        # not read as "throttling stopped"
        if tt is not None and tt != self._last_throttle:
            self._last_throttle = tt
            # unconditional like ERR/STATS: the event-API path consumes
            # THROTTLE ops without a throttle_cb configured
            self.rk.rep.push(Op(OpType.THROTTLE,
                                payload=(self.name, self.nodeid, tt)))
        if req.cb:
            req.cb(None, body)

    def _req_fail(self, req: Request, err: KafkaError):
        # the absolute timeout budget spans retries (reference keeps one
        # deadline per request); an exhausted budget means no retry
        budget_left = (not req.abs_timeout
                       or time.monotonic() < req.abs_timeout)
        if err.retriable and req.retries_left > 0 and budget_left:
            req.retries_left -= 1
            backoff = self.rk.conf.get("retry.backoff.ms") / 1000.0
            self.retryq.append((time.monotonic() + backoff, req))
            return
        if req.cb:
            req.cb(err, None)

    def _serve_retries(self, now: float):
        if not self.retryq:
            return
        due = [r for t, r in self.retryq if t <= now]
        self.retryq = [(t, r) for t, r in self.retryq if t > now]
        self._pass_work += len(due)
        for req in due:
            self._xmit(req)

    def _scan_timeouts(self, now: float):
        timed_out = [c for c, r in self.waitresp.items()
                     if r.abs_timeout and now > r.abs_timeout]
        self._pass_work += len(timed_out)
        for c in timed_out:
            req = self.waitresp.pop(c)
            self.c_req_timeouts += 1
            self._req_timeouts_pending += 1
            if _trace.enabled:
                # flight-recorder trigger: the trace explaining WHY the
                # request stalled is exactly what times out with it
                _trace.instant("broker", "request_timeout",
                               {"broker": self.name, "api": req.api.name,
                                "corrid": req.corrid})
                _trace.flight_record(f"request_timeout_{req.api.name}")
            self._req_fail(req, KafkaError(Err._TIMED_OUT,
                                           f"{req.api.name} timed out"))
        # socket.max.fails consecutive timeouts with no response in
        # between: the connection is dead — force a reconnect cycle
        # (reference: rd_kafka_broker_timeout_scan's rkb_req_timeouts
        # accounting; 0 disables)
        max_fails = self.rk.conf.get("socket.max.fails")
        if max_fails and self._req_timeouts_pending >= max_fails:
            consec = self._req_timeouts_pending
            self._disconnect(KafkaError(
                Err._TIMED_OUT,
                f"{consec} consecutive request(s) timed out: "
                f"disconnect (socket.max.fails={max_fails})"))

    # =================================================== PRODUCER SERVE ===
    def _producer_serve(self, now: float):
        """The hot loop (reference rdkafka_broker.c:3242), restructured for
        batched codec offload: gather all ready batches across toppars,
        compress them in one provider call, then send."""
        rk = self.rk
        linger = rk.conf.get("queue.buffering.max.ms") / 1000.0
        batch_max = rk.conf.get("batch.num.messages")
        codec = rk.conf.get("compression.codec")
        # pre-0.11 broker: magic 0/1 path — skip V2 writer construction
        legacy = self.features is not None and MSGVER2 not in self.features
        # codec pipeline backpressure: at most `depth` launches in
        # flight; messages keep accumulating in xmit_msgq meanwhile
        if (rk.codec_worker is not None
                and self._codec_outstanding >= rk.codec_pipeline_depth):
            return
        # queue.buffering.backpressure.threshold: with this many built-
        # but-untransmitted requests still sitting in the socket write
        # buffer, hold off forming new MessageSets — messages keep
        # accumulating into bigger batches instead (reference:
        # rd_kafka_toppar_producer_serve's outbuf backpressure,
        # rdkafka_broker.c:3262)
        if len(self._unsent_req_ends) >= rk.conf.get(
                "queue.buffering.backpressure.threshold"):
            return
        t_assembly = _trace.now() if _trace.enabled else 0
        ready: list[tuple] = []   # (toppar, msgs, writer|None-when-legacy)

        # one locked flush-flag snapshot per serve pass (the --races
        # sweep flagged the per-toppar lock-free reads against flush()'s
        # kafka.msg_cnt-guarded writes); a pass-stale value only delays
        # the linger override by one loop turn
        with rk._msg_cnt_lock:
            flush_forced = rk.flushing

        # O(active), as the consumer's serve: metadata registers every
        # partition of every known topic in self.toppars (a 100,000-
        # partition topic made each pass walk them all), while a
        # produced-to partition is in the client's active index (the
        # wake of its first enqueue activates it)
        for tp in rk.active_toppars():
            if tp not in self.toppars or tp.leader_id != self.nodeid:
                continue
            tp.xmit_move()
            # idempotence / backpressure gates
            max_inflight = (IDEMP_MAX_INFLIGHT if rk.idemp else
                            rk.conf.get("max.in.flight.requests.per.connection"))
            if rk.idemp and not rk.idemp.can_produce():
                continue
            # transactional gate: a partition's batches may only leave
            # once it is registered with the txn coordinator
            # (AddPartitionsToTxn; partition_ready queues unregistered
            # ones for the main-thread serve pass — this loop never
            # blocks on a coordinator round trip). Only toppars with
            # actual work register: an idle partition must never draw a
            # txn marker just for being led here.
            if (rk.txnmgr is not None
                    and (tp.retry_batches or tp.xmit_msgq
                         or (tp.arena is not None and len(tp.arena)))
                    and not rk.txnmgr.partition_ready(tp)):
                continue
            # frozen retry batches resend first, membership intact, and
            # block new batch formation until drained (ordering); popped
            # batches are accounted in-flight IMMEDIATELY so the DRAIN
            # rebase on the main thread never runs past messages held in
            # this serve pass's `ready` list
            if now >= tp.retry_backoff_until:
                while tp.inflight < max_inflight:
                    with tp.lock:
                        # emptiness re-checked under the lock: purge()
                        # clears retry_batches from the app thread
                        if not tp.retry_batches:
                            break
                        msgs = tp.retry_batches.popleft()
                        if not isinstance(msgs, ArenaBatch):
                            msgs = list(msgs)
                        tp.inflight_msgids.add(batch_head_msgid(msgs))
                        tp.inflight += 1
                    ready.append((tp, msgs,
                                  None if legacy else
                                  self._make_writer(tp, msgs, self._codec_for(tp, codec))))
            if tp.retry_batches or tp.inflight >= max_inflight:
                continue
            # ---- native enqueue fast lane: form an ArenaBatch ----------
            if tp.arena is not None and len(tp.arena):
                if not tp.arena_ok:
                    # records appended concurrently with a demotion:
                    # convert them so the Message path below carries them
                    rk._demote(tp, "race")
                    tp.xmit_move()
                elif not tp.xmit_msgq:
                    if now < tp.retry_backoff_until:
                        continue
                    first_us = tp.arena.first_enq_us()
                    # full by count OR by bytes: one message.max.bytes
                    # worth is a complete wire batch — lingering past it
                    # buys nothing (reference size gate in
                    # rd_kafka_toppar_producer_serve, rdkafka_broker.c:3453)
                    full = (len(tp.arena) >= batch_max
                            or tp.arena.nbytes()
                            >= rk.conf.get("message.max.bytes"))
                    lingered = (first_us >= 0
                                and now - first_us / 1e6 >= linger)
                    if not (full or lingered or flush_forced):
                        continue
                    t0 = _trace.now() if _trace.enabled else 0
                    with tp.lock:
                        run = tp.arena.take(
                            batch_max, rk.conf.get("message.max.bytes"))
                        if run is None:
                            continue
                        b = ArenaBatch(*run)
                        # batch msgid assignment: takes are FIFO and
                        # exclusive under tp.lock, so sequence numbering
                        # is identical to per-enqueue assignment
                        b.msgid_base = tp.next_msgid
                        tp.next_msgid += b.count
                        tp.inflight_msgids.add(b.msgid_base)
                        tp.inflight += 1
                    if t0:
                        # per-stage attribution: broker-thread run take
                        # (arena → ArenaBatch descriptor, under tp.lock)
                        _trace.complete("produce", "run_take", t0,
                                        {"topic": tp.topic,
                                         "partition": tp.partition,
                                         "msgs": b.count,
                                         "batch": b.msgid_base})
                    ready.append((tp, b,
                                  None if legacy else
                                  self._make_writer(tp, b, self._codec_for(tp, codec))))
                    continue
            if not tp.xmit_msgq or now < tp.retry_backoff_until:
                continue
            # linger gate (rdkafka_broker.c:3453-3470)
            try:
                oldest = tp.xmit_msgq[0]
            except IndexError:      # raced with the msg-timeout scan
                continue
            full = len(tp.xmit_msgq) >= batch_max
            lingered = (now - oldest.enq_time) >= linger
            if not (full or lingered or flush_forced):
                continue
            size_max = rk.conf.get("message.max.bytes")
            q = tp.xmit_msgq
            msgs = []
            sz = 0
            # under tp.lock: the main thread's msg-timeout scan pops
            # expired messages from this same deque
            with tp.lock:
                n_take = min(len(q), batch_max)
                for _ in range(n_take):
                    m = q[0]
                    if msgs and sz + m.size > size_max:
                        break
                    q.popleft()
                    msgs.append(m)
                    sz += m.size
                # pop + in-flight claim are ONE critical section: the
                # DRAIN rebase observes inflight and the queues under
                # this same lock, so a popped batch is never invisible
                # to both
                if msgs:
                    tp.inflight_msgids.add(msgs[0].msgid)
                    tp.inflight += 1
            if not msgs:
                continue
            ready.append((tp, msgs,
                          None if legacy else
                          self._make_writer(tp, msgs, self._codec_for(tp, codec))))

        if not ready:
            return
        self._pass_work += 1
        if t_assembly:
            # spans only when batches actually formed: the idle serve
            # pass must not flood the ring
            _trace.complete("produce", "batch_assembly", t_assembly,
                            {"batches": len(ready)})

        # int_latency: produce() -> MessageSet write (reference rkb_avg
        # int_latency fed per message at rdkafka_msgset_writer.c; here the
        # batch's oldest+newest bound the window at 2 adds/batch instead
        # of N)
        for tp, msgs, _w in ready:
            if isinstance(msgs, ArenaBatch):
                self.rk.stats.int_latency.add((now - msgs.enq_first) * 1e6)
                if msgs.count > 1:
                    self.rk.stats.int_latency.add(
                        (now - msgs.enq_last) * 1e6)
            else:
                self.rk.stats.int_latency.add(
                    (now - msgs[0].enq_time) * 1e6)
                if len(msgs) > 1:
                    self.rk.stats.int_latency.add(
                        (now - msgs[-1].enq_time) * 1e6)
        ts_codec = time.monotonic()

        # legacy broker (no MSGVER2): magic 0/1 messagesets via the v01
        # writer, Produce <= v2 (reference MsgVersion selection,
        # rdkafka_msgset_writer.c:100 by feature set)
        if legacy:
            self._produce_legacy(ready, codec, now)
            return

        # ---- phase 2: ONE batched compress + ONE batched CRC call across
        # partitions (both ride the same provider/offload axis; reference
        # does each per batch on the broker thread,
        # rdkafka_msgset_writer.c:1129 + :1230).  Batches in `ready` are
        # already accounted in-flight; any failure from here on must
        # release the accounting and error-DR the batch or tp.inflight
        # leaks (flush() would hang, DRAIN never resolves)
        # With codec.pipeline.depth > 0 this phase runs on the client's
        # codec worker thread (SURVEY.md §5 parallelism axis 2: pipeline
        # overlap): the broker thread keeps serving socket IO and forms
        # the NEXT batch while this launch compresses; results come back
        # through the broker ops queue (FIFO — per-partition send order,
        # and with it idempotent sequence order, is preserved)
        worker = rk.codec_worker
        if worker is not None:
            self._codec_outstanding += 1
            worker.submit(self, ready, ts_codec, rk._purge_epoch)
            return
        self._codec_results(_begin_codec_phase(rk, ready).finish(),
                            ts_codec, rk._purge_epoch)

    def _codec_results(self, results: list, ts_codec: float,
                       purge_epoch: int):
        """Phase 3: finalize+send (or fail) each batch from the codec
        phase. Runs on the broker thread.

        Two invalidation gates: a purge(in_flight=True) issued while the
        batch was inside the pipeline discards it with _PURGE_INFLIGHT;
        a broker no longer UP (disconnected mid-launch) requeues the
        batch as a frozen retry batch so the message-timeout scan and
        reconnect logic own it — it must NOT be parked in outq where no
        timeout scan can reach it."""
        rk = self.rk
        now = time.monotonic()
        rk.stats.codec_latency.add((now - ts_codec) * 1e6)
        purged = purge_epoch != rk._purge_epoch
        for tp, msgs, wire, exc in results:
            if purged:
                tp.release_inflight(msgs)
                rk.dr_msgq(msgs, KafkaError(Err._PURGE_INFLIGHT,
                                            "purged in flight",
                                            retriable=False), tp=tp)
            elif exc is not None:
                self._release_unsent(tp, msgs, exc)
            elif self.state != BrokerState.UP or self.terminate:
                # requeue FIRST: the DRAIN rebase scans retry_batches the
                # instant inflight drops to 0 (release_inflight docstring)
                tp.enqueue_retry_batch(msgs)
                tp.release_inflight(msgs)
            else:
                self._send_produce(tp, msgs, wire, now)

    def _release_unsent(self, tp, msgs: list[Message], exc: Exception):
        tp.release_inflight(msgs)
        self.rk.log("ERROR", f"{self.name}: batch codec failed: {exc!r}")
        self.rk.dr_msgq(msgs, KafkaError(Err._FAIL,
                                         f"batch codec failed: {exc!r}"),
                        tp=tp)

    def _codec_for(self, tp, global_codec: str) -> str:
        """Topic-scope compression.codec override; 'inherit' falls
        through to the global row (reference rdkafka_conf.c:1360)."""
        t = self.rk.topics.get(tp.topic)
        if t is not None:
            tc = t.conf.get("compression.codec")
            if tc != "inherit":
                return tc
        return global_codec

    def _make_writer(self, tp, msgs, codec: str):
        rk = self.rk
        pid, epoch = (-1, -1)
        base_seq = -1
        if rk.idemp:
            pid, epoch = rk.idemp.pid, rk.idemp.epoch
            base_seq = (batch_head_msgid(msgs) - 1
                        - tp.epoch_base_msgid) & 0x7FFFFFFF
        # transactional attr bit: every batch of a transactional
        # producer carries it (produce() is gated to IN_TXN), flowing
        # through the same writer on both CPU and GPU codec providers
        transactional = rk.txnmgr is not None
        now_ms = int(time.time() * 1000)
        if isinstance(msgs, ArenaBatch):
            # fused fast lane: defer frame+compress+CRC to ONE native
            # call in the codec phase (no intermediate records_bytes)
            # when the provider routes this codec to the CPU path.
            # Transactional batches ride it too — build_batch ORs the
            # transactional bit into the attribute word
            cid = getattr(rk.codec_provider, "fused_codec_id",
                          lambda c: None)(codec)
            if cid is not None and codec_phase.fused_builder() is not None:
                return codec_phase.FusedJob(
                    cid, pid, epoch, base_seq, now_ms,
                    ATTR_TRANSACTIONAL if transactional else 0)
        w = MsgsetWriterV2(producer_id=pid, producer_epoch=epoch,
                           base_sequence=base_seq,
                           transactional=transactional,
                           codec=None if codec == "none" else codec)
        if isinstance(msgs, ArenaBatch):
            # fast lane: ONE native call straight off the arena buffers
            t0 = _trace.now() if _trace.enabled else 0
            w.build_arena(msgs, now_ms)
            if t0:
                # per-stage attribution: arena run → framed records
                _trace.complete("produce", "native_frame", t0,
                                {"topic": tp.topic,
                                 "partition": tp.partition,
                                 "msgs": msgs.count,
                                 "batch": msgs.msgid_base})
        else:
            # Message duck-types Record (key/value/headers/timestamp) —
            # no per-message conversion on the hot path
            w.build(msgs, now_ms)
        return w

    def _produce_legacy(self, ready: list, codec: str, now: float):
        """Magic 0/1 path for pre-0.11 brokers: per-batch msgset build +
        compression wrapper (no batched CRC seam — MsgVer0/1 CRC is the
        per-message zlib crc32 the v01 writer computes inline)."""
        from ..protocol.msgset import write_msgset_v01
        rk = self.rk
        magic = 1 if MSGVER1 in self.features else 0
        ver = pick_version(self.api_versions, ApiKey.Produce, 2)
        provider = rk.codec_provider
        now_ms = int(time.time() * 1000)
        for tp, msgs, _writer in ready:
            if isinstance(msgs, ArenaBatch):
                # legacy brokers are off the fast path: materialize
                # Messages (rare — pre-0.11 cluster)
                msgs = msgs.to_messages(tp.topic)
            try:
                compress_fn = None
                codec_tp = self._codec_for(tp, codec)
                use_codec = None if codec_tp == "none" else codec_tp
                if use_codec:
                    lvl = rk.topic_conf_for(tp.topic).get("compression.level")
                    compress_fn = (lambda raw, c=use_codec, l=lvl:
                                   provider.compress_many(c, [raw], l)[0])
                wire = write_msgset_v01(msgs, magic=magic, codec=use_codec,
                                        now_ms=now_ms,
                                        compress_fn=compress_fn)
            except Exception as e:
                self._release_unsent(tp, msgs, e)
                continue
            self._send_produce(tp, msgs, wire, now, version=ver)

    def _send_produce(self, tp, msgs, wire: bytes, now: float,
                      version: Optional[int] = None):
        rk = self.rk
        tconf = rk.topic_conf_for(tp.topic)
        acks = tconf.get("request.required.acks")
        # NOTE: tp.inflight / inflight_msgids were accounted at batch
        # formation time in _producer_serve (DRAIN-rebase atomicity)
        if isinstance(msgs, ArenaBatch):
            msgs.possibly_persisted = True
        else:
            for m in msgs:
                m.status = MsgStatus.POSSIBLY_PERSISTED
                m.latency_us = int((now - m.enq_time) * 1e6)
        t_tx = _trace.now() if _trace.enabled else 0
        req = Request(
            ApiKey.Produce,
            {"transactional_id": (rk.conf.get("transactional.id") or None
                                  if rk.txnmgr is not None else None),
             "acks": acks,
             "timeout": tconf.get("request.timeout.ms"),
             "topics": [{"topic": tp.topic, "partitions": [
                 {"partition": tp.partition, "records": wire}]}]},
            expect_response=(acks != 0),
            version=version,
            cb=lambda err, resp, tp=tp, msgs=msgs, t_tx=t_tx:
            self._handle_produce(tp, msgs, err, resp, t_tx))
        self._xmit(req)
        if t_tx:
            # framing + write-queue submit of the ProduceRequest
            _trace.complete("produce", "produce_tx", t_tx,
                            {"topic": tp.topic,
                             "partition": tp.partition,
                             "bytes": len(wire),
                             "batch": batch_head_msgid(msgs)})
        if acks == 0:
            tp.release_inflight(msgs)
            if not isinstance(msgs, ArenaBatch):
                for m in msgs:
                    m.offset = -1
            rk.dr_msgq(msgs, None, tp=tp)

    def _handle_produce(self, tp, msgs: list[Message], err, resp,
                        t_tx_ns: int = 0):
        """Produce response → DR / retry / idempotence reconciliation
        (reference: rd_kafka_handle_Produce, rdkafka_request.c:2887,
        error path :2415).  The in-flight accounting is released only
        AFTER the requeue-or-DR decision so the main thread's DRAIN
        rebase can never observe inflight==0 while this batch is still
        unresolved."""
        if t_tx_ns and _trace.enabled:
            # tx -> response read (the wire round trip of this batch)
            _trace.complete("produce", "ack", t_tx_ns,
                            {"topic": tp.topic, "partition": tp.partition,
                             "err": (err.code.name if err is not None
                                     else None),
                             "batch": batch_head_msgid(msgs)})
        t_dr = _trace.now() if _trace.enabled else 0
        try:
            self._handle_produce0(tp, msgs, err, resp, t_tx_ns)
        finally:
            tp.release_inflight(msgs)
            if t_dr:
                # the response's own work: DR / retry / idempotence
                _trace.complete("produce", "dr", t_dr,
                                {"topic": tp.topic,
                                 "partition": tp.partition,
                                 "batch": batch_head_msgid(msgs)})

    def _gapless_fatal(self, tp, kerr: KafkaError) -> Optional[KafkaError]:
        """enable.gapless.guarantee: any permanently failed message in an
        idempotent stream leaves a sequence gap — escalate to a fatal
        error (reference: RD_KAFKA_RESP_ERR__GAPLESS_GUARANTEE)."""
        rk = self.rk
        if rk.idemp is None or not rk.conf.get("enable.gapless.guarantee"):
            return None
        if kerr.code in (Err._PURGE_QUEUE, Err._PURGE_INFLIGHT):
            return None          # app-initiated purge is not a gap
        fatal = KafkaError(
            Err._GAPLESS_GUARANTEE,
            f"{tp}: message failed ({kerr.code.name}) and "
            "enable.gapless.guarantee is set")
        rk.set_fatal_error(fatal)
        return fatal

    def _handle_produce0(self, tp, msgs: list[Message], err, resp,
                         t_tx_ns: int = 0):
        rk = self.rk
        ut = rk.conf.get("ut_handle_ProduceResponse")
        if ut is not None:
            # hidden unit-test hook (reference ut_handle_ProduceResponse,
            # rdkafka_conf.c:849): may override the response outcome
            override = ut(self.nodeid, batch_head_msgid(msgs), err)
            if override is not None:
                err = override
        fast = isinstance(msgs, ArenaBatch)
        if err is None:
            pres = resp["topics"][0]["partitions"][0]
            ec = Err.from_wire(pres["error_code"])
            if ec == Err.NO_ERROR:
                base = pres["base_offset"]
                if _trace.enabled and _trace.flow_sample_every and base >= 0:
                    # cross-process flow points: offsets are
                    # only known HERE, at ack time — emit the sampled
                    # produce point back-dated to the request tx stamp
                    # and the ack point at now; obs/collect.py stitches
                    # them to the consumer's fetch/deliver points by
                    # (topic, partition, offset)
                    n = msgs.count if fast else len(msgs)
                    step = _trace.flow_sample_every
                    for off in range(base + (-base) % step, base + n,
                                     step):
                        a = {"topic": tp.topic, "partition": tp.partition,
                             "offset": off}
                        _trace.evt("flow", "flow_produce", "i",
                                   t_tx_ns or None, 0, a)
                        _trace.instant("flow", "flow_ack", a)
                if not fast and (rk.interceptors or rk.conf.get("dr_msg_cb")
                                 or rk.conf.get("dr_cb")
                                 or any(m.on_delivery is not None
                                        for m in msgs)):
                    for i, m in enumerate(msgs):
                        m.offset = base + i if base >= 0 else -1
                        m.status = MsgStatus.PERSISTED
                rk.dr_msgq(msgs, None, tp=tp, base_offset=base)
                return
            kerr = KafkaError(ec)
        else:
            kerr = err

        # error path
        if rk.txnmgr is not None and kerr.code in (
                Err.PRODUCER_FENCED, Err.INVALID_PRODUCER_EPOCH,
                Err.TRANSACTION_COORDINATOR_FENCED):
            # zombie fencing: a newer instance of this transactional.id
            # bumped the epoch — fatal, never retried (resending under
            # a stale epoch is exactly what fencing exists to stop)
            fatal = rk.txnmgr.fenced(f"{tp}: produce")
            rk.dr_msgq(msgs, fatal, tp=tp)
            return
        if kerr.code in (Err.DUPLICATE_SEQUENCE_NUMBER,):
            # benign: broker already has these (idempotent dedup)
            if not fast:
                for m in msgs:
                    m.status = MsgStatus.PERSISTED
            rk.dr_msgq(msgs, None, tp=tp)
            return
        if rk.idemp and kerr.code == Err.OUT_OF_ORDER_SEQUENCE_NUMBER:
            # If an EARLIER batch of this partition failed retriably, the
            # broker rejects every in-flight successor with OUT_OF_ORDER —
            # a consequent error: requeue in msgid order and let the head
            # batch retry first.  A gap at the head of the line, however,
            # is a true sequence desynchronization: the batch is
            # POSSIBLY_PERSISTED and resending under a fresh PID would
            # bypass broker dedup, so it is FATAL (reference:
            # rd_kafka_handle_Produce_error, rdkafka_request.c:2173 r==0).
            head = batch_head_msgid(msgs)
            with tp.lock:
                pending_earlier = (
                    any(m.msgid < head for m in tp.xmit_msgq)
                    or any(batch_head_msgid(b) < head
                           for b in tp.retry_batches)
                    or any(mid < head for mid in tp.inflight_msgids))
            if pending_earlier:
                tp.enqueue_retry_batch(msgs)
                tp.retry_backoff_until = time.monotonic() + \
                    rk.conf.get("retry.backoff.ms") / 1000.0
                return
            fatal = KafkaError(
                Err.OUT_OF_ORDER_SEQUENCE_NUMBER,
                f"{tp}: sequence desynchronization: head-of-line batch "
                f"rejected with OUT_OF_ORDER_SEQUENCE_NUMBER "
                f"(possibly persisted; resend would bypass broker dedup)")
            rk.set_fatal_error(fatal)
            rk.dr_msgq(msgs, fatal, tp=tp)
            return
        retriable = kerr.retriable
        max_retries = rk.conf.get("message.send.max.retries")
        if retriable:
            if kerr.code in (Err.NOT_LEADER_FOR_PARTITION,
                             Err.LEADER_NOT_AVAILABLE,
                             Err.UNKNOWN_TOPIC_OR_PART):
                rk.metadata_refresh(reason=f"produce error {kerr.code.name}",
                                    topics=[tp.topic])
            if rk.idemp or fast:
                # keep the batch frozen: membership must survive the retry
                # for (BaseSequence, count) dup detection; budget is judged
                # on the batch head (fast-lane batches always travel
                # whole — their records share one retry budget)
                batch_retries = (msgs.retries if fast
                                 else msgs[0].retries)
                if batch_retries < max_retries:
                    if fast:
                        msgs.retries += 1
                    else:
                        for m in msgs:
                            m.retries += 1
                    tp.enqueue_retry_batch(msgs)
                    tp.retry_backoff_until = time.monotonic() + \
                        rk.conf.get("retry.backoff.ms") / 1000.0
                else:
                    rk.dr_msgq(msgs, self._gapless_fatal(tp, kerr) or kerr,
                               tp=tp)
                return
            retry = [m for m in msgs if m.retries < max_retries]
            fail = [m for m in msgs if m.retries >= max_retries]
            # (non-idempotent path continues below)
            for m in retry:
                m.retries += 1
            if retry:
                tp.insert_retry(retry)
                tp.retry_backoff_until = time.monotonic() + \
                    rk.conf.get("retry.backoff.ms") / 1000.0
            if fail:
                rk.dr_msgq(fail, self._gapless_fatal(tp, kerr) or kerr,
                           tp=tp)
        else:
            rk.dr_msgq(msgs, self._gapless_fatal(tp, kerr) or kerr, tp=tp)

    # =================================================== CONSUMER SERVE ===
    def _consumer_serve(self, now: float):
        """(reference: rd_kafka_broker_consumer_serve, rdkafka_broker.c:4489
        → rd_kafka_broker_fetch_toppars :4279)

        Fetch pipelining: up to ``fetch.num.inflight`` FetchRequests may
        be outstanding per broker, over DISJOINT partition sets (each
        toppar is in at most one outstanding Fetch) — the reference
        keeps the fetch pipe full the same way instead of serializing
        one Fetch per broker round trip."""
        rk = self.rk
        if self.fetch_inflight_cnt >= rk.conf.get("fetch.num.inflight"):
            return
        from .partition import FetchState
        fetch_parts = []
        # O(active): scan the client's active-toppar index (consumer-
        # started or produced-to), not this broker's full toppar set —
        # metadata registration alone puts every partition of every
        # known topic in self.toppars, and a 100k-toppar client must
        # not walk them per serve pass
        for tp in rk.active_toppars():
            if tp not in self.toppars:
                continue
            # KIP-392: a delegated partition fetches from its follower;
            # everyone else fetches from the leader
            fetch_node = (tp.fetch_broker_id
                          if tp.fetch_broker_id is not None
                          else tp.leader_id)
            if fetch_node != self.nodeid or tp.paused:
                continue
            if tp.fetch_in_flight:
                continue
            if tp.fetch_state == FetchState.OFFSET_QUERY:
                self._offset_query(tp)
                continue
            if tp.fetch_state != FetchState.ACTIVE:
                continue
            if now < tp.fetch_backoff_until:
                continue
            # budget reads under the toppar lock: the app thread's
            # drain decrements them concurrently (same --races finding
            # as the kafka/consumer RMW sites)
            with tp.lock:
                fq_cnt, fq_bytes = tp.fetchq_cnt, tp.fetchq_bytes
            if fq_cnt >= rk.conf.get("queued.min.messages"):
                continue
            if fq_bytes >= rk.conf.get(
                    "queued.max.messages.kbytes") * 1024:
                continue
            if tp.fetch_offset < 0:
                continue
            fetch_parts.append(tp)
        if not fetch_parts:
            return
        fetch_ver = pick_version(self.api_versions, ApiKey.Fetch, 11)
        fs = self._fetch_session
        use_session = (fetch_ver >= 7
                       and rk.conf.get("fetch.session.enable"))
        if use_session and fs.overflow_inflight:
            # an overflow fetch (below) is out.  The broker answers a
            # connection's requests in order, so it lands after the
            # session response it was queued behind: a session built
            # before it lands finds its partitions in flight and leaves
            # them out of the book again, every epoch (a 10,000-partition
            # assign kept thousands out for good).  It returns at once
            # (max_wait 0): build after it.
            return
        part_max = rk.conf.get("fetch.message.max.bytes")
        body = {
            "replica_id": -1,
            "max_wait_time": rk.conf.get("fetch.wait.max.ms"),
            "min_bytes": rk.conf.get("fetch.min.bytes"),
            "max_bytes": rk.conf.get("fetch.max.bytes"),
            "isolation_level": 1 if rk.conf.get("isolation.level") ==
                               "read_committed" else 0,
            # v11+ (KIP-392): our rack lets the broker nominate a
            # same-rack follower via preferred_read_replica
            "rack_id": rk.conf.get("client.rack")}
        session_req = False
        if use_session and not fs.inflight:
            # KIP-227 session fetch: the request lists only partitions
            # whose (offset, max_bytes) CHANGED vs the session book —
            # added/seeked — plus forgotten_topics for removals; an
            # all-unchanged steady state sends an EMPTY topic list and
            # the broker long-polls the whole book.  The effective
            # partition set is all of `wanted`, so every eligible
            # partition is claimed and version-stamped, listed or not.
            wanted = {(tp.topic, tp.partition): (tp.fetch_offset, part_max)
                      for tp in fetch_parts}
            epoch, to_send, forgotten = fs.build(wanted)
            by_tp = {(tp.topic, tp.partition): tp for tp in fetch_parts}
            by_topic: dict[str, list] = {}
            for key in to_send:
                by_topic.setdefault(key[0], []).append(by_tp[key])
            fby: dict[str, list] = {}
            for t, p in forgotten:
                fby.setdefault(t, []).append(p)
            body["session_id"] = fs.session_id
            body["session_epoch"] = epoch
            body["topics"] = [
                {"topic": t, "partitions": [
                    {"partition": tp.partition,
                     "fetch_offset": tp.fetch_offset,
                     "max_bytes": part_max}
                    for tp in tps]} for t, tps in by_topic.items()]
            body["forgotten_topics"] = [
                {"topic": t, "partitions": ps} for t, ps in fby.items()]
            session_req = True
        else:
            # sessionless full fetch (schema defaults: session_id=0,
            # epoch=-1): sessions disabled, a pre-v7 broker, or a
            # session request already outstanding — newly eligible
            # partitions go out as one-shot full fetches and fold into
            # the session on a later pass (KIP-227 epochs are strictly
            # sequential; only ONE session request may be in flight)
            if use_session:
                # overflow next to an in-flight session: ONE immediate-
                # return fetch per partition per session epoch.  A
                # long-polling (or repeated) overflow turns over on the
                # same cadence as the session itself, so its partitions
                # are forever in flight at session-build time and never
                # fold into the book (observed: a 1000-partition assign
                # stuck at a 1-partition session, then a half-absorbed
                # book with the spin costing more wire than the session
                # saved).  One max_wait=0 round serves fresh data NOW;
                # after it the partition sits free until the in-flight
                # session turns over (<= fetch.wait.max.ms) and the
                # next epoch's build absorbs it deterministically.
                fetch_parts = [tp for tp in fetch_parts
                               if (tp.topic, tp.partition)
                               not in fs.overflowed]
                if not fetch_parts:
                    return
                fs.overflowed.update(
                    (tp.topic, tp.partition) for tp in fetch_parts)
                fs.overflow_inflight += 1
                body["max_wait_time"] = 0
            by_topic = {}
            for tp in fetch_parts:
                by_topic.setdefault(tp.topic, []).append(tp)
            body["topics"] = [{"topic": t, "partitions": [
                {"partition": tp.partition,
                 "fetch_offset": tp.fetch_offset,
                 "max_bytes": part_max}
                for tp in tps]} for t, tps in by_topic.items()]
        self.fetch_inflight_cnt += 1
        for tp in fetch_parts:
            tp.fetch_in_flight = True
        versions = {(tp.topic, tp.partition): tp.version for tp in fetch_parts}
        overflow = use_session and not session_req
        self._xmit(Request(ApiKey.Fetch, body, version=fetch_ver,
                           cb=lambda err, resp, parts=fetch_parts,
                           sess=session_req, ovf=overflow:
                           self._handle_fetch(err, resp, versions, parts,
                                              session=sess, overflow=ovf)))

    def _offset_query(self, tp):
        """Logical offset (BEGINNING/END) → ListOffsets
        (reference: rd_kafka_toppar_offset_request)."""
        from .partition import FetchState
        ts = (proto.OFFSET_BEGINNING
              if tp.fetch_offset == proto.OFFSET_BEGINNING
              else proto.OFFSET_END)
        tp.fetch_state = FetchState.OFFSET_WAIT
        body = {"replica_id": -1,
                "topics": [{"topic": tp.topic, "partitions": [
                    {"partition": tp.partition, "timestamp": ts,
                     "max_num_offsets": 1}]}]}    # v0 field; v1 ignores
        self._xmit(Request(ApiKey.ListOffsets, body, retries_left=3,
                           version=pick_version(self.api_versions,
                                                ApiKey.ListOffsets, 1),
                           cb=lambda err, resp, tp=tp:
                           self._handle_offset(tp, err, resp)))

    def _handle_offset(self, tp, err, resp):
        from .partition import FetchState
        if err is not None:
            tp.fetch_state = FetchState.OFFSET_QUERY
            tp.fetch_backoff_until = time.monotonic() + \
                self.rk.conf.get("fetch.error.backoff.ms") / 1000.0
            return
        pres = resp["topics"][0]["partitions"][0]
        ec = Err.from_wire(pres["error_code"])
        if ec != Err.NO_ERROR:
            tp.fetch_state = FetchState.OFFSET_QUERY
            tp.fetch_backoff_until = time.monotonic() + \
                self.rk.conf.get("fetch.error.backoff.ms") / 1000.0
            return
        if "offset" in pres:
            resolved = pres["offset"]
        else:                       # ListOffsets v0: plural offsets
            offs = pres.get("offsets") or [-1]
            resolved = offs[0]
        if resolved < 0:
            # no resolvable offset: back off and re-query rather than
            # fetching at -1 (OFFSET_OUT_OF_RANGE loop)
            tp.fetch_state = FetchState.OFFSET_QUERY
            tp.fetch_backoff_until = time.monotonic() + \
                self.rk.conf.get("fetch.error.backoff.ms") / 1000.0
            return
        tp.fetch_offset = resolved
        tp.fetch_state = FetchState.ACTIVE
        self.rk.dbg("fetch", f"{tp}: offset query -> {tp.fetch_offset}")

    def _handle_fetch(self, err, resp, versions, parts, session=False,
                      overflow=False):
        self.fetch_inflight_cnt = max(0, self.fetch_inflight_cnt - 1)
        if overflow:
            fs = self._fetch_session
            fs.overflow_inflight = max(0, fs.overflow_inflight - 1)
        # in-flight claim discipline: OK partitions stay claimed
        # continuously from request to deferred-entry processing (a
        # clear-then-reclaim window would let another broker double-
        # fetch the same offsets mid-migration); everything else —
        # errored partitions, stale versions, and ANY exception before
        # the ok-list is final — releases in _handle_fetch0's finally.
        ok_final = None
        try:
            ok_final = self._handle_fetch0(err, resp, versions, parts,
                                           session=session)
        finally:
            keep = ({id(e[0]) for e in ok_final}
                    if ok_final is not None else set())
            for tp in parts:
                if id(tp) not in keep:
                    tp.fetch_in_flight = False

    def _handle_fetch0(self, err, resp, versions, parts, session=False):
        if session:
            fs = self._fetch_session
            fs.inflight = False
            if err is not None:
                # transport error: the broker-side cache entry is gone
                # (or unreachable) — renegotiate from epoch 0
                fs.reset("transport error")
            else:
                top_ec = Err.from_wire(resp.get("error_code", 0))
                if top_ec in (Err.FETCH_SESSION_ID_NOT_FOUND,
                              Err.INVALID_FETCH_SESSION_EPOCH):
                    # the broker evicted/lost the session (cache
                    # pressure, restart) or we desynced: fall back to a
                    # full fetch — the reset makes the next request an
                    # epoch-0 full renegotiation.  The response carries
                    # no partitions; claims release via the finally.
                    self.rk.dbg("fetch",
                                f"{self.name}: fetch session "
                                f"{top_ec.name}; renegotiating")
                    fs.reset(top_ec.name)
                    return None
                fs.on_success(resp.get("session_id", 0))
        if err is not None:
            # a failed fetch to a FOLLOWER falls back to the leader
            # (reference reverts the preferred replica on errors) —
            # WITH backoff, or transport errors would ping-pong the
            # partition between brokers at error rate
            backoff = time.monotonic() + \
                self.rk.conf.get("fetch.error.backoff.ms") / 1000.0
            for tp in parts:
                if tp.fetch_broker_id is not None:
                    tp.fetch_backoff_until = backoff
                    self.rk.revoke_fetch_delegation(tp, f"fetch: {err}")
            return
        rk = self.rk
        from .partition import FetchState
        from ..protocol.msgset import iter_batches

        from ..protocol.msgset import split_msgset_segments
        # phase A: collect OK partitions; split v2 blobs into batches so
        # CRC verify and decompress each run as ONE batched provider
        # call across the whole Fetch response — the consumer-side
        # mirror of the producer's batched codec seam (reference does
        # both per batch on the broker thread,
        # rdkafka_msgset_reader.c:950-1016 CRC, :258-530 decompress)
        # every phase works from the (fetch_offset, version) snapshot
        # taken here, so a concurrent seek() cannot desync the
        # decompress decision (phase C) from the parse decision (D) —
        # the op version stamp makes post-seek deliveries discardable
        ok: list[tuple] = []      # (tp, pres, batches|None, fo, ver)
        for t in resp["topics"]:
            for p in t["partitions"]:
                tp = rk.get_toppar(t["topic"], p["partition"], create=False)
                if tp is None or tp not in self.toppars:
                    continue
                if versions.get((tp.topic, tp.partition), -1) != tp.version:
                    continue  # stale (seek/rebalance since request)
                ec = Err.from_wire(p["error_code"])
                if ec == Err.NO_ERROR:
                    # v11 KIP-392: the leader may nominate a follower;
                    # move this partition's fetching there (the
                    # redirect response itself carries no records)
                    pref = p.get("preferred_read_replica", -1)
                    if pref != -1 and pref != self.nodeid:
                        rk.delegate_fetch(tp, pref)
                    tp.hi_offset = p["high_watermark"]
                    tp.ls_offset = p.get("last_stable_offset",
                                         p["high_watermark"])
                    blob = p["records"] or b""
                    batches = None
                    if blob:
                        # ONE frame walk per partition response: its
                        # result feeds the mixed/legacy decisions here,
                        # the legacy CRC verify (phase B), and the reply
                        # handler (via pres["_segments"])
                        segs = split_msgset_segments(blob)
                        p["_segments"] = segs
                        if len(segs) == 1 and segs[0][0] == "v2":
                            batches = [
                                [info, payload,
                                 info.base_offset + info.last_offset_delta,
                                 full]
                                for info, payload, full in
                                iter_batches(blob)]
                        # mixed or legacy blobs: the reply handler
                        # splits/processes inline — precomputed batches
                        # would silently drop the legacy run
                    ok.append((tp, p, batches, tp.fetch_offset, tp.version))
                elif ec == Err.OFFSET_OUT_OF_RANGE \
                        and tp.fetch_broker_id is not None:
                    # a lagging follower, not a truncated log: retry
                    # from the leader before any offset reset
                    # (reference: rd_kafka_fetch_reply OUT_OF_RANGE on
                    # preferred replica → revert, no reset) — with
                    # backoff so a still-lagging follower can't
                    # ping-pong the partition at RTT rate
                    tp.fetch_backoff_until = time.monotonic() + \
                        rk.conf.get("fetch.error.backoff.ms") / 1000.0
                    rk.revoke_fetch_delegation(tp, "follower out of range")
                elif ec == Err.OFFSET_OUT_OF_RANGE:
                    rk.offset_reset(tp, f"fetch offset {tp.fetch_offset} out of range")
                elif ec in (Err.NOT_LEADER_FOR_PARTITION,
                            Err.UNKNOWN_TOPIC_OR_PART,
                            Err.LEADER_NOT_AVAILABLE,
                            Err.FENCED_LEADER_EPOCH):
                    if tp.fetch_broker_id is not None:
                        rk.revoke_fetch_delegation(tp, ec.name)
                    rk.metadata_refresh(reason=f"fetch error {ec.name}",
                                        topics=[tp.topic])
                    tp.fetch_backoff_until = time.monotonic() + \
                        rk.conf.get("fetch.error.backoff.ms") / 1000.0
                else:
                    if tp.fetch_broker_id is not None:
                        rk.revoke_fetch_delegation(tp, ec.name)
                    tp.fetch_backoff_until = time.monotonic() + \
                        rk.conf.get("fetch.error.backoff.ms") / 1000.0
        if not ok:
            return None
        if _trace.enabled:
            _trace.instant("fetch", "fetch_rx",
                           {"broker": self.name, "partitions": len(ok)})
        # phases B-D run PER PARTITION with decompressed-ahead flow
        # control. Two measured pathologies of whole-response
        # batching: (a) a 1MB-wire partition can decompress to tens of
        # MB at high compression ratios, so the app thread saw seconds
        # of zero delivery while the broker ground through the whole
        # response; (b) materializing hundreds of MB ahead of the app
        # walks the heap through fresh pages — fault+zero+cold-write
        # measured 275 MB/s effective decode vs 5-7 GB/s when the
        # working set recycles. So a partition is processed only while
        # the total queued-undelivered volume is under the
        # queued.max.messages.kbytes budget; the rest defer to the
        # serve loop and resume as the app drains (the reference's
        # fetchq bound, applied at the decompress stage). Within a
        # partition, CRC and decompress still run as BATCHED provider
        # calls over its ~10 batches — the offload seam's launch axis.
        # entries park still-claimed (no other broker may re-fetch the
        # same offsets); _serve_deferred_fetch releases at process time
        self._fetch_deferred.extend(ok)
        self._serve_deferred_fetch()
        return ok

    def _queued_fetch_bytes(self) -> int:
        # O(active): only started/produced-to toppars can hold fetchq
        # bytes — never walk the full (metadata-registered) toppar set
        total = 0
        for tp in self.rk.active_toppars():
            if tp not in self.toppars:
                continue
            with tp.lock:
                total += tp.fetchq_bytes
        return total

    def _serve_deferred_fetch(self) -> None:
        """Process deferred fetch partitions while the app-side queue
        has room (called from _handle_fetch and each serve pass). The
        queued-bytes sum is computed once per drain and advanced by
        each resolved entry's own contribution — per-entry re-sums
        were O(partitions^2) on wide brokers; app-side drains between
        iterations only make the estimate conservative.

        Codec phases are pipelined: each admitted partition's CRC
        regions and decompress jobs are SUBMITTED as offload tickets
        (_begin_fetch_partition) and parked in the _PendingFetch FIFO
        up to gpu.fetch.pipeline.depth deep, so this thread frames and
        splits the NEXT partition (or fetch response) while the engine
        dispatch thread and the device execute; tickets resolve in
        order (_reap_fetch_pending), preserving delivery order, the
        seek-stamp discard and the CRC-mismatch semantics exactly."""
        # migrated partitions release their claims FIRST, regardless of
        # the queued-bytes budget: the new leader's fetch is blocked on
        # fetch_in_flight, and an undrained old-broker backlog must not
        # starve it (their parked data is stale — the new broker
        # re-fetches the same offsets)
        if any(e[0] not in self.toppars for e in self._fetch_deferred):
            kept: deque = deque()
            for entry in self._fetch_deferred:
                if entry[0] in self.toppars:
                    kept.append(entry)
                else:
                    entry[0].fetch_in_flight = False
            self._fetch_deferred = kept
        self._reap_fetch_pending(block=False)
        budget = self.rk.conf.get("queued.max.messages.kbytes") * 1024
        depth = max(1, int(getattr(self.rk, "fetch_pipeline_depth", 2)
                           or 1))
        queued = self._queued_fetch_bytes()
        while self._fetch_deferred:
            if queued >= budget:
                return
            if len(self._fetch_pending) >= depth:
                # pipeline full: block on the oldest entry's tickets —
                # the newer launches keep executing meanwhile (the
                # CodecWorker in-flight gate, consumer side)
                queued += self._reap_fetch_pending(block=True)
                continue
            entry = self._fetch_deferred.popleft()
            self._pass_work += 1
            tp = entry[0]
            if tp not in self.toppars:
                tp.fetch_in_flight = False   # migrated while deferred
                continue
            try:
                self._fetch_pending.append(
                    self._begin_fetch_partition(entry))
            except Exception as e:
                tp.fetch_in_flight = False
                self.rk.log("ERROR",
                            f"{self.name}: fetch partition process: {e!r}")
                continue
            # opportunistic reap: keeps the budget accounting current,
            # and with pre-resolved tickets (CPU provider) preserves the
            # sync path's strict process-then-admit ordering
            queued += self._reap_fetch_pending(block=False)
        self._reap_fetch_pending(block=False)

    def _reap_fetch_pending(self, block: bool) -> int:
        """Resolve pending fetch partitions strictly FIFO; returns the
        delivered fetchq-bytes delta for the budget accounting.
        ``block=True`` waits for the OLDEST entry's tickets (pipeline
        full), then keeps draining whatever else already resolved."""
        delta = 0
        while self._fetch_pending and (block
                                       or self._fetch_pending[0].done()):
            block = False
            pend = self._fetch_pending.popleft()
            self._pass_work += 1
            tp = pend.entry[0]
            with tp.lock:
                before = tp.fetchq_bytes
            # release-then-process, the sync path's ordering; migrated
            # partitions only release (their parked data is stale — the
            # new broker re-fetches the same offsets)
            tp.fetch_in_flight = False
            try:
                if tp in self.toppars:
                    self._finish_fetch_partition(pend)
            except Exception as e:
                self.rk.log("ERROR",
                            f"{self.name}: fetch partition process: {e!r}")
            if pend.t_submit_ns:
                # fetch pipeline window: ticket submit -> reap (stats
                # brokers.fetch_latency, STATISTICS.md)
                self.fetch_latency_avg.add(
                    (time.monotonic_ns() - pend.t_submit_ns) / 1e3)
            with tp.lock:
                after = tp.fetchq_bytes
            delta += max(0, after - before)
        return delta

    def _begin_fetch_partition(self, entry) -> _PendingFetch:
        """Phases B+C: submit this partition's CRC verify regions (both
        polynomials) and decompress jobs through
        codec_phase.submit_fetch and return a _PendingFetch.  Providers
        without an async seam resolve through pre-resolved SyncTickets:
        same code path, synchronous schedule, identical bytes."""
        rk = self.rk
        tp, pres, batches, fo, ver = entry
        pend = _PendingFetch(entry)
        pend.t_submit_ns = time.monotonic_ns()
        regions, lregions = [], []
        if rk.conf.get("check.crcs"):
            if batches:
                regions = [b[3][proto.V2_OF_Attributes:]
                           for b in batches if b[2] >= fo]
                pend.crc_bytes = sum(map(len, regions))
                pend.crc_infos = [b[0] for b in batches if b[2] >= fo]
            else:
                # legacy MsgVer0/1 blobs: per-message zlib CRC (reference
                # verifies inline, rdkafka_msgset_reader.c v0/v1).  The
                # phase-A segment split keeps v2 batches out of this walk
                lowners = []
                for kind, seg in pres.get("_segments") or []:
                    if kind != "legacy":
                        continue
                    for off, crc, region in iter_legacy_crc_regions(seg):
                        lregions.append(region)
                        lowners.append((off, crc))
                pend.legacy_owners = lowners
        pend.crc_ticket, pend.legacy_ticket, pend.dec_tickets = \
            codec_phase.submit_fetch(
                rk.codec_provider, regions, lregions,
                [(b[0].codec, b, b[1]) for b in batches or ()
                 if b[2] >= fo and b[0].codec])
        return pend

    def _finish_fetch_partition(self, pend: _PendingFetch) -> None:
        """Resolve a partition's codec tickets and run phase D, with
        the synchronous path's exact observable semantics: a CRC
        mismatch emits Err._BAD_MSG + 0.5s fetch backoff and drops the
        partition's batches; a failing decompress isolates per batch
        (payload=None) so a corrupt batch inside an aborted transaction
        does not suppress the partition's valid committed data; the
        delivery is stamped with the (fetch_offset, version) snapshot
        so post-seek resolutions get discarded."""
        rk = self.rk
        tp, pres, batches, fo, ver = pend.entry
        if pend.crc_ticket is not None:
            crcs = pend.crc_ticket.result(60.0)
            if getattr(pend.crc_ticket, "on_device", False):
                self.c_fetch_crc_bytes_device += pend.crc_bytes
            else:
                self.c_fetch_crc_bytes_host += pend.crc_bytes
            if _trace.enabled:
                # submit -> resolve: the verify's share of the pipeline
                _trace.complete("fetch", "crc_verify", pend.t_submit_ns,
                                {"topic": tp.topic,
                                 "partition": tp.partition,
                                 "batches": len(pend.crc_infos)})
            for info, crc in zip(pend.crc_infos, crcs):
                if int(crc) != info.crc:
                    if _trace.enabled:
                        _trace.instant("fetch", "crc_mismatch",
                                       {"topic": tp.topic,
                                        "partition": tp.partition,
                                        "offset": info.base_offset})
                        _trace.flight_record("crc_mismatch")
                    rk.op_err(KafkaError(
                        Err._BAD_MSG,
                        f"{tp}: CRC mismatch at offset "
                        f"{info.base_offset}"))
                    tp.fetch_backoff_until = time.monotonic() + 0.5
                    return
        if pend.legacy_ticket is not None:
            crcs = pend.legacy_ticket.result(60.0)
            if _trace.enabled:
                _trace.complete("fetch", "crc_verify", pend.t_submit_ns,
                                {"topic": tp.topic,
                                 "partition": tp.partition,
                                 "legacy": True,
                                 "batches": len(pend.legacy_owners)})
            for (off, want), got in zip(pend.legacy_owners, crcs):
                if int(got) != want:
                    if _trace.enabled:
                        _trace.instant("fetch", "crc_mismatch",
                                       {"topic": tp.topic,
                                        "partition": tp.partition,
                                        "offset": off, "legacy": True})
                        _trace.flight_record("crc_mismatch")
                    rk.op_err(KafkaError(
                        Err._BAD_MSG,
                        f"{tp}: legacy message CRC mismatch "
                        f"at offset {off}"))
                    tp.fetch_backoff_until = time.monotonic() + 0.5
                    return
        t_dec = _trace.now() if _trace.enabled else 0
        for codec, items, ticket in pend.dec_tickets:
            blobs = None
            try:
                blobs = ticket.result(60.0)
            except Exception:
                pass   # isolate the failing batch below
            for i, b in enumerate(items):
                if blobs is not None:
                    b[1] = blobs[i]
                    continue
                try:
                    b[1] = rk.codec_provider.decompress_many(
                        codec, [b[1]])[0]
                except Exception:
                    b[1] = None
        if t_dec and pend.dec_tickets:
            _trace.complete("fetch", "decompress", t_dec,
                            {"topic": tp.topic, "partition": tp.partition,
                             "codecs": [c for c, _i, _t in
                                        pend.dec_tickets]})
        # phase D: record parsing + delivery op for this partition
        t_del = _trace.now() if _trace.enabled else 0
        rk.fetch_reply_handle(
            tp, pres, self,
            batches=None if batches is None else
            [(info, payload, last)
             for info, payload, last, _full in batches],
            fo=fo, ver=ver)
        if t_del:
            _trace.complete("fetch", "deliver", t_del,
                            {"topic": tp.topic,
                             "partition": tp.partition})
