"""The client handle (reference: rd_kafka_t, src/rdkafka.c).

Owns configuration, the broker set, topics/toppars, the metadata cache,
the reply ("rep") queue the app polls, and the main thread
(rd_kafka_thread_main, rdkafka.c:1834) that drives timers: metadata
refresh, message timeout scans, stats emission, cgrp serving, and
unassigned-partition migration.
"""
from __future__ import annotations

import json
import random
import socket
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..analysis import lockdep as _lockdep
from ..analysis import races as _races
from ..analysis.races import shared
from ..analysis.locks import new_cond, new_lock
from ..obs import trace as _trace
from ..protocol import apis, proto
from ..protocol.msgset import (iter_batches, parse_fetch_messages_v2,
                               parse_msgset_v01, parse_records_v2,
                               verify_crc_v2)
from ..protocol.proto import ApiKey
from ..utils.hash import murmur2_partition
from .arena import (ArenaBatch, arena_new, batch_msgids, decode_hblob,
                    encode_headers, lane_new)
from .broker import Broker, Request
from .conf import Conf, TopicConf
from .errors import Err, KafkaError, KafkaException
from .msg import (FetchMessage, Message, MsgStatus, PARTITION_UA,
                  partitioner_fn)
from .partition import FetchState, Toppar
from .queue import Op, OpQueue, OpType, Timers

PRODUCER, CONSUMER = "producer", "consumer"


class Topic:  # lint: ok shared-state
    """rd_kafka_itopic_t analog: per-topic state + UA message parking.

    shared-state pragma: UA parking and partition_cnt are mutated only
    on rdk:main (metadata/partitioner paths) under ``self.lock``; the
    cross-thread surfaces live at the Toppar/OpQueue level, both
    declared there."""

    def __init__(self, name: str, tconf: TopicConf):
        self.name = name
        self.conf = tconf
        self.partition_cnt = -1
        self.ua_msgq: deque[Message] = deque()   # parked until metadata
        self.partitioner = partitioner_fn(tconf.get("partitioner"))
        self.lock = new_lock("kafka.topic")


class IdempotenceManager:
    """EOS v1 producer-id state machine (reference:
    src/rdkafka_idempotence.c — REQ_PID→WAIT_PID→ASSIGNED, drain+epoch-bump
    recovery at :347-440)."""

    # relaxed: the FSM is single-writer (rdk:main serve loop under
    # kafka.idemp); can_produce() on the produce fast path and the
    # stats emitter read lock-free — str/int snapshots, atomic under
    # the GIL, and a stale read only delays a produce by one serve pass
    state = shared("kafka.idemp.state", relaxed=True)
    pid = shared("kafka.idemp.pid", relaxed=True)
    epoch = shared("kafka.idemp.epoch", relaxed=True)

    def __init__(self, rk: "Kafka"):
        self.rk = rk
        self.state = "INIT"
        self.pid = -1
        self.epoch = -1
        self._lock = new_lock("kafka.idemp")

    def can_produce(self) -> bool:
        return self.state == "ASSIGNED"

    def serve(self):
        with self._lock:
            if self.state == "DRAIN":
                # wait for every in-flight ProduceRequest to resolve, then
                # rebase each toppar's sequence origin to its oldest
                # unacked message and fetch a fresh PID (reference
                # DRAIN_BUMP → REQ_PID, rdkafka_idempotence.c:374-440)
                with self.rk._toppars_lock:
                    tps = list(self.rk._toppars.values())
                for t in tps:
                    with t.lock:
                        # inflight must be observed atomically with the
                        # queue scan: broker threads pop a batch and
                        # claim inflight under this same lock, so per
                        # toppar either the pop already happened
                        # (inflight > 0 → wait) or the batch is still
                        # queued and counted in `pending` below.
                        # Fast-lane arena records hold NO msgids yet
                        # (assigned at take()): they will draw ids from
                        # next_msgid onward, which the default already
                        # rebases to.
                        if t.inflight > 0:
                            return
                        pending = []
                        for b in t.retry_batches:
                            pending += batch_msgids(b)
                        pending += [m.msgid for m in t.xmit_msgq]
                        pending += [m.msgid for m in t.msgq]
                        t.epoch_base_msgid = (
                            min(pending, default=t.next_msgid) - 1)
                self.state = "INIT"
            if self.state in ("INIT", "RETRY"):
                broker = self.rk.any_up_broker()
                if broker is None:
                    return
                self.state = "WAIT_PID"
                broker.enqueue_request(Request(
                    ApiKey.InitProducerId,
                    {"transactional_id": None,
                     "transaction_timeout_ms": 60000},
                    retries_left=3, cb=self._handle_pid))

    def _handle_pid(self, err, resp):
        with self._lock:
            if self.state != "WAIT_PID":
                return          # a drain was requested while in flight
            if err is not None or resp["error_code"] != 0:
                self.state = "RETRY"
                return
            self.pid = resp["producer_id"]
            self.epoch = resp["producer_epoch"]
            self.state = "ASSIGNED"
            self.rk.dbg("eos", f"assigned PID {self.pid} epoch {self.epoch}")

    def drain_epoch_bump(self, reason: str):
        """Enter DRAIN: stop producing; serve() acquires a new PID and
        rebases sequence origins once every in-flight request has
        resolved (reference DRAIN_BUMP, rdkafka_idempotence.c:374-440).
        Used for recoverable gaps the broker never saw (e.g. messages
        timing out locally, rdkafka_broker.c:3291-3309) — NOT for
        head-of-line sequence desync, which is fatal."""
        if self.rk.txnmgr is not None:
            # transactional mode: the txn manager owns the epoch
            # lifecycle (gaps surface as abortable errors; the
            # post-abort InitProducerId bumps the epoch and rebases)
            return
        with self._lock:
            if self.state in ("ASSIGNED", "WAIT_PID"):
                self.rk.dbg("eos", f"drain+epoch bump: {reason}")
                self.state = "DRAIN"


class Kafka:  # lint: ok shared-state
    """Client instance; create via Producer() or Consumer().

    shared-state pragma: the client's cross-thread surfaces are
    declared at their owning layers (OpQueue, Toppar, Broker,
    StatsCollector, the offload engine); the handful of fields below
    that genuinely cross threads are declared individually."""

    # outstanding-count accounting crosses app + broker + codec
    # threads, all under kafka.msg_cnt (the flush() contract)
    dr_cnt = shared("kafka.dr_cnt")
    flushing = shared("kafka.flushing")
    # metadata cache: mutations happen under kafka.metadata on
    # rdk:main; declared so the sweep sees its access pattern
    metadata = shared("kafka.metadata_cache")
    # fast-lane demotion breakdown: RMW'd under kafka.msg_cnt from the
    # app thread (_produce_slow/_partition_and_enq) AND the broker
    # serve thread (concurrent-append race demote); the stats emitter
    # snapshot-reads it
    _demote_reasons = shared("kafka.demote_reasons")

    def __init__(self, conf: Conf, client_type: str):
        self.conf = conf
        self.type = client_type
        if conf.get("compression.backend") == "gpu":
            # gpu.device first: a host without CUDA raises here, before
            # this client holds a tracer, lockdep or lane reference
            from ..ops.crc32c_torch import resolve_device
            resolve_device(conf.get("gpu.device"))
        # lockdep (analysis/lockdep.py, ANALYSIS.md): must engage
        # BEFORE the first lock below exists — the factory picks plain
        # vs instrumented per object at creation time.  Refcounted like
        # the tracer; released at close().
        self._lockdep_ref = False
        if conf.get("analysis.lockdep"):
            _lockdep.enable()
            self._lockdep_ref = True
        # lockset race detector (analysis/races.py): installs the
        # Guarded descriptors on every declared class and holds a
        # lockdep reference (locksets come from its held-stack) — also
        # before the first lock/container below exists
        self._races_ref = False
        if conf.get("analysis.races"):
            _races.enable()
            self._races_ref = True
        self.is_producer = client_type == PRODUCER
        self.is_consumer = client_type == CONSUMER
        self.rep = OpQueue("rk_rep")          # app-facing reply queue
        self.ops = OpQueue("rk_ops")
        self.timers = Timers()
        self.brokers: dict[int, Broker] = {}
        self._bootstrap: list[Broker] = []
        self._brokers_lock = new_lock("kafka.brokers")
        self.topics: dict[str, Topic] = {}
        self._topics_lock = new_lock("kafka.topics")
        self._toppars: dict[tuple[str, int], Toppar] = {}
        self._toppars_lock = new_lock("kafka.toppars")
        # ACTIVE toppars: produced-to or consumer-started partitions.
        # Metadata registration alone creates Toppar objects for EVERY
        # partition of every known topic — a 100k-partition topic means
        # 100k registered toppars — so anything periodic (stats emit,
        # queued-fetch-bytes sums, the consumer serve scan) iterates
        # THIS index, O(active), never _toppars.  Guarded by
        # _toppars_lock; membership mirrored in tp.stats_active for the
        # lock-free hot-path check.
        self._active_toppars: dict[tuple[str, int], Toppar] = {}
        self.metadata: dict = {"brokers": {}, "topics": {}}
        self._metadata_lock = new_lock("kafka.metadata")
        # notified (under _metadata_lock) after every metadata cache
        # update; sync callers (list_topics, offsets_for_times leader
        # wait) block here instead of sleep-polling (reference pattern:
        # replyq pop in rd_kafka_metadata, rdkafka.c)
        self._metadata_cond = new_cond("kafka.metadata",
                                       self._metadata_lock)
        self._metadata_inflight = False
        self._metadata_refresh_queued = False
        self._metadata_full_ts = 0.0   # completion time of last FULL refresh
        self._fast_refresh_scheduled = False
        self._addr_cache: dict = {}        # broker.address.ttl DNS cache
        self._purge_epoch = 0              # invalidates in-pipeline batches
        self._metadata_topic_ts: dict = {}  # topic -> last metadata time
        self.flushing = False
        self.terminating = False
        self.fatal_error: Optional[KafkaError] = None
        # Queue accounting lives in the enqueue lane (native when the
        # extension builds): C produce() updates the counters atomically
        # under the GIL; Python paths go through lane.acct().  msg_cnt /
        # msg_bytes remain readable as properties.
        self._lane = lane_new()
        # DR ops pushed to the reply queue but not yet served to the app.
        # flush() must wait on msg_cnt + dr_cnt, like the reference's
        # rd_kafka_outq_len which counts undelivered DR ops
        # (rdkafka.c:3905) — otherwise flush() can return between the
        # msg_cnt decrement and the DR callback, losing the report to a
        # post-flush close.
        self.dr_cnt = 0
        # serializes COMPOUND transitions (msg_cnt release + dr_cnt
        # claim) against flush()'s combined read
        self._msg_cnt_lock = new_lock("kafka.msg_cnt")
        # flush() blocks here in DR-event mode; outstanding-count
        # decrements notify it only while flushing is set (one bool
        # check on the hot path, no wakeups otherwise)
        self._outq_cond = new_cond("kafka.msg_cnt", self._msg_cnt_lock)
        self.cgrp = None                       # set by Consumer
        self.consumer = None                   # back-ref set by Consumer
        # thread CPU of the consumer's poll() and consume() calls, ns,
        # counted only while tracing (CPU_ACCOUNTING.md)
        self.fetch_cpu_ns = 0
        self.interceptors = conf.get("interceptors") or None
        self.mock_cluster = None
        self.stats = None                      # StatsCollector, set below
        # flight-recorder tracing (obs/trace.py, TRACING.md): the
        # module-level tracer is refcounted — this client holds one
        # reference while trace.enable is set, released at close()
        self._trace_ref = False
        if conf.get("trace.enable"):
            _trace.enable(ring=conf.get("trace.ring.events"),
                          on_fatal=conf.get("trace.dump.on.fatal"))
            self._trace_ref = True
        self.debug_contexts = set(conf.get("debug"))
        # debug contexts force DEBUG visibility (the reference raises
        # log_level to 7 whenever debug is set, rd_kafka_conf_finalize)
        self._log_level = (7 if self.debug_contexts
                           else conf.get("log_level"))
        self.log_cb = conf.get("log_cb")
        # topic.blacklist (reference rdkafka_pattern.c blacklist list):
        # matching topics are invisible to metadata/subscriptions
        import re as _re
        self._blacklist = [_re.compile(pat if pat.startswith("^") else
                                       "^" + _re.escape(pat) + "$")
                           for pat in conf.get("topic.blacklist")]

        # native enqueue fast lane (client/arena.py): engaged per call
        # when there are no DR consumers or interceptors — produce()
        # then marshals key/value into a per-toppar native arena in one
        # C call instead of building a Message object (the app-thread
        # GIL ceiling; reference zero-allocation enqueue rdkafka_msg.c)
        self._fast_lane_ver = -1          # recompute on conf mutation
        self._fast_lane = False
        # validated (topic, partition) -> Toppar with a live arena; one
        # dict hit replaces topic lookup + partition check + toppar
        # lookup on the produce hot path
        self._fast_tp: dict = {}
        # per-reason demotion counts (stats arena.demoted breakdown)
        self._demote_reasons: dict = {}
        # the lane's C produce() is the public entry point: eligible
        # records never touch a Python frame; everything else tails into
        # _produce_slow (the Message pipeline + first-sight setup)
        self._lane.configure(
            self._produce_slow, self._wake_leader,
            conf.get("queue.buffering.max.messages"),
            conf.get("queue.buffering.max.kbytes") * 1024,
            # also capped at message.max.bytes so oversize records always
            # reach the slow path's MSG_SIZE_TOO_LARGE check
            min(conf.get("message.copy.max.bytes"),
                conf.get("message.max.bytes")))
        self.produce = self._lane.produce
        conf.add_listener(self._recompute_fast_lane)
        self._recompute_fast_lane()

        # codec provider selection (compression.backend; SURVEY.md §7 st.5)
        backend = conf.get("compression.backend")
        if backend == "gpu":
            from ..ops.gpu import GpuCodecProvider
            # gpu.device defaults to the card: a host without CUDA
            # raises here, never a silent CPU fallback
            self.codec_provider = GpuCodecProvider(
                device=conf.get("gpu.device"),
                min_batches=conf.get("gpu.launch.min.batches"),
                mesh_devices=conf.get("gpu.mesh.devices"),
                lz4_force=conf.get("gpu.lz4.force"),
                min_transport_mb_s=conf.get("gpu.transport.min.mb.s"),
                pipeline_depth=conf.get("gpu.pipeline.depth"),
                fanin_us=conf.get("gpu.pipeline.fanin.us"),
                governor=conf.get("gpu.governor"),
                warmup=conf.get("gpu.warmup"),
                compress_device=conf.get("gpu.compress.device"))
        else:
            from ..ops.cpu import CpuCodecProvider
            self.codec_provider = CpuCodecProvider()

        # transactional.id implies idempotence (the txn FSM layers over
        # the pid/epoch machinery; reference: rd_kafka_conf finalize
        # forces enable.idempotence for transactional producers)
        txn_id = conf.get("transactional.id") if self.is_producer else ""
        self.idemp = (IdempotenceManager(self)
                      if self.is_producer
                      and (conf.get("enable.idempotence") or txn_id)
                      else None)
        self.txnmgr = None
        if txn_id:
            from .txnmgr import TransactionManager
            self.txnmgr = TransactionManager(self)
            # the lane was computed before txnmgr existed; re-gate it
            # on the (UNINIT) txn state
            self._txn_lane_sync()

        # codec pipeline thread (codec.pipeline.depth; SURVEY.md §5
        # axis 2 — overlap batch build/socket IO with codec launches)
        self.codec_pipeline_depth = conf.get("codec.pipeline.depth")
        # consumer fetch codec pipeline: max _PendingFetch entries in
        # flight per broker (broker.py _serve_deferred_fetch)
        self.fetch_pipeline_depth = conf.get("gpu.fetch.pipeline.depth")
        self.codec_worker = None
        if self.is_producer and self.codec_pipeline_depth > 0:
            from .broker import CodecWorker
            self.codec_worker = CodecWorker(self)

        # OAUTHBEARER app-supplied token (set_oauthbearer_token; the
        # refresh flow of rdkafka_sasl_oauthbearer.c's
        # RD_KAFKA_OP_OAUTHBEARER_REFRESH machinery)
        self._oauth_token = None      # (token, principal, expiry_unix)
        self._oauth_failure = None
        self._oauth_timer = None
        self._oauth_cb_lock = new_lock("kafka.oauth_cb")

        # TLS context — one per instance, shared by all broker threads
        # (reference: rd_kafka_ssl_ctx_init, rdkafka_ssl.c)
        from . import tls as _tls
        self._ssl_ctx = _tls.make_client_ctx(conf)

        # SASL mechanism validation happens at client creation so a
        # misconfigured mechanism fails fast (reference: rd_kafka_new
        # sasl checks, rdkafka.c:~2000)
        if self.sasl_required():
            from .sasl import kinit_setup, validate_mechanism
            validate_mechanism(conf)
            # GSSAPI: run sasl.kerberos.kinit.cmd now + on the relogin
            # timer (reference: rd_kafka_sasl_cyrus_kinit_refresh)
            kinit_setup(self)

        from .stats import StatsCollector
        self.stats = StatsCollector(self)

        # legacy file offset store (offset.store.method=file)
        self.offset_store = None
        if self.is_consumer:
            from .offset_store import FileOffsetStore
            self.offset_store = FileOffsetStore(self)

        # optional background event thread (rdkafka_background.c:109,
        # created at rd_kafka_new rdkafka.c:2189-2196)
        self.background = None
        bg_cb = conf.get("background_event_cb")
        if bg_cb is not None:
            from .event import BackgroundThread
            self.background = BackgroundThread(self, bg_cb)

        # implicit mock cluster (test.mock.num.brokers)
        nmock = conf.get("test.mock.num.brokers")
        bootstrap = conf.get("bootstrap.servers")
        if nmock > 0 and not bootstrap:
            from ..mock.cluster import MockCluster
            self.mock_cluster = MockCluster(
                num_brokers=nmock,
                default_partitions=conf.get("test.mock.default.partitions"))
            bootstrap = self.mock_cluster.bootstrap_servers()
        if not bootstrap:
            raise KafkaException(Err._INVALID_ARG,
                                 "bootstrap.servers not configured")

        # plugins (plugin.library.paths; reference rdkafka_plugin.c —
        # each entry's conf_init() registers interceptors)
        plugin_paths = conf.get("plugin.library.paths")
        if plugin_paths:
            from .interceptor import load_plugins
            self.interceptors = load_plugins(plugin_paths, conf)
            conf.set("interceptors", self.interceptors)

        # interceptors on_new
        if self.interceptors:
            self.interceptors.on_new(self)

        nodeid = -1
        for hp in bootstrap.split(","):
            host, _, port = hp.strip().rpartition(":")
            b = Broker(self, nodeid, host, int(port),
                       name=f"{host}:{port}/bootstrap")
            self._bootstrap.append(b)
            self.brokers[nodeid] = b
            nodeid -= 1

        # timers (reference main loop rdkafka.c:1877-1886)
        refresh = conf.get("topic.metadata.refresh.interval.ms")
        if refresh > 0:
            self.timers.add(refresh / 1000.0,
                            lambda: self.metadata_refresh("periodic"))
        self.timers.add(1.0, self._scan_msg_timeouts)
        stats_ival = conf.get("statistics.interval.ms")
        self._stats_timer = None
        if stats_ival > 0:
            self._stats_timer = self.timers.add(stats_ival / 1000.0,
                                                self._emit_stats)
            # process-wide registry: the conftest leak fixture fails any
            # test whose client left its stats emitter registered
            from .stats import _ACTIVE_STATS_TIMERS
            _ACTIVE_STATS_TIMERS.add(id(self._stats_timer))

        self._main = threading.Thread(target=self._thread_main,
                                      name="rdk:main", daemon=True)
        self._main.start()
        for b in self._bootstrap:
            b.start()
        self.metadata_refresh("bootstrap")

    # ------------------------------------------------------------ logging --
    _LOG_LEVELS = {"EMERG": 0, "ALERT": 1, "CRIT": 2, "ERROR": 3,
                   "WARN": 4, "NOTICE": 5, "INFO": 6, "DEBUG": 7}

    def log(self, level: str, msg: str):
        # numeric syslog-style filter (reference log_level, default 6)
        if self._LOG_LEVELS.get(level, 6) > self._log_level:
            return
        # log.thread.name: tag messages with the emitting thread exactly
        # like the reference's "[thrd:...]" prefix (rdlog.c)
        if self.conf.get("log.thread.name"):
            msg = f"[thrd:{threading.current_thread().name}] {msg}"
        # log.queue: logs become LOG events served from the app-facing
        # queue (poll/queue_poll) instead of synchronous output — the
        # log_cb then fires on the POLLING thread (reference
        # rd_kafka_conf "log.queue" + rd_kafka_set_log_queue)
        if self.conf.get("log.queue"):
            self.rep.push(Op(OpType.LOG, payload=(level, "rdkafka", msg)))
            return
        if self.log_cb:
            self.log_cb(level, "rdkafka", msg)
        elif level in ("ERROR", "WARN"):
            print(f"%{level}|rdkafka| {msg}", file=sys.stderr)

    def dbg(self, ctx: str, msg: str):
        if ctx in self.debug_contexts or "all" in self.debug_contexts:
            self.log("DEBUG", f"[{ctx}] {msg}")

    # -------------------------------------------------------- main thread --
    def _thread_main(self):
        if self.interceptors:
            self.interceptors.on_thread_start("main", "rdk:main")
        while not self.terminating:
            timeout = self.timers.next_timeout(0.1)
            op = self.ops.pop(timeout)
            if op is not None:
                self._op_serve(op)
            self.timers.run()
            if self.idemp and self.txnmgr is None:
                # transactional pids are acquired ONLY through
                # init_transactions (the txnmgr owns the epoch
                # lifecycle); the idempotence FSM must not race it with
                # a non-transactional InitProducerId
                self.idemp.serve()
            if self.txnmgr is not None:
                self.txnmgr.serve()
            if self.cgrp:
                self.cgrp.serve()
        if self.interceptors:
            self.interceptors.on_thread_exit("main", "rdk:main")

    def _op_serve(self, op: Op):
        if op.cb:
            op.cb(op)

    # ----------------------------------------------------------- metadata --
    def blacklisted(self, topic: str) -> bool:
        return any(p.search(topic) for p in self._blacklist)

    def any_up_broker(self) -> Optional[Broker]:
        with self._brokers_lock:
            ups = [b for b in self.brokers.values() if b.is_up()]
        return random.choice(ups) if ups else None

    def metadata_refresh(self, reason: str = "",
                         all_topics: bool = False,
                         topics: Optional[list] = None):
        """``topics`` is an interest HINT: the caller knows these
        specific topics need fresh metadata (fetch/produce errors, new
        topic registration) — they bypass the interest-only freshness
        debounce below."""
        if self.terminating:
            return
        if self._metadata_inflight:
            # queue one follow-up so a refresh requested mid-flight (e.g.
            # regex discovery racing a sparse refresh) is not lost until
            # the periodic timer (reference: rd_kafka_metadata_refresh
            # coalescing)
            self._metadata_refresh_queued = True
            return
        b = self.any_up_broker()
        if b is None:
            # will be retried when a broker comes up (broker_state_change)
            return
        self._metadata_inflight = True
        sparse = self.conf.get("topic.metadata.refresh.sparse")
        interest_only = self.conf.get("topic.metadata.interest.only")
        with self._topics_lock:
            names = list(self.topics) if sparse else None
        if names is not None and topics:
            names = list(dict.fromkeys([*names, *topics]))
        if names == [] and not interest_only:
            # legacy shape: an empty interest set falls back to a full
            # sweep; interest-only keeps it empty — a brokers-only
            # request (Metadata v1+ empty topic array = no topics)
            names = None
        if all_topics or reason == "periodic":
            # full enumeration: list_topics, and the periodic refresh —
            # the ONE recurring full sweep interest-only keeps (deleted-
            # topic pruning + regex discovery happen here)
            names = None
        if self.cgrp is not None and self.cgrp.patterns:
            # regex subscriptions need the full cluster topic list
            names = None
        if interest_only and names:
            # per-topic staleness debounce: a topic whose metadata just
            # landed isn't re-requested by an unrelated trigger (bursts
            # of "new topic" refreshes re-listing the whole interest set
            # were O(topics²) on the wire).  Hinted topics and anything
            # older than half the fast-refresh interval pass — the
            # leaderless fast path (250ms) always re-polls.
            cutoff = self.conf.get(
                "topic.metadata.refresh.fast.interval.ms") / 1000.0 * 0.5
            hint = set(topics or ())
            now0 = time.monotonic()
            with self._metadata_lock:
                names = [t for t in names if t in hint
                         or now0 - self._metadata_topic_ts.get(t, 0.0)
                         >= cutoff]
            if not names and hint:
                names = list(hint)
        # metadata.max.age.ms: expire cache entries past their age
        # (reference rdkafka_metadata_cache.c:289). Existing toppar
        # leader delegation is updated by the refresh RESPONSE
        # (_assign_toppar_leader); the expiry only keeps get_toppar and
        # admin list_topics from reading decayed entries meanwhile
        max_age = self.conf.get("metadata.max.age.ms") / 1000.0
        now = time.monotonic()
        with self._metadata_lock:
            for name, ts in list(self._metadata_topic_ts.items()):
                if now - ts > max_age:
                    self.metadata["topics"].pop(name, None)
                    del self._metadata_topic_ts[name]
        self.dbg("metadata", f"refresh ({reason}) via {b.name}")
        # ONLY a null topic array is a full enumeration (Metadata v1+:
        # null = all topics, [] = none — the mock used to conflate the
        # two); [] is a brokers-only liveness probe and must not prune
        full = names is None
        b.enqueue_request(Request(
            ApiKey.Metadata,
            # v4+ carries the auto-creation flag: producers may trigger
            # broker-side topic creation, consumers only when
            # allow.auto.create.topics (KIP-204; reference
            # rd_kafka_MetadataRequest). Older negotiated versions
            # simply don't serialize the key.
            {"topics": names,
             "allow_auto_topic_creation":
                 self.is_producer or
                 bool(self.conf.get("allow.auto.create.topics"))},
            retries_left=2,
            abs_timeout=time.monotonic() +
            self.conf.get("metadata.request.timeout.ms") / 1000.0,
            cb=lambda e, r: self._handle_metadata(e, r, full=full)))

    def _handle_metadata(self, err, resp, full: bool = False):
        self._metadata_inflight = False
        if self._metadata_refresh_queued:
            self._metadata_refresh_queued = False
            self.timers.add(0.05, lambda: self.metadata_refresh("queued"),
                            once=True)
        if err is not None:
            return
        with self._metadata_lock:
            new_brokers = {b["node_id"]: (b["host"], b["port"])
                           for b in resp["brokers"]}
            self.metadata["brokers"] = new_brokers
            self.metadata["controller_id"] = resp.get("controller_id", -1)
            cid = resp.get("cluster_id")
            if cid:
                self.metadata["cluster_id"] = cid
            seen = set()
            failed_topics = []
            for t in resp["topics"]:
                if self.blacklisted(t["topic"]):
                    continue
                terr = Err.from_wire(t["error_code"])
                if terr == Err.UNKNOWN_TOPIC_OR_PART:
                    # topic deleted: drop it from the cache
                    self.metadata["topics"].pop(t["topic"], None)
                    continue
                if terr in (Err.TOPIC_EXCEPTION,
                            Err.TOPIC_AUTHORIZATION_FAILED):
                    # permanent: parked messages must fail NOW, not at
                    # message.timeout.ms (reference: metadata topic err
                    # → rd_kafka_topic_metadata_update NOTEXISTS → DR
                    # failures; tests 0057-invalid_topic analog)
                    self.metadata["topics"].pop(t["topic"], None)
                    failed_topics.append((t["topic"], terr))
                    continue
                if terr != Err.NO_ERROR:
                    # transient (e.g. LEADER_NOT_AVAILABLE during
                    # election): the topic still exists — keep it in
                    # `seen` so prune/regex don't treat it as deleted
                    seen.add(t["topic"])
                    continue
                seen.add(t["topic"])
                self.metadata["topics"][t["topic"]] = {
                    p["partition"]: p["leader"] for p in t["partitions"]}
                self._metadata_topic_ts[t["topic"]] = time.monotonic()
            if full:
                # a full metadata response enumerates every topic: prune
                # cache entries that vanished (deleted topics)
                for name in list(self.metadata["topics"]):
                    if name not in seen:
                        del self.metadata["topics"][name]
            if full:
                # stamped AFTER the cache update, inside the lock:
                # list_topics waits on this to take a coherent snapshot
                self._metadata_full_ts = time.monotonic()
            self._metadata_cond.notify_all()
        for name, terr in failed_topics:
            if self.is_producer:
                self._fail_topic(name, KafkaError(terr, retriable=False))
            else:
                # consumers: surface the permanent topic error as an
                # error event (reference delivers
                # ERR_TOPIC_AUTHORIZATION_FAILED to the app); fetching
                # for the topic stops with the cache entry gone.
                # NOTE: with topic.metadata.refresh.sparse=false the
                # full enumeration never names an invalid topic, so
                # this path needs the (default) sparse refresh; the
                # non-sparse fallback is message.timeout.ms, matching
                # the reference's behavior there.
                self.op_err(KafkaError(
                    terr, f"topic {name!r}: permanent metadata error",
                    retriable=False))
        if self.cgrp is not None:
            # subscription re-evaluation (rdkafka_pattern.c; literal
            # arrival counts on sparse updates too — a topic created
            # after subscribe() must rejoin the group when its
            # per-topic metadata lands, rdkafka_cgrp.c:3412)
            self.cgrp.metadata_update(seen, full=full)
        # leaderless partitions (election in progress): re-query on the
        # fast interval (topic.metadata.refresh.fast.interval.ms;
        # reference rd_kafka_metadata_refresh fast path)
        leaderless = any(
            p["leader"] < 0
            for t in resp["topics"] if t["error_code"] == 0
            for p in t["partitions"])
        if leaderless and not self._fast_refresh_scheduled:
            self._fast_refresh_scheduled = True
            fast = self.conf.get(
                "topic.metadata.refresh.fast.interval.ms") / 1000.0

            def _fast_refresh():
                self._fast_refresh_scheduled = False
                self.metadata_refresh("fast")

            self.timers.add(fast, _fast_refresh, once=True)
        # instantiate broker threads for newly discovered nodes — none
        # once close() began: it sets terminating, then snapshots the
        # brokers under this lock to stop them, so a broker added after
        # that snapshot would serve on forever
        with self._brokers_lock:
            for nid, (host, port) in new_brokers.items():
                if nid not in self.brokers and not self.terminating:
                    b = Broker(self, nid, host, port)
                    self.brokers[nid] = b
                    b.start()
        # update topic partition counts + migrate UA messages + leaders
        for t in resp["topics"]:
            name = t["topic"]
            topic = self.topics.get(name)
            if topic is not None:
                with topic.lock:
                    topic.partition_cnt = len(t["partitions"])
                # partition count changed ⇒ the lane's cached native
                # auto-partition entry is stale; drop it and let the
                # next produce() re-register via _fast_partition
                self._lane.part_del(name)
                if self.is_producer:
                    self._fail_unknown_partitions(name, len(t["partitions"]))
            for p in t["partitions"]:
                if p["leader"] < 0:
                    continue
                tp = self.get_toppar(name, p["partition"],
                                     create=(topic is not None))
                if tp is not None:
                    self._assign_toppar_leader(tp, p["leader"])
        self._migrate_ua_msgs()
        # second notify AFTER toppar leader assignment: waiters whose
        # predicate is tp.leader_id >= 0 (offsets_for_times) observe the
        # assignment, not just the raw cache update above
        with self._metadata_cond:
            self._metadata_cond.notify_all()

    def list_topics(self, timeout: float = 10.0) -> dict:
        """Synchronous full-metadata snapshot: {brokers, controller_id,
        topics: {topic: {partition: leader}}} (rd_kafka_metadata)."""
        deadline = time.monotonic() + timeout
        t0 = time.monotonic()
        self.metadata_refresh("list_topics", all_topics=True)
        while time.monotonic() < deadline:
            # wait for a FULL refresh completed at/after this call; the
            # 0.5s cap re-issues it in case the first raced broker
            # bring-up and was dropped
            if self.metadata_wait(
                    lambda: self._metadata_full_ts >= t0,
                    min(0.5, max(0.0, deadline - time.monotonic()))):
                with self._metadata_lock:
                    md = self.metadata
                    return {"brokers": dict(md["brokers"]),
                            "controller_id": md.get("controller_id", -1),
                            "topics": {t: dict(ps)
                                       for t, ps in md["topics"].items()}}
            self.metadata_refresh("list_topics retry", all_topics=True)
        raise KafkaException(Err._TIMED_OUT, "metadata not available")

    def cluster_id(self, timeout: float = 5.0) -> Optional[str]:
        """Cluster id from metadata (reference rd_kafka_clusterid;
        Metadata v2+ carries it). None when unknown within timeout."""
        if self.metadata.get("cluster_id") is None:
            self.metadata_refresh("clusterid")
            self.metadata_wait(
                lambda: self.metadata.get("cluster_id") is not None,
                timeout)
        return self.metadata.get("cluster_id")

    def controller_id(self, timeout: float = 5.0) -> int:
        """Controller broker id (reference rd_kafka_controllerid);
        -1 when unknown within timeout."""
        if self.metadata.get("controller_id", -1) < 0:
            self.metadata_refresh("controllerid")
            self.metadata_wait(
                lambda: self.metadata.get("controller_id", -1) >= 0,
                timeout)
        return self.metadata.get("controller_id", -1)

    def metadata_wait(self, predicate, timeout: float) -> bool:
        """Block until ``predicate()`` holds or ``timeout`` elapses,
        waking on every metadata cache update (condvar, no polling)."""
        deadline = time.monotonic() + timeout
        with self._metadata_cond:
            while not predicate():
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._metadata_cond.wait(remain)
            return True

    def _assign_toppar_leader(self, tp: Toppar, leader: int):
        if tp.leader_id == leader:
            return
        # a leadership change invalidates any follower delegation
        # (reference resets the fetch broker on leader updates)
        self.revoke_fetch_delegation(tp, "leader change")
        old = tp.leader_id
        tp.leader_id = leader
        with self._brokers_lock:
            if old in self.brokers:
                self.brokers[old].remove_toppar(tp)
            if leader in self.brokers:
                self.brokers[leader].add_toppar(tp)
        self.dbg("topic", f"{tp}: leader {old} -> {leader}")

    # ------------------------------------------ KIP-392 follower fetch --
    def delegate_fetch(self, tp: Toppar, broker_id: int) -> None:
        """Move a partition's FETCH traffic to a follower replica the
        broker nominated via preferred_read_replica (Fetch v11;
        reference: rd_kafka_fetch_preferred_replica_handle,
        rdkafka_broker.c:3921). Producing still targets the leader."""
        if tp.fetch_broker_id == broker_id or broker_id == tp.leader_id:
            if broker_id == tp.leader_id:
                self.revoke_fetch_delegation(tp, "leader nominated")
            return
        with self._brokers_lock:
            b = self.brokers.get(broker_id)
            if b is None:
                # unknown replica: our metadata is stale — back the fetch
                # off so the leader's record-less redirects don't hot-loop
                # (reference: rd_kafka_fetch_preferred_replica_handle).
                # The refresh itself happens below, after the lock is
                # released: metadata_refresh → any_up_broker re-acquires
                # _brokers_lock, which is non-reentrant.
                tp.fetch_backoff_until = time.monotonic() + \
                    self.conf.get("fetch.error.backoff.ms") / 1000.0
            else:
                old = tp.fetch_broker_id
                tp.fetch_broker_id = broker_id
                if old is not None and old != tp.leader_id \
                        and old in self.brokers:
                    self.brokers[old].remove_toppar(tp)
                b.add_toppar(tp)
        if b is None:
            self.metadata_refresh(
                reason=f"unknown preferred replica {broker_id}")
            return
        self.dbg("fetch",
                 f"{tp}: fetching from follower {broker_id} "
                 f"(leader {tp.leader_id})")

    def revoke_fetch_delegation(self, tp: Toppar, reason: str) -> None:
        with self._brokers_lock:     # fetch_broker_id writes stay
            old = tp.fetch_broker_id  # ordered vs delegate_fetch
            if old is None:
                return
            tp.fetch_broker_id = None
            if old != tp.leader_id and old in self.brokers:
                self.brokers[old].remove_toppar(tp)
            leader = self.brokers.get(tp.leader_id)
            if leader is not None:
                leader._wakeup()
        self.dbg("fetch", f"{tp}: back to leader fetch ({reason})")

    def _fail_topic(self, name: str, kerr: KafkaError) -> None:
        """Fail every message queued for ``name`` — UA-parked and
        per-toppar alike (permanent metadata topic errors:
        INVALID_TOPIC, TOPIC_AUTHORIZATION_FAILED)."""
        with self._topics_lock:
            topic = self.topics.get(name)
        if topic is not None:
            with topic.lock:
                msgs = list(topic.ua_msgq)
                topic.ua_msgq.clear()
            if msgs:
                self.dr_msgq(msgs, kerr)   # dr_msgq stamps m.error
        self._fail_unknown_partitions(name, 0, kerr)

    def _fail_unknown_partitions(self, topic: str, cnt: int,
                                 kerr: Optional[KafkaError] = None):
        """Error-DR messages parked on partitions beyond the topic's real
        partition count (reference: rd_kafka_topic_partition_cnt_update →
        UNKNOWN_PARTITION delivery failures, rdkafka_topic.c). ``kerr``
        overrides the default unknown-partition error (permanent topic
        errors fail with their own code)."""
        with self._toppars_lock:
            tps = [tp for (t, p), tp in self._toppars.items()
                   if t == topic and p >= cnt]
        for tp in tps:
            self._fast_tp.pop((tp.topic, tp.partition), None)
            self._lane.map_del(tp.topic, tp.partition)
            failed: list[Message] = []
            fast_cnt = fast_bytes = 0
            dr_wanted = self._dr_out_wanted()
            with tp.lock:
                failed.extend(tp.msgq)
                tp.msgq.clear()
                tp.msgq_bytes = 0
                failed.extend(tp.xmit_msgq)
                tp.xmit_msgq.clear()
                for b in tp.retry_batches:
                    if not isinstance(b, ArenaBatch):
                        failed.extend(b)
                    elif dr_wanted:   # dr_msgq accounts materialized msgs
                        failed.extend(b.to_messages(tp.topic, tp.partition))
                    else:
                        fast_cnt += b.count
                        fast_bytes += b.nbytes
                tp.retry_batches.clear()
                if tp.arena is not None:
                    if dr_wanted:
                        for k, v, mts, hb in tp.arena.drain_records():
                            failed.append(Message(
                                tp.topic, value=v, key=k,
                                partition=tp.partition, timestamp=mts,
                                headers=decode_hblob(hb) if hb else ()))
                    else:
                        c, nb = tp.arena.clear()
                        fast_cnt += c
                        fast_bytes += nb
            if fast_cnt:
                self._lane.acct(-fast_cnt, -fast_bytes)
            if failed:
                self.dr_msgq(failed, kerr or KafkaError(
                    Err._UNKNOWN_PARTITION,
                    f"{tp}: partition does not exist"))

    def _migrate_ua_msgs(self):
        with self._topics_lock:
            topics = list(self.topics.values())
        for topic in topics:
            with topic.lock:
                if topic.partition_cnt <= 0 or not topic.ua_msgq:
                    continue
                msgs, topic.ua_msgq = topic.ua_msgq, deque()
            for m in msgs:
                self._partition_and_enq(topic, m)

    # -------------------------------------------------------------- topics --
    def get_topic(self, name: str) -> Topic:
        created = False
        with self._topics_lock:
            t = self.topics.get(name)
            if t is None:
                t = Topic(name, self.conf.topic_conf())
                self.topics[name] = t
                created = True
        if created:
            # outside _topics_lock: metadata_refresh re-acquires it
            self.metadata_refresh(f"new topic {name}")
        return t

    def topic_conf_for(self, name: str) -> TopicConf:
        with self._topics_lock:
            t = self.topics.get(name)
        return t.conf if t else self.conf.topic_conf()

    def set_topic_conf(self, name: str, conf: dict) -> None:
        """Per-topic configuration (the rd_kafka_topic_new(rk, name,
        topic_conf) analog, reference rdkafka_topic.c): applies on top
        of the default topic conf for this topic only."""
        t = self.get_topic(name)
        t.conf.update(conf)
        if "partitioner" in conf or "partitioner_cb" in conf:
            t.partitioner = partitioner_fn(t.conf.get("partitioner"))
            # invalidate the lane's cached native auto-partition entry;
            # the next UA produce re-registers via _fast_partition
            self._lane.part_del(name)

    def get_toppar(self, topic: str, partition: int,
                   create: bool = True) -> Optional[Toppar]:
        key = (topic, partition)
        with self._toppars_lock:
            tp = self._toppars.get(key)
            if tp is None and create:
                tp = Toppar(topic, partition)
                self._toppars[key] = tp
                with self._metadata_lock:
                    leader = self.metadata["topics"].get(topic, {}).get(partition)
                if leader is not None and leader >= 0:
                    self._assign_toppar_leader(tp, leader)
            return tp

    # ------------------------------------------------------------ produce --
    @property
    def msg_cnt(self) -> int:
        return self._lane.msg_cnt

    @property
    def msg_bytes(self) -> int:
        return self._lane.msg_bytes

    def _produce_slow(self, topic: str, value=None, key=None,
                      partition=PARTITION_UA, on_delivery=None, timestamp=0,
                      headers=(), opaque=None) -> None:
        """The Message-path produce (and the fast lane's first-sight
        setup).  The PUBLIC entry point is ``self.produce`` — the native
        Lane.produce (enqlane.cpp), which handles every eligible record
        in one C call and tail-calls here for the rest."""
        # positional order matches the confluent-style public API
        # (topic, value, key, partition, on_delivery, timestamp, headers)
        if _trace.enabled:
            # the produce()-enqueue anchor of the producer span chain
            # (fast-lane records never enter a Python frame; their
            # first-sight setup passes through here)
            _trace.instant("produce", "enqueue",
                           {"topic": topic, "partition": partition})
        if isinstance(value, str):
            value = value.encode()
        if isinstance(key, str):
            key = key.encode()
        if self.fatal_error:
            raise KafkaException(self.fatal_error)
        if self.txnmgr is not None and self.txnmgr.state != "IN_TXN":
            # transactional producers may only produce inside a
            # transaction (reference: rd_kafka_produce ERR__STATE gate)
            raise KafkaException(
                Err._STATE,
                f"produce() requires an ongoing transaction "
                f"(state {self.txnmgr.state}; call begin_transaction)")
        sz = (len(value) if value else 0) + (len(key) if key else 0)
        # reference: rd_kafka_msg_new0 rejects oversize messages up
        # front with MSG_SIZE_TOO_LARGE (test 0003-msgmaxsize)
        if sz > self.conf.get("message.max.bytes"):
            raise KafkaException(
                Err.MSG_SIZE_TOO_LARGE,
                f"message size {sz} exceeds message.max.bytes "
                f"{self.conf.get('message.max.bytes')}")
        # lock keeps check+claim atomic on this Python path (the C lane
        # does both inside one GIL-atomic call)
        with self._msg_cnt_lock:
            if self._lane.full(sz):
                raise KafkaException(Err._QUEUE_FULL,
                                     "producer queue is full")
            self._lane.acct(1, sz)
        # native enqueue fast lane: no Message object, one C call into
        # the per-toppar arena (queue accounting above is shared;
        # _fast_lane stays fresh via the conf.add_listener hook).
        # Widened eligibility: explicit timestamps ride a side
        # int64 array, headers pre-encode into a wire blob here (the
        # framer memcpys it), and PARTITION_UA engages via the native
        # murmur2 map when the topic's partitioner is murmur2-family.
        if (self._fast_lane and on_delivery is None and opaque is None
                and (value is None or type(value) is bytes)
                and (key is None or type(key) is bytes)
                and type(timestamp) is int and timestamp >= 0):
            hblob = encode_headers(headers) if headers else None
            if not headers or hblob is not None:
                if partition >= 0:
                    if self._produce_fast(topic, key, value, partition,
                                          sz, timestamp, hblob):
                        return
                elif partition == PARTITION_UA:
                    p = self._fast_partition(topic, key)
                    if (p >= 0
                            and self._produce_fast(topic, key, value, p,
                                                   sz, timestamp, hblob)):
                        return
        m = Message(topic, value=value, key=key, partition=partition,
                    headers=headers, timestamp=timestamp, opaque=opaque)
        if on_delivery is not None:
            m.on_delivery = on_delivery   # per-message DR callback
        if self.interceptors:
            self.interceptors.on_send(m)
        # lock-free fast path: dict reads are atomic under the GIL; fall
        # back to the locked creation path on first sight of a topic
        t = self.topics.get(topic)
        if t is None:
            t = self.get_topic(topic)
        if partition == PARTITION_UA:
            with t.lock:
                if t.partition_cnt <= 0:
                    t.ua_msgq.append(m)     # park until metadata
                    return
            self._partition_and_enq(t, m)
        else:
            cnt = t.partition_cnt       # int read: GIL-atomic, no lock
            if 0 < cnt <= partition:
                # known-invalid partition fails at produce() time
                # (reference: rd_kafka_msg_partitioner → UNKNOWN_PARTITION)
                self._lane.acct(-1, -sz)
                raise KafkaException(
                    Err._UNKNOWN_PARTITION,
                    f"{topic}[{partition}]: partition does not exist")
            tp = self._toppars.get((topic, partition))
            if tp is None:
                tp = self.get_toppar(topic, partition)
            if tp.arena_ok:
                # Message path claims this toppar (shape-ineligible
                # produce: interceptors, on_delivery/opaque, str value
                # kept as Message, oversize, ...)
                self._demote(tp, "ineligible")
            if tp.enq_msg(m):
                self._wake_leader(tp)

    def _recompute_fast_lane(self) -> None:
        conf = self.conf
        # DR consumers (dr_msg_cb / dr_cb / "dr" events / background)
        # no longer disable the lane: delivery reports materialize
        # Message objects from the arena run at DR time (dr_msgq), so
        # produce() stays on the zero-alloc path — the reference's
        # headline throughput runs WITH dr_msg_cb set. Interceptors
        # still force the Message path: on_send must fire per message
        # at produce() time.  Transactional producers ride the lane
        # too, but only while produce() is legal — the C entry point
        # cannot check the in-transaction state gate itself, so the
        # txn FSM toggles lane.enabled at every transition
        # (_txn_lane_sync); outside IN_TXN the tail-call into
        # _produce_slow raises the reference's ERR__STATE.
        self._fast_lane = (self.is_producer and not self.interceptors)
        self._fast_lane_ver = getattr(conf, "version", 0)
        # the C entry consults this flag before touching an arena; a
        # conf.set that adds a DR consumer flips it via the listener
        self._txn_lane_sync()

    def _txn_lane_sync(self) -> None:
        """Recompute the native lane's enable flag from the fast-lane
        eligibility AND the txn FSM (transactional producers may only
        fast-enqueue while IN_TXN)."""
        txnmgr = getattr(self, "txnmgr", None)
        try:
            self._lane.enabled = (
                1 if self._fast_lane
                and (txnmgr is None or txnmgr.state == "IN_TXN")
                else 0)
        except AttributeError:
            pass                        # lane not constructed yet

    def _fast_partition(self, topic: str, key) -> int:
        """Auto-partition for the fast lane: murmur2-family partitioners
        compute natively-reproducible partitions (bit-exact vs
        utils/hash.murmur2), so PARTITION_UA produces stay eligible.
        Registers (partition_cnt, mode) with the C lane so subsequent
        UA produces never enter a Python frame.  Returns -1 (fall back
        to the Message path / Python partitioner) for partitioner_cb,
        non-murmur2 partitioners, unknown partition counts, and
        murmur2_random with a falsy key (random must stay Python's
        RNG)."""
        t = self.topics.get(topic)
        if t is None:
            t = self.get_topic(topic)
        if t.conf.get("partitioner_cb"):
            return -1
        mode = {"murmur2": 1,
                "murmur2_random": 2}.get(t.conf.get("partitioner"), 0)
        cnt = t.partition_cnt           # int read: GIL-atomic, no lock
        if mode == 0 or cnt <= 0:
            return -1
        self._lane.part_set(topic, cnt, mode)
        if mode == 2 and not key:
            return -1                   # falsy key → random partitioner
        return murmur2_partition(key or b"", cnt)

    def _produce_fast(self, topic: str, key, value, partition: int,
                      sz: int, timestamp: int = 0, hblob=None) -> bool:
        """Fast-lane enqueue; False = caller falls back to the Message
        path (queue accounting stays — both paths share it)."""
        tp = self._fast_tp.get((topic, partition))
        if tp is not None:
            if not tp.arena_ok:         # demoted since caching
                return False
            if tp.arena.append(key, value, timestamp, hblob) == 1:
                self._wake_leader(tp)   # wake on empty→non-empty only
            return True
        # ---- first sight: validate, create the arena, cache ------------
        t = self.topics.get(topic)
        if t is None:
            t = self.get_topic(topic)
        cnt = t.partition_cnt
        if 0 < cnt <= partition:
            self._lane.acct(-1, -sz)
            raise KafkaException(
                Err._UNKNOWN_PARTITION,
                f"{topic}[{partition}]: partition does not exist")
        tp = self._toppars.get((topic, partition))
        if tp is None:
            tp = self.get_toppar(topic, partition)
        if not tp.arena_ok:
            # cache the demoted toppar too: the next eligible produce
            # short-circuits on one dict hit instead of re-running the
            # topic/partition/toppar lookups before falling back
            self._fast_tp[(topic, partition)] = tp
            return False
        a = tp.arena
        if a is None:
            with tp.lock:
                if tp.arena is None and tp.arena_ok:
                    tp.arena = arena_new()
                a = tp.arena
            if a is None:               # extension unavailable: demote
                tp.arena_ok = False
                self._fast_tp[(topic, partition)] = tp
                return False
        self._fast_tp[(topic, partition)] = tp
        # register with the C entry point: subsequent produces for this
        # toppar never enter a Python frame (map_set keeps the lane's
        # last-topic lookup cache coherent — never mutate map directly)
        self._lane.map_set(topic, partition, (a, tp))
        if a.append(key, value, timestamp, hblob) == 1:
            self._wake_leader(tp)
        return True

    def _partition_and_enq(self, topic: Topic, m: Message):
        pcb = topic.conf.get("partitioner_cb")
        if pcb:
            m.partition = pcb(m.key, topic.partition_cnt)
        else:
            m.partition = topic.partitioner(m.key, topic.partition_cnt)
        tp = self._toppars.get((topic.name, m.partition))
        if tp is None:
            tp = self.get_toppar(topic.name, m.partition)
        if tp.arena_ok:
            # a Python-partitioned message (random/consistent family,
            # partitioner_cb, or murmur2_random falsy key) claims this
            # toppar for the Message path
            self._demote(tp, "partitioner")
        if tp.enq_msg(m):
            self._wake_leader(tp)

    def _demote(self, tp: Toppar, reason: str = "ineligible") -> None:
        """Permanently route a toppar through the Message path: remove
        it from the C entry's map FIRST so no new fast-lane records land
        while the arena drains into the msgq (FIFO preserved).
        ``reason`` feeds the stats ``arena.demoted`` breakdown."""
        key = (tp.topic, tp.partition)
        self._lane.map_del(tp.topic, tp.partition)
        self._fast_tp.pop(key, None)
        with self._msg_cnt_lock:
            self._demote_reasons[reason] = (
                self._demote_reasons.get(reason, 0) + 1)
        tp.demote_arena()

    def _wake_leader(self, tp: Toppar):
        # every wake means "this toppar has work" (first produce enqueue,
        # fetcher start, retry) — the cheapest correct hook for the
        # O(active) index; consumer _stop_partitions deactivates
        if not tp.stats_active:
            self.toppar_set_active(tp, True)
        with self._brokers_lock:
            b = self.brokers.get(tp.leader_id)
        if b is not None:
            b.ops.push(Op(OpType.BROKER_WAKEUP))

    def toppar_set_active(self, tp: Toppar, active: bool) -> None:
        """Add/remove ``tp`` from the active-toppar index (stats emit,
        fetch-serve and queue-budget scans iterate only this set)."""
        with self._toppars_lock:
            if active:
                self._active_toppars[(tp.topic, tp.partition)] = tp
            else:
                self._active_toppars.pop((tp.topic, tp.partition), None)
            tp.stats_active = active

    def active_toppars(self) -> list[Toppar]:
        """Snapshot of the active toppars (O(active), not O(registered))."""
        with self._toppars_lock:
            return list(self._active_toppars.values())

    # ------------------------------------------------------------ DR path --
    def _dr_out_wanted(self) -> bool:
        """Is anyone consuming delivery reports? (dr callback, "dr"
        events, or the background event thread)"""
        conf = self.conf
        return bool(conf.get("dr_msg_cb") or conf.get("dr_cb")
                    or conf.get("dr_batch_cb")
                    or "dr" in conf.get("enabled_events")
                    or self.background is not None)

    def dr_msgq(self, msgs, err: Optional[KafkaError],
                tp=None, base_offset: int = -1):
        """Queue delivery reports (reference: rd_kafka_dr_msgq,
        rdkafka_broker.c:2432).  Accepts list[Message] or a fast-lane
        ArenaBatch.  With no DR consumer an ArenaBatch resolves to pure
        queue accounting; with one, its records materialize into
        Message objects HERE — at delivery-report time, off the
        produce() path — carrying ``tp``'s topic/partition and offsets
        from ``base_offset`` (successful batches)."""
        if err is not None and self.txnmgr is not None:
            # a failed message inside a transaction makes it abortable
            # (reference: rd_kafka_txn_set_abortable_error from the DR
            # path); purge DRs during abort are exempt inside msg_failed
            self.txnmgr.msg_failed(err)
        if self.stats and err is None:
            # stats txmsgs: acked produces (rdkafka.c txmsgs analog;
            # bumped on every acked produce).  Counted before the fast-lane
            # branch so pure-accounting ArenaBatch resolutions (no DR
            # consumer) are included.
            self.stats.add_tx(msgs.count if isinstance(msgs, ArenaBatch)
                              else len(msgs))
        batch_nbytes = None
        if isinstance(msgs, ArenaBatch):
            if self._dr_out_wanted():
                st = (MsgStatus.PERSISTED if err is None
                      else MsgStatus.POSSIBLY_PERSISTED
                      if msgs.possibly_persisted
                      else MsgStatus.NOT_PERSISTED)
                batch_nbytes = msgs.nbytes
                # LAZY DR materialization: messages hold (arena base,
                # packed offsets); .value/.key bytes exist only if the
                # DR callback reads them. The shared error stamps every
                # record here, so the per-message error loop below is
                # skipped for batches.
                msgs = msgs.to_messages_lazy(
                    tp.topic if tp is not None else "",
                    tp.partition if tp is not None else -1,
                    base_offset if err is None else -1, st, err)
            else:
                with self._msg_cnt_lock:
                    self._lane.acct(-msgs.count, -msgs.nbytes)
                    if self.flushing:
                        self._outq_cond.notify_all()
                return
        elif err is not None:
            for m in msgs:
                m.error = err
        if self.interceptors:
            for m in msgs:
                self.interceptors.on_acknowledgement(m)
        out = []
        if (self._dr_out_wanted()
                or any(m.on_delivery is not None for m in msgs)):
            only_err = self.conf.get("delivery.report.only.error")
            out = msgs if (err or not only_err) else \
                [m for m in msgs if m.error]
        # msg_cnt release and dr_cnt claim must be ONE atomic step:
        # a flush() reading between them would see outstanding == 0 and
        # return before the DR reaches the app
        if batch_nbytes is None:
            batch_nbytes = sum(m.size for m in msgs)
        with self._msg_cnt_lock:
            self._lane.acct(-len(msgs), -batch_nbytes)
            self.dr_cnt += len(out)
            if self.flushing and not out:
                self._outq_cond.notify_all()
        if out:
            # one DR op per batch, not per message (queue-push overhead)
            self.rep.push(Op(OpType.DR, payload=out))

    def poll(self, timeout: float = 0.0) -> int:
        """Serve the app reply queue: DRs, errors, stats, logs
        (reference: rd_kafka_poll, rdkafka.c:3574)."""
        served = 0
        t = timeout
        while True:
            op = self.rep.pop(t)
            if op is None:
                return served
            t = 0
            self._serve_rep_op(op)
            served += 1

    def queue_poll(self, timeout: float = 0.0):
        """Pop one typed Event from the reply queue (reference:
        rd_kafka_queue_poll → rd_kafka_event_t). Alternative to the
        callback dispatch of poll()."""
        from .event import Event
        op = self.rep.pop(timeout)
        if op is not None and op.type == OpType.DR:
            self._dr_served(len(op.payload))
        return Event(op) if op is not None else None

    def _dr_served(self, n: int) -> None:
        """A DR op reached the app (callback fired / event popped)."""
        with self._msg_cnt_lock:
            self.dr_cnt -= n
            if self.flushing:
                self._outq_cond.notify_all()

    def _serve_rep_op(self, op: Op):
        if op.type == OpType.DR:
            bcb = self.conf.get("dr_batch_cb")
            cb = self.conf.get("dr_msg_cb") or self.conf.get("dr_cb")
            try:
                if bcb is not None:
                    # ONE call per delivered batch (the
                    # rd_kafka_event_DR message-array contract); any
                    # per-message on_delivery callbacks still fire
                    bcb(op.payload)
                    if cb is None:
                        # fast-lane DR batches are FetchMessage lists —
                        # on_delivery is a class-level None there, so
                        # the per-message scan is skipped entirely
                        if (op.payload
                                and type(op.payload[0]) is FetchMessage):
                            return
                        for m in op.payload:
                            if m.on_delivery is not None:
                                m.on_delivery(m.error, m)
                        return
                for m in op.payload:
                    mcb = m.on_delivery or cb
                    if mcb:
                        mcb(m.error, m)
            finally:
                self._dr_served(len(op.payload))
        elif op.type == OpType.ERR:
            cb = self.conf.get("error_cb")
            if cb:
                cb(op.payload)
        elif op.type == OpType.THROTTLE:
            cb = self.conf.get("throttle_cb")
            if cb:
                cb(*op.payload)       # (broker_name, broker_id, throttle_ms)
        elif op.type == OpType.STATS:
            cb = self.conf.get("stats_cb")
            if cb:
                cb(op.payload)
        elif op.type == OpType.LOG:
            if self.log_cb:
                self.log_cb(*op.payload)
        elif op.cb:
            op.cb(op)

    @property
    def outq_len(self) -> int:
        """rd_kafka_outq_len: unacked messages + undelivered DR ops."""
        with self._msg_cnt_lock:
            return self.msg_cnt + self.dr_cnt

    def op_err(self, err: KafkaError):
        self.rep.push(Op(OpType.ERR, payload=err))

    def set_fatal_error(self, err: KafkaError):
        err.fatal = True
        if self.fatal_error is None:
            self.fatal_error = err
            self._lane.fatal = 1        # C produce must reject now
            if _trace.enabled:
                # flight-recorder trigger: dump the rings that explain
                # how the client got here (TRACING.md)
                _trace.instant("client", "fatal_error",
                               {"code": err.code.name,
                                "reason": err.reason})
                _trace.flight_record(f"fatal_{err.code.name}")
            self.op_err(err)

    # -------------------------------------------------------------- flush --
    def flush(self, timeout: float = 10.0) -> int:
        """Wait for all outstanding messages; returns count still queued
        (reference: rd_kafka_flush, rdkafka.c:3905)."""
        # under the outq lock: broker threads read the flag (under the
        # same lock) to decide whether an outstanding-count decrement
        # must notify — the --races sweep flagged the bare store
        with self._msg_cnt_lock:
            self.flushing = True
        # DR-mode split (reference rk_drmode, rd_kafka_flush): with a dr
        # callback, flush serves the reply queue itself; in event mode
        # (enabled_events has "dr", no callback) it must NOT consume DR
        # events destined for the app's queue_poll — it only waits for
        # another thread (or the background thread) to drain them.
        dr_event_mode = (
            not (self.conf.get("dr_msg_cb") or self.conf.get("dr_cb"))
            and "dr" in self.conf.get("enabled_events")
            and self.background is None)
        try:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._msg_cnt_lock:
                    # undelivered DR ops count toward the outstanding
                    # total (reference rd_kafka_outq_len, rdkafka.c:3905)
                    n = self.msg_cnt + self.dr_cnt
                if n == 0:
                    return 0
                self._wake_all_brokers()
                if dr_event_mode:
                    # block on the outq condvar (notified by every
                    # outstanding-count decrement while flushing); the
                    # 100ms cap re-wakes brokers if progress stalls
                    with self._msg_cnt_lock:
                        if self.msg_cnt + self.dr_cnt == 0:
                            return 0
                        self._outq_cond.wait(
                            min(0.1, max(0.0,
                                         deadline - time.monotonic())))
                else:
                    # poll() itself blocks on the reply-queue condvar;
                    # the short cap keeps the outer progress checks live
                    self.poll(0.05)
            with self._msg_cnt_lock:
                return self.msg_cnt + self.dr_cnt
        finally:
            with self._msg_cnt_lock:
                self.flushing = False

    def purge(self, in_queue: bool = True, in_flight: bool = False) -> None:
        """Purge messages (reference: rd_kafka_purge):
        ``in_queue`` — every queued message (msgq, xmit_msgq, frozen
        retry batches, UA parking) gets a _PURGE_QUEUE DR;
        ``in_flight`` — outstanding ProduceRequests are abandoned on the
        broker threads and their messages get _PURGE_INFLIGHT DRs (any
        late broker response is dropped by the corrid filter)."""
        purged = []
        fast_cnt = fast_bytes = 0
        dr_wanted = self._dr_out_wanted()
        with self._toppars_lock:
            tps = list(self._toppars.values())
        for tp in tps:
            with tp.lock:
                if in_queue:
                    purged.extend(tp.msgq)
                    tp.msgq.clear()
                    tp.msgq_bytes = 0
                    purged.extend(tp.xmit_msgq)
                    tp.xmit_msgq.clear()
                    for batch in tp.retry_batches:
                        if not isinstance(batch, ArenaBatch):
                            purged.extend(batch)
                        elif dr_wanted:  # dr_msgq accounts these
                            purged.extend(
                                batch.to_messages(tp.topic, tp.partition))
                        else:
                            fast_cnt += batch.count
                            fast_bytes += batch.nbytes
                    tp.retry_batches.clear()
                    if tp.arena is not None:
                        if dr_wanted:
                            for k, v, mts, hb in tp.arena.drain_records():
                                purged.append(Message(
                                    tp.topic, value=v, key=k,
                                    partition=tp.partition, timestamp=mts,
                                    headers=decode_hblob(hb) if hb else ()))
                        else:
                            c, nb = tp.arena.clear()
                            fast_cnt += c
                            fast_bytes += nb
        with self._topics_lock:
            for t in self.topics.values():
                with t.lock:
                    if in_queue:
                        purged.extend(t.ua_msgq)
                        t.ua_msgq.clear()
        if fast_cnt:
            self._lane.acct(-fast_cnt, -fast_bytes)
        if purged:
            self.dr_msgq(purged, KafkaError(Err._PURGE_QUEUE, "purged"))
        if in_flight:
            # batches inside the codec pipeline are neither queued nor in
            # waitresp: bump the purge epoch so their codec_done results
            # are discarded with _PURGE_INFLIGHT instead of being sent
            self._purge_epoch += 1
            with self._brokers_lock:
                brokers = list(self.brokers.values())
            for b in brokers:
                b.ops.push(Op(OpType.PURGE))
        if self.idemp and (purged or fast_cnt or in_flight):
            # purged messages consumed msgids: the sequence chain has a
            # gap the broker would reject — resync PID/epoch (the DRAIN
            # rebase recomputes the base from what is still pending)
            self.idemp.drain_epoch_bump("purge")

    def _wake_all_brokers(self):
        with self._brokers_lock:
            for b in self.brokers.values():
                b.ops.push(Op(OpType.BROKER_WAKEUP))

    # ------------------------------------------------- broker transitions --
    def broker_state_change(self, broker: Broker):
        if broker.is_up():
            self.metadata_refresh(f"broker {broker.name} up")

    def broker_down(self, broker: Broker, err: KafkaError):
        with self._brokers_lock:
            any_up = any(b.is_up() for b in self.brokers.values())
        if not any_up and not self.terminating:
            self.op_err(KafkaError(Err._ALL_BROKERS_DOWN,
                                   "all brokers are down"))

    # ------------------------------------------------------ msg timeouts --
    def _scan_msg_timeouts(self):
        """(reference: rd_kafka_broker_toppar_msgq_scan,
        rdkafka_broker.c:3093)"""
        if not self.is_producer:
            return
        now = time.monotonic()
        with self._toppars_lock:
            tps = list(self._toppars.values())
        any_possibly_persisted = False
        any_expired = False
        for tp in tps:
            tmo = self.topic_conf_for(tp.topic).get("message.timeout.ms") / 1000.0
            if tmo <= 0:
                continue
            expired = []
            fast_cnt = fast_bytes = 0
            fast_pp = False
            dr_wanted = self._dr_out_wanted()
            with tp.lock:
                if tp.arena is not None and len(tp.arena):
                    # fast-lane records carry a native monotonic µs stamp
                    cutoff = int((now - tmo) * 1e6)
                    if dr_wanted:
                        # materialize for error DRs (dr_msgq accounts)
                        for k, v, mts, hb in tp.arena.expire_records(cutoff):
                            expired.append(Message(
                                tp.topic, value=v, key=k,
                                partition=tp.partition, timestamp=mts,
                                headers=decode_hblob(hb) if hb else ()))
                    else:
                        c, nb = tp.arena.expire(cutoff)
                        fast_cnt += c
                        fast_bytes += nb
                for q in (tp.msgq, tp.xmit_msgq):
                    while q and now - q[0].enq_time > tmo:
                        expired.append(q.popleft())
                # frozen retry batches expire whole (membership must stay
                # intact); a batch expires when its head message has
                # (reference scans all queues, rdkafka_broker.c:3093)
                while tp.retry_batches:
                    b = tp.retry_batches[0]
                    head_enq = (b.enq_first if isinstance(b, ArenaBatch)
                                else b[0].enq_time)
                    if now - head_enq <= tmo:
                        break
                    tp.retry_batches.popleft()
                    if not isinstance(b, ArenaBatch):
                        expired.extend(b)
                    elif dr_wanted:
                        lst = b.to_messages(tp.topic, tp.partition)
                        if b.possibly_persisted:
                            for m in lst:
                                m.status = MsgStatus.POSSIBLY_PERSISTED
                        expired.extend(lst)
                    else:
                        fast_cnt += b.count
                        fast_bytes += b.nbytes
                        fast_pp = fast_pp or b.possibly_persisted
            if fast_cnt:
                any_expired = True
                any_possibly_persisted = any_possibly_persisted or fast_pp
                self._lane.acct(-fast_cnt, -fast_bytes)
                if (self.idemp and fast_pp
                        and self.conf.get("enable.gapless.guarantee")):
                    # an expired SENT fast-lane batch leaves a sequence
                    # gap, same as the Message path below
                    self.set_fatal_error(KafkaError(
                        Err._GAPLESS_GUARANTEE,
                        f"{tp}: message timed out with "
                        "enable.gapless.guarantee set"))
            if expired:
                any_expired = True
                if any(m.status == MsgStatus.POSSIBLY_PERSISTED
                       for m in expired):
                    any_possibly_persisted = True
                terr = KafkaError(Err._MSG_TIMED_OUT, "message timed out")
                if self.idemp and self.conf.get("enable.gapless.guarantee"):
                    # a timed-out message leaves a sequence gap: fatal
                    # under gapless (reference _GAPLESS_GUARANTEE)
                    terr = KafkaError(
                        Err._GAPLESS_GUARANTEE,
                        f"{tp}: message timed out with "
                        "enable.gapless.guarantee set")
                    self.set_fatal_error(terr)
                self.dr_msgq(expired, terr)
        if any_expired and self.idemp:
            # ANY timed-out message leaves a sequence gap the broker will
            # reject — even never-transmitted ones consumed msgids;
            # recover via drain + epoch bump (reference:
            # rdkafka_broker.c:3291-3309)
            self.idemp.drain_epoch_bump("message(s) timed out")

    # --------------------------------------------------------- stats emit --
    def _emit_stats(self):
        blob = self.stats.emit_json()
        self.rep.push(Op(OpType.STATS, payload=blob))

    # -------------------------------------------------------------- trace --
    def trace_dump(self, path: str) -> int:
        """Export the flight-recorder rings as Chrome trace-event JSON
        loadable in Perfetto (obs/trace.py; workflow in TRACING.md).
        Returns the number of events written.  The tracer is module-
        wide, so a dump taken through any client carries every
        instrumented thread — producer, consumer, engine, brokers."""
        return _trace.dump(path)

    # ------------------------------------------------- consumer fetch path --
    def fetch_reply_handle(self, tp: Toppar, pres: dict, broker: Broker,
                           batches: Optional[list] = None,
                           fo: Optional[int] = None,
                           ver: Optional[int] = None):
        """Parse a fetch response partition into messages
        (reference: rd_kafka_fetch_reply_handle → rd_kafka_msgset_parse,
        rdkafka_msgset_reader.c:1410; aborted-txn filtering :1442-1560).

        ``batches``: pre-processed v2 batches from the broker's batched
        phase — [(info, records_bytes_DECOMPRESSED, last_offset)] with
        CRCs already verified in ONE provider call across the whole
        Fetch response (the consumer-side mirror of the producer's
        batched codec seam). None falls back to inline per-batch work
        (legacy v0/v1 messagesets, tests). A batch payload of None marks
        a decompress failure — errored only if the batch would actually
        be delivered (aborted/control batches are skipped unread).

        ``fo``/``ver``: the (fetch_offset, version) snapshot the caller
        took when it decided this response is current; all skip/parse
        decisions use the snapshot so a concurrent seek() can't desync
        them, and deliveries are stamped with ``ver`` so post-seek ops
        get discarded by the consumer's staleness filter.

        Returns False when the range errored without advancing
        fetch_offset (CRC/decompress failure) — a mixed-segment caller
        must then stop, or it would advance past the failed range and
        lose it. True otherwise."""
        if fo is None:
            fo = tp.fetch_offset
        if ver is None:
            ver = tp.version
        blob = pres["records"] or b""
        if not blob:
            if (self.conf.get("enable.partition.eof")
                    and fo >= tp.hi_offset
                    and tp.eof_reported_at != fo):
                tp.eof_reported_at = fo
                m = Message(tp.topic, partition=tp.partition)
                m.offset = fo
                m.error = KafkaError(Err._PARTITION_EOF, "partition EOF")
                tp.fetchq.push(Op(OpType.FETCH, payload=(tp, [m], ver, 0)))
            return True
        check_crcs = self.conf.get("check.crcs")
        read_committed = (self.conf.get("isolation.level") == "read_committed")
        aborted_list = pres.get("aborted_transactions") or []
        aborted = {a["producer_id"]: sorted(x["first_offset"]
                   for x in aborted_list
                   if x["producer_id"] == a["producer_id"])
                   for a in aborted_list}
        active_aborts: set[int] = set()
        msgs: list[Message] = []
        msgs_bytes = 0
        next_offset = fo
        # mixed-format logs (written across a 0.11 upgrade): process
        # each same-format run in order; the single-format common case
        # falls through to the batched paths below untouched
        from ..protocol.msgset import split_msgset_segments
        segs = pres.pop("_segments", None) \
            if isinstance(pres.get("_segments"), list) else None
        if segs is None:
            segs = split_msgset_segments(blob)
        if len(segs) > 1:
            for _kind, seg in segs:
                if tp.version != ver:
                    return True
                sub = dict(pres)
                sub["records"] = seg
                if not self.fetch_reply_handle(tp, sub, broker,
                                               batches=None, fo=fo,
                                               ver=ver):
                    # segment errored without advancing: stop here so
                    # the failed range is re-fetched, not skipped over
                    return False
                fo = tp.fetch_offset
            return True
        is_v2 = (len(blob) > proto.V2_OF_Magic and blob[proto.V2_OF_Magic] == 2)
        if is_v2:
            if batches is None:
                # inline fallback path: per-batch CRC + decompress
                batches = []
                for info, payload, full in iter_batches(blob):
                    last = info.base_offset + info.last_offset_delta
                    if last >= fo:
                        if check_crcs and not verify_crc_v2(info, full):
                            if _trace.enabled:
                                _trace.instant(
                                    "fetch", "crc_mismatch",
                                    {"topic": tp.topic,
                                     "partition": tp.partition,
                                     "offset": info.base_offset})
                                _trace.flight_record("crc_mismatch")
                            self.op_err(KafkaError(
                                Err._BAD_MSG,
                                f"{tp}: CRC mismatch at offset "
                                f"{info.base_offset}"))
                            tp.fetch_backoff_until = time.monotonic() + 0.5
                            return False
                        if info.codec:
                            try:
                                payload = self.codec_provider.decompress_many(
                                    info.codec, [payload])[0]
                            except Exception as e:
                                self.op_err(KafkaError(
                                    Err._BAD_COMPRESSION,
                                    f"{tp}: decompress ({info.codec}): "
                                    f"{e!r}"))
                                tp.fetch_backoff_until = \
                                    time.monotonic() + 0.5
                                return False
                    batches.append((info, payload, last))
            for info, payload, last in batches:
                if last < fo:
                    next_offset = max(next_offset, last + 1)
                    continue
                # aborted-txn bookkeeping
                pid = info.producer_id
                if read_committed and pid in aborted:
                    while aborted[pid] and aborted[pid][0] <= info.base_offset:
                        aborted[pid].pop(0)
                        active_aborts.add(pid)
                if info.is_control:
                    # control record: key = [version i16, type i16]
                    try:
                        recs = (parse_records_v2(info, payload)
                                if payload is not None else [])
                        if recs and recs[0].key and len(recs[0].key) >= 4:
                            ctype = int.from_bytes(recs[0].key[2:4], "big")
                            if ctype == proto.CTRL_ABORT:
                                active_aborts.discard(pid)
                    except Exception:
                        pass
                    next_offset = last + 1
                    continue
                if (read_committed and info.is_transactional
                        and pid in active_aborts):
                    next_offset = last + 1
                    continue
                if payload is None:      # decompress failed (phase C)
                    self.op_err(KafkaError(
                        Err._BAD_COMPRESSION,
                        f"{tp}: decompress ({info.codec}) failed at "
                        f"offset {info.base_offset}"))
                    tp.fetch_backoff_until = time.monotonic() + 0.5
                    return False
                # direct Message materialization off the native field
                # walk (no intermediate Record; ~1.5 us/msg on this path)
                ms, mbytes = parse_fetch_messages_v2(
                    info, payload, tp.topic, tp.partition, fo)
                if _trace.enabled and _trace.flow_sample_every and ms:
                    # flow point 3/4: sampled offsets now
                    # back on the wire consumer-side
                    step = _trace.flow_sample_every
                    lo = ms[0].offset
                    for off in range(lo + (-lo) % step,
                                     ms[-1].offset + 1, step):
                        _trace.instant("flow", "flow_fetch",
                                       {"topic": tp.topic,
                                        "partition": tp.partition,
                                        "offset": off})
                msgs.extend(ms)
                msgs_bytes += mbytes
                next_offset = last + 1
        else:
            dec = lambda codec, b: self.codec_provider.decompress_many(codec, [b])[0]
            for r in parse_msgset_v01(blob, dec):
                if r.offset < fo:
                    continue
                m = Message(tp.topic, value=r.value, key=r.key,
                            partition=tp.partition, timestamp=r.timestamp)
                m.offset = r.offset
                msgs.append(m)
                msgs_bytes += m.size
                next_offset = max(next_offset, r.offset + 1)

        if tp.version != ver:
            return True  # seek/rebalance raced this response: drop it
        tp.fetch_offset = next_offset
        tp.eof_reported_at = proto.OFFSET_INVALID
        if self.interceptors:
            for m in msgs:
                self.interceptors.on_consume(m)
        # accounting BEFORE the push: the app thread may drain the op
        # (decrements clamp at 0) the instant it becomes visible.
        # Under the toppar lock — the app thread's decrement is a
        # concurrent read-modify-write, and the --races sweep convicted
        # the old bare ``+=`` here racing consumer.py's drain (a GIL
        # switch between the load and the store loses an update, and
        # the clamp then silently re-zeroes the budget)
        with tp.lock:
            tp.fetchq_cnt += len(msgs)
            tp.fetchq_bytes += msgs_bytes
        if msgs:
            if _trace.enabled and _trace.flow_sample_every:
                # flow point 4/4: handed to the app-facing fetch queue
                step = _trace.flow_sample_every
                lo = msgs[0].offset
                for off in range(lo + (-lo) % step,
                                 msgs[-1].offset + 1, step):
                    _trace.instant("flow", "flow_deliver",
                                   {"topic": tp.topic,
                                    "partition": tp.partition,
                                    "offset": off})
            # ONE op per parsed partition response (per-message op
            # push/pop dominated the consume profile)
            tp.fetchq.push(Op(OpType.FETCH,
                              payload=(tp, msgs, ver, msgs_bytes)))
        if self.stats:
            self.stats.add_rx(len(msgs))
        return True

    def offset_reset(self, tp: Toppar, reason: str):
        """Apply auto.offset.reset (reference: rdkafka_offset.c
        RD_KAFKA_OP_OFFSET_RESET path)."""
        policy = self.topic_conf_for(tp.topic).get("auto.offset.reset")
        if policy in ("smallest", "earliest", "beginning"):
            tp.fetch_offset = proto.OFFSET_BEGINNING
            tp.fetch_state = FetchState.OFFSET_QUERY
        elif policy in ("largest", "latest", "end"):
            tp.fetch_offset = proto.OFFSET_END
            tp.fetch_state = FetchState.OFFSET_QUERY
        else:
            m = Message(tp.topic, partition=tp.partition)
            m.error = KafkaError(Err._NO_OFFSET, reason)
            tp.fetchq.push(Op(OpType.CONSUMER_ERR, payload=(tp, m, tp.version)))
            tp.fetch_state = FetchState.STOPPED
        self.dbg("fetch", f"{tp}: offset reset ({policy}): {reason}")

    # -------------------------------------------------------------- close --
    def close(self, timeout: float = 5.0):
        if self.is_producer:
            self.flush(timeout)
        self.terminating = True
        if self._stats_timer is not None:
            self.timers.stop(self._stats_timer)
            from .stats import _ACTIVE_STATS_TIMERS
            _ACTIVE_STATS_TIMERS.discard(id(self._stats_timer))
            self._stats_timer = None
        if self._trace_ref:
            # release this client's tracer reference (the last release
            # disables recording and frees every ring)
            self._trace_ref = False
            _trace.disable()
        if self._lockdep_ref:
            # the order graph survives for lockdep.report(); only the
            # recording refcount drops
            self._lockdep_ref = False
            _lockdep.disable()
        if self._races_ref:
            # findings survive for races.report(); the last release
            # uninstalls the Guarded descriptors
            self._races_ref = False
            _races.disable()
        with self._brokers_lock:
            brokers = list(self.brokers.values())
        for b in brokers:
            b.stop()
        for b in brokers:
            b.thread.join(timeout=2.0)
        self._main.join(timeout=2.0)
        if self.interceptors:
            self.interceptors.on_destroy(self)
        if self.mock_cluster:
            self.mock_cluster.stop()
        if self.offset_store is not None:
            self.offset_store.close()
        if self.background is not None:
            self.background.stop()
        if self.codec_worker is not None:
            self.codec_worker.stop()
        # async offload engine: drain in-flight launches + stop its
        # dispatch thread (GpuCodecProvider; CPU provider has no close)
        pclose = getattr(self.codec_provider, "close", None)
        if pclose is not None:
            try:
                pclose()
            except Exception:
                pass
        # Release the fat buffers NOW, not at the next gen2 GC pass:
        # the client object graph is cyclic (rk<->brokers<->toppars<->
        # queues<->callbacks), so without this the arena slabs, socket
        # buffers and queued messages — hundreds of MB on a busy
        # instance — stay live until the collector happens by. A
        # process that closes one client and starts another (the bench
        # shape, also common in tests) then walks its heap through
        # fresh pages instead of recycling (this VM's lazy pager makes
        # a first touch ~21 us/page; rd_kafka_destroy frees eagerly
        # for the same reason).
        with self._toppars_lock:
            tps = list(self._toppars.values())
        for tp in tps:
            tp.arena = None
            tp.msgq.clear()
            tp.xmit_msgq.clear()
            tp.retry_batches.clear()
        if getattr(self, "_lane", None) is not None:
            try:
                for key in list(self._lane.map):
                    self._lane.map_del(*key)
            except Exception:
                pass
        for b in brokers:
            # only reap a broker whose thread really exited: a stuck
            # thread (join timed out above) still OWNS these structures
            # — clearing them under it races its serve loop ("deque
            # mutated during iteration", claims lost mid-release)
            if b.thread.is_alive():
                continue
            b._rbuf = bytearray()
            b._fetch_deferred.clear()
            b.outq.clear()
            b.waitresp.clear()

    # ------------------------------------------------------- oauthbearer --
    def set_oauthbearer_token(self, token: str, lifetime_ms: int = 0,
                              principal: str = "") -> None:
        """App-supplied OAUTHBEARER token (rd_kafka_oauthbearer_set_token).
        A refresh is scheduled at 80% of the token lifetime, firing the
        oauthbearer_token_refresh_cb again (the previous schedule is
        replaced, so proactive re-sets don't accumulate timers)."""
        expiry = (time.time() + lifetime_ms / 1000.0) if lifetime_ms else 0
        self._oauth_token = (token, principal, expiry)
        self._oauth_failure = None
        if self._oauth_timer is not None:
            self.timers.stop(self._oauth_timer)
            self._oauth_timer = None
        if lifetime_ms > 0 and self.conf.get("oauthbearer_token_refresh_cb"):
            self._oauth_timer = self.timers.add(
                max(1.0, lifetime_ms / 1000.0 * 0.8),
                lambda: self._oauth_refresh_fire(force=True), once=True)

    def set_oauthbearer_token_failure(self, errstr: str) -> None:
        """(rd_kafka_oauthbearer_set_token_failure) — the failure stands
        until the next refresh attempt, which clears it and retries."""
        self._oauth_failure = errstr

    def _oauth_refresh_fire(self, force: bool = False):
        """Invoke the app's refresh cb. Serialized: concurrent broker
        reconnects must not fan out duplicate token fetches (the
        reference guarantees single-threaded cb invocation).
        ``force`` is the proactive 80%-lifetime timer path — the token
        is still fresh there by construction, that's the point."""
        cb = self.conf.get("oauthbearer_token_refresh_cb")
        if cb is None or self.terminating:
            return
        with self._oauth_cb_lock:
            if not force and self._oauth_token_fresh():
                return              # another thread already refreshed
            self._oauth_failure = None    # each attempt starts clean
            try:
                cb(self, self.conf.get("sasl.oauthbearer.config"))
            except Exception as e:
                self._oauth_failure = repr(e)
                self.log("ERROR", f"oauthbearer refresh cb raised: {e!r}")

    def _oauth_token_fresh(self) -> bool:
        t = self._oauth_token
        if t is None:
            return False
        _tok, _principal, expiry = t
        return not expiry or time.time() < expiry

    def get_oauthbearer_token(self):
        """Token for the SASL client: a fresh app-set token, else invoke
        the refresh callback (which must call set_oauthbearer_token).
        Returns the (token, principal, expiry) tuple or None — None with
        a refresh cb configured is an authentication FAILURE, never an
        unsecured-JWS fallback."""
        if not self._oauth_token_fresh():
            if self.conf.get("oauthbearer_token_refresh_cb") is not None:
                self._oauth_refresh_fire()
        if self._oauth_failure or not self._oauth_token_fresh():
            return None
        return self._oauth_token

    # ----------------------------------------------------------- security --
    def ssl_ctx(self):
        """The per-instance TLS context, or None for plaintext
        (reference: rk_conf.ssl.ctx built at rd_kafka_ssl_ctx_init)."""
        return self._ssl_ctx

    def connect_cb(self, host: str, port: int, timeout: float):
        """Create the TCP connection for a broker. Honors the app's
        ``connect_cb``/``socket_cb`` conf hooks — the seam the reference
        exposes for sockem-style network shaping (rdkafka_conf.c
        socket_cb/connect_cb; tests/sockem.c interposes here). Also
        applies socket.* buffer/keepalive knobs and
        broker.address.family resolution."""
        cb = self.conf.get("connect_cb")
        if cb is not None:
            return cb(host, port, timeout)
        fam_conf = self.conf.get("broker.address.family")
        family = {"v4": socket.AF_INET, "v6": socket.AF_INET6}.get(
            fam_conf, socket.AF_UNSPEC)
        sock_cb = self.conf.get("socket_cb")
        last_err = None
        for af, stype, sproto, _, addr in self._resolve(host, port, family):
            try:
                s = (sock_cb(af, stype, sproto) if sock_cb is not None
                     else socket.socket(af, stype, sproto))
            except OSError as e:
                last_err = e
                continue
            try:
                sndbuf = self.conf.get("socket.send.buffer.bytes")
                if sndbuf:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
                rcvbuf = self.conf.get("socket.receive.buffer.bytes")
                if rcvbuf:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
                if self.conf.get("socket.keepalive.enable"):
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
                s.settimeout(timeout)
                s.connect(addr)
                return s
            except OSError as e:
                last_err = e
                try:
                    s.close()
                except OSError:
                    pass
        raise last_err or OSError(f"cannot resolve {host}:{port}")

    def _resolve(self, host: str, port: int, family) -> list:
        """getaddrinfo with a broker.address.ttl cache (reference:
        rdaddr.c rd_sockaddr_list caching + rotation)."""
        ttl = self.conf.get("broker.address.ttl") / 1000.0
        key = (host, port, family)
        now = time.monotonic()
        hit = self._addr_cache.get(key)
        if hit is not None and now < hit[0]:
            return hit[1]
        infos = socket.getaddrinfo(host, port, family, socket.SOCK_STREAM)
        if ttl > 0:
            self._addr_cache[key] = (now + ttl, infos)
        return infos

    # ---------------------------------------------------------------- SASL --
    def sasl_required(self) -> bool:
        return self.conf.get("security.protocol") in ("sasl_plaintext",
                                                      "sasl_ssl")

    def sasl_start(self, broker: Broker):
        from .sasl import sasl_client_start
        sasl_client_start(self, broker)
