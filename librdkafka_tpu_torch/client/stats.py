"""Statistics: windowed averages with percentiles + the JSON stats blob.

Reference: rd_avg_t (src/rdavg.h) over HdrHistogram (rdhdrhistogram.c),
emitted by rd_kafka_stats_emit_all (rdkafka.c:1473-1700) every
statistics.interval.ms with the schema documented in STATISTICS.md.
The port's copy of the JAX package's ``client/stats.py``: for the same
conf the blob has the same key tree; ``codec_engine`` comes from the
port's offload engine (ops/engine.py).
"""
from __future__ import annotations

import json
import threading
import time
from typing import TYPE_CHECKING

from ..utils.hdrhistogram import HdrHistogram
from ..analysis.locks import new_lock
from ..analysis.races import register_slots, shared
from ..obs import metrics as _metrics

if TYPE_CHECKING:
    from .kafka import Kafka

#: live stats-emit timers by id() (registered by Kafka.__init__ when
#: statistics.interval.ms > 0, removed at close); the conftest autouse
#: leak fixture fails any test whose client left one behind — a leaked
#: emitter means close() never ran or lost the timer handle
_ACTIVE_STATS_TIMERS: set[int] = set()


class Avg:
    """Windowed HdrHistogram with rollover (reference: rd_avg_t,
    rdavg.h:37-165 — values accumulate into the current window; the
    stats emitter rolls the window over and renders min/avg/max +
    p50..p99.99, rdkafka.c:1582-1630). O(1) record, constant memory."""

    __slots__ = ("_hist", "_lock")

    #: STATISTICS.md percentile fields
    PCTS = ((50, "p50"), (75, "p75"), (90, "p90"), (95, "p95"),
            (99, "p99"), (99.99, "p99_99"))

    def __init__(self, lowest: int = 1, highest: int = 60_000_000,
                 sigfigs: int = 3):
        self._hist = HdrHistogram(lowest, highest, sigfigs)
        self._lock = new_lock("stats.avg")

    def add(self, v: float):
        with self._lock:
            self._hist.record(int(v))

    def rollover(self) -> dict:
        with self._lock:
            h = self._hist
            vals, stddev = h.snapshot([p for p, _ in self.PCTS])
            out = {"min": h.min_v, "max": h.max_v,
                   "avg": int(h.mean()), "sum": h.sum_v, "cnt": h.total,
                   "stddev": int(stddev),
                   "hdrsize": h.memsize,
                   "outofrange": h.out_of_range}
            for (pct, name), v in zip(self.PCTS, vals):
                out[name] = v
            h.reset()
        return out


# every histogram touch — record from app/broker/codec threads,
# rollover from the stats emitter — holds stats.avg (analysis/races.py
# verifies the discipline; the slot form because Avg is __slots__)
register_slots(Avg, "_hist", prefix="stats.avg")


class StatsCollector:
    """Aggregates counters from the client and renders the stats JSON."""

    # txmsgs/rxmsgs are bumped from broker ack paths and the consumer
    # poll loop while the emitter timer reads them — all under
    # stats.counters (the --races sweep convicted the
    # old bare ``+=`` against the emitter's read; it also surfaced
    # that c_tx_msgs was never bumped at all — txmsgs sat at 0)
    c_tx_msgs = shared("stats.c_tx_msgs")
    c_rx_msgs = shared("stats.c_rx_msgs")

    def __init__(self, rk: "Kafka"):
        self.rk = rk
        self.ts_start = time.time()
        self._clock = new_lock("stats.counters")
        self.c_tx_msgs = 0
        self.c_rx_msgs = 0
        self.int_latency = Avg()      # produce() -> MessageSet write
        self.codec_latency = Avg()    # batched codec provider call

    def add_tx(self, n: int) -> None:
        """Count ``n`` successfully produced (acked) messages."""
        with self._clock:
            self.c_tx_msgs += n

    def add_rx(self, n: int) -> None:
        """Count ``n`` messages delivered to the consumer app."""
        with self._clock:
            self.c_rx_msgs += n

    def emit_json(self) -> str:
        rk = self.rk
        brokers = {}
        # ONE active-toppar snapshot feeds both the per-broker toppar
        # maps and the topics{} tree: the emitter is O(active), never
        # O(registered) — a 100k-partition topic in the metadata cache
        # costs the stats timer nothing
        active = rk.active_toppars()
        with rk._brokers_lock:
            rk_brokers = list(rk.brokers.values())
        for b in rk_brokers:
            brokers[b.name] = {
                "name": b.name, "nodeid": b.nodeid, "state": b.state.value,
                "stateage": int((time.monotonic() - b.ts_state) * 1e6),
                "connects": b.c_connects,
                "outbuf_cnt": len(b._unsent_req_ends),
                "waitresp_cnt": len(b.waitresp),
                "tx": b.c_tx, "txbytes": b.c_tx_bytes,
                "rx": b.c_rx, "rxbytes": b.c_rx_bytes,
                "req_timeouts": b.c_req_timeouts,
                # the serve thread's passes: all, those that did nothing,
                # those that blocked with nothing to serve, what ended
                # each one's wait, the ops served by kind
                "wakeups": b.c_wakeups,
                "idle_wakeups": b.c_idle_wakeups,
                "idle_waits": b.c_idle_waits,
                "woke": dict(b.c_woke),
                "ops": dict(b.c_ops),
                # fetched v2 bytes whose CRC32C the card or the host
                # checked
                "fetch_crc_bytes_device": b.c_fetch_crc_bytes_device,
                "fetch_crc_bytes_host": b.c_fetch_crc_bytes_host,
                # latency decomposition (STATISTICS.md broker window stats)
                "rtt": b.rtt_avg.rollover(),
                "outbuf_latency": b.outbuf_avg.rollover(),
                "throttle": b.throttle_avg.rollover(),
                # consumer fetch pipeline: codec-ticket submit -> reap
                # (the _PendingFetch window)
                "fetch_latency": b.fetch_latency_avg.rollover(),
                # KIP-227 session snapshot + fetch-API wire split
                #: the bench reads these to prove on-wire
                # savings; partitions_sent/partitions_total give the
                # incremental ratio
                "fetch_session": {**b._fetch_session.stats(),
                                  "tx_bytes": b.c_fetch_tx_bytes,
                                  "rx_bytes": b.c_fetch_rx_bytes},
                "toppars": {f"{tp.topic}-{tp.partition}":
                            {"topic": tp.topic, "partition": tp.partition}
                            for tp in active if tp in b.toppars},
            }
        topics = {}
        for tp in active:
            t, p = tp.topic, tp.partition
            topics.setdefault(t, {"topic": t, "partitions": {}})
            # reference lag (rdkafka.c:1283-1297): end_offset (ls under
            # read_committed) minus MAX(app, committed), clamped >= 0
            end = (tp.ls_offset if rk.conf.get("isolation.level")
                   == "read_committed" and tp.ls_offset >= 0
                   else tp.hi_offset)
            base = max(tp.app_offset, tp.committed_offset)
            lag = max(0, end - base) if end >= 0 and base >= 0 else -1
            # queue gauges under the toppar lock: the app enqueues and
            # the broker drains while the emitter reads (the --races
            # sweep flagged the old lock-free len()/int peeks against
            # kafka.toppar-guarded writes)
            with tp.lock:
                msgq_cnt = (len(tp.msgq)
                            + (len(tp.arena) if tp.arena is not None
                               else 0))
                msgq_bytes = tp.msgq_bytes
                xmit_cnt = len(tp.xmit_msgq)
                fetchq_cnt = tp.fetchq_cnt
            topics[t]["partitions"][str(p)] = {
                "partition": p, "leader": tp.leader_id,
                "msgq_cnt": msgq_cnt,
                "msgq_bytes": msgq_bytes,
                "xmit_msgq_cnt": xmit_cnt,
                "fetchq_cnt": fetchq_cnt,
                "fetch_state": tp.fetch_state.value,
                "app_offset": tp.app_offset,
                "stored_offset": tp.stored_offset,
                "committed_offset": tp.committed_offset,
                "hi_offset": tp.hi_offset,
                "ls_offset": tp.ls_offset,
                "consumer_lag": lag,
            }
        with rk._metadata_lock:
            metadata_cache_cnt = len(rk.metadata.get("topics", {}))
        with self._clock:
            txmsgs, rxmsgs = self.c_tx_msgs, self.c_rx_msgs
        blob = {
            "name": rk.conf.get("client.id"),
            "client_id": rk.conf.get("client.id"),
            "type": rk.type,
            "ts": int(time.time() * 1e6),
            "time": int(time.time()),
            "age": int((time.time() - self.ts_start) * 1e6),
            "replyq": len(rk.rep),
            "msg_cnt": rk.msg_cnt,
            "msg_size": rk.msg_bytes,
            "msg_max": rk.conf.get("queue.buffering.max.messages"),
            "msg_size_max":
                rk.conf.get("queue.buffering.max.kbytes") * 1024,
            "tx": sum(b["tx"] for b in brokers.values()),
            "tx_bytes": sum(b["txbytes"] for b in brokers.values()),
            "rx": sum(b["rx"] for b in brokers.values()),
            "rx_bytes": sum(b["rxbytes"] for b in brokers.values()),
            # Fetch-API bytes (both directions) across brokers: the
            # incremental-session savings gauge
            "wire_fetch_bytes": sum(
                b["fetch_session"]["tx_bytes"]
                + b["fetch_session"]["rx_bytes"]
                for b in brokers.values()),
            "metadata_cache_cnt": metadata_cache_cnt,
            "txmsgs": txmsgs, "rxmsgs": rxmsgs,
            "int_latency": self.int_latency.rollover(),
            "codec_latency": self.codec_latency.rollover(),
            "brokers": brokers,
            "topics": topics,
            # unified metrics registry: every process-wide
            # counter/gauge/window any subsystem registered — always
            # present (a disabled registry snapshots as empty maps) so
            # stats consumers never branch on its existence
            "obs": _metrics.snapshot(),
        }
        if rk.type == "producer":
            # fast-lane engagement: cumulative native-lane appends plus
            # the per-reason fallback/demotion breakdown — "workloads
            # actually ride it" is machine-checkable
            with rk._msg_cnt_lock:
                demoted = dict(rk._demote_reasons)
            blob["arena"] = {**rk._lane.counters(), "demoted": demoted}
        # adaptive offload governor decisions: launch /
        # merge / fallback / warmup counters plus the cost-model gauges
        # from the async engine, when the gpu backend has spun one up
        eng = getattr(rk.codec_provider, "_engine", None)
        if eng is not None:
            blob["codec_engine"] = {
                **eng.stats,
                "governor": eng.governor_snapshot(),
                # per-stage latency decomposition + pipeline-occupancy
                # gauges (STATISTICS.md codec_engine section)
                "stage_latency": eng.stage_latency_snapshot(),
                "gauges": eng.gauges_snapshot(),
                # per-device dispatch lanes: launch counts,
                # in-flight depth, launch-time EWMAs and warm-kernel
                # count per mesh device (STATISTICS.md
                # codec_engine.devices[])
                "devices": eng.devices_snapshot(),
                # device compress route: fused launch /
                # routed-per-bucket / bytes counters, the governor's
                # compress cost model, and per-topic QoS routed/shed
                # tallies (STATISTICS.md codec_engine.compress)
                "compress": eng.compress_snapshot()}
        if rk.cgrp is not None:
            cg = rk.cgrp
            with cg._lock:
                assignment_size = len(cg.assignment)
                incremental_revokes = cg.incremental_revoke_cnt
            # stuck partitions: assigned but not fetching (NONE /
            # STOPPED after the rebalance settled) — steady state must
            # read 0, the stats-level echo of the chaos continuity
            # invariant
            stuck = 0
            consumer = getattr(rk, "consumer", None)
            if consumer is not None:
                from .partition import FetchState
                for tp in list(consumer._assignment.values()):
                    if tp.fetch_state in (FetchState.NONE,
                                          FetchState.STOPPED):
                        stuck += 1
            blob["cgrp"] = {"state": cg.join_state,
                            "rebalance_cnt": cg.rebalance_cnt,
                            "assignment_size": assignment_size,
                            "rebalance_proto": cg.rebalance_protocol,
                            "incremental_revokes": incremental_revokes,
                            "stuck_partitions": stuck}
        if rk.idemp is not None:
            blob["eos"] = {"idemp_state": rk.idemp.state,
                           "producer_id": rk.idemp.pid,
                           "producer_epoch": rk.idemp.epoch}
            if rk.txnmgr is not None:
                # transactional FSM snapshot (STATISTICS.md eos blob)
                blob["eos"].update({
                    "txn_state": rk.txnmgr.state,
                    "transactional_id": rk.txnmgr.transactional_id,
                    "txn_registered_partitions":
                        len(rk.txnmgr._registered),
                    "txn_coordinator": (rk.txnmgr.coord_id
                                        if rk.txnmgr.coord_id is not None
                                        else -1),
                    # the port's transaction counters (CPU_ACCOUNTING.md)
                    "txn_begins": rk.txnmgr.begins,
                    "txn_commits": rk.txnmgr.commits,
                    "txn_aborts": rk.txnmgr.aborts,
                    "txn_commit_wall_ns": rk.txnmgr.commit_wall_ns,
                    "txn_cpu_ns": rk.txnmgr.cpu_ns})
        return json.dumps(blob)
