"""Scenario library: canned chaos storms over the real-TCP mock
cluster — in-process OR the out-of-process tier, where every
broker is a real OS process and faults are real signals.

The port's copy of the JAX package's ``chaos/scenarios.py``.  Run via
``python -m librdkafka_tpu_torch.chaos`` (``--list`` to enumerate) or the
pytest tiers (``tests/test_torch_chaos.py``: fast scenarios in tier-1,
full storms ``slow``-marked, the multi-minute soak ``soak``-marked).

Every scenario is deterministic from its seed: the fault timeline's
``replay_key`` is identical across runs (schedule.py's contract) —
including against the external cluster, where a fresh supervisor
process must resolve the same targets (coordinator placement hashes
stably, alive-set bookkeeping is handle-local).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, NamedTuple, Optional

from ..analysis.locks import new_lock
from ..client.consumer import Consumer
from ..client.errors import KafkaException
from ..client.producer import Producer
from ..mock.cluster import MockCluster
from ..mock.external import ClusterHandle
from ..mock.sockem import Sockem
from ..obs import trace
from .members import LiteMemberFleet
from .oracle import DeliveryOracle, OracleViolation
from .schedule import (ChaosScheduler, Schedule, broker_kill,
                       broker_restart, conn_kill, leader_migrate, net,
                       proc_cont, proc_kill9, proc_pause, proc_restart)


def _pct(vals: list, q: float) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    return round(s[min(len(s) - 1, int(round(q * (len(s) - 1))))], 1)


def storm_metrics(timeline: list[dict], acked_ts: list[float]
                  ) -> Optional[dict]:
    """Robustness-as-numbers over any fault timeline + ack-stamp
    stream: throughput sustained inside the fault window and
    time-to-first-ack after each kill (the recovery envelope).  Shared
    by Storm (one in-process client) and the fleet driver (many worker
    processes, whose merged stamps arrive unsorted — sorted here)."""
    fired = [e for e in timeline
             if (e.get("resolved") or {}).get("broker") is not None
             and "mono" in e]
    if not fired:
        return None
    acked_ts = sorted(acked_ts)
    t0, t1 = fired[0]["mono"], fired[-1]["mono"]
    window = max(t1 - t0, 1e-3)
    in_window = sum(1 for t in acked_ts if t0 <= t <= t1)
    recovery, unrecovered = [], 0
    kills = [e["mono"] for e in fired
             if e["action"] in ("broker_kill", "proc_kill9")]
    for k in kills:
        nxt = next((t for t in acked_ts if t > k), None)
        if nxt is None:
            unrecovered += 1
        else:
            recovery.append((nxt - k) * 1000.0)
    return {
        "storm_window_s": round(window, 2),
        "storm_acks": in_window,
        "storm_msgs_s": round(in_window / window, 1),
        "kills": len(kills),
        "recovery_ms": {
            "per_kill": [round(r, 1) for r in recovery],
            "p50": _pct(recovery, 0.50),
            "p99": _pct(recovery, 0.99),
            "max": _pct(recovery, 1.0),
            "unrecovered": unrecovered,
        },
    }


# ---------------------------------------------------------------- storm --
class Storm:  # lint: ok shared-state
    """One storm run: cluster (in-process MockCluster or external
    ClusterHandle) + optional sockem + oracle + scheduler + paced
    producer/consumer loops.  Scenarios configure and run it;
    everything tears down in ``finally`` so a failed storm never leaks
    threads — or broker subprocesses — into the next one (the conftest
    fixtures police both).

    shared-state pragma: consumer loops communicate exclusively
    through the oracle's declared ledgers (chaos.oracle lock) and
    threading.Events; the storm thread reads results after joins."""

    def __init__(self, *, seed: int, brokers: int = 3,
                 partitions: int = 4, topic: str = "chaos",
                 external: bool = False,
                 use_sockem: bool = False, min_alive: int = 1,
                 transactional: bool = False, txn_size: int = 5,
                 abort_every: int = 0, isolation: str = "read_committed",
                 consumers: int = 1, consumer_start_delays=(0.0,),
                 check_group: bool = False, converge_s: float = 20.0,
                 strategy: str = "range,roundrobin",
                 check_continuity: bool = False,
                 flow_stall_s: float = 2.0,
                 converge_bound_s: Optional[float] = None,
                 churn_consumers: int = 0, churn_start_s: float = 1.0,
                 churn_period_s: float = 0.5, churn_lifetime_s: float = 2.0,
                 duration_s: float = 3.0, pace_ms: float = 4.0,
                 drain_s: float = 20.0,
                 check_duplicates: bool = True, check_order: bool = True,
                 producer_conf: Optional[dict] = None):
        self.seed = seed
        self.topic = topic
        self.partitions = partitions
        self.external = external
        self.transactional = transactional
        self.txn_size = txn_size
        self.abort_every = abort_every
        self.isolation = isolation
        self.n_consumers = consumers
        self.consumer_start_delays = consumer_start_delays
        self.check_group = check_group
        self.converge_s = converge_s
        self.strategy = strategy
        self.check_continuity = check_continuity
        self.flow_stall_s = flow_stall_s
        self.converge_bound_s = converge_bound_s
        self.churn_consumers = churn_consumers
        self.churn_start_s = churn_start_s
        self.churn_period_s = churn_period_s
        self.churn_lifetime_s = churn_lifetime_s
        self.duration_s = duration_s
        self.pace_ms = pace_ms
        self.drain_s = drain_s
        self.check_duplicates = check_duplicates
        self.check_order = check_order
        self.producer_conf = producer_conf or {}

        if external:
            assert not use_sockem, \
                "sockem shapes the CLIENT socket; pair it with the " \
                "in-process tier (process faults cover the server side)"
            self.cluster = ClusterHandle(brokers=brokers,
                                         topics={topic: partitions})
        else:
            self.cluster = MockCluster(num_brokers=brokers,
                                       topics={topic: partitions})
        self.sockem = Sockem() if use_sockem else None
        self.oracle = DeliveryOracle(track_flow=check_continuity)
        self.chaos = ChaosScheduler(self.cluster, self.sockem,
                                    min_alive=min_alive)
        self.produced = 0
        self.errors: list[str] = []
        self._converged_s: Optional[float] = None
        self._stop_consumers = threading.Event()
        # per-member KIP-227 fetch-session counters, snapshotted just
        # before each consumer closes: {member: {broker
        # name: FetchSession.stats()}} — session-chaos scenarios assert
        # renegotiation happened off these
        self.fetch_session_stats: dict = {}

    # -- client builders --------------------------------------------------
    def _conf(self, extra: dict) -> dict:
        conf = {"bootstrap.servers": self.cluster.bootstrap_servers()}
        if self.sockem is not None:
            conf["connect_cb"] = self.sockem.connect_cb
        conf.update(extra)
        return conf

    def _make_producer(self) -> Producer:
        conf = self._conf({
            "linger.ms": 2,
            "enable.idempotence": True,
            "message.send.max.retries": 1000,
            "retry.backoff.ms": 50,
            "message.timeout.ms": 120000,
            "reconnect.backoff.ms": 50,
            # storms kill the same broker many times in a row; the
            # default 10 s backoff ceiling compounds across cycles
            # into multi-second ack wedges (correct client behavior,
            # wrong rig tuning — a chaos rig wants fast re-probing)
            "reconnect.backoff.max.ms": 1000,
        })
        if self.transactional:
            conf["transactional.id"] = f"chaos-tx-{self.seed}"
        conf.update(self.producer_conf)
        return Producer(conf)

    def _make_consumer(self, i: int) -> Consumer:
        conf = {
            "group.id": f"chaos-g-{self.seed}",
            "client.id": f"chaos-c{i}",
            "auto.offset.reset": "earliest",
            "isolation.level": self.isolation,
            "reconnect.backoff.ms": 50,
            "reconnect.backoff.max.ms": 1000,
        }
        if self.check_group:
            # group-heavy storms: heartbeat well inside the mock's
            # rebalance window (3 s) or halves of a churning group keep
            # missing each other's rebalances and the group oscillates
            # between two stable sub-covers instead of converging
            conf["heartbeat.interval.ms"] = 400
            conf["session.timeout.ms"] = 6000
        conf["partition.assignment.strategy"] = self.strategy
        return Consumer(self._conf(conf))

    # -- loops ------------------------------------------------------------
    def _consume_loop(self, i: int, delay: float,
                      lifetime: Optional[float] = None):
        """One group member. ``lifetime`` makes it a churner: it polls
        for that long, then leaves the group deliberately — overlapping
        churner lifetimes ARE the join/leave storm."""
        member = f"c{i}"
        if delay > 0 and self._stop_consumers.wait(delay):
            return
        c = self._make_consumer(i)
        oracle = self.oracle
        try:
            if self.check_group:
                def _on_assign(cons, parts, _m=member):
                    coop = cons.rebalance_protocol() == "COOPERATIVE"
                    oracle.record_assign(
                        _m, [(tp.topic, tp.partition) for tp in parts],
                        incremental=coop)
                    if coop:
                        cons.incremental_assign(parts)
                    else:
                        cons.assign(parts)

                def _on_revoke(cons, parts, _m=member):
                    if cons.rebalance_protocol() == "COOPERATIVE":
                        # KIP-429 incremental revoke: ONLY these leave;
                        # the kept set owes continuity until the next
                        # assignment (oracle window)
                        oracle.record_revoke(
                            _m, [(tp.topic, tp.partition)
                                 for tp in parts])
                        cons.incremental_unassign(parts)
                    else:
                        oracle.record_revoke(_m)
                        cons.unassign()

                c.subscribe([self.topic], on_assign=_on_assign,
                            on_revoke=_on_revoke)
            else:
                c.subscribe([self.topic])
            deadline = (time.monotonic() + lifetime
                        if lifetime is not None else None)
            was_steady = False
            while not self._stop_consumers.is_set():
                if deadline is not None and time.monotonic() >= deadline:
                    break
                m = c.poll(0.2)
                if self.check_group:
                    oracle.record_poll(member)
                    if self.check_continuity:
                        # continuity windows for REAL clients: the join
                        # FSM leaving steady marks rebalance begin (the
                        # kept partitions must flow from here until the
                        # next assignment closes the window)
                        steady = c._rk.cgrp.join_state == "steady"
                        if was_steady and not steady:
                            oracle.record_rebalance_begin(member)
                        was_steady = steady
                if m is not None and m.error is None:
                    oracle.record_consumed(m)
        except Exception as e:
            self.errors.append(f"consumer{i}: {e!r}")
        finally:
            try:
                # snapshot BEFORE close(): close tears sessions down
                # and would count its own resets
                with c._rk._brokers_lock:
                    bs = list(c._rk.brokers.values())
                self.fetch_session_stats[member] = {
                    b.name: b._fetch_session.stats() for b in bs}
            except Exception:
                pass
            if self.check_group and lifetime is not None:
                oracle.record_member_closed(member)
            c.close()

    def _produce_plain(self, p: Producer, deadline: float):
        seq = 0
        while time.monotonic() < deadline:
            v = b"s%08d" % seq
            try:
                p.produce(self.topic, v, partition=seq % self.partitions,
                          on_delivery=self.oracle.dr())
                seq += 1
            except KafkaException as e:
                if e.error.code.name == "_QUEUE_FULL":
                    p.poll(0.05)
                    continue
                raise
            p.poll(0)
            if self.pace_ms:
                time.sleep(self.pace_ms / 1000.0)
        self.produced = seq

    def _produce_txns(self, p: Producer, deadline: float):
        seq = 0
        tno = 0
        while time.monotonic() < deadline:
            tid = f"txn-{self.seed}-{tno}"
            tno += 1
            want_abort = (self.abort_every
                          and tno % self.abort_every == 0)
            self.oracle.begin_txn(tid)
            try:
                p.begin_transaction()
                for _ in range(self.txn_size):
                    v = b"s%08d" % seq
                    p.produce(self.topic, v,
                              partition=seq % self.partitions,
                              on_delivery=self.oracle.dr(tid))
                    seq += 1
                    p.poll(0)
                if want_abort:
                    p.abort_transaction(60)
                    self.oracle.abort_txn(tid)
                else:
                    p.commit_transaction(60)
                    self.oracle.commit_txn(tid)
            except KafkaException as e:
                # abortable mid-storm error: roll the txn back and keep
                # storming; if even the abort fails the outcome is
                # client-side unknowable — record it as such (the storm
                # asserts this never actually happens)
                self.errors.append(f"txn {tid}: {e!r}")
                try:
                    p.abort_transaction(60)
                    self.oracle.abort_txn(tid)
                except KafkaException as e2:
                    self.errors.append(f"txn {tid} abort: {e2!r}")
                    self.oracle.unknown_txn(tid)
            if self.pace_ms:
                time.sleep(self.pace_ms / 1000.0)
        self.produced = seq

    # -- metrics ----------------------------------------------------------
    def _storm_metrics(self, timeline: list[dict]) -> Optional[dict]:
        """Robustness-as-numbers (BENCH_r* trajectory) — the shared
        ``storm_metrics`` over this storm's oracle ack stamps."""
        with self.oracle._lock:
            acked_ts = list(self.oracle.acked_ts)
        return storm_metrics(timeline, acked_ts)

    # -- run --------------------------------------------------------------
    def run(self, schedule: Schedule, *, tamper: Optional[Callable] = None,
            raise_on_violation: bool = True) -> dict:
        trace.enable()        # flight recorder armed for the whole storm
        t0 = time.monotonic()
        consumers = []
        violation: Optional[OracleViolation] = None
        try:
            for i in range(self.n_consumers):
                delay = (self.consumer_start_delays[i]
                         if i < len(self.consumer_start_delays) else 0.0)
                th = threading.Thread(target=self._consume_loop,
                                      args=(i, delay),
                                      name=f"chaos-consumer-{i}",
                                      daemon=True)
                th.start()
                consumers.append(th)
            # churners: staggered joins, bounded lifetimes — their
            # overlap is the group join/leave storm
            for j in range(self.churn_consumers):
                idx = self.n_consumers + j
                delay = self.churn_start_s + j * self.churn_period_s
                th = threading.Thread(target=self._consume_loop,
                                      args=(idx, delay,
                                            self.churn_lifetime_s),
                                      name=f"chaos-consumer-{idx}",
                                      daemon=True)
                th.start()
                consumers.append(th)

            p = self._make_producer()
            try:
                if self.transactional:
                    p.init_transactions(30)
                self.chaos.start(schedule)
                deadline = time.monotonic() + self.duration_s
                if self.transactional:
                    self._produce_txns(p, deadline)
                else:
                    self._produce_plain(p, deadline)
                self.chaos.join(timeout=schedule.duration + 30)
                self.chaos.heal()
                left = p.flush(60)
                if left:
                    self.errors.append(f"flush left {left} undelivered")
            finally:
                self.chaos.stop()
                p.close()

            # drain: consumers keep polling until every committed ack
            # arrived (or the deadline turns the gap into a loss verdict)
            drain_end = time.monotonic() + self.drain_s
            while (self.oracle.missing_count() > 0
                   and time.monotonic() < drain_end):
                time.sleep(0.2)
            # one extra grace round so trailing duplicates/reorders
            # land in the ledger too, not just the last missing ack
            time.sleep(0.5)

            # group-invariant storms: the still-live members must
            # settle into one exact cover of the partitions; the time
            # that takes (from storm end) is the convergence metric
            group_snapshot = None
            if self.check_group:
                conv_t0 = time.monotonic()
                conv_end = conv_t0 + self.converge_s
                while time.monotonic() < conv_end:
                    if self.oracle.group_coverage(
                            self.topic, self.partitions)["converged"]:
                        self._converged_s = round(
                            time.monotonic() - conv_t0, 2)
                        break
                    time.sleep(0.2)
                # freeze the verdict BEFORE teardown: stopping the
                # consumers is a deliberate LeaveGroup cascade that a
                # live recompute would misread as lost coverage
                group_snapshot = {
                    "coverage": self.oracle.group_coverage(
                        self.topic, self.partitions),
                    "now": time.monotonic()}

            self._stop_consumers.set()
            for th in consumers:
                th.join(15)

            if tamper is not None:
                tamper(self.oracle)
            group_kwargs = {}
            if self.check_group:
                group_kwargs = {"check_group": True,
                                "group_topic": self.topic,
                                "group_partitions": self.partitions,
                                "converged_s": self._converged_s,
                                "converge_bound_s": self.converge_bound_s,
                                "coverage": group_snapshot["coverage"],
                                "now": group_snapshot["now"]}
            if self.check_continuity:
                group_kwargs.update(check_continuity=True,
                                    flow_stall_s=self.flow_stall_s)
            try:
                report = self.oracle.verify(
                    check_duplicates=self.check_duplicates,
                    check_order=self.check_order,
                    raise_on_violation=raise_on_violation,
                    **group_kwargs)
            except OracleViolation as v:
                violation = v
                report = v.report
            report.update({
                "seed": self.seed,
                "external": self.external,
                "produced": self.produced,
                "wall_s": round(time.monotonic() - t0, 2),
                "timeline": self.chaos.timeline,
                "replay_key": self.chaos.replay_key(),
                "schedule_errors": self.chaos.errors,
                "errors": self.errors,
            })
            metrics = self._storm_metrics(self.chaos.timeline)
            if metrics is not None:
                report["storm_metrics"] = metrics
            if self.external:
                report["proc_events"] = list(self.cluster.proc_events)
            if violation is not None:
                raise violation
            return report
        finally:
            self._stop_consumers.set()
            for th in consumers:
                th.join(15)
            self.chaos.stop()
            if self.sockem is not None:
                self.sockem.kill_all()
            self.cluster.stop()
            trace.disable()


# ----------------------------------------------------------- lite storm --
class LiteStorm:  # lint: ok shared-state
    """A storm over :class:`~.members.LiteMemberFleet` — hundreds-to-
    1000 thread-cheap group members instead of full ``Consumer``
    instances, plus one real paced producer.  The scale tier of the
    consumer-group axis: Storm proves the REAL client's cooperative
    protocol; LiteStorm proves the group machinery (mock coordinator,
    assignor, continuity oracle) at member counts no in-process
    Consumer army could reach.

    shared-state pragma: the producer thread and the fleet's workers
    communicate exclusively through the oracle's declared ledgers and
    the fleet's own declared books; the storm thread reads after
    joins."""

    def __init__(self, *, seed: int, brokers: int = 3,
                 partitions: int = 16, topic: str = "coop",
                 external: bool = False, min_alive: int = 1,
                 members: int = 100, churners: int = 0,
                 churn_start_s: float = 2.0, churn_period_s: float = 0.05,
                 churn_lifetime_s: float = 4.0,
                 strategy: str = "cooperative-sticky", threads: int = 8,
                 heartbeat_s: float = 0.4, member_stagger_s: float = 0.0,
                 duration_s: float = 8.0, pace_ms: float = 2.0,
                 drain_s: float = 30.0, converge_s: float = 40.0,
                 converge_bound_s: Optional[float] = None,
                 check_continuity: bool = True,
                 flow_stall_s: float = 2.0,
                 initial_delay_ms: int = 0):
        self.seed = seed
        self.topic = topic
        self.partitions = partitions
        self.external = external
        self.members = members
        self.churners = churners
        self.duration_s = duration_s
        self.pace_ms = pace_ms
        self.drain_s = drain_s
        self.converge_s = converge_s
        self.converge_bound_s = converge_bound_s
        self.check_continuity = check_continuity
        self.flow_stall_s = flow_stall_s
        if external:
            self.cluster = ClusterHandle(brokers=brokers,
                                         topics={topic: partitions})
        else:
            self.cluster = MockCluster(
                num_brokers=brokers, topics={topic: partitions},
                group_initial_rebalance_delay_ms=initial_delay_ms)
        self.oracle = DeliveryOracle(track_flow=check_continuity)
        self.chaos = ChaosScheduler(self.cluster, None,
                                    min_alive=min_alive)
        self.fleet = LiteMemberFleet(
            self.cluster.bootstrap_servers(), group_id=f"lite-g-{seed}",
            topic=topic, partitions=partitions, members=members,
            oracle=self.oracle, seed=seed, strategy=strategy,
            threads=threads, heartbeat_s=heartbeat_s,
            member_stagger_s=member_stagger_s,
            churn_members=churners, churn_start_s=churn_start_s,
            churn_period_s=churn_period_s,
            churn_lifetime_s=churn_lifetime_s)
        self.produced = 0
        self.errors: list[str] = []
        self._converged_s: Optional[float] = None

    def run(self, schedule: Schedule, *,
            tamper: Optional[Callable] = None,
            raise_on_violation: bool = True) -> dict:
        trace.enable()
        t0 = time.monotonic()
        p = Producer({
            "bootstrap.servers": self.cluster.bootstrap_servers(),
            "linger.ms": 2, "enable.idempotence": True,
            "compression.codec": "none",   # lite fetchers parse raw v2
            "message.send.max.retries": 1000, "retry.backoff.ms": 50,
            "message.timeout.ms": 120000, "reconnect.backoff.ms": 50,
            "reconnect.backoff.max.ms": 1000})
        try:
            self.fleet.start()
            self.chaos.start(schedule)
            deadline = time.monotonic() + self.duration_s
            seq = 0
            while time.monotonic() < deadline:
                v = b"s%08d" % seq
                try:
                    p.produce(self.topic, v,
                              partition=seq % self.partitions,
                              on_delivery=self.oracle.dr())
                    seq += 1
                except KafkaException as e:
                    if e.error.code.name == "_QUEUE_FULL":
                        p.poll(0.05)
                        continue
                    raise
                p.poll(0)
                if self.pace_ms:
                    time.sleep(self.pace_ms / 1000.0)
            self.produced = seq
            self.chaos.join(timeout=schedule.duration + 30)
            self.chaos.heal()
            left = p.flush(60)
            if left:
                self.errors.append(f"flush left {left} undelivered")
            storm_end = time.monotonic()

            drain_end = time.monotonic() + self.drain_s
            while (self.oracle.missing_count() > 0
                   and time.monotonic() < drain_end):
                time.sleep(0.2)

            conv_end = storm_end + self.converge_s
            while time.monotonic() < conv_end:
                if self.oracle.group_coverage(
                        self.topic, self.partitions)["converged"]:
                    self._converged_s = round(
                        time.monotonic() - storm_end, 2)
                    break
                time.sleep(0.2)
            group_snapshot = {
                "coverage": self.oracle.group_coverage(self.topic,
                                                       self.partitions),
                "now": time.monotonic()}
            unavail = self.fleet.partition_unavailability(
                group_snapshot["now"])
            self.fleet.stop()

            if tamper is not None:
                tamper(self.oracle)
            violation: Optional[OracleViolation] = None
            try:
                report = self.oracle.verify(
                    check_duplicates=False, check_order=False,
                    check_group=True, group_topic=self.topic,
                    group_partitions=self.partitions,
                    converged_s=self._converged_s,
                    converge_bound_s=self.converge_bound_s,
                    check_continuity=self.check_continuity,
                    flow_stall_s=self.flow_stall_s,
                    coverage=group_snapshot["coverage"],
                    now=group_snapshot["now"],
                    raise_on_violation=raise_on_violation)
            except OracleViolation as v:
                violation = v
                report = v.report
            report.update({
                "seed": self.seed,
                "external": self.external,
                "produced": self.produced,
                "members": self.members + self.churners,
                "live_members": self.fleet.live_member_count(),
                "converged_s": self._converged_s,
                "partition_unavailability": unavail,
                "rebalancing_intervals":
                    len(self.fleet.rebalancing_intervals(
                        group_snapshot["now"])),
                "wall_s": round(time.monotonic() - t0, 2),
                "timeline": self.chaos.timeline,
                "replay_key": self.chaos.replay_key(),
                "schedule_errors": self.chaos.errors,
                "errors": self.errors + list(self.fleet.errors),
            })
            with self.oracle._lock:
                acked_ts = list(self.oracle.acked_ts)
            metrics = storm_metrics(self.chaos.timeline, acked_ts)
            if metrics is not None:
                report["storm_metrics"] = metrics
            if self.external:
                report["proc_events"] = list(self.cluster.proc_events)
            if violation is not None:
                raise violation
            return report
        finally:
            self.fleet.stop()
            self.chaos.stop()
            p.close()
            self.cluster.stop()
            trace.disable()


# ------------------------------------------------------------ scenarios --
def rolling_restart_eos(seed: int = 1, *, kills: int = 5,
                        raise_on_violation: bool = True) -> dict:
    """In-process flagship: >=5 rolling broker kill/restarts
    under sustained transactional produce + read_committed consume."""
    interval = 1.2
    storm = Storm(seed=seed, brokers=3, partitions=4, min_alive=2,
                  transactional=True, txn_size=5, abort_every=7,
                  duration_s=1.0 + kills * interval + 0.5, pace_ms=2,
                  drain_s=30.0)
    sched = Schedule(seed=seed)
    for i in range(kills):
        t = 1.0 + i * interval
        sched.at(t, broker_kill("any"))
        sched.at(t + 0.7, broker_restart())    # revive in kill order
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    kills_fired = sum(1 for e in report["timeline"]
                      if e["action"] == "broker_kill"
                      and (e.get("resolved") or {}).get("broker"))
    report["kills_fired"] = kills_fired
    return report


def external_kill9_eos(seed: int = 21, *, kills: int = 3,
                       raise_on_violation: bool = True) -> dict:
    """FLAGSHIP: >=3 ``SIGKILL``s of real broker OS
    processes — pid-verified dead — under sustained EOS produce +
    read_committed consume; the oracle asserts all four delivery
    invariants PLUS the group invariants (the consumer must re-acquire
    full coverage after every kill, converge, and never wedge).

    The EOS consumer is a single-member group: zero-duplication across
    partition OWNERSHIP TRANSFER would require transactional offset
    commits (a consume-transform-produce loop), which this storm does
    not run — multi-member assignment churn is covered at-least-once
    by ``group_churn_coordinator_storm``/``fast_group_churn``."""
    interval = 1.8
    storm = Storm(seed=seed, brokers=3, partitions=4, min_alive=2,
                  external=True, transactional=True, txn_size=4,
                  abort_every=6, consumers=1, check_group=True,
                  duration_s=1.0 + kills * interval + 0.5, pace_ms=2,
                  drain_s=40.0)
    sched = Schedule(seed=seed)
    for i in range(kills):
        t = 1.0 + i * interval
        sched.at(t, proc_kill9("any"))
        sched.at(t + 1.0, proc_restart())      # respawn in kill order
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    report["kills_fired"] = sum(
        1 for e in report["timeline"] if e["action"] == "proc_kill9"
        and (e.get("resolved") or {}).get("broker"))
    report["pids_killed"] = [e for e in report.get("proc_events", [])
                             if e["verb"] == "kill9"]
    return report


def coordinator_death_midcommit(seed: int = 2, *, rounds: int = 3,
                                raise_on_violation: bool = True) -> dict:
    """Kill the transaction coordinator while commits are in flight;
    the client must FindCoordinator its way to the failover broker and
    the retried EndTxn must stay idempotent (no torn txns)."""
    storm = Storm(seed=seed, brokers=3, partitions=2, min_alive=2,
                  transactional=True, txn_size=4, abort_every=5,
                  duration_s=1.0 + rounds * 2.0, pace_ms=2, drain_s=30.0)
    tid = f"chaos-tx-{seed}"          # Storm._make_producer's txn id
    sched = Schedule(seed=seed)
    for i in range(rounds):
        t = 1.0 + i * 2.0
        sched.at(t, broker_kill(f"coordinator:{tid}"))
        sched.at(t + 1.0, broker_restart())
    return storm.run(sched, raise_on_violation=raise_on_violation)


def leader_migration_midbatch(seed: int = 3, *, migrations: int = 8,
                              raise_on_violation: bool = True) -> dict:
    """Migrate partition leadership every 400 ms while an idempotent
    producer streams batches: every NOT_LEADER redirect must re-route
    without loss, duplication, or reorder."""
    storm = Storm(seed=seed, brokers=3, partitions=4,
                  duration_s=1.0 + migrations * 0.4, pace_ms=2,
                  drain_s=20.0)
    sched = Schedule(seed=seed).every(
        0.8, 0.4, migrations, lambda: leader_migrate("chaos", "any"))
    return storm.run(sched, raise_on_violation=raise_on_violation)


def slow_network_rebalance(seed: int = 4, *,
                           raise_on_violation: bool = True) -> dict:
    """Slow, jittery, briefly half-partitioned network while a second
    consumer joins mid-stream (eager rebalance): plain consumer-group
    semantics are at-least-once, so only zero-loss is asserted —
    duplicates/reorder across the handoff are legal here."""
    storm = Storm(seed=seed, brokers=2, partitions=4, use_sockem=True,
                  consumers=2, consumer_start_delays=(0.0, 1.5),
                  isolation="read_uncommitted",
                  check_duplicates=False, check_order=False,
                  duration_s=4.5, pace_ms=3, drain_s=25.0)
    sched = (Schedule(seed=seed)
             .at(0.5, net(delay_ms=120, jitter_ms=80))
             .at(2.0, net(rx_drop=True))          # half-open partition
             .at(2.6, net(rx_drop=False))
             .at(3.2, conn_kill())
             .at(4.0, net(delay_ms=0, jitter_ms=0)))
    return storm.run(sched, raise_on_violation=raise_on_violation)


def group_churn_coordinator_storm(seed: int = 31, *, consumers: int = 12,
                                  churners: int = 8,
                                  raise_on_violation: bool = True) -> dict:
    """Consumer-group-heavy storm: a large group (``consumers`` stable
    members + ``churners`` joining/leaving on overlapping lifetimes)
    rebalances continuously while the GROUP coordinator broker is
    killed twice mid-churn.  At-least-once delivery (duplicates across
    handoffs are legal) but zero loss — and the group invariants must
    hold: the survivors converge to one exact cover of the partitions
    and nobody ends up permanently stuck."""
    gid = f"chaos-g-{seed}"
    storm = Storm(seed=seed, brokers=3, partitions=8, min_alive=2,
                  consumers=consumers,
                  consumer_start_delays=tuple(0.05 * i
                                              for i in range(consumers)),
                  check_group=True, converge_s=25.0,
                  churn_consumers=churners, churn_start_s=1.0,
                  churn_period_s=0.45, churn_lifetime_s=2.2,
                  isolation="read_uncommitted",
                  check_duplicates=False, check_order=False,
                  duration_s=6.0, pace_ms=2, drain_s=30.0)
    sched = (Schedule(seed=seed)
             .at(1.6, broker_kill(f"coordinator:{gid}"))
             .at(2.8, broker_restart())
             .at(3.8, broker_kill(f"coordinator:{gid}"))
             .at(5.0, broker_restart()))
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    report["converged_s"] = storm._converged_s
    return report


def fast_kill_restart(seed: int = 7, *,
                      raise_on_violation: bool = True) -> dict:
    """Tier-1 deterministic smoke (<10 s): one broker kill + restart
    under idempotent produce/consume, full invariant check."""
    storm = Storm(seed=seed, brokers=2, partitions=2, min_alive=1,
                  duration_s=2.2, pace_ms=2, drain_s=15.0)
    sched = (Schedule(seed=seed)
             .at(0.7, broker_kill("any"))
             .at(1.5, broker_restart()))
    return storm.run(sched, raise_on_violation=raise_on_violation)


def fast_external_kill9(seed: int = 23, *,
                        raise_on_violation: bool = True) -> dict:
    """Tier-1 out-of-process smoke (<15 s): one real ``SIGKILL`` of a
    broker OS process (pid-verified) + one SIGSTOP/SIGCONT brownout
    under idempotent produce/consume, full invariant check.  Also the
    source of the bench ``storm_msgs_s``/recovery metrics."""
    storm = Storm(seed=seed, brokers=2, partitions=2, min_alive=1,
                  external=True, duration_s=3.0, pace_ms=2, drain_s=20.0)
    sched = (Schedule(seed=seed)
             .at(0.6, proc_pause("any"))
             .at(1.2, proc_cont())
             .at(1.6, proc_kill9("any"))
             .at(2.4, proc_restart()))
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    report["pids_killed"] = [e for e in report.get("proc_events", [])
                             if e["verb"] == "kill9"]
    return report


def fast_session_kill9(seed: int = 57, *,
                       raise_on_violation: bool = True) -> dict:
    """Tier-1 fetch-session chaos smoke (<15 s): one real
    ``SIGKILL`` of a broker OS process (pid-verified) under idempotent
    produce + consume with KIP-227 incremental fetch sessions on.  The
    session cache is broker MEMORY — it dies with the process — so the
    reconnecting client must renegotiate from epoch 0 (a fresh full
    fetch) and keep delivering with zero acked loss.  Asserted off the
    per-member ``FetchSession`` counters the storm snapshots at
    teardown.  Broker 1 is SIGKILLed and restarted, then broker 2 is
    SIGKILLed — failing every partition back onto broker 1, so the
    client MUST renegotiate the session its disconnect reset: broker
    1's counters deterministically show resets >= 1 AND full_fetches
    >= 2 (the initial create + the post-kill renegotiation)."""
    storm = Storm(seed=seed, brokers=2, partitions=2, min_alive=1,
                  external=True, duration_s=4.0, pace_ms=2, drain_s=20.0)
    sched = (Schedule(seed=seed)
             .at(1.4, proc_kill9(1))
             .at(2.2, proc_restart())
             .at(2.8, proc_kill9(2))
             .at(3.6, proc_restart()))
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    report["pids_killed"] = [e for e in report.get("proc_events", [])
                             if e["verb"] == "kill9"]
    fs = storm.fetch_session_stats.get("c0", {})
    report["fetch_sessions"] = fs
    if raise_on_violation:
        assert len(report["pids_killed"]) == 2 and all(
            e["verified_dead"] for e in report["pids_killed"]), \
            "expected two pid-verified SIGKILLs"
        b1 = next((s for n, s in fs.items() if n.endswith("/1")), None)
        assert b1 is not None, f"no broker-1 session stats: {list(fs)}"
        assert b1["resets"] >= 1, \
            "broker SIGKILL never reset the fetch session"
        assert b1["full_fetches"] >= 2, \
            "no renegotiation after the broker came back"
        live = [s for s in fs.values() if s["partitions_total"] > 0]
        assert live, "no fetch session was live at teardown"
    return report


def fast_group_churn(seed: int = 33, *,
                     raise_on_violation: bool = True) -> dict:
    """Tier-1 group smoke (<12 s): 4 stable members + 2 churners, one
    coordinator kill mid-rebalance, zero-loss + group invariants."""
    gid = f"chaos-g-{seed}"
    storm = Storm(seed=seed, brokers=2, partitions=4, min_alive=1,
                  consumers=4,
                  consumer_start_delays=(0.0, 0.1, 0.2, 0.3),
                  check_group=True, converge_s=20.0,
                  churn_consumers=2, churn_start_s=0.8,
                  churn_period_s=0.5, churn_lifetime_s=1.2,
                  isolation="read_uncommitted",
                  check_duplicates=False, check_order=False,
                  duration_s=3.0, pace_ms=2, drain_s=20.0)
    sched = (Schedule(seed=seed)
             .at(1.2, broker_kill(f"coordinator:{gid}"))
             .at(2.2, broker_restart()))
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    report["converged_s"] = storm._converged_s
    return report


def fast_cooperative_churn(seed: int = 35, *,
                           raise_on_violation: bool = True) -> dict:
    """Tier-1 cooperative smoke (<14 s): 4 stable + 2 churning REAL
    ``Consumer`` members on the KIP-429 ``cooperative-sticky``
    protocol, one coordinator kill mid-rebalance.  Zero-loss + group
    invariants PLUS the continuity invariant: every partition a member
    keeps through a rebalance must keep flowing (zero stop-the-world
    windows), and convergence lands inside the stated bound."""
    gid = f"chaos-g-{seed}"
    storm = Storm(seed=seed, brokers=2, partitions=4, min_alive=1,
                  consumers=4,
                  consumer_start_delays=(0.0, 0.1, 0.2, 0.3),
                  check_group=True, converge_s=20.0,
                  strategy="cooperative-sticky",
                  check_continuity=True, flow_stall_s=2.5,
                  converge_bound_s=20.0,
                  churn_consumers=2, churn_start_s=0.8,
                  churn_period_s=0.5, churn_lifetime_s=1.2,
                  isolation="read_uncommitted",
                  check_duplicates=False, check_order=False,
                  duration_s=3.5, pace_ms=2, drain_s=20.0)
    sched = (Schedule(seed=seed)
             .at(1.2, broker_kill(f"coordinator:{gid}"))
             .at(2.2, broker_restart()))
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    report["converged_s"] = storm._converged_s
    return report


def cooperative_coordinator_storm(seed: int = 37, *, consumers: int = 12,
                                  churners: int = 8,
                                  raise_on_violation: bool = True) -> dict:
    """Cooperative twin of ``group_churn_coordinator_storm`` (slow):
    12 stable + 8 churning cooperative-sticky members rebalance
    continuously while the group coordinator is killed TWICE
    mid-rebalance — zero loss, group invariants, and the continuity
    invariant across every window."""
    gid = f"chaos-g-{seed}"
    storm = Storm(seed=seed, brokers=3, partitions=8, min_alive=2,
                  consumers=consumers,
                  consumer_start_delays=tuple(0.05 * i
                                              for i in range(consumers)),
                  check_group=True, converge_s=25.0,
                  strategy="cooperative-sticky",
                  check_continuity=True, flow_stall_s=2.5,
                  converge_bound_s=25.0,
                  churn_consumers=churners, churn_start_s=1.0,
                  churn_period_s=0.45, churn_lifetime_s=2.2,
                  isolation="read_uncommitted",
                  check_duplicates=False, check_order=False,
                  duration_s=6.0, pace_ms=2, drain_s=30.0)
    sched = (Schedule(seed=seed)
             .at(1.6, broker_kill(f"coordinator:{gid}"))
             .at(2.8, broker_restart())
             .at(3.8, broker_kill(f"coordinator:{gid}"))
             .at(5.0, broker_restart()))
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    report["converged_s"] = storm._converged_s
    return report


def cooperative_churn_storm(seed: int = 55, *, members: int = 240,
                            churners: int = 80, external: bool = True,
                            kills: int = 1,
                            raise_on_violation: bool = True) -> dict:
    """FLAGSHIP: ≥300 thread-cheap cooperative members —
    ``members`` stable + ``churners`` on overlapping join/leave
    lifetimes — against the supervised out-of-process cluster, with
    the group COORDINATOR process SIGKILLed (pid-verified) mid-churn,
    i.e. mid-rebalance: the churn keeps the group permanently
    rebalancing.  The oracle asserts zero acked loss, exact final
    coverage, no stuck member, **zero stop-the-world windows** (every
    kept partition flows through every rebalance window — the
    continuity invariant) and convergence within the stated bound.
    Same seed ⇒ identical ``replay_key`` across supervisor launches
    (the replay contract, now at 1000-member scale)."""
    gid = f"lite-g-{seed}"
    storm = LiteStorm(seed=seed, brokers=3, partitions=16,
                      external=external, min_alive=2,
                      members=members, churners=churners,
                      churn_start_s=2.0, churn_period_s=0.05,
                      churn_lifetime_s=4.0,
                      strategy="cooperative-sticky", threads=8,
                      heartbeat_s=0.5, member_stagger_s=0.004,
                      duration_s=4.0 + churners * 0.05 + 4.0,
                      pace_ms=2, drain_s=40.0,
                      converge_s=45.0, converge_bound_s=45.0,
                      check_continuity=True, flow_stall_s=3.0)
    sched = Schedule(seed=seed)
    kill_verb = proc_kill9 if external else broker_kill
    restart_verb = proc_restart if external else broker_restart
    for i in range(kills):
        t = 4.0 + i * 3.0
        sched.at(t, kill_verb(f"coordinator:{gid}"))
        sched.at(t + 1.5, restart_verb())
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    report["kills_fired"] = sum(
        1 for e in report["timeline"]
        if e["action"] in ("proc_kill9", "broker_kill")
        and (e.get("resolved") or {}).get("broker"))
    if external:
        report["pids_killed"] = [e for e in report.get("proc_events", [])
                                 if e["verb"] == "kill9"]
    return report


def oracle_continuity_selftest(seed: int = 39) -> dict:
    """Intentionally broken continuity: a quiet cooperative run whose
    ledger is tampered with a SYNTHETIC flow gap — a rebalance window
    over an unrevoked partition whose consume stamps inside the window
    are deleted.  Proves the flow-gap detector yields an
    OracleViolation carrying the JSON diff + flight dump (mirrors
    ``oracle_selftest``).  Returns the report (ok=False)."""
    topic = "chaos"

    def _tamper(oracle: DeliveryOracle):
        with oracle._lock:
            stamps = sorted(oracle.flow.get((topic, 0), ()))
            if len(stamps) < 4:
                raise AssertionError(
                    "continuity self-test: no flow recorded to tamper")
            w0, w1 = stamps[0], stamps[-1]
            # plant: a window claiming (topic, 0) was kept throughout,
            # then erase its stamps after the first 10% of the window
            oracle.windows.append(
                ("selftest-m", w0, w1, frozenset({(topic, 0)})))
            cut = w0 + (w1 - w0) * 0.1
            oracle.flow[(topic, 0)] = [t for t in stamps if t <= cut]

    storm = Storm(seed=seed, brokers=1, partitions=2, consumers=1,
                  check_group=True, strategy="cooperative-sticky",
                  check_continuity=True, flow_stall_s=1.0,
                  isolation="read_uncommitted",
                  check_duplicates=False, check_order=False,
                  duration_s=3.0, pace_ms=2, drain_s=12.0)
    try:
        storm.run(Schedule(seed=seed), tamper=_tamper)
    except OracleViolation as v:
        if not v.report["violations"].get("flow_gap"):
            raise AssertionError(
                "continuity self-test: violation raised but no "
                "flow_gap row — wrong detector fired") from v
        return v.report
    raise AssertionError("continuity self-test: planted flow gap was "
                         "not flagged — the continuity oracle is blind")


def fast_net_flap(seed: int = 11, *,
                  raise_on_violation: bool = True) -> dict:
    """Tier-1 deterministic smoke (<10 s): partial writes, latency
    jitter and a mid-flight connection kill via sockem, full invariant
    check on a single-broker cluster."""
    storm = Storm(seed=seed, brokers=1, partitions=2, use_sockem=True,
                  duration_s=2.2, pace_ms=2, drain_s=15.0)
    sched = (Schedule(seed=seed)
             .at(0.3, net(max_write=7))
             .at(0.8, net(delay_ms=80, jitter_ms=40, max_write=0))
             .at(1.3, conn_kill())
             .at(1.7, net(delay_ms=0, jitter_ms=0)))
    return storm.run(sched, raise_on_violation=raise_on_violation)


def soak_kill9_txn_storm(seed: int = 41, *, minutes: float = 2.5,
                         raise_on_violation: bool = True) -> dict:
    """LONG SOAK (``scripts/chaos.sh --soak``): minutes of unpaced EOS
    transactions against the external cluster under repeated
    ``SIGKILL``/respawn cycles — the endurance tier: thousands of
    txns, a kill every ~4 s, every invariant checked at the end."""
    duration = minutes * 60.0
    cycle = 4.0
    cycles = max(1, int((duration - 3.0) / cycle))
    storm = Storm(seed=seed, brokers=3, partitions=4, min_alive=2,
                  external=True, transactional=True, txn_size=3,
                  abort_every=9, consumers=1, check_group=True,
                  duration_s=duration, pace_ms=0, drain_s=60.0)
    sched = Schedule(seed=seed)
    for i in range(cycles):
        t = 2.0 + i * cycle
        sched.at(t, proc_kill9("any"))
        sched.at(t + 2.0, proc_restart())
    report = storm.run(sched, raise_on_violation=raise_on_violation)
    report["kills_fired"] = sum(
        1 for e in report["timeline"] if e["action"] == "proc_kill9"
        and (e.get("resolved") or {}).get("broker"))
    return report


def oracle_selftest(seed: int = 13) -> dict:
    """Intentionally broken: a quiet run whose ledger is tampered
    (one consumed record dropped = loss; one double-recorded = dup)
    to prove a violation yields an OracleViolation carrying a flight-
    recorder dump + oracle diff. Returns the report (ok=False)."""
    def _tamper(oracle: DeliveryOracle):
        with oracle._lock:
            if len(oracle.consumed) >= 2:
                oracle.consumed.pop()                    # lose one
                oracle.consumed.append(oracle.consumed[0])   # dup one
    storm = Storm(seed=seed, brokers=1, partitions=1,
                  duration_s=0.8, pace_ms=2, drain_s=10.0)
    try:
        storm.run(Schedule(seed=seed), tamper=_tamper)
    except OracleViolation as v:
        return v.report
    raise AssertionError("oracle self-test: tampered ledger was not "
                         "flagged — the oracle is blind")


def hot_topic_flood(seed: int = 17, *, flood_s: float = 2.0,
                    raise_on_violation: bool = True,
                    device: Optional[str] = None) -> dict:
    """QoS isolation under a bulk flood: one producer runs a
    latency-sensitive topic (``topic.qos.weight`` 8.0) and a zipf-sized
    bulk topic (weight 0.25) through the device compress route with the
    governor's weighted fan-in + shed model live.  The latency topic's
    produce→ack p99 is measured unloaded, then again with the flood
    active — isolation holds when the flooded p99 stays within 3× the
    unloaded p99 (with an absolute floor: on a 1-core CI host the
    unloaded p99 can be a fraction of a millisecond, where 3× is
    noise), every latency message acks, and the bulk topic still makes
    progress (weighting dims, never starves).  Warmup stays ON — the
    warm gate serving cold buckets from the bit-exact CPU encoder is
    exactly what keeps the kernel's build and first launch out of the
    latency path.  ``device`` is ``gpu.device``: the card (``None``, the
    default) or ``"cpu"``, the kernels' plain versions."""
    import random as _random

    rng = _random.Random(seed)
    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "compression.backend": "gpu",
                  "gpu.device": device or "cuda",
                  "gpu.transport.min.mb.s": 0,
                  "gpu.compress.device": True,
                  "gpu.launch.min.batches": 1,
                  "gpu.governor": True, "gpu.warmup": True,
                  "compression.codec": "lz4", "linger.ms": 2,
                  "batch.num.messages": 32})
    report: dict = {"ok": False, "seed": seed}
    try:
        p._rk.set_topic_conf("qos-latency", {"topic.qos.weight": 8.0})
        p._rk.set_topic_conf("qos-bulk", {"topic.qos.weight": 0.25})

        lat_lock = new_lock("chaos.hot_topic_flood")
        lat_unloaded: list[float] = []
        lat_flood: list[float] = []
        bulk_acked = [0]

        def lat_dr(sink, t0, err, _msg):
            if err is None:
                with lat_lock:
                    sink.append((time.perf_counter() - t0) * 1e3)

        def bulk_dr(err, _msg):
            if err is None:
                with lat_lock:
                    bulk_acked[0] += 1

        def ping(sink):
            t0 = time.perf_counter()
            p.produce("qos-latency", value=b"lat-ping " * 40,
                      on_delivery=lambda e, m, s=sink, t=t0:
                      lat_dr(s, t, e, m))

        # -- phase 1: unloaded baseline ------------------------------
        for _ in range(40):
            ping(lat_unloaded)
            p.poll(0.01)
        p.flush(60)

        # -- phase 2: zipf bulk flood + concurrent latency pings -----
        stop = threading.Event()
        sent_bulk = [0]

        def flood():
            while not stop.is_set():
                # zipf-skewed bulk payloads: mostly small, heavy tail
                n = min(int(2000 * (1.0 / (1.0 - rng.random()) ** 1.2)),
                        120_000)
                try:
                    p.produce("qos-bulk", value=b"\xa5" * max(n, 100),
                              on_delivery=bulk_dr)
                    sent_bulk[0] += 1
                except BufferError:
                    time.sleep(0.002)
                time.sleep(0.0005)

        flooder = threading.Thread(target=flood, name="qos-flooder",
                                   daemon=True)
        flooder.start()
        t_end = time.monotonic() + flood_s
        while time.monotonic() < t_end:
            ping(lat_flood)
            p.poll(0.02)
        stop.set()
        flooder.join(10)
        p.flush(120)

        import json as _json
        stats = _json.loads(p._rk.stats.emit_json())
        comp = stats["codec_engine"]["compress"]
        with lat_lock:
            p99_un = _pct(lat_unloaded, 0.99)
            p99_fl = _pct(lat_flood, 0.99)
            n_un, n_fl = len(lat_unloaded), len(lat_flood)
            bulk_n = bulk_acked[0]
        # 3× isolation bound with an absolute floor (sub-ms unloaded
        # p99s make a pure ratio meaningless on shared CI hosts)
        bound = max(3.0 * (p99_un or 0.0), 100.0)
        pings = 40 + n_fl
        report.update({
            "p99_unloaded_ms": p99_un, "p99_flood_ms": p99_fl,
            "bound_ms": round(bound, 1), "latency_acked": n_un + n_fl,
            "latency_sent": pings, "bulk_sent": sent_bulk[0],
            "bulk_acked": bulk_n, "compress": comp,
            "qos": comp["qos"]})
        ok = (p99_fl is not None and p99_fl <= bound
              and n_un + n_fl == pings        # every latency msg acked
              and bulk_n > 0)                # flood progressed too
        report["ok"] = ok
        if raise_on_violation and not ok:
            raise AssertionError(
                f"QoS isolation violated: flood p99 {p99_fl}ms vs "
                f"bound {bound:.1f}ms (unloaded {p99_un}ms), "
                f"latency acked {n_un + n_fl}/{pings}, "
                f"bulk acked {bulk_n}")
        return report
    finally:
        p.close()


class Scenario(NamedTuple):
    fn: Callable
    desc: str
    tier: str          # "fast" (tier-1) | "slow" | "soak"
    seed: int          # default seed (CLI --seed overrides = replay)
    invariants: str    # what the oracle asserts for this storm


SCENARIOS: dict[str, Scenario] = {
    "rolling_restart_eos": Scenario(
        rolling_restart_eos,
        "in-process flagship: >=5 rolling broker kill/restarts under "
        "EOS produce + read_committed consume", "slow", 1,
        "loss,dup,order,atomicity"),
    "external_kill9_eos": Scenario(
        external_kill9_eos,
        "OUT-OF-PROCESS flagship: >=3 SIGKILLs of real broker OS "
        "processes (pid-verified) under EOS + read_committed, "
        "2-member group", "slow", 21,
        "loss,dup,order,atomicity,group"),
    "coordinator_death_midcommit": Scenario(
        coordinator_death_midcommit,
        "kill the txn coordinator mid-commit; EndTxn retry must stay "
        "idempotent across failover", "slow", 2,
        "loss,dup,order,atomicity"),
    "leader_migration_midbatch": Scenario(
        leader_migration_midbatch,
        "migrate partition leaders every 400ms under idempotent "
        "produce", "slow", 3, "loss,dup,order"),
    "slow_network_rebalance": Scenario(
        slow_network_rebalance,
        "slow/jittery/half-partitioned network during a consumer-group "
        "rebalance (zero-loss)", "slow", 4, "loss"),
    "group_churn_coordinator_storm": Scenario(
        group_churn_coordinator_storm,
        "12 stable + 8 churning consumers rebalance while the group "
        "coordinator dies twice", "slow", 31, "loss,group"),
    "fast_kill_restart": Scenario(
        fast_kill_restart,
        "tier-1 smoke: one kill/restart, full invariants, <10s",
        "fast", 7, "loss,dup,order"),
    "fast_external_kill9": Scenario(
        fast_external_kill9,
        "tier-1 smoke: real SIGKILL + SIGSTOP brownout of broker OS "
        "processes, <15s", "fast", 23, "loss,dup,order"),
    "fast_session_kill9": Scenario(
        fast_session_kill9,
        "tier-1 smoke: pid-verified broker SIGKILL under incremental "
        "fetch sessions — session dies with the broker, client "
        "renegotiates, zero loss, <15s", "fast", 57, "loss,dup,order"),
    "fast_group_churn": Scenario(
        fast_group_churn,
        "tier-1 smoke: 4+2-member group churn across a coordinator "
        "kill, <12s", "fast", 33, "loss,group"),
    "fast_cooperative_churn": Scenario(
        fast_cooperative_churn,
        "tier-1 smoke: 4+2 cooperative-sticky members churn across a "
        "coordinator kill — continuity invariant on, <14s",
        "fast", 35, "loss,group,continuity"),
    "cooperative_coordinator_storm": Scenario(
        cooperative_coordinator_storm,
        "12+8 cooperative-sticky members rebalance while the "
        "coordinator dies twice — zero stop-the-world windows",
        "slow", 37, "loss,group,continuity"),
    "cooperative_churn_storm": Scenario(
        cooperative_churn_storm,
        "FLAGSHIP: >=300 thread-cheap cooperative members under "
        "overlapping join/leave churn + a pid-verified coordinator "
        "SIGKILL mid-rebalance — continuity + bounded convergence",
        "slow", 55, "loss,group,continuity,convergence-bound"),
    "oracle_continuity_selftest": Scenario(
        oracle_continuity_selftest,
        "intentionally broken: a synthetic flow gap on an unrevoked "
        "partition must dump flight + diff", "fast", 39, "selftest"),
    "fast_net_flap": Scenario(
        fast_net_flap,
        "tier-1 smoke: partial writes + jitter + conn kill, <10s",
        "fast", 11, "loss,dup,order"),
    "soak_kill9_txn_storm": Scenario(
        soak_kill9_txn_storm,
        "SOAK: minutes of unpaced EOS txns under repeated SIGKILL "
        "cycles of real broker processes", "soak", 41,
        "loss,dup,order,atomicity,group"),
    "oracle_selftest": Scenario(
        oracle_selftest,
        "intentionally broken ledger proves violations dump flight + "
        "diff", "fast", 13, "selftest"),
    "hot_topic_flood": Scenario(
        hot_topic_flood,
        "tier-1 smoke: zipf bulk flood vs a weight-8 latency topic on "
        "the device compress route — flooded p99 within 3x unloaded, "
        "<10s", "fast", 17, "qos-isolation"),
}
