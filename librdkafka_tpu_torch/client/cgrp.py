"""Consumer group coordinator ("cgrp") state machine.

Reference: src/rdkafka_cgrp.c (3547 LoC) — two nested FSMs driven from the
main thread via serve() (rd_kafka_cgrp_serve, :3231): the coordinator
query/connect FSM (states rdkafka_cgrp.h:61-79) and the join FSM
(WAIT_JOIN → WAIT_SYNC → WAIT_ASSIGN_REBALANCE_CB → STARTED,
rdkafka_cgrp.h:86-111). The elected leader runs the assignor
(handle_JoinGroup :894 → assignor_run). Heartbeats (:1469) detect
generation changes; max.poll.interval.ms is enforced here (:2742).
"""
from __future__ import annotations

import re
import time
from typing import Optional, TYPE_CHECKING

from ..analysis.locks import new_lock
from ..analysis.races import shared
from ..protocol.proto import ApiKey
from .assignor import (ASSIGNOR_PROTOCOLS, ASSIGNORS, assignment_decode,
                       assignment_encode, subscription_decode,
                       subscription_encode)
from .broker import Request
from .errors import Err, KafkaError
from .queue import Op, OpType, SyncReply

if TYPE_CHECKING:
    from .kafka import Kafka


def _tps_dict(tps) -> dict:
    """(topic, partition) set -> {topic: sorted [partitions]}."""
    out: dict = {}
    for t, p in sorted(tps):
        out.setdefault(t, []).append(p)
    return out


class ConsumerGroup:
    # lockset declarations (analysis/races.py).  Relaxed: the join/
    # sync/heartbeat response handlers run on broker threads while
    # serve() drives the FSM from the rk main thread — serialized by
    # the single-flight ``_pending`` gate (at most one group request
    # outstanding) and read lock-free by the stats emitter (str/int
    # snapshots, GIL-atomic); tracked so a genuinely concurrent second
    # writer path would surface in the --races sweeps.  Strict (all
    # sites under the ``cgrp`` factory lock): ``assignment`` — replaced
    # by the apply paths on app AND broker-callback threads while
    # _join snapshots it for owned_partitions and stats reads it — and
    # the incremental-revoke counter, an RMW between those threads.
    join_state = shared("cgrp.join_state", relaxed=True)
    member_id = shared("cgrp.member_id", relaxed=True)
    generation = shared("cgrp.generation", relaxed=True)
    rebalance_protocol = shared("cgrp.rebalance_proto", relaxed=True)
    assignment = shared("cgrp.assignment")
    incremental_revoke_cnt = shared("cgrp.incremental_revokes")

    def __init__(self, rk: "Kafka", group_id: str):
        self.rk = rk
        self.group_id = group_id
        self.state = "init"            # coordinator FSM
        self.join_state = "init"       # join FSM
        self.coord_id = -1
        self.member_id = ""
        self.generation = -1
        self.protocol = ""
        #: rebalance protocol of the broker-elected assignor
        #: (rd_kafka_rebalance_protocol): NONE until the first
        #: JoinGroup completes, then EAGER or COOPERATIVE
        self.rebalance_protocol = "NONE"
        #: guards ``assignment`` + ``incremental_revoke_cnt`` (leaf
        #: lock: nothing else is ever acquired while held)
        self._lock = new_lock("cgrp")
        self.incremental_revoke_cnt = 0
        # two-phase cooperative rebalance chain (KIP-429): the sync
        # response's incremental revoke is delivered first; its ack
        # chains the incremental assign; a non-empty revoke re-joins
        # afterwards so the freed partitions land next generation
        self._coop_active = False
        self._coop_added: Optional[dict] = None
        self._coop_rejoin = False
        self.subscription: list[str] = []
        self.patterns: list = []            # compiled ^regex subscriptions
        self._matched: set[str] = set()     # topics currently matching
        # literal subscription topics whose metadata is known: a topic
        # whose metadata arrives AFTER the JoinGroup must trigger a
        # rejoin too (reference: rd_kafka_cgrp_metadata_update_check,
        # rdkafka_cgrp.c:3412, rejoins for literal and regex alike)
        self._lit_known: set[str] = set()
        # bumped by rejoin(); a JoinGroup begun under an older version is
        # abandoned on response instead of syncing a stale subscription
        self.sub_version = 0
        self._join_version = 0
        self.assignment: dict[str, list[int]] = {}
        self.rebalance_cnt = 0
        self.last_heartbeat = 0.0
        self.last_coord_query = 0.0
        self.last_poll = time.monotonic()
        self.max_poll_exceeded = False
        self._pending = False          # a request is in flight
        self._unknown_topic_scan = 0.0  # last unknown-literal re-query
        self._wait_rebalance_cb = False
        self._auto_commit_next = 0.0
        self.terminated = False
        # posted when the coordinator FSM reaches "up": sync callers
        # (commit/committed on a consumer that hasn't subscribed yet)
        # block here instead of failing with _WAIT_COORD
        self.coord_ready = SyncReply()

    # ------------------------------------------------------------ public --
    def subscribe(self, topics: list[str]):
        """Topics starting with ``^`` are regex patterns matched against
        the full cluster topic list (reference: rdkafka_pattern.c topic
        pattern lists; the ``^`` prefix is part of the regex, matched
        with search semantics like the reference's regexec).

        All patterns are validated before any state changes (like the
        reference, a bad pattern fails the whole subscribe atomically)."""
        pats = []
        for t in topics:
            if t.startswith("^"):
                try:
                    pats.append(re.compile(t))
                except re.error as e:
                    from .errors import KafkaException
                    raise KafkaException(Err._INVALID_ARG,
                                         f"bad subscription regex {t!r}: {e}")
        self.subscription = list(topics)
        self.patterns = pats
        self._matched = set()
        # literal topics already in the metadata cache won't fire a
        # metadata_update rejoin; unknown ones rejoin when their
        # metadata lands (the assignor needs the partition counts)
        with self.rk._metadata_lock:
            known = set(self.rk.metadata["topics"])
        self._lit_known = {t for t in topics
                           if not t.startswith("^") and t in known}
        # literals after patterns are installed: their metadata_refresh
        # must request the FULL topic list for pattern discovery
        for t in topics:
            if not t.startswith("^"):
                self.rk.get_topic(t)
        if self.patterns:
            self.rk.metadata_refresh("regex subscription")
        self.rejoin("subscribe")

    def effective_subscription(self) -> list[str]:
        """Literal topics + current regex matches."""
        lits = [t for t in self.subscription if not t.startswith("^")]
        return sorted(set(lits) | self._matched)

    def metadata_update(self, topic_names, full: bool = True) -> None:
        """Re-evaluate the subscription against fresh metadata
        (reference: rd_kafka_cgrp_metadata_update_check,
        rdkafka_cgrp.c:3412 — rejoins for literal AND regex
        subscriptions): a literal topic whose metadata arrives after the
        JoinGroup rejoins so the leader's assignor finally sees its
        partitions; a regex match-set change rebalances onto the new
        topics.  ``full=False`` is a sparse (per-topic) update: literal
        arrival still counts, but patterns are only re-evaluated against
        full enumerations (a sparse list would shrink the match set)."""
        topic_names = set(topic_names)
        reasons = []
        lits = {t for t in self.subscription if not t.startswith("^")}
        newly = (lits & topic_names) - self._lit_known
        self._lit_known |= newly
        if full:
            # full enumeration: a deleted topic re-arms its trigger so
            # a later re-create rejoins again
            self._lit_known &= topic_names
        if newly:
            reasons.append(f"literal topic metadata arrived "
                           f"({sorted(newly)})")
        if self.patterns and full:
            matched = {t for t in topic_names
                       if not self.rk.blacklisted(t)
                       and any(p.search(t) for p in self.patterns)}
            if matched != self._matched:
                added = matched - self._matched
                self._matched = matched
                for t in added:
                    self.rk.get_topic(t)
                reasons.append(f"regex match changed (+{sorted(added)})")
        if reasons:
            self.rejoin("; ".join(reasons))

    def unsubscribe(self):
        self.subscription = []
        self.patterns = []
        self._matched = set()
        self._lit_known = set()
        self.sub_version += 1    # abandon any JoinGroup in flight
        self._leave()

    def poll_tick(self):
        self.last_poll = time.monotonic()
        self.max_poll_exceeded = False

    def rejoin(self, reason: str):
        self.rk.dbg("cgrp", f"rejoin: {reason}")
        self.sub_version += 1
        if self.join_state in ("started", "steady"):
            # COOPERATIVE (KIP-429): rejoin WITHOUT revoking — the
            # current assignment rides the JoinGroup as
            # owned_partitions and every unrevoked partition keeps
            # fetching through the whole rebalance; only the sync
            # response's incremental revoke set ever stops a fetcher
            if self.rebalance_protocol != "COOPERATIVE":
                self._trigger_rebalance_revoke()
        self.join_state = "init"

    # ------------------------------------------------------------- serve --
    def serve(self):
        """Called from the main thread loop (rd_kafka_cgrp_serve)."""
        if self.terminated:
            return
        now = time.monotonic()
        if self.subscription:
            # max.poll.interval.ms enforcement (reference :2742) — runs
            # regardless of coordinator state: a stalled app thread must
            # be detected even while the coordinator is being re-queried
            mpi = self.rk.conf.get("max.poll.interval.ms") / 1000.0
            if (self.join_state == "steady" and not self.max_poll_exceeded
                    and now - self.last_poll > mpi):
                self.max_poll_exceeded = True
                self.rk.op_err(KafkaError(
                    Err._MAX_POLL_EXCEEDED,
                    f"application maximum poll interval "
                    f"({int(mpi * 1000)}ms) exceeded"))
                self._leave()
                return
            # a subscribed literal topic with no metadata yet (created
            # after subscribe(), or still propagating) is re-queried on
            # a 1s scan — the reference's rd_kafka_1s_tmr topic scan —
            # so its arrival can fire the metadata_update rejoin; the
            # periodic refresh timer alone is minutes away
            if now - self._unknown_topic_scan >= 1.0 and any(
                    not t.startswith("^") and t not in self._lit_known
                    for t in self.subscription):
                self._unknown_topic_scan = now
                self.rk.metadata_refresh(
                    "unknown subscribed topic(s)",
                    topics=[t for t in self.subscription
                            if not t.startswith("^")
                            and t not in self._lit_known])
        if self.state != "up":
            # the coordinator lookup runs even without a subscription:
            # commit()/committed() on an assign()-based or fresh consumer
            # still needs the group coordinator (reference:
            # rd_kafka_cgrp_serve drives the coord FSM unconditionally)
            self._coord_query(now)
            return
        if not self.subscription:
            return
        if self._pending:
            return
        if self.join_state == "init":
            self._join()
        elif self.join_state == "steady":
            hb = self.rk.conf.get("heartbeat.interval.ms") / 1000.0
            if now - self.last_heartbeat >= hb:
                self._heartbeat()
            self._serve_auto_commit(now)

    # ------------------------------------------------- coordinator query --
    def _coord_query(self, now: float):
        # fast 1s retry while the coordinator is unknown, capped by
        # coordinator.query.interval.ms (reference coord_query_intvl)
        ivl = min(1.0,
                  self.rk.conf.get("coordinator.query.interval.ms") / 1e3)
        if self._pending or now - self.last_coord_query < ivl:
            return
        b = self.rk.any_up_broker()
        if b is None:
            return
        self.last_coord_query = now
        self._pending = True
        self.state = "query-coord"
        b.enqueue_request(Request(
            ApiKey.FindCoordinator, {"key": self.group_id, "key_type": 0},
            cb=self._handle_coord))

    def _handle_coord(self, err, resp):
        self._pending = False
        if err is not None or resp["error_code"] != 0:
            self.state = "init"
            return
        self.coord_id = resp["node_id"]
        with self.rk._brokers_lock:
            known = self.coord_id in self.rk.brokers
        if not known:
            self.rk.metadata_refresh("coordinator unknown")
            self.state = "init"
            return
        self.state = "up"
        self.coord_ready.post()
        self.rk.dbg("cgrp", f"coordinator is broker {self.coord_id}")

    def _coord_broker(self):
        with self.rk._brokers_lock:
            b = self.rk.brokers.get(self.coord_id)
        if b is None or not b.is_up():
            if b is not None:
                # sparse connections: demand the coordinator connect
                b.schedule_connect()
            self.state = "init"
            return None
        return b

    # --------------------------------------------------------------- join --
    def _join(self):
        b = self._coord_broker()
        if b is None:
            return
        self._pending = True
        self.join_state = "wait-join"
        self._join_version = self.sub_version
        names = [n.strip() for n in
                 self.rk.conf.get("partition.assignment.strategy").split(",")
                 if n.strip()]
        topics = self.effective_subscription()
        meta = subscription_encode(topics)
        with self._lock:
            owned = {t: list(ps) for t, ps in self.assignment.items()}
        # cooperative assignors get Subscription v1 with the member's
        # current claims (KIP-429); eager ones keep the v0 encoding
        coop_meta = subscription_encode(topics, owned=owned)
        self.rk.dbg("cgrp", f"joining group {self.group_id!r} "
                            f"member={self.member_id!r}")
        b.enqueue_request(Request(
            ApiKey.JoinGroup,
            {"group_id": self.group_id,
             "session_timeout": self.rk.conf.get("session.timeout.ms"),
             "rebalance_timeout": self.rk.conf.get("max.poll.interval.ms"),
             "member_id": self.member_id,
             # KIP-345 static membership (JoinGroup v5+)
             "group_instance_id":
                 self.rk.conf.get("group.instance.id") or None,
             "protocol_type": self.rk.conf.get("group.protocol.type"),
             "protocols": [{"name": n,
                            "metadata":
                            (coop_meta if ASSIGNOR_PROTOCOLS.get(n)
                             == "COOPERATIVE" else meta)}
                           for n in names]},
            cb=self._handle_join,
            abs_timeout=time.monotonic() +
            self.rk.conf.get("max.poll.interval.ms") / 1000.0 + 5))

    def _handle_join(self, err, resp):
        self._pending = False
        if self.sub_version != self._join_version:
            # subscription changed while the JoinGroup was in flight
            # (e.g. a regex matched new topics): abandon and rejoin with
            # the fresh effective subscription. Keep the broker-assigned
            # member_id — rejoining with it replaces our slot instead of
            # leaving a ghost member that stalls the group's rebalance
            if err is None and resp.get("member_id"):
                self.member_id = resp["member_id"]
            self.join_state = "init"
            return
        if err is not None:
            self.join_state = "init"
            return
        ec = Err.from_wire(resp["error_code"])
        if ec == Err.MEMBER_ID_REQUIRED:
            self.member_id = resp["member_id"]
            self.join_state = "init"
            return
        if ec in (Err.UNKNOWN_MEMBER_ID, Err.ILLEGAL_GENERATION):
            self.member_id = ""
            self.join_state = "init"
            self._lost_assignment(ec.name)
            return
        if ec == Err.NOT_COORDINATOR or ec == Err.COORDINATOR_NOT_AVAILABLE:
            self.state = "init"
            self.join_state = "init"
            return
        if ec != Err.NO_ERROR:
            self.join_state = "init"
            return
        self.member_id = resp["member_id"]
        self.generation = resp["generation_id"]
        self.protocol = resp["protocol"]
        self.rebalance_protocol = ASSIGNOR_PROTOCOLS.get(self.protocol,
                                                         "EAGER")
        is_leader = resp["leader_id"] == self.member_id
        self.rk.dbg("cgrp", f"joined gen {self.generation} "
                            f"{'as leader' if is_leader else ''}")
        assignments = []
        if is_leader:
            assignments = self._run_assignor(resp["members"])
        self._sync(assignments)

    def _run_assignor(self, members: list[dict]) -> list[dict]:
        """Leader-side assignment (reference: rd_kafka_assignor_run)."""
        subs = {}
        owned = {}
        for m in members:
            d = subscription_decode(m["metadata"])
            subs[m["member_id"]] = d["topics"]
            owned[m["member_id"]] = d.get("owned_partitions") or {}
        all_topics = sorted({t for ts in subs.values() for t in ts})
        # partition counts from metadata (refresh if missing)
        with self.rk._metadata_lock:
            parts = {t: len(self.rk.metadata["topics"].get(t, {}))
                     for t in all_topics}
        missing = [t for t, n in parts.items() if n == 0]
        if missing:
            self.rk.metadata_refresh(f"assignor needs {missing}",
                                     topics=missing)
        fn = ASSIGNORS.get(self.protocol, ASSIGNORS["range"])
        if ASSIGNOR_PROTOCOLS.get(self.protocol) == "COOPERATIVE":
            per_member = fn(subs, parts, owned)
        else:
            per_member = fn(subs, parts)
        return [{"member_id": m,
                 "assignment": assignment_encode(a)}
                for m, a in per_member.items()]

    def _sync(self, assignments: list[dict]):
        b = self._coord_broker()
        if b is None:
            self.join_state = "init"
            return
        self._pending = True
        self.join_state = "wait-sync"
        b.enqueue_request(Request(
            ApiKey.SyncGroup,
            {"group_id": self.group_id, "generation_id": self.generation,
             "member_id": self.member_id, "assignments": assignments},
            cb=self._handle_sync))

    def _handle_sync(self, err, resp):
        self._pending = False
        if err is not None:
            self.join_state = "init"
            return
        ec = Err.from_wire(resp["error_code"])
        if ec != Err.NO_ERROR:
            if ec in (Err.UNKNOWN_MEMBER_ID,):
                self.member_id = ""
                self._lost_assignment(ec.name)
            self.join_state = "init"
            return
        new_assignment = assignment_decode(resp["assignment"] or b"")
        self.rebalance_cnt += 1
        self.last_heartbeat = time.monotonic()
        self.rk.dbg("cgrp", f"assignment: {new_assignment}")
        if self.rebalance_protocol == "COOPERATIVE":
            self._apply_cooperative(new_assignment)
        else:
            self._deliver_rebalance(Err._ASSIGN_PARTITIONS, new_assignment)

    # ------------------------------------- cooperative two-phase flow --
    def _apply_cooperative(self, target: dict):
        """KIP-429 incremental application of a sync response: deliver
        only the revoked/added DELTAS — partitions in both the old and
        new assignment are never touched and keep fetching through the
        entire rebalance.  A non-empty revoke chains revoke → assign →
        rejoin (the freed partitions land with their new owner next
        generation — the assignor never moves a partition in the
        generation it is revoked)."""
        with self._lock:
            owned = {t: list(ps) for t, ps in self.assignment.items()}
        own = {(t, p) for t, ps in owned.items() for p in ps}
        tgt = {(t, p) for t, ps in target.items() for p in ps}
        revoked = _tps_dict(own - tgt)
        added = _tps_dict(tgt - own)
        self._coop_active = True
        self._coop_added = added
        self._coop_rejoin = bool(revoked)
        self.rk.dbg("cgrp", f"cooperative delta: revoke={revoked} "
                            f"add={added}")
        if revoked:
            with self._lock:
                self.incremental_revoke_cnt += 1
            self._deliver_rebalance(Err._REVOKE_PARTITIONS, revoked,
                                    incremental=True)
        else:
            self._deliver_assign_phase()

    def _deliver_assign_phase(self):
        added = self._coop_added if self._coop_added is not None else {}
        self._coop_added = None
        self._deliver_rebalance(Err._ASSIGN_PARTITIONS, added,
                                incremental=True)

    def _coop_ack(self, assigned: bool):
        """Advance the cooperative chain after an incremental assign/
        unassign (the app's callback, or the auto-apply path)."""
        self._wait_rebalance_cb = False
        if not self._coop_active:
            return          # manual incremental call outside a rebalance
        if not assigned and self._coop_added is not None:
            self._deliver_assign_phase()
            return
        rejoin = self._coop_rejoin
        self._coop_active = False
        self._coop_rejoin = False
        self._coop_added = None
        self.join_state = "init" if rejoin else "steady"

    def _deliver_rebalance(self, code: Err, assignment: dict,
                           incremental: bool = False):
        """Rebalance op to the app (or auto-apply)
        (reference: rd_kafka_cgrp_rebalance → op to app queue)."""
        consumer = self.rk.consumer
        if self.rk.conf.get("rebalance_cb"):
            self.join_state = "wait-assign-rebalance-cb"
            self._wait_rebalance_cb = True
            consumer.queue.push(Op(OpType.REBALANCE,
                                   payload=(code, assignment, incremental)))
            return
        if incremental:
            if code == Err._ASSIGN_PARTITIONS:
                consumer.apply_incremental_assign(assignment)
                self._coop_ack(True)
            else:
                consumer.apply_incremental_unassign(assignment)
                self._coop_ack(False)
            return
        if code == Err._ASSIGN_PARTITIONS:
            consumer.apply_assignment(assignment)
        else:
            consumer.apply_assignment({})
        self.join_state = "steady"

    def rebalance_done(self, assigned: bool):
        """Called after the app's assign()/unassign() in the rebalance cb."""
        if self._coop_active:
            # the app answered a cooperative op (with either the
            # incremental API or a full assign): drive the chain
            self._coop_ack(assigned)
            return
        self._wait_rebalance_cb = False
        self.join_state = "steady" if assigned else "init"

    def _trigger_rebalance_revoke(self):
        with self._lock:
            assignment = {t: list(ps) for t, ps in self.assignment.items()}
        self._deliver_rebalance(Err._REVOKE_PARTITIONS, assignment)

    def _lost_assignment(self, why: str):
        """This member's ownership is void (fenced / unknown member /
        illegal generation): in cooperative mode every owned partition
        must be revoked — incrementally, so the flow machinery stays on
        the incremental path — before the fresh join claims nothing
        (reference: rd_kafka_cgrp_assignment_lost)."""
        if self.rebalance_protocol != "COOPERATIVE":
            return
        with self._lock:
            owned = {t: list(ps) for t, ps in self.assignment.items()}
        if not any(owned.values()):
            return
        self.rk.dbg("cgrp", f"assignment lost ({why}): revoking {owned}")
        self._coop_active = True
        self._coop_added = {}
        self._coop_rejoin = True    # chain must end back at init
        with self._lock:
            self.incremental_revoke_cnt += 1
        self._deliver_rebalance(Err._REVOKE_PARTITIONS, owned,
                                incremental=True)

    # ---------------------------------------------------------- heartbeat --
    def _heartbeat(self):
        b = self._coord_broker()
        if b is None:
            return
        self.last_heartbeat = time.monotonic()
        b.enqueue_request(Request(
            ApiKey.Heartbeat,
            {"group_id": self.group_id, "generation_id": self.generation,
             "member_id": self.member_id},
            cb=self._handle_heartbeat))

    def _handle_heartbeat(self, err, resp):
        if err is not None:
            return
        ec = Err.from_wire(resp["error_code"])
        if ec == Err.NO_ERROR:
            return
        if ec == Err.REBALANCE_IN_PROGRESS:
            self.rk.dbg("cgrp", "group is rebalancing")
            if self.rebalance_protocol == "COOPERATIVE":
                # KIP-429: rejoin WITHOUT revoking — every owned
                # partition keeps fetching; the sync response's
                # incremental revoke is the only thing that stops one
                if not self._wait_rebalance_cb:
                    self.join_state = "init"
            else:
                self._trigger_rebalance_revoke()
                if not self._wait_rebalance_cb:
                    self.join_state = "init"
        elif ec in (Err.UNKNOWN_MEMBER_ID, Err.ILLEGAL_GENERATION,
                    Err.FENCED_INSTANCE_ID):
            self.member_id = "" if ec == Err.UNKNOWN_MEMBER_ID else self.member_id
            self.join_state = "init"
            # ownership is void: cooperative members must drop their
            # claims (and stop those fetchers) before rejoining
            self._lost_assignment(ec.name)
        elif ec in (Err.NOT_COORDINATOR, Err.COORDINATOR_NOT_AVAILABLE):
            self.state = "init"

    # -------------------------------------------------------- auto commit --
    def _serve_auto_commit(self, now: float):
        if not self.rk.conf.get("enable.auto.commit"):
            return
        ival = self.rk.conf.get("auto.commit.interval.ms") / 1000.0
        if now < self._auto_commit_next:
            return
        self._auto_commit_next = now + ival
        offsets = self.rk.consumer.stored_offsets()
        if offsets:
            self.commit_offsets(offsets, None, from_store=True)

    @staticmethod
    def _synth_offset_resp(items: dict, with_offsets: bool) -> dict:
        """Build an OffsetCommit/OffsetFetch-shaped response for locally
        (file-)stored offsets so every caller sees one response shape."""
        by_topic: dict[str, list] = {}
        for (t, p), off in items.items():
            row = {"partition": p, "error_code": 0, "metadata": None}
            if with_offsets:
                row["offset"] = off if off is not None else -1
            by_topic.setdefault(t, []).append(row)
        return {"topics": [{"topic": t, "partitions": ps}
                           for t, ps in by_topic.items()]}

    def commit_offsets(self, offsets: dict[tuple[str, int], int],
                       cb, from_store: bool = False) -> bool:
        # values may be plain offsets or (offset, metadata) — the
        # commit-metadata string of rd_kafka_topic_partition_t
        # (reference test 0099-commit_metadata); normalize here
        offsets = {k: (v if isinstance(v, tuple) else (v, None))
                   for k, v in offsets.items()}
        # legacy file store split (offset.store.method=file,
        # rdkafka_offset.c:98-330): file-backed topics commit locally
        rk = self.rk
        all_offsets = {k: v[0] for k, v in offsets.items()}
        store = rk.offset_store
        # NOTE: file-backed items commit locally BEFORE the coordinator
        # check — async/terminate callers get the partial file commit
        # even during a coordinator outage (the reference's file store
        # is purely local).  The sync commit() retry loop strips
        # file-backed keys after the first attempt so they are not
        # re-committed per retry.
        if store is not None:
            # offset.store.method=none: offsets for these topics are not
            # stored anywhere (reference RD_KAFKA_OFFSET_METHOD_NONE).
            # Only STORE-DERIVED auto-commit offsets are filtered — an
            # explicitly requested commit (commit(message=...) /
            # commit(offsets=...)) must reach the broker, not vanish
            # behind a synthetic success callback
            none_keys = ([k for k in offsets
                          if store.method(k[0]) == "none"]
                         if from_store else [])
            if none_keys:
                offsets = {k: v for k, v in offsets.items()
                           if k not in none_keys}
                if not offsets:
                    if cb:
                        cb(None, {"topics": []})
                    return True
            file_items = {k: v for k, v in offsets.items()
                          if store.uses_file(k[0])}
            if file_items:
                # plain-int offset dict: callbacks/interceptors keep the
                # pre-metadata contract on every path
                file_plain = {k: v[0] for k, v in file_items.items()}
                store.commit_all(file_plain)
                for (t, p), off in file_plain.items():
                    tp = rk.get_toppar(t, p, create=False)
                    if tp is not None:
                        tp.committed_offset = off
                if rk.interceptors:
                    rk.interceptors.on_commit(file_plain)
                offsets = {k: v for k, v in offsets.items()
                           if k not in file_items}
                if not offsets:
                    if cb:
                        cb(None, self._synth_offset_resp(file_plain, False))
                    occb = rk.conf.get("offset_commit_cb")
                    if occb:
                        occb(None, file_plain)
                    return True
                # mixed commit: report file-backed partitions alongside
                # the broker result in both cb's response and occb
                orig_cb = cb

                def cb(err, resp, _orig=orig_cb, _file=file_plain):
                    if err is None and resp is not None:
                        resp = dict(resp)
                        resp["topics"] = (
                            list(resp["topics"])
                            + self._synth_offset_resp(_file, False)["topics"])
                    if _orig:
                        _orig(err, resp)
        b = self._coord_broker()
        if b is None:
            if cb:
                cb(KafkaError(Err._WAIT_COORD, "no coordinator"), None)
            return False
        by_topic: dict[str, list] = {}
        for (t, p), (off, meta) in offsets.items():
            by_topic.setdefault(t, []).append(
                {"partition": p, "offset": off, "metadata": meta,
                 "timestamp": -1})    # OffsetCommit v1 field; v2 ignores

        def on_commit(err, resp):
            if err is None and self.rk.interceptors:
                self.rk.interceptors.on_commit(
                    {k: v[0] for k, v in offsets.items()})
            if err is None:
                for tpc in resp["topics"]:
                    for pres in tpc["partitions"]:
                        tp = self.rk.get_toppar(tpc["topic"],
                                                pres["partition"],
                                                create=False)
                        if tp is not None and pres["error_code"] == 0:
                            tp.committed_offset = offsets.get(
                                (tpc["topic"], pres["partition"]),
                                (tp.committed_offset, None))[0]
            if cb:
                cb(err, resp)
            occb = self.rk.conf.get("offset_commit_cb")
            if occb:
                occb(err, all_offsets)

        b.enqueue_request(Request(
            ApiKey.OffsetCommit,
            {"group_id": self.group_id, "generation_id": self.generation,
             "member_id": self.member_id, "retention_time": -1,
             "topics": [{"topic": t, "partitions": ps}
                        for t, ps in by_topic.items()]},
            cb=on_commit, retries_left=2))
        return True

    def fetch_committed(self, tps: list[tuple[str, int]], cb) -> bool:
        rk = self.rk
        store = rk.offset_store
        file_reads: dict[tuple[str, int], Optional[int]] = {}
        if store is not None:
            file_tps = [k for k in tps if store.uses_file(k[0])]
            if file_tps:
                file_reads = {(t, p): store.read(t, p) for t, p in file_tps}
                tps = [k for k in tps if k not in file_reads]
                if not tps:
                    if cb:
                        cb(None, self._synth_offset_resp(file_reads, True))
                    return True
        b = self._coord_broker()
        if b is None:
            if file_reads and cb:
                # deliver the file offsets we DID read; the broker-backed
                # partitions fall back to the caller's no-result path
                cb(None, self._synth_offset_resp(file_reads, True))
                return True
            return False
        by_topic: dict[str, list] = {}
        for t, p in tps:
            by_topic.setdefault(t, []).append(p)

        def on_fetch(err, resp):
            if file_reads:
                # merge locally-read file offsets into the result; on
                # broker error still deliver the file offsets rather
                # than discarding successfully-read local state
                if err is None:
                    resp = dict(resp)
                    resp["topics"] = (list(resp["topics"])
                                      + self._synth_offset_resp(
                                          file_reads, True)["topics"])
                else:
                    err, resp = None, self._synth_offset_resp(
                        file_reads, True)
            cb(err, resp)

        b.enqueue_request(Request(
            ApiKey.OffsetFetch,
            {"group_id": self.group_id,
             "topics": [{"topic": t, "partitions": ps}
                        for t, ps in by_topic.items()]},
            cb=on_fetch if cb else None, retries_left=2))
        return True

    # --------------------------------------------------------------- leave --
    def _leave(self):
        b = self._coord_broker()
        # KIP-345: static members do NOT send LeaveGroup — the member
        # slot survives restarts until session.timeout.ms (reference:
        # rd_kafka_cgrp_leave skips for group.instance.id)
        static = bool(self.rk.conf.get("group.instance.id"))
        if b is not None and self.member_id and not static:
            b.enqueue_request(Request(
                ApiKey.LeaveGroup,
                {"group_id": self.group_id, "member_id": self.member_id},
                cb=lambda e, r: None))
        self.join_state = "init"
        self.generation = -1
        self.rk.consumer.apply_assignment({})

    def terminate(self):
        self.terminated = True
        offsets = self.rk.consumer.stored_offsets()
        if offsets and self.rk.conf.get("enable.auto.commit"):
            # final auto-commit must reach the wire before LeaveGroup
            # (reference: rd_kafka_cgrp_terminate waits for the commit
            # reply) — block on the reply instead of sleeping
            done = []
            reply = SyncReply()

            def _cb(err, resp):
                done.append(err)
                reply.post()

            self.commit_offsets(offsets, _cb, from_store=True)
            reply.wait(lambda: bool(done), 1.0)
        self._leave()
