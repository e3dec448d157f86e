"""Delivery-invariant oracle: the ledger that decides whether a chaos
storm actually broke anything.

Records every **acked** produce (topic, partition, offset, key, value,
txn id — fed by the delivery-report callback, so only what the broker
confirmed counts) and every **consumed** message, then asserts the
delivery contract after the storm:

  * **zero acked loss** — every committed ack is consumed;
  * **zero duplication** — under EOS ``read_committed`` no record is
    delivered twice;
  * **per-partition order** — records of one partition arrive in
    offset order, the order they were acked in;
  * **txn atomicity** — a transaction's records land all-or-nothing:
    committed txns fully visible, aborted txns fully invisible.

On any violation the oracle dumps the flight recorder (the trace
that *explains* the failure) plus its own diff as JSON, then raises
``OracleViolation`` carrying the structured report — the chaos analog
of the fetch path's CRC-mismatch flight trigger.

Identity: message **values must be unique per oracle** (scenario
producers stamp a monotonically increasing sequence into each value);
loss/dup/order are judged on ``(topic, partition, value)``.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional

from ..obs import trace
from ..analysis.locks import new_lock
from ..analysis.races import shared_dict, shared_list


class OracleViolation(AssertionError):
    """Delivery contract broken; ``.report`` holds the full verdict
    (violations, flight-recorder path, oracle-diff path)."""

    def __init__(self, report: dict):
        self.report = report
        v = report["violations"]
        summary = ", ".join(f"{k}={len(rows)}" for k, rows in v.items()
                            if rows)
        super().__init__(
            f"delivery invariants violated ({summary}); "
            f"oracle diff: {report.get('diff_path')}, "
            f"flight dump: {report.get('flight_path')}")


#: cap per-violation rows carried in the in-memory report / exception;
#: the JSON diff on disk always holds everything
REPORT_ROW_CAP = 50


class DeliveryOracle:
    """Thread-safe ledger (DR callbacks fire on client poll threads,
    consumers record from their own loops)."""

    def __init__(self, *, dump_dir: Optional[str] = None,
                 track_flow: bool = False):
        self._lock = new_lock("chaos.oracle")
        self.dump_dir = dump_dir
        #: continuity tracking: per-partition consumption
        #: stamps + per-member rebalance windows feed the flow-gap
        #: detector (``verify(check_continuity=True)``) — opt-in, the
        #: stamps are per-message state other storms don't need
        self.track_flow = track_flow
        # every ledger is declared shared (analysis/races.py): DR
        # callbacks append from broker/poll threads, consumers from
        # their own loops, the verdict snapshots from the storm thread
        # — all under chaos.oracle, and the lockset sweep keeps the
        # discipline honest (an unlocked append from a new callback
        # path is an empty-lockset write)
        # acked produces: (topic, partition, offset, key, value, txn)
        self.acked: list[tuple] = shared_list("oracle.acked")
        # produce failures: (topic, partition, value, txn, err_str) —
        # not required to be delivered, kept for the report
        self.failed: list[tuple] = shared_list("oracle.failed")
        # consumed: (topic, partition, offset, value) in arrival order
        self.consumed: list[tuple] = shared_list("oracle.consumed")
        # txn id -> "open" | "committed" | "aborted" | "unknown"
        self.txns: dict[str, str] = shared_dict("oracle.txns")
        # monotonic stamp per acked row (parallel to ``acked``): feeds
        # the storm-metrics recovery clock (time-to-first-ack after a
        # process kill), never the delivery verdict
        self.acked_ts: list[float] = shared_list("oracle.acked_ts")
        # ---- consumer-group ledger (group invariants) ----
        # member -> {"assigns": n, "current": set[(t,p)] | None,
        #            "last_poll": ts, "last_assign": ts, "closed": bool}
        self.members: dict[str, dict] = shared_dict("oracle.members")
        # (ts, member, kind, parts|None) for every membership/
        # assignment change — convergence is judged relative to the
        # LAST of these; incremental revokes carry their partition set
        self.group_events: list[tuple] = shared_list("oracle.group_events")
        # ---- continuity ledger (flow-gap detector) ----
        # (topic, partition) -> [consume monotonic stamps]
        self.flow: dict[tuple, list] = shared_dict("oracle.flow")
        # closed rebalance windows: (member, start, end, kept frozenset)
        # — ``kept`` is the UNREVOKED ownership the member carried
        # through the window; each kept partition must keep flowing
        self.windows: list[tuple] = shared_list("oracle.windows")
        # member -> (start_ts, kept set) while a revoke awaits the
        # member's next assignment
        self._open_windows: dict[str, tuple] = shared_dict(
            "oracle.open_windows")

    # ---------------------------------------------------- producer side --
    def dr(self, txn: Optional[str] = None):
        """A delivery-report callback bound to ``txn`` (None = plain
        produce): ``produce(..., on_delivery=oracle.dr(tid))``."""
        def _cb(err, msg):
            if err is None:
                self.record_ack(msg.topic, msg.partition, msg.offset,
                                msg.key, msg.value, txn)
            else:
                with self._lock:
                    self.failed.append((msg.topic, msg.partition,
                                        msg.value, txn, str(err)))
        return _cb

    def record_ack(self, topic: str, partition: int, offset: int,
                   key: Optional[bytes], value: Optional[bytes],
                   txn: Optional[str] = None,
                   ts: Optional[float] = None) -> None:
        """``ts``: the ack's ``time.monotonic()`` stamp.  In-process
        callers omit it (stamped on arrival); the fleet driver passes
        the WORKER's stamp so recovery envelopes measure the client's
        clock, not the merge pipeline's batching latency."""
        with self._lock:
            self.acked.append((topic, partition, offset, key, value, txn))
            self.acked_ts.append(time.monotonic() if ts is None else ts)

    def record_failed(self, topic: str, partition: int,
                      value, txn: Optional[str], err: str) -> None:
        with self._lock:
            self.failed.append((topic, partition, value, txn, err))

    # ------------------------------------------- fleet ledger merge --
    def record_acks(self, rows) -> None:
        """Bulk merge of a fleet worker's streamed ack ledger: rows of
        ``(topic, partition, offset, key, value, txn, ts)`` land under
        one lock acquisition (hundreds of workers stream batches; a
        per-row lock would make the merge the bottleneck)."""
        with self._lock:
            for topic, partition, offset, key, value, txn, ts in rows:
                self.acked.append((topic, partition, offset, key, value,
                                   txn))
                self.acked_ts.append(ts)

    def record_consumed_rows(self, rows) -> None:
        """Bulk merge of consumed rows ``(topic, partition, offset,
        value[, ts])`` — the consumer-side half of ``record_acks``;
        the optional worker-side stamp feeds the continuity ledger."""
        with self._lock:
            for row in rows:
                topic, partition, offset, value = row[:4]
                self.consumed.append((topic, partition, offset, value))
                if self.track_flow:
                    ts = row[4] if len(row) > 4 else time.monotonic()
                    self.flow.setdefault((topic, partition),
                                         []).append(ts)

    def begin_txn(self, txn: str) -> None:
        with self._lock:
            self.txns[txn] = "open"

    def commit_txn(self, txn: str) -> None:
        with self._lock:
            self.txns[txn] = "committed"

    def abort_txn(self, txn: str) -> None:
        with self._lock:
            self.txns[txn] = "aborted"

    def unknown_txn(self, txn: str) -> None:
        """Outcome undeterminable client-side (commit AND abort both
        errored mid-storm): its records are exempt from loss/dup checks
        but still must land atomically; storms assert this stays 0."""
        with self._lock:
            self.txns[txn] = "unknown"

    # ---------------------------------------------------- consumer side --
    def record_consumed(self, msg) -> None:
        """Feed one consumed Message (or anything with topic/partition/
        offset/value attributes)."""
        with self._lock:
            self.consumed.append((msg.topic, msg.partition, msg.offset,
                                  msg.value))
            if self.track_flow:
                self.flow.setdefault((msg.topic, msg.partition),
                                     []).append(time.monotonic())

    # ------------------------------------------------------ group side --
    def _member(self, member: str) -> dict:
        st = self.members.get(member)
        if st is None:
            st = self.members[member] = {
                "assigns": 0, "current": None, "last_poll": 0.0,
                "last_assign": 0.0, "closed": False}
        return st

    def record_assign(self, member: str, partitions,
                      incremental: bool = False) -> None:
        """on_assign callback: ``partitions`` is the member's NEW
        ownership set as (topic, partition) pairs (empty is a real
        assignment — a large group legally leaves members idle).
        ``incremental=True`` (KIP-429 cooperative) ADDS to the current
        set instead of replacing it."""
        now = time.monotonic()
        parts = set(partitions)
        with self._lock:
            st = self._member(member)
            st["assigns"] += 1
            if incremental:
                st["current"] = (st["current"] or set()) | parts
            else:
                st["current"] = parts
            st["last_assign"] = now
            self.group_events.append((now, member, "assign",
                                      tuple(sorted(parts))))
            # an assign closes the member's open rebalance window: the
            # kept partitions were required to flow from the revoke
            # delivery until right now
            open_w = self._open_windows.pop(member, None)
            if open_w is not None and self.track_flow:
                start, kept = open_w
                self.windows.append((member, start, now,
                                     frozenset(kept)))

    def record_rebalance_begin(self, member: str) -> None:
        """The member started rebalancing (left steady state / rejoin
        triggered) while still OWNING its current set: opens the
        continuity window — every partition it keeps through the
        rebalance must flow until the next assignment closes the
        window.  Mid-window incremental revokes narrow the kept set
        (``record_revoke``); eager full revokes discard the window
        (an eager member legally stops the world)."""
        now = time.monotonic()
        with self._lock:
            st = self._member(member)
            kept = set(st["current"] or ())
            self.group_events.append((now, member, "rebalance", None))
            if self.track_flow and kept \
                    and member not in self._open_windows:
                self._open_windows[member] = (now, kept)

    def record_revoke(self, member: str, partitions=None) -> None:
        """``partitions=None`` is the eager full revoke (between
        generations the member owns nothing).  A (topic, partition)
        list is a KIP-429 INCREMENTAL revoke: only those leave the
        member's ownership — everything kept is REQUIRED to keep
        flowing until the member's next assignment (the continuity
        invariant's rebalance window)."""
        now = time.monotonic()
        with self._lock:
            st = self._member(member)
            if partitions is None:
                st["current"] = None    # between generations: owns nothing
                self.group_events.append((now, member, "revoke", None))
                # eager stop-the-world: nothing is kept, no continuity
                # obligation survives
                self._open_windows.pop(member, None)
                return
            revoked = set(partitions)
            kept = (st["current"] or set()) - revoked
            st["current"] = kept
            self.group_events.append((now, member, "revoke",
                                      tuple(sorted(revoked))))
            if not self.track_flow:
                return
            prev = self._open_windows.get(member)
            if prev is not None:
                # narrow an open window: revoked partitions owe flow
                # only up to this revoke, the rest to the next assign
                narrowed = prev[1] - revoked
                if narrowed:
                    self._open_windows[member] = (prev[0], narrowed)
                else:
                    self._open_windows.pop(member, None)
            elif kept:
                self._open_windows[member] = (now, set(kept))

    def record_poll(self, member: str) -> None:
        """Liveness heartbeat: the member's consume loop is still
        turning (stamped per loop iteration, stored O(1))."""
        with self._lock:
            self._member(member)["last_poll"] = time.monotonic()

    def record_member_closed(self, member: str) -> None:
        """The member left deliberately (churn departure / shutdown):
        exempt from stuck-consumer and coverage checks — and its open
        rebalance window (if any) is discarded, a departing member
        owes no continuity."""
        now = time.monotonic()
        with self._lock:
            self._member(member)["closed"] = True
            self.group_events.append((now, member, "closed", None))
            self._open_windows.pop(member, None)

    def group_coverage(self, topic: str, n_partitions: int) -> dict:
        """Live snapshot of group assignment state — the convergence
        predicate the storm polls: ``converged`` iff every partition is
        owned by exactly one live, assigned member."""
        with self._lock:
            live = {m: st for m, st in self.members.items()
                    if not st["closed"]}
            owned: dict[tuple, list] = {}
            unassigned = []
            for m, st in live.items():
                if st["current"] is None:
                    unassigned.append(m)
                    continue
                for tp in st["current"]:
                    owned.setdefault(tp, []).append(m)
        expected = {(topic, p) for p in range(n_partitions)}
        missing = sorted(p for (t, p) in expected - set(owned)
                         if t == topic)
        overlaps = {f"{t}:{p}": sorted(ms)
                    for (t, p), ms in owned.items() if len(ms) > 1}
        return {"live_members": len(live), "missing": missing,
                "overlaps": overlaps, "unassigned": sorted(unassigned),
                "converged": (bool(live) and not missing and not overlaps
                              and not unassigned)}

    # ---------------------------------------------------------- verdict --
    def stats(self) -> dict:
        with self._lock:
            committed = sum(1 for *_x, txn in self.acked
                            if txn is None
                            or self.txns.get(txn) == "committed")
            return {"acked": len(self.acked),
                    "acked_committed": committed,
                    "consumed": len(self.consumed),
                    "failed": len(self.failed),
                    "txns": dict(self.txns)}

    def _committed(self, txn: Optional[str]) -> bool:
        return txn is None or self.txns.get(txn) == "committed"

    def missing_count(self) -> int:
        """Committed acks not yet consumed — the drain phase polls
        until this reaches 0 (or its deadline: that's a loss)."""
        with self._lock:
            have = {(t, p, v) for t, p, _o, v in self.consumed}
            return sum(1 for t, p, _o, _k, v, txn in self.acked
                       if self._committed(txn) and (t, p, v) not in have)

    def verify(self, *, check_duplicates: bool = True,
               check_order: bool = True,
               check_group: bool = False,
               group_topic: Optional[str] = None,
               group_partitions: int = 0,
               converged_s: Optional[float] = None,
               converge_bound_s: Optional[float] = None,
               stuck_after_s: float = 8.0,
               check_continuity: bool = False,
               flow_stall_s: float = 2.0,
               coverage: Optional[dict] = None,
               now: Optional[float] = None,
               raise_on_violation: bool = True) -> dict:
        """Judge the ledger. Scenarios without exactly-once semantics
        (plain consumer-group rebalances are at-least-once) relax
        ``check_duplicates``/``check_order``; loss and txn atomicity
        are always enforced.

        ``check_group`` adds the consumer-group invariants over
        the assignment ledger: **convergence** (the storm passes its
        measured ``converged_s`` once the group settled, None = never —
        a violation), **coverage** (final live assignments partition
        ``group_topic``'s ``group_partitions`` exactly: nothing
        unowned, nothing double-owned), and **no stuck consumer** (a
        live member must have received at least one assignment and
        polled within ``stuck_after_s`` of the verdict).

        ``coverage``/``now``: the storm freezes its group verdict
        (``group_coverage()`` snapshot + clock) BEFORE shutting its
        consumers down — judging the live recompute instead would see
        the deliberate LeaveGroup cascade of teardown as a coverage
        hole.  When omitted (unit tests), both default to live.

        ``check_continuity`` (requires ``track_flow=True``):
        the **zero stop-the-world** invariant — for every rebalance
        window (incremental revoke delivery → the member's next
        assignment), each partition the member KEPT must show
        consumption with no internal gap exceeding ``flow_stall_s``,
        provided traffic (acks) existed in the window.  An unrevoked
        partition that stalls across a rebalance is a ``flow_gap``
        violation.  ``converge_bound_s`` turns a measured-but-slow
        convergence into a violation too."""
        with self._lock:
            acked = list(self.acked)
            acked_ts = list(self.acked_ts)
            consumed = list(self.consumed)
            txns = dict(self.txns)
            failed = list(self.failed)
            members = {m: dict(st) for m, st in self.members.items()}
            windows = list(self.windows)
            flow = {tp: list(ts) for tp, ts in self.flow.items()} \
                if check_continuity else {}

        lost, duplicated, reordered = [], [], []
        aborted_seen, torn = [], []

        consumed_count: dict[tuple, int] = {}
        for topic, part, off, value in consumed:
            consumed_count[(topic, part, value)] = \
                consumed_count.get((topic, part, value), 0) + 1

        # -- zero acked-message loss (committed/plain acks only) ----------
        for topic, part, off, key, value, txn in acked:
            st = txns.get(txn) if txn is not None else None
            if txn is not None and st != "committed":
                continue
            if (topic, part, value) not in consumed_count:
                lost.append({"topic": topic, "partition": part,
                             "offset": off, "txn": txn,
                             "value": _short(value)})

        # -- zero duplication (EOS read_committed) ------------------------
        if check_duplicates:
            for (topic, part, value), n in consumed_count.items():
                if n > 1:
                    duplicated.append({"topic": topic, "partition": part,
                                       "count": n, "value": _short(value)})

        # -- per-partition ordering ---------------------------------------
        if check_order:
            last: dict[tuple, tuple] = {}
            for topic, part, off, value in consumed:
                prev = last.get((topic, part))
                if prev is not None and off <= prev[0]:
                    reordered.append(
                        {"topic": topic, "partition": part,
                         "offset": off, "after_offset": prev[0],
                         "value": _short(value)})
                last[(topic, part)] = (off, value)

        # -- txn visibility + atomicity -----------------------------------
        by_txn: dict[str, list] = {}
        for topic, part, off, key, value, txn in acked:
            if txn is not None:
                by_txn.setdefault(txn, []).append((topic, part, value))
        for txn, msgs in by_txn.items():
            st = txns.get(txn, "open")
            seen = sum(1 for m in msgs if m in consumed_count)
            if st == "aborted" and seen:
                for topic, part, value in msgs:
                    if (topic, part, value) in consumed_count:
                        aborted_seen.append(
                            {"txn": txn, "topic": topic, "partition": part,
                             "value": _short(value)})
            # all-or-nothing regardless of which outcome won
            if 0 < seen < len(msgs):
                torn.append({"txn": txn, "state": st,
                             "acked": len(msgs), "consumed": seen})

        violations = {"lost": lost, "duplicated": duplicated,
                      "reordered": reordered,
                      "aborted_seen": aborted_seen, "torn_txns": torn}

        # -- continuity: zero stop-the-world windows -----------
        if check_continuity:
            ack_stamps: dict[tuple, list] = {}
            for (topic, part, *_rest), ts in zip(acked, acked_ts):
                ack_stamps.setdefault((topic, part), []).append(ts)
            for ts_list in ack_stamps.values():
                ts_list.sort()
            flow_gaps = []
            for member, w0, w1, kept in windows:
                if w1 - w0 <= flow_stall_s:
                    continue        # too short to even hold a gap
                for tp in sorted(kept):
                    stamps = flow.get(tp, ())
                    # traffic gate: the partition must have received
                    # acked produce inside the window, otherwise there
                    # was legitimately nothing to consume
                    if not any(w0 <= t <= w1
                               for t in ack_stamps.get(tp, ())):
                        continue
                    anchors = ([w0]
                               + sorted(t for t in stamps
                                        if w0 <= t <= w1) + [w1])
                    gap = max(b - a for a, b in zip(anchors, anchors[1:]))
                    if gap > flow_stall_s:
                        flow_gaps.append(
                            {"member": member, "topic": tp[0],
                             "partition": tp[1],
                             "gap_s": round(gap, 2),
                             "window_s": round(w1 - w0, 2),
                             "window": [round(w0, 3), round(w1, 3)]})
            violations["flow_gap"] = flow_gaps

        # -- consumer-group invariants (assignment ledger) ----------------
        group_blob = None
        if check_group:
            unconverged, stuck = [], []
            cov = (coverage if coverage is not None else
                   self.group_coverage(group_topic or "",
                                       group_partitions))
            if converged_s is None:
                unconverged.append(
                    {"reason": "no_convergence_within_bound", **{
                        k: cov[k] for k in ("missing", "overlaps",
                                            "unassigned")}})
            elif (converge_bound_s is not None
                    and converged_s > converge_bound_s):
                unconverged.append(
                    {"reason": "convergence_exceeded_bound",
                     "converged_s": converged_s,
                     "bound_s": converge_bound_s})
            else:
                # converged once, but the FINAL state must still hold:
                # a late rebalance may not leave holes or double owners
                if cov["missing"]:
                    unconverged.append({"reason": "uncovered_partitions",
                                        "missing": cov["missing"]})
                if cov["overlaps"]:
                    unconverged.append({"reason": "overlapping_ownership",
                                        "overlaps": cov["overlaps"]})
            now = time.monotonic() if now is None else now
            for m, st in sorted(members.items()):
                if st["closed"]:
                    continue
                if st["assigns"] == 0:
                    stuck.append({"member": m, "reason": "never_assigned"})
                elif now - st["last_poll"] > stuck_after_s:
                    stuck.append({"member": m, "reason": "stopped_polling",
                                  "stale_s": round(now - st["last_poll"],
                                                   2)})
            violations["unconverged"] = unconverged
            violations["stuck_consumer"] = stuck
            group_blob = {
                "members": len(members),
                "live": sum(1 for st in members.values()
                            if not st["closed"]),
                "departed": sum(1 for st in members.values()
                                if st["closed"]),
                "assignments": sum(st["assigns"]
                                   for st in members.values()),
                "converged_s": converged_s,
                "coverage": cov,
            }

        ok = not any(violations.values())
        report = {
            "ok": ok,
            "acked": len(acked), "consumed": len(consumed),
            "failed_produces": len(failed),
            "txns": {"committed":
                     sum(1 for s in txns.values() if s == "committed"),
                     "aborted":
                     sum(1 for s in txns.values() if s == "aborted"),
                     "unknown":
                     sum(1 for s in txns.values() if s == "unknown"),
                     "open":
                     sum(1 for s in txns.values() if s == "open")},
            "violations": {k: v[:REPORT_ROW_CAP]
                           for k, v in violations.items()},
        }
        if group_blob is not None:
            report["group"] = group_blob
        if check_continuity:
            report["continuity"] = {
                "windows": len(windows),
                "flow_stall_s": flow_stall_s,
                "tracked_partitions": len(flow),
                "flow_gaps": len(violations.get("flow_gap", ()))}
        if not ok:
            report["diff_path"] = self._dump_diff(violations, report)
            # the trace that explains the storm must survive it: stamp
            # the verdict into the rings, then flight-dump them
            # (flight_record self-checks and returns None when tracing
            # is off, so the key is present either way)
            if trace.enabled:
                trace.instant("chaos", "oracle_violation",
                              {k: len(v) for k, v in violations.items()})
            report["flight_path"] = trace.flight_record("oracle_violation")
            if raise_on_violation:
                raise OracleViolation(report)
        return report

    def _dump_diff(self, violations: dict, report: dict) -> Optional[str]:
        d = self.dump_dir or tempfile.gettempdir()
        path = os.path.join(
            d, f"tk_oracle_{os.getpid()}_{id(self) & 0xFFFF:x}.json")
        try:
            with open(path, "w") as f:
                json.dump({"summary": {k: len(v)
                                       for k, v in violations.items()},
                           "stats": {"acked": report["acked"],
                                     "consumed": report["consumed"],
                                     "txns": report["txns"]},
                           "violations": violations}, f, indent=1,
                          default=_short)
        except OSError:
            return None
        return path


def _short(v) -> str:
    if isinstance(v, (bytes, bytearray)):
        return v[:48].decode("latin1")
    return str(v)[:64]
