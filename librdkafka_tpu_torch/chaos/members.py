"""Thread-cheap consumer-group members: hundreds-to-1000 in-process
group members multiplexed over a handful of threads.

A real ``Consumer`` costs threads (per-broker IO, timers) — fine for a
dozen members, fatal for a thousand.  ``LiteMemberFleet`` keeps each
member as a tiny FSM record (join → sync → heartbeat/fetch, the
rd_kafka_cgrp join FSM distilled) and drives N of them from a few
worker threads, each owning ONE nonblocking TCP connection per broker
(group requests are keyed by member_id in the body, so members share
connections freely — the broker doesn't care).  This is what scales
the churn storms from tens to 1000 members.

The fleet speaks the real wire protocol (protocol/apis.py schemas) to
the mock cluster — in-process ``MockCluster`` or the out-of-process
supervised rig (``ClusterHandle``), where the coordinator can be
SIGKILLed mid-rebalance.  Both rebalance protocols are implemented:

* ``cooperative-sticky`` (KIP-429): owned partitions ride the
  Subscription v1 metadata, sync deltas apply incrementally, and
  unrevoked partitions KEEP FETCHING through the whole rebalance —
  the zero stop-the-world property the oracle's continuity invariant
  (``check_continuity``) asserts.
* ``range`` (EAGER): every rejoin revokes the world first — the
  baseline the ``bench.py --rebalance`` leg measures cooperative
  against.

Members "consume" for real: each owner issues Fetch v4 to the
partition leader, parses the v2 batches, and records values + stamps
into the shared :class:`~.oracle.DeliveryOracle`.  Ownership handoffs
resume from a fleet-level position book (the commit analog), so the
storm stays at-least-once, and every partition's covered/uncovered
time is accounted (``partition_unavailability()`` — the
stop-the-world seconds the bench leg compares).

Determinism: all randomness (churn stagger jitter) draws from
``random.Random(seed)``; the chaos schedule owns the fault timeline,
so same seed ⇒ same ``replay_key`` (the replay contract).
"""
from __future__ import annotations

import random
import select
import socket
import struct
import threading
import time
from typing import Callable, Optional

from ..analysis.locks import new_lock
from ..analysis.races import shared_dict, shared_list
from ..client.assignor import (ASSIGNOR_PROTOCOLS, ASSIGNORS,
                               assignment_decode, assignment_encode,
                               subscription_decode, subscription_encode)
from ..client.errors import Err
from ..protocol import msgset
from ..protocol.apis import build_request, parse_response
from ..protocol.proto import ApiKey
from .oracle import DeliveryOracle

#: fetch request knobs: tiny waits keep one connection serving many
#: members without head-of-line blocking
_FETCH_MAX_WAIT_MS = 60
_FETCH_MAX_BYTES = 262144


class _Conn:
    """One nonblocking client connection to one broker: framed request
    send + response dispatch by correlation id.  Owned by exactly one
    worker thread — no locking; a dead connection fails its in-flight
    callbacks and is reconnected lazily with backoff."""

    def __init__(self, addr: tuple[str, int]):
        self.addr = addr
        self.sock: Optional[socket.socket] = None
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.inflight: dict[int, tuple[ApiKey, Optional[int], Callable]] = {}
        self.corrid = 0
        self.next_connect = 0.0     # backoff gate after a failure

    def alive(self) -> bool:
        return self.sock is not None

    def connect(self, now: float) -> bool:
        if self.sock is not None:
            return True
        if now < self.next_connect:
            return False
        try:
            s = socket.create_connection(self.addr, timeout=0.4)
        except OSError:
            self.next_connect = now + 0.25
            return False
        s.setblocking(False)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = s
        return True

    def close(self, err: Optional[Exception] = None):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        self.sock = None
        self.rbuf.clear()
        self.wbuf.clear()
        self.next_connect = time.monotonic() + 0.25
        pending = list(self.inflight.values())
        self.inflight.clear()
        e = err or ConnectionError("connection lost")
        for _api, _ver, cb in pending:
            cb(e, None)

    def send(self, api: ApiKey, body: dict, cb: Callable,
             version: Optional[int] = None) -> bool:
        """Queue one request; ``cb(err, resp)`` ALWAYS fires — from
        ``pump`` on response, from ``close`` on connection death, or
        synchronously here when the connection is already gone (so FSM
        ``pending`` flags can never wedge)."""
        if self.sock is None:
            cb(ConnectionError("not connected"), None)
            return False
        self.corrid += 1
        corrid = self.corrid
        self.wbuf += build_request(api, corrid, "lite-member", body,
                                   version=version)
        self.inflight[corrid] = (api, version, cb)
        self._flush()
        return self.sock is not None

    def _flush(self):
        if self.sock is None or not self.wbuf:
            return
        try:
            n = self.sock.send(self.wbuf)
            del self.wbuf[:n]
        except BlockingIOError:
            pass
        except OSError as e:
            self.close(e)

    def pump(self):
        """Read whatever is available and dispatch complete frames."""
        if self.sock is None:
            return
        self._flush()
        try:
            while True:
                chunk = self.sock.recv(262144)
                if not chunk:
                    self.close()
                    return
                self.rbuf += chunk
        except BlockingIOError:
            pass
        except OSError as e:
            self.close(e)
            return
        while len(self.rbuf) >= 4:
            size = struct.unpack_from(">i", self.rbuf)[0]
            if len(self.rbuf) < 4 + size:
                break
            frame = bytes(self.rbuf[4:4 + size])
            del self.rbuf[:4 + size]
            corrid = struct.unpack_from(">i", frame)[0]
            entry = self.inflight.pop(corrid, None)
            if entry is None:
                continue
            api, ver, cb = entry
            try:
                _corr, body = parse_response(api, frame, version=ver)
            except Exception as e:   # malformed frame: fail this call
                cb(e, None)
                continue
            cb(None, body)


class _Member:
    """One group member's FSM record (single worker thread owns it)."""

    __slots__ = ("name", "member_id", "generation", "state", "owned",
                 "protocol", "start_at", "leave_at", "hb_due",
                 "fetch_due", "pending", "closed", "static_id", "rebal")

    def __init__(self, name: str, start_at: float,
                 leave_at: Optional[float],
                 static_id: Optional[str] = None):
        self.name = name
        self.member_id = ""
        self.generation = -1
        self.state = "wait"       # wait/init/stable/done
        self.owned: dict[tuple[str, int], int] = {}   # tp -> next offset
        self.protocol = ""
        self.start_at = start_at
        self.leave_at = leave_at
        self.hb_due = 0.0
        self.fetch_due = 0.0
        self.pending = False      # one group request in flight at a time
        self.closed = False
        self.static_id = static_id
        self.rebal = False        # contributing to the rebalancing gauge


class LiteMemberFleet:
    """Drive ``members`` thread-cheap group members against a cluster.

    Cross-thread state is declared to the lockset detector and guarded
    by the ``chaos.members`` factory lock: the position book, the
    leader map, the coordinator cache, the per-partition coverage
    ledger and the rebalancing-interval book are all shared between
    worker threads (and read by the storm thread after ``stop()``)."""

    def __init__(self, bootstrap: str, *, group_id: str, topic: str,
                 partitions: int, members: int, oracle: DeliveryOracle,
                 seed: int, strategy: str = "cooperative-sticky",
                 threads: int = 4, heartbeat_s: float = 0.4,
                 session_ms: int = 6000, rebalance_ms: int = 3000,
                 fetch: bool = True,
                 churn_members: int = 0, churn_start_s: float = 1.0,
                 churn_period_s: float = 0.2,
                 churn_lifetime_s: float = 2.5,
                 member_stagger_s: float = 0.0):
        self.bootstrap = [(h, int(p)) for h, p in
                          (hp.rsplit(":", 1)
                           for hp in bootstrap.split(","))]
        self.group_id = group_id
        self.topic = topic
        self.partitions = partitions
        self.oracle = oracle
        self.strategy = strategy
        self.proto = ASSIGNOR_PROTOCOLS.get(strategy, "EAGER")
        self.heartbeat_s = heartbeat_s
        self.session_ms = session_ms
        self.rebalance_ms = rebalance_ms
        self.fetch = fetch
        self.errors: list[str] = shared_list("members.errors")
        self._lock = new_lock("chaos.members")
        rng = random.Random(seed)
        now0 = 0.0   # member clocks are offsets from start()
        self._members: list[_Member] = []
        for i in range(members):
            self._members.append(_Member(
                f"m{i:04d}", now0 + i * member_stagger_s, None))
        for j in range(churn_members):
            start = (churn_start_s + j * churn_period_s
                     + rng.random() * 0.1)
            self._members.append(_Member(
                f"x{j:04d}", start, start + churn_lifetime_s))
        self.n_threads = max(1, min(threads, members + churn_members))
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # ---- fleet-shared books (all under chaos.members) ----
        # group position book: the commit analog ownership handoffs
        # resume from — (t, p) -> next fetch offset
        self.positions: dict[tuple, int] = shared_dict("members.positions")
        # partition -> leader broker id (Metadata-refreshed on error)
        self.leaders: dict[tuple, int] = shared_dict("members.leaders")
        # broker id -> (host, port) advertised addresses
        self.broker_addrs: dict[int, tuple] = shared_dict(
            "members.broker_addrs")
        self.coordinator: Optional[int] = None
        # per-partition coverage ledger: (t,p) -> active fetcher count,
        # plus (ts, tp, delta) events — partition_unavailability()
        # integrates the zero-fetcher time (eager's stop-the-world)
        self._active: dict[tuple, int] = shared_dict("members.active")
        self._cov_events: list[tuple] = shared_list("members.cov_events")
        # group-wide rebalance intervals: [start, end) spans where >=1
        # member was mid-rejoin — bench's "messages flowing DURING the
        # rebalance" denominator
        self._rebalancing = 0
        self._reb_events: list[tuple] = shared_list("members.reb_events")
        self._t0 = 0.0
        self._metadata_due = 0.0

    # ------------------------------------------------------- lifecycle --
    def start(self):
        self._t0 = time.monotonic()
        per = [[] for _ in range(self.n_threads)]
        for i, m in enumerate(self._members):
            per[i % self.n_threads].append(m)
        for i, group in enumerate(per):
            th = threading.Thread(target=self._worker, args=(i, group),
                                  name=f"lite-members-{i}", daemon=True)
            th.start()
            self._threads.append(th)

    def stop(self, timeout: float = 20.0):
        self._stop.set()
        for th in self._threads:
            th.join(timeout)

    def live_member_count(self) -> int:
        return sum(1 for m in self._members
                   if not m.closed and m.state != "wait")

    # ----------------------------------------------------- shared books --
    def _mark_rebalancing(self, delta: int):
        now = time.monotonic()
        with self._lock:
            was = self._rebalancing
            self._rebalancing += delta
            if was == 0 and self._rebalancing > 0:
                self._reb_events.append((now, 1))
            elif was > 0 and self._rebalancing == 0:
                self._reb_events.append((now, 0))

    def _flow_start(self, tp: tuple):
        now = time.monotonic()
        with self._lock:
            n = self._active.get(tp, 0)
            self._active[tp] = n + 1
            if n == 0:
                self._cov_events.append((now, tp, 1))

    def _flow_stop(self, tp: tuple):
        now = time.monotonic()
        with self._lock:
            n = self._active.get(tp, 0) - 1
            self._active[tp] = n if n > 0 else 0
            if n <= 0:
                self._cov_events.append((now, tp, 0))

    def partition_unavailability(self, until: Optional[float] = None
                                 ) -> dict:
        """Integrate each partition's zero-active-fetcher time from the
        first moment it was covered (so the initial join ramp doesn't
        count) until ``until``/now.  Returns per-partition seconds +
        the fleet total — eager's stop-the-world shows up here; the
        cooperative total must stay a small fraction of it."""
        end = until if until is not None else time.monotonic()
        with self._lock:
            events = list(self._cov_events)
        per: dict[tuple, float] = {}
        state: dict[tuple, tuple] = {}   # tp -> (covered?, since)
        for ts, tp, up in events:
            cov, since = state.get(tp, (None, None))
            if cov is None:
                state[tp] = (bool(up), ts)
                continue
            if cov and not up:
                state[tp] = (False, ts)
            elif not cov and up:
                per[tp] = per.get(tp, 0.0) + (ts - since)
                state[tp] = (True, ts)
        for tp, (cov, since) in state.items():
            if cov is False:
                per[tp] = per.get(tp, 0.0) + (max(0.0, end - since))
        total = round(sum(per.values()), 3)
        return {"total_s": total,
                "per_partition_s": {f"{t}:{p}": round(v, 3)
                                    for (t, p), v in sorted(per.items())}}

    def rebalancing_intervals(self, until: Optional[float] = None
                              ) -> list[tuple[float, float]]:
        """Closed [start, end] spans where the group was rebalancing
        (>=1 member mid-rejoin)."""
        end_t = until if until is not None else time.monotonic()
        with self._lock:
            ev = list(self._reb_events)
        out = []
        start = None
        for ts, up in ev:
            if up and start is None:
                start = ts
            elif not up and start is not None:
                out.append((start, ts))
                start = None
        if start is not None:
            out.append((start, end_t))
        return out

    # ------------------------------------------------------ worker loop --
    def _worker(self, idx: int, members: list[_Member]):
        # TWO conns per broker: group requests (JoinGroup parks on the
        # coordinator for up to the whole rebalance window) and fetches
        # ride separate sockets, or a mass rejoin head-of-line-blocks
        # every fetch to the coordinator broker for seconds — a
        # self-inflicted flow gap the continuity invariant caught
        conns: dict[int, _Conn] = {}        # broker id -> group conn
        fconns: dict[int, _Conn] = {}       # broker id -> fetch conn
        boot = _Conn(self.bootstrap[idx % len(self.bootstrap)])
        try:
            while not self._stop.is_set():
                now = time.monotonic()
                self._serve_metadata(boot, conns, now)
                socks = {c.sock: c for c in
                         list(conns.values()) + list(fconns.values())
                         + [boot]
                         if c.sock is not None}
                if socks:
                    try:
                        r, _w, _x = select.select(list(socks), [], [],
                                                  0.01)
                    except (OSError, ValueError):
                        r = []
                    for s in r:
                        socks[s].pump()
                else:
                    self._stop.wait(0.02)
                for m in members:
                    self._serve_member(m, conns, fconns, now)
            # deliberate departure on stop: churners already closed;
            # remaining members just stop (the storm freezes its group
            # verdict before calling stop(), like Storm teardown)
        except Exception as e:   # worker must never die silently
            with self._lock:
                self.errors.append(f"worker-{idx}: {e!r}")
        finally:
            for c in list(conns.values()) + list(fconns.values()) + [boot]:
                if c.sock is not None:
                    c.close()

    # -------------------------------------------------------- metadata --
    def _serve_metadata(self, boot: _Conn, conns: dict, now: float):
        """Keep the leader map + coordinator cache warm (one worker's
        bootstrap conn refreshes for everyone; staleness is healed on
        NOT_LEADER/NOT_COORDINATOR errors)."""
        with self._lock:
            due = now >= self._metadata_due
            if due:
                self._metadata_due = now + 0.5
        if not due:
            return
        if not boot.connect(now) or boot.inflight:
            return

        def on_meta(err, resp):
            if err is not None or resp is None:
                return
            with self._lock:
                for b in resp.get("brokers", ()):
                    self.broker_addrs[b["node_id"]] = (b["host"],
                                                       b["port"])
                for t in resp.get("topics", ()):
                    if t["topic"] != self.topic:
                        continue
                    for p in t["partitions"]:
                        if p["leader"] >= 0:
                            self.leaders[(t["topic"], p["partition"])] = \
                                p["leader"]

        boot.send(ApiKey.Metadata, {"topics": [self.topic],
                                    "allow_auto_topic_creation": True},
                  on_meta)

        def on_coord(err, resp):
            if err is not None or resp is None:
                return
            if resp.get("error_code", -1) == 0:
                with self._lock:
                    self.coordinator = resp["node_id"]
                    self.broker_addrs[resp["node_id"]] = (resp["host"],
                                                          resp["port"])

        boot.send(ApiKey.FindCoordinator,
                  {"key": self.group_id, "key_type": 0}, on_coord)

    def _conn_to(self, broker_id: Optional[int], conns: dict,
                 now: float) -> Optional[_Conn]:
        if broker_id is None:
            return None
        with self._lock:
            addr = self.broker_addrs.get(broker_id)
        if addr is None:
            return None
        c = conns.get(broker_id)
        if c is None or c.addr != tuple(addr):
            if c is not None and c.sock is not None:
                c.close()
            c = conns[broker_id] = _Conn(tuple(addr))
        if not c.connect(now):
            return None
        return c

    def _enter_rebalance(self, m: _Member):
        if not m.rebal:
            m.rebal = True
            self._mark_rebalancing(1)
            # continuity window: kept partitions must flow from HERE
            # until the next assignment lands
            self.oracle.record_rebalance_begin(m.name)

    def _exit_rebalance(self, m: _Member):
        if m.rebal:
            m.rebal = False
            self._mark_rebalancing(-1)

    # ------------------------------------------------------- member FSM --
    def _serve_member(self, m: _Member, conns: dict, fconns: dict,
                      now: float):
        rel = now - self._t0
        if m.state == "done":
            return
        if m.state == "wait":
            if rel < m.start_at:
                return
            m.state = "init"
            self._enter_rebalance(m)
        if m.leave_at is not None and rel >= m.leave_at:
            self._leave(m, conns, now)
            return
        # owned partitions keep fetching in EVERY state — through the
        # whole join/sync round trip: the cooperative zero
        # stop-the-world property (eager members own nothing here,
        # their world was revoked at rejoin)
        if self.fetch and m.owned and now >= m.fetch_due:
            self._fetch(m, fconns, now)
        if m.pending:
            return
        if m.state == "init":
            self._join(m, conns, now)
        elif m.state == "stable" and now >= m.hb_due:
            self._heartbeat(m, conns, now)

    def _coord_conn(self, conns: dict, now: float) -> Optional[_Conn]:
        with self._lock:
            coord = self.coordinator
        return self._conn_to(coord, conns, now)

    def _join(self, m: _Member, conns: dict, now: float):
        c = self._coord_conn(conns, now)
        if c is None:
            return
        owned_d: dict[str, list] = {}
        if self.proto == "COOPERATIVE":
            for (t, p) in m.owned:
                owned_d.setdefault(t, []).append(p)
            meta = subscription_encode([self.topic], owned=owned_d)
        else:
            meta = subscription_encode([self.topic])
        m.pending = True

        def on_join(err, resp):
            m.pending = False
            if err is not None or resp is None:
                return                      # retried next serve pass
            ec = Err.from_wire(resp["error_code"])
            if ec in (Err.UNKNOWN_MEMBER_ID, Err.ILLEGAL_GENERATION):
                self._lost(m, "join:" + ec.name)
                m.member_id = ""
                return
            if ec in (Err.NOT_COORDINATOR,
                      Err.COORDINATOR_NOT_AVAILABLE):
                with self._lock:
                    self.coordinator = None
                return
            if ec != Err.NO_ERROR:
                return
            m.member_id = resp["member_id"]
            m.generation = resp["generation_id"]
            m.protocol = resp["protocol"]
            assignments = []
            if resp["leader_id"] == m.member_id:
                assignments = self._lead(resp["members"])
            self._sync(m, conns, assignments)

        c.send(ApiKey.JoinGroup, {
            "group_id": self.group_id,
            "session_timeout": self.session_ms,
            "rebalance_timeout": self.rebalance_ms,
            "member_id": m.member_id,
            "group_instance_id": m.static_id,
            "protocol_type": "consumer",
            "protocols": [{"name": self.strategy, "metadata": meta}]},
            on_join)

    def _lead(self, members_meta: list[dict]) -> list[dict]:
        """Leader-side assignment over the joined members' metadata."""
        subs, owned = {}, {}
        for row in members_meta:
            d = subscription_decode(row["metadata"])
            subs[row["member_id"]] = d["topics"]
            owned[row["member_id"]] = d.get("owned_partitions") or {}
        parts = {self.topic: self.partitions}
        fn = ASSIGNORS[self.strategy]
        if self.proto == "COOPERATIVE":
            per = fn(subs, parts, owned)
        else:
            per = fn(subs, parts)
        return [{"member_id": mid, "assignment": assignment_encode(a)}
                for mid, a in per.items()]

    def _sync(self, m: _Member, conns: dict, assignments: list[dict]):
        c = self._coord_conn(conns, time.monotonic())
        if c is None:
            return                         # rejoin next pass
        m.pending = True

        def on_sync(err, resp):
            m.pending = False
            if err is not None or resp is None:
                return
            ec = Err.from_wire(resp["error_code"])
            if ec == Err.REBALANCE_IN_PROGRESS:
                self._rejoin(m)
                return
            if ec in (Err.UNKNOWN_MEMBER_ID, Err.ILLEGAL_GENERATION):
                self._lost(m, "sync:" + ec.name)
                if ec == Err.UNKNOWN_MEMBER_ID:
                    m.member_id = ""
                return
            if ec != Err.NO_ERROR:
                return
            target = assignment_decode(resp["assignment"] or b"")
            self._apply(m, target)

        c.send(ApiKey.SyncGroup, {
            "group_id": self.group_id, "generation_id": m.generation,
            "member_id": m.member_id, "assignments": assignments},
            on_sync)

    def _apply(self, m: _Member, target: dict):
        tgt = {(t, p) for t, ps in target.items() for p in ps}
        own = set(m.owned)
        if self.proto == "COOPERATIVE":
            revoked = own - tgt
            added = tgt - own
            if revoked:
                self.oracle.record_revoke(m.name, sorted(revoked))
                for tp in sorted(revoked):
                    self._retire(m, tp)
            self.oracle.record_assign(m.name, sorted(added),
                                      incremental=True)
            for tp in sorted(added):
                self._adopt(m, tp)
            m.state = "stable"
            m.hb_due = time.monotonic() + self.heartbeat_s
            self._exit_rebalance(m)
            if revoked:
                self._rejoin(m)     # freed partitions land next gen
        else:
            # EAGER: the world was revoked at rejoin; everything in the
            # target is a fresh adoption
            self.oracle.record_assign(m.name, sorted(tgt))
            for tp in sorted(tgt):
                self._adopt(m, tp)
            m.state = "stable"
            m.hb_due = time.monotonic() + self.heartbeat_s
            self._exit_rebalance(m)

    def _adopt(self, m: _Member, tp: tuple):
        with self._lock:
            pos = self.positions.get(tp, 0)
        m.owned[tp] = pos
        self._flow_start(tp)

    def _retire(self, m: _Member, tp: tuple):
        pos = m.owned.pop(tp, None)
        if pos is not None:
            with self._lock:
                if pos > self.positions.get(tp, 0):
                    self.positions[tp] = pos
            self._flow_stop(tp)

    def _rejoin(self, m: _Member):
        """Trigger a new join round.  EAGER revokes everything first
        (the stop-the-world the continuity invariant outlaws for
        cooperative members)."""
        self._enter_rebalance(m)
        if self.proto != "COOPERATIVE" and m.owned:
            self.oracle.record_revoke(m.name)       # full revoke
            for tp in sorted(m.owned):
                self._retire(m, tp)
        m.state = "init"

    def _lost(self, m: _Member, why: str):
        """Fenced/unknown: ownership is void regardless of protocol."""
        self._enter_rebalance(m)
        if m.owned:
            self.oracle.record_revoke(
                m.name, sorted(m.owned)
                if self.proto == "COOPERATIVE" else None)
            for tp in sorted(m.owned):
                self._retire(m, tp)
        m.generation = -1
        m.state = "init"

    def _heartbeat(self, m: _Member, conns: dict, now: float):
        c = self._coord_conn(conns, now)
        if c is None:
            return
        m.hb_due = now + self.heartbeat_s
        self.oracle.record_poll(m.name)
        m.pending = True

        def on_hb(err, resp):
            m.pending = False
            if err is not None or resp is None:
                return
            ec = Err.from_wire(resp["error_code"])
            if ec == Err.NO_ERROR:
                return
            if ec == Err.REBALANCE_IN_PROGRESS:
                self._rejoin(m)
            elif ec in (Err.UNKNOWN_MEMBER_ID, Err.ILLEGAL_GENERATION):
                self._lost(m, "hb:" + ec.name)
                if ec == Err.UNKNOWN_MEMBER_ID:
                    m.member_id = ""
            elif ec in (Err.NOT_COORDINATOR,
                        Err.COORDINATOR_NOT_AVAILABLE):
                with self._lock:
                    self.coordinator = None

        c.send(ApiKey.Heartbeat, {
            "group_id": self.group_id, "generation_id": m.generation,
            "member_id": m.member_id}, on_hb)

    def _leave(self, m: _Member, conns: dict, now: float):
        for tp in sorted(m.owned):
            self._retire(m, tp)
        self._exit_rebalance(m)
        m.state = "done"
        m.closed = True
        self.oracle.record_member_closed(m.name)
        c = self._coord_conn(conns, now)
        if c is not None and m.member_id:
            c.send(ApiKey.LeaveGroup, {"group_id": self.group_id,
                                       "member_id": m.member_id},
                   lambda e, r: None)

    # ----------------------------------------------------------- fetch --
    def _fetch(self, m: _Member, conns: dict, now: float):
        """One fetch round: owned partitions grouped by leader; the
        member keeps consuming THROUGH rebalances (cooperative) — this
        is the flow the continuity invariant measures."""
        m.fetch_due = now + 0.05
        by_leader: dict[int, list] = {}
        with self._lock:
            for tp, pos in m.owned.items():
                leader = self.leaders.get(tp)
                if leader is not None:
                    by_leader.setdefault(leader, []).append((tp, pos))
        for leader, tps in by_leader.items():
            c = self._conn_to(leader, conns, now)
            if c is None or len(c.inflight) > 8:
                continue
            per_topic: dict[str, list] = {}
            for (t, p), pos in tps:
                per_topic.setdefault(t, []).append(
                    {"partition": p, "fetch_offset": pos,
                     "max_bytes": _FETCH_MAX_BYTES // 4})
            body = {"replica_id": -1,
                    "max_wait_time": _FETCH_MAX_WAIT_MS,
                    "min_bytes": 1, "max_bytes": _FETCH_MAX_BYTES,
                    "isolation_level": 0,
                    "topics": [{"topic": t, "partitions": rows}
                               for t, rows in per_topic.items()]}
            c.send(ApiKey.Fetch, body,
                   self._make_fetch_cb(m), version=4)

    def _make_fetch_cb(self, m: _Member):
        def on_fetch(err, resp):
            if err is not None or resp is None:
                return
            rows = []
            for t in resp.get("topics", ()):
                for p in t.get("partitions", ()):
                    tp = (t["topic"], p["partition"])
                    if tp not in m.owned:
                        continue        # revoked while in flight: drop
                    ec = Err.from_wire(p["error_code"])
                    if ec == Err.NOT_LEADER_FOR_PARTITION:
                        with self._lock:
                            self.leaders.pop(tp, None)
                            self._metadata_due = 0.0
                        continue
                    if ec == Err.OFFSET_OUT_OF_RANGE:
                        m.owned[tp] = 0     # earliest (retention reset)
                        continue
                    if ec != Err.NO_ERROR or not p["records"]:
                        continue
                    pos = m.owned[tp]
                    now = time.monotonic()
                    for info, payload, _full in msgset.iter_batches(
                            p["records"]):
                        if info.codec or info.is_control:
                            # harness scope: uncompressed data batches
                            # (scenario producers run codec=none)
                            pos = max(pos, info.base_offset
                                      + info.record_count)
                            continue
                        for rec in msgset.parse_records_v2(
                                info, payload):
                            if rec.offset < m.owned[tp]:
                                continue        # already seen
                            rows.append((tp[0], tp[1], rec.offset,
                                         rec.value, now))
                            pos = max(pos, rec.offset + 1)
                    m.owned[tp] = pos
                    with self._lock:
                        if pos > self.positions.get(tp, 0):
                            self.positions[tp] = pos
            if rows:
                self.oracle.record_consumed_rows(rows)
        return on_fetch
