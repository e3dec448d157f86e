"""In-process mock Kafka cluster.

The rebuild of the reference's mock broker (src/rdkafka_mock.c:1772 +
rdkafka_mock_handlers.c:1483): real TCP listeners per mock broker served
from one cluster thread, an in-memory log that stores produced MessageSets
**verbatim as byte blobs** (rdkafka_mock_int.h:93-100) and returns them to
Fetch — so producer wire bytes are round-trippable and byte-comparable —
plus scriptable fault injection (per-ApiKey error stacks, RTT delays,
leader changes, coordinator selection; reference rdkafka_mock.c:1382-1445).

Created implicitly by ``test.mock.num.brokers`` in client config, or
directly via ``MockCluster(num_brokers=3)``.
"""
from __future__ import annotations

import selectors
import socket
import ssl as _ssl
import struct
import threading
import time
import zlib
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..client.errors import Err
from ..protocol import apis, proto
from ..protocol.apis import APIS
from ..protocol.msgset import read_batch_header
from ..utils import sockbuf
from ..protocol.proto import ApiKey
from ..utils.buf import Slice
from ..analysis import lockdep as _lockdep
from ..analysis.locks import new_rlock
from ..analysis.races import shared_dict

_TOPIC_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def _renumber_legacy(msgset: bytes, first: int) -> tuple[bytes, int]:
    """``msgset`` with its messages at offsets first, first + 1, ...
    (the offset field lies outside each message's CRC); (bytes, count)."""
    out = bytearray(msgset)
    n, off = 0, 0
    while off + 12 <= len(out):
        size = struct.unpack_from(">i", out, off + 8)[0]
        if off + 12 + size > len(out):
            break
        struct.pack_into(">q", out, off, first + n)
        n += 1
        off += 12 + size
    return bytes(out), n


def _assign_legacy_offsets(blob: bytes, base: int) -> tuple[bytes, int]:
    """A produced MsgVer0/1 MessageSet with the offsets a broker assigns
    from ``base`` (Kafka's log validator): each plain message its own;
    a compression wrapper the offset of its last inner message, whose
    inner offsets stay relative (0..n-1) in MsgVer1 and become absolute
    in MsgVer0 (the inner set is then recompressed and the wrapper's CRC
    recomputed).  A producer numbers every request from 0, so a set
    stored verbatim would repeat offsets and count a wrapper as one
    message.  Returns (bytes, messages)."""
    from ..ops.cpu import CpuCodecProvider
    codec_p = CpuCodecProvider()
    out = bytearray()
    n, off = 0, 0
    while off + 12 <= len(blob):
        size = struct.unpack_from(">i", blob, off + 8)[0]
        if size < 6 or off + 12 + size > len(blob):
            break                      # a partial trailing message
        msg = blob[off + 12:off + 12 + size]     # crc .. value
        off += 12 + size
        magic, attrs = msg[4], msg[5]
        codec = proto.CODEC_NAMES.get(attrs & proto.ATTR_CODEC_MASK)
        if codec is None:
            out += struct.pack(">qi", base + n, size) + msg
            n += 1
            continue
        o = 6 + (8 if magic == 1 else 0)
        klen = struct.unpack_from(">i", msg, o)[0]
        o += 4 + max(klen, 0)
        vlen = struct.unpack_from(">i", msg, o)[0]
        value = msg[o + 4:o + 4 + vlen]
        inner = codec_p.decompress_many(codec, [value])[0]
        renumbered, k = _renumber_legacy(inner, 0 if magic == 1 else base + n)
        if renumbered != inner:
            value = codec_p.compress_many(codec, [renumbered])[0]
            body = msg[4:o] + struct.pack(">i", len(value)) + value
            msg = struct.pack(">I", zlib.crc32(body)) + body
        out += struct.pack(">qi", base + n + k - 1, len(msg)) + msg
        n += k
    return bytes(out), max(n, 1)


def _valid_topic_name(name: str) -> bool:
    """Kafka topic-name rules (broker-side validation the real cluster
    applies): 1-249 chars of [a-zA-Z0-9._-], not '.'/'..'."""
    return (0 < len(name) <= 249 and name not in (".", "..")
            and set(name) <= _TOPIC_CHARS)


@dataclass
class MockPartition:
    topic: str
    id: int
    leader: int
    replicas: list[int]
    start_offset: int = 0
    end_offset: int = 0
    # the log: (base_offset, raw_messageset_bytes)
    log: list[tuple[int, bytes]] = field(default_factory=list)
    # idempotence: (pid, epoch) -> next expected base sequence
    pid_seqs: dict[tuple[int, int], int] = field(default_factory=dict)
    # size-based retention (real brokers: log.retention.bytes); 0 = keep
    # everything. Oldest batches are dropped and start_offset advances.
    retention_bytes: int = 0
    log_bytes: int = 0
    # KIP-392: broker id nominated as preferred read replica for v11+
    # consumer fetches (None = leader serves); the reference mock's
    # rd_kafka_mock_partition_set_follower equivalent
    follower_id: Optional[int] = None
    # aborted-transaction index: [{"producer_id", "first_offset",
    # "last_offset"}] — reported to read_committed fetches whose range
    # overlaps (real brokers: the .txnindex sidecar file)
    aborted: list = field(default_factory=list)
    # open (un-ended) transactions touching this partition:
    # pid -> first data offset; bounds the last stable offset
    open_txns: dict = field(default_factory=dict)

    def lso(self) -> int:
        """Last stable offset: first offset still inside an open
        transaction, or the log end when none is open."""
        if self.open_txns:
            return min(self.open_txns.values())
        return self.end_offset

    def append(self, blob: bytes) -> int:
        """Append a produced MessageSet verbatim; returns assigned base
        offset. v2 blobs get their BaseOffset field patched (outside the
        CRC'd region), exactly what a real broker does; MsgVer0/1 sets
        get the offsets a broker assigns (``_assign_legacy_offsets``)."""
        base = self.end_offset
        if len(blob) >= proto.V2_HEADER_SIZE and blob[proto.V2_OF_Magic] == 2:
            blob = struct.pack(">q", base) + blob[8:]
            count = struct.unpack(
                ">i", blob[proto.V2_OF_RecordCount:proto.V2_OF_RecordCount + 4])[0]
        else:
            blob, count = _assign_legacy_offsets(blob, base)
        self.log.append((base, blob))
        self.log_bytes += len(blob)
        self.end_offset = base + count
        if self.retention_bytes > 0:
            while len(self.log) > 1 and self.log_bytes > self.retention_bytes:
                _old_base, old_blob = self.log.pop(0)
                self.log_bytes -= len(old_blob)
                self.start_offset = self.log[0][0]
        return base

    def read_from(self, offset: int, max_bytes: int,
                  max_offset: Optional[int] = None) -> bytes:
        """``max_offset`` caps the read below the LSO for
        read_committed fetches: batches of a still-open transaction
        must not reach isolation-level-1 consumers (real brokers stop
        at the last stable offset)."""
        out = bytearray()
        for base, blob in self.log:
            # include any blob whose range covers/starts-after the offset
            if self._blob_end(base, blob) <= offset:
                continue
            if max_offset is not None and base >= max_offset:
                break
            out += blob
            if len(out) >= max_bytes:
                break
        return bytes(out)

    @staticmethod
    def _blob_end(base: int, blob: bytes) -> int:
        """The offset after the blob's last message."""
        if len(blob) >= proto.V2_HEADER_SIZE and blob[proto.V2_OF_Magic] == 2:
            return base + struct.unpack(
                ">i", blob[proto.V2_OF_RecordCount:proto.V2_OF_RecordCount + 4])[0]
        # MsgVer0/1: append() gave every message (a wrapper: its last
        # inner message) its absolute offset
        last, off = base, 0
        while off + 12 <= len(blob):
            last = struct.unpack_from(">q", blob, off)[0]
            off += 12 + struct.unpack_from(">i", blob, off + 8)[0]
        return last + 1


@dataclass
class GroupMember:
    member_id: str
    client_id: str
    client_host: str
    protocols: list[tuple[str, bytes]] = field(default_factory=list)
    assignment: bytes = b""
    metadata: bytes = b""
    last_heartbeat: float = field(default_factory=time.monotonic)
    session_timeout_ms: int = 10000
    # connection wanting the pending JoinGroup response: (conn, corrid)
    pending_join: Optional[tuple] = None


@dataclass
class MockGroup:
    group_id: str
    state: str = "Empty"   # Empty/PreparingRebalance/CompletingRebalance/Stable
    generation: int = 0
    protocol_type: str = ""
    protocol: str = ""
    leader: str = ""
    members: dict[str, GroupMember] = field(default_factory=dict)
    offsets: dict[tuple[str, int], tuple[int, Optional[str]]] = field(default_factory=dict)
    rebalance_deadline: float = 0.0
    # KIP-134 initial-rebalance hold: the first generation of a fresh
    # group stays open until this stamp (see MockCluster
    # group_initial_rebalance_delay_ms)
    hold_until: float = 0.0
    pending_syncs: list[tuple] = field(default_factory=list)  # (conn, corrid, member_id)
    # ownership book: (topic, partition) -> member_id as of
    # the LAST completed sync, plus the cooperative-protocol violations
    # the validator caught — a partition handed to a new owner in the
    # same generation its old owner still held it (KIP-429 forbids the
    # move without an intermediate revoke generation), or double-owned
    # within one generation.  Tests assert the list stays empty.
    owned: dict[tuple[str, int], str] = field(default_factory=dict)
    validation_errors: list[dict] = field(default_factory=list)


@dataclass
class MockTransaction:
    """Transaction-coordinator state for one transactional.id
    (reference: the 2.x broker's TransactionMetadata; the v1.3.0 mock
    has no coordinator role at all)."""
    tid: str
    pid: int
    epoch: int = -1
    state: str = "Empty"   # Empty/Ongoing/CompleteCommit/CompleteAbort
    # (topic, partition) -> first data offset of the CURRENT txn
    # (None until the first transactional batch lands there)
    partitions: dict = field(default_factory=dict)
    groups: set = field(default_factory=set)
    # group -> {(topic, partition): (offset, metadata)} staged by
    # TxnOffsetCommit, applied to the group at EndTxn(commit)
    pending_offsets: dict = field(default_factory=dict)


class _Conn:
    def __init__(self, sock: socket.socket, broker_id: int):
        self.sock = sock
        self.broker_id = broker_id
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.wbuf_off = 0           # consumed prefix (offset send)
        self.closed = False
        self.handshaking = False    # TLS handshake in progress
        self.sasl_mech = ""         # mechanism from SaslHandshake
        self.scram = None           # server-side SCRAM exchange state


class MockCluster:
    """In-process fake Kafka cluster over real localhost TCP sockets."""

    def __init__(self, num_brokers: int = 3, topics: Optional[dict] = None,
                 auto_create_topics: bool = True, default_partitions: int = 4,
                 tls: Optional[dict] = None,
                 sasl_users: Optional[dict] = None,
                 broker_version: Optional[str] = None,
                 retention_bytes: int = 0,
                 group_initial_rebalance_delay_ms: int = 0):
        """``group_initial_rebalance_delay_ms``: real brokers hold a
        brand-new (Empty) group's FIRST rebalance open for
        ``group.initial.rebalance.delay.ms`` (default 3000 there, 0
        here to keep tests instant) so a starting fleet joins one
        generation instead of the first member grabbing every
        partition and immediately redistributing — exactly the
        mass-move the cooperative assignor otherwise pays for.

        ``tls``: enable the TLS listener mode —
        ``{"certfile": ..., "keyfile": ..., "cafile": ...,
        "require_client_cert": bool}``. All mock brokers then speak TLS
        (like a real cluster with an SSL listener); clients must set
        ``security.protocol=ssl``/``sasl_ssl``.

        ``sasl_users``: ``{username: password}`` credential table. When
        set, PLAIN checks credentials and SCRAM runs the full RFC 5802
        server-side exchange (salted PBKDF2 verifier, client-proof
        verification, server signature); when None, PLAIN accepts any
        non-empty credentials and SCRAM is rejected (the server needs a
        real password to derive keys)."""
        self.num_brokers = num_brokers
        self.sasl_users = sasl_users
        # emulate an old broker: closes the connection on ApiVersions
        # when < 0.10 (the real pre-0.10 behavior clients must survive)
        self.broker_version = broker_version
        if broker_version is not None:
            from ..client.feature import _parse_version
            self._bv_tuple = _parse_version(broker_version)
        self._tls_ctx = None
        if tls:
            from ..client.tls import make_server_ctx
            self._tls_ctx = make_server_ctx(
                tls["certfile"], tls["keyfile"], tls.get("cafile"),
                tls.get("require_client_cert", False))
        self.auto_create_topics = auto_create_topics
        self.default_partitions = default_partitions
        # per-partition size retention for long-running/benchmark use
        # (real brokers: log.retention.bytes); 0 keeps everything
        self.retention_bytes = retention_bytes
        self.group_initial_delay_s = group_initial_rebalance_delay_ms \
            / 1000.0
        # the cluster tables are declared shared (analysis/races.py),
        # RELAXED with one justification: every handler and chaos
        # controller hook (kill/restart/migrate from the scheduler
        # thread) mutates them under mock.cluster, but tests are the
        # mock's second client — the test's thread inspects
        # ``cluster.topics[...]`` / ``cluster.groups[...]`` lock-free
        # by design (snapshot peeks of a test fixture).  The sweep
        # still tracks them, so a genuinely unlocked HANDLER mutation
        # shows up in the relaxed report's stacks.
        self.topics: dict[str, list[MockPartition]] = \
            shared_dict("mock.topics", relaxed=True)
        self.groups: dict[str, MockGroup] = \
            shared_dict("mock.groups", relaxed=True)
        self.cluster_id = "mockCluster"
        self.controller_id = 1
        self._next_pid = 1
        # transaction-coordinator role: per-transactional.id state +
        # the pid -> tid reverse map the Produce path fences through
        self.transactions: dict[str, MockTransaction] = \
            shared_dict("mock.transactions", relaxed=True)
        self._pid_tid: dict[int, str] = \
            shared_dict("mock.pid_tid", relaxed=True)
        # KIP-227 incremental fetch session cache: one entry
        # per negotiated session — {session_id: {broker, epoch, book,
        # last}} where `book` is the per-session partition state
        # {(topic, partition): {fetch_offset, max_bytes}} and `epoch`
        # the NEXT expected request epoch.  Bounded (LRU eviction at
        # fetch_session_slots, like a real broker's
        # max.incremental.fetch.session.cache.slots); a broker's
        # sessions die with it (set_broker_down) — the cache is broker
        # memory, which is exactly what the chaos kill tests assert.
        self._fetch_sessions: dict[int, dict] = \
            shared_dict("mock.fetch_sessions", relaxed=True)
        self._next_session_id = 1
        self.fetch_session_slots = 1000
        self._lock = new_rlock("mock.cluster")
        # fault injection
        self._err_stacks: dict[int, deque] = defaultdict(deque)
        self._rtt_ms: dict[int, float] = {}           # broker_id -> delay
        self._throttle_ms: dict[int, int] = {}        # broker_id -> report
        self._down: set[int] = set()
        # SIGSTOP analog (chaos proc_pause): a paused broker stops
        # reading and writing but its listener stays bound — connects
        # succeed (kernel backlog) and then freeze, exactly what a
        # GC-paused/VM-frozen broker looks like from the client
        self._paused: set[int] = set()
        # environment fault library: brokers whose storage
        # plane is "full"/EIO — every Produce they lead returns
        # KAFKA_STORAGE_ERROR (retriable: real brokers do exactly this
        # on a failed log dir) until the window heals
        self._storage_err: set[int] = set()
        # per-broker wall-clock skew in ms, reflected in every
        # timestamp this broker reports (log_append_time, ListOffsets)
        self._clock_skew_ms: dict[int, float] = {}
        # out-of-process tier: the standalone supervisor fronts each
        # internal listener with a relay OS process on a public port;
        # metadata/FindCoordinator must advertise THAT port or clients
        # would bypass the killable process entirely
        self._advertised: dict[int, int] = {}
        self.request_log: list[tuple[int, int]] = []  # (broker_id, api_key)
        # AlterConfigs store: (resource_type, name) -> {conf: value}
        self._resource_configs: dict[tuple, dict] = {}

        self._listeners: dict[int, socket.socket] = {}
        self._ports: dict[int, int] = {}
        self._sel = selectors.DefaultSelector()
        self._conns: list[_Conn] = []
        # deferred work: (due_monotonic, callable)
        self._deferred: list[tuple[float, Callable]] = []
        # parked fetches: (deadline, conn, corrid, parsed_request)
        self._parked_fetches: list = []
        self._stop = threading.Event()
        # controller bookkeeping: bumped on every leadership /
        # broker-liveness change (a real controller bumps the metadata
        # epoch; clients here refresh via NOT_LEADER/connection errors,
        # tests and the chaos oracle observe this counter)
        self.metadata_version = 1

        for b in range(1, num_brokers + 1):
            self._open_listener(b)

        if topics:
            for name, nparts in topics.items():
                self.create_topic(name, nparts)

        self._thread = threading.Thread(target=self._run, name="mock-cluster",
                                        daemon=True)
        self._thread.start()

    def _open_listener(self, broker_id: int) -> None:
        """Bind + register broker ``broker_id``'s TCP listener. First
        call picks an ephemeral port; later calls (broker restart)
        rebind the SAME port so clients' cached metadata stays valid."""
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind(("127.0.0.1", self._ports.get(broker_id, 0)))
        ls.listen(64)
        ls.setblocking(False)
        self._listeners[broker_id] = ls
        self._ports[broker_id] = ls.getsockname()[1]
        self._sel.register(ls, selectors.EVENT_READ, ("accept", broker_id))

    def _close_listener(self, broker_id: int) -> None:
        ls = self._listeners.get(broker_id)
        if ls is None:
            return
        try:
            self._sel.unregister(ls)
        except (KeyError, ValueError):
            pass
        try:
            ls.close()
        except OSError:
            pass
        del self._listeners[broker_id]

    # ------------------------------------------------------------- public --
    def bootstrap_servers(self) -> str:
        return ",".join(f"127.0.0.1:{self.advertised_port(b)}"
                        for b in self._ports)

    def advertised_port(self, broker_id: int) -> int:
        """The port clients should be told about: the broker's relay
        process port in the out-of-process tier, else its own."""
        return self._advertised.get(broker_id, self._ports[broker_id])

    def set_advertised_port(self, broker_id: int, port: int) -> None:
        with self._lock:
            self._advertised[broker_id] = port

    def create_topic(self, name: str, partitions: int = None,
                     replication: int = 1) -> None:
        with self._lock:
            if name in self.topics:
                return
            n = partitions or self.default_partitions
            self.topics[name] = [self._new_partition(name, i)
                                 for i in range(n)]

    def _new_partition(self, topic: str, i: int) -> MockPartition:
        leader = (i % self.num_brokers) + 1
        if leader in self._down:
            # a topic created mid-storm must not be born with a dead
            # leader — place it on the next alive broker in the ring
            leader = self._next_alive(leader) or leader
        return MockPartition(topic=topic, id=i,
                             leader=leader, replicas=[leader],
                             retention_bytes=self.retention_bytes)

    def _next_alive(self, after: int) -> Optional[int]:
        """Next alive broker in ring order after ``after``; None when
        every broker is down."""
        for k in range(1, self.num_brokers + 1):
            b = ((after - 1 + k) % self.num_brokers) + 1
            if b not in self._down:
                return b
        return None

    def alive_brokers(self) -> list[int]:
        with self._lock:
            return [b for b in range(1, self.num_brokers + 1)
                    if b not in self._down]

    def partition(self, topic: str, part: int) -> MockPartition:
        return self.topics[topic][part]

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        for ls in self._listeners.values():
            ls.close()
        for c in self._conns:
            try:
                c.sock.close()
            except OSError:
                pass

    # -- fault injection (reference: rd_kafka_mock_push_request_errors etc) --
    def push_request_errors(self, api: ApiKey, errors: list[Err]) -> None:
        with self._lock:
            self._err_stacks[int(api)].extend(errors)

    def set_rtt(self, broker_id: int, rtt_ms: float) -> None:
        self._rtt_ms[broker_id] = rtt_ms

    def set_broker_throttle(self, broker_id: int, throttle_ms: int) -> None:
        """Report this throttle_time in every response from the broker
        (reference rd_kafka_mock throttle injection)."""
        with self._lock:
            self._throttle_ms[broker_id] = throttle_ms

    def set_broker_down(self, broker_id: int, down: bool = True) -> None:
        """Take a broker down (or back up). Down means the LISTENER is
        closed — new connects get ECONNREFUSED, so clients exercise the
        real connect-retry/backoff path — and every established
        connection is dropped mid-flight. Up rebinds the same port.

        This is liveness only; ``kill_broker`` adds the controller's
        reaction (leadership + coordinator reassignment)."""
        with self._lock:
            if down:
                if broker_id in self._down:
                    return
                self._paused.discard(broker_id)     # SIGKILL beats SIGSTOP
                self._down.add(broker_id)
                self._close_listener(broker_id)
                for c in list(self._conns):
                    if c.broker_id == broker_id:
                        self._close(c)
                # fetch sessions are broker MEMORY: they die with the
                # broker — a reconnecting client's incremental fetch
                # gets FETCH_SESSION_ID_NOT_FOUND and renegotiates
                for sid in [sid for sid, s in self._fetch_sessions.items()
                            if s["broker"] == broker_id]:
                    del self._fetch_sessions[sid]
            else:
                if broker_id not in self._down:
                    return
                self._down.discard(broker_id)
                self._open_listener(broker_id)
            self.metadata_version += 1

    # ------------------------------- controller role (chaos subsystem) ----
    def kill_broker(self, broker_id: int) -> dict:
        """Broker death as the controller sees it: close the listener
        (new connects refused), drop in-flight connections, and move
        partition leadership + controller id off the dead broker onto
        alive replicas (coordinator placement follows automatically —
        ``coordinator_for`` only ever names alive brokers). Returns a
        summary dict (migrated leaders) for chaos timelines/tests."""
        migrated = []
        self.set_broker_down(broker_id, True)
        with self._lock:
            for tname, parts in self.topics.items():
                for p in parts:
                    if p.leader != broker_id:
                        continue
                    new = next((r for r in p.replicas
                                if r not in self._down), None)
                    new = new or self._next_alive(broker_id)
                    if new is None:
                        continue        # whole cluster is down
                    p.leader = new
                    if new not in p.replicas:
                        p.replicas.append(new)
                    migrated.append((tname, p.id, broker_id, new))
            if self.controller_id == broker_id:
                self.controller_id = self._next_alive(broker_id) or broker_id
            self.metadata_version += 1
        return {"broker": broker_id, "migrated": migrated}

    def restart_broker(self, broker_id: int) -> dict:
        """Bring a killed broker back: rebind its listener on the same
        port. Leadership stays where the kill moved it (a real cluster
        fails back only on preferred-leader election, which a chaos
        schedule scripts explicitly via ``leader_migrate``)."""
        self.set_broker_down(broker_id, False)
        return {"broker": broker_id}

    def kill9(self, broker_id: int) -> dict:
        """In-process stand-in for the chaos ``proc_kill9`` verb: same
        controller reaction as ``kill_broker``.  The out-of-process
        tier (``mock/external.py`` ClusterHandle) implements the same
        method with a real ``SIGKILL`` of the broker's relay process —
        the schedule DSL targets whichever cluster object it was given
        through this one name."""
        return self.kill_broker(broker_id)

    def pause_broker(self, broker_id: int) -> dict:
        """SIGSTOP analog (chaos ``proc_pause``): freeze the broker —
        stop reading its connections and flushing its responses, stop
        accepting (pending connects sit in the kernel backlog exactly
        as they would against a SIGSTOPped process).  Metadata still
        advertises it: a GC-paused broker is alive, just unresponsive,
        so clients walk the request-timeout path, not connect-refused.
        The out-of-process tier sends a real ``SIGSTOP``."""
        with self._lock:
            if broker_id in self._paused or broker_id in self._down:
                return {"broker": broker_id, "skipped": True}
            self._paused.add(broker_id)
            ls = self._listeners.get(broker_id)
            if ls is not None:
                try:
                    self._sel.unregister(ls)
                except (KeyError, ValueError):
                    pass
            for c in self._conns:
                if c.broker_id == broker_id and not c.closed:
                    try:
                        self._sel.unregister(c.sock)
                    except (KeyError, ValueError):
                        pass
        return {"broker": broker_id}

    def resume_broker(self, broker_id: int) -> dict:
        """SIGCONT analog: thaw a paused broker — re-register listener
        and connections and flush whatever queued while frozen."""
        with self._lock:
            if broker_id not in self._paused:
                return {"broker": broker_id, "skipped": True}
            self._paused.discard(broker_id)
            ls = self._listeners.get(broker_id)
            if ls is not None:
                try:
                    self._sel.register(ls, selectors.EVENT_READ,
                                       ("accept", broker_id))
                except (KeyError, ValueError):
                    pass
            thaw = [c for c in self._conns
                    if c.broker_id == broker_id and not c.closed]
            for c in thaw:
                try:
                    self._sel.register(c.sock, selectors.EVENT_READ,
                                       ("conn", c))
                except (KeyError, ValueError):
                    pass
        for c in thaw:
            self._flush(c)
        return {"broker": broker_id}

    def paused_brokers(self) -> list[int]:
        with self._lock:
            return sorted(self._paused)

    # ------------------------- environment fault library --
    def set_storage_error(self, broker_id: Optional[int] = None,
                          on: bool = True) -> dict:
        """Disk-full/EIO window on the storage plane (chaos
        ``env_eio``): every Produce led by an affected broker returns
        ``KAFKA_STORAGE_ERROR`` — the retriable error a real broker
        raises when its log dir fails — until the window heals.
        ``broker_id=None`` applies cluster-wide (all brokers)."""
        with self._lock:
            ids = ([broker_id] if broker_id
                   else list(range(1, self.num_brokers + 1)))
            for b in ids:
                if on:
                    self._storage_err.add(b)
                else:
                    self._storage_err.discard(b)
            return {"brokers": sorted(self._storage_err), "on": on}

    def storage_error_brokers(self) -> list[int]:
        with self._lock:
            return sorted(self._storage_err)

    def set_clock_skew(self, broker_id: int, skew_ms: float = 0.0) -> dict:
        """Clock-skew fault (chaos ``env_skew``): broker
        ``broker_id``'s wall clock reads ``skew_ms`` off true — every
        wall timestamp it reports (Produce ``log_append_time``,
        ``broker_clock_ms``) shifts accordingly.  0 restores a true
        clock."""
        with self._lock:
            if skew_ms:
                self._clock_skew_ms[broker_id] = float(skew_ms)
            else:
                self._clock_skew_ms.pop(broker_id, None)
            return {"broker": broker_id, "skew_ms": skew_ms}

    def broker_clock_ms(self, broker_id: int) -> int:
        """This broker's idea of wall-clock now, in ms (true clock +
        any injected skew)."""
        with self._lock:
            skew = self._clock_skew_ms.get(broker_id, 0.0)
        return int(time.time() * 1000.0 + skew)

    def clock_skews(self) -> dict[int, float]:
        with self._lock:
            return dict(self._clock_skew_ms)

    def rolling_restart(self, pause_s: float = 0.5) -> None:
        """Kill + restart every broker in id order, one at a time,
        waiting ``pause_s`` between steps (blocking convenience; chaos
        schedules script the same thing with precise timing)."""
        for b in range(1, self.num_brokers + 1):
            self.kill_broker(b)
            time.sleep(pause_s)
            self.restart_broker(b)
            time.sleep(pause_s)

    def set_partition_leader(self, topic: str, part: int, broker_id: int):
        with self._lock:
            p = self.topics[topic][part]
            p.leader = broker_id
            if broker_id not in p.replicas:
                p.replicas.append(broker_id)
            self.metadata_version += 1

    def coordinator_for(self, group: str) -> int:
        """Group/txn coordinator placement: hash ring, skipping dead
        brokers — when a coordinator dies, FindCoordinator immediately
        names the next alive broker (state is cluster-global here, so
        the successor serves seamlessly, like a real coordinator
        failover after __consumer_offsets replay)."""
        # stable hash (NOT builtin hash(): PYTHONHASHSEED randomizes it
        # per interpreter, and the out-of-process replay contract needs
        # the same key to land on the same broker across supervisor
        # launches — same seed => identical replay_key)
        base = (zlib.crc32(group.encode()) % self.num_brokers) + 1
        if base not in self._down:
            return base
        return self._next_alive(base) or base

    # -------------------------------------------------------------- loop ---
    def _run(self):
        while not self._stop.is_set():
            if _lockdep.enabled:
                _lockdep.note_blocking("mock.select")
            events = self._sel.select(timeout=0.005)
            now = time.monotonic()
            for key, mask in events:
                kind = key.data[0]
                if kind == "accept":
                    broker_id = key.data[1]
                    if broker_id in self._down:
                        try:
                            s, _ = key.fileobj.accept()
                            s.close()
                        except OSError:
                            pass
                        continue
                    try:
                        s, _ = key.fileobj.accept()
                    except OSError:
                        continue
                    s.setblocking(False)
                    conn = _Conn(s, broker_id)
                    if self._tls_ctx is not None:
                        try:
                            conn.sock = self._tls_ctx.wrap_socket(
                                s, server_side=True,
                                do_handshake_on_connect=False)
                            conn.handshaking = True
                        except (OSError, ValueError):
                            s.close()
                            continue
                    self._conns.append(conn)
                    self._sel.register(conn.sock, selectors.EVENT_READ,
                                       ("conn", conn))
                else:
                    conn = key.data[1]
                    if mask & selectors.EVENT_READ:
                        self._read(conn)
                    if mask & selectors.EVENT_WRITE:
                        self._flush(conn)
            # deferred responses (rtt injection) and group timers
            with self._lock:
                due = [d for d in self._deferred if d[0] <= now]
                self._deferred = [d for d in self._deferred if d[0] > now]
            for _, fn in due:
                fn()
            self._serve_parked_fetches(now)
            self._serve_group_timers(now)

    def _hs_serve(self, conn: _Conn) -> bool:
        """Advance a server-side TLS handshake; True once established."""
        try:
            conn.sock.do_handshake()
        except _ssl.SSLWantReadError:
            return False
        except _ssl.SSLWantWriteError:
            try:
                self._sel.modify(conn.sock,
                                 selectors.EVENT_READ | selectors.EVENT_WRITE,
                                 ("conn", conn))
            except (KeyError, ValueError):
                pass
            return False
        except (OSError, _ssl.SSLError):
            self._close(conn)
            return False
        conn.handshaking = False
        try:
            self._sel.modify(conn.sock, selectors.EVENT_READ, ("conn", conn))
        except (KeyError, ValueError):
            pass
        return True

    def _read(self, conn: _Conn):
        if conn.broker_id in self._paused:
            return              # race: event dequeued as the freeze hit
        if conn.handshaking:
            self._hs_serve(conn)
            return
        try:
            data = conn.sock.recv(262144)
        except (BlockingIOError, _ssl.SSLWantReadError, _ssl.SSLWantWriteError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            self._close(conn)
            return
        conn.rbuf += data
        # drain SSL-layer buffered records invisible to the selector
        while self._tls_ctx is not None:
            try:
                if not conn.sock.pending():
                    break
                more = conn.sock.recv(262144)
            except (OSError, ValueError):
                break
            if not more:
                break
            conn.rbuf += more
        # offset-based frame walk: one compaction per recv burst instead
        # of a memmove per request (1MB Produce requests arrive in ~64KB
        # chunks; per-frame `del` shifted the tail every time)
        frames, bad = sockbuf.extract_frames(conn.rbuf)
        for payload in frames:
            self._handle(conn, payload)
            if conn.closed:
                return
        if bad is not None:
            self._close(conn)

    def _close(self, conn: _Conn):
        if conn.closed:
            return
        conn.closed = True
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn in self._conns:
            self._conns.remove(conn)

    def _send(self, conn: _Conn, data: bytes):
        if conn.closed:
            return
        conn.wbuf += data
        self._flush(conn)

    def _flush(self, conn: _Conn):
        if conn.closed or conn.broker_id in self._paused:
            # frozen broker (pause_broker): responses queue in wbuf and
            # flush on resume — nothing leaves a SIGSTOPped process
            return
        if conn.handshaking:
            self._hs_serve(conn)
            return
        off, blocked, err = sockbuf.send_from(conn.sock, conn.wbuf,
                                              conn.wbuf_off)
        conn.wbuf_off = sockbuf.compact_consumed(conn.wbuf, off)
        if err is not None:
            self._close(conn)
            return
        if blocked:
            try:
                self._sel.modify(conn.sock,
                                 selectors.EVENT_READ | selectors.EVENT_WRITE,
                                 ("conn", conn))
            except (KeyError, ValueError):
                pass
            return
        try:
            self._sel.modify(conn.sock, selectors.EVENT_READ, ("conn", conn))
        except (KeyError, ValueError):
            pass

    # ---------------------------------------------------------- dispatch ---
    def _handle(self, conn: _Conn, payload: bytes):
        try:
            hdr, body = apis.parse_request(payload)
        except Exception:
            self._close(conn)
            return
        api = ApiKey(hdr["api_key"])
        corrid = hdr["correlation_id"]
        self.request_log.append((conn.broker_id, int(api)))

        # scripted error stack for this api?
        inject: Optional[Err] = None
        with self._lock:
            stack = self._err_stacks.get(int(api))
            if stack:
                inject = stack.popleft()

        # legacy-broker emulation: pre-0.10 brokers do not know
        # ApiVersions and close the connection on unknown requests
        if (self.broker_version is not None
                and api == ApiKey.ApiVersions
                and self._bv_tuple < (0, 10, 0)):
            self._close(conn)
            return

        handler = getattr(self, f"_h_{api.name}", None)
        if handler is None:
            self._close(conn)
            return
        resp = handler(conn, corrid, hdr, body, inject)
        if resp is None:
            return  # parked (fetch/join) — handler responds later
        self._respond(conn, corrid, api, resp, version=hdr["api_version"])

    def _respond(self, conn: _Conn, corrid: int, api: ApiKey, body: dict,
                 version: int | None = None):
        tt = self._throttle_ms.get(conn.broker_id)
        if tt and isinstance(body, dict) and "throttle_time_ms" in body:
            body = dict(body)
            body["throttle_time_ms"] = tt
        wire = apis.build_response(api, corrid, body, version=version)
        rtt = self._rtt_ms.get(conn.broker_id, 0)
        if rtt > 0:
            with self._lock:
                self._deferred.append((time.monotonic() + rtt / 1000.0,
                                       lambda: self._send(conn, wire)))
        else:
            self._send(conn, wire)

    # ---------------------------------------------------------- handlers ---
    def _h_ApiVersions(self, conn, corrid, hdr, body, inject):
        if self.broker_version is not None:
            from ..client.feature import fallback_api_versions
            av = fallback_api_versions(self.broker_version)
            vers = [{"api_key": k, "min_version": 0, "max_version": v}
                    for k, v in av.items()]
        else:
            vers = [{"api_key": int(k), "min_version": 0, "max_version": v}
                    for k, (v, _, _) in APIS.items()]
        return {"error_code": (inject.wire if inject else 0),
                "api_versions": vers}

    def _h_Metadata(self, conn, corrid, hdr, body, inject):
        with self._lock:
            names = body["topics"]
            # v4+ request flag (KIP-204): a False flag suppresses broker
            # auto-creation even when the cluster allows it
            allow = body.get("allow_auto_topic_creation", True)
            # Metadata v1+ semantics: ONLY a null
            # topic array enumerates everything; an EMPTY array means
            # "no topics" — a brokers-only liveness probe.  The old
            # conflation materialized the full topic table for clients
            # that asked for nothing.
            if names is None:
                names = list(self.topics)
            elif names and self.auto_create_topics and allow:
                for t in names:
                    if t not in self.topics and _valid_topic_name(t):
                        self.create_topic(t)
            topics = []
            for t in names:
                if t not in self.topics and not _valid_topic_name(t):
                    # real brokers reject bad names with
                    # INVALID_TOPIC_EXCEPTION (reference test
                    # 0057-invalid_topic); existence wins so a fixture-
                    # created topic always serves
                    topics.append({"error_code": Err.TOPIC_EXCEPTION.wire,
                                   "topic": t, "is_internal": False,
                                   "partitions": []})
                    continue
                if t not in self.topics:
                    topics.append({"error_code": Err.UNKNOWN_TOPIC_OR_PART.wire,
                                   "topic": t, "is_internal": False,
                                   "partitions": []})
                    continue
                parts = [{"error_code": 0, "partition": p.id,
                          "leader": p.leader if p.leader not in self._down else -1,
                          "replicas": p.replicas, "isr": p.replicas}
                         for p in self.topics[t]]
                topics.append({"error_code": inject.wire if inject else 0,
                               "topic": t, "is_internal": False,
                               "partitions": parts})
            brokers = [{"node_id": b, "host": "127.0.0.1",
                        "port": self.advertised_port(b), "rack": None}
                       for b in self._ports if b not in self._down]
        return {"throttle_time_ms": 0,   # serialized for v3+ only
                "brokers": brokers, "cluster_id": self.cluster_id,
                "controller_id": self.controller_id, "topics": topics}

    def _h_Produce(self, conn, corrid, hdr, body, inject):
        out_topics = []
        with self._lock:
            # env_eio: this broker's log dir is "failed" — refuse every
            # append with the retriable storage error a real broker
            # raises, without touching the log (nothing is persisted)
            storage_dead = conn.broker_id in self._storage_err
            skew = self._clock_skew_ms.get(conn.broker_id)
            la_time = (int(time.time() * 1000.0 + skew)
                       if skew is not None else -1)
            for t in body["topics"]:
                tp = {"topic": t["topic"], "partitions": []}
                for p in t["partitions"]:
                    err = Err.NO_ERROR
                    base = -1
                    part = None
                    # REQUEST_TIMED_OUT injection emulates "broker committed
                    # but the response was lost": append, THEN error — the
                    # scenario behind idempotent dup-seq handling (reference
                    # test 0094-idempotence_msg_timeout)
                    if inject and inject != Err.REQUEST_TIMED_OUT:
                        err = inject
                    elif t["topic"] not in self.topics or \
                            p["partition"] >= len(self.topics[t["topic"]]):
                        err = Err.UNKNOWN_TOPIC_OR_PART
                    else:
                        part = self.topics[t["topic"]][p["partition"]]
                        if part.leader != conn.broker_id:
                            err = Err.NOT_LEADER_FOR_PARTITION
                            part = None
                        elif storage_dead:
                            err = Err.KAFKA_STORAGE_ERROR
                            part = None
                    if part is not None:
                        blob = p["records"]
                        err, base = self._produce_to(part, blob)
                        if inject:
                            err, base = inject, -1
                    tp["partitions"].append(
                        {"partition": p["partition"], "error_code": err.wire,
                         "base_offset": base, "log_append_time": la_time})
                out_topics.append(tp)
        if body["acks"] == 0:
            return None  # no response for acks=0
        return {"topics": out_topics, "throttle_time_ms": 0}

    def _produce_to(self, part: MockPartition, blob: bytes) -> tuple[Err, int]:
        # idempotence checks for v2 batches (reference mock_handlers Produce)
        txn = None
        info = None
        if (len(blob) >= proto.V2_HEADER_SIZE
                and blob[proto.V2_OF_Magic] == 2):
            try:
                info = read_batch_header(Slice(blob))
            except Exception:
                return Err.INVALID_MSG, -1
            if info.producer_id >= 0:
                # epoch fencing precedes everything: a zombie's stale
                # epoch must never append (real broker ProducerStateManager)
                tid = self._pid_tid.get(info.producer_id)
                txn = self.transactions.get(tid) if tid else None
                if txn is not None and info.producer_epoch != txn.epoch:
                    return (Err.PRODUCER_FENCED
                            if info.producer_epoch < txn.epoch
                            else Err.INVALID_PRODUCER_EPOCH), -1
                if info.is_transactional:
                    if txn is None:
                        return Err.INVALID_PRODUCER_ID_MAPPING, -1
                    if (part.topic, part.id) not in txn.partitions:
                        # transactional data requires AddPartitionsToTxn
                        # first — the coordinator can't write a marker
                        # for a partition it never heard of
                        return Err.INVALID_TXN_STATE, -1
                key = (info.producer_id, info.producer_epoch)
                expected = part.pid_seqs.get(key, 0)
                if info.base_sequence != expected:
                    if info.base_sequence < expected:
                        return Err.DUPLICATE_SEQUENCE_NUMBER, -1
                    return Err.OUT_OF_ORDER_SEQUENCE_NUMBER, -1
                part.pid_seqs[key] = info.base_sequence + info.record_count
        base = part.append(blob)
        if info is not None and info.is_transactional and txn is not None:
            # first data offset of this txn in this partition: feeds
            # the aborted-txn index entry and pins the LSO
            tkey = (part.topic, part.id)
            if txn.partitions.get(tkey) is None:
                txn.partitions[tkey] = base
            part.open_txns.setdefault(info.producer_id, base)
        return Err.NO_ERROR, base

    def set_follower(self, topic: str, partition: int,
                     broker_id: Optional[int]) -> None:
        """Nominate (or clear) a preferred read replica for v11+
        fetches (reference: rd_kafka_mock_partition_set_follower)."""
        with self._lock:
            self.topics[topic][partition].follower_id = broker_id

    # ------------------------------------------------------------------
    # KIP-227 incremental fetch sessions

    def _session_error(self, err: Err) -> dict:
        """Top-level session error: empty topics, client renegotiates."""
        return {"throttle_time_ms": 0, "error_code": err.wire,
                "session_id": 0, "topics": []}

    def _evict_fetch_sessions_locked(self) -> None:
        """LRU-evict past the cache cap (mirrors the real broker's
        max.incremental.fetch.session.cache.slots). Lock held."""
        while len(self._fetch_sessions) > self.fetch_session_slots:
            victim = min(self._fetch_sessions,
                         key=lambda sid: self._fetch_sessions[sid]["last"])
            del self._fetch_sessions[victim]

    def evict_fetch_sessions(self, broker_id: Optional[int] = None) -> int:
        """Test hook: drop cached fetch sessions (all, or one broker's).
        The next incremental fetch gets FETCH_SESSION_ID_NOT_FOUND."""
        with self._lock:
            doomed = [sid for sid, s in self._fetch_sessions.items()
                      if broker_id is None or s["broker"] == broker_id]
            for sid in doomed:
                del self._fetch_sessions[sid]
            return len(doomed)

    def fetch_session_ids(self, broker_id: Optional[int] = None) -> list:
        """Test hook: session ids cached (for one broker, or all)."""
        with self._lock:
            return [sid for sid, s in self._fetch_sessions.items()
                    if broker_id is None or s["broker"] == broker_id]

    @staticmethod
    def _session_book_merge(book: dict, body: dict) -> None:
        """Fold a request's partition list + forgotten list into the
        session book {(topic, partition): {fetch_offset, max_bytes}}."""
        for ft in body.get("forgotten_topics") or []:
            for p in ft["partitions"]:
                book.pop((ft["topic"], p), None)
        for t in body["topics"]:
            for p in t["partitions"]:
                book[(t["topic"], p["partition"])] = {
                    "fetch_offset": p["fetch_offset"],
                    "max_bytes": p["max_bytes"]}

    @staticmethod
    def _session_body(body: dict, book: dict) -> dict:
        """Materialize the effective fetch body from a session book —
        the incremental request named only CHANGES; the broker serves
        its cached view of the full interest set."""
        by_topic: dict = {}
        for (t, p), st in book.items():
            by_topic.setdefault(t, []).append(
                {"partition": p, "fetch_offset": st["fetch_offset"],
                 "max_bytes": st["max_bytes"]})
        eff = dict(body)
        eff["topics"] = [{"topic": t, "partitions": ps}
                         for t, ps in sorted(by_topic.items())]
        return eff

    def _h_Fetch(self, conn, corrid, hdr, body, inject):
        now = time.monotonic()
        ver = hdr["api_version"]
        epoch = body.get("session_epoch", -1)
        sess = None           # (session_id, incremental-response?)
        eff_body = body
        if ver >= 7 and epoch != -1:
            with self._lock:
                if epoch == 0:
                    # FULL_FETCH establishing a session: cache the whole
                    # partition book, answer with a broker-assigned id
                    sid = self._next_session_id
                    self._next_session_id += 1
                    book: dict = {}
                    self._session_book_merge(book, body)
                    self._fetch_sessions[sid] = {
                        "broker": conn.broker_id, "epoch": 1,
                        "book": book, "last": now}
                    self._evict_fetch_sessions_locked()
                    sess = (sid, False)   # full response this once
                else:
                    sid = body.get("session_id", 0)
                    s = self._fetch_sessions.get(sid)
                    if s is None or s["broker"] != conn.broker_id:
                        return self._session_error(
                            Err.FETCH_SESSION_ID_NOT_FOUND)
                    if epoch != s["epoch"]:
                        return self._session_error(
                            Err.INVALID_FETCH_SESSION_EPOCH)
                    self._session_book_merge(s["book"], body)
                    s["epoch"] += 1
                    s["last"] = now
                    sess = (sid, True)
                    eff_body = self._session_body(body, s["book"])
        resp = self._try_fetch(conn, eff_body, inject, ver=ver,
                               incremental=bool(sess and sess[1]))
        if resp is not None:
            if sess is not None:
                resp["error_code"] = 0
                resp["session_id"] = sess[0]
            return resp
        # no data yet: park until max_wait or data arrives
        deadline = now + body["max_wait_time"] / 1000.0
        self._parked_fetches.append((deadline, conn, corrid, eff_body,
                                     ver, sess))
        return None

    def _try_fetch(self, conn, body, inject, force: bool = False,
                   ver: int = 4, incremental: bool = False):
        """Build a fetch response, or None if empty and not forced."""
        any_data = False
        any_err = False
        out_topics = []
        with self._lock:
            for t in body["topics"]:
                tp = {"topic": t["topic"], "partitions": []}
                for p in t["partitions"]:
                    err = Err.NO_ERROR
                    records = b""
                    hwm = lso = -1
                    preferred = -1
                    if inject:
                        err = inject
                    elif t["topic"] not in self.topics or \
                            p["partition"] >= len(self.topics[t["topic"]]):
                        err = Err.UNKNOWN_TOPIC_OR_PART
                    else:
                        part = self.topics[t["topic"]][p["partition"]]
                        serves = (part.leader == conn.broker_id
                                  or part.follower_id == conn.broker_id)
                        if not serves:
                            err = Err.NOT_LEADER_FOR_PARTITION
                        elif (part.leader == conn.broker_id
                              and part.follower_id is not None
                              and part.follower_id != conn.broker_id
                              and part.follower_id not in self._down
                              and ver >= 11):
                            # KIP-392 redirect: the leader answers a
                            # v11 fetch with the nominated follower and
                            # NO records (real broker behavior)
                            hwm = lso = part.end_offset
                            preferred = part.follower_id
                        else:
                            hwm = part.end_offset
                            lso = part.lso()
                            off = p["fetch_offset"]
                            # read_committed fetches stop at the LSO:
                            # data of a still-open transaction is not
                            # stable yet (real broker behavior)
                            cap = (lso if body.get("isolation_level", 0)
                                   == 1 else part.end_offset)
                            if off < part.start_offset or off > part.end_offset:
                                err = Err.OFFSET_OUT_OF_RANGE
                            elif off < cap:
                                records = part.read_from(
                                    off, p["max_bytes"],
                                    max_offset=cap)
                    if err != Err.NO_ERROR:
                        any_err = True
                    if records:
                        any_data = True
                    aborted = []
                    if body.get("isolation_level", 0) == 1 and records:
                        # read_committed: report only aborted-txn ranges
                        # overlapping the fetched span — an entry whose
                        # ABORT marker precedes the fetch offset must
                        # not be re-reported or the client would filter
                        # later committed data from the same pid
                        # (txn index maintained by EndTxn, also
                        # test-seedable via part.aborted;
                        # "last_offset" = abort marker offset)
                        aborted = [
                            a for a in part.aborted or []
                            if a.get("last_offset", 1 << 62)
                            >= p["fetch_offset"]]
                    if preferred != -1:
                        any_data = True      # redirects return immediately
                    if incremental and not records \
                            and err == Err.NO_ERROR and preferred == -1:
                        # KIP-227: incremental responses OMIT unchanged
                        # empty partitions — the whole point of the
                        # session; steady-state long-poll answers are
                        # O(partitions-with-data), not O(interest set)
                        continue
                    tp["partitions"].append(
                        {"partition": p["partition"], "error_code": err.wire,
                         "high_watermark": hwm, "last_stable_offset": lso,
                         "aborted_transactions": aborted,
                         "preferred_read_replica": preferred,
                         "records": records})
                if tp["partitions"]:
                    out_topics.append(tp)
        if not any_data and not any_err and not force:
            return None
        return {"throttle_time_ms": 0, "topics": out_topics}

    def _serve_parked_fetches(self, now: float):
        still = []
        for deadline, conn, corrid, body, ver, sess in self._parked_fetches:
            if conn.closed:
                continue
            resp = self._try_fetch(conn, body, None,
                                   force=(now >= deadline), ver=ver,
                                   incremental=bool(sess and sess[1]))
            if resp is not None:
                if sess is not None:
                    resp["error_code"] = 0
                    resp["session_id"] = sess[0]
                self._respond(conn, corrid, ApiKey.Fetch, resp, version=ver)
            else:
                still.append((deadline, conn, corrid, body, ver, sess))
        self._parked_fetches = still

    def _h_ListOffsets(self, conn, corrid, hdr, body, inject):
        out = []
        with self._lock:
            for t in body["topics"]:
                tp = {"topic": t["topic"], "partitions": []}
                for p in t["partitions"]:
                    err = Err.NO_ERROR
                    offset = -1
                    if inject:
                        err = inject
                    elif t["topic"] not in self.topics:
                        err = Err.UNKNOWN_TOPIC_OR_PART
                    else:
                        part = self.topics[t["topic"]][p["partition"]]
                        ts = p["timestamp"]
                        if ts == proto.OFFSET_BEGINNING:
                            offset = part.start_offset
                        elif ts == proto.OFFSET_END:
                            offset = part.end_offset
                        else:
                            # timestamp lookup (offsets_for_times): the
                            # earliest offset whose batch could contain
                            # ts, from the stored batch headers
                            offset = -1
                            for base, blob in part.log:
                                if (len(blob) < proto.V2_HEADER_SIZE
                                        or blob[proto.V2_OF_Magic] != 2):
                                    continue
                                max_ts = struct.unpack_from(
                                    ">q", blob, proto.V2_OF_MaxTimestamp)[0]
                                if max_ts >= ts:
                                    offset = base
                                    break
                    tp["partitions"].append(
                        {"partition": p["partition"], "error_code": err.wire,
                         "timestamp": -1, "offset": offset,
                         # plural form for ListOffsets v0 responses
                         "offsets": [offset] if offset >= 0 else []})
                out.append(tp)
        return {"topics": out}

    # ------------------------------------------------------ group machinery --
    def _h_FindCoordinator(self, conn, corrid, hdr, body, inject):
        if inject:
            return {"throttle_time_ms": 0, "error_code": inject.wire,
                    "error_message": None, "node_id": -1, "host": "",
                    "port": -1}
        b = self.coordinator_for(body["key"])
        return {"throttle_time_ms": 0, "error_code": 0, "error_message": None,
                "node_id": b, "host": "127.0.0.1",
                "port": self.advertised_port(b)}

    def _group(self, gid: str) -> MockGroup:
        with self._lock:
            if gid not in self.groups:
                self.groups[gid] = MockGroup(group_id=gid)
            return self.groups[gid]

    def _member_id_for(self, g, body, client_id):
        """Static members (group.instance.id) keep a stable member_id
        across restarts (KIP-345); dynamic members get a fresh one."""
        inst = body.get("group_instance_id")
        if inst:
            for m in g.members.values():
                if getattr(m, "instance_id", None) == inst:
                    return m.member_id
            return f"{client_id}-static-{inst}"
        return None

    def _h_JoinGroup(self, conn, corrid, hdr, body, inject):
        if inject:
            return {"throttle_time_ms": 0, "error_code": inject.wire,
                    "generation_id": -1, "protocol": "", "leader_id": "",
                    "member_id": body["member_id"], "members": []}
        g = self._group(body["group_id"])
        with self._lock:
            member_id = body["member_id"]
            static_id = self._member_id_for(g, body,
                                            hdr["client_id"] or "member")
            if static_id is not None:
                member_id = static_id
                m = g.members.get(member_id)
                if m is not None and g.state == "Stable" \
                        and self._static_rejoin_ok(m, body):
                    # KIP-345 static rejoin fast path: a known
                    # group.instance.id returning while the group is
                    # Stable reclaims its slot at the CURRENT
                    # generation — no rebalance, nobody else revokes
                    # anything; SyncGroup serves the retained
                    # assignment (real broker behavior for static
                    # members inside session.timeout.ms)
                    m.protocols = [(p["name"], p["metadata"])
                                   for p in body["protocols"]]
                    m.metadata = m.protocols[0][1] if m.protocols else b""
                    m.session_timeout_ms = body["session_timeout"]
                    m.last_heartbeat = time.monotonic()
                    members_meta = [
                        {"member_id": mm.member_id,
                         "group_instance_id": getattr(mm, "instance_id",
                                                      None),
                         "metadata": dict(mm.protocols).get(g.protocol,
                                                            b"")}
                        for mm in g.members.values()]
                    return {"throttle_time_ms": 0, "error_code": 0,
                            "generation_id": g.generation,
                            "protocol": g.protocol, "leader_id": g.leader,
                            "member_id": member_id,
                            "members": (members_meta
                                        if member_id == g.leader else [])}
            if not member_id:
                member_id = f"{hdr['client_id'] or 'member'}-{len(g.members) + 1}-{int(time.monotonic()*1e6) & 0xFFFF}"
            m = g.members.get(member_id)
            if m is None:
                m = GroupMember(member_id=member_id,
                                client_id=hdr["client_id"] or "",
                                client_host="/127.0.0.1")
                m.instance_id = body.get("group_instance_id")
                g.members[member_id] = m
            m.protocols = [(p["name"], p["metadata"]) for p in body["protocols"]]
            m.metadata = m.protocols[0][1] if m.protocols else b""
            m.session_timeout_ms = body["session_timeout"]
            m.last_heartbeat = time.monotonic()
            g.protocol_type = body["protocol_type"]
            m.pending_join = (conn, corrid, hdr["api_version"])
            if g.state in ("Empty", "Stable", "CompletingRebalance"):
                was_empty = g.state == "Empty"
                g.state = "PreparingRebalance"
                g.rebalance_deadline = time.monotonic() + min(
                    body.get("rebalance_timeout", 3000), 3000) / 1000.0
                if was_empty and self.group_initial_delay_s > 0:
                    # KIP-134 group.initial.rebalance.delay.ms: hold
                    # the FIRST generation open so a starting fleet
                    # joins together
                    g.hold_until = (time.monotonic()
                                    + self.group_initial_delay_s)
                    g.rebalance_deadline = max(g.rebalance_deadline,
                                               g.hold_until)
            # complete immediately if every member has rejoined
            self._maybe_complete_join(g)
        return None  # parked; responded by _maybe_complete_join / timer

    @staticmethod
    def _static_rejoin_ok(m, body) -> bool:
        """Whether a known static member's JoinGroup may take the
        no-rebalance fast path: its effective subscription (protocol
        names + topic lists) must be unchanged, AND it must be either
        a fresh restart reclaiming its slot (empty member_id — the new
        instance never knew its id) or the live member itself.  A LIVE
        cooperative member rejoining after an incremental revoke
        carries a CHANGED owned_partitions set and an explicit
        member_id — that rejoin exists to trigger the next generation
        and must NOT be swallowed (real GroupCoordinator semantics:
        updateMemberAndRebalance when the protocols changed)."""
        from ..client.assignor import subscription_decode

        def sig(protocols):
            out = []
            for name, meta in protocols:
                try:
                    out.append((name, tuple(
                        subscription_decode(meta)["topics"])))
                except Exception:
                    out.append((name, bytes(meta)))
            return out

        new = [(p["name"], bytes(p["metadata"])) for p in body["protocols"]]
        old = [(n, bytes(b)) for n, b in m.protocols]
        if not body["member_id"]:
            # fresh restart reclaiming the slot: the new instance never
            # knew its owned set, so compare topics only
            return sig(new) == sig(old)
        # live member: byte-exact metadata match — a cooperative
        # rejoin after an incremental revoke differs in
        # owned_partitions and must trigger the next generation
        return body["member_id"] == m.member_id and new == old

    def _maybe_complete_join(self, g: MockGroup):
        if g.state != "PreparingRebalance":
            return
        if time.monotonic() < g.hold_until:
            return          # initial-rebalance delay window still open
        if any(m.pending_join is None for m in g.members.values()):
            return
        self._complete_join(g)

    def _complete_join(self, g: MockGroup):
        # drop members that never rejoined
        g.members = {mid: m for mid, m in g.members.items()
                     if m.pending_join is not None}
        if not g.members:
            g.state = "Empty"
            return
        g.generation += 1
        # pick first common protocol
        proto_names = None
        for m in g.members.values():
            names = [n for n, _ in m.protocols]
            proto_names = names if proto_names is None else \
                [n for n in proto_names if n in names]
        g.protocol = proto_names[0] if proto_names else ""
        g.leader = next(iter(g.members))
        g.state = "CompletingRebalance"
        members_meta = [
            {"member_id": m.member_id,
             "group_instance_id": getattr(m, "instance_id", None),
             "metadata": dict(m.protocols).get(g.protocol, b"")}
            for m in g.members.values()]
        for m in g.members.values():
            conn, corrid, jver = m.pending_join
            m.pending_join = None
            body = {"throttle_time_ms": 0, "error_code": 0,
                    "generation_id": g.generation, "protocol": g.protocol,
                    "leader_id": g.leader, "member_id": m.member_id,
                    "members": members_meta if m.member_id == g.leader else []}
            self._respond(conn, corrid, ApiKey.JoinGroup, body, version=jver)

    def _serve_group_timers(self, now: float):
        with self._lock:
            for g in self.groups.values():
                if g.state == "PreparingRebalance" and now >= g.rebalance_deadline:
                    # rebalance window expired: complete with who rejoined
                    self._complete_join(g)
                # session timeout enforcement
                dead = [mid for mid, m in g.members.items()
                        if m.pending_join is None and g.state == "Stable"
                        and now - m.last_heartbeat >
                        m.session_timeout_ms / 1000.0]
                for mid in dead:
                    del g.members[mid]
                    if g.members:
                        g.state = "PreparingRebalance"
                        g.rebalance_deadline = now + 3.0
                    else:
                        g.state = "Empty"

    def _h_SyncGroup(self, conn, corrid, hdr, body, inject):
        if inject:
            return {"throttle_time_ms": 0, "error_code": inject.wire,
                    "assignment": b""}
        g = self._group(body["group_id"])
        with self._lock:
            if body["generation_id"] != g.generation or \
                    body["member_id"] not in g.members:
                return {"throttle_time_ms": 0,
                        "error_code": Err.ILLEGAL_GENERATION.wire,
                        "assignment": b""}
            if g.state == "PreparingRebalance":
                return {"throttle_time_ms": 0,
                        "error_code": Err.REBALANCE_IN_PROGRESS.wire,
                        "assignment": b""}
            if body["member_id"] == g.leader:
                for a in body["assignments"]:
                    if a["member_id"] in g.members:
                        g.members[a["member_id"]].assignment = a["assignment"]
                self._validate_group_assignment(g)
                g.state = "Stable"
                # flush parked syncs; a parked member that was dropped
                # meanwhile (never rejoined before the rebalance window
                # closed — heavy churn does this constantly) gets
                # UNKNOWN_MEMBER_ID so it re-joins, never a KeyError
                for (pconn, pcorrid, pmid, pver) in g.pending_syncs:
                    if pmid in g.members:
                        body = {"throttle_time_ms": 0, "error_code": 0,
                                "assignment": g.members[pmid].assignment}
                    else:
                        body = {"throttle_time_ms": 0,
                                "error_code": Err.UNKNOWN_MEMBER_ID.wire,
                                "assignment": b""}
                    self._respond(pconn, pcorrid, ApiKey.SyncGroup, body,
                                  version=pver)
                g.pending_syncs.clear()
                return {"throttle_time_ms": 0, "error_code": 0,
                        "assignment": g.members[g.leader].assignment}
            if g.state == "Stable":
                return {"throttle_time_ms": 0, "error_code": 0,
                        "assignment": g.members[body["member_id"]].assignment}
            g.pending_syncs.append((conn, corrid, body["member_id"],
                                    hdr["api_version"]))
            return None

    def _validate_group_assignment(self, g: MockGroup):
        """Ownership validation (called under ``self._lock``
        when a leader sync lands): decode every member's embedded-
        protocol assignment, flag (a) partitions owned by two members
        in ONE generation and (b) — for COOPERATIVE protocols — a
        partition handed to a new owner in the same generation its
        previous owner lost it (KIP-429 requires an intermediate
        generation where nobody owns it).  Violations are recorded in
        ``g.validation_errors`` for tests/oracles; the wire response
        is unchanged (a real broker treats assignments as opaque)."""
        from ..client.assignor import ASSIGNOR_PROTOCOLS, assignment_decode
        new_owned: dict[tuple[str, int], str] = {}
        for mid, m in g.members.items():
            try:
                asn = assignment_decode(m.assignment or b"")
            except Exception:
                continue            # opaque/foreign protocol bytes
            for t, ps in asn.items():
                for p in ps:
                    prev = new_owned.get((t, p))
                    if prev is not None and prev != mid:
                        g.validation_errors.append(
                            {"kind": "double_owner", "gen": g.generation,
                             "topic": t, "partition": p,
                             "members": sorted((prev, mid))})
                    new_owned[(t, p)] = mid
        if ASSIGNOR_PROTOCOLS.get(g.protocol) == "COOPERATIVE":
            for tp, mid in new_owned.items():
                old = g.owned.get(tp)
                if old is not None and old != mid and old in g.members:
                    g.validation_errors.append(
                        {"kind": "moved_without_revoke",
                         "gen": g.generation, "topic": tp[0],
                         "partition": tp[1], "from": old, "to": mid})
        g.owned = new_owned

    def _h_Heartbeat(self, conn, corrid, hdr, body, inject):
        if inject:
            return {"throttle_time_ms": 0, "error_code": inject.wire}
        g = self._group(body["group_id"])
        with self._lock:
            m = g.members.get(body["member_id"])
            if m is None:
                return {"throttle_time_ms": 0,
                        "error_code": Err.UNKNOWN_MEMBER_ID.wire}
            if body["generation_id"] != g.generation:
                return {"throttle_time_ms": 0,
                        "error_code": Err.ILLEGAL_GENERATION.wire}
            m.last_heartbeat = time.monotonic()
            if g.state == "PreparingRebalance":
                return {"throttle_time_ms": 0,
                        "error_code": Err.REBALANCE_IN_PROGRESS.wire}
        return {"throttle_time_ms": 0, "error_code": 0}

    def _h_LeaveGroup(self, conn, corrid, hdr, body, inject):
        g = self._group(body["group_id"])
        with self._lock:
            g.members.pop(body["member_id"], None)
            if g.members:
                g.state = "PreparingRebalance"
                g.rebalance_deadline = time.monotonic() + 3.0
                self._maybe_complete_join(g)
            else:
                g.state = "Empty"
        return {"throttle_time_ms": 0, "error_code": 0}

    def _h_OffsetCommit(self, conn, corrid, hdr, body, inject):
        g = self._group(body["group_id"])
        out = []
        with self._lock:
            # generation/membership validation (real broker
            # GroupCoordinator semantics): a group-member commit
            # (generation >= 0) must name a live member at the current
            # generation — a fenced/zombie member's commit is rejected
            # so its offsets can't clobber the new owner's.  Simple
            # consumers commit with generation -1 and skip the check.
            gen_err = Err.NO_ERROR
            if body.get("generation_id", -1) >= 0:
                if body.get("member_id") not in g.members:
                    gen_err = Err.UNKNOWN_MEMBER_ID
                elif body["generation_id"] != g.generation:
                    gen_err = Err.ILLEGAL_GENERATION
            for t in body["topics"]:
                tp = {"topic": t["topic"], "partitions": []}
                for p in t["partitions"]:
                    err = inject or gen_err or Err.NO_ERROR
                    if err == Err.NO_ERROR:
                        g.offsets[(t["topic"], p["partition"])] = (
                            p["offset"], p["metadata"])
                    tp["partitions"].append({"partition": p["partition"],
                                             "error_code": err.wire})
                out.append(tp)
        return {"topics": out}

    def _h_OffsetFetch(self, conn, corrid, hdr, body, inject):
        g = self._group(body["group_id"])
        out = []
        with self._lock:
            for t in body["topics"] or []:
                tp = {"topic": t["topic"], "partitions": []}
                for pid in t["partitions"]:
                    off, meta = g.offsets.get((t["topic"], pid), (-1, None))
                    tp["partitions"].append(
                        {"partition": pid, "offset": off, "metadata": meta,
                         "error_code": inject.wire if inject else 0})
                out.append(tp)
        return {"topics": out}

    # ----------------------------------------------------------- producer --
    #: broker-side transaction.max.timeout.ms (real default)
    MAX_TXN_TIMEOUT_MS = 900000

    def _h_InitProducerId(self, conn, corrid, hdr, body, inject):
        if inject:
            return {"throttle_time_ms": 0, "error_code": inject.wire,
                    "producer_id": -1, "producer_epoch": -1}
        tid = body.get("transactional_id")
        if not tid:
            # plain idempotent producer: fresh pid, epoch 0
            with self._lock:
                pid = self._next_pid
                self._next_pid += 1
            return {"throttle_time_ms": 0, "error_code": 0,
                    "producer_id": pid, "producer_epoch": 0}
        # transactional: the id is pinned to its coordinator, keeps its
        # pid across re-inits, and every re-init BUMPS THE EPOCH —
        # fencing any older instance (zombie) still holding the old one
        fail = {"throttle_time_ms": 0, "producer_id": -1,
                "producer_epoch": -1}
        tmo = body.get("transaction_timeout_ms", 60000)
        if tmo <= 0 or tmo > self.MAX_TXN_TIMEOUT_MS:
            return {**fail,
                    "error_code": Err.INVALID_TRANSACTION_TIMEOUT.wire}
        with self._lock:
            if conn.broker_id != self.coordinator_for(tid):
                return {**fail, "error_code": Err.NOT_COORDINATOR.wire}
            t = self.transactions.get(tid)
            if t is None:
                t = MockTransaction(tid=tid, pid=self._next_pid)
                self._next_pid += 1
                self.transactions[tid] = t
                self._pid_tid[t.pid] = tid
            elif t.state == "Ongoing":
                # previous instance died mid-transaction: abort it
                # before handing out the new epoch (real coordinator
                # behavior on InitProducerId with an ongoing txn)
                self._end_txn_locked(t, committed=False)
            t.epoch += 1
            t.state = "Empty"
            return {"throttle_time_ms": 0, "error_code": 0,
                    "producer_id": t.pid, "producer_epoch": t.epoch}

    def _txn_lookup_locked(self, conn, tid: str, pid: int, epoch: int,
                           *, check_coord: bool = True) -> Optional[Err]:
        """Validate a transactional request's identity; None = OK."""
        if check_coord and conn.broker_id != self.coordinator_for(tid):
            return Err.NOT_COORDINATOR
        t = self.transactions.get(tid)
        if t is None or t.pid != pid:
            return Err.INVALID_PRODUCER_ID_MAPPING
        if epoch < t.epoch:
            return Err.PRODUCER_FENCED     # zombie instance
        if epoch > t.epoch:
            return Err.INVALID_PRODUCER_EPOCH
        return None

    def _h_AddPartitionsToTxn(self, conn, corrid, hdr, body, inject):
        tid = body["transactional_id"]
        out = []
        with self._lock:
            base_err = inject or self._txn_lookup_locked(
                conn, tid, body["producer_id"], body["producer_epoch"])
            t = self.transactions.get(tid)
            for tr in body["topics"]:
                parts = []
                for p in tr["partitions"]:
                    err = base_err or Err.NO_ERROR
                    if err == Err.NO_ERROR:
                        if tr["topic"] not in self.topics or \
                                p >= len(self.topics[tr["topic"]]):
                            err = Err.UNKNOWN_TOPIC_OR_PART
                        else:
                            t.partitions.setdefault((tr["topic"], p), None)
                            t.state = "Ongoing"
                    parts.append({"partition": p, "error_code": err.wire})
                out.append({"topic": tr["topic"], "partitions": parts})
        return {"throttle_time_ms": 0, "results": out}

    def _h_AddOffsetsToTxn(self, conn, corrid, hdr, body, inject):
        with self._lock:
            err = inject or self._txn_lookup_locked(
                conn, body["transactional_id"], body["producer_id"],
                body["producer_epoch"])
            if err is None:
                t = self.transactions[body["transactional_id"]]
                t.groups.add(body["group_id"])
                t.state = "Ongoing"
        return {"throttle_time_ms": 0,
                "error_code": err.wire if err else 0}

    def _h_TxnOffsetCommit(self, conn, corrid, hdr, body, inject):
        # arrives at the GROUP coordinator (real protocol), so the
        # txn-coordinator pinning check is skipped; offsets stage in
        # the txn and only land in the group at EndTxn(commit)
        out = []
        with self._lock:
            err = inject or self._txn_lookup_locked(
                conn, body["transactional_id"], body["producer_id"],
                body["producer_epoch"], check_coord=False)
            t = self.transactions.get(body["transactional_id"])
            staged = (t.pending_offsets.setdefault(body["group_id"], {})
                      if err is None else None)
            for tr in body["topics"]:
                parts = []
                for p in tr["partitions"]:
                    if err is None:
                        staged[(tr["topic"], p["partition"])] = (
                            p["offset"], p["metadata"])
                    parts.append({"partition": p["partition"],
                                  "error_code": err.wire if err else 0})
                out.append({"topic": tr["topic"], "partitions": parts})
        return {"throttle_time_ms": 0, "topics": out}

    def _h_EndTxn(self, conn, corrid, hdr, body, inject):
        with self._lock:
            err = inject or self._txn_lookup_locked(
                conn, body["transactional_id"], body["producer_id"],
                body["producer_epoch"])
            if err is None:
                t = self.transactions[body["transactional_id"]]
                if t.state == ("CompleteCommit" if body["committed"]
                               else "CompleteAbort"):
                    # idempotent retry: the previous EndTxn landed but
                    # its response was lost (coordinator died mid-
                    # commit); the markers are already written, so the
                    # retry must succeed, not INVALID_TXN_STATE — or
                    # every coordinator-failover storm would go fatal
                    pass
                elif t.state != "Ongoing":
                    err = Err.INVALID_TXN_STATE
                else:
                    self._end_txn_locked(t, body["committed"])
        return {"throttle_time_ms": 0,
                "error_code": err.wire if err else 0}

    def _end_txn_locked(self, t: MockTransaction, committed: bool) -> None:
        """Write a COMMIT/ABORT control record into every partition the
        transaction touched, maintain the aborted-transaction index,
        release the LSO, and (on commit) land the staged group offsets
        (real coordinator: WriteTxnMarkers to the partition leaders)."""
        for (topic, pnum), first in t.partitions.items():
            parts = self.topics.get(topic)
            if parts is None or pnum >= len(parts):
                continue                    # topic deleted mid-txn
            part = parts[pnum]
            marker = self._control_batch(t.pid, t.epoch, committed)
            base = part.append(marker)
            part.open_txns.pop(t.pid, None)
            if not committed and first is not None:
                part.aborted.append({"producer_id": t.pid,
                                     "first_offset": first,
                                     "last_offset": base})
        if committed:
            for gid, offs in t.pending_offsets.items():
                self._group(gid).offsets.update(offs)
        t.partitions = {}
        t.pending_offsets = {}
        t.groups = set()
        t.state = "CompleteCommit" if committed else "CompleteAbort"

    @staticmethod
    def _control_batch(pid: int, epoch: int, committed: bool) -> bytes:
        """A v2 control RecordBatch exactly as a broker writes it: one
        record, key = [version i16, type i16], value = [version i16,
        coordinator_epoch i32], transactional+control attr bits set."""
        from ..protocol.msgset import MsgsetWriterV2, Record
        now_ms = int(time.time() * 1000)
        w = MsgsetWriterV2(producer_id=pid, producer_epoch=epoch,
                           base_sequence=-1, transactional=True,
                           control=True)
        key = struct.pack(">hh", 0, proto.CTRL_COMMIT if committed
                          else proto.CTRL_ABORT)
        rec = Record(key=key, value=struct.pack(">hi", 0, 0),
                     timestamp=now_ms)
        return w.write_batch([rec], now_ms)

    # --------------------------------------------------------------- admin --
    def _h_CreateTopics(self, conn, corrid, hdr, body, inject):
        out = []
        with self._lock:
            for t in body["topics"]:
                if inject:
                    err = inject
                elif t["topic"] in self.topics:
                    err = Err.TOPIC_ALREADY_EXISTS
                elif not _valid_topic_name(t["topic"]):
                    # broker-side name validation (real brokers reject
                    # bad names at creation, not just on metadata)
                    err = Err.TOPIC_EXCEPTION
                else:
                    self.create_topic(t["topic"], max(t["num_partitions"], 1))
                    err = Err.NO_ERROR
                out.append({"topic": t["topic"], "error_code": err.wire,
                            "error_message": None})
        return {"throttle_time_ms": 0, "topics": out}

    def _h_DeleteTopics(self, conn, corrid, hdr, body, inject):
        out = []
        with self._lock:
            for t in body["topics"]:
                if inject:
                    err = inject
                elif t in self.topics:
                    del self.topics[t]
                    err = Err.NO_ERROR
                else:
                    err = Err.UNKNOWN_TOPIC_OR_PART
                out.append({"topic": t, "error_code": err.wire})
        return {"throttle_time_ms": 0, "topics": out}

    def _h_CreatePartitions(self, conn, corrid, hdr, body, inject):
        out = []
        with self._lock:
            for t in body["topics"]:
                if inject:
                    err = inject
                elif t["topic"] not in self.topics:
                    err = Err.UNKNOWN_TOPIC_OR_PART
                elif t["count"] <= len(self.topics[t["topic"]]):
                    err = Err.INVALID_PARTITIONS
                else:
                    parts = self.topics[t["topic"]]
                    for i in range(len(parts), t["count"]):
                        parts.append(self._new_partition(t["topic"], i))
                    err = Err.NO_ERROR
                out.append({"topic": t["topic"], "error_code": err.wire,
                            "error_message": None})
        return {"throttle_time_ms": 0, "topics": out}

    _CONFIG_DEFAULTS = {"retention.ms": "604800000",
                        "cleanup.policy": "delete"}

    def _h_DescribeConfigs(self, conn, corrid, hdr, body, inject):
        out = []
        with self._lock:
            for r in body["resources"]:
                key = (r["resource_type"], r["resource_name"])
                merged = dict(self._CONFIG_DEFAULTS)
                merged.update(self._resource_configs.get(key, {}))
                entries = [{"name": n, "value": v, "read_only": False,
                            "source": 5, "sensitive": False,
                            "synonyms": []}
                           for n, v in sorted(merged.items())]
                out.append({"error_code": inject.wire if inject else 0,
                            "error_message": None,
                            "resource_type": r["resource_type"],
                            "resource_name": r["resource_name"],
                            "entries": entries})
        return {"throttle_time_ms": 0, "resources": out}

    def _h_AlterConfigs(self, conn, corrid, hdr, body, inject):
        # stateful like a real broker: altered entries are visible to a
        # following DescribeConfigs
        out = []
        with self._lock:
            for r in body["resources"]:
                key = (r["resource_type"], r["resource_name"])
                if not (inject and inject.wire):
                    store = self._resource_configs.setdefault(key, {})
                    for e in r.get("entries") or []:
                        store[e["name"]] = e["value"]
                out.append({"error_code": inject.wire if inject else 0,
                            "error_message": None,
                            "resource_type": r["resource_type"],
                            "resource_name": r["resource_name"]})
        return {"throttle_time_ms": 0, "resources": out}

    def _h_DescribeGroups(self, conn, corrid, hdr, body, inject):
        out = []
        with self._lock:
            for gid in body["groups"]:
                g = self.groups.get(gid)
                if g is None:
                    out.append({"error_code": 0, "group_id": gid,
                                "state": "Dead", "protocol_type": "",
                                "protocol": "", "members": []})
                    continue
                out.append({
                    "error_code": 0, "group_id": gid, "state": g.state,
                    "protocol_type": g.protocol_type, "protocol": g.protocol,
                    "members": [{"member_id": m.member_id,
                                 "client_id": m.client_id,
                                 "client_host": m.client_host,
                                 "metadata": m.metadata,
                                 "assignment": m.assignment}
                                for m in g.members.values()]})
        return {"groups": out}

    def _h_ListGroups(self, conn, corrid, hdr, body, inject):
        with self._lock:
            groups = [{"group_id": g.group_id,
                       "protocol_type": g.protocol_type}
                      for g in self.groups.values() if g.members]
        return {"error_code": inject.wire if inject else 0, "groups": groups}

    def _h_DeleteGroups(self, conn, corrid, hdr, body, inject):
        out = []
        with self._lock:
            for gid in body["groups"]:
                g = self.groups.get(gid)
                if g is None:
                    err = Err.GROUP_ID_NOT_FOUND
                elif g.members:
                    err = Err.NON_EMPTY_GROUP
                else:
                    del self.groups[gid]
                    err = Err.NO_ERROR
                out.append({"group_id": gid, "error_code": err.wire})
        return {"throttle_time_ms": 0, "results": out}

    def _h_SaslHandshake(self, conn, corrid, hdr, body, inject):
        mechs = ["PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512", "OAUTHBEARER"]
        err = 0
        if body["mechanism"] not in mechs:
            err = Err.UNSUPPORTED_SASL_MECHANISM.wire
        conn.sasl_mech = body["mechanism"]
        conn.scram = None
        return {"error_code": err, "mechanisms": mechs}

    @staticmethod
    def _sasl_fail(msg="authentication failed"):
        return {"error_code": Err.SASL_AUTHENTICATION_FAILED.wire,
                "error_message": msg, "auth_bytes": b""}

    def _h_SaslAuthenticate(self, conn, corrid, hdr, body, inject):
        data = body["auth_bytes"] or b""
        if inject:
            return self._sasl_fail()
        if conn.sasl_mech.startswith("SCRAM") or conn.scram is not None:
            return self._scram_auth(conn, data)
        if conn.sasl_mech == "OAUTHBEARER":
            # "n,a=...,\x01auth=Bearer <jws>\x01\x01" — accept any
            # well-formed unsecured JWS (the reference's builtin handler
            # produces exactly this shape)
            ok = data.startswith(b"n,") and b"\x01auth=Bearer " in data
            return ({"error_code": 0, "error_message": None,
                     "auth_bytes": b""} if ok else self._sasl_fail())
        # PLAIN: [authzid] \0 authcid \0 passwd
        parts = data.split(b"\x00")
        if len(parts) != 3 or not parts[1] or not parts[2]:
            return self._sasl_fail()
        if self.sasl_users is not None:
            user, pw = parts[1].decode(), parts[2].decode()
            if self.sasl_users.get(user) != pw:
                return self._sasl_fail()
        return {"error_code": 0, "error_message": None, "auth_bytes": b""}

    def _scram_auth(self, conn, data: bytes):
        """Server half of RFC 5802 (the peer of the client exchange in
        client/sasl.py ScramClient; reference server behavior is the real
        broker's — rdkafka_sasl_scram.c only implements the client)."""
        import base64
        import hashlib
        import hmac
        import os
        hashname = ("sha256" if conn.sasl_mech == "SCRAM-SHA-256"
                    else "sha512")
        if conn.scram is None:
            if self.sasl_users is None:
                return self._sasl_fail("SCRAM requires mock sasl_users")
            try:
                txt = data.decode()
                if not txt.startswith("n,,"):
                    return self._sasl_fail("bad GS2 header")
                bare = txt[3:]
                fields = dict(kv.split("=", 1) for kv in bare.split(","))
                user = fields["n"].replace("=2C", ",").replace("=3D", "=")
                cnonce = fields["r"]
            except (ValueError, KeyError, UnicodeDecodeError):
                return self._sasl_fail("malformed client-first")
            pw = self.sasl_users.get(user)
            if pw is None:
                return self._sasl_fail("unknown user")
            salt = os.urandom(16)
            iters = 4096
            snonce = base64.b64encode(os.urandom(18)).decode()
            server_first = (f"r={cnonce}{snonce},"
                            f"s={base64.b64encode(salt).decode()},i={iters}")
            salted = hashlib.pbkdf2_hmac(hashname, pw.encode(), salt, iters)
            conn.scram = (bare, server_first, salted)
            return {"error_code": 0, "error_message": None,
                    "auth_bytes": server_first.encode()}
        bare, server_first, salted = conn.scram
        conn.scram = None
        try:
            txt = data.decode()
            without_proof, _, proof_b64 = txt.rpartition(",p=")
            fields = dict(kv.split("=", 1) for kv in without_proof.split(","))
            proof = base64.b64decode(proof_b64)
        except (ValueError, UnicodeDecodeError):
            return self._sasl_fail("malformed client-final")
        expect_nonce = dict(kv.split("=", 1)
                            for kv in server_first.split(","))["r"]
        if fields.get("r") != expect_nonce:
            return self._sasl_fail("nonce mismatch")
        auth_msg = ",".join([bare, server_first, without_proof]).encode()
        client_key = hmac.new(salted, b"Client Key", hashname).digest()
        stored_key = hashlib.new(hashname, client_key).digest()
        sig = hmac.new(stored_key, auth_msg, hashname).digest()
        recovered = bytes(a ^ b for a, b in zip(proof, sig))
        if hashlib.new(hashname, recovered).digest() != stored_key:
            return self._sasl_fail("proof verification failed")
        server_key = hmac.new(salted, b"Server Key", hashname).digest()
        v = base64.b64encode(
            hmac.new(server_key, auth_msg, hashname).digest()).decode()
        return {"error_code": 0, "error_message": None,
                "auth_bytes": f"v={v}".encode()}
