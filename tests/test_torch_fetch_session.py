"""Mirrors of test_0133_fetch_session (KIP-227 incremental fetch sessions
and the interest-set metadata) on the port: the client's ``FetchSession``
epoch protocol, the consumer's session over its life (negotiation,
forgotten partitions, seek, both session errors, a cooperative
rebalance, the sessionless knob), the conf knobs, the mock broker's
session cache and the Metadata null-versus-empty topic list; and two
many-partition cases of the port alone (a large assign joins its
session; the producer serves only the partitions it produced to).

The unit, conf, mock and metadata cases compare the port's results with
the JAX package's on the same input.  The consumer cases fetch through
the codec, so the port's clients run ``compression.backend=gpu,
gpu.device=cpu``; each scenario runs on both packages at once
(``test_torch_txn.both``) and the port's result must equal the
reference's and the reference test's expectation.
"""
import time
from types import SimpleNamespace

import pytest

from librdkafka_tpu.client import fetch_session as ref_fs
from librdkafka_tpu_torch.client import fetch_session as port_fs

from test_torch_txn import PORT, REF, both

TOPIC = "fs"
FS = {True: port_fs, False: ref_fs}


# ===================================================== the FSM ==

def _fsm(mod, case):
    fs = mod.FetchSession()
    if case == "epoch0":
        wanted = {("t", 0): (0, 1 << 20), ("t", 1): (5, 1 << 20)}
        epoch, to_send, forgotten = fs.build(wanted)
        fs.on_success(77)
        return [epoch, sorted(to_send), forgotten, fs.session_id, fs.epoch,
                fs.book == wanted]
    if case == "incremental":
        fs.build({("t", 0): (0, 1), ("t", 1): (0, 1)})
        fs.on_success(9)
        out = [fs.build({("t", 0): (10, 1), ("t", 1): (0, 1)})]
        fs.on_success(9)
        out.append(fs.build({("t", 0): (10, 1)}))
        fs.on_success(9)
        return out + [fs.book]
    if case == "wrap":
        fs.build({("t", 0): (0, 1)})
        fs.on_success(3)
        fs.epoch = 0x7FFFFFFF
        fs.build({("t", 0): (0, 1)})
        fs.on_success(3)
        return [fs.epoch]
    fs.reset("disconnect")          # nothing negotiated: not a reset
    out = [fs.stats()["resets"]]
    fs.build({("t", 0): (0, 1)})
    fs.on_success(4)
    fs.reset("disconnect")
    return out + [fs.stats()["resets"], fs.session_id, fs.epoch, fs.book,
                  bool(fs.inflight), mod.SESSIONLESS_EPOCH, mod.INITIAL_EPOCH]


@pytest.mark.parametrize("case,want", [
    ("epoch0", [0, [("t", 0), ("t", 1)], [], 77, 1, True]),
    ("incremental", [(1, [("t", 0)], []), (2, [], [("t", 1)]),
                     {("t", 0): (10, 1)}]),
    ("wrap", [1]),                  # past int32 to 1, never 0 or -1
    ("reset", [0, 1, 0, 0, {}, False, -1, 0])])
def test_fetch_session_fsm_equals_reference(case, want):
    port = _fsm(port_fs, case)
    assert port == _fsm(ref_fs, case) == want


# ============================================= the consumer's session ==

def _cluster(pkg):
    return pkg.MockCluster(num_brokers=1, topics={TOPIC: 2})


def _produce(pkg, cluster, n, start=0, parts=2):
    p = pkg.Producer(pkg.conf({
        "bootstrap.servers": cluster.bootstrap_servers(), "linger.ms": 2}))
    for i in range(start, start + n):
        p.produce(TOPIC, value=b"m%04d" % i, partition=i % parts)
    assert p.flush(10.0) == 0
    p.close()


def _consume(c, n, timeout=15.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        m = c.poll(0.2)
        if m is not None and m.error is None:
            got.append(m)
    return got


def _sessions(c):
    with c._rk._brokers_lock:
        return [b._fetch_session for b in c._rk.brokers.values()]


def _consumer(pkg, cluster, group, **extra):
    c = pkg.Consumer(pkg.conf({
        "bootstrap.servers": cluster.bootstrap_servers(), "group.id": group,
        "auto.offset.reset": "earliest", **extra}))
    c.assign([pkg.TopicPartition(TOPIC, 0), pkg.TopicPartition(TOPIC, 1)])
    return c


def test_session_negotiated_and_epoch_increments():
    """Consuming negotiates a session, epochs increment per fetch, the
    mock caches the partition book and steady state is incremental."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            _produce(pkg, cluster, 20)
            c = _consumer(pkg, cluster, "fs-g")
            n = len(_consume(c, 20))
            for _ in range(5):
                c.poll(0.1)
            fs = next(f for f in _sessions(c) if f.session_id > 0)
            st = fs.stats()
            with cluster._lock:
                book = set(cluster._fetch_sessions[fs.session_id]["book"])
            out = [n, fs.epoch >= 2, st["full_fetches"],
                   st["partitions_total"],
                   fs.session_id in cluster.fetch_session_ids(),
                   sorted(book), st["partitions_sent"] < fs.epoch * 2]
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [20, True, 1, 2, True, [(TOPIC, 0), (TOPIC, 1)],
                           True]


def test_forgotten_partitions_on_incremental_unassign():
    """An unassigned partition rides forgotten_topics: the mock's book
    shrinks while the kept partition delivers on the same session."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            _produce(pkg, cluster, 10)
            c = _consumer(pkg, cluster, "fs-g2")
            n = len(_consume(c, 10))
            fs = next(f for f in _sessions(c) if f.session_id > 0)
            sid = fs.session_id
            c.incremental_unassign([pkg.TopicPartition(TOPIC, 1)])
            _produce(pkg, cluster, 5, start=100, parts=1)
            got = [m.value for m in _consume(c, 5)]
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                with cluster._lock:
                    book = set(cluster._fetch_sessions.get(sid, {})
                               .get("book", {}))
                if book == {(TOPIC, 0)}:
                    break
                c.poll(0.1)
            out = [n, got, sorted(book), fs.session_id == sid,
                   fs.stats()["resets"]]
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [10, [b"m%04d" % i for i in range(100, 105)],
                           [(TOPIC, 0)], True, 0]


def test_seek_relists_partition_in_session():
    """seek() re-lists the partition in the session (no reset) and the
    data comes again from the seek point."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            _produce(pkg, cluster, 8)
            c = _consumer(pkg, cluster, "fs-g3")
            n = len(_consume(c, 8))
            fs = next(f for f in _sessions(c) if f.session_id > 0)
            sent = fs.stats()["partitions_sent"]
            c.seek(pkg.TopicPartition(TOPIC, 0, 0))
            again = sorted(m.offset for m in _consume(c, 4))
            out = [n, again, fs.stats()["partitions_sent"] > sent,
                   fs.stats()["resets"]]
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [8, [0, 1, 2, 3], True, 0]


@pytest.mark.parametrize("corrupt", ["evict", "epoch"])
def test_session_error_falls_back_and_renegotiates(corrupt):
    """FETCH_SESSION_ID_NOT_FOUND and INVALID_FETCH_SESSION_EPOCH both
    reset the session, full-fetch from epoch 0 and keep delivering."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            _produce(pkg, cluster, 6)
            c = _consumer(pkg, cluster, f"fs-e-{corrupt}")
            n = len(_consume(c, 6))
            fs = next(f for f in _sessions(c) if f.session_id > 0)
            old = fs.session_id
            if corrupt == "evict":
                evicted = cluster.evict_fetch_sessions() >= 1
            else:
                with cluster._lock:
                    cluster._fetch_sessions[old]["epoch"] += 7
                evicted = True
            _produce(pkg, cluster, 6, start=50)
            got = len(_consume(c, 6))
            st = fs.stats()
            out = [n, evicted, got, st["resets"] >= 1,
                   st["full_fetches"] >= 2, fs.session_id > 0,
                   corrupt != "evict" or fs.session_id != old]
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [6, True, 6, True, True, True, True]


def test_session_survives_cooperative_rebalance():
    """An incremental cooperative rebalance moves a partition off the
    incumbent without resetting its session."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            _produce(pkg, cluster, 16)
            conf = pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "fs-coop", "auto.offset.reset": "earliest",
                "partition.assignment.strategy": "cooperative-sticky",
                "heartbeat.interval.ms": 300, "session.timeout.ms": 6000})
            c1 = pkg.Consumer(dict(conf, **{"client.id": "c1"}))
            c1.subscribe([TOPIC])
            n = len(_consume(c1, 16))
            fs = next(f for f in _sessions(c1) if f.session_id > 0)
            sid = fs.session_id
            c2 = pkg.Consumer(dict(conf, **{"client.id": "c2"}))
            c2.subscribe([TOPIC])
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                c1.poll(0.1)
                c2.poll(0.1)
                if len(c1.assignment()) == 1 and len(c2.assignment()) == 1:
                    break
            out = [n, len(c1.assignment()), len(c2.assignment()),
                   fs.session_id == sid, fs.stats()["resets"]]
            _produce(pkg, cluster, 10, start=200)
            out.append(bool(_consume(c1, 1, timeout=10)
                            + _consume(c2, 1, timeout=10)))
            c1.close()
            c2.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [16, 1, 1, True, 0, True]


def test_sessionless_when_disabled():
    """fetch.session.enable=false: epoch -1 fetches, no session on either
    side, delivery unaffected."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            _produce(pkg, cluster, 10)
            c = _consumer(pkg, cluster, "fs-off",
                          **{"fetch.session.enable": False})
            n = len(_consume(c, 10))
            stats = [fs.stats() for fs in _sessions(c)]
            out = [n, all(s["session_id"] == 0 and s["epoch"] == 0
                          and s["full_fetches"] == 0
                          and s["partitions_total"] == 0 for s in stats),
                   cluster.fetch_session_ids()]
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [10, True, []]



def test_every_partition_of_a_large_assign_joins_the_session():
    """A partition that turns fetchable while a session request is out
    rides an immediate-return overflow fetch queued behind it; the mock
    answers one connection's requests in order, so the session response
    lands first.  The next session build waits for the overflow fetch,
    so every partition folds into the book.  (Both packages built it at
    once and left the overflow's partitions out of the book every epoch:
    a 10,000-partition assign kept thousands out for good.  Repaired in
    the port; the JAX package keeps it.)"""
    n, with_data = 10_000, 256
    cluster = PORT.MockCluster(num_brokers=1, topics={TOPIC: n})
    try:
        # the CPU provider: the codec route is not what this case holds
        p = PORT.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                           "linger.ms": 2})
        for i in range(4 * with_data):
            p.produce(TOPIC, value=b"m%04d" % i, partition=i % with_data)
        assert p.flush(30.0) == 0
        p.close()
        c = PORT.Consumer({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "group.id": "fs-large", "auto.offset.reset": "earliest"})
        try:
            c.assign([PORT.TopicPartition(TOPIC, i) for i in range(n)])
            assert len(_consume(c, 4 * with_data, 60.0)) == 4 * with_data
            deadline = time.monotonic() + 30
            booked = 0
            while booked < n and time.monotonic() < deadline:
                c.poll(0.1)
                booked = sum(len(fs.book) for fs in _sessions(c))
            assert booked == n, f"{booked} of {n} partitions in the book"
        finally:
            c.close()
    finally:
        cluster.stop()



def test_producer_serve_touches_only_produced_partitions(monkeypatch):
    """The producer's serve pass walks the partitions with work (the
    client's active index), not every partition metadata registered:
    producing to 8 partitions of a 10,000-partition topic moves no queue
    of the other 9,992.  (Both packages walked all of them each pass,
    which held a 100,000-partition producer to hundreds of msgs/s on the
    card; repaired in the port.)"""
    from librdkafka_tpu_torch.client.partition import Toppar
    moved: dict = {}
    xmit_move = Toppar.xmit_move

    def counting(tp):
        moved[tp.partition] = moved.get(tp.partition, 0) + 1
        return xmit_move(tp)
    monkeypatch.setattr(Toppar, "xmit_move", counting)
    cluster = PORT.MockCluster(num_brokers=1, topics={TOPIC: 10_000})
    try:
        p = PORT.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                           "linger.ms": 2})
        try:
            for i in range(2_000):
                p.produce(TOPIC, value=b"m%04d" % i, partition=i % 8)
            assert p.flush(30.0) == 0
        finally:
            p.close()
        assert set(moved) <= set(range(8)), f"{len(moved)} queues moved"
        assert sum(cluster.partition(TOPIC, i).end_offset
                   for i in range(8)) == 2_000
    finally:
        cluster.stop()


# ================================================== the conf knobs ==

@pytest.mark.parametrize("knob", ["fetch.session.enable",
                                  "topic.metadata.interest.only"])
def test_conf_knob_default_and_validation(knob):
    def scenario(pkg):
        conf = pkg.Conf()
        out = [conf.get(knob)]
        conf.set(knob, "false")
        out.append(conf.get(knob))
        conf.set(knob, True)
        out.append(conf.get(knob))
        with pytest.raises(pkg.KafkaException) as ei:
            conf.set(knob, "not-a-bool")
        return out + [ei.value.error.code.name]
    port, ref = scenario(PORT), scenario(REF)
    assert port == ref == [True, False, True, "_INVALID_ARG"]


# ======================================= the mock's session cache ==

def _fetch(cluster, body):
    conn = SimpleNamespace(broker_id=1, closed=False)
    return cluster._h_Fetch(conn, 1, {"api_version": 11}, dict(body), None)


def _body(epoch, sid=0, topics=(), forgotten=()):
    return {"replica_id": -1, "max_wait_time": 0, "min_bytes": 1,
            "max_bytes": 1 << 20, "isolation_level": 0, "session_id": sid,
            "session_epoch": epoch,
            "topics": [{"topic": t, "partitions": [
                {"partition": p, "fetch_offset": o, "max_bytes": 1 << 20}]}
                for t, p, o in topics],
            "forgotten_topics": [{"topic": t, "partitions": ps}
                                 for t, ps in forgotten]}


def _cache(pkg, case):
    cluster = _cluster(pkg)
    try:
        if case == "unknown_session":
            r = _fetch(cluster, _body(5, sid=424242))
            return [r["error_code"], r["topics"], r["session_id"]]
        _produce(pkg, cluster, 4 if case == "incremental" else 2, parts=1)
        if case == "epoch_mismatch":
            sid = _fetch(cluster, _body(0, topics=[(TOPIC, 0, 0)]))[
                "session_id"]
            return [sid > 0,
                    _fetch(cluster, _body(3, sid=sid))["error_code"]]
        if case == "lru":
            cluster.fetch_session_slots = 4
            for _ in range(7):
                _fetch(cluster, _body(0, topics=[(TOPIC, 0, 0)]))
            return sorted(cluster.fetch_session_ids())
        if case == "incremental":
            r = _fetch(cluster, _body(0, topics=[(TOPIC, 0, 0),
                                                 (TOPIC, 1, 0)]))
            sid = r["session_id"]
            full = sum(len(t["partitions"]) for t in r["topics"])
            _produce(pkg, cluster, 2, start=10, parts=1)
            r = _fetch(cluster, _body(1, sid=sid, topics=[(TOPIC, 0, 4)]))
            return [full, r["error_code"], r["session_id"] == sid,
                    [(t["topic"], p["partition"]) for t in r["topics"]
                     for p in t["partitions"]]]
        sid = _fetch(cluster, _body(0, topics=[(TOPIC, 0, 0)]))["session_id"]
        out = [sid in cluster.fetch_session_ids()]
        cluster.set_broker_down(1, True)
        out.append(cluster.fetch_session_ids())
        cluster.set_broker_down(1, False)
        return out + [_fetch(cluster, _body(1, sid=sid))["error_code"]]
    finally:
        cluster.stop()


@pytest.mark.parametrize("case", ["unknown_session", "epoch_mismatch", "lru",
                                  "incremental", "dies_with_broker"])
def test_mock_session_cache_equals_reference(case):
    port, ref = both(_cache, case)
    assert port == ref
    E = PORT.Err
    assert port == {
        "unknown_session": [E.FETCH_SESSION_ID_NOT_FOUND.wire, [], 0],
        "epoch_mismatch": [True, E.INVALID_FETCH_SESSION_EPOCH.wire],
        # the oldest sessions were evicted
        "lru": [4, 5, 6, 7],
        # the full response lists both partitions, the incremental one
        # only the partition with new data
        "incremental": [2, 0, True, [(TOPIC, 0)]],
        "dies_with_broker": [True, [], E.FETCH_SESSION_ID_NOT_FOUND.wire],
    }[case]


# ============================== metadata: null versus empty list ==

def _metadata(pkg, names):
    cluster = _cluster(pkg)
    try:
        cluster.create_topic("other", partitions=1)
        conn = SimpleNamespace(broker_id=1, closed=False)
        r = cluster._h_Metadata(conn, 1, {"api_version": 4},
                                {"topics": names}, None)
        return [sorted(t["topic"] for t in r["topics"]), bool(r["brokers"])]
    finally:
        cluster.stop()


@pytest.mark.parametrize("names,want", [
    (None, [[TOPIC, "other"], True]),       # null: every topic
    ([], [[], True]),                       # empty: no topic, brokers kept
    ([TOPIC], [[TOPIC], True])])            # named: just those
def test_metadata_topic_list_equals_reference(names, want):
    assert _metadata(PORT, names) == _metadata(REF, names) == want
