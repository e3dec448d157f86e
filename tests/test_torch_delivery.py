"""Mirrors of the producer's delivery path on the port: test_0123_fastlane_dr
(delivery reports off the fast lane), test_0134_fastlane_wide (the cases
test_torch_fastlane.py does not hold: murmur2 parity and routing, DRs with
timestamps and headers, the demotion drain, expiry DRs, the widened
consume round trip), test_0107_flush_dr (flush waits for DR ops; the
consumer's staleness barrier), test_0121_produce_batch (per-message
errors) and test_0125_deferred_release (deferred fetch claims and close()
under a wedged broker thread, on ``Broker`` shells of each package's own
``client/broker.py``), plus close() racing a metadata reply, where the
port departs from the reference on purpose (a repaired thread leak).

The port's clients run ``compression.backend=gpu, gpu.device=cpu``
(``test_torch_txn.GPU``: the kernels' plain versions, every CRC job on the
device route) and the JAX package's the reference case's own conf.  Each
scenario runs on both packages on the same input, concurrently
(``both``); the port's result must equal the reference's and the
reference test's expectation.
"""
import importlib
import itertools
import threading
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_txn import PORT, REF, both

NOW_MS = 1722900000123


def mod(pkg, name: str):
    """``pkg``'s module ``name`` (e.g. ``"client.msg"``)."""
    root = "librdkafka_tpu_torch" if pkg.port else "librdkafka_tpu"
    return importlib.import_module(f"{root}.{name}")


def _producer(pkg, cluster=None, **conf):
    base = {"bootstrap.servers": (cluster.bootstrap_servers()
                                  if cluster is not None else "127.0.0.1:1"),
            "linger.ms": 5}
    return pkg.Producer(pkg.conf({**base, **conf}))


def _seed_toppar(p, topic: str) -> None:
    """Route records into an arena without metadata: seed the toppar as
    the first-sight path would (the broker is unreachable)."""
    t = p.rk.get_topic(topic)
    t.partition_cnt = 1
    p.rk.get_toppar(topic, 0)


def _poll_until(p, cond, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        p.poll(0.1)


def _metadata_seen(client, timeout: float = 10.0) -> None:
    """Wait until the client's first metadata reply named a broker.  A
    client closed before that races the reply: the JAX package then
    starts a broker thread that nothing stops (ROADMAP queue 3;
    ``test_close_then_metadata_reply_starts_no_broker``)."""
    deadline = time.monotonic() + timeout
    while not any(nid >= 0 for nid in list(client._rk.brokers)):
        assert time.monotonic() < deadline, "no metadata reply"
        time.sleep(0.01)


def _wait_partitions(p, topic: str) -> None:
    p.rk.get_topic(topic)
    deadline = time.monotonic() + 5
    while (p.rk.topics[topic].partition_cnt <= 0
           and time.monotonic() < deadline):
        p.poll(0.05)


# ------------------------------------------------------- test_0123 ------

def test_dr_cb_does_not_demote_fast_lane():
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"fl": 2})
        drs = []
        p = _producer(pkg, cluster,
                      dr_msg_cb=lambda e, m: drs.append((e, m)))
        try:
            for i in range(50):
                p.produce("fl", value=b"v%03d" % i, key=b"k%03d" % i,
                          partition=i % 2)
            assert p.flush(20.0) == 0
            by_part = {0: [], 1: []}
            for e, m in drs:
                assert e is None and m.topic == "fl"
                by_part[m.partition].append(m.offset)
            return [[p.rk._toppars[("fl", q)].arena_ok for q in (0, 1)],
                    {q: sorted(o) for q, o in by_part.items()},
                    sorted((m.key, m.value) for _e, m in drs)]
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [
        [True, True], {0: list(range(25)), 1: list(range(25))},
        sorted((b"k%03d" % i, b"v%03d" % i) for i in range(50))]


@pytest.mark.parametrize("how", ["timeout", "purge"])
def test_error_drs_carry_payloads(how):
    """Unsendable fast-lane records expire (message.timeout.ms) or are
    purged into error DRs WITH their original payloads."""
    n = 20 if how == "timeout" else 10

    def scenario(pkg):
        drs = []
        extra = {"message.timeout.ms": 700,
                 "topic.metadata.refresh.interval.ms": 100} \
            if how == "timeout" else {}
        p = _producer(pkg, dr_msg_cb=lambda e, m: drs.append((e, m)),
                      **extra)
        try:
            _seed_toppar(p, "tt")
            for i in range(n):
                p.produce("tt", value=b"x%02d" % i, partition=0)
            arena = len(p.rk._toppars[("tt", 0)].arena)
            if how == "purge":
                p.purge(in_queue=True)
            _poll_until(p, lambda: len(drs) >= n, 10)
            return [arena, sorted(m.value for _e, m in drs),
                    {(e.code.name, m.topic, m.partition) for e, m in drs},
                    len(p)]
        finally:
            p.rk.conf.set("message.timeout.ms", 300000)
            p.close()
    port, ref = both(scenario)
    code = "_MSG_TIMED_OUT" if how == "timeout" else "_PURGE_QUEUE"
    assert port == ref == [n, [b"x%02d" % i for i in range(n)],
                           {(code, "tt", 0)}, 0]


def test_interceptors_still_demote():
    """on_send must fire per message at produce() time: interceptors keep
    the Message path."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"ic": 1})
        chain = mod(pkg, "client.interceptor").InterceptorChain()
        sent = []
        chain.add("t", "on_send", lambda m: sent.append(m))
        try:
            p = _producer(pkg, cluster)
            try:
                out = [p.rk._fast_lane]
                _metadata_seen(p)
            finally:
                p.close()
            p = _producer(pkg, cluster, interceptors=chain)
            try:
                out.append(p.rk._fast_lane)
                p.produce("ic", value=b"v", partition=0)
                out += [p.flush(15.0), len(sent)]
            finally:
                p.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True, False, 0, 1]


def test_dr_batch_cb_one_call_per_batch_lazy_payloads():
    """dr_batch_cb: ONE callback per delivered batch with the full,
    lazily materialized Message list, contiguous offsets, PERSISTED."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"bdr": 1})
        batches = []
        p = _producer(pkg, cluster, dr_batch_cb=batches.append,
                      **{"linger.ms": 20})
        try:
            for i in range(40):
                p.produce("bdr", value=b"v%03d" % i, key=b"k%03d" % i,
                          partition=0)
            assert p.flush(20.0) == 0
            return [len(batches) < 40,
                    [(m.error, m.status.name, m.topic, m.partition, m.value,
                      m.key, m.offset) for b in batches for m in b]]
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True, [
        (None, "PERSISTED", "bdr", 0, b"v%03d" % i, b"k%03d" % i, i)
        for i in range(40)]]


def test_dr_batch_cb_error_batches():
    """Failed deliveries reach dr_batch_cb with the error on every
    message, the payloads intact and no assigned offset."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"bde": 1})
        batches = []
        p = _producer(pkg, cluster, dr_batch_cb=batches.append,
                      **{"message.timeout.ms": 400})
        try:
            cluster.set_broker_down(1)
            for i in range(5):
                p.produce("bde", value=b"x%d" % i, partition=0)
            _poll_until(p, lambda: sum(map(len, batches)) >= 5, 10)
            return [(m.error.code.name, m.value, m.offset < 0)
                    for b in batches for m in b]
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [("_MSG_TIMED_OUT", b"x%d" % i, True)
                           for i in range(5)]


def test_dr_batch_cb_composes_with_dr_msg_cb():
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"bdc": 1})
        n = {"batch": 0, "msg": 0}

        def on_batch(msgs):
            n["batch"] += len(msgs)

        def on_msg(_e, _m):
            n["msg"] += 1
        p = _producer(pkg, cluster, dr_batch_cb=on_batch, dr_msg_cb=on_msg)
        try:
            for i in range(30):
                p.produce("bdc", value=b"c%d" % i, partition=0)
            assert p.flush(20.0) == 0
            return n
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == {"batch": 30, "msg": 30}


# ------------------------------------------------------- test_0134 ------

KEY_SWEEP = [
    b"", b"\x00", b"\x00\x00\x00\x00", b"key", b"kafka-key", b"a" * 3,
    bytes(range(256)), b"\x7f\x80\xff\x01", b"\x80" * 7, b"\xff" * 9,
    b"k" * 1000, b"\xfe\xdc\xba" * 333, "héllo-wörld".encode(),
    "キー".encode(),
]
CNT_SWEEP = [1, 2, 3, 7, 16, 100, 12345]


def _murmur_keys(case: str) -> list:
    if case == "none_key":
        return [(b"", cnt) for cnt in CNT_SWEEP]
    rng = np.random.default_rng(16)
    fuzz = [rng.integers(0, 256, int(rng.integers(0, 64)),
                         dtype=np.uint8).tobytes() for _ in range(300)]
    return (list(itertools.product(KEY_SWEEP, CNT_SWEEP))
            + [(k, c) for k in fuzz for c in (3, 12, 31)])


@pytest.mark.parametrize("case", ["sweep", "none_key"])
def test_murmur2_native_parity(case):
    """The native lane's murmur2 (each package's own extension) is
    bit-exact with the Python partitioner; a None/empty key hashes as
    b''."""
    keys = _murmur_keys(case)

    def scenario(pkg):
        m = mod(pkg, "client.arena")._mod()
        py = mod(pkg, "utils.hash").murmur2_partition
        return [(m.murmur2_partition(k, c), py(k, c)) for k, c in keys]
    port, ref = both(scenario)
    assert port == ref
    assert all(a == b for a, b in port)


@pytest.mark.parametrize("partitioner", ["murmur2", "murmur2_random"])
def test_auto_partition_routing(partitioner):
    """PARTITION_UA: keyed records land where the Python murmur2
    partitioner puts them.  With murmur2 the lane stays engaged (no
    demotion); with murmur2_random the unkeyed records take the Python
    random partitioner and demote only their toppars."""
    cnt = 5 if partitioner == "murmur2" else 4
    if partitioner == "murmur2":
        sends = [(b"k-%03d" % i, b"v") for i in range(120)] + \
            [(b"", b"v"), (None, b"v")]
    else:
        sends = [(None, b"u%03d" % i) if i % 5 == 0
                 else (b"k%03d" % i, b"v%03d" % i) for i in range(200)]

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"ap": cnt})
        drs = []
        p = _producer(pkg, cluster,
                      dr_msg_cb=lambda e, mm: drs.append((e, mm)))
        p.set_topic_conf("ap", {"partitioner": partitioner})
        py = mod(pkg, "utils.hash").murmur2_partition
        try:
            _wait_partitions(p, "ap")
            for k, v in sends:
                p.produce("ap", value=v, key=k)
            assert p.flush(20.0) == 0
            keyed = sorted((mm.key is None, mm.key or b"", mm.partition,
                            py(mm.key or b"", cnt))
                           for e, mm in drs if e is None and (
                               mm.key is not None
                               or partitioner == "murmur2"))
            ctrs = p.rk._lane.counters()
            return [len(drs), all(e is None for e, _ in drs),
                    all(a == b for _n, _k, a, b in keyed), keyed,
                    set(p.rk._demote_reasons),
                    ctrs["engaged"] >= len(sends) - 6
                    if partitioner == "murmur2"
                    else ctrs["fallback"]["auto_partition"] >= 40]
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port[:3] == ref[:3] == [len(sends), True, True]
    assert port[3] == ref[3]
    demoted = set() if partitioner == "murmur2" else {"partitioner"}
    assert port[4] <= demoted and ref[4] <= demoted
    assert port[5] and ref[5]


def test_dr_carries_timestamps_and_headers():
    hdrs = [("trace", b"abc"), ("nil", None)]

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"drw": 1})
        drs = []
        p = _producer(pkg, cluster,
                      dr_msg_cb=lambda e, mm: drs.append((e, mm)))
        try:
            for i in range(30):
                p.produce("drw", value=b"v%02d" % i, partition=0,
                          timestamp=NOW_MS + i, headers=hdrs)
            assert p.flush(20.0) == 0
            return [p.rk._toppars[("drw", 0)].arena_ok,
                    [(e, mm.value, mm.timestamp, list(mm.headers))
                     for e, mm in sorted(drs, key=lambda x: x[1].offset)]]
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True, [(None, b"v%02d" % i, NOW_MS + i, hdrs)
                                  for i in range(30)]]


def test_demotion_drain_preserves_ts_and_headers():
    """An arena holding widened records demotes into Messages with
    timestamps and headers intact, FIFO."""
    hdrs = [("h", b"x")]

    def scenario(pkg):
        p = _producer(pkg)
        try:
            _seed_toppar(p, "dm")
            for i in range(10):
                p.produce("dm", value=b"w%d" % i, partition=0,
                          timestamp=NOW_MS + i, headers=hdrs)
            tp = p.rk._toppars[("dm", 0)]
            out = [len(tp.arena)]
            p.rk._demote(tp, "ineligible")
            return out + [tp.arena_ok,
                          [(mm.value, mm.timestamp, list(mm.headers))
                           for mm in tp.msgq],
                          p.rk._demote_reasons.get("ineligible")]
        finally:
            p.rk.purge(in_queue=True)
            p.close()
    port, ref = both(scenario)
    assert port == ref == [10, False, [(b"w%d" % i, NOW_MS + i, hdrs)
                                       for i in range(10)], 1]


def test_expiry_drs_carry_ts_and_headers():
    hdrs = [("why", b"expired")]

    def scenario(pkg):
        drs = []
        p = _producer(pkg, dr_msg_cb=lambda e, mm: drs.append((e, mm)),
                      **{"message.timeout.ms": 600})
        try:
            _seed_toppar(p, "ex")
            for i in range(5):
                p.produce("ex", value=b"e%d" % i, partition=0,
                          timestamp=NOW_MS + i, headers=hdrs)
            _poll_until(p, lambda: len(drs) >= 5, 10)
            return [(e is not None, mm.value, mm.timestamp,
                     list(mm.headers)) for e, mm in drs]
        finally:
            p.rk.conf.set("message.timeout.ms", 300000)
            p.close()
    port, ref = both(scenario)
    assert port == ref == [(True, b"e%d" % i, NOW_MS + i, hdrs)
                           for i in range(5)]


def test_consume_round_trip_widened():
    """Headers + explicit timestamps + murmur2 auto-partition on the fast
    lane, then consume: the application sees exactly what was sent."""
    sent = {}
    for i in range(90):
        sent[b"rk%03d" % i] = (b"rv%03d" % i, NOW_MS + i if i % 3 else 0,
                               [("seq", b"%d" % i)] if i % 2 else [])

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"rt": 3})
        p = _producer(pkg, cluster)
        p.set_topic_conf("rt", {"partitioner": "murmur2"})
        py = mod(pkg, "utils.hash").murmur2_partition
        try:
            _wait_partitions(p, "rt")
            for key, (val, ts, hdrs) in sent.items():
                p.produce("rt", value=val, key=key, timestamp=ts,
                          headers=hdrs)
            assert p.flush(20.0) == 0
            demoted = dict(p.rk._demote_reasons)
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "rtg", "auto.offset.reset": "earliest"}))
            c.subscribe(["rt"])
            got = {}
            deadline = time.monotonic() + 20
            while len(got) < 90 and time.monotonic() < deadline:
                mm = c.poll(0.2)
                if mm and not mm.error:
                    got[mm.key] = (mm.value,
                                   mm.timestamp if sent[mm.key][1] else 0,
                                   list(mm.headers),
                                   mm.partition == py(mm.key, 3))
            c.close()
            return [demoted, got]
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [{}, {k: (*v, True) for k, v in sent.items()}]


# ------------------------------------------------------- test_0107 ------

def test_flush_waits_for_dr_delivery():
    """Every DR callback has fired by the time flush() returns 0."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"fdr": 1})
        delivered = []
        p = _producer(pkg, cluster, dr_msg_cb=lambda e, m: delivered.append(m),
                      **{"linger.ms": 0})
        try:
            out = []
            for r in range(20):
                for i in range(5):
                    p.produce("fdr", value=b"x%d.%d" % (r, i), partition=0)
                out.append((p.flush(10.0), len(delivered)))
            return out
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [(0, 5 * (r + 1)) for r in range(20)]


@pytest.mark.parametrize("how", ["version", "seek", "pause"])
def test_deliver_stale_simple_consumer(how):
    """A batch stamped before the partition's version moved is dropped on
    a simple (group-less) consumer, though the partition is still
    assigned, and the drop does not move the application offset.
    ``version`` stamps the batch one version back (the reference case);
    ``seek`` moves the version through seek(); ``pause`` calls pause(),
    which moves no version in either package: a batch fetched before the
    pause is still delivered (librdkafka's pause is a version barrier;
    ROADMAP queue 3, shared with the reference)."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"st": 1})
        Message = mod(pkg, "client.msg").Message
        c = pkg.Consumer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers()}))
        try:
            out = [c._rk.cgrp is None]
            _metadata_seen(c)
            c.assign([pkg.TopicPartition("st", 0)])
            tp = c._assignment[("st", 0)]
            fresh = Message("st", value=b"v", partition=0)
            fresh.offset = 7
            c._pending.append((tp, [fresh], tp.version, fresh.size))
            out.append(c._next_pending() is fresh)
            stale = Message("st", value=b"v", partition=0)
            stale.offset = 8
            ver = tp.version
            if how == "version":
                ver -= 1
            elif how == "seek":
                c.seek(pkg.TopicPartition("st", 0, 8))
            else:
                c.pause([pkg.TopicPartition("st", 0)])
            c._pending.append((tp, [stale], ver, stale.size))
            got = c._next_pending()
            return out + [None if got is None else got.offset, tp.app_offset]
        finally:
            c.close()
            cluster.stop()
    port, ref = both(scenario)
    want = [True, True, 8, 9] if how == "pause" else [True, True, None, 8]
    assert port == ref == want


def test_deliver_revoked_partition_dropped():
    """A batch of a revoked partition is dropped, with and without a
    consumer group."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"rv": 1})
        Message = mod(pkg, "client.msg").Message
        out = []
        try:
            for extra in ({}, {"group.id": "grv"}):
                c = pkg.Consumer(pkg.conf({
                    "bootstrap.servers": cluster.bootstrap_servers(),
                    **extra}))
                try:
                    _metadata_seen(c)
                    c.assign([pkg.TopicPartition("rv", 0)])
                    tp = c._assignment[("rv", 0)]
                    ver = tp.version
                    m = Message("rv", value=b"v", partition=0)
                    m.offset = 0
                    c._pending.append((tp, [m], ver, m.size))
                    out.append(c._next_pending() is m)
                    c.unassign()
                    late = Message("rv", value=b"v", partition=0)
                    late.offset = 1
                    c._pending.append((tp, [late], ver, late.size))
                    out.append(c._next_pending())
                finally:
                    c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True, None, True, None]


def test_flush_with_event_api_accounts_drs():
    """With DR events and no DR callback, flush() does not consume the
    events itself; once queue_poll drains them it returns 0."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"fev": 1})
        p = _producer(pkg, cluster, enabled_events="dr", **{"linger.ms": 0})
        rk = p._rk
        try:
            for i in range(3):
                p.produce("fev", value=b"e%d" % i, partition=0)
            out = [p.flush(0.5) > 0]
            got = 0
            deadline = time.monotonic() + 10
            while got < 3 and time.monotonic() < deadline:
                ev = rk.queue_poll(0.1)
                if ev is not None and ev.type == "DR":
                    got += len(ev.messages())
            with rk._msg_cnt_lock:
                out += [got, rk.dr_cnt, rk.msg_cnt]
            return out + [p.flush(5.0)]
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True, 3, 0, 0, 0]


def test_overlapping_assign_starts_all_partitions():
    """A second assign() overlapping a pending committed-offset lookup
    still starts every partition's fetcher."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"ov": 2})
        try:
            p = _producer(pkg, cluster, **{"linger.ms": 2})
            for i in range(30):
                p.produce("ov", value=b"b%02d" % i, partition=i % 2)
            assert p.flush(10.0) == 0
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "gov", "auto.offset.reset": "earliest"}))
            c.assign([pkg.TopicPartition("ov", 0)])
            c.assign([pkg.TopicPartition("ov", 0),
                      pkg.TopicPartition("ov", 1)])
            got = []
            deadline = time.monotonic() + 15
            while len(got) < 30 and time.monotonic() < deadline:
                m = c.poll(0.2)
                if m is not None and m.error is None:
                    got.append(m.value)
            c.close()
            p.close()
            return sorted(got)
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [b"b%02d" % i for i in range(30)]


# ------------------------------------------------------- test_0121 ------

def test_produce_batch_per_message_errors():
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"t0121": 2})
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "message.max.bytes": 1000}))
        try:
            msgs = [{"value": b"ok-1", "partition": 0},
                    {"value": b"x" * 2000, "partition": 0},
                    {"value": b"ok-2", "key": b"k", "partition": 1},
                    {"value": b"x" * 5000, "partition": 1},
                    {"value": b"ok-3", "partition": 0}]
            n = p.produce_batch("t0121", msgs)
            return [n, [m["error"].code.name if "error" in m else None
                        for m in msgs], p.flush(10)]
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    big = "MSG_SIZE_TOO_LARGE"
    assert port == ref == [3, [None, big, None, big, None], 0]


def test_produce_batch_queue_full():
    """Overflow surfaces _QUEUE_FULL per message; the count is only the
    enqueued ones (no broker drains the queue mid-batch)."""
    def scenario(pkg):
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": "127.0.0.1:1",
            "queue.buffering.max.messages": 5, "message.timeout.ms": 100}))
        try:
            msgs = [{"value": b"v%d" % i, "partition": 0} for i in range(8)]
            n = p.produce_batch("t0121q", msgs)
            out = [n, [m["error"].code.name for m in msgs if "error" in m]]
            p.purge(in_queue=True)
            p.flush(2)
            return out
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref == [5, ["_QUEUE_FULL"] * 3]


# ------------------------------------------------------- test_0125 ------

class _FakeTp:
    def __init__(self, name):
        self.topic, self.partition = name, 0
        self.fetch_in_flight = True
        self.lock = threading.Lock()
        self.fetchq_bytes = 0


def _fake_broker(pkg, budget_kb: int):
    """A Broker shell of ``pkg``'s own client/broker.py with just the
    state _serve_deferred_fetch needs: no socket, no thread."""
    b = mod(pkg, "client.broker").Broker.__new__(
        mod(pkg, "client.broker").Broker)
    b.name = "fake:0/1"
    b.rk = SimpleNamespace(
        conf=SimpleNamespace(
            get=lambda k: {"queued.max.messages.kbytes": budget_kb}[k]),
        fetch_pipeline_depth=2, log=lambda *a, **k: None)
    b.toppars = set()
    b._fetch_deferred = deque()
    b._fetch_pending = deque()
    b.rk.active_toppars = lambda: list(b.toppars)
    return b


@pytest.mark.parametrize("budget_kb", [0, 1024])
def test_deferred_fetch_claims(budget_kb):
    """Budget 0: a migrated partition's claim is released while the owned
    partition's entry stays parked and claimed.  Budget 1 MB: the owned
    partition is begun and finished, both claims released, nothing
    left parked or pending."""
    def scenario(pkg):
        b = _fake_broker(pkg, budget_kb)
        owned, migrated = _FakeTp("owned"), _FakeTp("migrated")
        b.toppars = {owned}
        begun, finished = [], []
        pending = mod(pkg, "client.broker")._PendingFetch
        b._begin_fetch_partition = \
            lambda entry: (begun.append(entry[0].topic), pending(entry))[1]
        b._finish_fetch_partition = \
            lambda pend: finished.append(pend.entry[0].topic)
        b._fetch_deferred.extend([(migrated, {}, None, 0, 0),
                                  (owned, {}, None, 0, 0)])
        b._serve_deferred_fetch()
        return [migrated.fetch_in_flight, owned.fetch_in_flight, begun,
                finished, [e[0].topic for e in b._fetch_deferred],
                len(b._fetch_pending)]
    port, ref = both(scenario)
    want = ([False, True, [], [], ["owned"], 0] if budget_kb == 0 else
            [False, False, ["owned"], ["owned"], [], 0])
    assert port == ref == want


def test_close_leaves_stuck_broker_structures_alone():
    """close() reaps a broker's buffers only when its thread really
    exited: a wedged thread still owns them.  On the port the client's
    codec engine closes under the wedged thread all the same."""
    def scenario(pkg):
        Request = mod(pkg, "client.broker").Request
        p = pkg.Producer(pkg.conf({"bootstrap.servers": "",
                                   "test.mock.num.brokers": 1,
                                   "linger.ms": 2}))
        p.produce("guard", value=b"x", partition=0)
        assert p.flush(10.0) == 0
        rk = p._rk
        with rk._brokers_lock:
            brokers = list(rk.brokers.values())
        stuck = brokers[0]
        stuck._serve = lambda: time.sleep(0.05)
        time.sleep(0.3)
        stuck._rbuf += b"sentinel"
        stuck.waitresp[999999] = Request(pkg.proto.ApiKey.Metadata, {})
        try:
            p.close()
            eng = getattr(rk.codec_provider, "_engine", None)
            return [stuck.thread.is_alive(),
                    bytes(stuck._rbuf).endswith(b"sentinel"),
                    999999 in stuck.waitresp,
                    all(not b.waitresp for b in brokers[1:]
                        if not b.thread.is_alive()),
                    eng is None or (eng._closed
                                    and not eng._thread.is_alive())]
        finally:
            stuck.terminate = True
            stuck.thread.join(5)
    port, ref = both(scenario)
    assert port == ref == [True, True, True, True, True]


def test_close_then_metadata_reply_starts_no_broker():
    """A metadata reply handled after close() began names a broker the
    client has not seen.  The port starts no broker thread for it (a
    repair: close() stops only the brokers it snapshots, so such a
    thread would serve on forever); the JAX package starts one, which
    the test stops (ROADMAP queue 3)."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"mr": 1})
        try:
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers()}))
            rk = p._rk
            _metadata_seen(p)
            p.close()
            rk._handle_metadata(None, {
                "brokers": [{"node_id": 7, "host": "127.0.0.1", "port": 1}],
                "controller_id": 7, "topics": []})
            b = rk.brokers.get(7)
            started = b is not None and b.thread.is_alive()
            if started:
                b.terminate = True
                b.thread.join(5)
                assert not b.thread.is_alive()
            return started
        finally:
            cluster.stop()
    assert both(scenario) == (False, True)


class _Evil:
    """A deque stand-in whose iteration raises like a mutated deque."""

    def __iter__(self):
        raise RuntimeError("deque mutated during iteration")

    def clear(self):
        raise RuntimeError("deque mutated during iteration")


def test_broker_exit_deferred_release_survives_concurrent_clear():
    def scenario(pkg):
        conf = {"reconnect.backoff.ms": 100}
        rk = SimpleNamespace(conf=SimpleNamespace(get=lambda k: conf[k]),
                             interceptors=None, dbg=lambda *a, **k: None,
                             log=lambda *a, **k: None)
        b = mod(pkg, "client.broker").Broker(rk, 1, "localhost", 1)
        b.terminate = True
        b._fetch_deferred = _Evil()
        b._thread_main()          # must return cleanly, not raise
        return True
    assert both(scenario) == (True, True)


# ------------------------------------------- chip_smoke.py phase 11 ------

#: phase 11's functions on each package (its names serve as the client
#: kit): the port's GPU backend on the plain versions, the JAX package's
#: TPU backend (jax on the CPU)
P11_PORT = {"compression.backend": "gpu", "gpu.device": "cpu",
            "gpu.governor": False, "gpu.launch.min.batches": 1}
P11_REF = {"compression.backend": "tpu", "tpu.governor": False,
           "tpu.launch.min.batches": 1, "tpu.transport.min.mb.s": 0}
P11_PARTS, P11_PER = 4, 100


def p11_vals():
    import chip_smoke
    flat = chip_smoke.payloads(P11_PARTS * P11_PER, chip_smoke.VALUE_SIZE)
    return [flat[i * P11_PER:(i + 1) * P11_PER] for i in range(P11_PARTS)]


@pytest.mark.parametrize("leg", ["a", "b"])
def test_phase11_delivery_on_both_packages(leg):
    """chip_smoke.py 11a at 4 x 100 x 1 KB: produce_batch with headers and
    timestamps, every DR served at flush(), DR batches == stored batches,
    the error DRs; on the port's CRC tickets (a) or device compress route
    (b), frames held to the native (deterministic on b) encoder, and on
    the JAX package's TPU backend."""
    import chip_smoke
    vals = p11_vals()

    def scenario(pkg):
        backend = dict(P11_PORT if pkg.port else P11_REF)
        if pkg.port and leg == "b":
            backend["gpu.compress.device"] = True
        cluster = chip_smoke.p11_cluster(pkg, leg, P11_PARTS)
        try:
            d = chip_smoke.p11_delivery(pkg, cluster, vals, backend, leg,
                                        det=pkg.port and leg == "b")
        finally:
            cluster.stop()
        if pkg.port:
            assert (d["lz4"] > 0 and d["crc"] == 0 if leg == "b"
                    else d["crc"] > 0 and d["lz4"] == 0), d
        e = d["errors"]
        return [e["mixed"], e["expired"], sum(e["purged"].values()),
                "_PURGE_INFLIGHT" in e["purged"]]
    port, ref = both(scenario)
    n = chip_smoke.P11_ERR
    assert port == ref == [{"queued": n - (n + 2) // 3,
                            "unknown": (n + 2) // 3}, n, n, True]


def test_phase11_teardown_on_both_packages():
    """chip_smoke.py 11c on each package in turn (it checks that no engine
    thread is left, so the two may not overlap): close() under a wedged
    broker thread with tickets in flight, every waiter resolved or
    failed "closed", a fresh client exact.  The JAX package runs its CPU
    backend here: its engine's drain compiles each new padded shape
    (seconds with jax on the CPU), which would time XLA, not close()."""
    import chip_smoke
    out = {}
    for pkg in (PORT, REF):
        t = chip_smoke.p11_teardown(
            pkg, P11_PORT if pkg.port
            else {"compression.backend": "cpu"}, "c", parts=4, per=100)
        out[pkg.port] = [t["ticket_waits"]["hung"],
                         t["ticket_waits"]["other"], t["tickets"] > 0]
        if pkg.port:
            assert t["fresh_launches"] > 0
    assert out[True] == out[False] == [0, [], True]
