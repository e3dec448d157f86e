"""Mirrors of the consumer's API on the port: test_0030_offset_file (the
file offset store), test_0054_offsets_pause (offsets_for_times,
pause/resume), test_0085_headers_api (headers, watermarks, position),
test_0106_regex_subscribe, test_0117_fetch_follower (KIP-392),
test_0119_consume_api (consume(n), max.poll.interval.ms, compacted
offsets, connection loss, callback consume) and test_0120_sync_waits
(no sleep-polling in client/, pointed at each package's own modules;
condvar wakes).

The port's clients run ``compression.backend=gpu, gpu.device=cpu``
(``test_torch_txn.GPU``) and the JAX package's the reference case's own
conf.  Each scenario runs on both packages on the same input,
concurrently (``both``); the port's result must equal the reference's
and the reference test's expectation.
"""
import pathlib
import re
import threading
import time

import pytest

from test_torch_delivery import _metadata_seen, mod
from test_torch_txn import PORT, REF, both


def _produce(pkg, cluster, topic: str, vals, partition=0, **conf):
    p = pkg.Producer(pkg.conf({
        "bootstrap.servers": cluster.bootstrap_servers(), "linger.ms": 2,
        **conf}))
    try:
        for v in vals:
            p.produce(topic, value=v, partition=partition)
        assert p.flush(10.0) == 0
    finally:
        p.close()


def _consumer(pkg, cluster, **conf):
    return pkg.Consumer(pkg.conf({
        "bootstrap.servers": cluster.bootstrap_servers(),
        "auto.offset.reset": "earliest", **conf}))


def _poll(c, n: int, timeout: float = 20.0, each=0.3, keep=None) -> list:
    """Poll until ``n`` good messages (those ``keep`` accepts) or
    ``timeout``."""
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        m = c.poll(each)
        if m is not None and m.error is None and (keep is None or keep(m)):
            got.append(m)
    return got


# ------------------------------------------------------- test_0030 ------

def _file_consumer(pkg, cluster, path, group="gfile", **extra):
    return _consumer(pkg, cluster, **{
        "group.id": group, "enable.auto.commit": False,
        "offset.store.method": "file", "offset.store.path": str(path),
        "offset.store.sync.interval.ms": 0, **extra})


def _dirs(tmp_path):
    out = {}
    for side in ("port", "ref"):
        out[side == "port"] = tmp_path / side
        out[side == "port"].mkdir()
    return out


def _file_cluster(pkg):
    return pkg.MockCluster(num_brokers=1, topics={"filo": 1})


def test_commit_writes_file_and_committed_reads_it(tmp_path):
    dirs = _dirs(tmp_path)

    def scenario(pkg):
        cluster = _file_cluster(pkg)
        d = dirs[pkg.port]
        try:
            _produce(pkg, cluster, "filo", [b"m%02d" % i for i in range(20)])
            c = _file_consumer(pkg, cluster, d)
            c.subscribe(["filo"])
            got = _poll(c, 10)
            c.commit(message=got[-1])
            path = d / "filo-0.offset"
            out = [len(got), path.exists() and int(path.read_text().strip()),
                   c.committed([pkg.TopicPartition("filo", 0)])[0].offset]
            c.close()
            return out + [[a for _, a in cluster.request_log
                           if a == int(pkg.proto.ApiKey.OffsetCommit)]]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [10, 10, 10, []]


def test_restart_resumes_from_file_offset(tmp_path):
    dirs = _dirs(tmp_path)

    def scenario(pkg):
        cluster = _file_cluster(pkg)
        try:
            _produce(pkg, cluster, "filo", [b"r%02d" % i for i in range(15)])
            c1 = _file_consumer(pkg, cluster, dirs[pkg.port])
            c1.subscribe(["filo"])
            got = _poll(c1, 7)
            c1.commit(message=got[-1])
            c1.close()
            c2 = _file_consumer(pkg, cluster, dirs[pkg.port])
            c2.subscribe(["filo"])
            got2 = _poll(c2, 8)
            c2.close()
            return [m.value for m in got2]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [b"r%02d" % i for i in range(7, 15)]


def test_file_corruption_falls_back_to_reset_policy(tmp_path):
    dirs = _dirs(tmp_path)

    def scenario(pkg):
        cluster = _file_cluster(pkg)
        try:
            (dirs[pkg.port] / "filo-0.offset").write_text("not-a-number\n")
            _produce(pkg, cluster, "filo", [b"only"])
            c = _file_consumer(pkg, cluster, dirs[pkg.port])
            c.subscribe(["filo"])
            got = _poll(c, 1, timeout=15)
            c.close()
            return [m.value for m in got]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [b"only"]


def test_store_method_none_explicit_commit_reaches_broker(tmp_path):
    """offset.store.method=none suppresses only store-derived auto-commit
    offsets: an explicit commit(message=...) reaches the broker, and no
    offset file appears."""
    dirs = _dirs(tmp_path)

    def scenario(pkg):
        cluster = _file_cluster(pkg)
        try:
            _produce(pkg, cluster, "filo", [b"m%02d" % i for i in range(10)])
            c = _file_consumer(pkg, cluster, dirs[pkg.port], group="gnone",
                               **{"offset.store.method": "none"})
            c.subscribe(["filo"])
            got = _poll(c, 5)
            c.commit(message=got[-1])
            out = [len(got),
                   c.committed([pkg.TopicPartition("filo", 0)])[0].offset,
                   list(dirs[pkg.port].iterdir())]
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [5, 5, []]


def test_store_method_none_filters_auto_commit(tmp_path):
    """Under method=none the store-derived auto-commit (and close()'s
    final one) never reaches the broker."""
    dirs = _dirs(tmp_path)

    def scenario(pkg):
        cluster = _file_cluster(pkg)
        try:
            _produce(pkg, cluster, "filo", [b"m%02d" % i for i in range(10)])
            c = _file_consumer(pkg, cluster, dirs[pkg.port], group="gnone2",
                               **{"offset.store.method": "none",
                                  "enable.auto.commit": True,
                                  "auto.commit.interval.ms": 50})
            c.subscribe(["filo"])
            got = _poll(c, 10)
            time.sleep(0.5)               # several auto-commit intervals
            out = [len(got), c.committed(
                [pkg.TopicPartition("filo", 0)])[0].offset in (-1, None)]
            c.close()
            c2 = _file_consumer(pkg, cluster, dirs[pkg.port],
                                group="gnone2",
                                **{"offset.store.method": "none"})
            cm = None
            deadline = time.monotonic() + 10
            while cm is None and time.monotonic() < deadline:
                try:
                    cm = c2.committed([pkg.TopicPartition("filo", 0)],
                                      timeout=5.0)
                except pkg.KafkaException:
                    time.sleep(0.2)
            c2.close()
            return out + [cm is not None and cm[0].offset in (-1, None)]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [10, True, True]


# ------------------------------------------------------- test_0054 ------

def test_offsets_for_times():
    """EARLIEST offset whose timestamp >= the target, through
    ListOffsets; past the last timestamp, no offset."""
    base_ts = 1_600_000_000_000

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"oft": 1})
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 0}))
        try:
            for i in range(5):
                p.produce("oft", value=b"t%d" % i, partition=0,
                          timestamp=base_ts + i * 1000)
                p.flush(10.0)               # one batch a timestamp
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "goft"}))
            out = []
            for dt in (1500, 0, 4000, 99_000):
                r = c.offsets_for_times(
                    [pkg.TopicPartition("oft", 0, base_ts + dt)],
                    timeout=10)[0]
                out.append(r.offset if r.error is None and r.offset >= 0
                           else None)
            c.close()
            return out
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [2, 0, 4, None]


def test_pause_resume_no_loss():
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"pr": 2})
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 2}))
        c = _consumer(pkg, cluster, **{"group.id": "gpr"})
        try:
            for i in range(20):
                p.produce("pr", value=b"a%02d" % i, partition=i % 2)
            assert p.flush(10.0) == 0
            c.subscribe(["pr"])
            first = sorted(m.value for m in _poll(c, 20))
            c.pause([pkg.TopicPartition("pr", 0)])
            time.sleep(0.2)
            for i in range(10):
                p.produce("pr", value=b"b%02d" % i, partition=i % 2)
            assert p.flush(10.0) == 0
            paused = []
            deadline = time.monotonic() + 4
            while time.monotonic() < deadline:
                m = c.poll(0.25)
                if m is not None and m.error is None:
                    paused.append((m.partition, m.value))
            c.resume([pkg.TopicPartition("pr", 0)])
            resumed = _poll(c, 5, timeout=15, keep=lambda m: m.partition == 0)
            return [first, sorted(paused), sorted(m.value for m in resumed)]
        finally:
            c.close()
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [sorted(b"a%02d" % i for i in range(20)),
                           [(1, b"b%02d" % i) for i in range(1, 10, 2)],
                           [b"b%02d" % i for i in range(0, 10, 2)]]


# ------------------------------------------------------- test_0085 ------

def test_headers_round_trip_and_position():
    """Headers (null values, duplicates) and timestamps survive produce ->
    lz4 wire -> consume; watermarks and position report the log."""
    ts = 1_680_000_000_123
    hdrs = [("trace-id", b"abc123"), ("null-hdr", None),
            ("dup", b"first"), ("dup", b"second")]

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"hdr": 1})
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 2, "compression.codec": "lz4"}))
        try:
            p.produce("hdr", value=b"with-headers", key=b"k", partition=0,
                      timestamp=ts, headers=hdrs)
            p.produce("hdr", value=b"plain", partition=0)
            assert p.flush(10.0) == 0
            c = _consumer(pkg, cluster, **{"group.id": "ghdr"})
            c.subscribe(["hdr"])
            got = _poll(c, 2, timeout=15)
            out = [[(m.value, list(m.headers or [])) for m in got],
                   got[0].timestamp,
                   c.get_watermark_offsets(pkg.TopicPartition("hdr", 0)),
                   c.position([pkg.TopicPartition("hdr", 0)])[0].offset]
            c.close()
            return out
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [[(b"with-headers", hdrs), (b"plain", [])], ts,
                           (0, 2), 2]


# ------------------------------------------------------- test_0106 ------

def _regex_cluster(pkg):
    return pkg.MockCluster(num_brokers=1, topics={"bench-a": 1, "other": 1},
                           auto_create_topics=False)


def _topic_values(c, n, timeout=25):
    return [(m.topic, m.value) for m in _poll(c, n, timeout=timeout)]


def test_regex_matches_existing_and_new_topics():
    """A pattern matches the cluster's topics; a matching topic created
    after subscribe() is picked up and read; other topics never are."""
    def scenario(pkg):
        cluster = _regex_cluster(pkg)
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 2}))
        try:
            p.produce("bench-a", value=b"a1", partition=0)
            p.produce("other", value=b"x1", partition=0)
            assert p.flush(10.0) == 0
            c = _consumer(pkg, cluster, **{
                "group.id": "rgx", "topic.metadata.refresh.interval.ms": 400})
            c.subscribe(["^bench-.*"])
            out = [_topic_values(c, 1)]
            cluster.create_topic("bench-b", 1)
            p.produce("bench-b", value=b"b1", partition=0)
            assert p.flush(10.0) == 0
            out.append(_topic_values(c, 1))
            p.produce("other", value=b"x2", partition=0)
            assert p.flush(10.0) == 0
            out.append(_topic_values(c, 1, timeout=2))
            c.close()
            return out
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [[("bench-a", b"a1")], [("bench-b", b"b1")], []]


def test_mixed_literal_and_regex():
    def scenario(pkg):
        cluster = _regex_cluster(pkg)
        try:
            _produce(pkg, cluster, "bench-a", [b"a"])
            _produce(pkg, cluster, "other", [b"o"])
            c = _consumer(pkg, cluster, **{
                "group.id": "rgx2", "topic.metadata.refresh.interval.ms": 400})
            c.subscribe(["other", "^bench-.*"])
            got = sorted(_topic_values(c, 2))
            c.close()
            return got
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [("bench-a", b"a"), ("other", b"o")]


def test_bad_regex_raises():
    def scenario(pkg):
        cluster = _regex_cluster(pkg)
        c = pkg.Consumer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "group.id": "rgx3"}))
        try:
            _metadata_seen(c)
            with pytest.raises(pkg.KafkaException):
                c.subscribe(["^ben[ch-"])
            return True
        finally:
            c.close()
            cluster.stop()
    assert both(scenario) == (True, True)


# ------------------------------------------------------- test_0117 ------

def _fetch_brokers(pkg, cluster):
    return {b for b, api in cluster.request_log
            if api == pkg.proto.ApiKey.Fetch}


def _ff_values(lo, hi):
    return [b"ff-%03d" % i for i in range(lo, hi)]


def test_fetch_moves_to_follower_and_back():
    """A v11 Fetch to the leader is redirected to the nominated follower;
    once the follower is withdrawn the consumer goes back to the
    leader."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=2, topics={"ff": 1})
        try:
            _produce(pkg, cluster, "ff", _ff_values(0, 40), **{"linger.ms": 5})
            cluster.set_follower("ff", 0, 2)
            c = _consumer(pkg, cluster, **{
                "group.id": "gff", "client.rack": "rack-b",
                "fetch.wait.max.ms": 50})
            c.subscribe(["ff"])
            out = [sorted(m.value for m in _poll(c, 40, each=0.2)),
                   2 in _fetch_brokers(pkg, cluster)]
            cluster.set_follower("ff", 0, None)
            cluster.request_log.clear()
            _produce(pkg, cluster, "ff", _ff_values(40, 60),
                     **{"linger.ms": 5})
            out += [sorted(m.value for m in _poll(c, 20, each=0.2)),
                    1 in _fetch_brokers(pkg, cluster)]
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [_ff_values(0, 40), True, _ff_values(40, 60), True]


def test_pre_v11_broker_never_redirects():
    """A broker below Fetch v11 serves data itself, follower or not."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=2, topics={"ff": 1},
                                  broker_version="0.11.0")
        try:
            cluster.set_follower("ff", 0, 2)
            _produce(pkg, cluster, "ff", _ff_values(0, 15), **{"linger.ms": 5})
            c = _consumer(pkg, cluster, **{"group.id": "gff-old",
                                           "fetch.wait.max.ms": 50})
            c.subscribe(["ff"])
            got = _poll(c, 15, timeout=15, each=0.2)
            c.close()
            return [len(got), 2 in _fetch_brokers(pkg, cluster)]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [15, False]


def test_producer_keeps_targeting_leader():
    """Fetch delegation does not move produce traffic."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=2, topics={"ff": 1})
        try:
            cluster.set_follower("ff", 0, 2)
            _produce(pkg, cluster, "ff", _ff_values(0, 10), **{"linger.ms": 5})
            return {b for b, api in cluster.request_log
                    if api == pkg.proto.ApiKey.Produce}
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == {1}


# ------------------------------------------------------- test_0119 ------

def _ca_cluster(pkg):
    return pkg.MockCluster(num_brokers=1, topics={"ca": 1})


def _ca(lo, hi):
    return [b"c%03d" % i for i in range(lo, hi)]


def test_consume_batch():
    """consume(n) returns up to n messages in order."""
    def scenario(pkg):
        cluster = _ca_cluster(pkg)
        try:
            _produce(pkg, cluster, "ca", _ca(0, 25))
            c = _consumer(pkg, cluster, **{"group.id": "gcb"})
            c.subscribe(["ca"])
            got, sizes = [], []
            deadline = time.monotonic() + 20
            while len(got) < 25 and time.monotonic() < deadline:
                batch = c.consume(10, timeout=0.5)
                sizes.append(len(batch))
                got += [m for m in batch if m.error is None]
            c.close()
            return [max(sizes) <= 10, [(m.value, m.offset) for m in got]]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True, list(zip(_ca(0, 25), range(25)))]


def test_max_poll_interval_exceeded():
    """Not polling past max.poll.interval.ms surfaces _MAX_POLL_EXCEEDED
    and leaves the group; polling again resumes consumption."""
    post = [b"post-%d" % i for i in range(3)]

    def scenario(pkg):
        cluster = _ca_cluster(pkg)
        errs = []
        try:
            _produce(pkg, cluster, "ca", _ca(0, 5))
            c = _consumer(pkg, cluster, **{
                "group.id": "gmp", "max.poll.interval.ms": 1200,
                "session.timeout.ms": 6000, "error_cb": errs.append})
            c.subscribe(["ca"])
            out = [len(_poll(c, 5, timeout=15, each=0.2))]
            time.sleep(2.5)

            def exceeded():
                return any(e.code.name == "_MAX_POLL_EXCEEDED" for e in errs)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not exceeded():
                c.poll(0.1)
            out.append(exceeded())
            _produce(pkg, cluster, "ca", post)
            seen = {m.value for m in _poll(c, 3, each=0.2,
                                           keep=lambda m: m.value in post)}
            c.close()
            return out + [sorted(seen)]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [5, True, post]


def test_compacted_log_offset_gaps():
    """A compacted log's offset gaps are stepped over under check.crcs."""
    def scenario(pkg):
        cluster = _ca_cluster(pkg)
        Message = mod(pkg, "client.msg").Message
        part = cluster.partition("ca", 0)

        def batch(base, vals):
            msgs = [Message("ca", value=v, partition=0,
                            timestamp=1_690_000_000_000 + i)
                    for i, v in enumerate(vals)]
            return pkg.msgset.MsgsetWriterV2(base_offset=base).build(
                msgs, now_ms=1_690_000_000_000).finalize()
        try:
            with cluster._lock:
                part.log = [(0, batch(0, [b"k0", b"k1", b"k2"])),
                            (5, batch(5, [b"k5", b"k6"]))]
                part.start_offset, part.end_offset = 0, 7
            c = _consumer(pkg, cluster, **{"group.id": "gcp",
                                           "check.crcs": True})
            c.subscribe(["ca"])
            got = [(m.offset, m.value) for m in _poll(c, 5, timeout=15,
                                                      each=0.2)]
            c.close()
            return got
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [(0, b"k0"), (1, b"k1"), (2, b"k2"),
                           (5, b"k5"), (6, b"k6")]


def test_consume_connection_close_recovers():
    """Every connection killed mid-consume: the consumer reconnects and
    finishes the stream without loss."""
    def scenario(pkg):
        cluster = _ca_cluster(pkg)
        em = mod(pkg, "mock.sockem").Sockem()
        try:
            _produce(pkg, cluster, "ca", _ca(0, 20))
            c = _consumer(pkg, cluster, **{
                "group.id": "gcc", "connect_cb": em.connect_cb,
                "reconnect.backoff.ms": 50, "fetch.wait.max.ms": 100})
            c.subscribe(["ca"])
            got = [m.offset for m in _poll(c, 20, timeout=30, each=0.2)]
            killed = em.kill_all() > 0
            _produce(pkg, cluster, "ca", _ca(20, 40))
            deadline = time.monotonic() + 30
            while len(set(got)) < 40 and time.monotonic() < deadline:
                m = c.poll(0.2)
                if m is not None and m.error is None:
                    got.append(m.offset)
            c.close()
            return [killed, sorted(set(got))]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True, list(range(40))]


def test_consume_callback_mode():
    """consume_callback with consume_cb and the
    consume.callback.max.messages cap; explicit arguments beat the conf."""
    def scenario(pkg):
        cluster = _ca_cluster(pkg)
        seen = []
        try:
            _produce(pkg, cluster, "ca", _ca(0, 30))
            c = _consumer(pkg, cluster, **{
                "group.id": "gccb", "consume_cb": lambda m: seen.append(
                    m.offset), "consume.callback.max.messages": 10})
            c.subscribe(["ca"])
            total, most = 0, 0
            deadline = time.monotonic() + 20
            while total < 30 and time.monotonic() < deadline:
                n = c.consume_callback(timeout=0.5)
                most = max(most, n)
                total += n
            _produce(pkg, cluster, "ca", _ca(30, 35))
            got2 = []
            deadline = time.monotonic() + 20
            while len(got2) < 5 and time.monotonic() < deadline:
                c.consume_callback(timeout=0.5,
                                   consume_cb=lambda m: got2.append(m.offset),
                                   max_messages=2)
            c.close()
            return [total, most <= 10, list(seen), got2]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [30, True, list(range(30)), list(range(30, 35))]


def test_consume_callback_requires_cb():
    def scenario(pkg):
        cluster = _ca_cluster(pkg)
        c = pkg.Consumer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "group.id": "gnone"}))
        try:
            _metadata_seen(c)
            with pytest.raises(Exception):
                c.consume_callback(timeout=0.1)
            return True
        finally:
            c.close()
            cluster.stop()
    assert both(scenario) == (True, True)


# ------------------------------------------------------- test_0120 ------

ROOT = pathlib.Path(__file__).parent.parent
#: the one time.sleep allowed in client/: broker.py's backoff after an
#: unexpected serve exception (it rate-limits a broken broker thread's
#: restart loop; not a request/response wait)
ALLOWED = {"broker.py": 1}


@pytest.mark.parametrize("package", ["librdkafka_tpu_torch",
                                     "librdkafka_tpu"])
def test_no_sleep_poll_in_client(package):
    found = {}
    for py in sorted((ROOT / package / "client").glob("*.py")):
        n = len(re.findall(r"time\.sleep\(", py.read_text()))
        if n:
            found[py.name] = n
    assert found == ALLOWED


def _sync_cluster(pkg):
    return pkg.MockCluster(num_brokers=2, topics={"t0120": 2, "t0120f": 1})


def test_commit_wakes_without_poll_period():
    """A synchronous commit returns on the reply's condvar wake, within
    one mock round trip (generous on a loaded host)."""
    def scenario(pkg):
        cluster = _sync_cluster(pkg)
        try:
            _produce(pkg, cluster, "t0120", [b"m%d" % i for i in range(10)])
            c = _consumer(pkg, cluster, **{"group.id": "g0120",
                                           "enable.auto.commit": False})
            c.subscribe(["t0120"])
            out = [len(_poll(c, 10, timeout=15, each=0.2))]
            t0 = time.monotonic()
            res = c.commit(asynchronous=False)
            out.append(bool(res) and time.monotonic() - t0 < 2.0)
            committed = c.committed(res, timeout=5.0)
            out.append({tp.partition: tp.offset for tp in committed}[0])
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [10, True, 10]


def test_flush_event_mode_wakes():
    """flush() in DR-event mode returns once another thread drains the
    DR events (the condvar path)."""
    def scenario(pkg):
        cluster = _sync_cluster(pkg)
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "enabled_events": ["dr"]}))
        stop = threading.Event()

        def drain():
            while not stop.is_set():
                p.rk.queue_poll(0.05)
        t = threading.Thread(target=drain, daemon=True)
        try:
            for i in range(50):
                p.produce("t0120f", value=b"x" * 100, partition=0)
            t.start()
            return p.flush(10)
        finally:
            stop.set()
            t.join(2)
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == 0


# ------------------------------------------- chip_smoke.py phase 11 ------

def test_phase11_consumer_api_on_both_packages(tmp_path):
    """chip_smoke.py 11b at 4 x 100 x 1 KB on each package: 11a's records
    read from the follower of the even partitions, half paused and
    resumed, the follower withdrawn midway, a quarter rewound by seek,
    offsets_for_times on stored timestamps, a file-store restart, then a
    regex subscription that picks up a topic created mid-run.  Every
    record after each seek point once, in order."""
    import chip_smoke
    from test_torch_delivery import P11_PARTS, P11_PER, P11_PORT, P11_REF
    from test_torch_delivery import p11_vals
    vals = p11_vals()
    dirs = _dirs(tmp_path)

    def scenario(pkg):
        backend = P11_PORT if pkg.port else P11_REF
        cluster = chip_smoke.p11_cluster(pkg, "a", P11_PARTS)
        try:
            d = chip_smoke.p11_delivery(pkg, cluster, vals, backend, "a")
            r = chip_smoke.p11_consume(pkg, cluster, vals, backend, "a",
                                       str(dirs[pkg.port]), d["max_ts"])
            rx = chip_smoke.p11_regex(pkg, cluster, backend, "a")
        finally:
            cluster.stop()
        if pkg.port:
            assert min(r["crc"]) > 0, r
        return [r["delivered"] - r["rewound"], r["delegated"] > 0,
                r["follower_after"], rx["records"]]
    port, ref = both(scenario)
    assert port == ref == [P11_PARTS * P11_PER, True, 0, 100]
