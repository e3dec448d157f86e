"""Mirrors of test_0075_sockem (latency and bandwidth shaping, a
connection killed mid-ProduceRequest, a request timeout's retry, a broker
process SIGKILLed mid-produce, a consumer's connection killed between
fetches) and test_0093_holb (a slow broker does not hold up a fast one;
close) on the port.

Each case runs one scenario on the port and on the JAX package, at once
in two threads, each with its own mock (and, for the SIGKILL case, its
own out-of-process cluster: the port's ``mock.external.ClusterHandle``)
and its own package's ``mock.sockem.Sockem``.  The port's clients run
``compression.backend=gpu, gpu.device=cpu`` (the kernels' plain versions;
a retried idempotent batch is rebuilt through the device route), except
where 0075 parametrises the backend: there the port's ``cpu`` and ``gpu``
stand beside the reference's ``cpu`` and ``tpu``.  The partition logs
(values in order), the DR counts and the reconnect decisions compare;
timing bounds are 0075's and 0093's own.
"""
import time

import pytest

from test_torch_client import guarded_thread
from test_torch_delivery import mod
from test_torch_txn import PORT, REF, both
from torch_leakguard import no_new_threads


@pytest.fixture(autouse=True)
def _no_thread_left():
    with no_new_threads(guarded_thread):
        yield


def sockem(pkg, **kw):
    return mod(pkg, "mock.sockem").Sockem(**kw)


def log_values(pkg, cluster, topic: str = "net", part: int = 0) -> list:
    out = []
    for _base, blob in cluster.partition(topic, part).log:
        for info, payload, _full in pkg.msgset.iter_batches(blob):
            out += [bytes(r.value)
                    for r in pkg.msgset.parse_records_v2(info, payload)]
    return out


def on_net(scenario):
    """``scenario(pkg, cluster)`` on both packages with 0075's mock (one
    broker, topic ``net`` of one partition); (port, reference)."""
    def run(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"net": 1})
        try:
            return scenario(pkg, cluster)
        finally:
            cluster.stop()
    return both(run)


# ------------------------------------------------------------ test_0075 --

def test_latency_injection_slows_but_delivers():
    def scenario(pkg, cluster):
        em = sockem(pkg, delay_ms=0)
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "connect_cb": em.connect_cb, "linger.ms": 2}))
        try:
            p.produce("net", value=b"fast", partition=0)
            assert p.flush(10.0) == 0
            connected = em.connect_count >= 1
            em.set(delay_ms=400)
            t0 = time.monotonic()
            p.produce("net", value=b"slow", partition=0)
            assert p.flush(15.0) == 0
            return connected, time.monotonic() - t0 >= 0.4, \
                log_values(pkg, cluster)
        finally:
            p.close()
    port, ref = on_net(scenario)
    assert port == ref == (True, True, [b"fast", b"slow"])


def test_rate_limit_paces_transfer():
    def scenario(pkg, cluster):
        em = sockem(pkg, rate_bps=40000)
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "connect_cb": em.connect_cb, "linger.ms": 2,
            "compression.codec": "none"}))
        try:
            t0 = time.monotonic()
            p.produce("net", value=b"x" * 40000, partition=0)
            assert p.flush(20.0) == 0
            return time.monotonic() - t0 >= 0.8, log_values(pkg, cluster)
        finally:
            p.close()
    port, ref = on_net(scenario)
    assert port == ref == (True, [b"x" * 40000])


def test_kill_mid_produce_retries_without_duplication():
    """The link throttled to 30 kB/s mid-ProduceRequest, then cut: the
    idempotent producer resends, and every record is in the log once."""
    n = 100

    def scenario(pkg, cluster):
        em = sockem(pkg)
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "connect_cb": em.connect_cb, "enable.idempotence": True,
            "linger.ms": 5, "retry.backoff.ms": 50,
            "message.send.max.retries": 20, "message.timeout.ms": 30000}))
        try:
            p.produce("net", value=b"warm", partition=0)
            assert p.flush(10.0) == 0
            em.set(rate_bps=30000)
            for i in range(n):
                p.produce("net", value=(b"m%03d-" % i) * 100, partition=0)
            time.sleep(0.6)            # the request is mid-transfer now
            killed = em.kill_all()
            em.set(rate_bps=0)
            assert p.flush(30.0) == 0
            return killed >= 1, log_values(pkg, cluster)
        finally:
            p.close()
    port, ref = on_net(scenario)
    assert port == ref
    assert port[0] and port[1] == [b"warm"] + [(b"m%03d-" % i) * 100
                                               for i in range(n)]


BACKENDS = {"cpu": ({"compression.backend": "cpu"},
                    {"compression.backend": "cpu"}),
            "gpu": ({"compression.backend": "gpu"},
                    {"compression.backend": "tpu", "tpu.governor": False,
                     "tpu.launch.min.batches": 1})}


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_request_timeout_retry_no_duplicate(backend):
    """2 s of injected latency makes the ProduceRequest overshoot
    socket.timeout.ms: the client times it out and retries, and the
    broker's idempotence check drops whichever copy lands second."""
    def scenario(pkg, cluster):
        em = sockem(pkg)
        conf = {"bootstrap.servers": cluster.bootstrap_servers(),
                "connect_cb": em.connect_cb, "enable.idempotence": True,
                "compression.codec": "lz4", "linger.ms": 2,
                "socket.timeout.ms": 1000, "socket.max.fails": 0,
                "retry.backoff.ms": 100, "message.send.max.retries": 20,
                "message.timeout.ms": 30000}
        side = BACKENDS[backend][0 if pkg.port else 1]
        conf = pkg.conf(conf) if pkg.port and backend == "gpu" \
            else {**conf, **side}
        p = pkg.Producer(conf)
        try:
            p.produce("net", value=b"warm", partition=0)
            assert p.flush(10.0) == 0
            em.set(delay_ms=2000)
            p.produce("net", value=b"timeout-victim", partition=0)
            time.sleep(1.4)            # past socket.timeout.ms
            timed_out = sum(b.c_req_timeouts
                            for b in p.rk.brokers.values()) >= 1
            em.set(delay_ms=0)
            assert p.flush(20.0) == 0
            produces = sum(1 for _b, api in cluster.request_log
                           if api == int(pkg.proto.ApiKey.Produce))
            return timed_out, log_values(pkg, cluster), produces >= 3
        finally:
            p.close()
    port, ref = on_net(scenario)
    assert port == ref == (True, [b"warm", b"timeout-victim"], True)


@pytest.mark.chaos
def test_kill9_during_produce_backoff_and_dedup():
    """The broker PROCESS SIGKILLed mid-produce: the client walks the
    jittered reconnect backoff while the port is unbound, and after the
    restart one copy of every record survives (read back by a
    consumer)."""
    base_ms, max_ms, n = 200, 1500, 40

    def scenario(pkg):
        ext = mod(pkg, "mock.external")
        h = ext.ClusterHandle(brokers=1, topics={"net": 1})
        p = c = None
        try:
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": h.bootstrap_servers(),
                "enable.idempotence": True, "linger.ms": 2,
                "reconnect.backoff.ms": base_ms,
                "reconnect.backoff.max.ms": max_ms,
                "socket.timeout.ms": 2000, "socket.max.fails": 0,
                "retry.backoff.ms": 50, "message.send.max.retries": 200,
                "message.timeout.ms": 60000}))
            p.produce("net", value=b"warm", partition=0)
            assert p.flush(15.0) == 0
            for i in range(n):
                p.produce("net", value=b"k%03d" % i, partition=0)
            p.poll(0)
            pid = h.broker_pids[1]
            r = h.kill9(1)
            dead = r["exit"] == -9 and not ext.pid_alive(pid)
            time.sleep(2.2)
            h.restart_broker(1)
            assert p.flush(60.0) == 0
            hist = [d for b in p.rk.brokers.values() if b.nodeid >= 0
                    for _ts, d in b.reconnect_history]
            lo, hi = 0.75 * base_ms / 1000.0, max_ms / 1000.0
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": h.bootstrap_servers(),
                "group.id": "g-kill9", "auto.offset.reset": "earliest",
                "check.crcs": True}))
            c.subscribe(["net"])
            got = []
            deadline = time.monotonic() + 30
            while len(got) < n + 1 and time.monotonic() < deadline:
                m = c.poll(0.3)
                if m is not None and m.error is None:
                    got.append(bytes(m.value))
            return (dead, len(hist) >= 2,
                    all(lo <= d <= hi * 1.0001 for d in hist),
                    max(hist) > base_ms / 1000.0 * 1.5001
                    or max(hist) == pytest.approx(hi, rel=1e-6),
                    sorted(v for v in got if v != b"warm"))
        finally:
            if p is not None:
                p.close()
            if c is not None:
                c.close()
            h.stop()
    port, ref = both(scenario)
    assert port == ref == (True, True, True, True,
                           sorted(b"k%03d" % i for i in range(n)))


def test_connection_kill_recovery_consumer():
    """The consumer's connection killed between fetches: it reconnects
    and resumes from its position, nothing lost or read twice."""
    def scenario(pkg, cluster):
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 2}))
        try:
            for i in range(30):
                p.produce("net", value=b"c%d" % i, partition=0)
            assert p.flush(10.0) == 0
        finally:
            p.close()
        em = sockem(pkg)
        c = pkg.Consumer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "connect_cb": em.connect_cb, "group.id": "gsock",
            "auto.offset.reset": "earliest", "session.timeout.ms": 30000,
            "check.crcs": True}))
        got, killed = [], False
        try:
            c.subscribe(["net"])
            deadline = time.monotonic() + 30
            while len(got) < 30 and time.monotonic() < deadline:
                m = c.poll(0.3)
                if m is not None and m.error is None:
                    got.append(bytes(m.value))
                if len(got) >= 10 and not killed:
                    killed = True
                    em.kill_all()
        finally:
            c.close()
        return killed, sorted(got)
    port, ref = on_net(scenario)
    assert port == ref == (True, sorted(b"c%d" % i for i in range(30)))


# ------------------------------------------------------------ test_0093 --

def test_slow_broker_does_not_block_fast_broker():
    """Broker 1's RTT at 2,500 ms: broker 2's 20 DRs land under 2.0 s,
    broker 1's after at least 2.0 s."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=2, topics={"holb": 2})
        cluster.set_partition_leader("holb", 0, 1)
        cluster.set_partition_leader("holb", 1, 2)
        fast, slow = [], []
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 2}))
        try:
            for q in (0, 1):
                p.produce("holb", value=b"w%d" % q, partition=q,
                          on_delivery=lambda e, m: None)
            assert p.flush(10.0) == 0
            cluster.set_rtt(1, 2500)
            t0 = time.monotonic()
            for i in range(20):
                p.produce("holb", value=b"s%d" % i, partition=0,
                          on_delivery=lambda e, m: slow.append(
                              time.monotonic() - t0))
                p.produce("holb", value=b"f%d" % i, partition=1,
                          on_delivery=lambda e, m: fast.append(
                              time.monotonic() - t0))
            deadline = time.monotonic() + 10
            while len(fast) < 20 and time.monotonic() < deadline:
                p.poll(0.05)
            fast_ok = len(fast) == 20 and max(fast) < 2.0
            assert p.flush(15.0) == 0
            deadline = time.monotonic() + 5
            while len(slow) < 20 and time.monotonic() < deadline:
                p.poll(0.05)
            return fast_ok, len(slow), min(slow) >= 2.0
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == (True, 20, True)


def test_close_is_idempotent_and_releases():
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"cl": 1})
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 2}))
        try:
            p.produce("cl", value=b"x", partition=0)
            assert p.flush(10.0) == 0
        finally:
            p.close()
            p.close()                  # a second close is a no-op
            cluster.stop()
        return cluster.partition("cl", 0).end_offset
    port, ref = both(scenario)
    assert port == ref == 1


def test_close_with_pending_messages_flushes_first():
    """close() flushes what lingers (linger.ms 3 s) before it returns."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"cl2": 1})
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 3000}))
        try:
            for i in range(10):
                p.produce("cl2", value=b"p%d" % i, partition=0)
            p.close()
            return log_values(pkg, cluster, "cl2")
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [b"p%d" % i for i in range(10)]
