"""Mirrors of test_0091_stress (application threads x broker threads x
the codec pipeline x rebalancing consumers x broker bounces: no message
lost, none duplicated, the accounting drained) on the port, and
chip_smoke.py phase 14c (0091's concurrent producers, with a broker
killed and restarted midway, its two rebalancing check.crcs consumers,
0112's message.copy.max.bytes) on both packages at a small size.

Each case runs on the port and on the JAX package at once
(``test_torch_txn.both``), each against its own mock.  The port's
clients run ``compression.backend=gpu, gpu.device=cpu`` (the kernels'
plain versions, every CRC job on the device route; a retried idempotent
batch is rebuilt through it); the reference's run the reference test's
own conf.
"""
import threading
import time

from test_torch_latency import backend, kit
from test_torch_txn import both


def _log_values(pkg, cluster, topic, parts):
    from librdkafka_tpu_torch.ops import cpu
    vals = []
    for i in range(parts):
        for _base, blob in cluster.partition(topic, i).log:
            for info, payload, _full in pkg.msgset.iter_batches(blob):
                if info.codec:
                    payload = cpu.lz4_decompress(payload)
                vals += [r.value
                         for r in pkg.msgset.parse_records_v2(info, payload)]
    return vals


# ------------------------------------------------------------ test_0091 --

def test_multithreaded_producers_exactly_once():
    """4 app threads x 2000 msgs through one idempotent producer with the
    codec pipeline on: every message lands exactly once."""
    n_threads, per = 4, 2000

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=2, topics={"st": 8})
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "enable.idempotence": True, "compression.codec": "lz4",
            "linger.ms": 5}))
        errors = []

        def worker(tid):
            try:
                for i in range(per):
                    p.produce("st", value=b"t%d-%05d" % (tid, i),
                              partition=(tid * per + i) % 8)
            except Exception as e:
                errors.append(e)
        try:
            ths = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            assert not errors, errors
            assert p.flush(60.0) == 0
            drained = p._rk.msg_cnt == 0 and p._rk.msg_bytes == 0
        finally:
            p.close()
        try:
            return drained, sorted(_log_values(pkg, cluster, "st", 8))
        finally:
            cluster.stop()
    port, ref = both(scenario)
    expect = sorted(b"t%d-%05d" % (t, i) for t in range(n_threads)
                    for i in range(per))
    assert port == ref == (True, expect), "loss or duplication"


def test_produce_during_broker_bounce_no_duplication():
    """Produce continuously while a broker bounces down/up: idempotent
    retries deliver every message exactly once."""
    n = 3000

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"bounce": 2})
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "enable.idempotence": True, "message.send.max.retries": 10000,
            "retry.backoff.ms": 50, "message.timeout.ms": 60000,
            "compression.codec": "lz4", "linger.ms": 5}))
        stop = threading.Event()

        def bouncer():
            while not stop.is_set():
                time.sleep(0.4)
                cluster.set_broker_down(1)
                time.sleep(0.25)
                cluster.set_broker_down(1, down=False)
        bt = threading.Thread(target=bouncer)
        bt.start()
        try:
            for i in range(n):
                p.produce("bounce", value=b"b%05d" % i, partition=i % 2)
                if i % 500 == 0:
                    time.sleep(0.05)     # let the bounce interleave
        finally:
            stop.set()
            bt.join()
            cluster.set_broker_down(1, down=False)
        try:
            assert p.flush(90.0) == 0
        finally:
            p.close()
        try:
            return sorted(_log_values(pkg, cluster, "bounce", 2))
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [b"b%05d" % i for i in range(n)]


def test_two_consumers_rebalance_under_load():
    """A second consumer joins mid-consumption: across the rebalance
    every message is seen at least once, and the second consumer is
    assigned partitions."""
    n = 2000

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"rb": 4})
        try:
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "linger.ms": 2}))
            for i in range(n):
                p.produce("rb", value=b"r%05d" % i, partition=i % 4)
            assert p.flush(20.0) == 0
            p.close()
            seen, assigned = [], {1: 0, 2: 0}
            lock = threading.Lock()

            def consume(cid):
                c = pkg.Consumer(pkg.conf({
                    "bootstrap.servers": cluster.bootstrap_servers(),
                    "group.id": "grb", "auto.offset.reset": "earliest",
                    "session.timeout.ms": 30000}))
                c.subscribe(["rb"])
                deadline = time.monotonic() + 40
                idle = 0
                while time.monotonic() < deadline and idle < 12:
                    m = c.poll(0.25)
                    assigned[cid] = len(c.assignment())
                    if m is not None and m.error is None:
                        with lock:
                            seen.append(m.value)
                        idle = 0
                    else:
                        idle += 1
                c.close()
            c1 = threading.Thread(target=consume, args=(1,))
            c1.start()
            time.sleep(1.5)              # c1 mid-consumption
            c2 = threading.Thread(target=consume, args=(2,))
            c2.start()
            c1.join()
            c2.join()
            missing = {b"r%05d" % i for i in range(n)} - set(seen)
            return len(missing), assigned[2] >= 1
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == (0, True)


# ------------------------------------------- chip_smoke.py phase 14c --

def test_phase14c_load_on_both_packages():
    """chip_smoke.py 14c at 4 threads x 100 records over 8 partitions:
    exactly once with and without a broker killed and restarted midway
    (its requeued batches rebuilt through the device route), the two
    rebalancing consumers losing nothing, then 0112's
    message.copy.max.bytes through the CRC ticket.  14c's backpressure
    function runs in tests/test_torch_conf.py on each package's CPU
    provider, as 0112 does: with the plain versions a CRC ticket takes
    longer than 0112's 60 ms burst, so here the device route's codec
    pipeline, not the threshold, paces batch formation in both packages
    (on the card the ticket takes milliseconds, and phase 14c runs the
    case on the device route)."""
    import chip_smoke

    def scenario(pkg):
        k, gpu = kit(pkg), backend(pkg)
        load = chip_smoke.p14_load(k, gpu, "a", 4, 100, 8, "cpu", "cpu")
        return sorted(load), chip_smoke.p14_copy_max(k, gpu, "a")
    port, ref = both(scenario)
    assert port == ref == (["crc_rows", "lz4_rows"], 1)
