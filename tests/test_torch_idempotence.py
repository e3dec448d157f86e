"""Mirrors of test_0090_idempotence (exactly-once, in-order logs under
retriable errors and lost responses; the fatal head-of-line gap),
test_0094_msg_timeout (unknown partitions, message timeouts over every
queue, retry backoff) and test_0086_purge (in-queue and in-flight purge)
on the port.

Every produce crosses the codec, so the port's producers run
``compression.backend=gpu, gpu.device=cpu`` (``test_torch_txn.GPU``) and
the JAX package's the reference case's conf.  Each scenario runs on both
packages on the same input, concurrently (``both``) or, where the case
times a request in flight, one after the other (``each``); the port's
result must equal the reference's and the reference test's expectation.
"""
import time

import pytest

from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.protocol.msgset import iter_batches, parse_records_v2

from test_torch_txn import PORT, REF, both


def each(scenario, *args):
    """``scenario`` on the port, then on the JAX package."""
    return scenario(PORT, *args), scenario(REF, *args)


def _producer(pkg, **extra):
    return pkg.Producer(pkg.conf({
        "bootstrap.servers": "", "test.mock.num.brokers": 1, "linger.ms": 2,
        "batch.num.messages": 50, **extra}))


def _log_values(cluster, topic, part, check_seq=True):
    """A partition's record values; with ``check_seq`` every batch carries
    a producer id and base sequences run on without a gap."""
    out, last_seq = [], None
    for _base, blob in cluster.partition(topic, part).log:
        for info, payload, _full in iter_batches(bytes(blob)):
            if info.codec:
                payload = native.lz4_decompress(payload)
            if check_seq:
                assert info.producer_id >= 1 and info.base_sequence >= 0
                if last_seq is not None:
                    assert info.base_sequence == last_seq, "sequence gap"
                last_seq = info.base_sequence + info.record_count
            out.extend(r.value for r in parse_records_v2(info, payload))
    return out


def _drs(p, drs):
    p._rk.conf.set("dr_msg_cb", lambda err, msg: drs.append(
        None if err is None else err.code.name))


# ------------------------------------------------------- test_0090 ------

@pytest.mark.parametrize("parts", [1, 4])
def test_idempotent_exactly_once_in_order(parts):
    """Every record once, in order, sequences independent per partition."""
    n = 1000 if parts == 1 else 300

    def scenario(pkg):
        p = _producer(pkg, **{"enable.idempotence": True})
        try:
            for i in range(n):
                p.produce("eos", value=b"p%05d" % i, partition=i % parts)
            assert p.flush(30.0) == 0
            return [_log_values(p._rk.mock_cluster, "eos", q)
                    for q in range(parts)]
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref == [[b"p%05d" % i for i in range(n) if i % parts == q]
                           for q in range(parts)]


@pytest.mark.parametrize("errors,n", [
    # rejected before the append: retried with the same sequence
    (("NOT_LEADER_FOR_PARTITION", "LEADER_NOT_AVAILABLE"), 500),
    # appended, response lost: DUPLICATE_SEQUENCE_NUMBER is success
    (("REQUEST_TIMED_OUT",), 200)])
def test_idempotent_retries_no_dup_no_gap(errors, n):
    def scenario(pkg):
        p = _producer(pkg, **{"enable.idempotence": True})
        try:
            drs = []
            _drs(p, drs)
            cluster = p._rk.mock_cluster
            p.produce("eos", value=b"warm", partition=0)
            assert p.flush(30.0) == 0
            cluster.push_request_errors(pkg.proto.ApiKey.Produce,
                                        [pkg.Err[e] for e in errors])
            for i in range(n):
                p.produce("eos", value=b"r%05d" % i, partition=0)
            assert p.flush(60.0) == 0
            return [_log_values(cluster, "eos", 0), set(drs)]
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref == [[b"warm"] + [b"r%05d" % i for i in range(n)],
                           {None}]


def test_idempotent_head_of_line_gap_is_fatal():
    """A head-of-line sequence gap is fatal (no drain and bump): error
    DRs, nothing duplicated, produce() refused afterwards."""
    def scenario(pkg):
        p = _producer(pkg, **{"enable.idempotence": True})
        try:
            drs = []
            _drs(p, drs)
            cluster = p._rk.mock_cluster
            p.produce("eos", value=b"warm", partition=0)
            assert p.flush(30.0) == 0
            part = cluster.partition("eos", 0)
            with cluster._lock:
                for key in list(part.pid_seqs):
                    part.pid_seqs[key] = 0
            for i in range(100):
                p.produce("eos", value=b"g%05d" % i, partition=0)
            assert p.flush(60.0) == 0
            try:
                p.produce("eos", value=b"after-fatal", partition=0)
                refused = False
            except pkg.KafkaException:
                refused = True
            return [set(drs[1:]), p._rk.fatal_error is not None,
                    _log_values(cluster, "eos", 0, check_seq=False),
                    refused]
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref == [{"OUT_OF_ORDER_SEQUENCE_NUMBER"}, True, [b"warm"],
                           True]


def test_idempotent_partial_batch_lost_response_membership_frozen():
    """A linger-expired partial batch whose response is lost is retried
    with its original membership, so no newer message is marked
    delivered without being appended."""
    def scenario(pkg):
        p = _producer(pkg, **{"enable.idempotence": True, "linger.ms": 30})
        try:
            drs = []
            _drs(p, drs)
            cluster = p._rk.mock_cluster
            p.produce("eos", value=b"warm", partition=0)
            assert p.flush(30.0) == 0
            cluster.push_request_errors(pkg.proto.ApiKey.Produce,
                                        [pkg.Err.REQUEST_TIMED_OUT])
            for i in range(30):
                p.produce("eos", value=b"a%05d" % i, partition=0)
            time.sleep(0.12)
            for i in range(40):
                p.produce("eos", value=b"b%05d" % i, partition=0)
            assert p.flush(60.0) == 0
            return [_log_values(cluster, "eos", 0), set(drs)]
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref == [[b"warm"] + [b"a%05d" % i for i in range(30)]
                           + [b"b%05d" % i for i in range(40)], {None}]


# ------------------------------------------------------- test_0094 ------

def test_unknown_partition_fails_parked_messages():
    """Produced to a partition that does not exist before metadata came:
    one _UNKNOWN_PARTITION DR once the count is known."""
    def scenario(pkg):
        p = _producer(pkg)
        try:
            drs = []
            _drs(p, drs)
            p.produce("nopart", value=b"x", partition=99)
            assert p.flush(10.0) == 0
            return drs
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref == ["_UNKNOWN_PARTITION"]


def test_unknown_partition_fails_fast_when_count_known():
    def scenario(pkg):
        p = _producer(pkg)
        try:
            p.produce("t", value=b"ok", partition=0)
            assert p.flush(10.0) == 0
            with pytest.raises(pkg.KafkaException) as ei:
                p.produce("t", value=b"x", partition=99)
            return [ei.value.error.code.name, p._rk.msg_cnt]
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref == ["_UNKNOWN_PARTITION", 0]


def test_msg_timeout_expires_retry_batches_broker_down():
    """With the broker down and a retry batch frozen, every message gets
    _MSG_TIMED_OUT within message.timeout.ms and flush() returns."""
    def scenario(pkg):
        p = _producer(pkg, **{"message.timeout.ms": 2500,
                              "enable.idempotence": True,
                              "message.send.max.retries": 10000,
                              "retry.backoff.ms": 1000})
        try:
            drs = []
            _drs(p, drs)
            cluster = p._rk.mock_cluster
            p.produce("tmo", value=b"warm", partition=0)
            assert p.flush(10.0) == 0
            cluster.push_request_errors(pkg.proto.ApiKey.Produce,
                                        [pkg.Err.REQUEST_TIMED_OUT])
            for i in range(20):
                p.produce("tmo", value=b"m%d" % i, partition=0)
            time.sleep(0.2)
            cluster.set_broker_down(1)
            t0 = time.monotonic()
            assert p.flush(30.0) == 0
            took = time.monotonic() - t0
            cluster.set_broker_down(1, False)
            return [drs[1:], took < 15.0]
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref == [["_MSG_TIMED_OUT"] * 20, True]


def test_retry_backoff_is_honored():
    """Three injected errors at retry.backoff.ms=200: delivery takes at
    least about three backoffs."""
    def scenario(pkg):
        p = _producer(pkg, **{"retry.backoff.ms": 200,
                              "message.send.max.retries": 10})
        try:
            p.produce("bk", value=b"warm", partition=0)
            assert p.flush(10.0) == 0
            p._rk.mock_cluster.push_request_errors(
                pkg.proto.ApiKey.Produce, [pkg.Err.REQUEST_TIMED_OUT] * 3)
            t0 = time.monotonic()
            p.produce("bk", value=b"retry-me", partition=0)
            assert p.flush(15.0) == 0
            return time.monotonic() - t0 >= 0.55
        finally:
            p.close()
    assert both(scenario) == (True, True)


# ------------------------------------------------------- test_0086 ------

def test_purge_in_queue_covers_all_tiers():
    """An in-queue purge drains the queues and the unknown-topic parking:
    _PURGE_QUEUE DRs, queue accounting back to 0."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"pq": 1})
        drs = []
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 60000,
            "dr_msg_cb": lambda e, m: drs.append(e)}))
        try:
            for i in range(10):
                p.produce("pq", value=b"q%d" % i, partition=0)
            p.produce("unknown-topic-parked", value=b"ua")
            time.sleep(0.3)
            p.purge(in_queue=True, in_flight=False)
            assert p.flush(10.0) == 0
            deadline = time.monotonic() + 5
            while len(drs) < 11 and time.monotonic() < deadline:
                p.poll(0.1)
            errs = [e.code.name for e in drs if e is not None]
            return [len(errs) >= 10, set(errs[:10]),
                    p._rk.msg_cnt, p._rk.msg_bytes]
        finally:
            p.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True, {"_PURGE_QUEUE"}, 0, 0]


def test_purge_in_flight():
    """A ProduceRequest held in flight by a choked socket, then purged:
    _PURGE_INFLIGHT DRs and a prompt flush()."""
    def scenario(pkg):
        from importlib import import_module
        sockem = import_module(("librdkafka_tpu_torch" if pkg.port
                                else "librdkafka_tpu") + ".mock.sockem")
        em = sockem.Sockem()
        cluster = pkg.MockCluster(num_brokers=1, topics={"pf": 1})
        drs = []
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "connect_cb": em.connect_cb, "linger.ms": 2,
            "message.timeout.ms": 120000,
            "dr_msg_cb": lambda e, m: drs.append(e)}))
        try:
            p.produce("pf", value=b"warm", partition=0)
            assert p.flush(10.0) == 0
            em.set(rate_bps=2000)
            for i in range(5):
                p.produce("pf", value=b"f%d" % i * 200, partition=0)
            time.sleep(0.6)
            t0 = time.monotonic()
            p.purge(in_queue=True, in_flight=True)
            assert p.flush(10.0) == 0
            fast = time.monotonic() - t0 < 5.0
            deadline = time.monotonic() + 5
            while len(drs) < 6 and time.monotonic() < deadline:
                p.poll(0.1)
            errs = {e.code.name for e in drs if e is not None}
            return [fast, errs <= {"_PURGE_QUEUE", "_PURGE_INFLIGHT"},
                    "_PURGE_INFLIGHT" in errs]
        finally:
            p.close()
            cluster.stop()
            em.kill_all()
    port, ref = each(scenario)
    assert port == ref == [True, True, True]
