"""Mirrors of test_0103_transactions (the transactional producer: FSM,
visibility, fencing, offsets in the transaction, abortable errors, purge,
stats) and test_0098_consumer_txn (read_committed filtering of a
synthesized transactional log) on the port.

Every case produces or fetches through the codec, so the port's clients
run ``compression.backend=gpu, gpu.device=cpu`` (the kernels' plain
versions; governor off, so every CRC job takes the device route) and the
JAX package's the reference case's conf.  Each scenario runs on both
packages on the same input, concurrently in two threads (``both``), and
the port's result must equal the reference's and the reference test's
expectation.  The helpers here (``PORT``, ``REF``, ``both``, ``consume``)
serve the other mirror files too.
"""
import json
import struct
import threading
import time
from types import SimpleNamespace

import pytest

import librdkafka_tpu as _ref
import librdkafka_tpu_torch as _port
import torch_port_only as port_only
from librdkafka_tpu.client import conf as _ref_conf
from librdkafka_tpu.client import consumer as _ref_consumer
from librdkafka_tpu.client import errors as _ref_errors
from librdkafka_tpu.mock import cluster as _ref_cluster
from librdkafka_tpu.protocol import msgset as _ref_msgset
from librdkafka_tpu.protocol import proto as _ref_proto
from librdkafka_tpu_torch.client import conf as _port_conf
from librdkafka_tpu_torch.client import consumer as _port_consumer
from librdkafka_tpu_torch.client import errors as _port_errors
from librdkafka_tpu_torch.mock import cluster as _port_cluster
from librdkafka_tpu_torch.protocol import msgset as _port_msgset
from librdkafka_tpu_torch.protocol import proto as _port_proto

#: the port's codec keys: the GPU backend on the plain versions, every
#: CRC job on the device route
GPU = {"compression.backend": "gpu", "gpu.device": "cpu",
       "gpu.governor": False, "gpu.launch.min.batches": 1}


def _pkg(port, client, conf, consumer, errors, cluster, msgset, proto):
    return SimpleNamespace(
        port=port, Producer=client.Producer, Consumer=client.Consumer,
        TopicPartition=consumer.TopicPartition, Conf=conf.Conf,
        Err=errors.Err, KafkaException=errors.KafkaException,
        MockCluster=cluster.MockCluster, GroupMember=cluster.GroupMember,
        MockGroup=cluster.MockGroup, msgset=msgset, proto=proto,
        conf=(lambda d: {**d, **GPU}) if port else dict)


PORT = _pkg(True, _port, _port_conf, _port_consumer, _port_errors,
            _port_cluster, _port_msgset, _port_proto)
REF = _pkg(False, _ref, _ref_conf, _ref_consumer, _ref_errors,
           _ref_cluster, _ref_msgset, _ref_proto)


def both(scenario, *args):
    """``scenario(pkg, *args)`` on the port and on the JAX package, in two
    threads at once; returns (port result, reference result) and raises
    the first failure of either."""
    out, errs = {}, {}

    def run(pkg):
        try:
            out[pkg.port] = scenario(pkg, *args)
        except BaseException as e:         # re-raised on the test thread
            errs[pkg.port] = e
    ths = [threading.Thread(target=run, args=(pkg,), name=f"mirror-{i}")
           for i, pkg in enumerate((PORT, REF))]
    for th in ths:
        th.start()
    for th in ths:
        th.join(120)
    assert not any(th.is_alive() for th in ths), "a scenario hung"
    for side in (True, False):
        if side in errs:
            raise errs[side]
    return out[True], out[False]


def consume(c, n: int, timeout: float = 20.0, quiet: float = 0.3) -> list:
    """Poll until ``n`` records came (then ``quiet`` s more, to catch any
    extra) or ``timeout``; returns the records' values.  With ``n == 0``,
    waits for an assignment, then polls ``quiet`` s."""
    got = []
    deadline = time.monotonic() + timeout
    if n == 0:
        while not c.assignment() and time.monotonic() < deadline:
            c.poll(0.05)
    stop = None if n else time.monotonic() + quiet
    while time.monotonic() < (stop or deadline):
        m = c.poll(0.05)
        if m is not None and m.error is None:
            got.append(m.value)
        if stop is None and len(got) >= n:
            stop = time.monotonic() + quiet
    return got


def _consume_all(pkg, cluster, isolation, n, topic="txn", quiet=0.3):
    c = pkg.Consumer(pkg.conf({
        "bootstrap.servers": cluster.bootstrap_servers(),
        "group.id": f"g-{isolation}-{time.monotonic_ns()}",
        "auto.offset.reset": "earliest", "isolation.level": isolation}))
    try:
        c.subscribe([topic])
        return consume(c, n, quiet=quiet)
    finally:
        c.close()


def _cluster(pkg):
    return pkg.MockCluster(num_brokers=3, topics={"txn": 2, "src": 1})


def _txn_producer(pkg, cluster, tid, **extra):
    return pkg.Producer(pkg.conf({
        "bootstrap.servers": cluster.bootstrap_servers(),
        "transactional.id": tid, "linger.ms": 2, **extra}))


# ------------------------------------------------------------ visibility --

def _commit(pkg, cluster, p):
    p.init_transactions(30)
    p.begin_transaction()
    p.produce("txn", b"c-0", partition=0)
    p.produce("txn", b"c-1", partition=0)
    p.commit_transaction(30)
    p.close()
    return [_consume_all(pkg, cluster, "read_committed", 2),
            _consume_all(pkg, cluster, "read_uncommitted", 2)]


def _abort(pkg, cluster, p):
    p.init_transactions(30)
    p.begin_transaction()
    for i in range(3):
        p.produce("txn", b"a-%d" % i, partition=0)
    assert p.flush(15) == 0
    p.abort_transaction(30)
    p.begin_transaction()
    p.produce("txn", b"after", partition=0)
    p.commit_transaction(30)
    p.close()
    return [_consume_all(pkg, cluster, "read_committed", 1),
            _consume_all(pkg, cluster, "read_uncommitted", 4)]


def _open(pkg, cluster, p):
    p.init_transactions(30)
    p.begin_transaction()
    p.produce("txn", b"open-0", partition=0)
    assert p.flush(15) == 0
    before = _consume_all(pkg, cluster, "read_committed", 0, quiet=1.0)
    p.commit_transaction(30)
    p.close()
    return [before, _consume_all(pkg, cluster, "read_committed", 1)]


def _reinit(pkg, cluster, p1):
    p1.init_transactions(30)
    p1.begin_transaction()
    p1.produce("txn", b"dangling", partition=0)
    assert p1.flush(15) == 0
    p2 = _txn_producer(pkg, cluster, "tx-vis")
    p2.init_transactions(30)
    p2.begin_transaction()
    p2.produce("txn", b"takeover", partition=0)
    p2.commit_transaction(30)
    p2.close()
    p1.close(2)
    return [_consume_all(pkg, cluster, "read_committed", 1)]


VISIBILITY = {
    # committed records only; control records never delivered
    "commit": (_commit, [[b"c-0", b"c-1"], [b"c-0", b"c-1"]]),
    # flushed then aborted: invisible to read_committed, visible (with
    # the ABORT marker suppressed) to read_uncommitted; the next
    # transaction of the same producer is not shadowed
    "abort": (_abort, [[b"after"], [b"a-0", b"a-1", b"a-2", b"after"]]),
    # LSO: an open transaction's data is invisible before any marker
    "open": (_open, [[], [b"open-0"]]),
    # a producer dying mid-transaction: the next init_transactions of
    # its id aborts the dangling transaction
    "interrupted": (_reinit, [[b"takeover"]]),
}


@pytest.mark.parametrize("case", list(VISIBILITY))
def test_transaction_visibility(case):
    flow, want = VISIBILITY[case]

    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            return flow(pkg, cluster, _txn_producer(pkg, cluster, "tx-vis"))
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == want


def test_zombie_fencing():
    """A second instance of a transactional.id bumps the epoch and fences
    the first: PRODUCER_FENCED, fatal, and produce() refused after it."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            p1 = _txn_producer(pkg, cluster, "tx-zombie")
            p1.init_transactions(30)
            e1, pid1 = p1.rk.txnmgr.epoch, p1.rk.txnmgr.pid
            p2 = _txn_producer(pkg, cluster, "tx-zombie")
            p2.init_transactions(30)
            out = [p2.rk.txnmgr.pid == pid1, p2.rk.txnmgr.epoch - e1]
            p1.begin_transaction()
            p1.produce("txn", b"zombie", partition=0)
            with pytest.raises(pkg.KafkaException) as ei:
                p1.commit_transaction(15)
            out += [p1.rk.fatal_error.code.name,
                    ei.value.error.fatal
                    or ei.value.error.code == pkg.Err.PRODUCER_FENCED]
            with pytest.raises(pkg.KafkaException):
                p1.produce("txn", b"more", partition=0)
            p1.close(2)
            p2.begin_transaction()
            p2.produce("txn", b"fresh", partition=0)
            p2.commit_transaction(30)
            p2.close()
            return out + [_consume_all(pkg, cluster, "read_committed", 1)]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True, 1, "PRODUCER_FENCED", True, [b"fresh"]]


@pytest.mark.parametrize("md", ["group_id", "consumer_group_metadata"])
def test_send_offsets_to_transaction(md):
    """AddOffsetsToTxn + TxnOffsetCommit: the offsets land in the group
    with the commit, not before, and an abort discards them; the group
    may be named by id or by a Consumer's consumer_group_metadata()."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        c = None
        try:
            group = "grp-eos"
            if md == "consumer_group_metadata":
                c = pkg.Consumer(pkg.conf({
                    "bootstrap.servers": cluster.bootstrap_servers(),
                    "group.id": group, "auto.offset.reset": "earliest"}))
                c.subscribe(["src"])
                group = c.consumer_group_metadata()
                assert group.group_id == "grp-eos"
            p = _txn_producer(pkg, cluster, "tx-offsets")
            p.init_transactions(30)
            p.begin_transaction()
            p.produce("txn", b"v", partition=0)
            p.send_offsets_to_transaction(
                [pkg.TopicPartition("src", 0, 42, metadata="m1")], group, 30)
            g = cluster.groups.get("grp-eos")
            staged = None if g is None else g.offsets.get(("src", 0))
            p.commit_transaction(30)
            committed = cluster.groups["grp-eos"].offsets[("src", 0)]
            p.begin_transaction()
            p.produce("txn", b"v2", partition=0)
            p.send_offsets_to_transaction(
                [pkg.TopicPartition("src", 0, 99)], group, 30)
            p.abort_transaction(30)
            after_abort = cluster.groups["grp-eos"].offsets[("src", 0)]
            p.close()
            return [staged, committed, after_abort]
        finally:
            if c is not None:
                c.close()
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [None, (42, "m1"), (42, "m1")]


def test_state_machine_guards():
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            p = _txn_producer(pkg, cluster, "tx-fsm")
            codes = []
            for step in (p.begin_transaction,
                         lambda: p.init_transactions(30),
                         lambda: p.produce("txn", b"x", partition=0),
                         lambda: p.commit_transaction(5),
                         p.begin_transaction, p.begin_transaction,
                         lambda: p.commit_transaction(30)):
                try:
                    step()
                    codes.append(None)
                except pkg.KafkaException as e:
                    codes.append(e.error.code.name)
            log = cluster.partition("txn", 0).log
            p.close()
            return codes + [log]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    # begin before init, produce outside and commit without a
    # transaction, a double begin; an empty transaction writes nothing
    assert port == ref == ["_STATE", None, "_STATE", "_STATE", None,
                           "_STATE", None, []]


@pytest.mark.parametrize("case", ["no_transactional_id", "oversize_timeout"])
def test_init_transactions_refused(case):
    """Without a transactional.id the API is _NOT_IMPLEMENTED; a
    transaction.timeout.ms over the broker's maximum fails
    init_transactions with INVALID_TRANSACTION_TIMEOUT."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            if case == "no_transactional_id":
                p = pkg.Producer(pkg.conf(
                    {"bootstrap.servers": cluster.bootstrap_servers()}))
            else:
                p = _txn_producer(pkg, cluster, "tx-tmo",
                                  **{"transaction.timeout.ms": 1000000})
            try:
                p.init_transactions(15)
            except pkg.KafkaException as e:
                return e.error.code.name
            finally:
                p.close(2)
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == {"no_transactional_id": "_NOT_IMPLEMENTED",
                           "oversize_timeout":
                               "INVALID_TRANSACTION_TIMEOUT"}[case]


def test_conf_validated_at_set_time():
    """transactional.id and transaction.timeout.ms are checked at set()
    time, and a transactional.id implies idempotence."""
    def scenario(pkg):
        c = pkg.Conf()
        out = []
        for k, v in (("transactional.id", "ok-id"),
                     ("transactional.id", "x" * 250),
                     ("transactional.id", "bad\x00id"),
                     ("transaction.timeout.ms", 10),
                     ("transaction.timeout.ms", 60000)):
            try:
                c.set(k, v)
                out.append(True)
            except pkg.KafkaException:
                out.append(False)
        cluster = pkg.MockCluster(num_brokers=1, topics={"txn": 1})
        try:
            p = _txn_producer(pkg, cluster, "tx-implied")
            out += [p.rk.idemp is not None, p.rk.txnmgr is not None]
            p.close()
        finally:
            cluster.stop()
        return out
    port, ref = both(scenario)
    assert port == ref == [True, False, False, False, True, True, True]


def test_failed_message_makes_txn_abortable():
    """A message failing inside the transaction parks the FSM in
    ABORTABLE_ERROR: commit refuses, abort recovers, the next
    transaction commits."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            p = _txn_producer(pkg, cluster, "tx-abortable",
                              **{"message.send.max.retries": 0})
            p.init_transactions(30)
            p.begin_transaction()
            cluster.push_request_errors(pkg.proto.ApiKey.Produce,
                                        [pkg.Err.INVALID_MSG])
            p.produce("txn", b"doomed", partition=0)
            assert p.flush(15) == 0
            with pytest.raises(pkg.KafkaException) as ei:
                p.commit_transaction(15)
            out = [ei.value.error.code.name, p.rk.txnmgr.state]
            p.abort_transaction(30)
            out.append(p.rk.txnmgr.state)
            p.begin_transaction()
            p.produce("txn", b"recovered", partition=0)
            p.commit_transaction(30)
            p.close()
            return out + [_consume_all(pkg, cluster, "read_committed", 1)]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == ["_STATE", "ABORTABLE_ERROR", "READY",
                           [b"recovered"]]


def test_unflushed_abort_purges_queued_messages():
    """An abort without a flush purges the queued messages: their DRs
    carry _PURGE_QUEUE and neither data nor a marker reaches the log."""
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            drs = []
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "transactional.id": "tx-purge", "linger.ms": 5000,
                "dr_msg_cb": lambda e, m: drs.append(e)}))
            p.init_transactions(30)
            p.begin_transaction()
            p.produce("txn", b"never-sent", partition=0)
            p.abort_transaction(30)
            p.poll(1.0)
            log = cluster.partition("txn", 0).log
            p.close()
            return [[e.code.name if e is not None else None for e in drs],
                    log]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [["_PURGE_QUEUE"], []]


def test_stats_blob_carries_txn_state():
    def scenario(pkg):
        cluster = _cluster(pkg)
        try:
            blobs = []
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "transactional.id": "tx-stats", "linger.ms": 2,
                "statistics.interval.ms": 100,
                "stats_cb": lambda js: blobs.append(json.loads(js))}))
            p.init_transactions(30)
            p.begin_transaction()
            p.produce("txn", b"s", partition=0)
            p.commit_transaction(30)
            # a blob begun after the commit: the first one appended after
            # it may have been built while the commit returned
            n0 = len(blobs)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and len(blobs) <= n0 + 1:
                p.poll(0.1)
            p.close()
            eos = blobs[-1]["eos"]
            if pkg.port:
                # the port's own transaction counters (CPU_ACCOUNTING.md)
                # aside, after checking them
                assert eos["txn_begins"] == eos["txn_commits"] == 1
                assert eos["txn_aborts"] == 0
                assert eos["txn_commit_wall_ns"] > 0
                assert eos["txn_cpu_ns"] == 0          # untraced
                eos = port_only.strip_stats({"eos": eos})["eos"]
            return [sorted(eos), eos["txn_state"] in (
                "READY", "IN_TXN", "COMMITTING"), eos["transactional_id"],
                eos["producer_id"] >= 0 and eos["producer_epoch"] >= 0]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref
    assert port[1:] == [True, "tx-stats", True]
    assert {"txn_registered_partitions", "txn_coordinator"} <= set(port[0])


# ------------------------------------------------- test_0098 (consumer) --

def _batch(pkg, msgs, *, base_offset, pid=-1, transactional=False,
           control=False, ctrl_type=None):
    """A v2 batch blob, transactional or control (test_0098's _batch)."""
    proto, msgset = pkg.proto, pkg.msgset
    now = 1_700_000_000_000
    if control:
        msgs = [msgset.Record(offset=0, timestamp=now,
                              key=struct.pack(">hh", 0, ctrl_type),
                              value=b"")]
    w = msgset.MsgsetWriterV2(base_offset=base_offset, producer_id=pid,
                              transactional=transactional)
    blob = bytearray(w.write_batch(msgs, now))
    if control:
        attrs = struct.unpack_from(">h", blob, proto.V2_OF_Attributes)[0]
        struct.pack_into(">h", blob, proto.V2_OF_Attributes,
                         attrs | proto.ATTR_CONTROL)
        struct.pack_into(">I", blob, proto.V2_OF_CRC, msgset.crc32c(
            bytes(blob[proto.V2_OF_Attributes:])))
    return bytes(blob)


def _recs(pkg, vals, ts=1_700_000_000_000):
    return [pkg.msgset.Record(offset=i, timestamp=ts, key=None, value=v)
            for i, v in enumerate(vals)]


def _txn_log(pkg):
    """test_0098's log: plain, committed (pid 9), aborted (pid 7), plain,
    with the markers a broker writes and the aborted range."""
    c = pkg.MockCluster(num_brokers=1, topics={"txn": 1})
    part = c.partition("txn", 0)
    CTRL = pkg.proto
    for blob in (
            _batch(pkg, _recs(pkg, [b"plain-0", b"plain-1"]), base_offset=0),
            _batch(pkg, _recs(pkg, [b"committed-0", b"committed-1"]),
                   base_offset=2, pid=9, transactional=True),
            _batch(pkg, [], base_offset=4, pid=9, transactional=True,
                   control=True, ctrl_type=CTRL.CTRL_COMMIT),
            _batch(pkg, _recs(pkg, [b"aborted-0", b"aborted-1",
                                    b"aborted-2"]),
                   base_offset=5, pid=7, transactional=True),
            _batch(pkg, [], base_offset=8, pid=7, transactional=True,
                   control=True, ctrl_type=CTRL.CTRL_ABORT),
            _batch(pkg, _recs(pkg, [b"tail-0"]), base_offset=9)):
        part.append(blob)
    part.aborted = [{"producer_id": 7, "first_offset": 5, "last_offset": 8}]
    return c


@pytest.mark.parametrize("isolation,want", [
    ("read_committed", [b"plain-0", b"plain-1", b"committed-0",
                        b"committed-1", b"tail-0"]),
    ("read_uncommitted", [b"plain-0", b"plain-1", b"committed-0",
                          b"committed-1", b"aborted-0", b"aborted-1",
                          b"aborted-2", b"tail-0"])])
def test_consumer_txn_filtering(isolation, want):
    """Batches listed as aborted are invisible under read_committed,
    control records never delivered; read_uncommitted sees every data
    record.  The synthesized log's blobs are equal in both packages."""
    def scenario(pkg):
        cluster = _txn_log(pkg)
        try:
            blobs = [bytes(b) for _o, b in cluster.partition("txn", 0).log]
            return [blobs, _consume_all(pkg, cluster, isolation, len(want))]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref
    assert port[1] == want
