"""The exactly-once copy (``chip_smoke.py`` phase 10's loop: ``eos_seed``,
``eos_copy``, ``eos_read``) held against the JAX package on the CPU.

An idempotent producer seeds eos-in (8 partitions x 100 records of
64-1,024 B from a numpy seed, keyed by the record's global index); two
copier members, each a read_committed cooperative-sticky group consumer
and a transactional producer, copy it to eos-out in transactions of 25
records, every 3rd flushed and aborted (the member then seeks back to
its committed offsets), and one member leaves midway.  The same copy runs
on the port (``compression.backend=gpu, gpu.device=cpu``: the CRC-ticket
leg and the device compress leg, on the kernels' plain versions) and on
the JAX package (``tpu`` with jax on the CPU, and ``cpu``).  In every case
a read_committed consumer reads each input record exactly once (so no
aborted record is visible, though the aborted batches are in the log),
the group's committed offsets are the input's ends, and the port's
records and offsets equal the reference's.

The one-member case (one partition, no rebalance, 25 records a
transaction, 500 B values, fixed ``batch.num.messages``, explicit
timestamps) compares
the stored eos-out blobs, data and control batches, byte for byte.  The
mocks write a control batch's timestamp from the wall clock, so that
case pins both mocks' ``time.time``; no field is masked.

The values are incompressible 4-bit noise, so whether a data batch
compresses depends on how many records the fetch timing puts in it: a
batch of one record is stored uncompressed (the writer keeps lz4 only
where it shrinks the records, in both packages), and ``eos_stored``
holds such a batch to that rule (the last case here pins it).
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as eos
from librdkafka_tpu import Consumer as RefConsumer
from librdkafka_tpu import Producer as RefProducer
from librdkafka_tpu.client.consumer import TopicPartition as RefTP
from librdkafka_tpu.mock import cluster as ref_cluster
from librdkafka_tpu_torch.mock import cluster as port_cluster
from librdkafka_tpu_torch.protocol.msgset import iter_batches
from torch_leakguard import no_new_threads

PARTS, PER, TXN, ABORT_EVERY = 8, 100, 25, 3

REF = SimpleNamespace(Producer=RefProducer, Consumer=RefConsumer,
                      TopicPartition=RefTP, MockCluster=ref_cluster.MockCluster)
PORT_GPU = {"compression.backend": "gpu", "gpu.device": "cpu",
            "gpu.governor": False, "gpu.launch.min.batches": 1}
REF_TPU = {"compression.backend": "tpu", "tpu.governor": False,
           "tpu.launch.min.batches": 1, "tpu.transport.min.mb.s": 0}
#: the port's two legs: the CRC tickets, the device compress route
LEGS = {"a": {}, "b": {"gpu.compress.device": True}}


def guarded_thread(name: str) -> bool:
    """A copier, engine or broker thread: none that a test starts may
    outlive it."""
    return "engine" in name or name.startswith(("eos-copier", "rdk:broker/"))


@pytest.fixture(autouse=True)
def _no_copier_left():
    """No copier, engine or port broker thread that the test started
    outlives it (``torch_leakguard.no_new_threads``)."""
    with no_new_threads(guarded_thread):
        yield


def _values(parts=PARTS, per=PER, size=None):
    """Seeded values of 64-1,024 B (or ``size`` B each)."""
    rng = np.random.default_rng(10)
    return [[rng.integers(0, 16, size or int(rng.integers(64, 1025)))
             .astype(np.uint8).tobytes() for _ in range(per)]
            for _ in range(parts)]


def _copy(kit, backend: dict, extra: dict, det=None) -> dict:
    """Seed, copy (two members, one leaving midway) and read back on one
    mock; the read records as a sorted multiset, the committed offsets,
    the stored batches (their lz4 frames held to the native encoder when
    ``det`` is not None) and the copiers."""
    vals = _values()
    cluster = kit.MockCluster(num_brokers=1,
                              topics={eos.EOS_IN: PARTS, eos.EOS_OUT: PARTS})
    try:
        boot = cluster.bootstrap_servers()
        eos.eos_seed(kit, boot, vals, backend)
        hwm = {i: cluster.partition(eos.EOS_IN, i).end_offset
               for i in range(PARTS)}
        assert hwm == {i: PER for i in range(PARTS)}
        # all members at once: a slow first transaction (the JAX
        # package's jit compiles) must not meet a revoke
        res = eos.eos_copy(kit, "t", boot, hwm, backend, extra, members=2,
                           txn_records=TXN, abort_every=ABORT_EVERY,
                           leaver=1, stagger=False, timeout=120)
        read = eos.eos_read(kit, boot, backend, PARTS, PARTS * PER, "t")
        g = cluster.groups["eos-copy-t"]
        stored_records = 0
        for i in range(PARTS):
            for _base, blob in cluster.partition(eos.EOS_OUT, i).log:
                for info, _payload, _full in iter_batches(blob):
                    if not info.is_control:
                        stored_records += info.record_count
        return {"vals": vals, "hwm": hwm, "res": res,
                "records": sorted(r[:3] for r in read["records"]),
                "read": read["records"],
                "committed": {q: g.offsets[(eos.EOS_IN, q)][0] for q in hwm},
                "stored": eos.eos_stored(cluster, PARTS, det=det),
                "stored_records": stored_records}
    finally:
        cluster.stop()


def _exactly_once(run: dict) -> None:
    eos.eos_exactly_once(run["vals"], run["read"])
    assert run["committed"] == run["hwm"]
    copiers = run["res"]["copiers"]
    assert all(c.aborts >= 1 for c in copiers), [c.aborts for c in copiers]
    # the aborted transactions' batches are in the log and stay unread
    assert run["stored"]["abort"] >= sum(c.aborts for c in copiers)
    assert run["stored_records"] > PARTS * PER
    assert len(run["read"]) == PARTS * PER


@pytest.fixture(scope="module")
def reference():
    """The JAX package's copy on its two backends."""
    return {"tpu": _copy(REF, REF_TPU, {}),
            "cpu": _copy(REF, {"compression.backend": "cpu"}, {})}


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_reference_copy_is_exactly_once(reference, backend):
    _exactly_once(reference[backend])


@pytest.mark.parametrize("leg", list(LEGS))
def test_port_copy_is_exactly_once_and_equals_reference(reference, leg):
    # leg b's frames are the deterministic encoder's, leg a's the default
    port = _copy(eos.port_kit(), PORT_GPU, LEGS[leg], det=leg == "b")
    _exactly_once(port)
    for ref in reference.values():
        assert port["records"] == ref["records"]
        assert port["committed"] == ref["committed"]
    for c in port["res"]["copiers"]:
        ce, pe = c.engines["consumer"], c.engines["producer"]
        assert ce["stats"]["launches"] > 0
        for snap in (ce, pe):
            assert not any(snap["stats"][k] for k in (
                "warmup_miss_jobs", "routed_cpu_jobs", "cpu_fallback_jobs"))
        if LEGS[leg]:
            # a leaving member's close() leaves the others' route warm
            assert pe["compress"]["launches"] > 0
            assert not any(pe["compress"][k] for k in (
                "cpu_jobs", "warmup_miss_jobs", "routed_cpu_jobs"))
            assert pe["stats"]["launches"] == c.engines["producer_crc0"]


class _Clock:
    """``time`` with ``time()`` pinned (a control batch's timestamp)."""

    def __init__(self, t: float):
        self._t = t

    def time(self) -> float:
        return self._t

    def __getattr__(self, name):
        return getattr(time, name)


def test_one_member_copy_blobs_equal_reference(monkeypatch):
    """The port's CRC-ticket leg writes the bytes of the reference's CPU
    backend (leg b's frames are held to the deterministic encoder in the
    test above)."""
    for mod in (port_cluster, ref_cluster):
        monkeypatch.setattr(mod, "time", _Clock(eos.NOW_MS / 1000))
    vals = _values(parts=1, size=500)
    blobs = []
    for kit, backend in ((eos.port_kit(), PORT_GPU),
                         (REF, {"compression.backend": "cpu"})):
        cluster = kit.MockCluster(num_brokers=1,
                                  topics={eos.EOS_IN: 1, eos.EOS_OUT: 1})
        try:
            boot = cluster.bootstrap_servers()
            eos.eos_seed(kit, boot, vals, backend)
            res = eos.eos_copy(
                kit, "det", boot, {0: PER}, backend,
                {"linger.ms": 1000, "batch.num.messages": TXN},
                members=1, txn_records=TXN, abort_every=ABORT_EVERY,
                leaver=None, exact=True, timeout=120)
            assert [(c.commits, c.aborts) for c in res["copiers"]] == \
                [(PER // TXN, 1)]
            blobs.append([bytes(b) for _base, b in
                          cluster.partition(eos.EOS_OUT, 0).log])
        finally:
            cluster.stop()
    port, ref = blobs
    kinds = [info.is_control for b in port for info, _p, _f in
             iter_batches(b)]
    assert kinds.count(True) == PER // TXN + 1        # markers
    assert kinds.count(False) == PER // TXN + 1       # data, aborted one too
    assert port == ref


def test_position_after_seek_equals_reference():
    """What the copy loop relies on: position() names the offset after
    the last record delivered, and a seek() does not move it (only the
    next delivery does), in the port as in the JAX package.  So after an
    abort-and-rewind the loop sends the positions of the partitions a
    transaction read, never of the whole assignment."""
    from test_torch_txn import both
    from librdkafka_tpu_torch.protocol.proto import OFFSET_BEGINNING

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"pos": 1})
        try:
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers()}))
            for i in range(10):
                p.produce("pos", value=b"r%d" % i, partition=0)
            assert p.flush(10) == 0
            p.close()
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "pos", "auto.offset.reset": "earliest"}))
            tp = pkg.TopicPartition("pos", 0, OFFSET_BEGINNING)
            c.assign([tp])
            got = []
            deadline = time.monotonic() + 15
            while len(got) < 10 and time.monotonic() < deadline:
                got += [m.offset for m in c.consume(10 - len(got), 0.2)]
            out = [got, c.position([tp])[0].offset]
            c.seek(pkg.TopicPartition("pos", 0, 4))
            out.append(c.position([tp])[0].offset)
            m = None
            while m is None and time.monotonic() < deadline:
                m = c.poll(0.2)
            out += [m.offset, c.position([tp])[0].offset]
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [list(range(10)), 10, 10, 4, 5]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_uncompressed_batch_held_to_the_writers_rule(pkg):
    """What made the copy above fail under load: a transaction that
    carries one record of incompressible 4-bit values to a partition
    writes a batch that lz4 cannot shrink, and the writer stores it
    uncompressed (both packages).  ``eos_stored`` accepts such a batch
    and counts it ``plain``; it rejects an uncompressed batch whose
    records lz4 shrinks."""
    kit, backend = ((eos.port_kit(), PORT_GPU) if pkg == "port"
                    else (REF, {"compression.backend": "cpu"}))
    noise = _values(parts=1, per=1, size=300)[0][0]
    for codec, value, plain_ok in (("lz4", noise, True),
                                   ("none", b"compressible " * 40, False)):
        cluster = kit.MockCluster(num_brokers=1, topics={eos.EOS_OUT: 1})
        try:
            p = kit.Producer({"bootstrap.servers":
                              cluster.bootstrap_servers(),
                              "transactional.id": f"plain-{pkg}-{codec}",
                              "compression.codec": codec, **backend})
            try:
                p.init_transactions(30)
                p.begin_transaction()
                p.produce(eos.EOS_OUT, value=value, partition=0)
                p.commit_transaction(30)
            finally:
                p.close()
            if plain_ok:
                stored = eos.eos_stored(cluster, 1, det=False)
                assert stored == {"data": 1, "commit": 1, "abort": 0,
                                  "plain": 1}
            else:
                with pytest.raises(eos.EosError, match="lz4 shrinks"):
                    eos.eos_stored(cluster, 1, det=False)
        finally:
            cluster.stop()
