"""Mirrors of test_0100_broker_version (the feature map, legacy produce and
consume at each broker version and magic, modern v2), test_0114's
version sweep (every version x codec cell, a few records each) and
test_0118's ``test_mixed_msgver_log`` on the port.

Each case runs one scenario on the port (``compression.backend=gpu,
gpu.device=cpu``: the consumer's ``check.crcs`` verify of every legacy
message goes through ``crc32_submit`` on the kernels' plain versions) and
on the JAX package (``cpu``), at once in two threads, each against its
own mock emulating the broker version.  A MsgVer1 compression wrapper
carries the producer's wall clock, so each case pins both packages'
``client/broker.py`` ``time.time``; the stored messages then compare byte
for byte, with the records read back and their offsets.  The port's mock
gives MsgVer0/1 messages a broker's offsets where the reference's keeps
the producer's (``test_legacy_offsets_across_produce_requests``), so the
offset fields of legacy messages compare apart.
"""
import time

import pytest

from test_torch_client import guarded_thread
from test_torch_delivery import mod
from test_torch_eos import _Clock
from test_torch_txn import PORT, REF, both
from torch_leakguard import no_new_threads

NOW_MS = 1_700_000_000_000
VERSIONS = ["0.8.2", "0.9.0", "0.10.0", "0.10.2", "0.11.0", "1.0.0",
            "2.3.0"]
MAGIC = {"0.8.2": 0, "0.9.0": 0, "0.10.0": 1, "0.10.2": 1,
         "0.11.0": 2, "1.0.0": 2, "2.3.0": 2}
#: consumer groups arrived with 0.9: 0114 reads no group on 0.8.x
GROUPLESS = {"0.8.2"}


@pytest.fixture(autouse=True)
def _no_thread_left():
    with no_new_threads(guarded_thread):
        yield


@pytest.fixture
def pinned(monkeypatch):
    """Both packages' broker threads write MsgVer0/1 wrappers at NOW_MS."""
    for pkg in (PORT, REF):
        monkeypatch.setattr(mod(pkg, "client.broker"), "time",
                            _Clock(NOW_MS / 1000))


def blobs_of(cluster, topic: str, part: int = 0) -> list:
    return [bytes(b) for _o, b in cluster.partition(topic, part).log]


def split_offsets(pkg, blobs: list) -> tuple:
    """A stored log as (its messages without their offset fields, the
    offsets): each MsgVer0/1 top-level message as (CRC, CRC region) and
    its offset; a v2 batch whole (both mocks patch its base offset)."""
    msgs, offsets = [], []
    for blob in blobs:
        if blob[16] == 2:
            msgs.append(blob)
            continue
        for off, crc, region in pkg.msgset.iter_legacy_crc_regions(blob):
            msgs.append((crc, bytes(region)))
            offsets.append(off)
    return msgs, offsets


def assert_stored_equal(port: dict, ref: dict, n: int, codec: str) -> None:
    """The port's stored messages are the reference's byte for byte but
    for their offsets, which are a broker's: a plain message its own, a
    wrapper its last inner message's (n - 1, one wrapper a request).  The
    reference's mock keeps the producer's, which differ for a MsgVer0
    wrapper only (0; ROADMAP queue 3)."""
    (pm, po), (rm, ro) = port["stored"], ref["stored"]
    assert pm == rm
    if port["magic"] == [2]:
        return
    broker = list(range(n)) if codec == "none" else [n - 1]
    assert po == broker
    assert ro == ([0] if codec != "none" and port["magic"] == [0]
                  else broker)


def read(pkg, cluster, topic: str, bver: str, n: int, group: str) -> list:
    """``n`` records through a check.crcs group consumer at ``bver``:
    (offset, key, value) in order."""
    c = pkg.Consumer(pkg.conf({
        "bootstrap.servers": cluster.bootstrap_servers(),
        "broker.version.fallback": bver, "group.id": group,
        "auto.offset.reset": "earliest", "check.crcs": True}))
    got = []
    try:
        c.subscribe([topic])
        deadline = time.monotonic() + 25
        while len(got) < n:
            assert time.monotonic() < deadline, got
            m = c.poll(0.3)
            if m is not None and m.error is None:
                got.append((m.offset, m.key, m.value))
        if pkg.port:
            # every CRC (crc32 for MsgVer0/1) went through the engine
            assert_device_route(c)
    finally:
        c.close()
    return got


def assert_device_route(client) -> None:
    """The port client's engine launched and routed no job to the CPU."""
    st = client._rk.codec_provider._engine.stats
    assert st["launches"] > 0, st
    assert not any(st[k] for k in ("warmup_miss_jobs", "routed_cpu_jobs",
                                   "cpu_fallback_jobs")), st


def roundtrip(pkg, bver: str, codec: str, n: int, topic: str,
              value: bytes, group: bool = True) -> dict:
    """0100's and 0114's round: ``n`` keyed records at ``bver`` with
    ``codec``, then a group consumer reads them back."""
    cluster = pkg.MockCluster(num_brokers=1, topics={topic: 1},
                              broker_version=bver)
    try:
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "broker.version.fallback": bver, "compression.codec": codec,
            "linger.ms": 1000, "batch.num.messages": n}))
        try:
            for i in range(n):
                p.produce(topic, value=value % i, key=b"k%d" % i,
                          partition=0, timestamp=NOW_MS + i)
            assert p.flush(20.0) == 0
        finally:
            p.close()
        blobs = blobs_of(cluster, topic)
        out = {"stored": split_offsets(pkg, blobs),
               "magic": sorted({b[16] for b in blobs})}
        if group:
            out["read"] = read(pkg, cluster, topic, bver, n,
                               f"g-{bver}-{codec}")
        return out
    finally:
        cluster.stop()


# ------------------------------------------------------------ test_0100 --

def test_feature_map():
    def features(pkg):
        f = mod(pkg, "client.feature")
        return {v: sorted(f.features_from_api_versions(
            f.fallback_api_versions(v))) for v in VERSIONS + ["2.0.0"]}
    port, ref = features(PORT), features(REF)
    assert port == ref
    assert {"MSGVER2", "MSGVER1", "IDEMPOTENT_PRODUCER"} <= set(port["2.0.0"])
    assert "MSGVER1" in port["0.10.0"] and "MSGVER2" not in port["0.10.0"]
    assert not {"MSGVER1", "MSGVER2"} & set(port["0.9.0"])
    assert {"BROKER_BALANCED_CONSUMER", "THROTTLETIME"} <= set(port["0.9.0"])
    assert "BROKER_BALANCED_CONSUMER" not in port["0.8.2"]


@pytest.mark.parametrize("bver,magic", [("0.9.0", 0), ("0.10.0", 1)])
def test_produce_consume_legacy_broker(pinned, bver, magic):
    """A pre-0.11 mock (ApiVersions closes the connection below 0.10):
    gzip MsgVer0/1 wrappers on the wire, read back by the consumer."""
    port, ref = both(lambda pkg: roundtrip(pkg, bver, "gzip", 40, "old",
                                           b"legacy-%02d"))
    assert_stored_equal(port, ref, 40, "gzip")
    assert port["read"] == ref["read"]
    assert port["magic"] == ref["magic"] == [magic]
    assert sorted(r[1:] for r in port["read"]) == sorted(
        (b"k%d" % i, b"legacy-%02d" % i) for i in range(40))


def test_modern_broker_still_uses_v2():
    def scenario(pkg):
        p = pkg.Producer(pkg.conf({"bootstrap.servers": "",
                                   "test.mock.num.brokers": 1,
                                   "linger.ms": 2}))
        try:
            p.produce("new", value=b"modern", partition=0,
                      timestamp=NOW_MS)
            assert p.flush(10.0) == 0
            blob = p._rk.mock_cluster.partition("new", 0).log[0][1]
            b = next(iter(p._rk.brokers.values()))
            return bytes(blob), "MSGVER2" in b.features
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref and port[0][16] == 2 and port[1]


# ------------------------------------------------------------ test_0114 --

@pytest.mark.parametrize("codec", ["none", "gzip"])
@pytest.mark.parametrize("bver", VERSIONS)
def test_version_sweep(pinned, bver, codec):
    port, ref = both(lambda pkg: roundtrip(
        pkg, bver, codec, 12, "sw", b"sweep-%03d",
        group=bver not in GROUPLESS))
    assert_stored_equal(port, ref, 12, codec)
    assert port.get("read") == ref.get("read")
    assert port["magic"] == ref["magic"] == [MAGIC[bver]]
    if bver not in GROUPLESS:
        assert [r[1:] for r in port["read"]] == [
            (b"k%d" % i, b"sweep-%03d" % i) for i in range(12)]


# ------------------------------------------------------------ test_0118 --

def test_mixed_msgver_log():
    """A partition log of a MsgVer1 run then v2 batches (0092's shape) is
    read end to end with check.crcs: the legacy run through the CRC
    seam's crc32, the v2 run inline on the host, in both packages."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"bh": 2})
        try:
            legacy = pkg.msgset.write_msgset_v01(
                [pkg.msgset.Record(key=b"k%d" % i, value=b"old-%d" % i,
                                   timestamp=1_690_000_000_000)
                 for i in range(3)], magic=1, codec=None,
                now_ms=1_690_000_000_000)
            cluster.partition("bh", 1).append(legacy)
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "linger.ms": 1000, "batch.num.messages": 3}))
            try:
                for i in range(3):
                    p.produce("bh", value=b"new-%d" % i, partition=1,
                              timestamp=NOW_MS + i)
                assert p.flush(10.0) == 0
            finally:
                p.close()
            blobs = blobs_of(cluster, "bh", 1)
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "gmix", "auto.offset.reset": "earliest",
                "check.crcs": True}))
            got = []
            try:
                c.subscribe(["bh"])
                deadline = time.monotonic() + 15
                while len(got) < 6:
                    assert time.monotonic() < deadline, got
                    m = c.poll(0.2)
                    if m is not None and m.error is None \
                            and m.partition == 1:
                        got.append((m.offset, m.value))
                if pkg.port:
                    assert_device_route(c)
            finally:
                c.close()
            return blobs, got
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref
    assert port[1] == list(enumerate([b"old-0", b"old-1", b"old-2",
                                      b"new-0", b"new-1", b"new-2"]))


@pytest.mark.parametrize("bver,magic", [("0.9.0", 0), ("0.10.2", 1)])
def test_legacy_offsets_across_produce_requests(pinned, bver, magic):
    """Two gzip MsgVer0/1 ProduceRequests to one partition: the port's
    mock assigns a broker's offsets (a wrapper at its last inner message,
    MsgVer0's inner set renumbered from the request's base), so the log
    ends at 2n and a check.crcs GPU consumer reads every record once with
    offsets 0..2n-1.  The reference's mock stores the producer's offsets
    and counts a wrapper as one message: its log ends at 2 and the
    second request repeats offsets 0..n-1 (ROADMAP queue 3)."""
    n = 20

    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"old": 1},
                                  broker_version=bver)
        try:
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "broker.version.fallback": bver, "compression.codec": "gzip",
                "linger.ms": 1000, "batch.num.messages": n}))
            try:
                for r in range(2):
                    for i in range(n):
                        p.produce("old", value=b"r%d-%02d" % (r, i),
                                  key=b"k", partition=0,
                                  timestamp=NOW_MS + i)
                    assert p.flush(20.0) == 0
            finally:
                p.close()
            part = cluster.partition("old", 0)
            out = {"end": part.end_offset,
                   "offsets": split_offsets(pkg, blobs_of(cluster, "old"))[1]}
            if pkg.port:
                out["read"] = read(pkg, cluster, "old", bver, 2 * n, "g2")
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port["end"] == 2 * n and port["offsets"] == [n - 1, 2 * n - 1]
    assert [r[0] for r in port["read"]] == list(range(2 * n))
    assert [r[2] for r in port["read"]] == [b"r%d-%02d" % (r, i)
                                            for r in range(2) for i in range(n)]
    assert ref["end"] == 2
    assert ref["offsets"] == ([0, 0] if magic == 0 else [n - 1, n - 1])
