"""The port's client layer and mock cluster held against the JAX package's.

The drive recipe (Producer -> in-process mock broker -> Consumer with
check.crcs) runs through the port with ``compression.backend=cpu`` and with
``compression.backend=gpu, gpu.device=cpu`` (the kernels' plain PyTorch
versions) on both GPU routes: the CRC tickets and the device compress route
(``gpu.compress.device``).  With ``batch.num.messages`` fixing the batch
boundaries and explicit timestamps, the blobs the mock stores equal the
reference Producer's byte for byte: the CRC-ticket route the reference's
``backend=cpu`` bytes, the device compress route the reference's device
compress route (its deterministic lz4 spec).  Every record comes back.

Mirrors: the stats key tree (test_0053), ticketed fetch verify (0021, 0108),
legacy CRC regions (0113), the mock's basics (0009), test_0135's conf,
end-to-end and QoS flood cases with ``gpu.*`` keys, one transactional round
trip, and the lazily imported modules.  An autouse fixture holds the port's
own registries to the conftest's leak contract.
"""
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

import torch_port_only as port_only
from librdkafka_tpu import Producer as RefProducer
from librdkafka_tpu.client import conf as ref_conf
from librdkafka_tpu.mock.cluster import MockCluster as RefMock
from librdkafka_tpu.protocol import apis as ref_apis
from librdkafka_tpu.protocol.proto import ApiKey as RefApiKey
from librdkafka_tpu_torch import Consumer, Producer
from librdkafka_tpu_torch.client import conf as port_conf_mod
from librdkafka_tpu_torch.client.consumer import TopicPartition
from librdkafka_tpu_torch.client.errors import Err, KafkaException
from librdkafka_tpu_torch.mock.cluster import MockCluster
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.ops import lz4_torch
from librdkafka_tpu_torch.protocol import apis, proto
from librdkafka_tpu_torch.protocol.msgset import (MsgsetWriterV2, Record,
                                                  iter_batches,
                                                  iter_legacy_crc_regions,
                                                  parse_records_v2,
                                                  verify_crc_v2)
from librdkafka_tpu_torch.protocol.proto import OFFSET_BEGINNING, ApiKey
from torch_leakguard import no_new_threads

NOW_MS = 1_700_000_000_000

#: JAX-package conf keys with no counterpart in the port
NO_TWIN = ("tpu.compile.cache.dir",)


def port_conf(ref: dict, device: str = "cpu") -> dict:
    """The port's conf for a reference conf dict: ``tpu`` becomes ``gpu``,
    each ``tpu.*`` key its ``gpu.*`` twin, the keys without a counterpart
    are dropped, and the GPU backend runs on ``device``."""
    out = {}
    for k, v in ref.items():
        if k in NO_TWIN:
            continue
        if k.startswith("tpu."):
            k = "gpu." + k[len("tpu."):]
        elif k == "compression.backend" and v == "tpu":
            v = "gpu"
        out[k] = v
    if out.get("compression.backend") == "gpu":
        out.setdefault("gpu.device", device)
    return out


# ------------------------------------------------------------ leak guard --

_PORT_THREADS = ("sockem-", "mock-cluster", "rdk:broker/", "gpu-codec-")


def guarded_thread(name: str) -> bool:
    """An engine, sockem, mock or broker thread of the port."""
    return "engine" in name or name.startswith(_PORT_THREADS)


@pytest.fixture(autouse=True)
def _port_leak_guard():
    """The conftest's leak contract for the port's own registries: no
    engine, sockem, mock or broker thread that the test started outlives
    it (``torch_leakguard.no_new_threads``), no stats-emit timer stays
    registered, and the port's tracer and metrics registry end disabled
    and empty."""
    with no_new_threads(guarded_thread):
        yield
    from librdkafka_tpu_torch.client.stats import _ACTIVE_STATS_TIMERS
    from librdkafka_tpu_torch.obs import metrics, trace
    assert not _ACTIVE_STATS_TIMERS, "a port client's stats timer leaked"
    assert not trace.enabled and trace.active_ring_count() == 0
    assert not metrics.enabled and metrics.registered_count() == 0


# -------------------------------------------------------------- conf map --

def test_conf_gpu_knobs_twin_the_tpu_knobs():
    ref = {p.name: p for p in ref_conf.PROPERTIES if p.scope == "global"}
    port = {p.name: p for p in port_conf_mod.PROPERTIES
            if p.scope == "global"}
    twins = [n for n in ref if n.startswith("tpu.") and n not in NO_TWIN]
    assert len(twins) == 10
    for name in twins:
        r, g = ref[name], port["gpu." + name[len("tpu."):]]
        assert (g.ptype, g.default, g.vmin, g.vmax, g.app, g.enum) == (
            r.ptype, r.default, r.vmin, r.vmax, r.app, r.enum), name
    assert not [n for n in port if n.startswith("tpu.")]
    # every other row is the reference's, the backend enum aside
    assert set(port) - {"gpu." + n[4:] for n in twins} == \
        set(ref) - set(twins) - set(NO_TWIN) | {"gpu.device"}
    c = port_conf_mod.Conf()
    assert c.get("compression.backend") == "cpu"
    assert c.get("gpu.device") == "cuda"
    c.set("compression.backend", "gpu")
    for bad in (("compression.backend", "tpu"), ("gpu.device", "tpu"),
                ("gpu.device", "cuda:x"), ("tpu.governor", False)):
        with pytest.raises(KafkaException):
            c.set(*bad)
    for ok in ("cpu", "cuda", "cuda:1"):
        c.set("gpu.device", ok)
    assert port_conf({"compression.backend": "tpu", "tpu.governor": False,
                      "tpu.mesh.devices": 2, "tpu.compile.cache.dir": "/x",
                      "linger.ms": 5}) == {
        "compression.backend": "gpu", "gpu.governor": False,
        "gpu.mesh.devices": 2, "linger.ms": 5, "gpu.device": "cpu"}


def test_qos_weight_conf_roundtrip():
    """test_0135 :296 — topic.qos.weight: a topic-scope float row with
    range validation, and the global-conf fallthrough."""
    tc = port_conf_mod.TopicConf()
    assert tc.get("topic.qos.weight") == 1.0
    tc.set("topic.qos.weight", "8.5")
    assert tc.get("topic.qos.weight") == 8.5
    with pytest.raises(KafkaException):
        tc.set("topic.qos.weight", 0.0)
    with pytest.raises(KafkaException):
        tc.set("topic.qos.weight", 1e6)
    c = port_conf_mod.Conf()
    c.set("topic.qos.weight", 2.5)
    assert c.get("default_topic_conf").get("topic.qos.weight") == 2.5


# ------------------------------------------------- drive recipe, bytes --

ROUTES = {
    "cpu": ({"compression.backend": "cpu"}, {"compression.backend": "cpu"}),
    # the CRC tickets: the reference's default backend=cpu is the oracle
    "gpu-crc": ({"compression.backend": "tpu", "tpu.governor": False,
                 "tpu.launch.min.batches": 1},
                {"compression.backend": "cpu"}),
    # the device compress route: the reference's own device route (its
    # deterministic lz4 spec) is the oracle
    "gpu-compress": ({"compression.backend": "tpu", "tpu.governor": False,
                      "tpu.launch.min.batches": 1,
                      "tpu.compress.device": True},
                     {"compression.backend": "tpu", "tpu.governor": False,
                      "tpu.launch.min.batches": 1, "tpu.warmup": False,
                      "tpu.transport.min.mb.s": 0,
                      "tpu.compress.device": True}),
}
PARTS, PER_PART, BATCH = 3, 40, 20


def _values():
    rng = np.random.default_rng(6)
    return [[b"p%d-r%03d " % (i, j) * int(rng.integers(5, 40))
             for j in range(PER_PART)] for i in range(PARTS)]


def _produce(make, conf: dict, vals) -> list[list[bytes]]:
    """Produce every record with an explicit partition, key and
    timestamp through ``make(conf)`` on its own mock; returns each
    partition's stored blobs."""
    p = make({"bootstrap.servers": "", "test.mock.num.brokers": 1,
              "test.mock.default.partitions": PARTS,
              "enable.idempotence": True, "compression.codec": "lz4",
              "linger.ms": 1000, "batch.num.messages": BATCH, **conf})
    try:
        for j in range(PER_PART):
            for i in range(PARTS):
                p.produce("drive", value=vals[i][j], key=b"k%d" % i,
                          partition=i, timestamp=NOW_MS + j)
        assert p.flush(120) == 0
        mc = p._rk.mock_cluster
        return [[bytes(b) for _base, b in mc.partition("drive", i).log]
                for i in range(PARTS)]
    finally:
        p.close()


@pytest.mark.parametrize("route", list(ROUTES))
def test_drive_recipe_wire_equals_reference(route):
    port_side, ref_side = ROUTES[route]
    vals = _values()
    want = _produce(RefProducer, ref_side, vals)
    got = _produce(Producer, port_conf(port_side), vals)
    nbatches = [sum(1 for b in part for _ in iter_batches(b)) for part in got]
    assert nbatches == [PER_PART // BATCH] * PARTS
    assert got == want


@pytest.mark.parametrize("route", list(ROUTES))
def test_drive_recipe_round_trip_check_crcs(route):
    """The drive recipe end to end: produce on the route, consume with
    check.crcs on the same backend; the stored batches verify and every
    partition's records come back in order.  On the GPU routes the
    producer's and the consumer's engines served every job (no CPU
    route)."""
    conf = port_conf(ROUTES[route][0])
    vals = _values()
    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "test.mock.default.partitions": PARTS,
                  "compression.codec": "lz4", "linger.ms": 5, **conf})
    gpu = conf["compression.backend"] == "gpu"
    c = None
    try:
        if gpu:     # the route open before the counted jobs
            assert p._rk.codec_provider.wait_warm(120)
        for j in range(PER_PART):
            for i in range(PARTS):
                p.produce("rt", value=vals[i][j], key=b"k%d" % i,
                          partition=i)
        assert p.flush(120) == 0
        mc = p._rk.mock_cluster
        for i in range(PARTS):
            for _base, blob in mc.partition("rt", i).log:
                for info, _payload, full in iter_batches(blob):
                    assert verify_crc_v2(info, full)
        c = Consumer({"bootstrap.servers": mc.bootstrap_servers(),
                      "group.id": "rt", "auto.offset.reset": "earliest",
                      "check.crcs": True, **conf})
        if gpu:
            assert c._rk.codec_provider.wait_warm(120)
        c.assign([TopicPartition("rt", i, OFFSET_BEGINNING)
                  for i in range(PARTS)])
        got = [[] for _ in range(PARTS)]
        deadline = time.monotonic() + 60
        while sum(map(len, got)) < PARTS * PER_PART:
            assert time.monotonic() < deadline, "consumer stalled"
            for m in c.consume(PARTS * PER_PART - sum(map(len, got)), 1.0):
                assert m.error is None, m.error
                got[m.partition].append(m.value)
        assert got == vals
        if gpu:
            for rk in (p._rk, c._rk):
                eng = rk.codec_provider._engine
                assert not any(eng.stats[k] for k in (
                    "warmup_miss_jobs", "routed_cpu_jobs",
                    "cpu_fallback_jobs")), eng.stats
            ceng = c._rk.codec_provider._engine
            assert ceng.stats["launches"] > 0
            peng = p._rk.codec_provider._engine
            if "gpu.compress.device" in conf:
                assert peng.compress_stats["launches"] > 0
                assert peng.compress_stats["fused_crc"] > 0
            else:
                assert peng.stats["launches"] > 0
    finally:
        if c is not None:
            c.close()
        p.close()


# ----------------------------------------------------------- stats tree --

def _tree(x, key=""):
    """The key tree of a stats blob: leaves become None, a list is the
    tree of its first element, broker names lose their mock's port, and
    the maps keyed by data (launch buckets by size, per-device maps by
    the device count: the JAX package's tests run eight CPU devices)
    keep no keys."""
    if isinstance(x, dict):
        if key in ("dev_launch_ms", "launch_dev"):
            return {"*": None}
        return {k.split(":")[0] if key == "brokers" else k: _tree(v, k)
                for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(x[0], key)] if x else []
    return None


def _tree_diff(a, b, path="") -> list[str]:
    """The paths where key trees ``a`` (port) and ``b`` (reference)
    differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b), key=str):
            if k not in b or k not in a:
                out.append(f"{path}/{k} only in {'port' if k in a else 'ref'}")
            else:
                out += _tree_diff(a[k], b[k], f"{path}/{k}")
        return out
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_stats_key_tree_equals_reference(backend):
    """test_0053's stats cross-check: for the same conf (mapped), the
    port's stats blob has the reference's key tree, codec_engine and
    its governor, devices and compress sections included."""
    conf = {"bootstrap.servers": "", "test.mock.num.brokers": 1,
            "compression.backend": backend, "compression.codec": "lz4",
            "linger.ms": 2, "enable.idempotence": True,
            "tpu.transport.min.mb.s": 0, "tpu.launch.min.batches": 1,
            "tpu.governor": False}
    blobs = []
    for make, c in ((RefProducer, conf), (Producer, port_conf(conf))):
        p = make(c)
        try:
            for i in range(40):
                p.produce("st", value=b"v%d" % i * 40, partition=i % 2)
            assert p.flush(120) == 0
            blobs.append(json.loads(p._rk.stats.emit_json()))
        finally:
            p.close()
    ref, port = blobs
    assert ("codec_engine" in port) == ("codec_engine" in ref) == (
        backend == "tpu")
    # the port's own stats fields (CPU_ACCOUNTING.md) aside
    assert _tree_diff(port_only.strip_stats(_tree(port)), _tree(ref)) == []


# ---------------------------------------------------- fetch verify -----

@pytest.fixture
def fv_cluster():
    c = MockCluster(num_brokers=1, topics={"fv": 3})
    yield c
    c.stop()


GPU = {"compression.backend": "gpu", "gpu.device": "cpu",
       "gpu.governor": False, "gpu.launch.min.batches": 1}


def _fv_produce(cluster, n, codec="lz4", parts=3):
    p = Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                  "linger.ms": 5, "compression.codec": codec})
    try:
        for i in range(n):
            p.produce("fv", value=b"fetch-%04d-" % i * 20, key=b"k%d" % i,
                      partition=i % parts)
        assert p.flush(30.0) == 0
    finally:
        p.close()


def test_crc_mismatch_through_gpu_ticket_errs_and_backs_off(fv_cluster):
    """0021: a flipped byte verified through the GPU provider's ticketed
    fetch verify: _BAD_MSG via error_cb, a fetch backoff of at most
    0.5 s, and nothing delivered."""
    _fv_produce(fv_cluster, 10, codec="none", parts=1)
    part = fv_cluster.partition("fv", 0)
    base, blob = part.log[0]
    corrupt = bytearray(blob)
    corrupt[proto.V2_HEADER_SIZE + 2] ^= 0xFF
    part.log[0] = (base, bytes(corrupt))
    errs = []
    c = Consumer({"bootstrap.servers": fv_cluster.bootstrap_servers(),
                  "group.id": "gtcrc", "auto.offset.reset": "earliest",
                  "check.crcs": True, "error_cb": errs.append, **GPU})
    try:
        c.subscribe(["fv"])
        got = []
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not errs:
            m = c.poll(0.3)
            if m is not None and m.error is None:
                got.append(m)
        tp = c._rk.get_toppar("fv", 0, create=False)
        backoff_left = (tp.fetch_backoff_until - time.monotonic()
                        if tp is not None else -1.0)
        eng = c._rk.codec_provider._engine
        assert eng is not None and eng.stats["jobs"] > 0
    finally:
        c.close()
    assert any(e.code == Err._BAD_MSG for e in errs), errs
    assert not got, "corrupted batch must not be delivered"
    assert 0.0 < backoff_left <= 0.5, backoff_left


def test_fetch_pipeline_tickets_multi_partition(fv_cluster):
    """0108 / 0021: a multi-partition lz4 fetch through the GPU provider
    with gpu.fetch.pipeline.depth=2 parks CRC and decompress tickets on
    the engine and delivers the same records, in partition order, as the
    CPU backend."""
    _fv_produce(fv_cluster, 150)
    out = {}
    for name, extra in (("cpu", {}),
                        ("gpu", {**GPU, "gpu.fetch.pipeline.depth": 2})):
        c = Consumer({"bootstrap.servers": fv_cluster.bootstrap_servers(),
                      "group.id": "gp-" + name, "check.crcs": True,
                      "auto.offset.reset": "earliest", **extra})
        try:
            c.assign([TopicPartition("fv", i, OFFSET_BEGINNING)
                      for i in range(3)])
            got = {i: [] for i in range(3)}
            deadline = time.monotonic() + 30
            while sum(map(len, got.values())) < 150:
                assert time.monotonic() < deadline
                for m in c.consume(150, 1.0):
                    assert m.error is None, m.error
                    got[m.partition].append((m.offset, m.key, m.value))
            out[name] = got
            if name == "gpu":
                eng = c._rk.codec_provider._engine
                assert eng.stats["launches"] > 0
                assert eng.stats["host_jobs"] > 0      # decompress jobs
                assert c._rk.fetch_pipeline_depth == 2
        finally:
            c.close()
    assert out["gpu"] == out["cpu"]
    assert [len(v) for v in out["cpu"].values()] == [50, 50, 50]


# ---------------------------------------------------- legacy CRC -------

def _legacy(mock):
    cluster = mock(num_brokers=1, topics={"old": 1}, broker_version="0.10.0")
    make = Producer if mock is MockCluster else RefProducer
    p = make({"bootstrap.servers": cluster.bootstrap_servers(),
              "broker.version.fallback": "0.10.0", "linger.ms": 5})
    try:
        for i in range(20):
            p.produce("old", value=b"legacy-%02d" % i, partition=0,
                      timestamp=NOW_MS + i)
        assert p.flush(30.0) == 0
    finally:
        p.close()
    return cluster


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "flipped"])
def test_legacy_crc_regions_and_gpu_verify(corrupt):
    """0113: the port's MsgVer1 producer stores the reference's bytes,
    whose legacy CRC regions both packages walk alike; a check.crcs GPU
    consumer verifies them through crc32 tickets, delivering every
    record, or reports _BAD_MSG for a flipped payload byte."""
    cluster, ref = _legacy(MockCluster), _legacy(RefMock)
    try:
        from librdkafka_tpu.protocol.msgset import \
            iter_legacy_crc_regions as ref_regions
        blobs = [b for _o, b in cluster.partition("old", 0).log]
        assert blobs == [b for _o, b in ref.partition("old", 0).log]
        regions = [r for b in blobs for r in iter_legacy_crc_regions(b)]
        assert regions == [r for b in blobs for r in ref_regions(b)]
        assert len(regions) == 20
        if corrupt:
            part = cluster.partition("old", 0)
            base, blob = part.log[0]
            bad = bytearray(blob)
            bad[-2] ^= 0xFF
            part.log[0] = (base, bytes(bad))
        errs = []
        c = Consumer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "broker.version.fallback": "0.10.0", "group.id": "gl",
                      "auto.offset.reset": "earliest", "check.crcs": True,
                      "error_cb": errs.append, **GPU})
        try:
            c.subscribe(["old"])
            got = []
            deadline = time.monotonic() + 20
            while (time.monotonic() < deadline and not errs
                   and len(got) < 20):
                m = c.poll(0.3)
                if m is not None and m.error is None:
                    got.append(m.value)
            assert c._rk.codec_provider._engine.stats["launches"] > 0
        finally:
            c.close()
        if corrupt:
            assert any(e.code == Err._BAD_MSG for e in errs), errs
            assert not got
        else:
            assert got == [b"legacy-%02d" % i for i in range(20)]
    finally:
        cluster.stop()
        ref.stop()


# --------------------------------------------------------- mock basics --

class _Raw:
    """A blocking protocol client: one request, one response."""

    def __init__(self, host_port: str, build, parse):
        host, port = host_port.split(":")
        self.sock = socket.create_connection((host, int(port)), timeout=5)
        self.build, self.parse, self.corrid = build, parse, 0

    def call(self, api, body: dict) -> dict:
        self.corrid += 1
        self.sock.sendall(self.build(api, self.corrid, "raw", body))
        (n,) = struct.unpack(">i", self._recvn(4))
        corrid, resp = self.parse(api, self._recvn(n))
        assert corrid == self.corrid
        return resp

    def _recvn(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("eof")
            out += chunk
        return out

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("codec", [None, "lz4", "snappy", "gzip"])
def test_mock_answers_like_the_reference(codec):
    """0009: the port's mock answers ApiVersions and Metadata as the
    reference's does (hosts and ports aside), and a produced v2 batch
    comes back from Fetch verbatim from both."""
    mocks = (MockCluster(num_brokers=3, topics={"t1": 4}),
             RefMock(num_brokers=3, topics={"t1": 4}))
    msgs = [Record(key=b"k%d" % i, value=b"payload-%d-" % i + b"z" * 100,
                   timestamp=NOW_MS + i) for i in range(17)]
    w = MsgsetWriterV2(codec=codec)
    wire = w.write_batch(msgs, NOW_MS, (lambda b: native.CODECS[codec][0](b))
                         if codec else None)
    seen = []
    try:
        for mock, ak, build, parse in (
                (mocks[0], ApiKey, apis.build_request, apis.parse_response),
                (mocks[1], RefApiKey, ref_apis.build_request,
                 ref_apis.parse_response)):
            part = mock.partition("t1", 0)
            addr = mock.bootstrap_servers().split(",")[part.leader - 1]
            c = _Raw(addr, build, parse)
            try:
                vers = c.call(ak.ApiVersions, {})
                md = c.call(ak.Metadata, {"topics": ["t1"]})
                for b in md["brokers"]:
                    b["port"] = 0
                pres = c.call(ak.Produce, {
                    "transactional_id": None, "acks": -1, "timeout": 5000,
                    "topics": [{"topic": "t1", "partitions": [
                        {"partition": 0, "records": wire}]}]})
                fres = c.call(ak.Fetch, {
                    "replica_id": -1, "max_wait_time": 1000, "min_bytes": 1,
                    "max_bytes": 1 << 20, "isolation_level": 1,
                    "topics": [{"topic": "t1", "partitions": [
                        {"partition": 0, "fetch_offset": 0,
                         "max_bytes": 1 << 20}]}]})
            finally:
                c.close()
            fpart = fres["topics"][0]["partitions"][0]
            fpart["records"] = bytes(fpart["records"])
            seen.append((vers, md, pres, fres))
    finally:
        for m in mocks:
            m.stop()
    assert seen[0] == seen[1]
    fpart = seen[0][3]["topics"][0]["partitions"][0]
    assert fpart["error_code"] == 0 and fpart["high_watermark"] == 17
    assert fpart["records"] == wire
    info, payload, full = next(iter_batches(fpart["records"]))
    assert verify_crc_v2(info, full)
    if info.codec:
        payload = native.CODECS[info.codec][1](payload, 0)
    assert [r.value for r in parse_records_v2(info, payload)] == \
        [m.value for m in msgs]


# ------------------------------------------------------------ test_0135 --

def test_e2e_device_route_roundtrip_and_stats():
    """test_0135 :400 with gpu.* keys: the producer's device compress
    route launches (the plain LZ4 version here), folds the batch CRCs,
    tallies the topic's QoS routing, and a CRC-checking consumer reads
    every record back."""
    p = Producer(port_conf({
        "bootstrap.servers": "", "test.mock.num.brokers": 1,
        "compression.backend": "tpu", "tpu.transport.min.mb.s": 0,
        "tpu.compress.device": True, "tpu.launch.min.batches": 1,
        "tpu.governor": False, "tpu.warmup": False,
        "compression.codec": "lz4", "linger.ms": 5}))
    n = 50
    vals = [(b"payload-%04d-" % i) * 40 for i in range(n)]
    try:
        for i, v in enumerate(vals):
            p.produce("devtp", value=v, key=b"k%d" % i)
        assert p.flush(120.0) == 0
        comp = json.loads(p._rk.stats.emit_json())["codec_engine"][
            "compress"]
        assert comp["launches"] >= 1, comp
        assert comp["fused_crc"] >= 1, comp
        assert comp["bytes_in"] > 0 and comp["bytes_out"] > 0, comp
        assert comp["qos"]["devtp"]["routed"] >= 1, comp
        c = Consumer({"bootstrap.servers":
                      p._rk.mock_cluster.bootstrap_servers(),
                      "group.id": "g-dev", "auto.offset.reset": "earliest",
                      "check.crcs": True})
        try:
            c.subscribe(["devtp"])
            got = {}
            deadline = time.time() + 30
            while len(got) < n and time.time() < deadline:
                m = c.poll(0.2)
                if m is not None and m.error is None:
                    got[bytes(m.key)] = bytes(m.value)
        finally:
            c.close()
        assert got == {b"k%d" % i: v for i, v in enumerate(vals)}
    finally:
        p.close()
    assert lz4_torch.device_kernel_count() == 0


def test_hot_topic_flood_qos_isolation():
    """test_0135 :448 with gpu.* keys (the JAX package's
    chaos.scenarios.hot_topic_flood, ported as the port's
    chaos.scenarios.hot_topic_flood, which runs it at full size): a
    weight-8 latency topic beside a zipf-sized weight-0.25 bulk flood
    through the device compress route with the governor and warmup on.
    Every latency message acks, the latency topic is routed to the
    device and never shed, both topics' weights reach the stats, and the
    bulk topic makes progress.

    On the CPU the route's "device" is the LZ4 kernel's plain version,
    40-100 ms a launch and run inside the dispatch thread: launches never
    overlap, a ping waits out whatever launch runs, and the lanes never
    read as saturated.  So the latency bound (flooded p99 within 3x the
    unloaded p99, floor 100 ms) is held on the card, at the reference's
    sizes, by tests/test_torch_gpu.py; here the bulk payloads are scaled
    by 1/100 (the reference's 2,000 B zipf becomes 20 B, at least 100 B,
    capped at 1,200 B) to keep the plain version's work small."""
    import random
    rng = random.Random(17)
    p = Producer(port_conf({
        "bootstrap.servers": "", "test.mock.num.brokers": 1,
        "compression.backend": "tpu", "tpu.transport.min.mb.s": 0,
        "tpu.compress.device": True, "tpu.launch.min.batches": 1,
        "tpu.governor": True, "tpu.warmup": True,
        "compression.codec": "lz4", "linger.ms": 2,
        "batch.num.messages": 32}))
    t0 = time.monotonic()
    lock = threading.Lock()
    lat_un, lat_fl, bulk_acked = [], [], [0]
    try:
        p._rk.set_topic_conf("qos-latency", {"topic.qos.weight": 8.0})
        p._rk.set_topic_conf("qos-bulk", {"topic.qos.weight": 0.25})

        def ping(sink):
            ts = time.perf_counter()

            def dr(err, _msg):
                if err is None:
                    with lock:
                        sink.append((time.perf_counter() - ts) * 1e3)
            p.produce("qos-latency", value=b"lat-ping " * 40,
                      on_delivery=dr)

        def bulk_dr(err, _msg):
            if err is None:
                with lock:
                    bulk_acked[0] += 1

        for _ in range(40):
            ping(lat_un)
            p.poll(0.01)
        p.flush(60)
        stop = threading.Event()

        def flood():
            while not stop.is_set():
                n = min(int(20 * (1.0 / (1.0 - rng.random()) ** 1.2)),
                        1_200)
                try:
                    p.produce("qos-bulk", value=b"\xa5" * max(n, 100),
                              on_delivery=bulk_dr)
                except BufferError:
                    time.sleep(0.002)
                time.sleep(0.0005)

        flooder = threading.Thread(target=flood, name="qos-flooder",
                                   daemon=True)
        flooder.start()
        t_end = time.monotonic() + 1.5
        while time.monotonic() < t_end:
            ping(lat_fl)
            p.poll(0.02)
        stop.set()
        flooder.join(10)
        assert not flooder.is_alive()
        assert p.flush(120) == 0
        comp = json.loads(p._rk.stats.emit_json())["codec_engine"][
            "compress"]
    finally:
        p.close()
    with lock:
        acked = len(lat_un) + len(lat_fl)
    assert acked == 40 + len(lat_fl) and len(lat_un) == 40 and lat_fl
    assert bulk_acked[0] > 0
    lat, bulk = comp["qos"]["qos-latency"], comp["qos"]["qos-bulk"]
    assert (lat["weight"], bulk["weight"]) == (8.0, 0.25), comp
    assert lat["routed"] > 0 and lat["shed"] == 0, comp
    assert bulk["routed"] + bulk["shed"] > 0, comp
    assert time.monotonic() - t0 < 60, "flood smoke budget blown"


# --------------------------------------------------------- transactions --

def test_transactional_round_trip():
    """One committed transaction through the GPU backend: the stored
    batches are transactional with one COMMIT marker, and a
    read_committed consumer reads every record."""
    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "transactional.id": "tx-port", "compression.codec": "lz4",
                  "linger.ms": 5, "batch.num.messages": 50, **GPU})
    c = None
    try:
        p.init_transactions(60)
        p.begin_transaction()
        for i in range(120):
            p.produce("txp", value=b"txn-%05d " % i * 8, partition=0)
        p.commit_transaction(120)
        mc = p._rk.mock_cluster
        data, markers = [], 0
        for _base, blob in mc.partition("txp", 0).log:
            for info, payload, full in iter_batches(blob):
                assert verify_crc_v2(info, full) and info.is_transactional
                if info.is_control:
                    markers += 1
                    continue
                if info.codec:
                    payload = native.lz4_decompress(payload)
                data += [r.value for r in parse_records_v2(info, payload)]
        assert markers == 1
        want = [b"txn-%05d " % i * 8 for i in range(120)]
        assert data == want
        c = Consumer({"bootstrap.servers": mc.bootstrap_servers(),
                      "group.id": "gtx", "isolation.level": "read_committed",
                      "auto.offset.reset": "earliest", "check.crcs": True,
                      **GPU})
        c.assign([TopicPartition("txp", 0, OFFSET_BEGINNING)])
        got = []
        deadline = time.monotonic() + 30
        while len(got) < 120 and time.monotonic() < deadline:
            for m in c.consume(120 - len(got), 1.0):
                assert m.error is None, m.error
                got.append(m.value)
        assert got == want
    finally:
        if c is not None:
            c.close()
        p.close()


@pytest.mark.parametrize("mod", ["client.txnmgr", "client.sasl",
                                 "client.tls", "client.admin",
                                 "obs.collect", "client.interceptor",
                                 "client.offset_store", "mock.sockem"])
def test_lazily_imported_modules_import(mod):
    import importlib
    m = importlib.import_module("librdkafka_tpu_torch." + mod)
    assert m.__name__ == "librdkafka_tpu_torch." + mod
