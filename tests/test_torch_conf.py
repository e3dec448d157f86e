"""Mirrors of test_0110_conf_wired (every declared property is read; the
deprecated, alias, invalid and both-scope rows; the union with the
reference table) and test_0112_conf_knobs (socket.max.fails,
queue.buffering.backpressure.threshold, allow.auto.create.topics,
log.queue / log.thread.name, message.copy.max.bytes, the codec offload
knobs' validation at set time and their plumbing into the provider,
group.protocol.type) on the port.

0110 runs over the port's ``PROPERTIES`` and source tree with the
reference's own ``ALLOWED_UNREAD``.  Its union test has no reference
source tree here (``/root/reference`` is absent, and the reference's own
case skips), so it holds the port's table to the JAX package's instead:
each ``tpu.*`` row maps to a ``gpu.*`` row, and every row without a
counterpart is named (``tpu.compile.cache.dir``: the CUDA kernels are
built once by nvcc, there is no JIT cache; ``gpu.device``: the port's
form of the JAX platform choice).

The client cases of 0112 run on the port and on the JAX package at once
(``test_torch_txn.both``); the port's clients run
``compression.backend=gpu, gpu.device=cpu`` (every CRC job on the device
route) and the reference's the reference case's own conf.  The
backpressure case runs both packages' CPU providers one after the other,
as the reference case does (its socket is choked to 24 KB/s and its
counts are load-bound; the device route's form is chip_smoke.py phase
14c).
"""
import pathlib
import time

import pytest

from librdkafka_tpu.client import conf as ref_conf
from librdkafka_tpu_torch.client import conf as port_conf
from test_0110_conf_wired import ALLOWED_UNREAD
from test_torch_delivery import mod
from test_torch_latency import kit
from test_torch_txn import PORT, REF, both

PKG = pathlib.Path(__file__).resolve().parents[1] / "librdkafka_tpu_torch"

#: the reference rows with no port counterpart, and the port's own
REF_ONLY = {("global", "tpu.compile.cache.dir")}
PORT_ONLY = {("global", "gpu.device")}


def _gpu_name(name: str) -> str:
    return "gpu." + name[4:] if name.startswith("tpu.") else name


# ------------------------------------------------------------ test_0110 --

def _source_blob() -> str:
    out = [p.read_text() for p in PKG.rglob("*.py") if p.name != "conf.py"]
    out += [p.read_text() for p in PKG.rglob("*.cpp")]
    return "\n".join(out)


def test_every_property_is_read_outside_conf():
    blob = _source_blob()
    dead = [p.name for p in port_conf.PROPERTIES
            if not (p.alias or p.name in ALLOWED_UNREAD
                    or p.ptype == "invalid" or p.deprecated)
            and p.name not in blob]
    assert not dead, f"decorative conf rows (declared, never read): {dead}"


def test_deprecated_rows_are_accepted_noops():
    names = {}
    for side, m in (("port", port_conf), ("ref", ref_conf)):
        dep = [p for p in m.PROPERTIES if p.deprecated]
        c = m.Conf()
        for p in dep:
            c.set(p.name, p.default)      # must not raise
        names[side] = sorted(p.name for p in dep)
    assert names["port"] == names["ref"]
    assert "reconnect.backoff.jitter.ms" in names["port"]


def test_aliases_point_at_real_rows():
    pairs = {}
    for side, m in (("port", port_conf), ("ref", ref_conf)):
        names = {p.name for p in m.PROPERTIES}
        pairs[side] = sorted((p.name, p.alias) for p in m.PROPERTIES
                             if p.alias)
        assert all(a in names for _n, a in pairs[side])
    assert pairs["port"] == [(_gpu_name(n), _gpu_name(a))
                             for n, a in pairs["ref"]]


def test_union_matches_reference_table():
    """The port's rows are the JAX package's with tpu.* as gpu.*, but for
    the rows named above; the port's documented additions
    (GPU_ADDITIONS, the CONFIGURATION.md appendix) are the reference's
    TPU_ADDITIONS mapped the same way."""
    ref = {(p.scope, p.name) for p in ref_conf.PROPERTIES}
    ours = {(p.scope, p.name) for p in port_conf.PROPERTIES}
    mapped = {(s, _gpu_name(n)) for s, n in ref - REF_ONLY}
    assert mapped - ours == set(), sorted(mapped - ours)
    assert ours - mapped == PORT_ONLY, sorted(ours - mapped)
    adds = {(s, _gpu_name(n)) for s, n in ref_conf.TPU_ADDITIONS
            if (s, n) not in REF_ONLY}
    assert set(port_conf.GPU_ADDITIONS) == adds | PORT_ONLY


def test_invalid_rows_raise_guidance():
    for pkg in (PORT, REF):
        for name, hint in (("ssl.truststore.location", "ssl.ca.location"),
                           ("sasl.jaas.config", "sasl.mechanisms")):
            with pytest.raises(pkg.KafkaException) as ei:
                pkg.Conf().set(name, "x")
            assert hint in str(ei.value), (pkg.port, name)


def test_both_scope_rows_are_independent():
    out = {}
    for pkg, m in ((PORT, port_conf), (REF, ref_conf)):
        c = m.Conf()
        c.set("compression.codec", "lz4")
        tc = m.TopicConf()
        got = [c.get("compression.codec"), tc.get("compression.codec")]
        tc.set("compression.codec", "snappy")
        got += [tc.get("compression.codec"), c.get("compression.codec")]
        out[pkg.port] = got
    assert out[True] == out[False] == ["lz4", "inherit", "snappy", "lz4"]


def test_global_offset_store_method_roundtrips():
    out = {}
    for pkg in (PORT, REF):
        c = pkg.Conf()
        got = [c.get("offset.store.method")]
        for v in ("none", "file", "broker"):
            c.set("offset.store.method", v)
            got.append((c.get("offset.store.method"),
                        c.topic_conf().get("offset.store.method")))
        out[pkg.port] = got
    assert out[True] == out[False] == [
        "broker", ("none", "none"), ("file", "file"), ("broker", "broker")]


# ------------------------------------------------------------ test_0112 --

def _on_kn(scenario):
    def run(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"kn": 2})
        try:
            return scenario(pkg, cluster)
        finally:
            cluster.stop()
    return both(run)


def test_socket_max_fails_forces_reconnect():
    def scenario(pkg, cluster):
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "socket.timeout.ms": 400, "socket.max.fails": 2,
            "message.timeout.ms": 8000, "retries": 100,
            "retry.backoff.ms": 50}))

        def total_connects():
            rk = p._rk
            return sum(b.c_connects for b in
                       list(rk.brokers.values()) + list(rk._bootstrap))
        try:
            p.produce("kn", value=b"warm", partition=0)
            assert p.flush(10.0) == 0
            base = total_connects()
            cluster.set_rtt(1, 4000)
            p.produce("kn", value=b"x", partition=0)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and total_connects() <= base:
                time.sleep(0.05)
            reconnected = total_connects() > base
            cluster.set_rtt(1, 0)
            p.flush(10.0)
            return reconnected
        finally:
            p.close()
    assert _on_kn(scenario) == (True, True)


def test_backpressure_threshold_batches_harder():
    """On a 24 KB/s sockem link, threshold 1 holds off MessageSet
    formation while a request sits unsent: fewer, larger batches than an
    effectively disabled threshold, in both packages, through
    chip_smoke.py 14c's function (0112's burst three times at each
    threshold, interleaved, the totals compared: one burst's count is
    load-bound, and the reference case is on ROADMAP's load-sensitive
    list)."""
    import chip_smoke
    out = {}
    for pkg in (PORT, REF):
        bp = chip_smoke.p14_backpressure(kit(pkg), {
            "compression.backend": "cpu"}, "cpu")
        out[pkg.port] = sum(bp[1]) < sum(bp[1000000])
    assert out == {True: True, False: True}, out


def test_allow_auto_create_topics_consumer():
    def scenario(pkg, cluster):
        created = []
        for flag, topic, polls in ((False, "kn-nocreate", 20),
                                   (True, "kn-docreate", 100)):
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": f"g-{flag}", "allow.auto.create.topics": flag}))
            try:
                c.subscribe([topic])
                for _ in range(polls):
                    c.poll(0.1)
                    if topic in cluster.topics:
                        break
                created.append(topic in cluster.topics)
            finally:
                c.close()
        return created
    assert _on_kn(scenario) == ([False, True], [False, True])


def test_producer_metadata_always_allows_auto_create():
    def scenario(pkg, cluster):
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 1}))
        try:
            p.produce("kn-prod-new", value=b"z")
            assert p.flush(10.0) == 0
            return "kn-prod-new" in cluster.topics
        finally:
            p.close()
    assert _on_kn(scenario) == (True, True)


def test_log_queue_and_thread_name():
    def scenario(pkg, cluster):
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "log.queue": True, "log.thread.name": True, "log_level": 7}))
        try:
            p._rk.log("INFO", "queued line")
            logs = []
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and not logs:
                ev = p._rk.queue_poll(0.1)
                if ev is not None and ev.type == "LOG":
                    logs.append(ev.log())
        finally:
            p.close()
        level, fac, msg = logs[0]
        seen = []
        p2 = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "log.thread.name": False, "log_level": 7,
            "log_cb": lambda lvl, f, m: seen.append(m)}))
        try:
            p2._rk.log("INFO", "direct line")
        finally:
            p2.close()
        return (level, fac, "[thrd:" in msg, msg.endswith("queued line"),
                seen[:1])
    port, ref = _on_kn(scenario)
    assert port == ref == ("INFO", "rdkafka", True, True, ["direct line"])


def test_message_copy_max_bytes_lane_routing():
    """A payload above message.copy.max.bytes skips the arena copy and
    takes the Message path; both deliver, in one batch with one CRC (the
    port's CRC ticket)."""
    def scenario(pkg, cluster):
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "message.copy.max.bytes": 64, "linger.ms": 2}))
        try:
            small, big = b"s" * 10, b"B" * 4096
            p.produce("kn", value=small, partition=0)   # arena lane
            p.produce("kn", value=big, partition=0)     # Message path
            assert p.flush(10.0) == 0
        finally:
            p.close()
        blobs = b"".join(b for _, b in cluster.partition("kn", 0).log)
        return small in blobs, big in blobs
    assert _on_kn(scenario) == ((True, True), (True, True))


#: test_0112's tpu.* rejections as gpu.* rows (the same ranges); the
#: reference's tpu.compile.cache.dir rows have no counterpart: the port
#: keeps no JIT cache (nvcc builds each kernel once into build/)
BAD_KNOBS = [("pipeline.depth", -1), ("pipeline.depth", 99),
             ("fetch.pipeline.depth", 0), ("fetch.pipeline.depth", -3),
             ("pipeline.fanin.us", -1), ("pipeline.fanin.us", 10**9),
             ("launch.min.batches", 0), ("warmup", "definitely"),
             ("governor", "perhaps")]


@pytest.mark.parametrize("knob,value", BAD_KNOBS)
def test_gpu_knob_validation_at_set_time(knob, value):
    """Each codec offload knob fails at Conf.set() with the reference's
    error, never at first launch; the port also checks gpu.device."""
    for pkg, prefix in ((PORT, "gpu."), (REF, "tpu.")):
        name = prefix + knob
        with pytest.raises(pkg.KafkaException) as ei:
            pkg.Conf().set(name, value)
        assert name in str(ei.value) or "Expected" in str(ei.value)


def test_gpu_knob_valid_values_and_device():
    out = {}
    for pkg, prefix in ((PORT, "gpu."), (REF, "tpu.")):
        c = pkg.Conf()
        c.set(prefix + "pipeline.depth", 0)        # 0 = engine disabled
        c.set(prefix + "pipeline.fanin.us", 0)     # dispatch immediately
        c.set(prefix + "warmup", False)
        c.set(prefix + "governor", "true")
        out[pkg.port] = (c.get(prefix + "governor"), c.get(prefix + "warmup"))
    assert out[True] == out[False] == (True, False)
    c = PORT.Conf()
    for dev in ("cuda", "cuda:0", "cpu"):
        c.set("gpu.device", dev)
    with pytest.raises(PORT.KafkaException):
        c.set("gpu.device", "tpu")


def test_gpu_governor_knobs_reach_provider():
    out = {}
    for pkg, prefix in ((PORT, "gpu."), (REF, "tpu.")):
        conf = {"bootstrap.servers": "", "test.mock.num.brokers": 1,
                "compression.backend": "gpu" if pkg.port else "tpu",
                prefix + "transport.min.mb.s": 0,
                prefix + "governor": False, prefix + "warmup": False}
        if pkg.port:
            conf["gpu.device"] = "cpu"
        p = pkg.Producer(conf)
        try:
            prov = p._rk.codec_provider
            out[pkg.port] = (prov.governor, prov.warmup if pkg.port
                             else prov.engine_warmup)
        finally:
            p.close()
    assert out[True] == out[False] == (False, False)


def test_group_protocol_type_on_wire():
    def scenario(pkg, cluster):
        c = pkg.Consumer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "group.id": "gpt", "group.protocol.type": "myproto"}))
        try:
            c.subscribe(["kn"])
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                c.poll(0.1)
                grp = cluster.groups.get("gpt")
                if grp is not None and grp.protocol_type:
                    break
        finally:
            c.close()
        grp = cluster.groups.get("gpt")
        return grp is not None and grp.protocol_type
    assert _on_kn(scenario) == ("myproto", "myproto")
