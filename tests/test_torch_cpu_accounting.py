"""The client's CPU by layer, counted inside the port: the broker
thread's serve passes (``wakeups``, ``idle_wakeups``, ``woke``, ``ops``
and the ``pass_tally`` event's CPU by phase), the codec worker's turns
(``codec_tally``), the engine's dispatch turns (``turns`` and the
trace-only ``*_cpu_ns`` counters), the native codec pool's CPU
(``tk_pool_cpu_take``), the ring's overwrite counts, the ``batch`` arg
that chains one batch's spans, and the benchmark's readers of all of
it.  CPU provider and the GPU provider's plain
versions (``gpu.device=cpu``).
"""
import importlib.util
import json
import os
import threading
import time

import pytest

import torch_port_only as port_only
from librdkafka_tpu_torch import Producer
from librdkafka_tpu_torch.client.broker import PASS_OPS, PASS_WOKE, _CpuTally
from librdkafka_tpu_torch.obs import trace
from librdkafka_tpu_torch.ops import cpu as native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BACKENDS = {
    "cpu": {},
    "gpu": {"compression.backend": "gpu", "gpu.device": "cpu",
            "gpu.launch.min.batches": 1},
}
PASS_PHASES = {"idle", "ops", "produce", "fetch", "send", "recv", "scan",
               "wait"}


def _producer(backend: str, **extra):
    conf = {"bootstrap.servers": "", "test.mock.num.brokers": 1,
            "compression.codec": "lz4", "linger.ms": 5,
            **BACKENDS[backend], **extra}
    p = Producer(conf)
    if backend == "gpu":
        assert p._rk.codec_provider.wait_warm(300)
    return p


def _produce_round(p, n: int = 2000, parts: int = 4) -> None:
    for i in range(n):
        p.produce("acct", value=b"rec-%06d " % i * 40, partition=i % parts)
        if i % 400 == 0:
            p.poll(0)
    assert p.flush(120) == 0


def _leaders(p) -> list:
    return [b for b in p._rk.brokers.values() if b.nodeid >= 0]


@pytest.fixture
def traced():
    """Tracing held on by the test itself, so that the rings (and the
    tallies the threads emit as they exit) outlive the client's close."""
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()


def _close_and_join(p) -> list:
    """Close the client and wait for its broker and codec threads."""
    rk = p._rk
    brokers = list(rk.brokers.values())
    worker = rk.codec_worker
    p.close()
    for b in brokers:
        b.thread.join(10)
    if worker is not None:
        worker.join(10)
    return brokers


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_tally_passes_sum_to_wakeups(backend, traced):
    """Every serve pass and codec turn lands in exactly one tally: summed
    over a thread's events, ``passes`` equals its counter, each pass had
    one ``woke`` cause, and the CPU falls in the named phases."""
    p = _producer(backend, **{"trace.enable": True})
    _produce_round(p)
    time.sleep(0.25)                 # at least one 100 ms tally on its own
    blob = json.loads(p._rk.stats.emit_json())
    worker = p._rk.codec_worker
    brokers = _close_and_join(p)
    evs = traced.collect_events()
    for b in brokers:
        mine = [e["args"] for e in evs
                if e["name"] == "pass_tally" and e["tid"] == b.thread.ident]
        assert len(mine) >= 2, b.name
        assert sum(a["passes"] for a in mine) == b.c_wakeups > 0
        assert sum(a["idle_passes"] for a in mine) == b.c_idle_wakeups
        for a in mine:
            assert sum(a["woke"].values()) == a["passes"]
            assert set(a["woke"]) == set(PASS_WOKE)
            assert set(a["ops"]) == set(PASS_OPS)
            assert set(a["cpu_ns"]) <= PASS_PHASES, a["cpu_ns"]
            assert a["t_start"] <= e_ts(evs, a)
            assert a["dropped"] == 0
        # the stats blob, read before the close, counted no more passes
        assert 0 < blob["brokers"][b.name]["wakeups"] <= b.c_wakeups
    if worker is not None:
        mine = [e["args"] for e in evs if e["name"] == "codec_tally"]
        assert sum(a["passes"] for a in mine) == worker.c_turns > 0
        for a in mine:
            assert set(a["cpu_ns"]) <= {"busy"}


def e_ts(evs: list, args: dict) -> float:
    """The timestamp of the event carrying ``args``."""
    return next(e["ts"] for e in evs if e.get("args") is args)


def test_idle_producer_counts_idle_passes_woken_by_timeout():
    """A connected producer with nothing to send: every pass is idle,
    and its select's timeout ends every wait."""
    p = _producer("cpu")
    try:
        _produce_round(p, n=200)
        time.sleep(0.3)                 # the acks and DRs settle
        (b,) = _leaders(p)
        w0, i0, woke0 = b.c_wakeups, b.c_idle_wakeups, dict(b.c_woke)
        time.sleep(0.6)
        w1, i1, woke1 = b.c_wakeups, b.c_idle_wakeups, dict(b.c_woke)
    finally:
        p.close()
    assert w1 - w0 >= 20                # 5 ms select timeouts
    assert i1 - i0 == w1 - w0
    moved = {k: woke1[k] - woke0[k] for k in woke1 if woke1[k] != woke0[k]}
    assert set(moved) == {"timeout"}, moved


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_produce_round_counts_codec_results_and_ack_cpu(backend, traced):
    """A produce round: the codec phase's results come back as
    ``codec_done`` ops, and the responses' read and DR path puts CPU
    under ``recv``."""
    p = _producer(backend, **{"trace.enable": True})
    try:
        _produce_round(p)
        (b,) = _leaders(p)
        blob = json.loads(p._rk.stats.emit_json())
    finally:
        _close_and_join(p)
    ops = blob["brokers"][b.name]["ops"]
    assert ops["codec_done"] >= 1 and b.c_ops["codec_done"] >= 1
    recv = sum(e["args"]["cpu_ns"].get("recv", 0)
               for e in traced.collect_events()
               if e["name"] == "pass_tally" and e["tid"] == b.thread.ident)
    assert recv > 0


def _crc_fallback(bufs, poly):
    prov = native.CpuCodecProvider()
    return (prov.crc32c_many(bufs) if poly == "crc32c"
            else prov.crc32_many(bufs))


def _engine():
    from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
    return AsyncOffloadEngine(devices=["cpu"], depth=2, min_batches=1,
                              cpu_fallback=_crc_fallback)


CPU_FIELDS = ("turn_cpu_ns", "sync_cpu_ns", "host_cpu_ns",
              "native_pool_cpu_ns")


def _engine_round(eng) -> None:
    prov = native.CpuCodecProvider()
    bufs = [os.urandom(30000) + b"z" * 30000 for _ in range(8)]
    got = eng.submit_compute(prov.compress_many, "lz4", bufs, host=True)
    assert [native.lz4_decompress(f, len(b)) for f, b in
            zip(got.result(120), bufs)] == bufs
    assert eng.submit([b"123456789"], "crc32c",
                      window=False).result(120).tolist() == [0xE3069283]


def test_engine_turns_move_cpu_fields_stay_zero_untraced():
    assert not trace.enabled
    eng = _engine()
    try:
        _engine_round(eng)
        stats = dict(eng.stats)
    finally:
        eng.close()
    assert stats["turns"] >= 2
    assert {k: stats[k] for k in CPU_FIELDS} == dict.fromkeys(CPU_FIELDS, 0)


def test_engine_cpu_fields_count_while_tracing(traced):
    eng = _engine()
    try:
        _engine_round(eng)
        stats = dict(eng.stats)
    finally:
        eng.close()
    assert stats["turn_cpu_ns"] >= stats["host_cpu_ns"] > 0
    assert stats["turn_cpu_ns"] >= stats["sync_cpu_ns"]
    # the host job compressed 8 buffers over the native pool
    assert stats["native_pool_cpu_ns"] > 0


def test_pool_cpu_take_counts_the_calling_threads_pool():
    bufs = [os.urandom(100_000) + b"q" * 100_000 for _ in range(8)]
    native.lz4f_compress_many(bufs)           # loads the library
    native.pool_cpu_take()
    native.lz4f_compress_many(bufs)
    assert native.pool_cpu_take() > 0
    assert native.pool_cpu_take() == 0
    # another thread's calls land in that thread's account only
    other = []
    t = threading.Thread(target=lambda: (native.lz4f_compress_many(bufs),
                                         other.append(
                                             native.pool_cpu_take())))
    t.start()
    t.join(60)
    assert other and other[0] > 0
    assert native.pool_cpu_take() == 0
    # one buffer runs on the caller: no pool, nothing to take
    native.lz4f_compress_many(bufs[:1])
    assert native.pool_cpu_take() == 0


def test_ring_counts_what_it_overwrote():
    """The ring's overwrites show in ``trace.dropped()``, on the
    thread's metadata record, and on each tally as it stood when the
    tally was emitted."""
    trace.enable(ring=64)
    try:
        def emit():
            tally = _CpuTally("broker", "pass_tally", "ops", {"passes": 0})
            tally.emit({"passes": 1})
            for i in range(200):
                trace.instant("t", f"e{i}")
            tally.emit({"passes": 2})
        t = threading.Thread(target=emit, name="acct-wrap")
        t.start()
        t.join(10)
        trace.instant("t", "one")
        drops = trace.dropped()
        evs = trace.collect_events()
    finally:
        trace.disable()
    meta = {e["args"]["name"]: e["args"]["dropped"]
            for e in evs if e["ph"] == "M"}
    # 202 events in a ring of 64: the first tally is overwritten, the
    # last one saw the 201 before it less the 64 the ring holds
    assert drops["acct-wrap"] == meta["acct-wrap"] == 202 - 64
    assert drops["MainThread"] == meta["MainThread"] == 0
    (last,) = [e["args"] for e in evs if e["name"] == "pass_tally"]
    assert last["passes"] == 1 and last["dropped"] == 201 - 64


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_batch_arg_chains_one_batchs_spans(backend, traced):
    """Each ProduceRequest's spans share (topic, partition, batch): the
    run take (and, off the fused lane, the native frame) before the
    request, its ack, then its DR, each starting no earlier than the
    one before."""
    p = _producer(backend, **{"trace.enable": True})
    try:
        _produce_round(p)
    finally:
        _close_and_join(p)
    chains: dict = {}
    for e in traced.collect_events():
        if e["name"] in ("run_take", "native_frame", "produce_tx", "ack",
                         "dr"):
            a = e["args"]
            key = (a["topic"], a["partition"], a["batch"])
            chains.setdefault(key, {})[e["name"]] = e
    txs = [c for c in chains.values() if "produce_tx" in c]
    assert len(txs) >= 4
    steps = ["run_take", "native_frame", "produce_tx", "ack", "dr"]
    for c in txs:
        assert {"run_take", "produce_tx", "ack", "dr"} <= set(c), set(c)
        if backend == "gpu":
            assert "native_frame" in c
        ts = [c[s]["ts"] for s in steps if s in c]
        assert ts[:3] == sorted(ts[:3])
        # the DR span opens as the ack span closes
        assert c["dr"]["ts"] >= c["ack"]["ts"] + c["ack"]["dur"] - 1.0


def test_port_stats_carry_the_documented_port_only_fields():
    """The port's stats blob has every field of CPU_ACCOUNTING.md's
    "Stats" sections, and beyond them the reference's sections; ``woke``
    and ``ops`` have exactly their documented keys."""
    p = _producer("gpu")
    try:
        _produce_round(p, n=200)
        blob = json.loads(p._rk.stats.emit_json())
    finally:
        p.close()
    fields = port_only.stats_fields()
    assert set(fields) == {"brokers.{name}", "codec_engine"}
    port_only.strip_stats(blob)          # asserts every field present
    for b in blob["brokers"].values():
        assert set(b["woke"]) == set(PASS_WOKE)
        assert set(b["ops"]) == set(PASS_OPS)
        assert sum(b["woke"].values()) == b["wakeups"]
        assert b["idle_wakeups"] <= b["wakeups"]
    ce = blob["codec_engine"]
    assert ce["turns"] > 0
    assert all(ce[k] == 0 for k in CPU_FIELDS)     # untraced


def test_tracing_md_names_the_port_only_events():
    """The port's own tracing doc (CPU_ACCOUNTING.md) names its events,
    span args and the ring's overwrite count."""
    with open(port_only.DOC) as f:
        doc = f.read()
    for name in (port_only.EVENTS | port_only.SPAN_ARGS
                 | {"run_take", "native_frame", "dropped"}):
        assert f"`{name}`" in doc, name


def _load_kbench_readers():
    path = os.path.join(ROOT, "kbench", "tests",
                        "test_kbench_cpu_readers.py")
    spec = importlib.util.spec_from_file_location(
        "kbench_cpu_readers_for_tier1", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_READERS = _load_kbench_readers()


@pytest.mark.parametrize(
    "check", sorted(n for n in dir(_READERS) if n.startswith("test_")))
def test_benchmark_reader(check):
    """kbench/tests/test_kbench_cpu_readers.py's checks of the readers of
    the client's CPU by layer, on synthetic readings."""
    getattr(_READERS, check)()
