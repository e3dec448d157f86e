"""The port's device compress route (ops/engine.py ``submit_compress``,
ops/gpu.py ``compress_submit`` / ``lz4_force``, client/codec_phase.py
``submit_batches(qos=)``) held against the JAX package's (test 0135's
suite, case by case).

Both engines run on the CPU: the JAX engine on jax's CPU backend (one
lane), the port's on a CPU lane (``devices=["cpu"]``: the LZ4 kernel's
plain PyTorch version).  Frames must equal each other and the native
deterministic encoder's byte for byte on every route (device launch,
below quorum, governor re-route, warmup miss, QoS shed), and where a
counter is deterministic for the submission pattern the port's
``compress_stats`` must equal the JAX engine's.  After every ``close()``
neither package holds a warm compress kernel.
"""
import threading
import time

import numpy as np
import pytest

from librdkafka_tpu.ops import cpu as jax_cpu
from librdkafka_tpu.ops import lz4_jax
from librdkafka_tpu.ops.engine import AsyncOffloadEngine as JaxEngine
from librdkafka_tpu.ops.engine import _Governor as JaxGovernor
from librdkafka_tpu.ops.tpu import TpuCodecProvider
from librdkafka_tpu_torch import GpuCodecProvider, submit_batches
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.ops import lz4_torch
from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
from librdkafka_tpu_torch.ops.engine import _Governor as PortGovernor
from librdkafka_tpu_torch.ops.packing import FrameBlob
from librdkafka_tpu_torch.protocol.msgset import MsgsetWriterV2, Record
from librdkafka_tpu_torch.utils.crc import crc32c

from test_0017_codecs import CORPORA

NOW = 1_700_000_000_000
#: counters equal between the engines whatever the timing
STATS = ("launches", "blocks", "jobs", "cpu_jobs", "fused_crc", "shed_jobs",
         "bytes_in", "bytes_out")


def _sweep():
    """test 0135's size sweep: empty / 1 B / 100 B / 1 KB / 64 KB
    boundary / multi-block / incompressible."""
    rng = np.random.default_rng(135)
    return [
        b"",
        b"Z",
        bytes(CORPORA["json_like"][:100]),
        b"kv-pair " * 128,
        CORPORA["near_64k"],
        CORPORA["over_64k"],
        rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
    ]


def _det(bufs):
    """The oracle: the native deterministic (insert-all) encoder."""
    return native.lz4f_compress_many([bytes(b) for b in bufs],
                                     deterministic=True)


def _jax_crc_fallback(bufs, poly):
    p = jax_cpu.CpuCodecProvider()
    return p.crc32c_many(bufs) if poly == "crc32c" else p.crc32_many(bufs)


def _port_crc_fallback(bufs, poly):
    p = native.CpuCodecProvider()
    return p.crc32c_many(bufs) if poly == "crc32c" else p.crc32_many(bufs)


def _engines(**kw):
    """The same configuration on both engines: (jax, port)."""
    kw.setdefault("depth", 2)
    kw.setdefault("min_batches", 1)
    kw.setdefault("warmup", False)
    return (JaxEngine(mesh_devices=1, cpu_fallback=_jax_crc_fallback,
                      cpu_compress_fallback=_det, **kw),
            AsyncOffloadEngine(devices=["cpu"],
                               cpu_fallback=_port_crc_fallback,
                               cpu_compress_fallback=_det, **kw))


def _close(*engines):
    for e in engines:
        e.close()
    assert lz4_torch.device_kernel_count() == 0
    assert lz4_jax.device_kernel_count() == 0


def _frames(ticket, timeout=300):
    return [bytes(f) for f in ticket.result(timeout)]


def _same_stats(j, p, keys=STATS):
    js, ps = j.compress_stats, p.compress_stats
    assert {k: ps[k] for k in keys} == {k: js[k] for k in keys}, (
        dict(js), dict(ps))


# ------------------------------------------------------ engine route --

def test_engine_device_frames_bitexact_sweep():
    """The sweep through submit_compress over three ring-reuse rounds:
    frames == the JAX engine's == the deterministic encoder's, the part
    CRCs fold to each frame's CRC, and the counters agree."""
    j, p = _engines()
    try:
        sweep = _sweep()
        for r in range(3):
            batch = sweep[r:] + sweep[:r]
            got = p.submit_compress(batch, window=False).result(300)
            assert [bytes(f) for f in got] == _det(batch), f"round {r}"
            assert _frames(j.submit_compress(batch, window=False)) \
                == [bytes(f) for f in got]
            for f, src in zip(got, batch):
                assert isinstance(f, FrameBlob)
                assert f.region_crc() == crc32c(bytes(f))
                assert native.lz4_decompress(bytes(f), len(src)) == src
        _same_stats(j, p)
        snap = p.compress_snapshot()
        assert snap["launches"] == 3 and snap["fused_crc"] == 3, snap
        assert any(v["device"] for v in snap["routed"].values()), snap
        assert p.stats["launches"] == 0      # no CRC launch for any frame
    finally:
        _close(j, p)


def test_engine_two_chunk_round_frames_bitexact(monkeypatch):
    """A round cut into two launches (a launch's bytes capped low): each
    chunk packed natively into a slot of its own, frames == the
    deterministic encoder's, one round counted, none native on a CPU
    lane, its wall time charged."""
    from librdkafka_tpu_torch.ops import crc32c_torch
    monkeypatch.setattr(crc32c_torch, "LAUNCH_BYTES", 100_000)
    rng = np.random.default_rng(2)
    bufs = [CORPORA["over_64k"][:70_000], b"kv-pair " * 6000,
            rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(), b"Z"]
    assert len(AsyncOffloadEngine._chunks(
        np.array([len(b) for b in bufs], np.int64))) == 2
    _, p = _engines()
    try:
        got = p.submit_compress(bufs, window=False).result(300)
        assert [bytes(f) for f in got] == _det(bufs)
        comp = dict(p.compress_stats)
    finally:
        _close(_, p)
    assert comp["launches"] == 1 and comp["fused_crc"] == 1, comp
    assert comp["native_rounds"] == 0, comp
    assert comp["launch_wall_ns"] > 0 and comp["readback_wall_ns"] > 0, comp


def test_engine_compress_below_quorum_serves_cpu_bitexact():
    j, p = _engines(min_batches=4)
    try:
        bufs = [b"below-quorum " * 50]
        assert _frames(p.submit_compress(bufs, window=False)) == _det(bufs)
        assert _frames(j.submit_compress(bufs, window=False)) == _det(bufs)
        assert p.compress_stats["cpu_jobs"] == 1
        assert p.compress_stats["launches"] == 0
        _same_stats(j, p)
    finally:
        _close(j, p)


def test_engine_compress_governor_routes_and_explores():
    """With both cost models fed, the CPU-lane 'device' launch (ms) loses
    to the native encoder (ns/byte) and groups re-route to the CPU;
    exploration keeps the device estimate fresh — every route exact, and
    the two engines route alike."""
    j, p = _engines(min_batches=2, governor=True, fanin_window_s=0)
    try:
        rng = np.random.default_rng(2)
        bufs = [rng.integers(0, 256, 2048, dtype=np.uint8).tobytes(),
                b"governed " * 200]
        want = _det(bufs)
        for eng in (j, p):
            assert _frames(eng.submit_compress(bufs, window=False)) == want
            assert _frames(eng.submit_compress(bufs[:1], window=False)) \
                == want[:1]
            model = eng.governor.compress_models()
            assert model["cpu_ns_per_byte"] is not None
            assert model["dev_launch_ms"]
            for _ in range(8 + 2 * eng.governor.EXPLORE_EVERY):
                assert _frames(eng.submit_compress(bufs, window=False)) \
                    == want
        assert p.compress_stats["routed_cpu_jobs"] >= 1
        assert p.compress_stats["explore_routes"] >= 1
        assert any(v["cpu"] for v in p.compress_snapshot()["routed"]
                   .values())
        _same_stats(j, p, STATS + ("routed_cpu_jobs", "explore_routes"))
    finally:
        _close(j, p)


def test_engine_compress_warm_gate_routes_cpu_then_device():
    """With background warmup, a lane whose compress kernel is not warm
    serves the deterministic CPU encoder (warmup_miss_jobs) instead of
    stalling the dispatch thread; once warm the same shape is a launch."""
    eng = AsyncOffloadEngine(devices=["cpu"], depth=2, min_batches=1,
                             warmup=True, cpu_fallback=_port_crc_fallback,
                             cpu_compress_fallback=_det)
    try:
        bufs = [b"warm-gate " * 80]
        t0 = time.perf_counter()
        assert _frames(eng.submit_compress(bufs, window=False), 60) \
            == _det(bufs)
        assert time.perf_counter() - t0 < 30
        assert eng.compress_stats["warmup_miss_jobs"] == 1
        assert eng.compress_stats["launches"] == 0
        assert eng.lz4_warm_wait(180), "warmup never warmed the lane"
        assert _frames(eng.submit_compress(bufs, window=False), 60) \
            == _det(bufs)
        assert eng.compress_stats["launches"] == 1
        assert eng.compress_stats["warmup_miss_jobs"] == 1
    finally:
        _close(eng)


def test_engine_close_leaves_a_live_engines_compress_route_warm():
    """Several clients in one process each run an engine: one client's
    close() must not take the warm compress kernel from another's live
    engine (the JAX package's ``release_device_kernels`` at any engine's
    close sends the others' compress jobs to the CPU as warmup misses
    until they re-warm).  The registry empties with the last engine."""
    kw = dict(devices=["cpu"], depth=2, min_batches=1, warmup=True,
              cpu_fallback=_port_crc_fallback, cpu_compress_fallback=_det)
    live = AsyncOffloadEngine(**kw)
    leaving = AsyncOffloadEngine(**kw)
    try:
        assert live.lz4_warm_wait(180) and leaving.lz4_warm_wait(180)
        leaving.close()
        assert lz4_torch.device_kernel_count() == 1
        bufs = [b"still warm " * 90]
        assert _frames(live.submit_compress(bufs, window=False)) == \
            _det(bufs)
        assert live.compress_stats["launches"] == 1
        assert live.compress_stats["warmup_miss_jobs"] == 0
        leaving.close()         # a second close() lets go of nothing
        assert lz4_torch.device_kernel_count() == 1
    finally:
        _close(live, leaving)


def test_engine_compress_failed_warmup_fails_tickets(monkeypatch):
    """A lane whose compress kernel cannot be built or checked never
    opens: its jobs fail with that error rather than live on the CPU."""
    def broken(device=None):
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(lz4_torch, "warm_kernel", broken)
    eng = AsyncOffloadEngine(devices=["cpu"], min_batches=1, warmup=True,
                             cpu_fallback=_port_crc_fallback,
                             cpu_compress_fallback=_det)
    try:
        assert not eng.lz4_warm_wait(60)
        with pytest.raises(RuntimeError, match="no nvcc"):
            eng.submit_compress([b"x" * 500], window=False).result(60)
        assert eng.compress_stats["warmup_miss_jobs"] == 0
    finally:
        _close(eng)


def test_engine_close_with_inflight_compress_resolves_tickets():
    j, p = _engines()
    bufs = [b"drain " * 100] * 3
    tickets = {e: [e.submit_compress(bufs, window=False) for _ in range(4)]
               for e in (j, p)}
    _close(j, p)
    for eng, ts in tickets.items():
        for t in ts:
            assert t.done(), "compress ticket left unresolved after close()"
            try:
                out = t.result(0)
            except RuntimeError:
                continue                  # failed by the shutdown: allowed
            assert [bytes(f) for f in out] == _det(bufs)


# ---------------------------------------------------------------- QoS --

@pytest.mark.parametrize("Gov", [JaxGovernor, PortGovernor],
                         ids=["jax", "port"])
def test_governor_qos_shed_model(Gov):
    g = Gov(True, 0.0)
    g.note_topics([("bulk", 0.25, 990_000), ("lat", 8.0, 10_000)])
    assert g.shed_topics(saturated=False) == set()
    assert g.shed_topics(saturated=True) == {"bulk"}
    g.note_qos(("bulk",), shed=True)
    g.note_qos(("lat",), shed=False)
    snap = g.qos_snapshot()
    assert snap["bulk"] == {"weight": 0.25, "routed": 0, "shed": 1}
    assert snap["lat"]["routed"] == 1 and snap["lat"]["shed"] == 0
    g2 = Gov(True, 0.0)
    g2.note_topics([("only", 1.0, 500_000)])
    assert g2.shed_topics(saturated=True) == set()
    g3 = Gov(True, 0.0)
    g3.note_topics([("a", 1.0, 100_000), ("b", 1.0, 100_000)])
    assert g3.shed_topics(saturated=True) == set()
    g4 = Gov(False, 0.0)
    g4.note_topics([("bulk", 0.25, 990_000), ("lat", 8.0, 10_000)])
    assert g4.shed_topics(saturated=True) == set()


def _hold_dispatch(eng):
    """Park the dispatch thread in a host job until the returned event is
    set, so the jobs queued meanwhile are popped together."""
    gate = threading.Event()
    eng.submit_compute(gate.wait, 30, host=True)
    time.sleep(0.05)
    return gate


def test_engine_shed_serves_overshare_topic_on_cpu_bitexact():
    """An over-share topic's job diverts to the CPU encoder while every
    lane is saturated (forced here), popped with a latency topic's job:
    same bytes, counted as shed_jobs, the latency topic never shed."""
    engines = _engines(governor=True)
    try:
        for eng in engines:
            init = [b"lane-init " * 60]
            assert _frames(eng.submit_compress(init, window=False)) \
                == _det(init)
            eng.governor.note_topics([("bulk", 0.25, 10_000_000),
                                      ("lat", 8.0, 1_000)])
            eng._inflight_total = lambda: 10 ** 9
            bulk, lat = [b"\xa5" * 4000], [b"latency " * 100]
            gate = _hold_dispatch(eng)
            t_b = eng.submit_compress(bulk, qos=[("bulk", 0.25)])
            t_l = eng.submit_compress(lat, qos=[("lat", 8.0)])
            gate.set()
            assert _frames(t_b, 120) == _det(bulk)
            assert _frames(t_l, 120) == _det(lat)
            snap = eng.compress_snapshot()
            assert snap["shed_jobs"] == 1, snap
            assert snap["qos"]["bulk"]["shed"] == 1
            assert snap["qos"]["lat"] == {"weight": 8.0, "routed": 1,
                                          "shed": 0}
        _same_stats(*engines)
    finally:
        for eng in engines:
            eng.__dict__.pop("_inflight_total", None)
        _close(*engines)


def test_submit_compute_weight_orders_dispatch():
    """Jobs popped together dispatch by descending weight, stably: a
    latency topic's host job never queues behind a bulk one's."""
    engines = _engines()
    try:
        for eng in engines:
            order = []
            gate = _hold_dispatch(eng)
            ts = [eng.submit_compute(order.append, name, host=True,
                                     weight=w)
                  for name, w in (("bulk1", 1.0), ("lat", 8.0),
                                  ("bulk2", 1.0), ("mid", 2.0))]
            gate.set()
            for t in ts:
                t.result(30)
            assert order == ["lat", "mid", "bulk1", "bulk2"], order
    finally:
        _close(*engines)


# --------------------------------------------------- provider + writer --

@pytest.fixture
def dev_providers():
    """The device compress route, gate open, warmup off: (jax, port)."""
    j = TpuCodecProvider(min_batches=1, warmup=False, min_transport_mb_s=0,
                         compress_device=True)
    p = GpuCodecProvider(device="cpu", min_batches=1, warmup=False,
                         min_transport_mb_s=0, compress_device=True)
    yield j, p
    j.close()
    p.close()
    assert lz4_torch.device_kernel_count() == 0


def test_provider_compress_submit_routes(dev_providers):
    j, p = dev_providers
    assert getattr(p, "accepts_qos", False) is True
    bufs = [b"route-check " * 60]
    got = p.compress_submit("lz4", bufs, qos=[("t", 2.0)]).result(300)
    assert isinstance(got[0], FrameBlob)
    assert [bytes(f) for f in got] == _det(bufs) == _frames(
        j.compress_submit("lz4", bufs, qos=[("t", 2.0)]))
    assert p._engine.compress_snapshot()["qos"]["t"]["routed"] == 1
    # other codecs: host jobs, the CPU provider's bytes
    t2 = p.compress_submit("gzip", bufs, qos=[("t", 2.0)])
    assert t2.result(60) == native.CpuCodecProvider().compress_many(
        "gzip", bufs)
    # device route off: an lz4 host job, the fast parse's bytes
    host = GpuCodecProvider(device="cpu", min_batches=1, warmup=False,
                            min_transport_mb_s=0)
    try:
        out = host.compress_submit("lz4", bufs, qos=[("t", 1.0)]).result(60)
        assert out == native.CpuCodecProvider().compress_many("lz4", bufs)
        assert not isinstance(out[0], FrameBlob)
    finally:
        host.close()


def test_lz4_force_sync_route_equals_jax_and_deterministic():
    """compress_many with lz4_force (pipeline off): every block of every
    buffer in one launch of the kernel's plain version here."""
    bufs = _sweep()
    p = GpuCodecProvider(device="cpu", min_batches=1, warmup=False,
                         pipeline_depth=0, lz4_force=True,
                         min_transport_mb_s=0)
    j = TpuCodecProvider(min_batches=1, warmup=False, pipeline_depth=0,
                         lz4_force=True, min_transport_mb_s=0)
    try:
        got = p.compress_many("lz4", bufs)
        assert got == _det(bufs)
        assert got == j.compress_many("lz4", bufs)
        # below quorum the native fast parse serves
        q = GpuCodecProvider(device="cpu", min_batches=8, warmup=False,
                             pipeline_depth=0, lz4_force=True)
        assert q.compress_many("lz4", bufs[:2]) == \
            native.CpuCodecProvider().compress_many("lz4", bufs[:2])
        assert p.fused_codec_id("lz4") is None
    finally:
        p.close()
        j.close()


def _writer_wire(blob_source, msgs, *, idemp=False) -> bytes:
    """Writer-level build (the JAX broker's _assemble_and_submit_crc):
    FrameBlob fold vs whole-region scan."""
    kw = dict(producer_id=9, producer_epoch=2,
              base_sequence=100) if idemp else {}
    w = MsgsetWriterV2(codec="lz4", **kw)
    w.build(msgs, NOW)
    blob = blob_source(w.records_bytes)
    if blob is not None and len(blob) >= len(w.records_bytes):
        blob, w.codec = None, None
    region = w.assemble(blob)
    if isinstance(blob, FrameBlob):
        crc = blob.region_crc(bytes(region[:len(region) - len(blob)]))
    else:
        crc = crc32c(bytes(region))
    return w.patch_crc(crc)


@pytest.mark.parametrize("idemp", [False, True], ids=["plain", "idemp"])
def test_wire_bitexact_device_vs_cpu_with_headers(dev_providers, idemp):
    """Identical MessageSet v2 wire bytes (CRC included) whether the lz4
    frame and its CRC came from the port's device route, the JAX
    package's or the deterministic CPU encoder — across the sweep, with
    headers, plain and idempotent."""
    j, p = dev_providers
    for payload in _sweep():
        msgs = [Record(key=b"k%d" % i, value=bytes(payload),
                       timestamp=NOW + i,
                       headers=[("h1", b"v1"), ("trace", b"\x00\x01")])
                for i in range(3)]

        def dev(prov):
            return lambda rb: prov.compress_submit(
                "lz4", [rb], qos=[("sweep", 1.0)]).result(300)[0]

        want = _writer_wire(lambda rb: _det([rb])[0], msgs, idemp=idemp)
        assert _writer_wire(dev(p), msgs, idemp=idemp) == want
        assert _writer_wire(dev(j), msgs, idemp=idemp) == want


def test_submit_batches_device_route_folds_batch_crc(dev_providers):
    """A produce round through submit_batches with per-partition qos:
    wire == the deterministic writer's, every frame from one compress
    launch, and no CRC job at all (the batch CRCs are folded)."""
    _, p = dev_providers
    rng = np.random.default_rng(5)
    parts = [[Record(value=rng.integers(97, 100, 300, dtype=np.uint8)
                     .tobytes() * 3) for _ in range(20)] for _ in range(6)]
    qos = [("hot" if i % 2 else "cold", 8.0 if i % 2 else 1.0)
           for i in range(6)]
    wire = submit_batches(p, parts, "lz4", NOW, qos=qos).result(300)
    want = [_writer_wire(lambda rb: _det([rb])[0], msgs) for msgs in parts]
    assert wire == want
    eng = p._engine
    assert eng.compress_stats["launches"] == 1
    assert eng.stats["jobs"] == 0 and eng.stats["launches"] == 0
    assert set(eng.compress_snapshot()["qos"]) == {"hot", "cold"}
