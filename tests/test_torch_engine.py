"""The port's async offload engine (librdkafka_tpu_torch/ops/engine.py)
held against the JAX package's (librdkafka_tpu/ops/engine.py), test
0018's engine and governor suite case by case.

Each case drives the same seeded inputs through both engines: the JAX
engine on jax's CPU backend (one lane, ``mesh_devices=1``; its kernels
are the XLA row kernels) and the port's on a CPU lane (``devices=
["cpu"]``: the segment kernel's plain PyTorch version).  CRCs must be
equal exactly, and equal to the native oracle; where a counter is
deterministic for the submission pattern (``launches``,
``fused_launches``, ``cpu_fallback_jobs``, ``warmup_miss_jobs``) the
port's must equal the JAX engine's.
"""
import threading
import time
import zlib

import numpy as np
import pytest

from librdkafka_tpu.ops import cpu as jax_cpu
from librdkafka_tpu.ops.engine import AsyncOffloadEngine as JaxEngine
from librdkafka_tpu_torch.obs import metrics as port_metrics
from librdkafka_tpu_torch.obs import trace as port_trace
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.ops import crc32c_torch
from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine, SyncTicket


@pytest.fixture(autouse=True)
def _port_obs_clean():
    """The conftest checks the JAX package's obs state; this checks the
    port's: tracer and metrics disabled and empty after each test."""
    yield
    assert not port_trace.enabled and port_trace.active_ring_count() == 0
    assert not port_metrics.enabled and port_metrics.registered_count() == 0


def _jax_fallback(bufs, poly):
    prov = jax_cpu.CpuCodecProvider()
    return (prov.crc32c_many(bufs) if poly == "crc32c"
            else prov.crc32_many(bufs))


def _port_fallback(bufs, poly):
    prov = native.CpuCodecProvider()
    return (prov.crc32c_many(bufs) if poly == "crc32c"
            else prov.crc32_many(bufs))


def _oracle(bufs, poly):
    return [native.crc32c(b) if poly == "crc32c"
            else zlib.crc32(b) & 0xFFFFFFFF for b in bufs]


def _engines(**kw):
    """The same configuration on both engines: (jax, port)."""
    return (JaxEngine(mesh_devices=1, cpu_fallback=_jax_fallback, **kw),
            AsyncOffloadEngine(devices=["cpu"], cpu_fallback=_port_fallback,
                               **kw))


def _close(*engines):
    for e in engines:
        e.close()


# test_0018's size classes: sub-block, exact block, multi-block, empty
SIZES = [1, 63, 1000, 65535, 65536, 65537, 200_000]
KEYS = ("launches", "fused_launches", "cpu_fallback_jobs")


def _bufs(seed):
    rng = np.random.default_rng(seed)
    return [b"", b"a", b"123456789", bytes(100)] + [
        rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in SIZES]


def test_engine_crc_bitexact_ring_reuse():
    """Four rotated rounds submitted before any resolves (ring slots are
    refilled while earlier launches are in flight), then one round per
    polynomial submitted and resolved in turn: both engines equal the
    oracle, and their launch counts agree on the sequential rounds."""
    jax_e, port_e = _engines(depth=2, fanin_window_s=0.0005,
                             min_batches=1)
    try:
        bufs = _bufs(7)
        rounds = [(bufs[r:] + bufs[:r], poly) for poly in ("crc32c", "crc32")
                  for r in range(4)]
        for eng in (jax_e, port_e):
            tickets = [eng.submit(b, poly, window=False)
                       for b, poly in rounds]
            for (b, poly), t in zip(rounds, tickets):
                assert t.result(120).tolist() == _oracle(b, poly)
        counts = []
        for eng in (jax_e, port_e):
            before = eng.stats["launches"]
            for poly in ("crc32c", "crc32"):
                got = eng.submit(bufs, poly, window=False).result(120)
                assert got.tolist() == _oracle(bufs, poly)
            counts.append(eng.stats["launches"] - before)
        assert counts == [2, 2]
        assert port_e._lanes[0].staging.nbytes() > 0
    finally:
        _close(jax_e, port_e)


def test_engine_fanin_aggregation_and_quorum_fallback():
    """A below-quorum windowed job alone is served by the CPU fallback
    when its window expires; two concurrent below-quorum jobs merge to
    meet the quorum — bytes identical either way, counters equal."""
    jax_e, port_e = _engines(depth=2, fanin_window_s=0.002, min_batches=8)
    try:
        rng = np.random.default_rng(8)
        bufs = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                for _ in range(4)]
        want = _oracle(bufs, "crc32c")
        for eng in (jax_e, port_e):
            t = eng.submit(bufs[:2], "crc32c", window=True)
            assert t.result(60).tolist() == want[:2]
            assert eng.stats["cpu_fallback_jobs"] >= 1
            t1 = eng.submit(bufs, "crc32c", window=True)
            t2 = eng.submit(bufs, "crc32c", window=True)
            assert t1.result(60).tolist() == want
            assert t2.result(60).tolist() == want
        # the merge is timing-dependent (a 2 ms window): either the two
        # jobs merged or the window expired and the CPU served them
        for eng in (jax_e, port_e):
            assert (eng.stats["aggregated"] == 2
                    or eng.stats["cpu_fallback_jobs"] > 1), eng.stats
    finally:
        _close(jax_e, port_e)


def test_engine_host_compute_jobs():
    """submit_compute(host=True) runs a host fn on the dispatch thread
    and resolves with its raw value; a raising host fn fails only its own
    ticket, and CRC launches go on."""
    jax_e, port_e = _engines(depth=2, min_batches=1)
    try:
        prov = native.CpuCodecProvider()
        payloads = [b"host-job-%d" % i * 40 for i in range(5)]
        comp = prov.compress_many("lz4", payloads)

        def boom():
            raise ValueError("host job failed")

        for eng in (jax_e, port_e):
            t = eng.submit_compute(prov.decompress_many, "lz4", comp,
                                   [len(p) for p in payloads], host=True)
            assert t.result(120) == payloads
            with pytest.raises(ValueError):
                eng.submit_compute(boom, host=True).result(120)
            got = eng.submit([b"123456789"], "crc32c", window=False)
            assert got.result(120).tolist() == [0xE3069283]
        assert jax_e.stats["host_jobs"] == port_e.stats["host_jobs"] == 2
    finally:
        _close(jax_e, port_e)


def test_engine_device_compute_job_reads_back_numpy():
    """submit_compute(host=False): the function's tensors come back as
    numpy arrays through the engine's readback."""
    import torch
    eng = AsyncOffloadEngine(devices=["cpu"], min_batches=1,
                             cpu_fallback=_port_fallback)
    try:
        x = torch.arange(6, dtype=torch.int64)
        out = eng.submit_compute(lambda v: (v * 2, {"s": v.sum()}), x)
        doubled, rest = out.result(60)
        assert isinstance(doubled, np.ndarray)
        assert doubled.tolist() == [0, 2, 4, 6, 8, 10]
        assert int(rest["s"]) == 15
    finally:
        eng.close()


def _close_cases(make):
    """test_0018's close cases on one engine factory: a clean close
    drains queued work; a wedged dispatch thread's queued job fails."""
    eng = make(depth=2)
    tickets = [eng.submit_compute(lambda i=i: (time.sleep(0.02), i)[1],
                                  host=True) for i in range(8)]
    eng.close()
    for i, t in enumerate(tickets):
        assert t.done(), "ticket left unresolved after close()"
        assert t.result(0) == i
    with pytest.raises(RuntimeError):     # post-close submits refused
        eng.submit([b"x"], "crc32c", window=False)

    eng2 = make(depth=1)
    started = threading.Event()

    def wedge():
        started.set()
        time.sleep(0.8)
        return "wedge-done"

    t_wedge = eng2.submit_compute(wedge, host=True)
    assert started.wait(10)
    t_stuck = eng2.submit_compute(lambda: 2, host=True)
    eng2.close(timeout=0.1)
    with pytest.raises(RuntimeError):
        t_stuck.result(5)
    assert t_wedge.result(5) == "wedge-done"
    eng2._thread.join(5)
    assert not eng2._thread.is_alive()


@pytest.mark.parametrize("which", ["jax", "port"])
def test_engine_close_with_inflight_resolves_every_ticket(which):
    if which == "jax":
        _close_cases(lambda depth: JaxEngine(
            depth=depth, min_batches=1, mesh_devices=1,
            cpu_fallback=_jax_fallback))
    else:
        _close_cases(lambda depth: AsyncOffloadEngine(
            depth=depth, min_batches=1, devices=["cpu"],
            cpu_fallback=_port_fallback))


def test_engine_close_with_crc_launches_in_flight():
    """close() right after CRC submissions: every ticket resolves with
    its CRCs (the exiting thread drains the lane)."""
    eng = AsyncOffloadEngine(depth=2, min_batches=1, devices=["cpu"],
                             cpu_fallback=_port_fallback, governor=False)
    bufs = _bufs(9)[:8]
    tickets = [eng.submit(bufs, "crc32c", window=False) for _ in range(5)]
    eng.close()
    for t in tickets:
        assert t.done()
        assert t.result(0).tolist() == _oracle(bufs, "crc32c")


def test_engine_warmup_gate_routes_cpu_then_device(monkeypatch):
    """With warmup on, a launch for a lane not warm yet is served by the
    CPU provider (counted as warmup_miss_jobs); once the warmup thread has
    made the lane warm, the same submission rides a launch.  The port's
    warmup is held until the first result is in, so its first job
    provably misses; the JAX engine's cold compile makes its miss the
    common case (test 0018 allows either)."""
    gate = threading.Event()
    real_warm = crc32c_torch.warm_kernel

    def held_warm(device=None):
        assert gate.wait(30)
        real_warm(device)

    monkeypatch.setitem(crc32c_torch._READY, "cpu", True)
    monkeypatch.delitem(crc32c_torch._READY, "cpu")
    monkeypatch.setattr(crc32c_torch, "warm_kernel", held_warm)
    jax_e, port_e = _engines(depth=2, min_batches=1, governor=True,
                             warmup=True)
    try:
        rng = np.random.default_rng(21)
        bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (5, 3000, 70000)]
        want = _oracle(bufs, "crc32c")
        for eng in (jax_e, port_e):
            t = eng.submit(bufs, "crc32c", window=False)
            assert t.result(60).tolist() == want
        assert port_e.stats["warmup_miss_jobs"] == 1
        assert port_e.stats["launches"] == 0
        assert (jax_e.stats["warmup_miss_jobs"] >= 1
                or jax_e.stats["launches"] >= 1)
        gate.set()
        assert jax_e.warm_wait(64, "crc32c", 180)
        assert port_e.warm_wait(60)
        for eng in (jax_e, port_e):
            before = eng.stats["launches"]
            assert eng.submit(bufs, "crc32c",
                              window=False).result(60).tolist() == want
            assert eng.stats["launches"] == before + 1
        assert port_e.stats["warmup_compiled"] == 1
        assert port_e.devices_snapshot()[0]["warm_buckets"] == 1
    finally:
        gate.set()
        _close(jax_e, port_e)
    for eng in (jax_e, port_e):
        assert not eng._warmup_thread.is_alive()


def test_engine_warmup_failure_fails_tickets(monkeypatch):
    """A lane whose warmup raises never opens, and its jobs fail with
    that error rather than being served from the CPU for ever."""
    def broken(device=None):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(crc32c_torch, "warm_kernel", broken)
    monkeypatch.setattr(crc32c_torch, "kernel_ready", lambda device=None:
                        False)
    eng = AsyncOffloadEngine(depth=2, min_batches=1, devices=["cpu"],
                             warmup=True, cpu_fallback=_port_fallback)
    try:
        eng._warmup_thread.join(30)
        assert not eng.warm_wait(5)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            eng.submit([b"abc"], "crc32c", window=False).result(30)
    finally:
        eng.close()


def test_engine_fused_multipoly_single_launch():
    """crc32c and legacy-crc32 jobs popped together fuse into ONE launch
    with a per-segment polynomial, each result exact for ITS
    polynomial: fused_launches == launches == 1 on both engines."""
    jax_e, port_e = _engines(depth=2, fanin_window_s=0.1, min_batches=4,
                             governor=True, warmup=False)
    try:
        rng = np.random.default_rng(22)
        bufs_c = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                  for n in (900, 70000)]
        bufs_l = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                  for n in (4096, 17)]
        for eng in (jax_e, port_e):
            t1 = eng.submit(bufs_c, "crc32c", window=True)
            t2 = eng.submit(bufs_l, "crc32", window=True)
            assert t1.result(300).tolist() == _oracle(bufs_c, "crc32c")
            assert t2.result(300).tolist() == _oracle(bufs_l, "crc32")
        for k in KEYS:
            assert jax_e.stats[k] == port_e.stats[k], k
        assert port_e.stats["fused_launches"] == 1, port_e.stats
        assert port_e.stats["launches"] == 1, port_e.stats
    finally:
        _close(jax_e, port_e)


def test_engine_adaptive_fanin_sheds_window_at_low_rate():
    """Once the governor has seen a mean inter-arrival beyond the fan-in
    cap, a below-quorum job dispatches at once: the last submission
    skips the window (a counter, not the clock, shows it)."""
    jax_e, port_e = _engines(depth=2, fanin_window_s=0.3, min_batches=8,
                             governor=True, warmup=False)
    try:
        bufs = [b"low-rate" * 64]
        want = _oracle(bufs, "crc32c")
        for i in range(3):
            waits = [e.stats["fanin_waits"] for e in (jax_e, port_e)]
            tickets = [e.submit(bufs, "crc32c", window=True)
                       for e in (jax_e, port_e)]
            for t in tickets:
                assert t.result(30).tolist() == want
            if i < 2:
                time.sleep(0.45)     # inter-arrival >> the 0.3 s cap
        for e, w in zip((jax_e, port_e), waits):
            assert e.stats["fanin_skips"] >= 1, e.stats
            assert e.stats["fanin_waits"] == w, "still paying the window"
    finally:
        _close(jax_e, port_e)


def test_engine_cost_model_routes_and_explores():
    """With both models measured, at-quorum groups go to the predicted-
    faster side — the CPU provider, against a jax-CPU or plain-torch
    "device" — and periodic exploration flips some decisions; every
    route exact."""
    jax_e, port_e = _engines(depth=2, fanin_window_s=0, min_batches=2,
                             governor=True, warmup=False)
    try:
        rng = np.random.default_rng(23)
        bufs = [rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
                for _ in range(2)]
        want = _oracle(bufs, "crc32c")
        for eng in (jax_e, port_e):
            assert eng.submit(bufs, "crc32c",
                              window=False).result(120).tolist() == want
            assert eng.submit(bufs[:1], "crc32c",
                              window=False).result(60).tolist() == want[:1]
            assert eng.stats["cpu_fallback_jobs"] == 1
            snap0 = eng.governor.snapshot()
            assert snap0["dev_launch_ms"] and \
                snap0["cpu_ns_per_byte"] is not None
            for _ in range(8):
                assert eng.submit(bufs, "crc32c",
                                  window=False).result(60).tolist() == want
            assert eng.stats["routed_cpu_jobs"] >= 1, eng.stats
            for _ in range(2 * eng.governor.EXPLORE_EVERY):
                assert eng.submit(bufs, "crc32c",
                                  window=False).result(60).tolist() == want
            assert eng.stats["explore_routes"] >= 1, eng.stats
            snap = eng.governor_snapshot()
            assert snap["cpu_ns_per_byte"] is not None
            assert snap["dev_launch_ms"]
    finally:
        _close(jax_e, port_e)


def test_engine_close_races_warmup_and_fanin_window():
    """close() right after start joins the warmup thread and drains the
    submitted job; close() racing an open 2 s fan-in window interrupts
    the wait, and the parked job resolves."""
    for make in (lambda **kw: JaxEngine(mesh_devices=1,
                                        cpu_fallback=_jax_fallback, **kw),
                 lambda **kw: AsyncOffloadEngine(
                     devices=["cpu"], cpu_fallback=_port_fallback, **kw)):
        eng = make(depth=2, min_batches=1, governor=True, warmup=True)
        t = eng.submit([b"racing-warmup"], "crc32c", window=False)
        eng.close()
        assert t.result(5).tolist() == _oracle([b"racing-warmup"], "crc32c")
        assert not eng._warmup_thread.is_alive()
        assert not eng._thread.is_alive()

        eng2 = make(depth=2, fanin_window_s=2.0, min_batches=64,
                    governor=False, warmup=False)
        t = eng2.submit([b"racing-fanin"], "crc32c", window=True)
        time.sleep(0.05)
        t0 = time.monotonic()
        eng2.close()
        assert time.monotonic() - t0 < 1.5, "close() sat out the window"
        assert t.result(5).tolist() == _oracle([b"racing-fanin"], "crc32c")
        assert not eng2._thread.is_alive()


def test_engine_two_lanes_spread_and_agree():
    """Two CPU lanes: sequential launches spread over both (the least-
    loaded pick sorts cold lanes first), results exact on each."""
    eng = AsyncOffloadEngine(depth=2, min_batches=1, governor=False,
                             devices=["cpu", "cpu"],
                             cpu_fallback=_port_fallback)
    try:
        bufs = _bufs(26)[:9]
        for r in range(4):
            batch = bufs[r:] + bufs[:r]
            got = eng.submit(batch, "crc32c", window=False).result(120)
            assert got.tolist() == _oracle(batch, "crc32c")
        assert sorted(ln.launches for ln in eng._lanes)[0] >= 1
        assert sum(ln.launches for ln in eng._lanes) == 4
        snap = eng.devices_snapshot()
        assert [d["id"] for d in snap] == [0, 1]
        assert all(d["dev_launch_ms"] for d in snap)
    finally:
        eng.close()


def test_engine_chunks_launch_bytes(monkeypatch):
    """A group over LAUNCH_BYTES goes out as several launches of one
    ticket, split at buffer bounds as the synchronous route splits it."""
    monkeypatch.setattr(crc32c_torch, "LAUNCH_BYTES", 4096)
    eng = AsyncOffloadEngine(depth=1, min_batches=1, governor=False,
                             devices=["cpu"], cpu_fallback=_port_fallback)
    try:
        rng = np.random.default_rng(27)
        bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (3000, 3000, 9000, 0, 5)]
        assert AsyncOffloadEngine._chunks(
            np.array([len(b) for b in bufs])) == [(0, 1), (1, 2), (2, 3),
                                                  (3, 5)]
        got = eng.submit(bufs, "crc32", window=False).result(60)
        assert got.tolist() == _oracle(bufs, "crc32")
        assert eng.stats["launches"] == 1
    finally:
        eng.close()


def test_engine_trace_spans_and_launch_counter():
    """With the port's tracer and metrics on, a device launch and a CPU
    serve emit device_launch / readback / cpu_serve spans and bump
    engine.launches; disabling clears both."""
    port_trace.enable()
    port_metrics.enable()
    try:
        eng = AsyncOffloadEngine(depth=1, min_batches=2, devices=["cpu"],
                                 cpu_fallback=_port_fallback,
                                 fanin_window_s=0)
        try:
            eng.submit([b"a" * 100, b"b"], "crc32c",
                       window=False).result(60)
            eng.submit([b"c"], "crc32c", window=False).result(60)
        finally:
            eng.close()
        names = {e["name"] for e in port_trace.collect_events()}
        assert {"device_launch", "readback", "cpu_serve"} <= names
        assert port_metrics.snapshot()["counters"]["engine.launches"] == 1
    finally:
        port_metrics.disable()
        port_trace.disable()


def test_engine_default_devices_raise_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncOffloadEngine()


def test_sync_ticket():
    assert SyncTicket([1]).result() == [1] and SyncTicket().done()
    with pytest.raises(KeyError):
        SyncTicket(exc=KeyError("x")).result()


def test_plan_slot_layout_and_bounds():
    """A slot holds flat rounded up to 16 B, then the tile list, then sel
    padded to 8 B; a launch of 2 GiB or more is refused (int32 tile
    positions)."""
    plan = crc32c_torch.plan_slot(np.array([5, 0, 40_000]),
                                  np.array([0, 1, 1]))
    tiles = crc32c_torch.plan_tiles(plan.offsets, plan.lengths)
    assert plan.flat_bytes == 40_016 and plan.ntiles == len(tiles) == 5
    assert plan.sel_at == plan.flat_bytes + 16 * len(tiles)
    assert plan.nbytes == plan.sel_at + 16 and plan.npolys == 2
    slot = crc32c_torch.Slot(crc32c_torch.slot_bucket(plan.nbytes), False)
    crc32c_torch.fill_slot(slot, plan, [b"x" * 5, b"y" * 40_000])
    host = slot.host.numpy()
    assert host[:5].tobytes() == b"xxxxx" and not host[40_005:40_016].any()
    assert np.array_equal(host[plan.sel_at:plan.nbytes].view(np.int32),
                          [0, 1, 1, 0])
    with pytest.raises(ValueError, match="2 GiB"):
        crc32c_torch.plan_slot(np.array([1 << 31]), np.array([0]))
    with pytest.raises(ValueError, match="pieces hold"):
        crc32c_torch.fill_slot(slot, plan, [b"short"])
