"""The port's multi-device codec path (librdkafka_tpu_torch/parallel/
mesh.py, the engine's sharded launches, ``gpu.mesh.devices``, the entry
points) held against the JAX package's, test 0019 and test 0018's mesh
suite case by case.

The JAX package runs on the 8 virtual CPU devices the conftest gives it;
the port stands them in with a list of CPU devices (``["cpu"] * k``: each
shard runs the kernels' plain PyTorch versions).  The same seeded inputs
go through both; blocks, CRCs, totals and wire bytes must be equal
exactly, and equal to the native oracles.  Where a counter is
deterministic for the submissions (``sharded_launches``, each lane's
launches) the port's must equal the JAX engine's.
"""
import importlib.util
import json
import pathlib
import time
import zlib

import numpy as np
import pytest
import torch

from librdkafka_tpu import Producer as RefProducer
from librdkafka_tpu.client import conf as ref_conf_mod
from librdkafka_tpu.ops import crc32c_jax as jax_crc
from librdkafka_tpu.ops.engine import AsyncOffloadEngine as JaxEngine
from librdkafka_tpu.ops.tpu import TpuCodecProvider
from librdkafka_tpu.parallel import mesh as jax_mesh
from librdkafka_tpu_torch import Producer
from librdkafka_tpu_torch.client import conf as port_conf_mod
from librdkafka_tpu_torch.entry import dryrun_multichip, entry
from librdkafka_tpu_torch.models import codec_step
from librdkafka_tpu_torch.obs import metrics as port_metrics
from librdkafka_tpu_torch.obs import trace as port_trace
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.ops import crc32c_torch
from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
from librdkafka_tpu_torch.ops.gpu import CPU_POOL, GpuCodecProvider
from librdkafka_tpu_torch.ops.packing import pad_left
from librdkafka_tpu_torch.parallel import mesh
from librdkafka_tpu_torch.protocol.msgset import MsgsetWriterV2, Record

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCK = 65536


@pytest.fixture(autouse=True)
def _step_caches_empty():
    """The port's step cache holds no step after a test (the conftest
    checks only the JAX package's); the JAX steps a test built directly
    are released for the conftest's check, and the port's tracer and
    metrics end disabled and empty."""
    yield
    left = mesh.step_cache_count()
    mesh.release_step_cache()
    jax_mesh.release_step_cache()
    assert left == 0, f"{left} port steps outlived the test"
    assert not port_trace.enabled and port_trace.active_ring_count() == 0
    assert not port_metrics.enabled and port_metrics.registered_count() == 0


def _cpus(n):
    return ["cpu"] * n


def _jax_fallback(bufs, poly):
    from librdkafka_tpu.ops import cpu as jax_cpu
    prov = jax_cpu.CpuCodecProvider()
    return (prov.crc32c_many(bufs) if poly == "crc32c"
            else prov.crc32_many(bufs))


def _port_fallback(bufs, poly):
    prov = native.CpuCodecProvider()
    return (prov.crc32c_many(bufs) if poly == "crc32c"
            else prov.crc32_many(bufs))


def _oracle(bufs, poly="crc32c"):
    return [native.crc32c(b) if poly == "crc32c"
            else zlib.crc32(b) & 0xFFFFFFFF for b in bufs]


def _jax_compress(n, blocks, with_crc=True):
    try:
        return jax_mesh.shard_compress(jax_mesh.make_mesh(n), blocks,
                                       with_crc=with_crc)
    finally:
        jax_mesh.release_step_cache()


def _port_compress(n, blocks, with_crc=True):
    try:
        return mesh.shard_compress(mesh.make_mesh(n, _cpus(n)), blocks,
                                   with_crc=with_crc)
    finally:
        mesh.release_step_cache()


# ------------------------------------------------------------- the mesh --

def test_make_mesh_devices_and_bounds(monkeypatch):
    m = mesh.make_mesh(4, _cpus(8))
    assert m.size == 4 and m.axis_names == ("batch",)
    assert all(d == torch.device("cpu") for d in m.devices)
    assert mesh.make_mesh(devices=_cpus(3)).size == 3
    with pytest.raises(RuntimeError, match="need 5 devices"):
        mesh.make_mesh(5, _cpus(4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for bad in ({}, {"devices": ["cuda:0"]}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh(1, **bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="not visible"):
        mesh.make_mesh(devices=["cuda:0", "cuda:1"])


@pytest.mark.parametrize("with_crc", [True, False])
@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_shard_compress_matches_oracles_and_jax(ndev, with_crc):
    """test_0019: B = 5, not a multiple of the mesh; pad rows must count
    in neither the blocks nor the total."""
    rng = np.random.default_rng(23)
    blocks = [b"hello world, this is a test buffer",
              rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
              b"z" * 10000, b"", b"x"]
    outs, crcs, total = _port_compress(ndev, blocks, with_crc)
    assert outs == [native.lz4_block_compress(b) for b in blocks]
    if with_crc:
        assert [int(c) for c in crcs] == _oracle(blocks)
        assert total == sum(len(o) for o in outs)
    else:
        assert crcs is None and total == 0
    want = _jax_compress(ndev, blocks, with_crc)
    assert outs == want[0] and total == want[2]
    assert (crcs is None) == (want[1] is None)
    if with_crc:
        assert crcs.tolist() == np.asarray(want[1]).tolist()


def test_shard_compress_full_multiple():
    blocks = [(b"msg-%d " % i) * 200 for i in range(16)]
    outs, crcs, total = _port_compress(8, blocks)
    assert [int(c) for c in crcs] == _oracle(blocks)
    assert outs == [native.lz4_block_compress(b) for b in blocks]
    assert total == sum(len(o) for o in outs)
    want = _jax_compress(8, blocks)
    assert (outs, crcs.tolist(), total) == (
        want[0], np.asarray(want[1]).tolist(), want[2])


def test_shard_compress_empty_blocks():
    m = mesh.make_mesh(2, _cpus(2))
    outs, crcs, total = mesh.shard_compress(m, [])
    assert outs == [] and total == 0 and len(crcs) == 0
    outs, crcs, total = mesh.shard_compress(m, [], with_crc=False)
    assert outs == [] and crcs is None and total == 0
    assert mesh.step_cache_count() == 0


def test_step_cache_bounded_lru():
    mesh.release_step_cache()
    try:
        for i in range(mesh._STEP_CACHE_MAX):
            mesh._step_cache_put(("t", i), i)
        assert mesh.step_cache_count() == mesh._STEP_CACHE_MAX == 16
        mesh._step_cache_get(("t", 0))             # refresh: 0 is now MRU
        mesh._step_cache_put(("t", "overflow"), -1)
        assert mesh.step_cache_count() == mesh._STEP_CACHE_MAX
        assert mesh._step_cache_get(("t", 0)) == 0          # survived
        assert mesh._step_cache_get(("t", 1)) is None       # LRU evicted
        assert mesh._step_cache_get(("t", "overflow")) == -1
    finally:
        mesh.release_step_cache()
    assert mesh.step_cache_count() == 0


def test_step_cache_caches_and_reuses_steps():
    m = mesh.make_mesh(2, _cpus(2))
    try:
        mesh.shard_compress(m, [b"payload" * 64] * 4)
        assert mesh.step_cache_count() == 1
        step = mesh.sharded_codec_step(m, 512, True)
        mesh.shard_compress(m, [b"payload" * 64] * 3)     # the same shape
        assert mesh.step_cache_count() == 1
        assert mesh.sharded_codec_step(m, 512, True) is step
    finally:
        mesh.release_step_cache()
    assert mesh.step_cache_count() == 0


def _crc_rows_case(ndev, kind, Bs=8):
    """Left-padded 64 KB rows of ragged lengths, their host terms and
    polynomials: the engine's sharded layout."""
    rng = np.random.default_rng(31 + ndev)
    B = Bs * ndev
    bufs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, BLOCK + 1, B)]
    polys = ([kind] * B if kind != "fused"
             else [("crc32c", "crc32")[i % 2] for i in range(B)])
    data, _ = pad_left(bufs, BLOCK)
    sel = np.array([p == "crc32" for p in polys], np.uint32)
    return bufs, polys, data, sel


@pytest.mark.parametrize("kind", ["crc32c", "crc32", "fused"])
@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_crc_step_bitexact_vs_jax(ndev, kind):
    """Kernel G at the engine's smallest shard (8 rows of 64 KB a device):
    every device checksums its contiguous row shard; the gathered CRCs
    equal the oracle, the JAX package's sharded step on the
    same rows, and the plain version."""
    bufs, polys, data, sel = _crc_rows_case(ndev, kind)
    terms_p = np.array([crc32c_torch._term_host(len(b), p)
                        for b, p in zip(bufs, polys)], np.uint32)
    terms_j = np.array([jax_crc._term_host(len(b), p)
                        for b, p in zip(bufs, polys)], np.uint32)
    assert terms_p.tolist() == terms_j.tolist()
    want = [native.crc32c(b) if p == "crc32c"
            else zlib.crc32(b) & 0xFFFFFFFF for b, p in zip(bufs, polys)]
    devs = _cpus(ndev)
    assert not mesh.sharded_crc_ready(devs, 8, BLOCK, kind)
    mesh.warm_sharded_crc(devs, 8, BLOCK, kind)
    assert mesh.sharded_crc_ready(devs, 8, BLOCK, kind)
    m, fn = mesh.sharded_crc_step(devs, 8, BLOCK, kind)
    args = (data, terms_p, sel) if kind == "fused" else (data, terms_p)
    got = fn(*args)
    assert got.dtype == np.uint32 and got.tolist() == want
    assert mesh.sharded_crc_reference(m, data, terms_p,
                                      sel).tolist() == want
    jm, jfn = jax_mesh.sharded_crc_step(
        list(jax_mesh.make_mesh(ndev).devices.flat), 8, BLOCK, kind)
    jargs = (data, terms_j, sel) if kind == "fused" else (data, terms_j)
    assert np.asarray(jfn(*jargs)).astype(np.uint32).tolist() == want
    assert mesh.step_cache_count() == 1
    mesh.release_step_cache()


# ----------------------------------------------------------- the engine --

def _bufs(seed):
    rng = np.random.default_rng(seed)
    return [b"", b"a", b"123456789", bytes(100)] + [
        rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
        for n in [1, 63, 1000, 65535, 65536, 65537, 200_000]]


@pytest.mark.parametrize("nd", [1, 2, 0])
def test_engine_mesh_bitexact_across_device_counts(nd):
    """test_0018: the same CRC workload gives the same checksums at
    mesh_devices 1, 2 and 0 (every device of the pool: 8 lanes), across
    ring reuse and both polynomials, on the port and the JAX engine."""
    bufs = _bufs(26)
    engines = (JaxEngine(depth=2, min_batches=1, governor=False,
                         warmup=False, mesh_devices=nd,
                         cpu_fallback=_jax_fallback),
               AsyncOffloadEngine(depth=2, min_batches=1, governor=False,
                                  devices=_cpus(8), mesh_devices=nd,
                                  cpu_fallback=_port_fallback))
    try:
        for eng in engines:
            for r in range(3):
                batch = bufs[r:] + bufs[:r]
                got = eng.submit(batch, "crc32c", window=False).result(300)
                assert got.tolist() == _oracle(batch)
            got32 = eng.submit(bufs, "crc32", window=False).result(300)
            assert got32.tolist() == _oracle(bufs, "crc32")
            assert len(eng._lanes) == (nd if nd else 8)
            if nd != 1:
                # the least-loaded pick spreads cold lanes first
                assert sum(1 for ln in eng._lanes if ln.launches) >= 2
        jax_e, port_e = engines
        assert port_e.stats["launches"] == jax_e.stats["launches"] == 4
    finally:
        for e in engines:
            e.close()


def test_engine_mesh_sharded_launch_bitexact_and_counted():
    """17 blocks over 2 lanes (>= SHARD_MIN_ROWS each): one sharded
    launch, exact; every lane records it with its share of the blocks;
    the pseudo-lane drains; close releases the steps."""
    eng = AsyncOffloadEngine(depth=2, min_batches=1, governor=False,
                             devices=_cpus(2), cpu_fallback=_port_fallback)
    try:
        rng = np.random.default_rng(27)
        bufs = [rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
                for _ in range(16)] + [b"tail-block" * 7]
        got = eng.submit(bufs, "crc32c", window=False).result(300)
        assert got.tolist() == _oracle(bufs)
        assert eng.stats["sharded_launches"] == 1 == eng.stats["launches"]
        rows = eng.devices_snapshot()
        assert [r["id"] for r in rows] == [0, 1]
        assert all(r["launches"] == 1 and r["blocks"] >= 1 for r in rows)
        assert sum(r["blocks"] for r in rows) == 17 == eng.stats["blocks"]
        assert all(r["dev_launch_ms"] for r in rows)
        assert eng._shard_lane is not None and eng._shard_lane.dev_id == -1
        assert not eng._shard_lane.inflight
        assert mesh.step_cache_count() == 1
    finally:
        eng.close()
    assert mesh.step_cache_count() == 0


@pytest.mark.parametrize("nd", [2, 0])
def test_engine_sharded_counts_agree_with_jax(nd):
    """One small group (whole, to lane 0 on both: every lane is cold),
    then two groups of 8 blocks a lane with a crc32 job fused in (the
    fan-in window, never met, merges each pair): the port's and the JAX
    engine's sharded_launches, fused_launches and per-lane launch counts
    agree, and the CRCs equal the oracle."""
    n = nd or 8
    rng = np.random.default_rng(40 + n)
    small = [b"small-%d" % i * 30 for i in range(3)]
    big = [rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
           for _ in range(8 * n - 1)] + [b"tail" * 99]
    legacy = [b"legacy-region" * 50]
    counts = []
    kw = dict(depth=2, min_batches=10_000, fanin_window_s=0.2,
              governor=True, mesh_devices=nd, cpu_fallback=None)
    for eng in (JaxEngine(warmup=False, **kw),
                AsyncOffloadEngine(devices=_cpus(8), **kw)):
        try:
            assert eng.submit(small, "crc32c", window=False).result(
                300).tolist() == _oracle(small)
            for _ in range(2):
                t1 = eng.submit(big, "crc32c", window=True)
                t2 = eng.submit(legacy, "crc32", window=True)
                assert t1.result(300).tolist() == _oracle(big)
                assert t2.result(300).tolist() == _oracle(legacy, "crc32")
            counts.append(({k: eng.stats[k] for k in (
                "launches", "sharded_launches", "fused_launches")},
                [ln.launches for ln in eng._lanes]))
        finally:
            eng.close()
    assert counts[0] == counts[1]
    stats, lanes = counts[1]
    assert stats["sharded_launches"] >= 1 and len(lanes) == n


def test_engine_mesh_governor_explore_and_fanin_skip_bitexact():
    """test_0018: the governor's exploration and the low-rate fan-in
    skip stay exact with 8 lanes; per-lane EWMAs for more than one lane."""
    eng = AsyncOffloadEngine(depth=2, fanin_window_s=0.3, min_batches=2,
                             governor=True, devices=_cpus(8),
                             mesh_devices=0, cpu_fallback=_port_fallback)
    try:
        rng = np.random.default_rng(28)
        bufs = [rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
                for _ in range(2)]
        want = _oracle(bufs)
        for _ in range(4):
            assert eng.submit(bufs, "crc32c",
                              window=False).result(300).tolist() == want
        assert eng.submit(bufs[:1], "crc32c",
                          window=False).result(60).tolist() == want[:1]
        g = eng.governor
        snap0 = g.snapshot()
        assert snap0["dev_launch_ms"] and snap0["cpu_ns_per_byte"] is not None
        assert len([d for d in range(8) if g.device_launch_ms(d)]) >= 2
        for _ in range(2 * g.EXPLORE_EVERY):
            assert eng.submit(bufs, "crc32c",
                              window=False).result(60).tolist() == want
        assert eng.stats["explore_routes"] >= 1, eng.stats
        assert eng.governor_snapshot()["dev_launch_ms"]
        # the inter-arrival EWMA climbs past the 0.3 s cap within a few
        # 0.45 s gaps, whatever the rate before
        last = None
        for _ in range(6):
            t0 = time.perf_counter()
            t = eng.submit(bufs[:1], "crc32c", window=True)
            assert t.result(60).tolist() == want[:1]
            last = time.perf_counter() - t0
            time.sleep(0.45)
        assert eng.stats["fanin_skips"] >= 1, eng.stats
        assert last < 0.15, f"still paying the window: {last:.3f}s"
    finally:
        eng.close()


def test_engine_close_racing_warmup_on_device_k():
    """close() racing the warmup sweep after it warmed lane 7 drains:
    every ticket resolves, both threads join, nothing stays in flight on
    any lane (the pseudo-lane included) and the steps are released."""
    eng = AsyncOffloadEngine(depth=2, min_batches=1, governor=True,
                             warmup=True, devices=_cpus(8), mesh_devices=0,
                             cpu_fallback=_port_fallback)
    try:
        eng._request_warm(7)
        assert eng.warm_wait(timeout=300, device=7)
        t = eng.submit([b"racing-mesh-warmup" * 200], "crc32c",
                       window=False)
    finally:
        eng.close()
    assert t.result(5).tolist() == _oracle([b"racing-mesh-warmup" * 200])
    assert not eng._warmup_thread.is_alive()
    assert not eng._thread.is_alive()
    assert eng._shard_lane is not None
    for ln in eng._all_lanes():
        assert not ln.inflight, "lane left launches in flight"
    assert mesh.step_cache_count() == 0


def test_engine_cold_sharded_step_goes_whole_and_warms():
    """With warmup on, a group whose sharded step is not built goes whole
    to one lane (no stall) and asks for the step; once built, the same
    group shards."""
    eng = AsyncOffloadEngine(depth=2, min_batches=1, governor=False,
                             warmup=True, devices=_cpus(2),
                             cpu_fallback=_port_fallback)
    try:
        assert eng.warm_wait(60, device=0) and eng.warm_wait(60, device=1)
        bufs = [bytes([i]) * 40_000 for i in range(16)]      # 16 blocks
        Bs = eng._shard_bucket(16, 2)
        mesh.release_step_cache()
        got = eng.submit(bufs, "crc32c", window=False).result(120)
        assert got.tolist() == _oracle(bufs)
        deadline = time.monotonic() + 60
        while not mesh.sharded_crc_ready(_cpus(2), Bs, BLOCK, "crc32c"):
            assert time.monotonic() < deadline, "the step never warmed"
            time.sleep(0.02)
        before = eng.stats["sharded_launches"]
        got = eng.submit(bufs, "crc32c", window=False).result(120)
        assert got.tolist() == _oracle(bufs)
        assert eng.stats["sharded_launches"] == before + 1
    finally:
        eng.close()


def test_shard_chunks_cut_at_buffer_bounds():
    """Shards hold about equal bytes, cut at buffer bounds; one huge
    buffer leaves the other shards empty; cuts cover every buffer."""
    lens = np.array([10, 10, 10, 10, 10, 10, 10, 10], np.int64)
    [(cuts, Bs)] = AsyncOffloadEngine._shard_chunks(lens, 4)
    assert cuts == [0, 2, 4, 6, 8] and Bs == 8
    lens = np.array([1000, 1, 1, 1], np.int64)
    [(cuts, _)] = AsyncOffloadEngine._shard_chunks(lens, 2)
    assert cuts[0] == 0 and cuts[-1] == 4 and cuts == sorted(cuts)
    assert AsyncOffloadEngine._shard_bucket(17, 2) == 16
    assert AsyncOffloadEngine._shard_bucket(64 * 8, 8) == 128


# ------------------------------------------------------- the provider --

def _wire_build(provider, ticketed: bool) -> bytes:
    """test_0018's writer-level build: one batch spans enough 64 KB
    blocks to take the sharded route on a 2-lane mesh."""
    now = 1_700_000_000_000
    rng = np.random.default_rng(29)
    batches = [
        [Record(key=b"k%d" % i, value=(b"mesh-%d " % i) * 30,
                timestamp=now + i) for i in range(16)],
        [Record(key=None, value=rng.integers(
            0, 256, 70_000, dtype=np.uint8).tobytes(), timestamp=now)
         for _ in range(18)],
        [Record(key=b"solo", value=b"x", timestamp=now)],
    ]
    wires = []
    for msgs in batches:
        w = MsgsetWriterV2(codec="lz4")
        w.build(msgs, now)
        blob = provider.compress_many("lz4", [w.records_bytes])[0]
        if len(blob) >= len(w.records_bytes):
            blob, w.codec = None, None
        region = w.assemble(blob)
        if ticketed:
            t = provider.crc32c_submit([region])
            assert t is not None
            crc = int(t.result(300)[0])
        else:
            crc = int(provider.crc32c_many([region])[0])
        wires.append(w.patch_crc(crc))
    return b"".join(wires)


@pytest.mark.parametrize("nd", [1, 2, 0])
def test_mesh_produce_wire_bitexact_across_device_counts(nd):
    """The port provider's wire bytes at mesh_devices 1, 2 and 0 equal
    the CPU provider's and the JAX provider's at the same count."""
    want = _wire_build(native.CpuCodecProvider(), ticketed=False)
    port = GpuCodecProvider(device="cpu", min_batches=1, warmup=False,
                            min_transport_mb_s=0, mesh_devices=nd)
    ref = TpuCodecProvider(min_batches=1, warmup=False,
                           min_transport_mb_s=0, mesh_devices=nd)
    try:
        assert _wire_build(port, ticketed=True) == want
        assert _wire_build(ref, ticketed=True) == want
        eng = port._engine
        assert len(eng._lanes) == (nd or CPU_POOL)
        assert eng.stats["sharded_launches"] == (1 if nd == 2 else 0)
    finally:
        port.close()
        ref.close()


def test_provider_lz4_force_shards_over_the_mesh():
    """lz4_force with mesh_devices 2: the synchronous device route goes
    through shard_compress; frames equal the deterministic encoder's, and
    close() releases the step."""
    prov = GpuCodecProvider(device="cpu", min_batches=1, warmup=False,
                            pipeline_depth=0, lz4_force=True,
                            mesh_devices=2, min_transport_mb_s=0)
    bufs = [b"", b"abc" * 3000, bytes(range(256)) * 40, b"q"]
    try:
        got = prov.compress_many("lz4", bufs)
        assert got == native.lz4f_compress_many(bufs, deterministic=True)
        assert prov._mesh is not None and prov._mesh.size == 2
        assert mesh.step_cache_count() == 1
    finally:
        prov.close()
    assert mesh.step_cache_count() == 0


# ------------------------------------------------------ conf and stats --

def test_conf_gpu_mesh_devices_reaches_the_engine():
    """gpu.mesh.devices: the twin of tpu.mesh.devices (type, default,
    range), passed to the provider; the engine takes that many lanes of
    the CPU pool."""
    ref = {p.name: p for p in ref_conf_mod.PROPERTIES}
    port = {p.name: p for p in port_conf_mod.PROPERTIES}
    r, g = ref["tpu.mesh.devices"], port["gpu.mesh.devices"]
    assert (g.ptype, g.default, g.vmin, g.vmax, g.app) == (
        r.ptype, r.default, r.vmin, r.vmax, r.app)
    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "compression.backend": "gpu", "gpu.device": "cpu",
                  "gpu.mesh.devices": 3, "gpu.governor": False,
                  "gpu.launch.min.batches": 1, "linger.ms": 1})
    try:
        prov = p._rk.codec_provider
        assert prov.mesh_devices == 3
        for i in range(8):
            p.produce("md", value=b"v%d" % i * 50, partition=0)
        assert p.flush(120) == 0
        assert len(prov._engine._lanes) == 3
    finally:
        p.close()


def test_stats_devices_rows_equal_reference():
    """test_0053 :445 at mesh devices 2: codec_engine.devices[] has one
    row a lane with the reference's keys, and sharded_launches is there."""
    conf = {"bootstrap.servers": "", "test.mock.num.brokers": 1,
            "compression.codec": "lz4", "linger.ms": 2,
            "compression.backend": "tpu", "tpu.transport.min.mb.s": 0,
            "tpu.launch.min.batches": 1, "tpu.governor": False,
            "tpu.mesh.devices": 2}
    port_conf = {k.replace("tpu.", "gpu."): v for k, v in conf.items()}
    port_conf.update({"compression.backend": "gpu", "gpu.device": "cpu"})
    blobs = []
    for make, c in ((RefProducer, conf), (Producer, port_conf)):
        p = make(c)
        try:
            for i in range(40):
                p.produce("st", value=b"v%d" % i * 40, partition=i % 2)
            assert p.flush(120) == 0
            blobs.append(json.loads(p._rk.stats.emit_json())["codec_engine"])
        finally:
            p.close()
    ref, port = blobs
    assert "sharded_launches" in port and "sharded_launches" in ref
    assert len(port["devices"]) == len(ref["devices"]) == 2
    assert [sorted(r) for r in port["devices"]] == \
        [sorted(r) for r in ref["devices"]]
    assert [r["id"] for r in port["devices"]] == [0, 1]


def test_device_launch_span_args():
    """test_0126 :96-100 on the port's engine: the device_launch span
    carries route, explored, fused, bucket, blocks, device and sharded;
    a sharded launch has device -1, a whole one its lane id."""
    port_trace.enable()
    eng = AsyncOffloadEngine(depth=2, min_batches=1, governor=False,
                             devices=_cpus(2), cpu_fallback=_port_fallback)
    try:
        big = [bytes([i]) * BLOCK for i in range(16)]
        assert eng.submit(big, "crc32c", window=False).result(
            120).tolist() == _oracle(big)
        assert eng.submit([b"one"], "crc32c", window=False).result(
            120).tolist() == _oracle([b"one"])
        evs = port_trace.collect_events()
    finally:
        eng.close()
        port_trace.disable()
    launches = [e for e in evs if e["name"] == "device_launch"]
    assert len(launches) == 2
    for e in launches:
        assert e["args"]["route"] == "device"
        assert {"explored", "fused", "bucket", "blocks", "device",
                "sharded"} <= set(e["args"])
        assert e["args"]["device"] >= -1
    assert [(e["args"]["sharded"], e["args"]["device"]) for e in launches] \
        == [(True, -1), (False, 0)]
    rbs = [e for e in evs if e["name"] == "readback"]
    assert rbs and all("device" in e["args"] for e in rbs)


# ---------------------------------------------------------- entry points --

def test_models_export_the_reference_names():
    from librdkafka_tpu import models as ref_models
    from librdkafka_tpu_torch import models
    assert models.__all__ == ref_models.__all__
    assert models.batched_codec_step is codec_step.batched_codec_step


def test_entry_matches_the_jax_entry():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", REPO / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jstep, (jdata, jlens) = graft.entry()
    step, (data, lens) = entry(device="cpu")
    assert data.device.type == "cpu"
    assert data.numpy().tolist() == np.asarray(jdata).tolist()
    out, olen, crc = step(data, lens)
    jout, jolen, jcrc = (np.asarray(x) for x in jstep(jdata, jlens))
    assert olen.numpy().tolist() == jolen.tolist()
    for r in range(len(olen)):
        n = int(olen[r])
        assert out[r, :n].numpy().tobytes() == jout[r, :n].tobytes()
    assert crc.numpy().astype(np.uint32).tolist() == \
        jcrc.astype(np.uint32).tolist()


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_dryrun_multichip_on_cpu_devices():
    try:
        dryrun_multichip(4, devices=_cpus(4))
        assert mesh.step_cache_count() == 1
    finally:
        mesh.release_step_cache()


def test_dryrun_multichip_raises_without_four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        dryrun_multichip(4)
    assert mesh.step_cache_count() == 0
