"""The port's GpuCodecProvider seams (ops/gpu.py) held against the JAX
package's TpuCodecProvider: the submit seams resolve to the oracle's
CRCs, a closed transport gate declines them (None, no engine), the
pipeline off keeps the synchronous route, and the probe's disk cache is
the port's own file.  Provider engines run on a CPU lane
(``device="cpu"``: the kernel's plain PyTorch version)."""
import os

import numpy as np
import pytest

from librdkafka_tpu.ops.tpu import TpuCodecProvider
from librdkafka_tpu_torch import GpuCodecProvider
from librdkafka_tpu_torch.obs import metrics as port_metrics
from librdkafka_tpu_torch.obs import trace as port_trace
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.ops import crc32c_torch, gpu
from librdkafka_tpu_torch.ops.engine import SyncTicket, Ticket

BUFS = [b"semi" * 300, bytes(range(256)) * 4, b"", b"q",
        b"n" * 65535, b"o" * 70_000]


@pytest.fixture(autouse=True)
def _port_obs_clean():
    """The conftest checks the JAX package's obs state; this checks the
    port's: tracer and metrics disabled and empty after each test."""
    yield
    assert not port_trace.enabled and port_trace.active_ring_count() == 0
    assert not port_metrics.enabled and port_metrics.registered_count() == 0


def _want(bufs=BUFS):
    return [native.crc32c(b) for b in bufs]


def test_provider_pipelined_crc_bitexact():
    """The submit seams resolve to the same values as the synchronous
    interface, the oracle and the JAX provider's seam."""
    jax_p = TpuCodecProvider(min_batches=1, warmup=False,
                             min_transport_mb_s=0)
    prov = GpuCodecProvider(device="cpu", min_batches=1)
    try:
        assert prov.wait_warm(60)
        t = prov.crc32c_submit(BUFS)
        assert isinstance(t, Ticket)
        assert t.result(120).tolist() == _want()
        assert prov.crc32c_many(BUFS) == _want()
        assert jax_p.crc32c_submit(BUFS).result(120).tolist() == _want()
        legacy = prov.crc32_submit(BUFS).result(120).tolist()
        assert legacy == jax_p.crc32_many(BUFS) == prov.crc32_many(BUFS)
        eng = prov._engine
        assert eng is not None and eng.stats["launches"] >= 1
        assert eng._thread.name == "gpu-codec-engine"
    finally:
        prov.close()
        jax_p.close()


def test_provider_host_job_seams():
    """compress_submit / decompress_submit ride the engine as host jobs
    and give the CPU provider's bytes."""
    prov = GpuCodecProvider(device="cpu", min_batches=1)
    cpu_p = native.CpuCodecProvider()
    try:
        bufs = [b"compress me " * 200, b"x" * 5000]
        comp = prov.compress_submit("lz4", bufs).result(60)
        assert comp == cpu_p.compress_many("lz4", bufs)
        dec = prov.decompress_submit("lz4", comp).result(60)
        assert dec == bufs
        assert prov._engine.stats["host_jobs"] == 2
    finally:
        prov.close()


def test_crc_transport_gate(monkeypatch):
    """Below tpu.transport.min.mb.s the CRC stays on the CPU; above it,
    or with the gate disabled, it offloads; values bit-identical."""
    calls = []
    real = crc32c_torch.crc_segments
    monkeypatch.setattr(crc32c_torch, "crc_segments",
                        lambda *a: calls.append(1) or real(*a))
    slow = GpuCodecProvider(device="cpu", min_batches=1, warmup=False,
                            min_transport_mb_s=100.0)
    slow.transport_mb_s = 2.0                     # a slow-link reading
    assert slow.crc32c_many(BUFS) == _want()
    assert calls == [] and slow._engine is None
    fast = GpuCodecProvider(device="cpu", min_batches=1, warmup=False,
                            min_transport_mb_s=100.0)
    fast.transport_mb_s = 10_000.0                # PCIe-class reading
    off = GpuCodecProvider(device="cpu", min_batches=1, warmup=False,
                           min_transport_mb_s=0)
    off.transport_mb_s = 2.0
    try:
        for prov in (fast, off):
            before = len(calls)
            assert prov.crc32c_many(BUFS) == _want()
            assert len(calls) == before + 1
    finally:
        for prov in (slow, fast, off):
            prov.close()


def test_provider_submit_declines_below_gate():
    """A closed gate returns None from the CRC submit seams (the caller
    stays on the synchronous CPU path, no engine spun); with the
    pipeline off every submit seam returns None — as the JAX provider."""
    for cls, kw in ((GpuCodecProvider, {"device": "cpu"}),
                    (TpuCodecProvider, {})):
        prov = cls(min_batches=1, warmup=False, min_transport_mb_s=100.0,
                   **kw)
        prov.transport_mb_s = 2.0
        assert prov.crc32c_submit([b"x" * 100]) is None
        assert prov._engine is None
        off = cls(min_batches=1, warmup=False, min_transport_mb_s=0,
                  pipeline_depth=0, **kw)
        assert off.crc32c_submit([b"x" * 100]) is None
        assert off.decompress_submit("lz4", [b""]) is None
        prov.close()
        off.close()
    off = GpuCodecProvider(device="cpu", min_batches=1, warmup=False,
                           pipeline_depth=0)
    assert off.crc32_submit([b"x"]) is None
    assert off.compress_submit("lz4", [b"x"]) is None
    assert off.crc32c_many(BUFS) == _want()       # the synchronous route


def test_cpu_provider_submit_seams_are_resolved():
    """The port's CPU provider answers the seams with SyncTickets, as the
    JAX CPU provider does."""
    p = native.CpuCodecProvider()
    t = p.crc32c_submit(BUFS)
    assert isinstance(t, SyncTicket) and t.done()
    assert t.result().tolist() == _want()
    assert p.crc32_submit([b"abc"]).result().tolist() == [0x352441C2]
    comp = p.compress_many("lz4", [b"z" * 300])
    assert p.decompress_submit("lz4", comp).result() == [b"z" * 300]


def test_probe_cache_is_the_ports_own(monkeypatch):
    """The transport probe's disk cache is keyed on the port and on
    CUDA_VISIBLE_DEVICES, so neither package reads the other's reading
    (the JAX provider's file is tk_transport_{uid}_{JAX_PLATFORMS})."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,3")
    path = gpu.probe_cache_path("cuda:0")
    name = os.path.basename(path)
    assert name.startswith("tk_torch_transport_")
    assert "1-3" in name and "cuda-0" in name
    jax_name = f"tk_transport_{os.getuid()}_cpu.json"
    assert name != jax_name
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert gpu.probe_cache_path("cuda:0") != path


def test_probe_reading_from_cache_and_failure(monkeypatch, tmp_path):
    """A fresh cache file of ours is read without a subprocess; a probe
    that cannot run reads 0.0, which closes the gate."""
    monkeypatch.setattr(gpu, "probe_cache_path",
                        lambda device: str(tmp_path / f"{device}.json"))
    (tmp_path / "cuda:0.json").write_text('{"mb_s": 5000.0}')
    assert gpu._probe_cached("cuda:0") == 5000.0

    def no_python(*a, **k):
        raise OSError("no interpreter")

    monkeypatch.setattr("subprocess.run", no_python)
    assert gpu._probe_cached("cuda:1") == 0.0
    assert not (tmp_path / "cuda:1.json").exists()


def test_cpu_device_gate_needs_no_probe(monkeypatch):
    """A CPU device has no transport: its gate opens without a probe."""
    monkeypatch.setattr(gpu, "_probe_cached", lambda d: pytest.fail(
        "probed a CPU device"))
    prov = GpuCodecProvider(device="cpu", warmup=False)
    assert prov._offload_pays()
    prov.close()


def test_default_provider_and_engine_raise_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GpuCodecProvider()


def test_close_joins_and_serves_synchronously_after():
    """close() drains the engine and joins the warmup thread; a call
    after close() is served synchronously and spawns nothing."""
    prov = GpuCodecProvider(device="cpu", min_batches=1)
    t = prov.crc32c_submit(BUFS)
    prov.close()
    assert t.done() and t.result(0).tolist() == _want()
    assert prov._warmup_thread is None
    assert prov.crc32c_submit(BUFS) is None
    assert prov.crc32c_many(BUFS) == _want()
    assert prov._engine is None
    np.testing.assert_array_equal(
        np.asarray(prov.crc32_many([b"abc"])), [0x352441C2])
