"""The port's writer phase and fetch verify (client/codec_phase.py) held
against the same flow through the JAX package: MsgsetWriterV2 +
TpuCodecProvider on its synchronous route, compress_many → assemble →
crc32c_many → patch_crc.  Exact equality on wire bytes."""
import numpy as np
import pytest
import torch

from librdkafka_tpu.ops import cpu as jax_cpu
from librdkafka_tpu.ops.tpu import TpuCodecProvider
from librdkafka_tpu.protocol import msgset as jms
from librdkafka_tpu_torch import (CpuCodecProvider, GpuCodecProvider,
                                  read_batches, submit_batches, submit_read,
                                  write_batches)
from librdkafka_tpu_torch.obs import metrics as port_metrics
from librdkafka_tpu_torch.obs import trace as port_trace
from librdkafka_tpu_torch.ops import crc32c_torch
from librdkafka_tpu_torch.ops.cpu import SyncTicket
from librdkafka_tpu_torch.ops.engine import Ticket
from librdkafka_tpu_torch.ops.packing import FrameBlob
from librdkafka_tpu_torch.protocol import msgset as pms
from librdkafka_tpu_torch.utils.crc import crc32c

NOW = 1_700_000_000_000
PARTS, RECORDS, SIZE = 8, 50, 1024


def _values(seed: int = 0) -> list[list[bytes]]:
    """Seeded, compressible 1 KB values (a few random words repeated)."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, 8, dtype=np.uint8).tobytes()
             for _ in range(16)]
    return [[b"".join(words[int(w)] for w in rng.integers(0, 16, SIZE // 8))
             for _ in range(RECORDS)] for _ in range(PARTS)]


def _jax_wire(values) -> list[bytes]:
    prov = TpuCodecProvider(min_batches=1, warmup=False,
                            min_transport_mb_s=0, pipeline_depth=0)
    try:
        writers = [jms.MsgsetWriterV2(codec="lz4").build(
            [jms.Record(value=v) for v in vals], NOW) for vals in values]
        comp = prov.compress_many("lz4", [w.records_bytes for w in writers])
        regions = []
        for w, c in zip(writers, comp):
            if len(c) >= len(w.records_bytes):
                c = None
                w.codec = None
            regions.append(w.assemble(c))
        crcs = prov.crc32c_many(regions)
        return [w.patch_crc(int(c)) for w, c in zip(writers, crcs)]
    finally:
        prov.close()


def _parts(values):
    return [[pms.Record(value=v) for v in vals] for vals in values]


@pytest.fixture(autouse=True)
def _port_obs_clean():
    """The conftest checks the JAX package's obs state; this checks the
    port's: tracer and metrics disabled and empty after each test."""
    yield
    assert not port_trace.enabled and port_trace.active_ring_count() == 0
    assert not port_metrics.enabled and port_metrics.registered_count() == 0


@pytest.fixture
def gpu_cpu():
    prov = GpuCodecProvider(device="cpu", min_batches=1)
    yield prov
    prov.close()


def test_write_batches_equals_jax_flow(gpu_cpu):
    values = _values()
    before = crc32c_torch.launches
    wire = write_batches(gpu_cpu, _parts(values), "lz4", NOW)
    assert crc32c_torch.launches == before      # CPU path: no launch
    assert wire == _jax_wire(values)
    assert wire == write_batches(CpuCodecProvider(), _parts(values), "lz4",
                                 NOW)


def test_read_batches_round_trip_and_crc_mismatch(gpu_cpu):
    values = _values(1)
    wire = write_batches(gpu_cpu, _parts(values), "lz4", NOW)
    recs = read_batches(gpu_cpu, wire)
    assert [[r.value for r in part] for part in recs] == values
    assert [r.offset for r in recs[0]] == list(range(RECORDS))
    bad = bytearray(wire[3])
    bad[-1] ^= 0x01
    with pytest.raises(pms.CrcMismatch):
        read_batches(gpu_cpu, wire[:3] + [bytes(bad)])


def test_read_batches_legacy_and_mixed(gpu_cpu):
    values = _values(2)
    legacy = [pms.write_msgset_v01(
        [pms.Record(value=v) for v in vals], magic=1, codec="lz4",
        now_ms=NOW, compress_fn=jax_cpu.lz4_compress) for vals in values]
    v2 = write_batches(gpu_cpu, _parts(values), "lz4", NOW)
    recs = read_batches(gpu_cpu, legacy + [legacy[0] + v2[1]])
    assert [[r.value for r in part] for part in recs[:PARTS]] == values
    assert [r.value for r in recs[PARTS]] == values[0] + values[1]
    bad = bytearray(legacy[2])
    bad[-1] ^= 0x01
    with pytest.raises(pms.CrcMismatch, match="legacy"):
        read_batches(gpu_cpu, [bytes(bad)])


def test_incompressible_and_uncompressed_batches(gpu_cpu):
    rng = np.random.default_rng(3)
    noise = [[rng.integers(0, 256, SIZE, dtype=np.uint8).tobytes()
              for _ in range(4)]]
    for codec in ("lz4", None):
        wire = write_batches(gpu_cpu, _parts(noise), codec, NOW)
        info = next(pms.iter_batches(wire[0]))[0]
        assert info.codec is None                 # sent plain
        assert wire == write_batches(CpuCodecProvider(), _parts(noise),
                                     codec, NOW)
        assert [r.value for r in read_batches(gpu_cpu, wire)[0]] == noise[0]


def test_frame_blob_folds_the_batch_crc(gpu_cpu):
    """A FrameBlob (fused compress→CRC frame) skips the CRC launch: its
    per-part CRCs fold into the batch CRC the region scan would give."""
    values = _values(4)[:2]

    class FramingProvider(GpuCodecProvider):
        def compress_many(self, codec, bufs, level=-1):
            out = super().compress_many(codec, bufs, level)
            return [FrameBlob([(c[:7], crc32c(c[:7])),
                               (c[7:], crc32c(c[7:]))]) for c in out]

        def crc32c_many(self, bufs):
            raise AssertionError("FrameBlob batches need no CRC pass")

    prov = FramingProvider(device="cpu", min_batches=1)
    try:
        assert write_batches(prov, _parts(values), "lz4", NOW) == \
            write_batches(gpu_cpu, _parts(values), "lz4", NOW)
    finally:
        prov.close()


def test_min_batches_routes_small_calls_to_cpu(monkeypatch):
    prov = GpuCodecProvider(device="cpu", min_batches=4, pipeline_depth=0)
    calls = []
    monkeypatch.setattr(crc32c_torch, "crc_segments",
                        lambda *a: calls.append(a) or
                        crc32c_torch.crc_segments_reference(*a))
    assert prov.crc32c_many([b"a", b"b"]) == [crc32c(b"a"), crc32c(b"b")]
    assert calls == []
    prov.crc32c_many([b"a"] * 4)
    assert len(calls) == 1
    assert prov.fused_codec_id("lz4") is None


def test_default_provider_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GpuCodecProvider()


# ------------------------------------------------ ticketed codec phases --

def test_submit_batches_pipelined_equals_sync_and_jax(gpu_cpu):
    """Round k+1 is submitted before round k resolves: compress rides the
    engine as a host job and the CRCs as a ticket; every round's wire
    equals the synchronous route's, the CPU provider's and the JAX
    package's flow."""
    rounds = [_values(10 + k) for k in range(3)]
    pend = [submit_batches(gpu_cpu, _parts(v), "lz4", NOW) for v in rounds]
    assert isinstance(pend[0].comp[1], Ticket)
    sync = GpuCodecProvider(device="cpu", min_batches=1, pipeline_depth=0)
    try:
        for p, values in zip(pend, rounds):
            wire = p.result(120)
            assert p.done()
            assert wire == write_batches(sync, _parts(values), "lz4", NOW)
            assert wire == write_batches(CpuCodecProvider(), _parts(values),
                                         "lz4", NOW)
            assert wire == _jax_wire(values)
    finally:
        sync.close()
    eng = gpu_cpu._engine
    assert eng.stats["host_jobs"] == 3
    assert eng.stats["launches"] + eng.stats["warmup_miss_jobs"] >= 1


def test_submit_batches_without_seams_is_synchronous():
    """A provider without submit seams resolves each stage at submit."""
    class Plain:
        compress_many = CpuCodecProvider().compress_many
        crc32c_many = CpuCodecProvider().crc32c_many

    values = _values(5)
    p = submit_batches(Plain(), _parts(values), "lz4", NOW)
    assert p.comp is None and isinstance(p.crc, SyncTicket)
    assert p.result() == write_batches(CpuCodecProvider(), _parts(values),
                                       "lz4", NOW)


def test_submit_read_ticketed_crc_mismatch(gpu_cpu):
    """The ticketed verify: every CRC and decompress job is submitted
    before any resolves; a flipped byte raises CrcMismatch at resolve."""
    values = _values(6)
    wire = write_batches(gpu_cpu, _parts(values), "lz4", NOW)
    pend = submit_read(gpu_cpu, wire)
    assert isinstance(pend.v2, Ticket) and len(pend.dec) == 1
    assert [[r.value for r in part] for part in pend.result(120)] == values
    bad = bytearray(wire[2])
    bad[-1] ^= 0x01
    pend = submit_read(gpu_cpu, wire[:2] + [bytes(bad)])
    with pytest.raises(pms.CrcMismatch):
        pend.result(120)
    assert pend.done()


def test_submit_read_mixed_v2_and_legacy(gpu_cpu):
    """v2 batches and MsgVer1 lz4 wrappers in one fetch: the v2 regions
    ride crc32c_submit, the legacy ones crc32_submit (both polynomials
    may fuse into one launch); records equal the JAX package's reader
    and the CPU provider's."""
    values = _values(7)
    legacy = [pms.write_msgset_v01(
        [pms.Record(value=v) for v in vals], magic=1, codec="lz4",
        now_ms=NOW, compress_fn=jax_cpu.lz4_compress) for vals in values]
    v2 = write_batches(gpu_cpu, _parts(values), "lz4", NOW)
    blobs = [legacy[0] + v2[1], v2[2], legacy[3]]
    pend = submit_read(gpu_cpu, blobs)
    assert isinstance(pend.legacy, Ticket) and isinstance(pend.v2, Ticket)
    got = [[r.value for r in part] for part in pend.result(120)]
    assert got == [values[0] + values[1], values[2], values[3]]
    assert got == [[r.value for r in part]
                   for part in read_batches(CpuCodecProvider(), blobs)]
    jax_vals = [[m.value for m in jms.parse_msgset_v01(
        legacy[3], lambda c, v: jax_cpu.CpuCodecProvider().decompress_many(
            c, [v])[0])]]
    assert got[2:] == jax_vals
    bad = bytearray(legacy[3])
    bad[-1] ^= 0x01
    with pytest.raises(pms.CrcMismatch, match="legacy"):
        submit_read(gpu_cpu, [v2[2], bytes(bad)]).result(120)
