"""The port's native enqueue lane and CPU fast paths held against the JAX
package's (test_0122, test_0134): the port builds and loads its own
extension (``tk_torch_enqlane``) in the same process as the reference's
``tk_enqlane``; on seeded runs, ``MsgsetWriterV2.build_arena``,
``frame_v2_raw`` / ``frame_v2_run``, ``iter_run_records`` and the fused
batch builder give the reference's bytes; the batched CRC and decoders
that ride the extension agree; and ``fused_codec_id`` follows the JAX
provider's rule with the transport gate open and closed.  Exact."""
import numpy as np
import pytest

from librdkafka_tpu.client import arena as ref_arena
from librdkafka_tpu.client.arena import ArenaBatch as RefArenaBatch
from librdkafka_tpu.ops import cpu as ref_cpu
from librdkafka_tpu.ops import packing as ref_packing
from librdkafka_tpu.ops.tpu import TpuCodecProvider
from librdkafka_tpu.protocol.msgset import MsgsetWriterV2 as RefWriter
from librdkafka_tpu_torch.client import arena as port_arena
from librdkafka_tpu_torch.client.arena import ArenaBatch
from librdkafka_tpu_torch.client.codec_phase import fused_builder
from librdkafka_tpu_torch.ops import cpu as port_cpu
from librdkafka_tpu_torch.ops import packing as port_packing
from librdkafka_tpu_torch.ops.gpu import GpuCodecProvider
from librdkafka_tpu_torch.ops.native.build import enqlane_error
from librdkafka_tpu_torch.protocol.msgset import MsgsetWriterV2

NOW_MS = 1_700_000_000_000
CODEC_ID = {"none": 0, "snappy": 2, "lz4": 3}


def _run(seed: int, n: int, ts: bool, hdrs: bool):
    """A seeded arena run descriptor: (base, klens, vlens, count, tss,
    hbuf, hlens) with null keys/values, explicit and unset timestamps
    and header blobs mixed in."""
    rng = np.random.default_rng(seed)
    parts, kl, vl, tss, hbufs, hl = [], [], [], [], [], []
    for i in range(n):
        k = None if rng.random() < 0.3 else b"k%05d" % i
        v = None if rng.random() < 0.05 else (
            b'{"seq": %07d, "pad": "' % i + b"ab" * int(rng.integers(0, 400))
            + b'"}')
        kl.append(-1 if k is None else len(k))
        vl.append(-1 if v is None else len(v))
        parts += [x for x in (k, v) if x is not None]
        tss.append(int(NOW_MS - rng.integers(0, 10_000))
                   if ts and rng.random() < 0.7 else 0)
        hb = (port_arena.encode_headers(
            [("h%d" % j, None if rng.random() < 0.2 else b"v%d" % j)
             for j in range(int(rng.integers(1, 4)))])
              if hdrs and rng.random() < 0.5 else b"")
        hbufs.append(hb)
        hl.append(len(hb))
    return (b"".join(parts), np.array(kl, np.int32).tobytes(),
            np.array(vl, np.int32).tobytes(), n,
            np.array(tss, np.int64).tobytes() if ts else None,
            b"".join(hbufs) if hdrs else None,
            np.array(hl, np.int32).tobytes() if hdrs else None)


def test_port_lane_loads_beside_the_reference():
    port, ref = port_arena._mod(), ref_arena._mod()
    assert port is not None, \
        f"the port's enqueue lane did not build: {enqlane_error()}"
    assert ref is not None
    assert port is not ref
    assert port.__name__ == "tk_torch_enqlane"
    assert ref.__name__ == "tk_enqlane"
    assert port.__file__.startswith(
        str(port_arena.__file__).rsplit("client", 1)[0])
    # the fast lane really is native: the lane object is the extension's
    assert type(port_arena.lane_new()).__module__ == "tk_torch_enqlane"
    assert port_cpu._ext() is port and fused_builder() is port.build_batch


@pytest.mark.parametrize("ts,hdrs", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_build_arena_and_run_framer_bytes_equal(ts, hdrs):
    base, kl, vl, n, tss, hb, hl = _run(122 + 2 * ts + hdrs, 300, ts, hdrs)
    w = MsgsetWriterV2(codec="lz4").build_arena(
        ArenaBatch(base, kl, vl, n, len(base), 0, 0, tss, hb, hl), NOW_MS)
    r = RefWriter(codec="lz4").build_arena(
        RefArenaBatch(base, kl, vl, n, len(base), 0, 0, tss, hb, hl), NOW_MS)
    assert w.records_bytes == r.records_bytes
    assert (w.record_count, w.first_timestamp, w.max_timestamp) == (
        r.record_count, r.first_timestamp, r.max_timestamp)
    assert port_cpu.frame_v2_run(base, kl, vl, n, NOW_MS, tss, hb, hl) == \
        ref_cpu.frame_v2_run(base, kl, vl, n, NOW_MS, tss, hb, hl)
    if not ts and not hdrs:
        assert port_cpu.frame_v2_raw(base, kl, vl, n) == \
            ref_cpu.frame_v2_raw(base, kl, vl, n) == w.records_bytes
    walked = list(port_packing.iter_run_records(base, kl, vl, n, tss, hb, hl))
    assert walked == list(ref_packing.iter_run_records(base, kl, vl, n, tss,
                                                       hb, hl))
    assert len(walked) == n


@pytest.mark.parametrize("codec", ["none", "lz4", "snappy"])
@pytest.mark.parametrize("idem", [False, True])
def test_fused_build_equals_reference_and_three_phase(codec, idem):
    base, kl, vl, n, tss, hb, hl = _run(7 + idem, 200, True, True)
    pid, epoch, seq = (1234, 7, 99) if idem else (-1, -1, -1)
    got = fused_builder()(base, kl, vl, n, NOW_MS, pid, epoch, seq,
                          CODEC_ID[codec], 0, tss, hb, hl)
    want = ref_arena._mod().build_batch(base, kl, vl, n, NOW_MS, pid, epoch,
                                        seq, CODEC_ID[codec], 0, tss, hb, hl)
    assert bytes(got) == bytes(want)
    # the 3-phase pipeline through the port's provider: the same bytes
    prov = port_cpu.CpuCodecProvider()
    w = MsgsetWriterV2(producer_id=pid, producer_epoch=epoch,
                       base_sequence=seq,
                       codec=None if codec == "none" else codec)
    w.build_arena(ArenaBatch(base, kl, vl, n, len(base), 0, 0, tss, hb, hl),
                  NOW_MS)
    blob = None
    if codec != "none":
        blob = prov.compress_many(codec, [w.records_bytes])[0]
        if len(blob) >= len(w.records_bytes):
            blob, w.codec = None, None
    region = w.assemble(blob)
    assert w.patch_crc(prov.crc32c_many([region])[0]) == bytes(got)


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_extension_crc_and_decoders_agree(codec):
    rng = np.random.default_rng(len(codec))
    bufs = [rng.integers(0, 4, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 150_000, 12)]
    port, ref = port_cpu.CpuCodecProvider(), ref_cpu.CpuCodecProvider()
    assert port.crc32c_many(bufs) == ref.crc32c_many(bufs)
    frames = ref.compress_many(codec, bufs)
    assert port.compress_many(codec, bufs) == frames
    assert port.decompress_many(codec, frames) == bufs
    assert port.decompress_many(codec, frames, [len(b) for b in bufs]) == bufs
    # a bad frame is isolated through the grow-and-retry path alike
    bad = frames[:2] + [b"\x00" * 16]
    with pytest.raises(Exception) as pe:
        port.decompress_many(codec, bad)
    with pytest.raises(Exception) as re_:
        ref.decompress_many(codec, bad)
    assert type(pe.value).__name__ == type(re_.value).__name__


def _gpu(gate_open: bool, lz4_force: bool = False):
    p = GpuCodecProvider(device="cpu", warmup=False, pipeline_depth=0,
                         lz4_force=lz4_force)
    if not gate_open:
        p.transport_mb_s = 0.0       # a probe that read a dead transport
    return p


def _tpu(gate_open: bool, lz4_force: bool = False):
    t = TpuCodecProvider(warmup=False, pipeline_depth=0, lz4_force=lz4_force,
                         min_transport_mb_s=0 if gate_open else 100)
    if not gate_open:
        t.transport_mb_s = 0.0
    return t


@pytest.mark.parametrize("gate_open", [True, False], ids=["open", "closed"])
@pytest.mark.parametrize("lz4_force", [False, True])
def test_fused_codec_id_follows_the_reference(gate_open, lz4_force):
    codecs = ("none", "gzip", "snappy", "lz4", "zstd")
    assert [port_cpu.CpuCodecProvider().fused_codec_id(c) for c in codecs] \
        == [ref_cpu.CpuCodecProvider().fused_codec_id(c) for c in codecs]
    g, t = _gpu(gate_open, lz4_force), _tpu(gate_open, lz4_force)
    try:
        got = [g.fused_codec_id(c) for c in codecs]
        assert got == [t.fused_codec_id(c) for c in codecs]
    finally:
        g.close()
        t.close()
    if gate_open or lz4_force:
        assert got == [None] * len(codecs)
    else:
        assert got == [0, None, 2, 3, None]
