"""The port's MessageSet writers produce the JAX package's wire bytes, and
its readers round-trip them.  Exact equality on wire bytes."""
import numpy as np
import pytest

from librdkafka_tpu.ops import cpu as jax_cpu
from librdkafka_tpu.protocol import msgset as jms
from librdkafka_tpu_torch.ops import cpu as port_cpu
from librdkafka_tpu_torch.protocol import msgset as pms

NOW = 1_700_000_000_000


def _spec(n: int, seed: int, *, keys: bool, values: bool, headers: bool):
    """Seeded record fields shared by both packages' Record classes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = (rng.integers(0, 256, int(rng.integers(0, 20)),
                          dtype=np.uint8).tobytes() if keys else None)
        v = (bytes(rng.integers(97, 100, int(rng.integers(0, 300)),
                                dtype=np.uint8)) if values else None)
        h = ([("h%d" % i, b"x" * i), ("n", None)] if headers else ())
        ts = NOW + i if i % 3 else -1
        out.append(dict(key=k, value=v, headers=h, timestamp=ts))
    return out


SHAPES = {
    "keys+values": dict(keys=True, values=True, headers=False),
    "values-only": dict(keys=False, values=True, headers=False),
    "null-values": dict(keys=True, values=False, headers=False),
    "headers": dict(keys=True, values=True, headers=True),
}


@pytest.mark.parametrize("codec", [None, "lz4"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_v2_writer_equals_jax(shape, codec):
    spec = _spec(40, 1, **SHAPES[shape])
    kw = dict(base_offset=7, producer_id=99, producer_epoch=2,
              base_sequence=5, codec=codec)
    jw = jms.MsgsetWriterV2(**kw).build([jms.Record(**s) for s in spec], NOW)
    pw = pms.MsgsetWriterV2(**kw).build([pms.Record(**s) for s in spec], NOW)
    assert pw.records_bytes == jw.records_bytes
    jcomp = pcomp = None
    if codec:
        jcomp = jax_cpu.lz4f_compress_many([jw.records_bytes])[0]
        pcomp = port_cpu.lz4f_compress_many([pw.records_bytes])[0]
        assert pcomp == jcomp
    assert pw.finalize(pcomp) == jw.finalize(jcomp)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_v2_write_batch_and_python_framer_equal_jax(shape):
    spec = _spec(25, 2, **SHAPES[shape])
    jwire = jms.MsgsetWriterV2(codec="lz4").write_batch(
        [jms.Record(**s) for s in spec], NOW, jax_cpu.lz4_compress)
    pwire = pms.MsgsetWriterV2(codec="lz4").write_batch(
        [pms.Record(**s) for s in spec], NOW, port_cpu.lz4_compress)
    assert pwire == jwire
    pw = pms.MsgsetWriterV2()._build_py([pms.Record(**s) for s in spec], NOW)
    assert pw.records_bytes == jms.MsgsetWriterV2()._build_py(
        [jms.Record(**s) for s in spec], NOW).records_bytes


@pytest.mark.parametrize("magic", [0, 1])
@pytest.mark.parametrize("codec", [None, "lz4"])
def test_v01_writer_equals_jax(magic, codec):
    spec = _spec(30, 3, keys=True, values=True, headers=False)
    jwire = jms.write_msgset_v01(
        [jms.Record(**s) for s in spec], magic=magic, codec=codec,
        now_ms=NOW, compress_fn=jax_cpu.lz4_compress, base_offset=100)
    pwire = pms.write_msgset_v01(
        [pms.Record(**s) for s in spec], magic=magic, codec=codec,
        now_ms=NOW, compress_fn=port_cpu.lz4_compress, base_offset=100)
    assert pwire == jwire
    # round trip through the port's legacy reader
    recs = pms.parse_msgset_v01(
        pwire, lambda c, v: port_cpu.lz4_decompress(v))
    assert [(r.key, r.value) for r in recs] == [
        (s["key"], s["value"]) for s in spec]
    assert [r.offset for r in recs] == list(range(100, 130))
    regions = pms.iter_legacy_crc_regions(pwire)
    assert regions == jms.iter_legacy_crc_regions(jwire)
    assert len(regions) == (1 if codec else 30)
    for _off, crc, region in regions:
        assert port_cpu.CpuCodecProvider().crc32_many([region]) == [crc]


@pytest.mark.parametrize("native", [True, False])
def test_v2_reader_round_trip(native):
    spec = _spec(50, 4, keys=True, values=True, headers=True)
    blob = b"".join(
        pms.MsgsetWriterV2(base_offset=base, codec=None).write_batch(
            [pms.Record(**s) for s in spec], NOW)
        for base in (0, 50))
    seen = []
    for info, payload, full in pms.iter_batches(blob + blob[:30]):
        assert pms.verify_crc_v2(info, full)
        parse = (pms.parse_records_v2 if native
                 else pms._parse_records_v2_py)
        seen.extend(parse(info, payload))
    assert [r.offset for r in seen] == list(range(100))
    assert [(r.key, r.value, list(r.headers)) for r in seen[:50]] == [
        (s["key"], s["value"], list(s["headers"])) for s in spec]


def test_split_segments_mixed_blob_equals_jax():
    spec = _spec(5, 5, keys=True, values=True, headers=False)
    v2 = pms.MsgsetWriterV2().write_batch([pms.Record(**s) for s in spec],
                                          NOW)
    v1 = pms.write_msgset_v01([pms.Record(**s) for s in spec], magic=1,
                              codec=None, now_ms=NOW)
    blob = v1 + v2 + v1
    segs = pms.split_msgset_segments(blob)
    assert [k for k, _ in segs] == ["legacy", "v2", "legacy"]
    assert segs == jms.split_msgset_segments(blob)
