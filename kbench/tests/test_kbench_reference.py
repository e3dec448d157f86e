"""The benchmark's plain reference: CRC32C, LZ4 frames, v2 batches and
the oracle over a topic's logs, held to published check values, to
hand-built inputs and to what the program's CPU writer produces.

    python -m pytest kbench/tests/test_kbench_reference.py
"""
from __future__ import annotations

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from kbench.lib.records import make_pool
from kbench.reference import batch as B
from kbench.reference.check import check_log
from kbench.reference.crc32c import crc32c, crc32c_many
from kbench.reference.lz4 import Lz4Error, decode_frame, xxh32

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_crc32c_check_value():
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0


@pytest.mark.parametrize("lens", [[0, 1, 3, 4, 5], [1023, 1024, 1025],
                                  [70000, 9, 2049, 131072]])
def test_crc32c_many_equals_the_loop(lens):
    rng = np.random.default_rng(len(lens))
    buf = rng.integers(0, 256, sum(lens) + 17, dtype=np.uint8).tobytes()
    starts = np.cumsum([3] + lens[:-1])
    ends = starts + np.array(lens)
    got = crc32c_many(buf, starts, ends)
    assert [int(g) for g in got] == [crc32c(buf[a:b])
                                     for a, b in zip(starts, ends)]


def test_xxh32_published_values():
    assert xxh32(b"") == 0x02CC5D05
    assert xxh32(b"abc") == 0x32D153FF


def _frame(blocks: list[bytes], raw: list[bool], checksum: bool) -> bytes:
    flg = 0x60 | (0x10 if checksum else 0)
    head = bytes([flg, 0x40])
    out = struct.pack("<I", 0x184D2204) + head
    out += bytes([(xxh32(head) >> 8) & 0xFF])
    for blk, r in zip(blocks, raw):
        out += struct.pack("<I", len(blk) | (0x80000000 if r else 0)) + blk
        if checksum:
            out += struct.pack("<I", xxh32(blk))
    return out + b"\0\0\0\0"


def test_lz4_hand_built_frame():
    # literals "abcd", then a match of 8 at offset 4 (overlapping), then
    # the last literals "xyz"
    blk = bytes([0x44]) + b"abcd" + struct.pack("<H", 4) + \
        bytes([0x30]) + b"xyz"
    assert decode_frame(_frame([blk], [False], True)) == \
        b"abcd" + b"abcdabcd" + b"xyz"
    assert decode_frame(_frame([b"plain", blk], [True, False], False)) == \
        b"plain" + b"abcdabcdabcdxyz"
    bad = bytearray(_frame([blk], [False], True))
    bad[9] ^= 1
    with pytest.raises(Lz4Error):
        decode_frame(bytes(bad))


def test_lz4_frames_of_the_programs_encoders():
    from librdkafka_tpu_torch.ops import cpu
    pool = make_pool(11, 1024, 256)
    data = [b"".join(pool), b"", b"q" * 200000, os.urandom(70000)]
    for det in (False, True):
        frames = cpu.lz4f_compress_many(data, deterministic=det)
        assert [decode_frame(f) for f in frames] == data


def _written(parts: dict, idempotent: bool = True, codec: str = "lz4"):
    """Partition logs as the program's CPU writer frames them."""
    from librdkafka_tpu_torch import CpuCodecProvider, write_batches
    from librdkafka_tpu_torch.protocol.msgset import Record
    recs = [[Record(value=v) for v in vals] for vals in parts.values()]
    wire = write_batches(CpuCodecProvider(), recs, codec,
                         now_ms=1_700_000_000_000)
    logs = {}
    for p, blob in zip(parts, wire):
        n = len(parts[p])
        blob = bytearray(blob)
        if idempotent:      # the producer's id, epoch and sequence
            struct.pack_into(">qhi", blob, 43, 7, 0, 0)
            struct.pack_into(">I", blob, 17, crc32c(bytes(blob[21:])))
        logs[p] = (0, n, bytes(blob))
    return logs


def test_v2_batches_of_the_programs_writer():
    pool = make_pool(5, 300, 64)
    logs = _written({0: pool[:40], 1: pool[40:]})
    for p, (_s, _e, log) in logs.items():
        (b,) = list(B.iter_batches(log))
        assert b.codec == "lz4" and b.crc == crc32c(log[21:])
        recs = B.parse_records(decode_frame(log[61:]), b.record_count)
        assert [r.value for r in recs] == (pool[:40] if p == 0
                                           else pool[40:])


def _judge(logs, pool, acked, **kw):
    exp = {0: pool[:40], 1: pool[40:]}
    return check_log(logs, lambda p, o: exp[p][o], acked,
                     idempotent=kw.get("idempotent", True), codec="lz4",
                     rng=np.random.default_rng(0),
                     slice_batches=kw.get("slice_batches", 8))[0]


def test_check_log_passes_a_sound_log_and_fails_each_fault():
    pool = make_pool(5, 300, 64)
    logs = _written({0: pool[:40], 1: pool[40:]})
    acked = {0: 40, 1: 24}
    assert set(_judge(logs, pool, acked).values()) == {0}
    # a byte flipped in the records: the CRC and the records disagree
    s, e, log = logs[1]
    bad = bytearray(log)
    bad[-9] ^= 0x40
    c = _judge({**logs, 1: (s, e, bytes(bad))}, pool, acked)
    assert c["crc_bad"] == 1 and (c["lz4_bad"] or c["value_bad"])
    # fewer records stored than acknowledged
    assert _judge(logs, pool, {0: 41, 1: 24})["stored_vs_acked"] == 1
    # another value at an offset
    c = _judge(logs, make_pool(6, 300, 64), acked)
    assert c["value_bad"] == 64
    # no producer id or sequences under idempotence
    plain = _written({0: pool[:40], 1: pool[40:]}, idempotent=False)
    assert _judge(plain, pool, acked)["seq_bad"] >= 2
    assert set(_judge(plain, pool, acked, idempotent=False).values()) == {0}
    # a batch cut short
    assert _judge({**logs, 1: (s, e, log[:-5])}, pool, acked)["frame_bad"]


@pytest.mark.parametrize("part", [0, 1])
def test_check_log_decodes_a_slice_of_every_partition(part):
    """One batch a partition decoded: another value in either partition's
    batch is found."""
    pool = make_pool(5, 300, 64)
    other = make_pool(6, 300, 64)
    vals = {0: pool[:40], 1: pool[40:]}
    vals[part] = (other[:40], other[40:])[part]
    c = _judge(_written(vals), pool, {0: 40, 1: 24}, slice_batches=1)
    assert c["value_bad"] == len(vals[part])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import kbench.reference.check, "
            "kbench.reference.lz4, kbench.reference.batch, "
            "kbench.reference.crc32c; print(' '.join(sorted("
            "{m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    top = set(out.split())
    assert not top & {"jax", "jaxlib", "flax", "librdkafka_tpu",
                      "librdkafka_tpu_torch", "torch"}
