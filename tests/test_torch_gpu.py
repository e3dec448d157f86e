"""Tests of the port that need a CUDA card: the hand-written segment kernel
(csrc/crc_rows.cu), through ``crc_rows`` and ``crc_segments``, against its
plain versions and the CPU oracles, and the GPU provider on its default
device.  Marked ``gpu``; each skips on a
host without CUDA.  On a card (tests/conftest.py imports jax, which the
GPU host lacks):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import zlib

import numpy as np
import pytest
import torch

from librdkafka_tpu_torch import GpuCodecProvider, read_batches, write_batches
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.ops import crc32c_torch as crc
from librdkafka_tpu_torch.ops.packing import pad_left
from librdkafka_tpu_torch.protocol.msgset import Record

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 5, 64])
@pytest.mark.parametrize("N", [4096, 65536])
def test_kernel_equals_plain_and_oracle(card, B, N):
    rng = np.random.default_rng(B + N)
    bufs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, N + 1, B)]
    data, lens = pad_left(bufs, N)
    sel = rng.integers(0, 2, B).astype(np.int32)
    terms = np.array([crc._term_host(int(n), crc.POLYS[s])
                      for n, s in zip(lens, sel)], dtype=np.int64)
    d, t, s = (torch.from_numpy(a).to(card) for a in (data, terms, sel))
    before = crc.launches
    got = crc.crc_rows(d, t, s)
    torch.cuda.synchronize()
    assert crc.launches == before + 1
    assert torch.equal(got, crc.crc_rows_reference(d, t, s))
    want = [native.crc32c(b) if p == 0 else zlib.crc32(b)
            for b, p in zip(bufs, sel)]
    assert got.cpu().tolist() == want


def test_provider_round_trip_on_card(card):
    prov = GpuCodecProvider(min_batches=1)
    assert prov.device.type == "cuda"
    parts = [[Record(value=b"v%d" % i * 100) for i in range(50)]
             for _ in range(4)]
    before = crc.launches
    wire = write_batches(prov, parts, "lz4", 1_700_000_000_000)
    recs = read_batches(prov, wire)
    assert crc.launches == before + 2
    assert [[r.value for r in p] for p in recs] == [
        [r.value for r in p] for p in parts]


@pytest.mark.parametrize("mode", ["crc32c", "crc32", "mixed", "terms"])
def test_segment_kernel_equals_plain_and_oracle(card, mode):
    rng = np.random.default_rng(len(mode))
    lens = [0, 1, 3, 7, 16, 8191, 8192, 8193, 65537, 200_000,
            *rng.integers(0, 30_000, 20).tolist()]
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    flat, offs = bytearray(), []
    for b in bufs:
        flat += bytes(int(rng.integers(0, 40)))
        offs.append(len(flat))
        flat += b
    sel = (np.full(len(bufs), crc.POLYS.index(mode), np.int32)
           if mode in crc.POLYS else
           rng.integers(0, 2, len(bufs)).astype(np.int32))
    terms = None
    if mode == "terms":
        terms = torch.tensor([crc._term_host(n, crc.POLYS[s])
                              for n, s in zip(lens, sel)], device=card)
    args = (torch.frombuffer(flat, dtype=torch.uint8).to(card),
            torch.tensor(offs), torch.tensor(lens), torch.from_numpy(sel),
            terms)
    before = crc.launches
    got = crc.crc_segments(*args)
    torch.cuda.synchronize()
    assert crc.launches == before + 1
    assert torch.equal(got, crc.crc_segments_reference(*args))
    want = [native.crc32c(b) if p == 0 else zlib.crc32(b)
            for b, p in zip(bufs, sel)]
    assert got.cpu().tolist() == want


def test_produce_round_copies_no_padding(card):
    prov = GpuCodecProvider(min_batches=1)
    parts = [[Record(value=b"%d" % i * 300) for i in range(40)]
             for _ in range(8)]
    before = crc.h2d_bytes
    wire = write_batches(prov, parts, None, 1_700_000_000_000)
    lens = np.array([len(w) - 21 for w in wire])     # the CRC regions
    tiles = crc.plan_tiles(np.cumsum(lens) - lens, lens)
    S, real = len(lens), int(lens.sum())
    meta = 16 * len(tiles) + 8 * -(-S // 2)       # descriptors and sel
    # the regions' own bytes, rounded up to 16, and the metadata: no rows
    assert crc.h2d_bytes - before == real + (-real % 16) + meta
