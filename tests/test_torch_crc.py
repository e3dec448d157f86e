"""The port's CRC row kernel and batched drivers, held against the JAX
package's kernels (A/B/C of ops/crc32c_jax.py) and the CPU oracles.

On this host the row kernel's wrapper runs its plain PyTorch version
(``device="cpu"``); the JAX kernels run on the CPU, the Pallas one in
interpret mode as tests/test_0018_tpu_codec.py runs it.  Tolerance is
exact equality: these are checksums.
"""
import zlib

import numpy as np
import pytest
import torch

from librdkafka_tpu.ops import crc32c_jax
from librdkafka_tpu.ops import packing as jax_packing
from librdkafka_tpu.utils import crc as jax_crc
from librdkafka_tpu_torch.ops import crc32c_torch as tcrc
from librdkafka_tpu_torch.ops import packing as port_packing

SIZES = [0, 1, 9, 63, 65535, 65536, 65537, 200_000]


def _rows(B: int, N: int, mode: str, seed: int):
    """Seeded left-padded rows, their per-row polys and JAX terms."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, N + 1, size=B)
    lens[0] = N
    bufs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in lens]
    data, lens = port_packing.pad_left(bufs, N)
    if mode == "mixed":
        sel = rng.integers(0, 2, size=B).astype(np.int32)
    else:
        sel = np.full(B, tcrc.POLYS.index(mode), dtype=np.int32)
    polys = [tcrc.POLYS[s] for s in sel]
    terms = np.array([crc32c_jax._term_host(int(n), p)
                      for n, p in zip(lens, polys)], dtype=np.uint32)
    return bufs, data, terms, sel, polys


def _port(data, terms, sel) -> np.ndarray:
    out = tcrc.crc_rows(torch.from_numpy(data),
                        torch.from_numpy(terms.astype(np.int64)),
                        torch.from_numpy(sel))
    return out.numpy().astype(np.uint32)


@pytest.mark.parametrize("B,N", [(1, 4096), (3, 4096), (8, 4096),
                                 (2, 65536)])
@pytest.mark.parametrize("mode", ["crc32c", "crc32", "mixed"])
def test_rows_reference_equals_jax_kernels(B, N, mode):
    bufs, data, terms, sel, polys = _rows(B, N, mode, seed=B * 7 + N)
    got = _port(data, terms, sel)
    if mode == "mixed":
        want = crc32c_jax._jit_mxu_fused(B, N)(data, terms,
                                               sel.astype(np.uint32))
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        want = crc32c_jax._jit_mxu(B, N, mode)(data, terms)
        np.testing.assert_array_equal(got, np.asarray(want))
        pallas = crc32c_jax._jit_mxu_pallas(B, N, 2048, mode)(data, terms)
        np.testing.assert_array_equal(got, np.asarray(pallas))
    oracle = [jax_crc.crc32c(b) if p == "crc32c" else zlib.crc32(b)
              for b, p in zip(bufs, polys)]
    assert got.tolist() == oracle


@pytest.mark.parametrize("poly", ["crc32c", "crc32"])
def test_term_host_equals_jax(poly):
    for n in [0, 1, 9, 4095, 65535, 65536, 123_457]:
        assert tcrc._term_host(n, poly) == crc32c_jax._term_host(n, poly)


@pytest.mark.parametrize("poly", ["crc32c", "crc32"])
def test_crc_many_equals_jax_driver(poly):
    rng = np.random.default_rng(11)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in SIZES]
    bufs[2] = b"123456789"
    port = (tcrc.crc32c_many if poly == "crc32c"
            else tcrc.crc32_many)(bufs, device="cpu")
    ref = (crc32c_jax.crc32c_many_mxu if poly == "crc32c"
           else crc32c_jax.crc32_many_mxu)(bufs)
    assert port.dtype == np.uint32
    np.testing.assert_array_equal(port, np.asarray(ref).astype(np.uint32))
    check = 0xE3069283 if poly == "crc32c" else 0xCBF43926
    assert int(port[2]) == check


@pytest.mark.parametrize("n", SIZES)
def test_crc_many_equals_oracles(n):
    buf = np.random.default_rng(n).integers(0, 256, n,
                                            dtype=np.uint8).tobytes()
    assert int(tcrc.crc32c_many([buf], device="cpu")[0]) == \
        jax_crc.crc32c(buf)
    assert int(tcrc.crc32_many([buf], device="cpu")[0]) == zlib.crc32(buf)


def test_crc_many_empty_and_memoryview():
    assert tcrc.crc32c_many([], device="cpu").shape == (0,)
    assert tcrc.crc32c_many([b"", b""], device="cpu").tolist() == [0, 0]
    blob = memoryview(b"xx123456789")[2:]
    assert int(tcrc.crc32c_many([blob], device="cpu")[0]) == 0xE3069283


def test_cpu_route_never_launches():
    before = tcrc.launches
    tcrc.crc32c_many([b"abc" * 1000] * 3, device="cpu")
    tcrc.crc32_many([b"abc"], device="cpu")
    assert tcrc.launches == before


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcrc.crc32c_many([b"abc"])


def test_crc_rows_rejects_bad_inputs():
    data = torch.zeros((2, 4096), dtype=torch.uint8)
    terms = torch.zeros(2, dtype=torch.int64)
    sel = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tcrc.crc_rows(torch.zeros((2, 3000), dtype=torch.uint8), terms, sel)
    with pytest.raises(ValueError):
        tcrc.crc_rows(data, terms.to(torch.int32), sel)
    with pytest.raises(ValueError):
        tcrc.crc_rows(data, terms, sel[:1])
    with pytest.raises(ValueError, match="unsupported device"):
        tcrc.crc_rows(data.to("meta"), terms.to("meta"), sel.to("meta"))


@pytest.mark.parametrize("name", ["pad_left", "pad_right"])
def test_packing_equals_jax(name):
    bufs = [b"", b"a", bytes(range(200)), memoryview(b"xyz")]
    got = getattr(port_packing, name)(bufs, 256)
    want = getattr(jax_packing, name)(bufs, 256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for n in [0, 1, 64, 65, 4097, 65536]:
        assert port_packing.next_pow2(n) == jax_packing.next_pow2(n)


# ------------------------------------------------------ packed segments --

SEG_LENS = [0, 1, 7, tcrc.TILE - 1, tcrc.TILE, tcrc.TILE + 1,
            65535, 65536, 65537, 200_000]


def _segments(lens, seed: int):
    """Seeded buffers packed into one flat array at unaligned offsets,
    with random bytes in the gaps between them."""
    rng = np.random.default_rng(seed)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    flat, offs = bytearray(), []
    for b in bufs:
        flat += rng.integers(0, 256, int(rng.integers(1, 38)),
                             dtype=np.uint8).tobytes()
        offs.append(len(flat))
        flat += b
    return (bufs, np.frombuffer(bytes(flat), np.uint8).copy(),
            np.array(offs, np.int64), np.array(lens, np.int64))


def _sel(mode: str, n: int, seed: int) -> np.ndarray:
    if mode == "mixed":
        return np.random.default_rng(seed).integers(0, 2, n).astype(np.int32)
    return np.full(n, tcrc.POLYS.index(mode), dtype=np.int32)


def _port_segments(flat, offs, lens, sel, terms=None) -> list[int]:
    out = tcrc.crc_segments(
        torch.from_numpy(flat), torch.from_numpy(offs),
        torch.from_numpy(lens), torch.from_numpy(sel),
        None if terms is None else torch.from_numpy(terms))
    return out.tolist()


@pytest.mark.parametrize("mode", ["crc32c", "crc32", "mixed"])
def test_segments_reference_equals_jax_and_oracles(mode):
    bufs, flat, offs, lens = _segments(SEG_LENS, seed=5)
    sel = _sel(mode, len(bufs), seed=6)
    got = _port_segments(flat, offs, lens, sel)
    oracle = [jax_crc.crc32c(b) if s == 0 else zlib.crc32(b)
              for b, s in zip(bufs, sel)]
    assert got == oracle
    if mode == "crc32c":
        # kernel D: the same function, with the length term on device
        assert got == np.asarray(crc32c_jax.crc32c_many(bufs)).tolist()
    if mode != "mixed":
        mxu = (crc32c_jax.crc32c_many_mxu if mode == "crc32c"
               else crc32c_jax.crc32_many_mxu)(bufs)
        assert got == np.asarray(mxu).astype(np.uint32).tolist()


def test_segments_with_terms_equal_jax_fused_rows():
    """With ``terms`` a segment keeps the TPU row contract: the same
    outputs as kernel C on the left-padded rows, for mixed ``sel``."""
    lens = [n for n in SEG_LENS if n <= 65536]
    bufs, flat, offs, lens_a = _segments(lens, seed=8)
    sel = _sel("mixed", len(bufs), seed=9)
    data, _ = port_packing.pad_left(bufs, 65536)
    terms = np.array([crc32c_jax._term_host(n, tcrc.POLYS[s])
                      for n, s in zip(lens, sel)], dtype=np.uint32)
    want = crc32c_jax._jit_mxu_fused(len(bufs), 65536)(
        data, terms, sel.astype(np.uint32))
    got = _port_segments(flat, offs, lens_a, sel, terms.astype(np.int64))
    assert got == np.asarray(want).tolist()


@pytest.mark.parametrize("poly", ["crc32c", "crc32"])
def test_crc_many_ragged_lengths_equal_jax_driver(poly):
    rng = np.random.default_rng(12)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in SEG_LENS]
    port = (tcrc.crc32c_many if poly == "crc32c"
            else tcrc.crc32_many)(bufs, device="cpu")
    ref = (crc32c_jax.crc32c_many_mxu if poly == "crc32c"
           else crc32c_jax.crc32_many_mxu)(bufs)
    np.testing.assert_array_equal(port, np.asarray(ref).astype(np.uint32))


def test_crc_many_splits_launches_by_bytes(monkeypatch):
    monkeypatch.setattr(tcrc, "LAUNCH_BYTES", 100)
    calls = []
    real = tcrc.crc_segments
    monkeypatch.setattr(tcrc, "crc_segments",
                        lambda *a: calls.append(a[0].numel()) or real(*a))
    bufs = [bytes([i]) * n for i, n in enumerate([60, 30, 20, 0, 250, 5])]
    got = tcrc.crc32c_many(bufs, device="cpu")
    assert got.tolist() == [jax_crc.crc32c(b) for b in bufs]
    assert calls == [96, 32, 256, 16]      # joined bytes rounded up to 16


def test_cpu_route_copies_nothing_to_a_device():
    before = tcrc.h2d_bytes
    tcrc.crc32c_many([b"abc" * 1000] * 3, device="cpu")
    tcrc.crc32_many([b"abc", b""], device="cpu")
    assert tcrc.h2d_bytes == before


def test_plan_tiles_covers_each_segment_from_its_aligned_end():
    offs = np.array([0, 3, 21, 8192, 100, 16], np.int64)
    lens = np.array([0, 1, 8191, 8192, 20000, 0], np.int64)
    tiles = tcrc.plan_tiles(offs, lens)
    assert tiles.dtype == np.int32 and tiles.shape[1] == 4
    assert (np.diff(tiles[:, 3]) >= 0).all()     # a segment's tiles adjacent
    for s, (o, n) in enumerate(zip(offs, lens)):
        lo, hi = o // 16 * 16, -(-(o + n) // 16) * 16
        k = max(1, -(-(hi - lo) // tcrc.TILE))
        mine = tiles[tiles[:, 3] == s]
        assert len(mine) == k
        assert (mine[:, 1:3] == [o, o + n]).all()
        # windows are adjacent, end at the aligned end, and only the
        # first one reaches before the aligned start
        assert (mine[:, 0] == hi - tcrc.TILE * np.arange(k, 0, -1)).all()
        assert mine[0, 0] <= lo and (k == 1 or mine[1, 0] > lo)


@pytest.mark.parametrize("poly", ["crc32c", "crc32"])
def test_kernel_consts_are_the_shift_and_inverse_operators(poly):
    c = tcrc._kernel_consts(poly).astype(np.int64)
    t8, zop = tcrc._poly_tables(poly)
    # the slice-by-8 step as 16 nibble lookups == 8 byte-table steps
    fold = c[:256].reshape(16, 16)
    rng = np.random.default_rng(3)
    for crc, data in zip(rng.integers(0, 1 << 32, 50).tolist(),
                         rng.integers(0, 256, (50, 8)).tolist()):
        x = crc ^ int.from_bytes(bytes(data[:4]), "little")
        x |= int.from_bytes(bytes(data[4:]), "little") << 32
        got = 0
        for j in range(16):
            got ^= int(fold[j][(x >> (4 * j)) & 15])
        for b in data:
            crc = int(t8[0][(crc ^ b) & 0xFF]) ^ (crc >> 8)
        assert got == crc
    shifts = c[256:256 + tcrc.SHIFTS * 128].reshape(-1, 8, 16)
    v = 0x1234ABCD
    combine = (jax_crc.crc32c_combine if poly == "crc32c"
               else jax_crc.crc32_combine)
    dists = [tcrc.PIECE << k for k in range(tcrc.SHIFTS)]
    for table, d in zip(shifts, dists):
        got = 0
        for j in range(8):
            got ^= int(table[j][(v >> (4 * j)) & 15])
        assert got == combine(v, 0, d)
    inv = c[256 + tcrc.SHIFTS * 128:].reshape(16, 32)
    for m in range(16):
        back = tcrc._apply_host(inv[m], v)
        for _ in range(m):
            back = tcrc._apply_host(zop[0], back)
        assert back == v


def test_crc_segments_rejects_bad_inputs():
    flat = torch.zeros(64, dtype=torch.uint8)
    offs = torch.tensor([0, 10])
    lens = torch.tensor([5, 5])
    sel = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tcrc.crc_segments(flat.view(8, 8), offs, lens, sel)
    with pytest.raises(ValueError):
        tcrc.crc_segments(flat, offs.to(torch.int32), lens, sel)
    with pytest.raises(ValueError):
        tcrc.crc_segments(flat, offs, lens, sel[:1])
    with pytest.raises(ValueError, match="outside flat"):
        tcrc.crc_segments(flat, offs, torch.tensor([5, 60]), sel)
    with pytest.raises(ValueError, match="outside flat"):
        tcrc.crc_segments(flat, torch.tensor([-1, 0]), lens, sel)
    with pytest.raises(ValueError, match="unsupported device"):
        tcrc.crc_segments(flat.to("meta"), offs, lens, sel)
