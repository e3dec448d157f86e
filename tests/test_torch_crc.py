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
