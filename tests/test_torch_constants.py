"""The port's CRC constants equal the JAX package's.

For this system the slice-by-8 tables and the zero-shift operator
matrices stand in for weights: the port computes its own copies
(librdkafka_tpu_torch/utils/crc.py), and this is the carry-across
check.  Exact equality.
"""
import numpy as np
import pytest

from librdkafka_tpu.utils import crc as jax_crc
from librdkafka_tpu_torch.utils import crc as port_crc


@pytest.mark.parametrize("name", ["TABLE_CRC32C", "TABLE_CRC32",
                                  "ZERO_OP_CRC32C", "ZERO_OP_CRC32"])
def test_constant_equals_jax(name):
    port = getattr(port_crc, name)
    ref = getattr(jax_crc, name)
    assert port.dtype == ref.dtype == np.uint32
    np.testing.assert_array_equal(port, ref)


def test_table8_crc32_follows_the_slice_by_8_recurrence():
    """The port's 8-table zlib form: row 0 is the JAX package's
    TABLE_CRC32; row k advances row k-1 through one zero byte."""
    t8 = port_crc.TABLE8_CRC32
    assert t8.shape == (8, 256)
    np.testing.assert_array_equal(t8[0], jax_crc.TABLE_CRC32)
    for k in range(1, 8):
        np.testing.assert_array_equal(
            t8[k], jax_crc.TABLE_CRC32[t8[k - 1] & 0xFF] ^ (t8[k - 1] >> 8))


@pytest.mark.parametrize("fn", ["crc32c_combine", "crc32_combine"])
def test_combine_equals_jax(fn):
    rng = np.random.default_rng(3)
    for _ in range(20):
        a, b = (int(x) for x in rng.integers(0, 1 << 32, 2))
        n = int(rng.integers(0, 1 << 20))
        assert getattr(port_crc, fn)(a, b, n) == getattr(jax_crc, fn)(a, b, n)


def test_crc_functions_equal_jax():
    data = np.random.default_rng(4).integers(0, 256, 1001,
                                             dtype=np.uint8).tobytes()
    assert port_crc.crc32c(data) == jax_crc.crc32c(data)
    assert port_crc.crc32(data) == jax_crc.crc32(data)
    assert port_crc.crc32c(b"123456789") == 0xE3069283
