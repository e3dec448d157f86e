"""Partitioner hashes: Java-compatible murmur2, and consistent CRC hashing.

The reference implements murmur2 in src/rdmurmur2.c (unit test vs Java
reference values at rdmurmur2.c:115); the murmur2_random partitioner must
produce the same partition as the Java client for the same key, so the hash
must match org.apache.kafka.common.utils.Utils.murmur2 exactly.
"""
from __future__ import annotations

from .crc import crc32

MURMUR2_SEED = 0x9747B28C
_M = 0x5BD1E995
_MASK = 0xFFFFFFFF


def murmur2(data: bytes) -> int:
    """Java-compatible murmur2 (signed-char reads, seed ^ len init)."""
    n = len(data)
    h = (MURMUR2_SEED ^ n) & _MASK
    i = 0
    while n - i >= 4:
        k = data[i] | (data[i + 1] << 8) | (data[i + 2] << 16) | (data[i + 3] << 24)
        k = (k * _M) & _MASK
        k ^= k >> 24
        k = (k * _M) & _MASK
        h = (h * _M) & _MASK
        h ^= k
        i += 4
    rem = n - i
    # Java reads trailing bytes as *signed* chars; sign-extend accordingly.
    if rem >= 3:
        h ^= (_sext(data[i + 2]) << 16) & _MASK
    if rem >= 2:
        h ^= (_sext(data[i + 1]) << 8) & _MASK
    if rem >= 1:
        h ^= _sext(data[i]) & _MASK
        h = (h * _M) & _MASK
    h ^= h >> 13
    h = (h * _M) & _MASK
    h ^= h >> 15
    return h


def _sext(b: int) -> int:
    return b - 256 if b >= 128 else b


def murmur2_partition(key: bytes, partition_cnt: int) -> int:
    """The murmur2 partitioner mapping: toPositive(murmur2(key)) % cnt."""
    return (murmur2(key) & 0x7FFFFFFF) % partition_cnt


def consistent_partition(key: bytes, partition_cnt: int) -> int:
    """'consistent' partitioner: CRC32 of the key modulo partition count."""
    return crc32(key) % partition_cnt
