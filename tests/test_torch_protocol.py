"""The port's protocol layer held against the JAX package's (test_0002,
and the unit cases of test_0134): every request and response schema, at
every version the API table declares, with field values drawn from a
seeded generator, encodes to the same bytes in both packages, and each
package decodes the other's bytes to the same body.  The partitioner
hashes (murmur2, consistent) and the header-blob codec of the enqueue
lane agree over seeded keys.  Exact: no tolerance."""
import struct

import numpy as np
import pytest

from librdkafka_tpu.client import arena as ref_arena
from librdkafka_tpu.protocol import apis as ref_apis
from librdkafka_tpu.protocol.proto import ApiKey as RefApiKey
from librdkafka_tpu.utils import hash as ref_hash
from librdkafka_tpu_torch.client import arena as port_arena
from librdkafka_tpu_torch.protocol import apis as port_apis
from librdkafka_tpu_torch.protocol.proto import ApiKey as PortApiKey
from librdkafka_tpu_torch.utils import hash as port_hash


def _versions(api) -> list[int]:
    """The default version of ``api`` and every explicit override."""
    vs = {ref_apis.APIS[api][0]}
    vs.update(v for (a, v) in ref_apis.VERSIONED if a == api)
    return sorted(vs)


CASES = [(api, v) for api in ref_apis.APIS for v in _versions(api)]


def _value(typ, rng, depth=0):
    """A seeded value for a schema type, by the type's class name (the two
    packages have their own type classes).  Bytes stay under the splice
    threshold, so both decoders return ``bytes``."""
    kind = type(typ).__name__
    if kind == "Schema":
        return {name: _value(t, rng, depth + 1) for name, t in typ.fields}
    if kind == "Array":
        if rng.random() < 0.1:
            return None
        return [_value(typ.elem, rng, depth + 1)
                for _ in range(int(rng.integers(0, 4 if depth < 3 else 2)))]
    if kind in ("_Int8", "_Int16", "_Int32", "_Int64", "_UInt32"):
        bits = struct.calcsize(typ.fmt) * 8
        lo, hi = ((0, 1 << bits) if kind == "_UInt32"
                  else (-(1 << (bits - 1)), 1 << (bits - 1)))
        return int(rng.integers(lo, hi, dtype=np.int64)
                   if bits < 64 else rng.integers(-(1 << 62), 1 << 62))
    if kind == "_Float64":
        return float(rng.normal())
    if kind == "_Boolean":
        return bool(rng.integers(0, 2))
    if kind in ("_String", "_NullableString"):
        if kind == "_NullableString" and rng.random() < 0.2:
            return None
        return "".join(chr(c) for c in rng.integers(0x20, 0x7F,
                                                    int(rng.integers(0, 12))))
    if kind == "_Bytes":
        if rng.random() < 0.2:
            return None
        return rng.integers(0, 256, int(rng.integers(0, 64)),
                            dtype=np.uint8).tobytes()
    raise TypeError(f"no generator for {kind}")


def _frame_strip(b: bytes) -> bytes:
    (n,) = struct.unpack(">i", b[:4])
    assert n == len(b) - 4
    return b[4:]


def test_every_api_and_version_is_covered():
    assert {int(a) for a in port_apis.APIS} == {int(a) for a in ref_apis.APIS}
    assert set((int(a), v) for a, v in port_apis.VERSIONED) == set(
        (int(a), v) for a, v in ref_apis.VERSIONED)
    for api in ref_apis.APIS:
        assert port_apis.APIS[PortApiKey(int(api))][0] == ref_apis.APIS[api][0]


@pytest.mark.parametrize("api,ver", CASES,
                         ids=[f"{a.name}-v{v}" for a, v in CASES])
def test_request_and_response_bytes_equal(api, ver):
    rng = np.random.default_rng(int(api) * 100 + ver)
    papi = PortApiKey(int(api))
    _, req_s, resp_s = ref_apis.schemas_for(api, ver)
    for _ in range(3):
        req, resp = _value(req_s, rng), _value(resp_s, rng)
        corr = int(rng.integers(0, 1 << 31))
        want = ref_apis.build_request(api, corr, "cid", req, version=ver)
        got = port_apis.build_request(papi, corr, "cid", req, version=ver)
        assert got == want
        hdr = {"api_key": int(api), "api_version": ver,
               "correlation_id": corr, "client_id": "cid"}
        assert port_apis.parse_request(_frame_strip(want)) == (hdr, req)
        assert ref_apis.parse_request(_frame_strip(got)) == (hdr, req)
        want = ref_apis.build_response(api, corr, resp, version=ver)
        got = port_apis.build_response(papi, corr, resp, version=ver)
        assert got == want
        assert port_apis.parse_response(papi, _frame_strip(want),
                                        version=ver) == (corr, resp)
        assert ref_apis.parse_response(api, _frame_strip(got),
                                       version=ver) == (corr, resp)


def test_request_defaults_fill_omitted_fields_alike():
    """A version-agnostic body (fields a later version added omitted)
    frames the same way through both packages' schema defaults."""
    body = {"topics": None}
    assert port_apis.build_request(PortApiKey.Metadata, 77, "cid", body) \
        == ref_apis.build_request(RefApiKey.Metadata, 77, "cid", body)


def _keys(seed: int, n: int = 300) -> list[bytes]:
    rng = np.random.default_rng(seed)
    fixed = [b"", b"\x00", b"key", b"\x7f\x80\xff\x01", bytes(range(256)),
             "キー".encode()]
    return fixed + [rng.integers(0, 256, int(rng.integers(0, 80)),
                                 dtype=np.uint8).tobytes() for _ in range(n)]


@pytest.mark.parametrize("fn", ["murmur2_partition", "consistent_partition"])
def test_partitioner_hash_parity(fn):
    ref, port = getattr(ref_hash, fn), getattr(port_hash, fn)
    for key in _keys(16):
        for cnt in (1, 3, 7, 64, 12345):
            assert port(key, cnt) == ref(key, cnt), (key[:16], cnt)
    assert all(port_hash.murmur2(k) == ref_hash.murmur2(k) for k in _keys(17))


def test_headers_blob_codec_parity():
    rng = np.random.default_rng(134)
    cases = [[], [("a", b"1")],
             [("key", None), ("", b""), ("utf8-ключ", b"\x00\xff")],
             [("h%d" % i, b"v" * i) for i in range(40)]]
    cases += [[("k%d" % j, None if rng.random() < 0.2 else
                rng.integers(0, 256, int(rng.integers(0, 30)),
                             dtype=np.uint8).tobytes())
               for j in range(int(rng.integers(1, 6)))] for _ in range(20)]
    for hdrs in cases:
        blob = port_arena.encode_headers(hdrs)
        assert blob == ref_arena.encode_headers(hdrs)
        assert port_arena.decode_hblob(blob) == ref_arena.decode_hblob(blob) \
            == [(k, v) for k, v in hdrs]
    for bad in ([("k", "str-not-bytes")], [(1, b"v")], "not-a-seq-of-pairs"):
        assert port_arena.encode_headers(bad) is None
        assert ref_arena.encode_headers(bad) is None
