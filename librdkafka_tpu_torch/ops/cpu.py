"""CPU codec provider — ctypes bindings over the native C++ library.

The port's copy of librdkafka_tpu/ops/cpu.py: the MsgsetCodecProvider
interface (SURVEY.md §7 stage 5) — compress / decompress / crc32c over one
or many buffers. gzip rides Python's zlib; zstd rides the zstandard module;
lz4 and snappy are our own native implementations (ops/native/codec.cpp).
The GPU provider (ops/gpu.py) delegates its host-side codec work here, so
both emit identical wire bytes.  The batched lz4/snappy decoders and
the CRC32C of many buffers ride the port's enqueue-lane extension
(``_ext()``, ops/native/enqlane.cpp) when it is built.
"""
from __future__ import annotations

import ctypes
import gzip as _gzip
import io
import struct
import zlib

import numpy as np

from .native.build import build

_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so = build()
        L = ctypes.CDLL(so)
        i64, u8p, u32 = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32
        i64p, u32p = ctypes.POINTER(i64), ctypes.POINTER(u32)
        L.tk_crc32c.restype = u32
        L.tk_crc32c.argtypes = [ctypes.c_char_p, i64, u32]
        L.tk_crc32c_many.restype = None
        L.tk_crc32c_many.argtypes = [ctypes.c_char_p, i64p, i64p, u32p, ctypes.c_int]
        L.tk_xxh32.restype = u32
        L.tk_xxh32.argtypes = [ctypes.c_char_p, i64, u32]
        L.tk_parse_v2.restype = i64
        L.tk_parse_v2.argtypes = [ctypes.c_char_p, i64, i64, i64p]
        for name in ("tk_lz4_block_compress", "tk_lz4_block_compress_fast",
                     "tk_lz4_block_decompress",
                     "tk_lz4f_compress", "tk_lz4f_compress_fast",
                     "tk_lz4f_decompress",
                     "tk_snappy_compress", "tk_snappy_decompress"):
            fn = getattr(L, name)
            fn.restype = i64
            fn.argtypes = [ctypes.c_char_p, i64, u8p, i64]
        for name in ("tk_lz4f_compress_many", "tk_lz4f_compress_many_fast",
                     "tk_snappy_compress_many"):
            fn = getattr(L, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_char_p, i64p, i64p, ctypes.c_int,
                           u8p, i64p, i64p, ctypes.c_int]
        for name in ("tk_lz4f_decompress_many", "tk_snappy_decompress_many"):
            fn = getattr(L, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_char_p, i64p, i64p, ctypes.c_int,
                           u8p, i64p, i64p, i64p, ctypes.c_int]
        i32p = ctypes.POINTER(ctypes.c_int32)
        L.tk_frame_v2_bound.restype = i64
        L.tk_frame_v2_bound.argtypes = [i64, ctypes.c_int]
        L.tk_frame_v2.restype = i64
        L.tk_frame_v2.argtypes = [ctypes.c_char_p, i32p, i32p, i64p,
                                  ctypes.c_int, u8p, i64]
        L.tk_frame_v2_run.restype = i64
        L.tk_frame_v2_run.argtypes = [ctypes.c_char_p, i32p, i32p, i64p,
                                      i64, ctypes.c_char_p, i32p,
                                      ctypes.c_int, u8p, i64, i64p, i64p]
        for name in ("tk_lz4f_bound", "tk_snappy_bound", "tk_lz4_block_bound",
                     "tk_snappy_uncompressed_length"):
            fn = getattr(L, name)
            fn.restype = i64
        L.tk_lz4f_bound.argtypes = [i64]
        L.tk_snappy_bound.argtypes = [i64]
        L.tk_lz4_block_bound.argtypes = [i64]
        L.tk_snappy_uncompressed_length.argtypes = [ctypes.c_char_p, i64]
        L.tk_lz4f_decompressed_size.restype = i64
        L.tk_lz4f_decompressed_size.argtypes = [ctypes.c_char_p, i64]
        L.tk_pool_cpu_take.restype = i64
        L.tk_pool_cpu_take.argtypes = []
        _lib = L
    return _lib


def pool_cpu_take() -> int:
    """CPU nanoseconds that the worker threads of this thread's native
    ``*_many`` calls spent since its previous take (the threads exit
    before the call returns, so no per-thread reading outside sees
    them); zeroes the account.  0 before the library is loaded."""
    return 0 if _lib is None else int(_lib.tk_pool_cpu_take())


def _outbuf(cap: int):
    buf = ctypes.create_string_buffer(cap)
    return buf, ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))


def crc32c(data: bytes, crc: int = 0) -> int:
    return lib().tk_crc32c(bytes(data), len(data), crc)


def xxh32(data: bytes, seed: int = 0) -> int:
    return lib().tk_xxh32(bytes(data), len(data), seed)


# ------------------------------------------------------------------- lz4 ---

def lz4_block_compress(data: bytes) -> bytes:
    data = bytes(data)
    cap = lib().tk_lz4_block_bound(len(data))
    buf, p = _outbuf(cap)
    r = lib().tk_lz4_block_compress(data, len(data), p, cap)
    if r < 0:
        raise ValueError("lz4 block compress failed")
    return buf.raw[:r]


def lz4_block_decompress(data: bytes, uncompressed_size: int) -> bytes:
    data = bytes(data)
    buf, p = _outbuf(uncompressed_size)
    r = lib().tk_lz4_block_decompress(data, len(data), p, uncompressed_size)
    if r < 0:
        raise ValueError(f"lz4 block decompress failed ({r})")
    return buf.raw[:r]


def lz4_compress(data: bytes, *, deterministic: bool = True) -> bytes:
    """LZ4 frame compress (Kafka MsgVer2 lz4 wire format).

    ``deterministic=True`` (default) uses the insert-all greedy encoder
    that is the bit-exactness contract shared with the JAX package's
    device encoder (librdkafka_tpu/ops/lz4_jax.py); ``False`` uses the
    throughput-first fast parse (same spec-compliant format, ~6x faster —
    what the broker hot path ships)."""
    data = bytes(data)
    cap = lib().tk_lz4f_bound(len(data))
    buf, p = _outbuf(cap)
    fn = (lib().tk_lz4f_compress if deterministic
          else lib().tk_lz4f_compress_fast)
    r = fn(data, len(data), p, cap)
    if r < 0:
        raise ValueError("lz4 frame compress failed")
    return buf.raw[:r]


def lz4_decompress(data: bytes, size_hint: int = 0) -> bytes:
    data = bytes(data)
    # hard ceiling: LZ4 cannot expand beyond ~255x input, so corruption
    # that masquerades as a capacity shortfall (-4) fails after one grow
    # instead of ballooning toward a fixed 1GB cap
    limit = 255 * len(data) + (1 << 16)
    cap = max(size_hint, 4 * len(data) + (1 << 16))
    while True:
        buf, p = _outbuf(cap)
        r = lib().tk_lz4f_decompress(data, len(data), p, cap)
        if r == -4 and cap < limit:      # output too small: grow and retry
            cap = min(cap * 4, limit)
            continue
        if r < 0:
            raise ValueError(f"lz4 frame decompress failed ({r})")
        return buf.raw[:r]


# ---------------------------------------------------------------- snappy ---

def snappy_compress(data: bytes) -> bytes:
    data = bytes(data)
    cap = lib().tk_snappy_bound(len(data))
    buf, p = _outbuf(cap)
    r = lib().tk_snappy_compress(data, len(data), p, cap)
    if r < 0:
        raise ValueError("snappy compress failed")
    return buf.raw[:r]


def snappy_decompress(data: bytes) -> bytes:
    data = bytes(data)
    size = lib().tk_snappy_uncompressed_length(data, len(data))
    if size < 0:
        raise ValueError("bad snappy preamble")
    buf, p = _outbuf(max(size, 1))
    r = lib().tk_snappy_decompress(data, len(data), p, size)
    if r != size:
        raise ValueError(f"snappy decompress failed ({r} != {size})")
    return buf.raw[:size]


SNAPPY_JAVA_MAGIC = b"\x82SNAPPY\x00"


def snappy_java_decompress(data: bytes) -> bytes:
    """Decompress snappy-java framed stream (magic + per-chunk blocks).

    Old Java producers emit this framing inside MessageSets; the reference
    detects and unframes it in rdkafka_msgset_reader.c (~:300).
    """
    if not isinstance(data, bytes):
        data = bytes(data)             # memoryview from the fetch path
    if not data.startswith(SNAPPY_JAVA_MAGIC):
        return snappy_decompress(data)
    out = io.BytesIO()
    i = len(SNAPPY_JAVA_MAGIC) + 8  # magic + version(4) + compatible(4)
    while i + 4 <= len(data):
        (chunk_len,) = struct.unpack(">i", data[i:i + 4])
        i += 4
        out.write(snappy_decompress(data[i:i + chunk_len]))
        i += chunk_len
    return out.getvalue()


# -------------------------------------------------------- record framing ---

def _frame_outbuf(cap: int):
    """Un-zeroed output buffer for the framer: create_string_buffer
    memsets its whole capacity and .raw copies it back out — ~2 MB of
    wasted traffic per 1 MB batch on the hot path (measured 0.9 us/msg).
    np.empty allocates without clearing; string_at extracts exactly the
    bytes written."""
    buf = np.empty(cap, dtype=np.uint8)
    return buf, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def frame_v2(base: bytes, klens: list[int], vlens: list[int],
             ts_deltas: list[int]) -> bytes:
    """Frame a batch of records into MessageSet v2 record wire layout in
    one native call (GIL released — framing overlaps the app thread).
    base = concatenated key||value bytes; klen/vlen -1 = null."""
    L = lib()
    count = len(klens)
    ka = np.array(klens, dtype=np.int32)
    va = np.array(vlens, dtype=np.int32)
    ta = np.array(ts_deltas, dtype=np.int64)
    cap = L.tk_frame_v2_bound(len(base), count)
    buf, p = _frame_outbuf(cap)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    r = L.tk_frame_v2(base, ka.ctypes.data_as(i32p),
                      va.ctypes.data_as(i32p), ta.ctypes.data_as(i64p),
                      count, p, cap)
    if r < 0:
        raise ValueError("tk_frame_v2 capacity shortfall")
    return ctypes.string_at(buf.ctypes.data, int(r))


def frame_v2_raw(base: bytes, klens: bytes, vlens: bytes,
                 count: int) -> bytes:
    """frame_v2 for the native enqueue lane: klens/vlens arrive as raw
    int32 arrays straight from the arena (no per-record Python work) and
    all timestamp deltas are zero (fast-lane records carry timestamp=0 =
    batch build time)."""
    L = lib()
    zeros = np.zeros(count, dtype=np.int64)
    cap = L.tk_frame_v2_bound(len(base), count)
    buf, p = _frame_outbuf(cap)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    ka = np.frombuffer(klens, dtype=np.int32)
    va = np.frombuffer(vlens, dtype=np.int32)
    r = L.tk_frame_v2(base, ka.ctypes.data_as(i32p),
                      va.ctypes.data_as(i32p), zeros.ctypes.data_as(i64p),
                      count, p, cap)
    if r < 0:
        raise ValueError("tk_frame_v2 capacity shortfall")
    return ctypes.string_at(buf.ctypes.data, int(r))


def frame_v2_run(base: bytes, klens: bytes, vlens: bytes, count: int,
                 now_ms: int, tss: bytes | None = None,
                 hbuf: bytes | None = None, hlens: bytes | None = None,
                 ) -> tuple[bytes, int, int]:
    """Run-native framing for widened arena runs: per-record explicit
    timestamps (raw int64 array; 0 = unset -> now_ms) and pre-encoded
    header blobs (hbuf concatenation + raw int32 lens) straight from the
    arena side buffers.  Returns (records, first_ts, max_ts) — the
    header timestamps the batch assembler needs."""
    L = lib()
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    ta = np.frombuffer(tss, dtype=np.int64) if tss is not None else None
    ha = np.frombuffer(hlens, dtype=np.int32) if hlens is not None else None
    cap = L.tk_frame_v2_bound(len(base) + (len(hbuf) if hbuf else 0), count)
    buf, p = _frame_outbuf(cap)
    ka = np.frombuffer(klens, dtype=np.int32)
    va = np.frombuffer(vlens, dtype=np.int32)
    first = ctypes.c_int64(now_ms)
    last = ctypes.c_int64(now_ms)
    r = L.tk_frame_v2_run(
        base, ka.ctypes.data_as(i32p), va.ctypes.data_as(i32p),
        ta.ctypes.data_as(i64p) if ta is not None else None,
        now_ms, hbuf, ha.ctypes.data_as(i32p) if ha is not None else None,
        count, p, cap, ctypes.byref(first), ctypes.byref(last))
    if r < 0:
        raise ValueError("tk_frame_v2_run capacity shortfall")
    return (ctypes.string_at(buf.ctypes.data, int(r)),
            int(first.value), int(last.value))


# ------------------------------------------------------------- gzip/zstd ---

def gzip_compress(data: bytes, level: int = -1) -> bytes:
    if level < 0:
        level = 6
    co = zlib.compressobj(level, zlib.DEFLATED, 31)  # 31 = gzip wrapper
    return co.compress(bytes(data)) + co.flush()


def gzip_decompress(data: bytes) -> bytes:
    return _gzip.decompress(bytes(data))


def zstd_compress(data: bytes, level: int = -1) -> bytes:
    import zstandard
    return zstandard.ZstdCompressor(level=level if level > 0 else 3).compress(bytes(data))


def zstd_decompress(data: bytes, size_hint: int = 0) -> bytes:
    import zstandard
    return zstandard.ZstdDecompressor().decompress(
        bytes(data), max_output_size=max(size_hint, 8 * len(data) + (1 << 20)))


# --------------------------------------------------------------- batched ---

def crc32c_many(buffers: list[bytes]) -> np.ndarray:
    """CRC32C of each buffer in one native call (the per-toppar batch axis)."""
    base = b"".join(bytes(b) for b in buffers)
    lens = np.array([len(b) for b in buffers], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    out = np.zeros(len(buffers), dtype=np.uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib().tk_crc32c_many(base, offs.ctypes.data_as(i64p),
                         lens.ctypes.data_as(i64p),
                         out.ctypes.data_as(u32p), len(buffers))
    return out


def _compress_many_parallel(fn_name: str, bound_name: str,
                            bufs: list[bytes]) -> list[bytes]:
    """One native call compressing all buffers across a thread pool —
    the batch axis the reference's per-broker-thread design serializes."""
    if not bufs:
        return []
    L = lib()
    base = b"".join(bytes(b) for b in bufs)
    lens = np.array([len(b) for b in bufs], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    bound = getattr(L, bound_name)
    caps = np.array([bound(int(n)) for n in lens], dtype=np.int64)
    out_offs = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
    # np.empty, not create_string_buffer: the latter memsets the whole
    # multi-MB slab before the encoder overwrites it anyway
    out = np.empty(int(caps.sum()), dtype=np.uint8)
    out_lens = np.zeros(len(bufs), dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    getattr(L, fn_name)(
        base, offs.ctypes.data_as(i64p), lens.ctypes.data_as(i64p),
        len(bufs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_offs.ctypes.data_as(i64p), out_lens.ctypes.data_as(i64p), 0)
    res = []
    addr = out.ctypes.data
    for i in range(len(bufs)):
        r = int(out_lens[i])
        if r < 0:
            raise ValueError(f"{fn_name} item {i} failed ({r})")
        o = int(out_offs[i])
        # string_at copies just [o, o+r) — .raw would copy the WHOLE
        # output slab per item (O(n^2) bytes; measured 5x the encode
        # cost at 8x900KB batches)
        res.append(ctypes.string_at(addr + o, r))
    return res


def lz4f_compress_many(bufs: list[bytes], *,
                       deterministic: bool = False) -> list[bytes]:
    """Batched lz4 frame compress. The default is the fast-parse
    encoder (the reference likewise ships lz4's fast mode on its hot
    path, rdkafka_lz4.c); ``deterministic=True`` selects the insert-all
    greedy spec shared bit-for-bit with the JAX package's device
    encoder."""
    fn = ("tk_lz4f_compress_many" if deterministic
          else "tk_lz4f_compress_many_fast")
    return _compress_many_parallel(fn, "tk_lz4f_bound", bufs)


def snappy_compress_many(bufs: list[bytes]) -> list[bytes]:
    return _compress_many_parallel("tk_snappy_compress_many",
                                   "tk_snappy_bound", bufs)


def _decompress_many_parallel(fn_name: str, bufs: list[bytes],
                              caps: list[int]) -> list[bytes | None]:
    """Batched native decompress; items that fail come back as None so
    the caller can fall back to the grow-and-retry single path."""
    if not bufs:
        return []
    L = lib()
    base = b"".join(bytes(b) for b in bufs)
    lens = np.array([len(b) for b in bufs], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    caps_a = np.array([max(int(c), 1) for c in caps], dtype=np.int64)
    out_offs = np.concatenate([[0], np.cumsum(caps_a)[:-1]]).astype(np.int64)
    out = np.empty(max(int(caps_a.sum()), 1), dtype=np.uint8)
    out_lens = np.zeros(len(bufs), dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    getattr(L, fn_name)(
        base, offs.ctypes.data_as(i64p), lens.ctypes.data_as(i64p),
        len(bufs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_offs.ctypes.data_as(i64p), caps_a.ctypes.data_as(i64p),
        out_lens.ctypes.data_as(i64p), 0)
    res: list[bytes | None] = []
    addr = out.ctypes.data
    for i in range(len(bufs)):
        r = int(out_lens[i])
        if r < 0:
            res.append(None)
        else:
            o = int(out_offs[i])
            res.append(ctypes.string_at(addr + o, r))  # not .raw: no O(n^2)
    return res


def lz4f_decompress_many(bufs: list[bytes],
                         size_hints: list[int] | None = None) -> list[bytes]:
    hints = size_hints or [0] * len(bufs)
    # trust a provided size hint; without one, a write-free native
    # sequence walk yields the EXACT size (the lz4 frame header carries
    # none with our FLG) — a guessed capacity on high-ratio batches
    # (40x is normal for templated payloads) fell through to the
    # grow-and-retry path, re-decoding each batch several times
    # (measured 390 MB/s effective vs 10.9 GB/s for the decoder proper)
    L = lib()
    caps = [h if h > 0 else 0 for h in hints]
    for i, b in enumerate(bufs):
        if caps[i] <= 0:
            sz = L.tk_lz4f_decompressed_size(bytes(b), len(b))
            caps[i] = sz if sz > 0 else 4 * len(b) + (1 << 16)
    out = _decompress_many_parallel("tk_lz4f_decompress_many", bufs, caps)
    return [o if o is not None else lz4_decompress(b, h)
            for o, b, h in zip(out, bufs, hints)]


def snappy_decompress_many(bufs: list[bytes]) -> list[bytes]:
    if not bufs:
        return []
    L = lib()
    caps = [L.tk_snappy_uncompressed_length(bytes(b), len(b)) for b in bufs]
    if any(c < 0 for c in caps):
        raise ValueError("bad snappy preamble")
    # preamble is untrusted network data sizing an allocation: clamp to
    # the format's max expansion before anything is decoded
    if any(c > 256 * len(b) + (64 << 10) for c, b in zip(caps, bufs)):
        raise ValueError("snappy preamble exceeds max expansion")
    out = _decompress_many_parallel("tk_snappy_decompress_many", bufs, caps)
    if any(o is None for o in out):
        raise ValueError("snappy decompress failed")
    return out  # type: ignore[return-value]


# codec registry: name -> (compress(data, level), decompress(data, size_hint))
CODECS = {
    "gzip": (lambda d, lvl=-1: gzip_compress(d, lvl),
             lambda d, hint=0: gzip_decompress(d)),
    "snappy": (lambda d, lvl=-1: snappy_compress(d),
               lambda d, hint=0: snappy_java_decompress(d)),
    "lz4": (lambda d, lvl=-1: lz4_compress(d),
            lambda d, hint=0: lz4_decompress(d, hint)),
    "zstd": (lambda d, lvl=-1: zstd_compress(d, lvl),
             lambda d, hint=0: zstd_decompress(d, hint)),
}


_EXT = None
_EXT_ERR = False


def _ext():
    """The tk_torch_enqlane extension's batched codec entry points (no-join
    crc32c_many / in-place decompress_many), or None."""
    global _EXT, _EXT_ERR
    if _EXT is None and not _EXT_ERR:
        try:
            from .native.build import load_enqlane
            m = load_enqlane()
            _EXT = m if hasattr(m, "crc32c_many") else None
            if _EXT is None:
                _EXT_ERR = True
        except Exception:
            _EXT_ERR = True
    return _EXT


class SyncTicket:
    """Pre-resolved ticket: the CPU provider's (and any synchronous
    fallback's) ticket-shaped result, so pipelined and synchronous codec
    paths flow through ONE submit/park/resolve code path.  It lives here,
    not in ops/engine.py, so a CPU client never imports torch."""

    __slots__ = ("_result", "_exc")

    def __init__(self, result=None, exc: BaseException | None = None):
        self._result = result
        self._exc = exc

    def done(self) -> bool:
        return True

    def result(self, timeout: float | None = None):
        if self._exc is not None:
            raise self._exc
        return self._result


class CpuCodecProvider:
    """The msgset codec provider interface (SURVEY.md §7 stage 5).

    compress_many / decompress_many / crc32c_many over independent
    per-partition batches; the GPU provider (ops/gpu.py) implements the
    same interface with one device launch per CRC batch.
    """

    name = "cpu"

    def compress_many(self, codec: str, bufs: list[bytes], level: int = -1
                      ) -> list[bytes]:
        if not bufs:
            return []
        # lz4/snappy: ONE native call, batch parallelized across cores
        # (the per-toppar batch axis the reference serializes on its
        # broker threads, rdkafka_msgset_writer.c:1129)
        if codec == "lz4":
            return lz4f_compress_many(bufs)
        if codec == "snappy":
            return snappy_compress_many(bufs)
        comp = CODECS[codec][0]
        return [comp(b, level) for b in bufs]

    def decompress_many(self, codec: str, bufs: list[bytes],
                        size_hints: list[int] | None = None) -> list[bytes]:
        if not bufs:
            return []
        if codec in ("lz4", "snappy"):
            ext = _ext()
            if (ext is not None and codec == "snappy" and any(
                    bytes(b).startswith(SNAPPY_JAVA_MAGIC)
                    for b in bufs)):
                ext = None           # java framing: python reader below
            if ext is not None:
                out = ext.decompress_many(3 if codec == "lz4" else 2,
                                          bufs, size_hints)
                if None not in out:
                    return out
                # isolate failures through the grow-and-retry path
                return [o if o is not None else
                        self.decompress_one(codec, b, h)
                        for o, b, h in zip(
                            out, bufs,
                            size_hints or [0] * len(bufs))]
        if codec == "lz4":
            return lz4f_decompress_many(bufs, size_hints)
        if codec == "snappy" and not any(
                bytes(b).startswith(SNAPPY_JAVA_MAGIC) for b in bufs):
            return snappy_decompress_many(bufs)
        dec = CODECS[codec][1]
        hints = size_hints or [0] * len(bufs)
        return [dec(b, h) for b, h in zip(bufs, hints)]

    def decompress_one(self, codec: str, buf: bytes, hint: int = 0):
        return CODECS[codec][1](buf, hint)

    def crc32c_many(self, bufs: list[bytes]) -> list[int]:
        ext = _ext()
        if ext is not None:
            # per-buffer hardware CRC with no join copy (enqlane.cpp)
            return ext.crc32c_many(bufs)
        return crc32c_many(bufs).tolist()

    def crc32_many(self, bufs: list[bytes]) -> list[int]:
        """Legacy MsgVer0/1 zlib-poly CRC (reference: src/rdcrc32.c)."""
        return [zlib.crc32(bytes(b)) & 0xFFFFFFFF for b in bufs]

    # ------------------------------------------------ ticket-shaped seam --
    # The async offload submit interface, resolved eagerly: the work runs
    # synchronously right here (no dispatch thread), but callers get the
    # same Ticket contract as the GPU provider, so the codec phases run
    # ONE submit/park/resolve code path for both providers.

    def crc32c_submit(self, bufs: list[bytes]):
        return SyncTicket(np.asarray(self.crc32c_many(bufs),
                                     dtype=np.uint32))

    def crc32_submit(self, bufs: list[bytes]):
        return SyncTicket(np.asarray(self.crc32_many(bufs),
                                     dtype=np.uint32))

    def decompress_submit(self, codec: str, bufs: list[bytes],
                          size_hints: list[int] | None = None):
        return SyncTicket(self.decompress_many(codec, bufs, size_hints))

    def fused_codec_id(self, codec: str) -> int | None:
        """Wire attribute id when the fused native batch builder
        (tk_torch_enqlane.build_batch: frame+compress+CRC+header in one
        GIL-released call) is equivalent to this provider's 3-phase
        path for ``codec``; None keeps the 3-phase pipeline.  The
        fused lz4/snappy encoders are the same native functions
        compress_many dispatches to, so wire bytes are identical."""
        return {"none": 0, "snappy": 2, "lz4": 3}.get(codec)
