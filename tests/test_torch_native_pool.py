"""The native codec pool (``ops/native/codec.cpp`` ``run_pool``): one
process-wide set of parked workers serves every ``*_many`` call, with
one participant per ``tk_pool_grain()`` bytes of input, the caller
included.

Output is the one-thread loop's, byte for byte, whatever the pool
does; concurrent callers and forked children are served; no call
starts a thread once the pool is built; and the pool's counters
(``ops.cpu.pool_stats``) move as ``CPU_ACCOUNTING.md`` documents.
"""
from __future__ import annotations

import ctypes
import functools
import multiprocessing
import os
import random
import subprocess
import sys
import threading

import numpy as np
import pytest

from librdkafka_tpu_torch.ops import cpu as native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I64P = ctypes.POINTER(ctypes.c_int64)
U8P = ctypes.POINTER(ctypes.c_uint8)


def _grain() -> int:
    return int(native.lib().tk_pool_grain())


@functools.lru_cache(maxsize=64)
def _text(n: int, seed: int) -> bytes:
    """``n`` bytes that compress about 2x: words from a small
    vocabulary with random numbers between them."""
    rng = random.Random(seed)
    words = [b"click", b"view", b"user", b"session", b"page", b"event"]
    out = bytearray()
    while len(out) < n:
        out += rng.choice(words) + b"=%d," % rng.randrange(10 ** 6)
    return bytes(out[:n])


def _pack(bufs):
    lens = np.array([len(b) for b in bufs], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return b"".join(bufs), offs, lens


def _compress(fn: str, bound: str, bufs, nthreads: int):
    L = native.lib()
    base, offs, lens = _pack(bufs)
    caps = np.array([getattr(L, bound)(int(n)) for n in lens],
                    dtype=np.int64)
    out_offs = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
    out = np.zeros(max(int(caps.sum()), 1), dtype=np.uint8)
    out_lens = np.zeros(len(bufs), dtype=np.int64)
    getattr(L, fn)(base, offs.ctypes.data_as(I64P), lens.ctypes.data_as(I64P),
                   len(bufs), out.ctypes.data_as(U8P),
                   out_offs.ctypes.data_as(I64P),
                   out_lens.ctypes.data_as(I64P), nthreads)
    return [bytes(out[o:o + r]) for o, r in zip(out_offs, out_lens)]


def _decompress(fn: str, bufs, caps, nthreads: int):
    L = native.lib()
    base, offs, lens = _pack(bufs)
    caps_a = np.array([max(c, 1) for c in caps], dtype=np.int64)
    out_offs = np.concatenate([[0], np.cumsum(caps_a)[:-1]]).astype(np.int64)
    out = np.zeros(int(caps_a.sum()) if bufs else 1, dtype=np.uint8)
    out_lens = np.zeros(len(bufs), dtype=np.int64)
    getattr(L, fn)(base, offs.ctypes.data_as(I64P), lens.ctypes.data_as(I64P),
                   len(bufs), out.ctypes.data_as(U8P),
                   out_offs.ctypes.data_as(I64P),
                   caps_a.ctypes.data_as(I64P),
                   out_lens.ctypes.data_as(I64P), nthreads)
    return [bytes(out[o:o + r]) for o, r in zip(out_offs, out_lens)]


# the four *_many entry points, lz4 compress in both encoders: each
# takes (plain items, nthreads) and returns the items it produced
ENTRIES = {
    "lz4_fast": lambda bufs, nt: _compress(
        "tk_lz4f_compress_many_fast", "tk_lz4f_bound", bufs, nt),
    "lz4_deterministic": lambda bufs, nt: _compress(
        "tk_lz4f_compress_many", "tk_lz4f_bound", bufs, nt),
    "snappy": lambda bufs, nt: _compress(
        "tk_snappy_compress_many", "tk_snappy_bound", bufs, nt),
    "lz4_decompress": lambda bufs, nt: _decompress(
        "tk_lz4f_decompress_many", _frames("lz4", tuple(bufs)),
        [len(b) for b in bufs], nt),
    "snappy_decompress": lambda bufs, nt: _decompress(
        "tk_snappy_decompress_many", _frames("snappy", tuple(bufs)),
        [len(b) for b in bufs], nt),
}


@functools.lru_cache(maxsize=64)
def _frames(codec: str, bufs: tuple) -> list:
    """The decompressors' input: each plain item compressed alone."""
    one = native.lz4_compress if codec == "lz4" else native.snappy_compress
    return [one(b) for b in bufs]


def _shape(name: str, grain: int):
    """Plain items of one call.  The decompressors' input is the
    compressed items, about half the plain bytes, so their calls near a
    participant's boundary take twice the plain bytes."""
    if name == "n0":
        return []
    if name == "n1":
        return [_text(5000, 1)]
    if name == "n2":
        return [_text(3000, 2), _text(70000, 3)]
    if name == "n64":
        return [_text(50 + 997 * i % 20000, i) for i in range(64)]
    if name == "empty_items":
        return [b"", _text(4000, 4), b"", b"", _text(10, 5), b""]
    # total plain bytes just below / above one and two grains
    k, side = {"below_grain": (1, -1), "above_grain": (1, 1),
               "below_2grain": (2, -1), "above_2grain": (2, 1)}[name]
    total = k * grain + side * 1000
    return [_text(total // 4, 10 + i) for i in range(3)] + [
        _text(total - 3 * (total // 4), 20)]


SHAPES = ("n0", "n1", "n2", "n64", "empty_items", "below_grain",
          "above_grain", "below_2grain", "above_2grain")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_pooled_output_is_the_one_thread_loops(entry, shape):
    bufs = _shape(shape, _grain())
    if entry.endswith("decompress") and shape.endswith("grain"):
        bufs = bufs + [_text(len(b), 30 + i) for i, b in enumerate(bufs)]
    fn = ENTRIES[entry]
    serial = fn(bufs, 1)
    assert fn(bufs, 0) == serial
    assert fn(bufs, 3) == serial
    if entry.endswith("decompress"):
        assert serial == bufs
    else:
        assert len(serial) == len(bufs) and all(serial)


def test_concurrent_callers_are_all_served():
    """8 Python threads, 200 mixed calls each: small calls the caller
    serves alone, calls of several grains the pool spreads, and calls
    that find the pool held by another."""
    grain = _grain()
    sets = [
        [_text(1000, 1)],
        [_text(20000 + i, 2 + i) for i in range(6)],
        [_text(grain // 2, 9 + i) for i in range(5)],
        [b"", _text(300, 15), b""],
        [_text(2000, 16), _text(30000, 17)],
        [_text(100_000, 18 + i) for i in range(3)],
        [_text(7, 21)],
    ]
    want = {(e, i): ENTRIES[e](s, 1) for e in ("lz4_fast", "snappy",
                                               "lz4_decompress")
            for i, s in enumerate(sets)}
    keys = sorted(want)
    bad: list = []

    def caller(t: int) -> None:
        for j in range(200):
            e, i = keys[(t * 7 + j) % len(keys)]
            if ENTRIES[e](sets[i], 0) != want[e, i]:
                bad.append((t, j, e, i))

    threads = [threading.Thread(target=caller, args=(t,)) for t in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def _python(script: str, timeout: float) -> str:
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_large_calls_start_no_thread():
    """Once the pool is built, 100 calls of several grains each start
    no thread: a sampler that lists ``/proc/self/task`` all through
    them sees only the tasks that were there before."""
    out = _python("""
import os, threading
from librdkafka_tpu_torch.ops import cpu as native
bufs = [os.urandom(300_000) + b"w" * 300_000 for _ in range(8)]
native.lz4f_compress_many(bufs)           # builds the pool
stop = threading.Event()
seen = set()
def sample():
    while not stop.is_set():
        seen.update(os.listdir("/proc/self/task"))
t = threading.Thread(target=sample)
t.start()
before = set(os.listdir("/proc/self/task"))
s0 = native.pool_stats()
for _ in range(100):
    native.lz4f_compress_many(bufs)
s1 = native.pool_stats()
after = set(os.listdir("/proc/self/task"))
stop.set()
t.join()
print(len(before), len(after), len(seen - before),
      s1["pool_wakes"] - s0["pool_wakes"], os.cpu_count())
""", 120)
    n_before, n_after, new, wakes, ncpu = map(int, out.split())
    assert n_after == n_before
    assert new == 0
    if ncpu > 1:
        assert wakes >= 100


def _forked_call(q) -> None:
    bufs = [_text(200_000, 40 + i) for i in range(8)]
    q.put(native.lz4f_compress_many(bufs) == ENTRIES["lz4_fast"](bufs, 1))


def test_forked_child_is_served_by_a_pool_of_its_own():
    bufs = [_text(200_000, 50 + i) for i in range(8)]
    native.lz4f_compress_many(bufs)           # the parent's pool is built
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=_forked_call, args=(q,))
    p.start()
    p.join(30)
    alive = p.is_alive()
    if alive:
        p.kill()
        p.join(10)
    assert not alive, "the forked child's pooled call did not finish"
    assert p.exitcode == 0
    assert q.get(timeout=5) is True


def test_process_that_used_the_pool_exits():
    _python("""
import os
from librdkafka_tpu_torch.ops import cpu as native
bufs = [os.urandom(200_000) + b"e" * 200_000 for _ in range(8)]
native.lz4f_compress_many(bufs)
assert native.pool_stats()["pool_calls"] == 1
""", 10)


def test_counters_move_as_documented():
    out = _python("""
import os
from librdkafka_tpu_torch.ops import cpu as native
assert native.pool_stats() == dict.fromkeys(native.POOL_STATS, 0)
native.lz4f_compress_many([b"x" * 1000])
a = native.pool_stats()
big = [os.urandom(500_000) + b"y" * 500_000 for _ in range(4)]   # 4 MB
native.lz4f_compress_many(big)
b = native.pool_stats()
print(*a.values(), *b.values(), os.cpu_count(), native.lib().tk_pool_grain())
""", 60)
    v = list(map(int, out.split()))
    a = dict(zip(native.POOL_STATS, v[:4]))
    b = dict(zip(native.POOL_STATS, v[4:8]))
    ncpu, grain = v[8:]
    # a one-item call is solo and wakes nothing
    assert a == {"pool_calls": 1, "pool_solo_calls": 1, "pool_busy_calls": 0,
                 "pool_wakes": 0}
    # a multi-MiB call wakes workers: one participant a grain, at most
    # one a core and one an item, the caller one of them
    assert b["pool_calls"] == 2 and b["pool_solo_calls"] == 1
    assert b["pool_busy_calls"] == 0
    assert b["pool_wakes"] == min(4_000_000 // grain, ncpu, 4) - 1


def test_engine_carries_the_pool_counters():
    from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
    eng = AsyncOffloadEngine(devices=["cpu"], depth=2, min_batches=1,
                             cpu_fallback=None)
    prov = native.CpuCodecProvider()
    try:
        before = native.pool_stats()
        got = eng.submit_compute(prov.compress_many, "lz4",
                                 [_text(3000, 60)], host=True)
        assert len(got.result(120)) == 1
        stats = dict(eng.stats)
    finally:
        eng.close()
    for k in native.POOL_STATS:
        assert stats[k] >= before[k]
    assert stats["pool_calls"] > before["pool_calls"]
