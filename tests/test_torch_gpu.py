"""Tests of the port that need a CUDA card: the hand-written segment kernel
(csrc/crc_rows.cu), through ``crc_rows`` and ``crc_segments``, against its
plain versions and the CPU oracles, the GPU provider on its default
device (synchronous route), the async offload engine on the card
(pinned staging rings reused while copies are in flight, the fused
launch, one launch per round, the H2D bytes, close with tickets in
flight, first launches from two threads), and the LZ4 kernel
(csrc/lz4_rows.cu) against its plain version and the native encoder in
every ``with_crc`` mode (with the edge rows of its stages), its two CTAs
an SM and its stage clocks, beside a CRC launch on another stream, and
through the engine's compress route (a round's wall time beside a
thread that keeps the GIL busy among them), the sharded steps (kernels G
and H of parallel/mesh.py) on four shards of the visible cards, through
the engine and the entry points, the robustness tier (the QoS flood
scenario and the stress gate) with its device legs on the card, the
C ABI (capi/gpu_smoke.c through libtkafka.so) on the card, the
exactly-once copy of chip_smoke.py phase 10, the delivery path and
consumer API of its phase 11, and a traced produce whose device_launch
spans match the CRC kernel's launches, and the linger-0 leg and codec
matrix of its phase 14, each at a small size, and each leg of the
port's bench (``python -m librdkafka_tpu_torch.bench``) that its phase
15 does not run, at its --smoke size.  Marked
``gpu``; each skips on a host without CUDA.  On a card
(tests/conftest.py imports jax, which the GPU host lacks):

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
    prov = GpuCodecProvider(min_batches=1, pipeline_depth=0)
    assert prov.wait_warm(300)      # its warm launch before the counts
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
    prov = GpuCodecProvider(min_batches=1, pipeline_depth=0)
    assert prov.wait_warm(300)      # its warm launch before the counts
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


# ------------------------------------------------ the engine on the card --

def _fallback(bufs, poly):
    p = native.CpuCodecProvider()
    return p.crc32c_many(bufs) if poly == "crc32c" else p.crc32_many(bufs)


def _oracle(bufs, poly):
    return [native.crc32c(b) if poly == "crc32c" else zlib.crc32(b)
            for b in bufs]


@pytest.fixture
def engine(card):
    from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
    eng = AsyncOffloadEngine(depth=2, fanin_window_s=0.1, min_batches=4,
                             governor=True, warmup=True,
                             cpu_fallback=_fallback)
    assert eng.warm_wait(300)
    yield eng
    eng.close()


def test_engine_ring_reuse_in_flight_exact(engine):
    """Rounds submitted before any resolves: ring slots are refilled while
    earlier launches' copies may still be in flight."""
    rng = np.random.default_rng(40)
    bufs = [b"", b"a", b"123456789", bytes(100)] + [
        rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for n in [1, 63, 1000, 65535, 65536, 65537, 200_000]]
    rounds = [bufs[r:] + bufs[:r] for r in range(8)]
    before = crc.launches
    tickets = [engine.submit(b, "crc32c", window=False) for b in rounds]
    for b, t in zip(rounds, tickets):
        assert t.result(60).tolist() == _oracle(b, "crc32c")
    assert crc.launches > before
    assert engine.stats["warmup_miss_jobs"] == 0


def test_engine_fused_single_launch(engine):
    rng = np.random.default_rng(41)
    bufs_c = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (900, 70000)]
    bufs_l = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (4096, 17)]
    before = crc.launches
    t1 = engine.submit(bufs_c, "crc32c", window=True)
    t2 = engine.submit(bufs_l, "crc32", window=True)
    assert t1.result(60).tolist() == _oracle(bufs_c, "crc32c")
    assert t2.result(60).tolist() == _oracle(bufs_l, "crc32")
    assert engine.stats["fused_launches"] == 1
    assert crc.launches == before + 1


def test_engine_round_one_launch_and_pinned_h2d_bytes(card):
    """governor=False after the route is warm: a produce round is one
    kernel launch, and the bytes copied to the card are the regions' own,
    their alignment and the metadata."""
    from librdkafka_tpu_torch import submit_batches
    prov = GpuCodecProvider(min_batches=1, governor=False)
    try:
        assert prov.wait_warm(300)
        parts = [[Record(value=b"%d" % i * 300) for i in range(40)]
                 for _ in range(8)]
        l0, h0 = crc.launches, crc.h2d_bytes
        wire = submit_batches(prov, parts, None,
                              1_700_000_000_000).result(60)
        assert crc.launches == l0 + 1
        lens = np.array([len(w) - 21 for w in wire])
        tiles = crc.plan_tiles(np.cumsum(lens) - lens, lens)
        real = int(lens.sum())
        meta = 16 * len(tiles) + 8 * -(-len(lens) // 2)
        assert crc.h2d_bytes - h0 == real + (-real % 16) + meta
        assert wire == write_batches(native.CpuCodecProvider(), parts, None,
                                     1_700_000_000_000)
        lane = prov._engine._lanes[0]
        assert lane.staging.pin and lane.staging.nbytes() > 0
        assert prov._engine.stats["routed_cpu_jobs"] == 0
    finally:
        prov.close()


def test_engine_close_with_tickets_in_flight(card):
    from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
    eng = AsyncOffloadEngine(depth=2, min_batches=1, governor=False,
                             cpu_fallback=_fallback)
    bufs = [bytes([i]) * (1000 + 97 * i) for i in range(64)]
    tickets = [eng.submit(bufs, "crc32c", window=False) for _ in range(16)]
    eng.close()
    for t in tickets:
        assert t.done() and t.result(0).tolist() == _oracle(bufs, "crc32c")


_TWO_THREADS = """
import threading, numpy as np, torch
from librdkafka_tpu_torch.ops import crc32c_torch as crc
from librdkafka_tpu_torch.ops import cpu as native
crc._kernel_lib()
bufs = [bytes([i]) * (5000 + i) for i in range(32)]
go = threading.Barrier(2)
out = {}
def first(k):
    torch.cuda.set_device(0)
    go.wait()
    out[k] = crc.crc32c_many(bufs).tolist()
ths = [threading.Thread(target=first, args=(k,)) for k in range(2)]
[t.start() for t in ths]
[t.join(120) for t in ths]
want = [native.crc32c(b) for b in bufs]
assert out[0] == want and out[1] == want, out
assert crc.launches == 2
print("ok")
"""


def test_first_launches_from_two_threads_fresh_process(card):
    """A fresh process makes its first two launches from two threads at
    once: the occupancy table the first launch fills is filled once."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _TWO_THREADS], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ------------------------------------------------ the LZ4 kernel on the card --

def _lz4_sweep():
    rng = np.random.default_rng(135)
    blocks = [b"", b"Z", b"x" * 12, b"abcdabcdabcda", b"kv-pair " * 128,
              b"ab" * 32767 + b"xy", rng.integers(0, 256, 3000,
                                                  dtype=np.uint8).tobytes(),
              rng.integers(0, 4, 65536, dtype=np.uint8).tobytes()]
    blocks += [b"z" * n for n in (15, 300, 65536)]
    from librdkafka_tpu_torch.ops import lz4_torch
    return blocks + lz4_torch.edge_rows()


def _main_path_blocks():
    """1,024 blocks of 64 KB cut from the main path's produce round: 64
    partitions x 960 records x 1 KB of the benchmark's JSON values."""
    from librdkafka_tpu_torch.protocol.msgset import MsgsetWriterV2
    base = (b'{"seq": %07d, "user": "u%05d", "event": "click", '
            b'"props": "abcdefghijklmnopqrstuvwxyz0123456789"}')
    vals = [(base % (i, i % 1000) * 11)[:1024] for i in range(4096)]
    blocks = []
    for p in range(64):
        recs = [Record(value=vals[(p * 960 + i) % 4096]) for i in range(960)]
        rb = MsgsetWriterV2(codec="lz4").build(recs,
                                               1_700_000_000_000).records_bytes
        blocks += [rb[i:i + 65536] for i in range(0, len(rb), 65536)]
    return blocks[:1024]


@pytest.mark.parametrize("mode", ["none", "both", "raw"])
@pytest.mark.parametrize("shape", ["sweep", "main path"])
def test_lz4_kernel_equals_plain_and_native(card, mode, shape):
    from librdkafka_tpu_torch.ops import lz4_torch
    from librdkafka_tpu_torch.ops.packing import pad_right
    blocks = _lz4_sweep() if shape == "sweep" else _main_path_blocks()
    data, lens = pad_right(blocks, 65536)
    d, ln = torch.from_numpy(data).to(card), torch.from_numpy(lens).to(card)
    before = lz4_torch.launches
    got = lz4_torch.lz4_rows(d, ln, mode)
    torch.cuda.synchronize()
    assert lz4_torch.launches == before + 1
    ref = lz4_torch.lz4_rows_reference(d, ln, mode)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert torch.equal(g, r)
    comp, olen = got[0].cpu().numpy(), got[1].cpu().numpy()
    want = [native.lz4_block_compress(b) for b in blocks]
    assert [comp[i, :olen[i]].tobytes() for i in range(len(blocks))] == want
    if mode == "both":
        assert got[2].cpu().tolist() == [native.crc32c(w) for w in want]
    if mode != "none":
        assert got[3].cpu().tolist() == [native.crc32c(b) for b in blocks]


def test_lz4_two_ctas_per_sm_and_stage_clocks(card):
    """Two CTAs of 64 KB rows fit an SM; the stage-clock build computes
    the same rows, every stage takes time, and its launch is not
    counted."""
    from librdkafka_tpu_torch.ops import lz4_torch
    from librdkafka_tpu_torch.ops.packing import pad_right
    assert lz4_torch.ctas_per_sm(65536) >= 2
    blocks = _lz4_sweep()
    data, lens = pad_right(blocks, 65536)
    d, ln = torch.from_numpy(data).to(card), torch.from_numpy(lens).to(card)
    before = lz4_torch.launches
    clk = lz4_torch.stage_clocks(d, ln, "both")
    assert lz4_torch.launches == before
    assert list(clk) == list(lz4_torch.STAGES)
    assert all(v > 0 for v in clk.values())


def test_lz4_and_crc_launches_on_two_streams_do_not_wedge(card):
    """An LZ4 launch and a cooperative CRC launch queued from two threads
    on two streams: both finish (launches of the port are serialized on
    the card), both exact."""
    import threading
    from librdkafka_tpu_torch.ops import lz4_torch
    from librdkafka_tpu_torch.ops.packing import pad_right
    blocks = _main_path_blocks()[:512]
    data, lens = pad_right(blocks, 65536)
    want = [native.crc32c(native.lz4_block_compress(b)) for b in blocks]
    rng = np.random.default_rng(9)
    bufs = [rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
            for _ in range(64)]
    out, errs = {}, []

    def lz4_side():
        try:
            s = torch.cuda.Stream(card)
            with torch.cuda.stream(s):
                d = torch.from_numpy(data).to(card)
                ln = torch.from_numpy(lens).to(card)
                for k in range(4):
                    out[("lz4", k)] = lz4_torch.lz4_rows(d, ln, "both")[2]
                s.synchronize()
        except Exception as e:          # reported below
            errs.append(e)

    def crc_side():
        try:
            s = torch.cuda.Stream(card)
            with torch.cuda.stream(s):
                for k in range(16):
                    out[("crc", k)] = crc.crc32c_many(bufs)
        except Exception as e:
            errs.append(e)

    ths = [threading.Thread(target=f) for f in (lz4_side, crc_side)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(300)
    assert not any(th.is_alive() for th in ths), "a launch wedged"
    assert not errs, errs
    torch.cuda.synchronize()
    for k in range(4):
        assert out[("lz4", k)].cpu().tolist() == want
    for k in range(16):
        assert out[("crc", k)].tolist() == [native.crc32c(b) for b in bufs]


def test_engine_rounds_beside_crc_launches_on_card(card):
    """The engine's native compress rounds (their chain wait and event
    recorded inside one native call) while another thread launches the
    cooperative CRC kernel on its own stream: nothing wedges, frames ==
    the deterministic encoder's, CRCs exact."""
    import threading
    from librdkafka_tpu_torch.ops import lz4_torch
    rng = np.random.default_rng(24)
    bufs = [(b"%05d-" % i) * 3000 + rng.integers(
        0, 256, 500 * (i % 5), dtype=np.uint8).tobytes() for i in range(32)]
    det = native.lz4f_compress_many(bufs, deterministic=True)
    want = [native.crc32c(b) for b in bufs]
    prov = GpuCodecProvider(min_batches=1, governor=False,
                            compress_device=True)
    errs, crcs = [], []

    def crc_side():
        try:
            s = torch.cuda.Stream(card)
            with torch.cuda.stream(s):
                for _ in range(24):
                    crcs.append(crc.crc32c_many(bufs).tolist())
        except Exception as e:          # reported below
            errs.append(e)

    try:
        assert prov.wait_warm(300)
        eng = prov._get_engine()
        l0 = lz4_torch.launches
        th = threading.Thread(target=crc_side)
        th.start()
        frames = [eng.submit_compress(bufs, window=False) for _ in range(8)]
        got = [[bytes(f) for f in t.result(300)] for t in frames]
        th.join(300)
        assert not th.is_alive(), "a launch wedged"
        assert not errs, errs
        assert all(g == det for g in got)
        assert crcs and all(c == want for c in crcs)
        assert lz4_torch.launches - l0 == eng.compress_stats["native_rounds"]
    finally:
        prov.close()


class _DetProvider(native.CpuCodecProvider):
    """The deterministic-writer oracle: the CPU provider with lz4 on the
    native insert-all encoder (the kernel's bytes)."""

    def compress_many(self, codec, bufs, level=-1):
        if codec == "lz4":
            return native.lz4f_compress_many([bytes(b) for b in bufs],
                                             deterministic=True)
        return super().compress_many(codec, bufs, level)


def test_engine_compress_route_on_card(card):
    """The device compress route on the card: warm, governor off, a round
    is one LZ4 launch and no CRC launch; frames == the deterministic
    encoder's, and only the compressed bytes come back."""
    from librdkafka_tpu_torch import submit_batches
    from librdkafka_tpu_torch.ops import lz4_torch
    prov = GpuCodecProvider(min_batches=1, governor=False,
                            compress_device=True)
    try:
        assert prov.wait_warm(300)
        parts = [[Record(value=b"%d-" % i * 300) for i in range(200)]
                 for _ in range(8)]
        l0, c0, d0 = lz4_torch.launches, crc.launches, lz4_torch.d2h_bytes
        wire = submit_batches(prov, parts, "lz4",
                              1_700_000_000_000).result(120)
        assert lz4_torch.launches == l0 + 1 and crc.launches == c0
        assert wire == write_batches(_DetProvider(), parts, "lz4",
                                     1_700_000_000_000)
        eng = prov._engine
        assert eng.compress_stats["launches"] == 1
        assert eng.compress_stats["native_rounds"] == 1
        assert not any(eng.compress_stats[k] for k in (
            "cpu_jobs", "warmup_miss_jobs", "routed_cpu_jobs", "shed_jobs"))
        assert lz4_torch.d2h_bytes - d0 < sum(len(w) for w in wire) + 8192
    finally:
        prov.close()
    assert lz4_torch.device_kernel_count() == 0


def test_compress_round_beside_a_busy_thread_on_card(card):
    """A round of 64 x 16 KB through the engine's compress route while a
    pure-Python thread spins beside it: frames == the deterministic
    encoder's, one LZ4 launch and no CRC launch, and the wall time the
    governor charges the round (packing and launch, then readback and
    frames) stays under 5 ms.  A thread that gives the GIL up beside the
    spinner waits the interpreter's switch interval (5 ms) to take it
    back: the round's native calls keep it while they need no wait."""
    import threading
    from librdkafka_tpu_torch.ops import lz4_torch
    rng = np.random.default_rng(16)
    words = [b"%06d:%s " % (i, b"ab" * (i % 7)) for i in range(4096)]
    bufs = [b"".join(rng.choice(words, 1200).tolist())[:16384]
            for _ in range(64)]
    assert all(len(b) == 16384 for b in bufs)
    prov = GpuCodecProvider(min_batches=1, governor=False,
                            compress_device=True)
    stop = threading.Event()

    def spin():
        n = 0
        while not stop.is_set():
            n += 1

    try:
        assert prov.wait_warm(300)
        eng = prov._get_engine()
        # the first round grows the rings and the lane's buffers
        eng.submit_compress(bufs, window=False).result(120)
        spinner = threading.Thread(target=spin, name="gil-spin")
        spinner.start()
        try:
            c0 = dict(eng.compress_stats)
            l0, k0 = lz4_torch.launches, crc.launches
            got = eng.submit_compress(bufs, window=False).result(120)
            c1 = dict(eng.compress_stats)
        finally:
            stop.set()
            spinner.join(10)
        assert not spinner.is_alive()
        assert [bytes(f) for f in got] == native.lz4f_compress_many(
            bufs, deterministic=True)
        assert lz4_torch.launches == l0 + 1 and crc.launches == k0
        d = {k: c1[k] - c0[k] for k in ("launches", "native_rounds",
                                        "launch_wall_ns",
                                        "readback_wall_ns")}
        print(f"round beside a busy thread: {d}")
        assert d["launches"] == d["native_rounds"] == 1, d
        assert d["launch_wall_ns"] + d["readback_wall_ns"] < 5e6, d
    finally:
        prov.close()


# ------------------------------------------------ Producer -> mock -> Consumer --

def _client_leg(extra: dict, det: bool, parts: int = 8, per_part: int = 300):
    """Phase 6 of chip_smoke at a small size: an idempotent lz4 Producer
    on the card's route into the mock, then a check.crcs GPU Consumer;
    the stored frames are the native encoder's and every record comes
    back in order.  Returns (producer launches, consumer engine stats)
    as (crc, lz4) kernel counts over the produce."""
    import json

    from librdkafka_tpu_torch import Consumer, Producer
    from librdkafka_tpu_torch.client.consumer import TopicPartition
    from librdkafka_tpu_torch.ops import lz4_torch
    from librdkafka_tpu_torch.protocol.msgset import (iter_batches,
                                                      parse_records_v2)
    from librdkafka_tpu_torch.protocol.proto import OFFSET_BEGINNING
    gpu = {"compression.backend": "gpu", "gpu.governor": False,
           "gpu.launch.min.batches": 1}
    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "test.mock.default.partitions": parts,
                  "enable.idempotence": True, "compression.codec": "lz4",
                  "linger.ms": 5, **gpu, **extra})
    c = None
    try:
        assert p._rk.codec_provider.device.type == "cuda"
        assert p._rk.codec_provider.wait_warm(300)
        vals = [[b"%02d-%05d " % (i, j) * 100 for j in range(per_part)]
                for i in range(parts)]
        c0, l0 = crc.launches, lz4_torch.launches
        for j in range(per_part):
            for i in range(parts):
                p.produce("gt", value=vals[i][j], key=b"%d" % i, partition=i)
        assert p.flush(120) == 0
        launches = (crc.launches - c0, lz4_torch.launches - l0)
        cluster = p._rk.mock_cluster
        for i in range(parts):
            frames, infos = [], []
            for _b, blob in cluster.partition("gt", i).log:
                for info, payload, _full in iter_batches(blob):
                    infos.append(info)
                    frames.append(bytes(payload))
            raws = native.lz4f_decompress_many(frames, None)
            assert frames == native.lz4f_compress_many(
                raws, deterministic=det)
            assert [r.value for info, raw in zip(infos, raws)
                    for r in parse_records_v2(info, raw)] == vals[i]
        c = Consumer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "group.id": "gt", "auto.offset.reset": "earliest",
                      "check.crcs": True, **gpu})
        assert c._rk.codec_provider.wait_warm(300)
        c.assign([TopicPartition("gt", i, OFFSET_BEGINNING)
                  for i in range(parts)])
        got = [[] for _ in range(parts)]
        n = parts * per_part
        while sum(map(len, got)) < n:
            ms = c.consume(n - sum(map(len, got)), 30)
            assert ms, "consumer stalled"
            for m in ms:
                assert m.error is None, m.error
                got[m.partition].append(m.value)
        assert got == vals
        ceng = json.loads(c._rk.stats.emit_json())["codec_engine"]
        assert ceng["launches"] > 0
        assert not any(ceng[k] for k in ("warmup_miss_jobs",
                                         "routed_cpu_jobs",
                                         "cpu_fallback_jobs"))
        return launches, json.loads(p._rk.stats.emit_json())["codec_engine"]
    finally:
        if c is not None:
            c.close()
        p.close()


def test_client_crc_ticket_route_on_card(card):
    (crcs, lz4s), eng = _client_leg({}, det=False)
    assert crcs > 0 and lz4s == 0 and eng["launches"] > 0
    assert not any(eng[k] for k in ("warmup_miss_jobs", "routed_cpu_jobs",
                                    "cpu_fallback_jobs"))


def test_client_device_compress_route_on_card(card):
    (crcs, lz4s), eng = _client_leg({"gpu.compress.device": True}, det=True)
    assert crcs == 0 and lz4s > 0
    comp = eng["compress"]
    assert comp["launches"] > 0 and comp["fused_crc"] > 0
    assert comp["native_rounds"] == comp["launches"]
    assert not any(comp[k] for k in ("cpu_jobs", "warmup_miss_jobs",
                                     "routed_cpu_jobs", "shed_jobs"))


def test_gpu_backend_raises_without_cuda(monkeypatch):
    """Runs on any host: with no CUDA device, Producer and Consumer with
    compression.backend=gpu raise unless gpu.device=cpu is asked for."""
    from librdkafka_tpu_torch import Consumer, Producer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Producer, Consumer):
        conf = {"bootstrap.servers": "", "compression.backend": "gpu",
                **({"group.id": "g"} if make is Consumer else {})}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(dict(conf))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make({**conf, "gpu.device": "cuda:0"})


def test_hot_topic_flood_qos_isolation_on_card(card):
    """test_0135 :448 at the reference's sizes, on the card, through the
    port's chaos.scenarios.hot_topic_flood (gpu.* keys): a weight-8
    latency topic beside a zipf-sized weight-0.25 bulk flood (2,000 B
    zipf, capped at 120,000 B) through the device compress route,
    governor and warmup on.  Every latency message acks, its flooded p99
    stays within 3x the unloaded p99 (floor 100 ms), every bulk message
    is delivered by the scenario's flush, and the latency topic's weight
    reaches the stats."""
    from librdkafka_tpu_torch.chaos.scenarios import hot_topic_flood
    r = hot_topic_flood(seed=17)
    assert r["ok"], r       # every ping acked, p99 in bound, bulk moved
    assert r["bulk_sent"] > 0 and r["bulk_acked"] == r["bulk_sent"], r
    assert r["compress"]["launches"] > 0, r["compress"]
    assert r["qos"]["qos-latency"]["weight"] == 8.0, r["qos"]


def test_robustness_tier_on_card(card):
    """The ported stress gate with its device legs on their default
    device, the card: analysis.stress.run_stress() is lockdep-clean with
    CRC launches (the engine leg) and LZ4 launches (the device-codec
    leg), no subprocess left behind.  The flood runs in the test above."""
    from librdkafka_tpu_torch.analysis import lockdep, stress
    from librdkafka_tpu_torch.mock import external
    from librdkafka_tpu_torch.ops import lz4_torch
    c0, l0 = crc.launches, lz4_torch.launches
    rep = stress.run_stress()
    assert lockdep.clean(rep), lockdep.format_report(rep)
    assert crc.launches > c0 and lz4_torch.launches > l0
    assert not external.active_subprocess_pids()


# ------------------------------------------------ kernels G and H (mesh) --

def _card_pool(card, k=4):
    """k shards on the visible cards: the first k cards when there are
    that many, else k shards of card 0 (in series on one card)."""
    n = torch.cuda.device_count()
    return ([f"cuda:{i}" for i in range(k)] if n >= k
            else ["cuda:0"] * k)


@pytest.mark.parametrize("kind", ["crc32c", "crc32", "fused"])
def test_sharded_crc_step_equals_plain_and_oracle(card, kind):
    """Kernel G on four shards: one crc_rows.cu launch a shard, equal to
    the per-shard plain version and the oracles."""
    from librdkafka_tpu_torch.parallel import mesh
    rng = np.random.default_rng(len(kind))
    Bs, N = 8, 65536
    pool = _card_pool(card)
    B = Bs * len(pool)
    bufs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, N + 1, B)]
    polys = ([kind] * B if kind != "fused"
             else [crc.POLYS[i % 2] for i in range(B)])
    data, _ = pad_left(bufs, N)
    sel = np.array([p == "crc32" for p in polys], np.uint32)
    terms = np.array([crc._term_host(len(b), p)
                      for b, p in zip(bufs, polys)], np.uint32)
    try:
        m, step = mesh.sharded_crc_step(pool, Bs, N, kind)
        before = mesh.crc_launches
        got = step(data, terms, sel) if kind == "fused" else step(data, terms)
        assert mesh.crc_launches == before + len(pool)
        want = [native.crc32c(b) if p == "crc32c"
                else zlib.crc32(b) & 0xFFFFFFFF for b, p in zip(bufs, polys)]
        assert got.tolist() == want
        assert mesh.sharded_crc_reference(m, data, terms,
                                          sel).tolist() == want
    finally:
        mesh.release_step_cache()


@pytest.mark.parametrize("with_crc", [True, False])
def test_shard_compress_equals_plain_and_native(card, with_crc):
    """Kernel H on four shards, B not a multiple of four: one lz4_rows.cu
    launch a shard, the native block encoder's bytes, the plain version's
    rows, native CRCs and the summed lengths."""
    from librdkafka_tpu_torch.ops.packing import next_pow2, pad_right
    from librdkafka_tpu_torch.parallel import mesh
    rng = np.random.default_rng(7)
    blocks = [rng.integers(0, 4, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(0, 65537, 23)]
    m = mesh.make_mesh(devices=_card_pool(card))
    try:
        before = mesh.codec_launches
        outs, crcs, total = mesh.shard_compress(m, blocks, with_crc)
        assert mesh.codec_launches == before + 4
        assert outs == [native.lz4_block_compress(b) for b in blocks]
        N = next_pow2(max(len(b) for b in blocks))
        data, lens = pad_right(blocks + [b""], N)
        valid = np.array([1] * len(blocks) + [0], np.int32)
        comp, olen, pcrc, ptotal = mesh.sharded_codec_reference(
            m, data, lens, valid, with_crc)
        assert [comp[i, :olen[i]].tobytes()
                for i in range(len(blocks))] == outs
        if with_crc:
            assert crcs.tolist() == [native.crc32c(b) for b in blocks]
            assert pcrc[:len(blocks)].tolist() == crcs.tolist()
            assert total == ptotal == sum(len(o) for o in outs)
        else:
            assert crcs is None and total == 0
    finally:
        mesh.release_step_cache()


def test_engine_sharded_launch_on_card(card):
    """The engine on two lanes of the pool shards a 17-block group: one
    crc_rows.cu launch a shard from each lane's pinned ring, exact, every
    lane records it; close releases the step."""
    from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
    from librdkafka_tpu_torch.parallel import mesh
    pool = _card_pool(card, 2)
    eng = AsyncOffloadEngine(depth=2, min_batches=1, governor=False,
                             devices=pool, cpu_fallback=None)
    try:
        rng = np.random.default_rng(27)
        bufs = [rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
                for _ in range(16)] + [b"tail-block" * 7]
        eng.submit([b"warm"], "crc32c", window=False).result(300)
        before = mesh.crc_launches
        got = eng.submit(bufs, "crc32c", window=False).result(300)
        assert got.tolist() == [native.crc32c(b) for b in bufs]
        assert mesh.crc_launches == before + 2
        assert eng.stats["sharded_launches"] == 1
        assert all(r["launches"] >= 1 for r in eng.devices_snapshot())
        assert all(ln.staging.pin for ln in eng._lanes)
    finally:
        eng.close()
    assert mesh.step_cache_count() == 0


def test_entry_points_on_card(card):
    from librdkafka_tpu_torch.entry import dryrun_multichip, entry
    from librdkafka_tpu_torch.ops import lz4_torch
    from librdkafka_tpu_torch.parallel import mesh
    step, (data, lens) = entry()
    assert data.device.type == "cuda"
    out, olen, crcs = step(data, lens)
    want = lz4_torch.lz4_rows_reference(data, lens, "raw")
    assert torch.equal(olen, want[1]) and torch.equal(crcs, want[3])
    assert torch.equal(out, want[0])
    try:
        dryrun_multichip(4, devices=_card_pool(card))
    finally:
        mesh.release_step_cache()


def test_capi_round_trip_on_card(card, tmp_path):
    """capi/gpu_smoke.c, a C program on the port's libtkafka.so, drives
    both GPU legs on the card at 8 partitions x 200 x 1 KB: every record
    read back in order, every DR delivered (the program checks both),
    crc_rows launches from the producer on leg a, lz4_rows on leg b, the
    consumer's CRC verify on both, and no job on a CPU route."""
    import subprocess

    from librdkafka_tpu_torch.capi import build_capi, smoke
    exe = build_capi.compile_program(smoke.SRC, str(tmp_path / "gpu_smoke"))
    r = subprocess.run(
        [exe, "--partitions", "8", "--records", "200", "--tail", "8",
         "--repeats", "1", "--conf", "compression.backend=gpu",
         "--conf", "gpu.governor=false", "--conf", "gpu.launch.min.batches=1",
         "--leg", "a", "--leg", "b:gpu.compress.device=true"],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    legs = smoke.read(r.stdout)
    assert set(legs) == {"a", "b"}
    for name, rep in legs.items():
        prod = smoke.deltas(rep, "producer")
        cons = smoke.deltas(rep, "consumer")
        assert cons["launches"] > 0
        assert not any(d[k] for d in (prod, cons) for k in smoke.CPU_ROUTES)
        if name == "a":
            assert prod["launches"] > 0 and prod["compress.launches"] == 0
        else:
            assert prod["compress.launches"] > 0 and prod["launches"] == 0


# ------------------------------------------------ the exactly-once copy --

@pytest.mark.parametrize("leg", ["a", "b"])
def test_eos_copy_on_card(card, leg):
    """chip_smoke.py phase 10's loop at the CPU test's size on the card
    (tests/test_torch_eos.py): 8 partitions x 100 records of 64-1,024 B,
    two copiers of 25 records a transaction, every 3rd aborted, one
    leaving midway.  Every input record is read once under
    read_committed, the group's offsets reach the input's ends, the
    consumers launch crc_rows and leg b's producers lz4_rows (their batch
    CRCs folded: no CRC launch)."""
    import chip_smoke as eos
    parts, per = 8, 100
    rng = np.random.default_rng(10)
    vals = [[rng.integers(0, 16, int(rng.integers(64, 1025)))
             .astype(np.uint8).tobytes() for _ in range(per)]
            for _ in range(parts)]
    kit = eos.port_kit()
    backend = {"compression.backend": "gpu", "gpu.device": "cuda",
               "gpu.governor": False, "gpu.launch.min.batches": 1}
    extra = {"gpu.compress.device": True} if leg == "b" else {}
    cluster = kit.MockCluster(num_brokers=1,
                              topics={eos.EOS_IN: parts, eos.EOS_OUT: parts})
    try:
        boot = cluster.bootstrap_servers()
        eos.eos_seed(kit, boot, vals, backend)
        hwm = {i: per for i in range(parts)}
        res = eos.eos_copy(kit, leg, boot, hwm, backend, extra, members=2,
                           txn_records=25, abort_every=3, leaver=1,
                           timeout=120)
        read = eos.eos_read(kit, boot, backend, parts, parts * per, leg)
        eos.eos_exactly_once(vals, read["records"])
        g = cluster.groups[f"eos-copy-{leg}"]
        assert {q: g.offsets[(eos.EOS_IN, q)][0] for q in hwm} == hwm
        eos.eos_stored(cluster, parts, det=leg == "b")
    finally:
        cluster.stop()
    assert read["engine"]["stats"]["launches"] > 0
    assert read["control_regions"] > 0
    for c in res["copiers"]:
        ce, pe = c.engines["consumer"], c.engines["producer"]
        assert ce["stats"]["launches"] > 0
        for snap in (ce, pe):
            assert not any(snap["stats"][k] for k in (
                "warmup_miss_jobs", "routed_cpu_jobs", "cpu_fallback_jobs"))
        if leg == "b":
            assert pe["compress"]["launches"] > 0
            assert pe["stats"]["launches"] == c.engines["producer_crc0"]
            assert not any(pe["compress"][k] for k in (
                "cpu_jobs", "warmup_miss_jobs", "routed_cpu_jobs"))
        else:
            assert pe["stats"]["launches"] > c.engines["producer_crc0"]


# ---------------------------------- the delivery path and consumer API --

def test_delivery_and_consumer_api_on_card(card):
    """chip_smoke.py phase 11 at 8 partitions x 400 records on the card:
    11a (produce_batch with headers and timestamps, every DR served at
    flush(), the error DRs) and 11b (follower fetch, pause, seek with
    tickets parked, offsets_for_times, the file-store restart, regex
    subscribe) on the CRC tickets and the device compress route, then
    11c (close() under a wedged broker thread with tickets in flight).
    Any check that fails raises or exits non-zero."""
    import chip_smoke
    out = chip_smoke.phase_api("card test", parts=8, per_part=400)
    assert out["crc_rows"] > 0 and out["lz4_rows"] > 0


# ------------------------------------------------------- observability --

def test_observability_traced_produce_on_card(card):
    """A traced GPU produce of 64 partitions x 64 records on the CRC
    tickets, warm: one device_launch span for each crc_rows launch the
    round made, each with route "device" on card 0, unsharded."""
    from librdkafka_tpu_torch import Producer
    from librdkafka_tpu_torch.obs import trace
    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "test.mock.default.partitions": 64,
                  "compression.codec": "lz4", "linger.ms": 5,
                  "compression.backend": "gpu", "gpu.governor": False,
                  "gpu.launch.min.batches": 1, "trace.enable": True,
                  "trace.ring.events": 1 << 16})
    try:
        assert p._rk.codec_provider.wait_warm(300)
        before = crc.launches
        t0 = trace.now()
        for j in range(64):
            for i in range(64):
                p.produce("obs-card", value=b"v%02d-%03d " % (i, j) * 64,
                          partition=i)
        assert p.flush(120) == 0
        launched = crc.launches - before
        spans = [e for e in trace.collect_events()
                 if e["name"] == "device_launch"
                 and round(e["ts"] * 1e3) >= t0]
    finally:
        p.close()
    assert launched > 0 and len(spans) == launched
    assert all(e["args"]["route"] == "device" and e["args"]["device"] == 0
               and e["args"]["sharded"] is False for e in spans)
    assert not trace.enabled and trace.active_ring_count() == 0


# ------------------------------------------------------------ planes --

def test_tls_admin_legacy_and_socket_faults_on_card(card):
    """chip_smoke.py phase 13 at 8 partitions x 400 records on the card:
    sasl_ssl blobs equal the plaintext round's, the refusals, the admin
    plane with a topic that grows under the producer, legacy brokers and
    a mixed log, the socket faults and head-of-line blocking, on the CRC
    tickets and the device compress route.  Any check that fails
    raises or exits non-zero."""
    import chip_smoke
    out = chip_smoke.phase_planes("card test", parts=8, per_part=400)
    assert out["crc_rows"] > 0 and out["lz4_rows"] > 0


# ------------------------------------------------------- latency, load --

def test_latency_load_leg_a_and_codecs_on_card(card):
    """chip_smoke.py phase 14 at reduced counts on the card: 14a's legs a
    and b (0055's bounds, 50 awaited linger-0 records, one crc_rows or
    lz4_rows launch a batch, no CPU route) and 14b (the topic-scope codec
    matrix at 4 partitions x 400 records on the CRC tickets and the
    device compress route, blobs equal to the CPU provider's round, every
    CRC exact).  Any check that fails raises."""
    import chip_smoke
    kit = chip_smoke.p14_kit()
    backend = {"compression.backend": "gpu", "gpu.device": "cuda",
               **chip_smoke.P6_GPU}
    lat = chip_smoke.p14_latency(
        kit, [("a", backend, True),
              ("b", {**backend, "gpu.compress.device": True}, True)],
        50, "cuda", "card test")
    assert lat["a"]["counts"] == {"crc_rows": 50, "lz4_rows": 0}
    assert lat["b"]["counts"] == {"crc_rows": 0, "lz4_rows": 50}
    out = chip_smoke.p14_codecs(kit, backend, chip_smoke.P14_LEGS, 4, 400,
                                "cuda", "card test")
    assert out["counts"]["crc_rows"] > 0 and out["counts"]["lz4_rows"] > 0


# ------------------------------------------------------------- bench --

#: every leg of ``python -m librdkafka_tpu_torch.bench`` that chip_smoke.py
#: phase 15 does not run, at its --smoke size: (flags, env, check)
BENCH_LEGS = {
    "pipeline": (["--pipeline"], {},
                 lambda a: a["engine"]["engine_stats"]["launches"] > 0),
    "fetch-pipeline": (["--fetch-pipeline"], {},
                       lambda a: "error" not in a["engine"]),
    "governor": (["--governor"], {},
                 lambda a: a["fused"]["halved"] and a["cold_start"]
                 ["first_device_launch_s"] is not None),
    "codec-device": (["--codec-device", "--smoke"], {},
                     lambda a: all(b["bit_exact"]
                                   for b in a["buckets"].values())
                     and a["warm_gate"]["first_device_launch_s"]
                     is not None),
    "txn": (["--txn"], {"BENCH_TXN_MSGS": "20000"},
            lambda a: a["txn_commit_msgs_s"] > 0),
    "partitions": (["--partitions", "--smoke"], {}, lambda a: a["ok"]),
    "mesh": (["--mesh"], {"BENCH_MESH_SUBS": "2"},
             lambda a: a["wire_bitexact"] and all(
                 leg["launches"] > 0 for leg in a["legs"].values())),
    "chaos": (["--chaos"], {}, lambda a: a["ok"]),
    "rebalance": (["--rebalance", "--smoke"], {}, lambda a: a["ok"]),
    "fleet": (["--fleet", "--smoke"], {}, lambda a: a["ok"]),
}


@pytest.mark.parametrize("leg", list(BENCH_LEGS))
def test_bench_leg_on_card(card, leg, tmp_path):
    """One leg of the port's bench on the card at its --smoke size, as a
    user runs it: exit 0, an artifact naming the card, the leg's own
    check; the bench's legs assert their bit-exactness themselves."""
    import json
    import os
    import subprocess
    import sys
    flags, env, ok = BENCH_LEGS[leg]
    out = tmp_path / "leg.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "librdkafka_tpu_torch.bench", *flags,
         "--json", str(out)], cwd=root, capture_output=True, text=True,
        env={**os.environ, "BENCH_TREND_PATH": str(tmp_path / "t.jsonl"),
             **env}, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    art = json.loads(out.read_text())
    assert art["device"]["platform"] == "gpu"
    failed = {k: v for k, v in (art.get("legs") or {}).items()
              if isinstance(v, dict) and v.get("ok") is False}
    assert ok(art), failed or art
