#!/usr/bin/env python3
"""Drive librdkafka_tpu_torch's main path on one NVIDIA GPU.

Run from the root of the repository, on a host with one CUDA card:

    python3 chip_smoke.py

Phase 1 prints the card and builds the kernels from the checkout's sources
(csrc/crc_rows.cu and csrc/lz4_rows.cu with nvcc, both nvcc runs started
together, and ops/native/codec.cpp with g++).  Phase 2 holds
the CRC kernel against its plain PyTorch versions and the CPU oracles
(native crc32c, zlib.crc32), for crc32c, crc32 and mixed polynomials, and
times it: through ``crc_rows`` at B in {1, 8, 128, 256} left-padded rows of
64 KB (the TPU row contract), and through ``crc_segments`` on packed
ragged segments: the main path's 64 regions, 256 x 65,536 B, random lengths
of 0-200,000 B at unaligned offsets, and 61,440 x 1 KB.  Phase 3 runs the
producer writer phase and the consumer fetch verify (write_batches /
read_batches) through GpuCodecProvider at the shape of BASELINE.json
config 5: 64 partitions, each one lz4 batch of 960 records x 1,024 B; the
wire bytes must equal the CPU provider's, a flipped byte must raise
CrcMismatch, a legacy leg runs 64 MsgVer1 lz4 wrappers through crc32_many,
and the bytes copied to the card must be the regions' own plus the
metadata.  A last leg verifies an uncompressed MsgVer1 fetch of the same
64 x 960 x 1 KB (61,440 legacy CRC regions).  Phases 2-3 run the
synchronous route (``pipeline_depth=0``).  Phase 4 runs the async offload
engine (ops/engine.py) on the card: (a) engine CRCs == the oracle with
pinned ring slots refilled while earlier launches are in flight, a crc32
job and a fused crc32c + crc32 launch, and one launch's staged inputs
through the plain version; (b) ROUNDS pipelined full-width produce rounds
through ``submit_batches`` (round k+1 submitted before round k resolves,
``governor=False``, route warm): wire == the CPU provider's, one launch a
round, H2D bytes == regions + alignment + metadata; (c) fan-in of 4
submitter threads x 16 partitions; (d) the ticketed verify of v2 batches
and MsgVer1 wrappers, and CrcMismatch; (e) close() with tickets in flight;
(f) the engine route's times beside the synchronous route's and the
native CRC's, its host split, produce / verify msgs/s three ways,
stage_latency, the busy share and a fresh process's time to an open
route; (g) the governed defaults' route split.  A counted leg fails if a
job of it went to the CPU.  Phase 5 drives the device compress route
(the LZ4 kernel csrc/lz4_rows.cu with its CRC epilogue): first what the
kernel's design depends on (CTAs per SM at 64 KB rows, at least 2;
ptxas registers and spills, none; sequences per main-path block); (a)
kernel == plain version == the native deterministic encoder, with CRCs
== the native crc32c, for each ``with_crc`` mode on a size sweep with
the kernel's edge rows and on the main path's 1,024 blocks; (b) the
synchronous route
``GpuCodecProvider(lz4_force=True, pipeline_depth=0).compress_many`` ==
the native deterministic frames; (c) ROUNDS pipelined produce rounds
through ``submit_batches`` on ``GpuCodecProvider(compress_device=True,
governor=False)``, warm: wire == the deterministic writer's, records read
back, one LZ4 launch a round and no CRC launch (the batch CRC is folded
from the frames' part CRCs); (d) two topics of unequal ``qos`` weight
under saturation, the flood topic's job shed to the CPU encoder, exact;
(e) close() with compress tickets in flight; (f) the LZ4 kernel's times in
each ``with_crc`` mode beside its bound and its plain version's (the
kernels line gives "both", the engine route's), the SM cycles of each of
its stages (a diagnostic build), the route's host split, the
bytes copied each way, produce msgs/s on the device route vs the CPU
deterministic and default encoders, and the busy share; (g) one pass of
the batched codec step (models/codec_step.py) through the engine.  A
counted leg of phase 5 fails if a job of it went to the CPU.  Phase 6
drives the port's client through the entry points a user calls, at the
shape of BASELINE.json config 5: ``Producer`` (idempotent, lz4, linger
5 ms, default batch.num.messages and message.max.bytes) into one
in-process mock broker with 64 partitions a topic, 64 x 4,800 records x
1,024 B a repeat, three repeats a leg, then a ``Consumer`` with
``compression.backend=gpu`` and ``check.crcs=true`` reading every record
back through ticketed fetch verify on the card.  Legs: (a) the producer on
the CPU provider, (b) on the GPU provider's CRC tickets, (c) with
``gpu.compress.device=true`` (one LZ4 launch with its CRC epilogue a
round); the GPU legs run ``gpu.governor=false``,
``gpu.launch.min.batches=1`` and wait for the route to warm.  Every stored
batch's CRC must equal the native crc32c, its lz4 frame the native
encoder's (the deterministic one on leg c), its records and idempotence
fields what was produced; the consumer must return each partition's
records in order; a corrupted batch must raise CrcMismatch in the port's
reader and reach the consumer as _BAD_MSG; the GPU legs must show launches
and no CPU route.  It prints each leg's produce and consume msgs/s
(median and spread of the three repeats) and its launch counts, which add
to the kernels line.  Phase 7 drives the multi-device codec path
(parallel/mesh.py) over a pool of the visible cards, or of card 0 four
times on a one-card host (whose shards run one after another, so none of
its times is a scale-out figure; the script prints which case ran):
(a) kernel G through the engine at 1, 2 and 4 lanes of the pool (the
governor on for a fused crc32c + crc32 group the fan-in merges, and no
CPU fallback at all): bench.py's 6 x 64 x 64 KB, test_0018's 16 x 64 KB
+ tail, and the fused group, every CRC == native, the staged inputs of
the sharded launch == crc_segments_reference, every lane recording the
sharded launches, nothing left in flight and no step after close(), with
MB/s and the per-lane launch/block split; (b) kernel H, shard_compress
over the pool on phase 5's 1,024 blocks and on 1,023, == the native
block encoder, crc32c, the summed lengths and the per-shard plain
version, the empty list building no step; (c) entry()'s step on the card
== its plain version, and dryrun_multichip(4); (d) phase 6 leg b's
Producer with gpu.mesh.devices=0 through ``python -m
librdkafka_tpu_torch.mock.standalone`` (its own process, killed and
reaped on every exit) and a check.crcs Consumer, 3 x 64 x 1,600 x 1 KB,
its msgs/s beside phase 6b's; then G's and H's host-clock step times
beside their plain versions and bounds.  Phase 8 drives the robustness
tier through the port's entry points at the JAX package's sizes: (a)
``analysis.stress.run_stress()`` with its device legs on the card, every
leg under lockdep, the report clean, the engine leg launching the CRC
kernel and the device-codec leg the LZ4 kernel (each leg's seconds and
launches printed); (b) ``chaos.scenarios.hot_topic_flood(seed=17)``:
isolation holds, every bulk message is delivered and the compress route
launched (its jobs split into launched, warmup misses and CPU routes;
the collector's pauses during the flood printed); (c)
``fast_external_kill9(seed=23)`` and (d) ``fleet_smoke(seed=51)``:
delivery verified, pid-verified SIGKILLs, and every child process (the
supervisor, each broker relay, each fleet worker) the port's by its
/proc command line, none left behind.  (a)'s and (b)'s launches add to
the kernels line.  Phase 9 drives the C ABI (librdkafka_tpu_torch/capi):
(a) gcc builds libtkafka.so from the checkout, then capi/gpu_smoke.c,
the port's examples/cpp_client.cpp and the reference's unchanged
tests/capi_smoke.c against it; (b) gpu_smoke, a C program, runs phase 6's
Producer -> mock -> Consumer(check.crcs) path through the library at 64 x
1,600 x 1 KB a repeat, three repeats on each of two legs ((a) CRC
tickets, (b) gpu.compress.device=true; gpu.governor=false,
gpu.launch.min.batches=1, warm first): tk_create_topic, tk_produce_batch
and tk_flush, a tail through tk_produce2 (raw-byte headers, DRs) and
tk_flush, then tk_assign and every record checked in order in C.  The
clients' codec_engine stats before and after each leg give the launches
(crc_rows on leg a, lz4_rows on leg b, both clients' CRC verify), which
add to the kernels line, and must show no job on a CPU route; its msgs/s
print beside phase 6b's and 6c's; (c) capi_smoke and cpp_client pass
against the port's library, capi_smoke's embedded sys.executable
running -c as Python (the GPU provider's transport probe re-runs it);
(d) the performance example (-P --backend cpu, -P --backend gpu, -C
--backend gpu, one process calling its main() thrice, set up beside
(c) and started after it) against the standalone mock, its msgs/s printed; each GPU run, under the provider's
default governor, must launch on the card, and the jobs it served on
the CPU print beside its launches.  Phase 9 fails past 60 s.  Any
mismatch exits non-zero.

The last two lines of standard output are a ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when no CUDA device is available.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import select
import shutil
import statistics
import subprocess
import sys
import sysconfig
import threading
import time
import zlib

import numpy as np
import torch

from librdkafka_tpu_torch import (CpuCodecProvider, GpuCodecProvider,
                                  read_batches, submit_batches, submit_read,
                                  write_batches)
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.models import codec_step
from librdkafka_tpu_torch.ops import crc32c_torch as crc
from librdkafka_tpu_torch.ops import lz4_torch as lz4
from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
from librdkafka_tpu_torch.parallel import mesh
from librdkafka_tpu_torch.ops.packing import (LZ4F_BLOCKSIZE, lz4f_frame,
                                              pad_left, pad_right)
from librdkafka_tpu_torch.protocol.msgset import (CrcMismatch,
                                                  MsgsetWriterV2, Record,
                                                  iter_legacy_crc_regions,
                                                  write_msgset_v01)
from librdkafka_tpu_torch.protocol.proto import V2_OF_Attributes

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12          # H100 SXM 32-bit non-tensor peak
SEED = 0
PARTITIONS, RECORDS, VALUE_SIZE = 64, 960, 1024
ROUNDS = 5
NOW_MS = 1_700_000_000_000     # fixed, so both providers' bytes match


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def payloads(n: int, size: int) -> list[bytes]:
    """The benchmark's value generator (bench.py _payloads)."""
    out = []
    base = (b'{"seq": %07d, "user": "u%05d", "event": "click", '
            b'"props": "abcdefghijklmnopqrstuvwxyz0123456789"}')
    for i in range(n):
        b = base % (i, i % 1000)
        out.append((b * (size // len(b) + 1))[:size])
    return out


def kernel_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events),
    with L2 flushed before each run: the rows arrive from the host.  A
    spin kernel ahead of the start event lets the host enqueue ``fn``
    before the device reaches it, so the wrapper's host overhead stays
    out of a kernel's time."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def b2b_ms(fn, n: int = 50) -> float:
    """Device time per call of ``fn`` over ``n`` calls back to back
    between two CUDA events (L2 warm), which spreads the events' own
    cost over the calls."""
    fn()
    torch.cuda._sleep(1_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` ending in a device sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_busy_share(fn) -> float | None:
    """Share of ``fn``'s wall time the card spent in kernels and copies
    (torch.profiler); None when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us = sum(e.self_device_time_total for e in prof.key_averages())
    return dev_us / wall_us if dev_us > 0 else None


def bound(rows: int, n: int, polys: int) -> tuple[float, str]:
    """Least time for the row kernel's work: each input byte read once
    (rows, terms, sel, the tables of the polynomials used), each output
    written once, over HBM; vs 2 ALU ops (lookup + xor) per row byte."""
    nbytes = rows * n + rows * (8 + 4 + 8) + polys * (8 * 256 + 64 * 32) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rows * n / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seg_bound(offs, lens, polys: int) -> tuple[float, str]:
    """Least time for the segment kernel's work on these inputs: the real
    bytes read once, plus the metadata (a 16 B descriptor a tile, sel
    4 B a segment), the constants of the polynomials used and the outputs
    (8 B a segment), over HBM; vs 2 ALU ops (lookup + xor) per real
    byte."""
    lens = np.asarray(lens, np.int64)
    tiles = crc.plan_tiles(np.asarray(offs, np.int64), lens)
    real = int(lens.sum())
    nbytes = (real + 12 * len(lens) + 16 * len(tiles)
              + polys * crc._kernel_consts("crc32c").nbytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * real / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rows_for(bufs, polys_per_row):
    data, lens = pad_left(bufs, crc.BLOCK)
    terms = np.array([crc._term_host(int(n), p)
                      for n, p in zip(lens, polys_per_row)], dtype=np.int64)
    sel = np.array([crc.POLYS.index(p) for p in polys_per_row],
                   dtype=np.int32)
    return data, terms, sel


def pack(bufs, rng=None):
    """Join ``bufs`` into one flat array (with random gaps of 1-37 bytes
    ahead of each when ``rng`` is given); returns (flat on the card,
    offsets, lengths) as crc_segments takes them."""
    flat, offs = bytearray(), []
    for b in bufs:
        if rng is not None:
            flat += bytes(int(rng.integers(1, 38)))
        offs.append(len(flat))
        flat += b
    flat += bytes(-len(flat) % 16)
    return (torch.frombuffer(flat, dtype=torch.uint8).cuda(),
            torch.tensor(offs, dtype=torch.int64),
            torch.tensor([len(b) for b in bufs], dtype=torch.int64))


def oracle(bufs, sel) -> list[int]:
    return [native.crc32c(b) if p == 0 else zlib.crc32(b) & 0xFFFFFFFF
            for b, p in zip(bufs, sel.tolist())]


# ---------------------------------------------------------------- phase 1 --

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card)")
    print(smi)
    cv = sysconfig.get_config_var
    print(f"python {sys.executable}: Py_ENABLE_SHARED="
          f"{cv('Py_ENABLE_SHARED')} LDLIBRARY={cv('LDLIBRARY')} "
          f"LIBDIR={cv('LIBDIR')} (libtkafka.so, phase 9, links it)")
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    ths = [threading.Thread(target=f) for f in (crc._kernel_lib,
                                                lz4._kernel_lib)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    t_nvcc = time.perf_counter() - t0
    check(crc._lib is not None and lz4._lib is not None,
          "a kernel did not build (nvcc's output is above)")
    t0 = time.perf_counter()
    native.lib()
    t_gpp = time.perf_counter() - t0
    print(f"build: crc_rows.cu + lz4_rows.cu (nvcc, in parallel) "
          f"{t_nvcc:.3f} s, codec.cpp (g++) {t_gpp:.3f} s")
    for src, log in (("crc_rows", crc.build_log), ("lz4_rows", lz4.build_log)):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")
    return {"name": name, "smi": smi}


# ---------------------------------------------------------------- phase 2 --

def phase_kernel(rng, regions) -> tuple[int, dict]:
    """Kernel == plain version == CPU oracle; returns the max abs error
    between kernel and plain version (0 when they agree) and the timing
    of the main path's shape (its produce regions, crc32c)."""
    max_err = 0
    print("phase 2: crc_rows vs plain version, rows of 65536 B")
    print("  B    sel     kernel_ms  bound_ms  plain_ms  h2d_ms")
    for B in (1, 8, 128, 256):
        lens = rng.integers(0, crc.BLOCK + 1, size=B)
        lens[0] = crc.BLOCK
        bufs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in lens]
        for mode in ("crc32c", "crc32", "mixed"):
            polys = ([mode] * B if mode != "mixed" else
                     [crc.POLYS[int(s)] for s in rng.integers(0, 2, B)])
            data, terms, sel = rows_for(bufs, polys)
            d = torch.from_numpy(data).cuda()
            t = torch.from_numpy(terms).cuda()
            s = torch.from_numpy(sel).cuda()
            got = crc.crc_rows(d, t, s)
            ref = crc.crc_rows_reference(d, t, s)
            torch.cuda.synchronize()
            err = int((got - ref).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"kernel != plain version at B={B} sel={mode}")
            check(got.cpu().tolist() == oracle(bufs, sel),
                  f"kernel != CPU oracle at B={B} sel={mode}")
            if mode != "mixed":
                continue
            # crc_rows' own launch, staged so that the timing holds the
            # kernel alone
            staged = crc.stage(d.reshape(-1),
                               torch.arange(B, dtype=torch.int64) * crc.BLOCK,
                               torch.full((B,), crc.BLOCK, dtype=torch.int64),
                               s, t)
            ms = kernel_ms(lambda: crc.launch(staged))
            check(torch.equal(staged[0], ref),
                  f"a staged launch fired again differs at B={B}")
            plain = kernel_ms(lambda: crc.crc_rows_reference(d, t, s), 5)
            h2d = host_ms(lambda: torch.from_numpy(data).cuda())
            bms, _ = bound(B, crc.BLOCK, 2)
            print(f"  {B:<4} {mode:<7} {ms:9.4f} {bms:9.4f} {plain:9.3f} "
                  f"{h2d:7.3f}")

    def ragged(n):
        return rng.integers(0, 200_001, n)

    shapes = (
        ("main path", [bytes(r) for r in regions], False, "crc32c"),
        ("256 x 65536", [rng.integers(0, 256, crc.BLOCK, dtype=np.uint8)
                         .tobytes() for _ in range(256)], False, "mixed"),
        ("ragged 0-200000", [rng.integers(0, 256, int(n), dtype=np.uint8)
                             .tobytes() for n in ragged(64)], True, "mixed"),
        ("61440 x 1024", [bytes(r) for r in rng.integers(
            0, 256, (61_440, 1024), dtype=np.uint8)], False, "mixed"))
    one = torch.zeros(1, device="cuda")
    print("phase 2: crc_segments vs plain version, packed segments; "
          f"kernel_ms as above, b2b_ms per launch of 50 back to back; "
          f"one elementwise kernel reads "
          f"{kernel_ms(lambda: one.add_(1)):.4f} ms by kernel_ms")
    print("  shape            segs   real_bytes  kernel_ms  b2b_ms  "
          "bound_ms  padded_bound_ms  plain_ms")
    main = {}
    for name, bufs, gaps, timed in shapes:
        flat, offs, lens = pack(bufs, rng if gaps else None)
        for mode in ("crc32c", "crc32", "mixed"):
            sel = (torch.full((len(bufs),), crc.POLYS.index(mode),
                              dtype=torch.int32) if mode != "mixed" else
                   torch.from_numpy(rng.integers(0, 2, len(bufs))
                                    .astype(np.int32)))
            got = crc.crc_segments(flat, offs, lens, sel)
            ref = crc.crc_segments_reference(flat, offs, lens, sel)
            torch.cuda.synchronize()
            err = int((got - ref).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"kernel != plain version at {name} sel={mode}")
            check(got.cpu().tolist() == oracle(bufs, sel),
                  f"kernel != CPU oracle at {name} sel={mode}")
            if mode != timed:
                continue
            staged = crc.stage(flat, offs, lens, sel)
            ms = kernel_ms(lambda: crc.launch(staged))
            b2b = b2b_ms(lambda: crc.launch(staged))
            check(torch.equal(staged[0], ref),
                  f"a staged launch fired again differs at {name}")
            plain = kernel_ms(
                lambda: crc.crc_segments_reference(flat, offs, lens, sel), 3)
            polys = len(set(sel.tolist()))
            bms, by = seg_bound(offs.numpy(), lens.numpy(), polys)
            rows = sum(math.ceil(n / crc.BLOCK) for n in lens.tolist())
            pbms, _ = bound(rows, crc.BLOCK, polys)
            print(f"  {name:<16} {len(bufs):6d} {int(lens.sum()):12d} "
                  f"{ms:10.4f} {b2b:7.4f} {bms:9.5f} {pbms:16.5f} "
                  f"{plain:9.3f}")
            if name == "main path":
                main = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                        "bound_by": by}
    print("phase 2: ok (kernel == plain == oracle, crc32c/crc32/mixed)")
    return max_err, main


# ---------------------------------------------------------------- phase 3 --

def workload(cpu_p) -> dict:
    """The main path's records, its MsgVer1 legacy fetch blobs (lz4
    wrappers, and uncompressed), and its produce regions (the CPU
    provider's wire, which the GPU provider must equal)."""
    vals = payloads(4096, VALUE_SIZE)
    parts = [[Record(value=vals[(p * RECORDS + i) % len(vals)])
              for i in range(RECORDS)] for p in range(PARTITIONS)]
    legacy = [write_msgset_v01(
        recs, magic=1, codec="lz4", now_ms=NOW_MS,
        compress_fn=lambda raw: cpu_p.compress_many("lz4", [raw])[0])
        for recs in parts]
    plain = [write_msgset_v01(recs, magic=1, codec=None, now_ms=NOW_MS)
             for recs in parts]
    wire = write_batches(cpu_p, parts, "lz4", NOW_MS)
    return {"parts": parts, "legacy": legacy, "legacy_plain": plain,
            "wire_cpu": wire,
            "regions": [w[V2_OF_Attributes:] for w in wire]}


def profiler_vs_events(regions) -> tuple[float | None, float, float]:
    """Device time of 20 launches of the kernel on the main path's
    regions, read three ways: torch.profiler's sum for the kernel; the
    sum of CUDA-event intervals around each launch (a spin kernel ahead);
    one CUDA-event interval around the 20 launches back to back."""
    from torch.profiler import ProfilerActivity, profile
    flat, offs, lens = pack(regions)
    staged = crc.stage(flat, offs, lens,
                       torch.zeros(len(regions), dtype=torch.int32))
    crc.launch(staged)
    each_ms = 0.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            crc.launch(staged)
            b.record()
            torch.cuda.synchronize()
            each_ms += a.elapsed_time(b)
        b2b = b2b_ms(lambda: crc.launch(staged), 20) * 20
    prof_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if "crc_segments" in e.key)
    return (prof_us / 2e3 if prof_us > 0 else None), each_ms, b2b


def route_split(regions) -> dict:
    """Host-clock ms (median of 20, each step ending in a device sync) of
    the steps of the GPU CRC route for one round's regions, taken one by
    one as crc32c_torch._crc_many takes them, and of the whole call."""
    real = sum(len(r) for r in regions)
    lens = torch.tensor([len(r) for r in regions], dtype=torch.int64)
    offs = torch.cumsum(lens, 0) - lens
    sel = torch.zeros(len(regions), dtype=torch.int32)

    def join():
        return torch.frombuffer(
            bytearray().join([*regions, bytes(-real % 16)]),
            dtype=torch.uint8)

    host = join()
    flat = host.cuda()
    staged = crc.stage(flat, offs, lens, sel)
    return {
        "join on the host": host_ms(join, 20),
        "H2D of flat (pageable)": host_ms(lambda: host.cuda(), 20),
        "checks, tile plan, metadata H2D": host_ms(
            lambda: crc.stage(flat, offs, lens, sel), 20),
        "kernel launch + D2H of the CRCs": host_ms(
            lambda: crc.launch(staged).cpu(), 20),
        "crc32c_many, whole": host_ms(lambda: crc.crc32c_many(regions), 20),
    }


def phase_main_path(gpu, cpu_p, work: dict) -> dict:
    parts, legacy = work["parts"], work["legacy"]
    nmsgs = PARTITIONS * RECORDS

    # the counted run: the main path, produce then verify, plus the
    # legacy fetch leg
    crc.launches = 0
    crc.h2d_bytes = 0
    wire = write_batches(gpu, parts, "lz4", NOW_MS)
    per_stage = {"produce": crc.launches}
    h2d_produce = crc.h2d_bytes
    got = read_batches(gpu, wire)
    per_stage["verify"] = crc.launches - per_stage["produce"]
    got_legacy = read_batches(gpu, legacy)
    torch.cuda.synchronize()
    launches = crc.launches
    per_stage["legacy verify"] = launches - sum(per_stage.values())
    check(all(per_stage.values()),
          f"a main-path stage launched the crc_rows kernel 0 times: "
          f"{per_stage}")

    check(wire == work["wire_cpu"], "GPU provider wire bytes != CPU "
          "provider's")
    for recs, want in ((got, parts), (got_legacy, parts)):
        check(len(recs) == len(want), "partition count differs")
        for r, w in zip(recs, want):
            check([(x.key, x.value) for x in r]
                  == [(x.key, x.value) for x in w],
                  "records read back differ from those written")
    bad = bytearray(wire[5])
    bad[-1] ^= 0x01
    try:
        read_batches(gpu, [bytes(bad)])
        fail("a flipped payload byte did not raise CrcMismatch")
    except CrcMismatch:
        pass

    regions = work["regions"]
    real = sum(len(r) for r in regions)
    S = len(regions)
    lens = np.array([len(r) for r in regions], np.int64)
    tiles = crc.plan_tiles(np.cumsum(lens) - lens, lens)
    meta = 16 * len(tiles) + 8 * math.ceil(S / 2)
    rows = sum(math.ceil(len(r) / crc.BLOCK) for r in regions)
    print(f"phase 3: {PARTITIONS} partitions x {RECORDS} x {VALUE_SIZE} B "
          f"lz4: {S} regions per round ({real} real bytes, {rows} rows of "
          f"64 KB under the padded contract); launches per round: "
          + ", ".join(f"{k} {v}" for k, v in per_stage.items()))
    print(f"  h2d bytes of one produce round: {h2d_produce} (regions "
          f"{real} + alignment {-real % 16} + metadata {meta}; padded rows "
          f"would copy {rows * crc.BLOCK})")
    check(h2d_produce == real + (-real % 16) + meta,
          f"produce round copied {h2d_produce} bytes to the card, not the "
          f"regions' {real} plus {meta} of metadata")

    provs = (("gpu", gpu), ("cpu", cpu_p))
    for _, prov in provs:                                   # warm round
        write_batches(prov, parts, "lz4", NOW_MS)
        read_batches(prov, wire)
    t_prod = {"gpu": 0.0, "cpu": 0.0}
    t_ver = {"gpu": 0.0, "cpu": 0.0}
    for _ in range(ROUNDS):                 # providers in turn, per round
        for name, prov in provs:
            t0 = time.perf_counter()
            write_batches(prov, parts, "lz4", NOW_MS)
            t1 = time.perf_counter()
            read_batches(prov, wire)
            t2 = time.perf_counter()
            t_prod[name] += t1 - t0
            t_ver[name] += t2 - t1
    for name, _ in provs:
        print(f"  {name} provider: produce {ROUNDS * nmsgs / t_prod[name]:.0f}"
              f" msgs/s, verify {ROUNDS * nmsgs / t_ver[name]:.0f} msgs/s "
              f"({ROUNDS} rounds after one warm round)")
    crc_ms = {name: host_ms(lambda: prov.crc32c_many(regions))
              for name, prov in provs}
    print(f"  crc32c_many of one round's {S} regions: gpu "
          f"{crc_ms['gpu']:.3f} ms, cpu {crc_ms['cpu']:.3f} ms (host clock)")
    busy = device_busy_share(lambda: write_batches(gpu, parts, "lz4", NOW_MS))
    print("  device busy share of one gpu produce round: "
          + ("not measured (profiler saw no device time)" if busy is None
             else f"{busy:.6f}"))
    prof_ms, each_ms, b2b = profiler_vs_events(regions)
    print(f"  20 kernel launches on the round's regions, device ms: "
          f"profiler's kernel sum "
          + ("not measured (no kernel time)" if prof_ms is None
             else f"{prof_ms:.4f}")
          + f"; CUDA events around each {each_ms:.4f}, around all 20 back "
          f"to back {b2b:.4f}")
    split = route_split(regions)
    print("  GPU CRC route of one round, host clock ms: " + "; ".join(
        f"{k} {v:.4f}" for k, v in split.items()))

    # uncompressed MsgVer1 fetch: one legacy CRC region per message
    plain = work["legacy_plain"]
    nreg = sum(len(iter_legacy_crc_regions(b)) for b in plain)
    before = crc.launches
    t0 = time.perf_counter()
    got_plain = read_batches(gpu, plain)
    t_gpu = (time.perf_counter() - t0) * 1e3
    leg_launches = crc.launches - before
    t0 = time.perf_counter()
    read_batches(cpu_p, plain)
    t_cpu = (time.perf_counter() - t0) * 1e3
    check([[x.value for x in r] for r in got_plain]
          == [[x.value for x in w] for w in parts],
          "uncompressed MsgVer1 records read back differ")
    regs = [r for b in plain for _, _, r in iter_legacy_crc_regions(b)]
    leg_ms = {name: host_ms(lambda: prov.crc32_many(regs), 3)
              for name, prov in provs}
    print(f"  uncompressed MsgVer1 fetch, {nreg} legacy regions "
          f"({sum(len(r) for r in regs)} bytes): {leg_launches} launch(es); "
          f"read_batches gpu {t_gpu:.1f} ms, cpu {t_cpu:.1f} ms; "
          f"crc32_many gpu {leg_ms['gpu']:.3f} ms, cpu {leg_ms['cpu']:.3f} ms "
          f"(host clock)")
    check(leg_launches == math.ceil(sum(len(r) for r in regs)
                                    / crc.LAUNCH_BYTES),
          f"uncompressed legacy fetch took {leg_launches} launches")
    print("phase 3: ok (round trip, wire == CPU provider, CrcMismatch, "
          "legacy legs, no padding copied)")
    return {"launches": launches}


# ---------------------------------------------------------------- phase 4 --

def fallback(cpu_p):
    """The engine's CPU fallback: the native provider, per polynomial."""
    return lambda bufs, poly: (cpu_p.crc32c_many(bufs) if poly == "crc32c"
                               else cpu_p.crc32_many(bufs))


def no_cpu_route(eng, what: str) -> None:
    """A counted leg ran with the device route open: no job of it went to
    the CPU (warmup miss, governor route or quorum fallback)."""
    bad = {k: eng.stats[k] for k in ("warmup_miss_jobs", "routed_cpu_jobs",
                                     "cpu_fallback_jobs") if eng.stats[k]}
    check(not bad, f"{what}: jobs served on the CPU: {bad}")


def wait_for(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.0002)


def cold_start_s() -> str:
    """A fresh process: import, GpuCodecProvider() with its defaults, and
    wait_warm (the transport probe in its subprocess, with no cached
    reading; CUDA init, constants, the warm launch; the kernel's .so is
    already built)."""
    code = ("import time; t0 = time.perf_counter()\n"
            "from librdkafka_tpu_torch import GpuCodecProvider\n"
            "p = GpuCodecProvider(); t1 = time.perf_counter()\n"
            "ok = p.wait_warm(300); t2 = time.perf_counter()\n"
            "print(ok, round(t1 - t0, 3), round(t2 - t1, 3), "
            "p.transport_mb_s); p.close()\n")
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:   # no cached probe reading
        res = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=600,
                             env={**os.environ, "TMPDIR": tmp})
    check(res.returncode == 0, f"cold-start process failed: {res.stderr}")
    ok, t_create, t_warm, mb_s = res.stdout.split()
    check(ok == "True", "a fresh GpuCodecProvider's route did not open")
    return (f"import + create {t_create} s, create -> wait_warm "
            f"{t_warm} s (transport probe {float(mb_s):.0f} MB/s)")


def engine_exact(cpu_p, rng) -> int:
    """(a): test_0018's sizes, 8 rotated rounds all submitted before any
    resolves, each its own launch (the next is submitted once the last
    has started), so ring slots are refilled while earlier copies may be
    in flight; then a crc32 job, and a crc32c + crc32 pair popped together
    (one fused launch).  Every result == the native oracle; the first
    launch's staged inputs through the plain version == its outputs.
    Returns the max abs error of that comparison."""
    eng = AsyncOffloadEngine(depth=2, fanin_window_s=0.1, min_batches=4,
                             governor=True, warmup=True,
                             cpu_fallback=fallback(cpu_p))
    staged, outs = [], []
    real_launch, real_read = crc.launch_slot, crc.read_slot

    def launch_rec(slot, plan, lane):
        if not staged:
            staged.append((plan, slot.host[:plan.flat_bytes].clone()))
        real_launch(slot, plan, lane)

    def read_rec(slot, plan):
        got = real_read(slot, plan)
        if staged and plan is staged[0][0] and not outs:
            outs.append(got)
        return got

    crc.launch_slot, crc.read_slot = launch_rec, read_rec
    try:
        check(eng.warm_wait(300), "the engine's lane did not warm")
        bufs = [b"", b"a", b"123456789", bytes(100)] + [
            rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (1, 63, 1000, 65535, 65536, 65537, 200_000)]
        rounds = [bufs[r % 11:] + bufs[:r % 11] for r in range(8)]
        l0 = crc.launches
        tickets = []
        for b in rounds:
            n = eng.stats["launches"]
            tickets.append(eng.submit(b, "crc32c", window=False))
            wait_for(lambda: eng.stats["launches"] > n, "a round's launch")
        for b, t in zip(rounds, tickets):
            check(t.result(60).tolist() == [native.crc32c(x) for x in b],
                  "engine crc32c != oracle with ring slots reused")
        t = eng.submit(bufs, "crc32", window=False)
        check(t.result(60).tolist() == [zlib.crc32(x) for x in bufs],
              "engine crc32 != oracle")
        bufs_c = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                  for n in (900, 70_000)]
        bufs_l = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                  for n in (4096, 17)]
        t1 = eng.submit(bufs_c, "crc32c", window=True)
        t2 = eng.submit(bufs_l, "crc32", window=True)
        check(t1.result(60).tolist() == [native.crc32c(x) for x in bufs_c]
              and t2.result(60).tolist() == [zlib.crc32(x) for x in bufs_l],
              "fused launch != oracle")
        check(eng.stats["fused_launches"] == 1,
              f"fused_launches {eng.stats['fused_launches']}, not 1")
        check(eng.stats["launches"] == 10 and crc.launches - l0 == 10,
              f"(a) took {eng.stats['launches']} engine launches, "
              f"{crc.launches - l0} kernel launches, not 10")
        no_cpu_route(eng, "(a)")
        plan, flat = staged[0]
        ref = crc.crc_segments_reference(
            flat.cuda(), torch.from_numpy(plan.offsets),
            torch.from_numpy(plan.lengths), torch.from_numpy(plan.sel))
        err = int(np.abs(ref.cpu().numpy() - outs[0].astype(np.int64)).max())
        check(err == 0, "an engine launch != the plain version on its "
              "staged inputs")
        rings = eng._lanes[0].staging.nbytes()
    finally:
        crc.launch_slot, crc.read_slot = real_launch, real_read
        eng.close()
    print(f"phase 4a: engine exact: 8 rounds in flight (ring reuse), crc32, "
          f"fused pair: 10 launches, fused_launches 1; pinned staging "
          f"{rings} B; staged launch == plain version")
    return err


def pipelined(prov, parts, rounds: int) -> list:
    """Rounds of submit_batches, round k+1 submitted before round k
    resolves (round k is advanced first, so its CRC goes out ahead of
    round k+1's compress job)."""
    wires = []
    pend = submit_batches(prov, parts, "lz4", NOW_MS)
    for k in range(rounds):
        pend.done()
        nxt = (submit_batches(prov, parts, "lz4", NOW_MS)
               if k + 1 < rounds else None)
        wires.append(pend.result(120))
        pend = nxt
    return wires


def pipelined_read(prov, wire, rounds: int) -> list:
    out = []
    pend = submit_read(prov, wire)
    for k in range(rounds):
        nxt = submit_read(prov, wire) if k + 1 < rounds else None
        out.append(pend.result(120))
        pend = nxt
    return out


def engine_split(regions) -> dict:
    """Host-clock ms (median of 20, each step ending in a device sync) of
    the engine route's steps for one round's regions, taken one by one as
    the engine takes them on a lane of its own."""
    lane = crc.LaneBuffers(torch.device("cuda", 0))
    lens = np.array([len(r) for r in regions], np.int64)
    sel = np.zeros(len(regions), np.int32)
    plan = crc.plan_slot(lens, sel)
    slot = crc.Slot(crc.slot_bucket(plan.nbytes), pin=True)
    joined = b"".join(regions)
    crc.fill_slot(slot, plan, [joined])
    crc.send_slot(slot, plan, lane)
    crc.launch_slot(slot, plan, lane)
    check(crc.read_slot(slot, plan).tolist()
          == [native.crc32c(r) for r in regions], "engine split != oracle")

    def plan_fill():
        crc.fill_slot(slot, crc.plan_slot(lens, sel), [joined])

    return {
        "join at submit": host_ms(lambda: b"".join(regions), 20),
        "plan + pinned fill": host_ms(plan_fill, 20),
        "async H2D (pinned, lane stream)": host_ms(
            lambda: crc.send_slot(slot, plan, lane), 20),
        "launch + D2H of the CRCs": host_ms(
            lambda: crc.launch_slot(slot, plan, lane), 20),
        "readback (event + view)": host_ms(
            lambda: crc.read_slot(slot, plan), 20),
    }


def engine_timeline(prov, regions, calls: int = 20) -> dict:
    """Where one engine ``crc32c_many`` of a round's regions spends its
    host-clock time, from the port's tracer (obs/trace.py): submit to the
    dispatch thread's device_launch span, the span itself, its end to the
    readback span, the readback, and the readback's end to the caller's
    return.  Medians over ``calls`` calls, in ms."""
    from librdkafka_tpu_torch.obs import trace
    marks = []
    trace.enable()
    try:
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = trace.now()
            prov.crc32c_many(regions)
            marks.append((t0, trace.now()))
        events = trace.collect_events()
    finally:
        trace.disable()
    spans = {n: sorted((e["ts"] * 1e3, e["dur"] * 1e3) for e in events
                       if e["name"] == n and e.get("ph") == "X")
             for n in ("device_launch", "readback")}
    check(len(spans["device_launch"]) == calls
          and len(spans["readback"]) == calls,
          f"traced {len(spans['device_launch'])} launches, "
          f"{len(spans['readback'])} readbacks for {calls} calls")
    steps = {"submit -> launch span": [], "launch span (plan, fill, H2D, "
             "kernel, D2H queued)": [], "launch end -> readback": [],
             "readback span (event wait, view)": [],
             "readback end -> caller returns": [], "whole call": []}
    for (t0, t1), (l0, ld), (r0, rd) in zip(marks, spans["device_launch"],
                                            spans["readback"]):
        for k, v in zip(steps, (l0 - t0, ld, r0 - (l0 + ld), rd,
                                t1 - (r0 + rd), t1 - t0)):
            steps[k].append(v / 1e6)
    return {k: statistics.median(v) for k, v in steps.items()}


def timed_wait_ms(reps: int = 50) -> float:
    """Median host-clock ms of a 0.2 ms ``Condition.wait`` on this host:
    the engine's dispatch loop lingers that long for a next submission
    before it reads back a launch."""
    cond = threading.Condition()
    times = []
    with cond:
        for _ in range(reps):
            t0 = time.perf_counter()
            cond.wait(0.0002)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_engine(cpu_p, gpu_sync, work: dict, rng) -> dict:
    parts, wire_cpu = work["parts"], work["wire_cpu"]
    regions = work["regions"]
    nmsgs = PARTITIONS * RECORDS
    real = sum(len(r) for r in regions)
    lens = np.array([len(r) for r in regions], np.int64)
    meta = (16 * len(crc.plan_tiles(np.cumsum(lens) - lens, lens))
            + 8 * math.ceil(len(regions) / 2))
    print(f"phase 4: cold start in a fresh process: {cold_start_s()}")
    err = engine_exact(cpu_p, rng)
    counted = 0

    # (b) pipelined produce, governor off, route open: the counted leg
    t0 = time.perf_counter()
    prov = GpuCodecProvider(min_batches=1, governor=False)
    check(prov.wait_warm(300), "the pipelined provider's route is closed")
    t_open = time.perf_counter() - t0
    eng = prov._get_engine()
    crc.launches = 0
    crc.h2d_bytes = 0
    wires = pipelined(prov, parts, ROUNDS)
    torch.cuda.synchronize()
    launches, h2d = crc.launches, crc.h2d_bytes
    counted += launches
    check(all(w == wire_cpu for w in wires),
          "pipelined wire bytes != CPU provider's")
    check(launches == ROUNDS and eng.stats["launches"] == ROUNDS,
          f"{ROUNDS} pipelined rounds took {launches} kernel launches "
          f"({eng.stats['launches']} engine launches), not one each")
    check(h2d == ROUNDS * (real + (-real % 16) + meta),
          f"pipelined rounds copied {h2d} B to the card, not "
          f"{ROUNDS} x (regions {real} + alignment + metadata {meta})")
    no_cpu_route(eng, "(b) pipelined produce")
    print(f"phase 4b: {ROUNDS} pipelined rounds (submit_batches, round k+1 "
          f"before k resolves): wire == CPU provider, {launches} launches, "
          f"h2d {h2d} B = {ROUNDS} x ({real} + {-real % 16} + {meta}); "
          f"route open {t_open:.3f} s after creation in this process")

    # (c) fan-in: 4 submitters x 16 partitions, windowed, one round each
    fan = GpuCodecProvider(min_batches=PARTITIONS, governor=False,
                           fanin_us=20_000)
    check(fan.wait_warm(300), "the fan-in provider's route is closed")
    feng = fan._get_engine()
    want = [native.crc32c(r) for r in regions]
    crc.launches = 0
    for _ in range(ROUNDS):
        go = threading.Barrier(4)
        got = [None] * 4

        def submitter(i):
            go.wait()
            got[i] = fan.crc32c_submit(regions[16 * i:16 * i + 16])

        ths = [threading.Thread(target=submitter, args=(i,))
               for i in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
        check(all(t is not None for t in got), "fan-in submit declined")
        check(sum((t.result(60).tolist() for t in got), []) == want,
              "fan-in CRCs != oracle")
    torch.cuda.synchronize()
    fan_launches = crc.launches
    counted += fan_launches
    check(feng.stats["aggregated"] > 0, "fan-in never aggregated")
    check(fan_launches < 4 * ROUNDS,
          f"fan-in: {fan_launches} launches for {ROUNDS} rounds of 4 jobs")
    no_cpu_route(feng, "(c) fan-in")
    print(f"phase 4c: fan-in, 4 threads x 16 partitions x {ROUNDS} rounds: "
          f"{fan_launches} launches, aggregated {feng.stats['aggregated']}, "
          f"fanin_waits {feng.stats['fanin_waits']}")
    fan.close()

    # (d) ticketed verify of v2 batches and MsgVer1 lz4 wrappers
    blobs = wire_cpu + work["legacy"]
    crc.launches = 0
    recs = submit_read(prov, blobs).result(120)
    torch.cuda.synchronize()
    ver_launches = crc.launches
    counted += ver_launches
    check([[r.value for r in p] for p in recs]
          == [[r.value for r in p] for p in parts + parts],
          "ticketed verify: records differ")
    check(ver_launches >= 1, "ticketed verify launched no kernel")
    bad = bytearray(wire_cpu[7])
    bad[-1] ^= 0x01
    try:
        submit_read(prov, [bytes(bad)] + work["legacy"][:2]).result(120)
        fail("ticketed verify: a flipped byte did not raise CrcMismatch")
    except CrcMismatch:
        pass
    no_cpu_route(eng, "(d) ticketed verify")
    print(f"phase 4d: ticketed verify of {len(wire_cpu)} v2 batches + "
          f"{len(work['legacy'])} MsgVer1 lz4 wrappers: {ver_launches} "
          f"launches; CrcMismatch on a flipped byte")

    # (e) close() with tickets in flight
    closing = AsyncOffloadEngine(depth=2, min_batches=1, governor=False,
                                 warmup=True, cpu_fallback=fallback(cpu_p))
    check(closing.warm_wait(300), "closing engine did not warm")
    tickets = [closing.submit(regions, "crc32c", window=False)
               for _ in range(16)]
    closing.close()
    check(all(t.done() and t.result(0).tolist() == want for t in tickets),
          "close() left a ticket unresolved or wrong")
    print("phase 4e: close() with 16 tickets in flight resolved all, exact")

    # (f) numbers, all in this call
    crc_ms = {"engine": host_ms(lambda: prov.crc32c_many(regions), 20),
              "sync GPU": host_ms(lambda: gpu_sync.crc32c_many(regions), 20),
              "native": host_ms(lambda: cpu_p.crc32c_many(regions), 20)}
    print("  crc32c_many of one round's 64 regions, host clock ms: "
          + "; ".join(f"{k} {v:.4f}" for k, v in crc_ms.items()))
    print("  engine route of one round, host clock ms: " + "; ".join(
        f"{k} {v:.4f}" for k, v in engine_split(regions).items()))
    print("  engine crc32c_many timeline, traced, median ms: " + "; ".join(
        f"{k} {v:.4f}" for k, v in engine_timeline(prov, regions).items())
          + f"; a 0.2 ms Condition.wait takes {timed_wait_ms():.4f}")
    eng.stage_latency_snapshot()                 # drop the windows so far
    pipelined(prov, parts, ROUNDS)
    lat = eng.stage_latency_snapshot()
    print("  stage_latency over one pipelined leg (us, avg/p50/p99): "
          + "; ".join(f"{k} {lat[k]['avg']}/{lat[k]['p50']}/{lat[k]['p99']}"
                      for k in ("submit_wait", "launch", "reap")))
    t_prod = {"cpu": 0.0, "sync GPU": 0.0, "pipelined GPU": 0.0}
    t_ver = dict.fromkeys(t_prod, 0.0)
    for _ in range(2):                       # a warm turn, then timed turns
        for name, fn, rd in (
                ("cpu", lambda: [write_batches(cpu_p, parts, "lz4", NOW_MS)
                                 for _ in range(ROUNDS)],
                 lambda: [read_batches(cpu_p, wire_cpu)
                          for _ in range(ROUNDS)]),
                ("sync GPU", lambda: [write_batches(gpu_sync, parts, "lz4",
                                                    NOW_MS)
                                      for _ in range(ROUNDS)],
                 lambda: [read_batches(gpu_sync, wire_cpu)
                          for _ in range(ROUNDS)]),
                ("pipelined GPU", lambda: pipelined(prov, parts, ROUNDS),
                 lambda: pipelined_read(prov, wire_cpu, ROUNDS))):
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            rd()
            t_prod[name] = t1 - t0
            t_ver[name] = time.perf_counter() - t1
    for name in t_prod:
        print(f"  {name}: produce {ROUNDS * nmsgs / t_prod[name]:.0f} msgs/s,"
              f" verify {ROUNDS * nmsgs / t_ver[name]:.0f} msgs/s "
              f"({ROUNDS} rounds)")
    busy = device_busy_share(lambda: pipelined(prov, parts, ROUNDS))
    print("  device busy share of pipelined produce rounds: "
          + ("not measured (profiler saw no device time)" if busy is None
             else f"{busy:.6f}"))
    no_cpu_route(eng, "(f) timed legs")
    prov.close()

    # (g) the governed leg, reference defaults: its route split, reported
    gov = GpuCodecProvider()
    check(gov.wait_warm(300), "the default provider's route is closed")
    wires = pipelined(gov, parts, ROUNDS)
    check(all(w == wire_cpu for w in wires),
          "governed pipelined wire != CPU provider's")
    g = gov._get_engine()
    split = {k: g.stats[k] for k in ("launches", "routed_cpu_jobs",
                                     "explore_routes", "cpu_fallback_jobs",
                                     "warmup_miss_jobs")}
    print(f"  governed leg (GpuCodecProvider() defaults), {ROUNDS} rounds: "
          f"{split}; governor {g.governor_snapshot()}")
    gov.close()
    print("phase 4: ok (engine exact, pipelined wire == CPU provider, one "
          "launch per round, fan-in, ticketed verify, close)")
    return {"launches": counted, "max_err": err}


# ---------------------------------------------------------------- phase 5 --

class DetProvider(CpuCodecProvider):
    """The deterministic-writer oracle: the CPU provider with lz4 on the
    native insert-all encoder, whose bytes the LZ4 kernel must equal (the
    default CPU provider's fast parse writes other, equally valid,
    frames)."""

    def compress_many(self, codec, bufs, level=-1):
        if codec == "lz4":
            return native.lz4f_compress_many([bytes(b) for b in bufs],
                                             deterministic=True)
        return super().compress_many(codec, bufs, level)


def det_frames(bufs) -> list[bytes]:
    return native.lz4f_compress_many([bytes(b) for b in bufs],
                                     deterministic=True)


def lz4_bound(lens, olen, mode: str = "both") -> tuple[float, str]:
    """Least time for the LZ4 kernel's work on these rows in ``mode``:
    each raw byte read once, each compressed byte, length and CRC asked
    for written once, over HBM; vs its operations at the 32-bit ALU peak:
    about 8 a raw byte for the parse (load, hash multiply and shift,
    table read and write, compare) and 2 a byte (lookup + xor) for each
    CRC asked for, raw and compressed."""
    lens = np.asarray(lens, np.int64)
    olen = np.asarray(olen, np.int64)
    raw_crc, comp_crc = mode != "none", mode == "both"
    nbytes = int(lens.sum() + olen.sum()) + len(lens) * (
        4 + 4 + 8 * (raw_crc + comp_crc))
    ops = ((8 + 2 * raw_crc) * int(lens.sum())
           + 2 * comp_crc * int(olen.sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lz4_sweep(rng) -> list[bytes]:
    """Sizes and shapes, and the edge rows of the kernel's stages
    (``lz4_torch.edge_rows``: segment borders, dense collisions, short
    and unaligned rows, incompressible, all-equal, the farthest repeats,
    a main-path tail)."""
    blocks = [b"", b"Z", b"x" * 12, b"abcdabcdabcda", b"kv-pair " * 128,
              b"ab" * 32767 + b"xy",
              rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
              rng.integers(0, 4, 65536, dtype=np.uint8).tobytes(),
              rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()]
    return (blocks + [b"z" * n for n in (15, 300, 65536)]
            + lz4.edge_rows())


def lz4_design(blocks) -> None:
    """What the kernel's design depends on: CTAs per SM at 64 KB rows
    (two, so a second row hides a chain's stalls), registers and spills
    from ptxas, and how many sequences the main path's blocks parse
    into (the chain's links), from the native encoder's output."""
    k = lz4.ctas_per_sm(LZ4F_BLOCKSIZE)
    print(f"phase 5: lz4_rows CTAs per SM at N = {LZ4F_BLOCKSIZE}: {k}")
    check(k >= 2, f"lz4_rows fits {k} CTA(s) an SM at 64 KB rows, not 2")
    props = [ln.strip() for ln in lz4.build_log.splitlines()
             if "spill" in ln or "registers" in ln]
    for ln in props:
        print(f"  ptxas lz4_rows: {ln}")
    if not props:
        print("  ptxas lz4_rows: no report (the build was up to date)")
    check(all(" 0 bytes spill stores" in ln for ln in props if "spill" in ln),
          "ptxas reports spills for lz4_rows")
    seqs = sorted(len(lz4.parse_sequences(native.lz4_block_compress(b)))
                  for b in blocks)
    print(f"  sequences per main-path block (native encoder, "
          f"{len(seqs)} blocks): min {seqs[0]}, median "
          f"{statistics.median(seqs)}, max {seqs[-1]}, total {sum(seqs)}")


def lz4_kernel_check(rng, blocks_main) -> tuple[int, dict]:
    """(a): kernel == plain version == native, every mode, sweep and main
    path; returns the max abs error (0 when they agree) and the inputs of
    the main path's shape on the card."""
    max_err = 0
    for name, blocks in (("sweep", lz4_sweep(rng)),
                         ("main path", blocks_main)):
        data, lens = pad_right(blocks, LZ4F_BLOCKSIZE)
        d = torch.from_numpy(data).cuda()
        ln = torch.from_numpy(lens).cuda()
        want = [native.lz4_block_compress(b) for b in blocks]
        for mode in lz4.MODES:
            got = lz4.lz4_rows(d, ln, mode)
            ref = lz4.lz4_rows_reference(d, ln, mode)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                check((g is None) == (r is None), f"lz4 {mode}: outputs")
                if g is not None:
                    err = int((g.to(torch.int64) - r.to(torch.int64))
                              .abs().max())
                    max_err = max(max_err, err)
            check(max_err == 0, f"lz4 kernel != plain version at {name} "
                  f"with_crc={mode}")
            comp, olen = got[0].cpu().numpy(), got[1].cpu().numpy()
            check([comp[i, :olen[i]].tobytes() for i in range(len(blocks))]
                  == want, f"lz4 kernel != native encoder at {name} {mode}")
            if mode == "both":
                check(got[2].cpu().tolist()
                      == [native.crc32c(w) for w in want],
                      f"crc_comp != native crc32c at {name}")
            if mode != "none":
                check(got[3].cpu().tolist()
                      == [native.crc32c(b) for b in blocks],
                      f"crc_raw != native crc32c at {name}")
        print(f"phase 5a: lz4_rows == plain == native deterministic "
              f"encoder, CRCs == native crc32c, modes none/both/raw: "
              f"{name} ({len(blocks)} blocks, {int(lens.sum())} B)")
    return max_err, {"d": d, "ln": ln, "lens": lens}


def pipelined_with(prov, parts, rounds: int, qos=None) -> list:
    """:func:`pipelined` with per-partition qos pairs."""
    wires = []
    pend = submit_batches(prov, parts, "lz4", NOW_MS, qos=qos)
    for k in range(rounds):
        pend.done()
        nxt = (submit_batches(prov, parts, "lz4", NOW_MS, qos=qos)
               if k + 1 < rounds else None)
        wires.append(pend.result(300))
        pend = nxt
    return wires


def no_cpu_compress(eng, what: str) -> None:
    bad = {k: eng.compress_stats[k] for k in (
        "cpu_jobs", "warmup_miss_jobs", "routed_cpu_jobs", "shed_jobs")
        if eng.compress_stats[k]}
    check(not bad, f"{what}: compress jobs served on the CPU: {bad}")


def lz4_split(bufs) -> dict:
    """Host-clock ms (median of 10, each step ending in a device sync) of
    the compress route's steps for one round's buffers, taken one by one
    as the engine takes them on a lane of its own."""
    lane = crc.LaneBuffers(torch.device("cuda", 0))
    rb = torch.cuda.Stream()
    lens = np.array([len(b) for b in bufs], np.int64)
    plan = lz4.plan_lz4(lens)
    slot = crc.Slot(crc.slot_bucket(plan.nbytes), pin=True)
    lz4.fill_lz4(slot, plan, bufs)
    handle = lz4.launch_lz4(slot, plan, lane)
    res = lz4.read_lz4(slot, plan, handle, rb)
    packed, offs, olen = res[0], res[1], res[2]
    check([packed[o:o + n].tobytes() for o, n in zip(offs, olen)]
          == [native.lz4_block_compress(bufs[k][i * LZ4F_BLOCKSIZE:
                                                (i + 1) * LZ4F_BLOCKSIZE])
              for k, (_, nb) in enumerate(plan.spans) for i in range(nb)],
          "engine staging split != native")

    def frames():
        mv = memoryview(packed)
        for k, (first, nb) in enumerate(plan.spans):
            raw = memoryview(bufs[k])
            lz4_frame_of(mv, raw, first, nb, offs, olen, res[3], res[4])

    def h2d():
        with torch.cuda.stream(lane.stream):
            lane.flat[:plan.nbytes].copy_(slot.host[:plan.nbytes],
                                          non_blocking=True)
        lane.stream.synchronize()

    def launch():
        h = lz4.launch_lz4(slot, plan, lane)
        lane.stream.synchronize()
        return h

    def readback() -> float:
        times = []
        for _ in range(10):
            h = launch()
            t0 = time.perf_counter()
            lz4.read_lz4(slot, plan, h, rb)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return {
        "plan + pinned fill": host_ms(
            lambda: lz4.fill_lz4(slot, lz4.plan_lz4(lens), bufs), 10),
        "H2D alone (pinned, lane stream)": host_ms(h2d, 10),
        "H2D + kernel + metadata D2H": host_ms(launch, 10),
        "readback (event, the cursor's bytes D2H)": readback(),
        "frame assembly (lz4f_frame)": host_ms(frames, 10),
    }


def lz4_frame_of(mv, raw, first, nb, offs, olen, cc, cr):
    return lz4f_frame([(mv[int(offs[first + k]):int(offs[first + k])
                           + int(olen[first + k])].tobytes(),
                        int(cc[first + k]),
                        raw[k * LZ4F_BLOCKSIZE:(k + 1) * LZ4F_BLOCKSIZE],
                        int(cr[first + k])) for k in range(nb)])


def phase_lz4(cpu_p, work: dict, rng) -> dict:
    parts = work["parts"]
    nmsgs = PARTITIONS * RECORDS
    bufs = [MsgsetWriterV2(codec="lz4").build(recs, NOW_MS).records_bytes
            for recs in parts]
    blocks = [b[i:i + LZ4F_BLOCKSIZE] for b in bufs
              for i in range(0, len(b), LZ4F_BLOCKSIZE)]
    print(f"phase 5: main path {PARTITIONS} partitions x {RECORDS} x "
          f"{VALUE_SIZE} B lz4: {len(blocks)} blocks of <= 64 KB, "
          f"{sum(len(b) for b in bufs)} B per round")
    lz4_design(blocks)
    max_err, main = lz4_kernel_check(rng, blocks)
    counted = {}
    det = DetProvider()
    wire_det = write_batches(det, parts, "lz4", NOW_MS)

    # (b) the synchronous E route
    sync = GpuCodecProvider(min_batches=1, pipeline_depth=0, lz4_force=True,
                            min_transport_mb_s=0, warmup=False)
    lz4.launches = 0
    got = sync.compress_many("lz4", bufs)
    torch.cuda.synchronize()
    counted["sync route"] = lz4.launches
    check(got == det_frames(bufs), "lz4_force compress_many != native "
          "deterministic frames")
    check(lz4.launches == 1, f"lz4_force compress_many took {lz4.launches} "
          f"launches, not 1")
    print(f"phase 5b: GpuCodecProvider(lz4_force=True, pipeline_depth=0)"
          f".compress_many of {len(bufs)} buffers == native deterministic "
          f"frames, 1 launch")

    # (c) pipelined produce rounds on the device compress route: counted
    prov = GpuCodecProvider(min_batches=1, governor=False,
                            compress_device=True)
    check(prov.wait_warm(300), "the compress route did not warm")
    eng = prov._get_engine()
    pipelined_with(prov, parts, 1)            # pinned rings, first round
    lz4.launches = crc.launches = 0
    lz4.h2d_bytes = lz4.d2h_bytes = 0
    wires = pipelined_with(prov, parts, ROUNDS)
    torch.cuda.synchronize()
    counted["pipelined produce"] = lz4.launches
    l_lz4, l_crc = lz4.launches, crc.launches
    h2d, d2h = lz4.h2d_bytes, lz4.d2h_bytes
    check(all(w == wire_det for w in wires),
          "device compress route wire != the deterministic writer's")
    check(l_lz4 == ROUNDS, f"{ROUNDS} rounds took {l_lz4} LZ4 launches")
    check(l_crc == 0, f"the batch CRCs took {l_crc} CRC launches, not 0")
    no_cpu_compress(eng, "(c) pipelined produce")
    recs = submit_read(prov, wires[0]).result(300)
    check([[r.value for r in p] for p in recs]
          == [[r.value for r in p] for p in parts],
          "records read back from the device route's wire differ")
    plan = lz4.plan_lz4([len(b) for b in bufs])
    C = plan.B * (LZ4F_BLOCKSIZE + LZ4F_BLOCKSIZE // 255 + 16)
    print(f"phase 5c: {ROUNDS} pipelined rounds on the device compress "
          f"route: wire == deterministic writer, records read back, "
          f"{l_lz4} LZ4 launches, {l_crc} CRC launches; per round h2d "
          f"{h2d // ROUNDS} B (blocks {plan.flat_bytes} + metadata "
          f"{plan.nbytes - plan.flat_bytes}), d2h {d2h // ROUNDS} B "
          f"(padded rows would read back {C})")

    # (d) two topics of unequal weight under saturation (depth 1: the
    # launch in flight saturates the lane)
    qeng = AsyncOffloadEngine(depth=1, min_batches=1, governor=True,
                              warmup=False, cpu_fallback=fallback(cpu_p),
                              cpu_compress_fallback=det_frames)
    try:
        bulk, lat = bufs[:48], bufs[48:]
        first = qeng.submit_compress(bulk, qos=[("bulk", 0.25)] * 48)
        gate = threading.Event()
        qeng.submit_compute(gate.wait, 60, host=True)
        wait_for(lambda: qeng.compress_stats["launches"] == 1, "(d) launch")
        t_b = qeng.submit_compress(bulk, qos=[("bulk", 0.25)] * 48)
        t_l = qeng.submit_compress(lat, qos=[("lat", 8.0)] * 16)
        gate.set()
        check([bytes(f) for f in first.result(300)] == det_frames(bulk)
              and [bytes(f) for f in t_b.result(300)] == det_frames(bulk)
              and [bytes(f) for f in t_l.result(300)] == det_frames(lat),
              "(d) QoS leg frames != native deterministic")
        snap = qeng.compress_snapshot()
        check(snap["shed_jobs"] == 1 and snap["qos"]["lat"]["shed"] == 0,
              f"(d) the flood topic was not shed alone: {snap}")
        print(f"phase 5d: qos bulk 0.25 vs lat 8.0, saturated: shed_jobs "
              f"{snap['shed_jobs']}, launches {snap['launches']}, "
              f"routed_cpu_jobs {snap['routed_cpu_jobs']}; qos "
              f"{snap['qos']}; frames exact")
    finally:
        qeng.close()
    check(prov.wait_warm(300), "the compress route did not warm again")

    # (f) numbers, all in this call.  The kernel in every mode at the main
    # path's blocks: "none" is E (the lz4_force route), "both" F (the
    # engine's route, the kernels line's entry), "raw" I (the codec step)
    d, ln, lens = main["d"], main["ln"], main["lens"]
    olen = lz4.lz4_rows(d, ln)[1].cpu().numpy()
    timing = {}
    for mode in lz4.MODES:
        staged = lambda: lz4.lz4_rows(d, ln, mode)       # noqa: E731
        ms = kernel_ms(staged, 10)
        b2b = b2b_ms(staged, 10)
        plain = kernel_ms(lambda: lz4.lz4_rows_reference(d, ln, mode), 2)
        bms, by = lz4_bound(lens, olen, mode)
        timing[mode] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                        "bound_by": by}
        print(f"  lz4_rows at the main path's {len(lens)} blocks, with_crc="
              f"{mode}: kernel {ms:.4f} ms (L2 flushed), {b2b:.4f} ms back "
              f"to back; bound {bms:.5f} ms ({by}); plain version "
              f"{plain:.3f} ms")
    clk = lz4.stage_clocks(d, ln, "both")
    tot = sum(clk[k] for k in lz4.STAGES)
    print(f"  lz4_rows stage clocks (diagnostic build, \"both\", SM cycles "
          f"a row, share): " + "; ".join(
              f"{k} {v / len(lens):.0f} ({v / tot:.3f})"
              for k, v in clk.items()))
    print("  compress route of one round, host clock ms: " + "; ".join(
        f"{k} {v:.4f}" for k, v in lz4_split(bufs).items()))
    t_prod = {"device compress": 0.0, "cpu deterministic": 0.0,
              "cpu default": 0.0}
    for _ in range(2):                       # a warm turn, then timed turns
        for name, fn in (
                ("device compress", lambda: pipelined_with(prov, parts,
                                                           ROUNDS)),
                ("cpu deterministic", lambda: [write_batches(
                    det, parts, "lz4", NOW_MS) for _ in range(ROUNDS)]),
                ("cpu default", lambda: [write_batches(
                    cpu_p, parts, "lz4", NOW_MS) for _ in range(ROUNDS)])):
            t0 = time.perf_counter()
            fn()
            t_prod[name] = time.perf_counter() - t0
    print("  produce msgs/s (" + f"{ROUNDS} rounds): " + "; ".join(
        f"{k} {ROUNDS * nmsgs / v:.0f}" for k, v in t_prod.items()))
    busy = device_busy_share(lambda: pipelined_with(prov, parts, ROUNDS))
    print("  device busy share of pipelined device-compress rounds: "
          + ("not measured (profiler saw no device time)" if busy is None
             else f"{busy:.6f}"))
    no_cpu_compress(eng, "(f) timed legs")

    # (g) one pass of the batched codec step (I) through the engine
    full = [b for b in blocks if len(b) == LZ4F_BLOCKSIZE][:64]
    sdata = np.frombuffer(b"".join(full), np.uint8).reshape(
        64, LZ4F_BLOCKSIZE)
    slens = np.full((64,), LZ4F_BLOCKSIZE, np.int32)
    submit = codec_step.pipelined_codec_step(eng, LZ4F_BLOCKSIZE, 64)
    lz4.launches = 0
    out, olen_s, crcs = submit(sdata, slens).result(300)
    counted["codec step"] = lz4.launches
    check(lz4.launches == 1, f"the codec step took {lz4.launches} launches")
    check([out[i, :olen_s[i]].tobytes() for i in range(64)]
          == [native.lz4_block_compress(r.tobytes()) for r in sdata]
          and crcs.tolist() == [native.crc32c(r.tobytes()) for r in sdata],
          "the codec step's rows or CRCs != native")
    print("phase 5g: pipelined_codec_step (64 x 64 KB, with_crc=raw) "
          "through the engine: 1 launch, rows and CRCs == native")
    prov.close()
    check(lz4.device_kernel_count() == 0, "a warm compress kernel outlived "
          "its engine")

    # (e) close() with compress tickets in flight
    closing = AsyncOffloadEngine(depth=2, min_batches=1, governor=False,
                                 cpu_fallback=fallback(cpu_p),
                                 cpu_compress_fallback=det_frames)
    tickets = [closing.submit_compress(bufs[:16], window=False)
               for _ in range(6)]
    closing.close()
    want = det_frames(bufs[:16])
    check(all(t.done() and [bytes(f) for f in t.result(0)] == want
              for t in tickets), "close() left a compress ticket "
          "unresolved or wrong")
    check(closing.compress_stats["launches"] >= 1,
          "(e) no compress launch before close")
    check(lz4.device_kernel_count() == 0, "close() kept a warm kernel")
    print("phase 5e: close() with 6 compress tickets in flight resolved "
          "all, exact")
    print("phase 5: ok (kernel == plain == native, sync route, pipelined "
          "wire == deterministic writer with no CRC launch, QoS shed, "
          "close, codec step)")
    return {"launches": sum(counted.values()), "counted": counted,
            "max_err": max_err, **timing["both"], "blocks": blocks,
            "timing": timing}


# ---------------------------------------------------------------- phase 6 --

P6_PARTS, P6_PER_PART, P6_REPEATS = PARTITIONS, 4800, 3
#: the GPU legs' codec keys: every CRC group on the card, route warm first
P6_GPU = {"gpu.governor": False, "gpu.launch.min.batches": 1}


def p6_conf(backend: str, device: str, parts: int, extra=None) -> dict:
    """Producer conf of a phase 6 leg: one in-process mock broker with
    ``parts`` partitions a topic, idempotent, lz4, linger 5 ms, the
    default batch.num.messages and message.max.bytes (about 960 records,
    1 MB framed, a batch).  The producer queue holds one repeat whole."""
    conf = {"bootstrap.servers": "", "test.mock.num.brokers": 1,
            "test.mock.default.partitions": parts,
            "enable.idempotence": True, "compression.codec": "lz4",
            "linger.ms": 5, "queue.buffering.max.messages": 1_000_000,
            "compression.backend": backend}
    if backend == "gpu":
        conf.update({"gpu.device": device, **P6_GPU, **(extra or {})})
    return conf


def p6_produce(p, topic: str, keys, vals) -> float:
    """Every record of ``vals[partition][j]``, keyed by partition, with
    explicit partitions, then flush(); msgs/s over produce() + flush()."""
    produce = p.produce
    n = sum(len(v) for v in vals)
    t0 = time.perf_counter()
    for j in range(len(vals[0])):
        for i, k in enumerate(keys):
            produce(topic, value=vals[i][j], key=k, partition=i)
    left = p.flush(300)
    dt = time.perf_counter() - t0
    check(left == 0, f"phase 6 {topic}: flush() left {left} messages")
    return n / dt


def p6_check_stored(cluster, topic: str, keys, vals, det: bool) -> int:
    """Every stored blob is a v2 lz4 batch whose CRC == the native crc32c
    of its CRC region and whose frame == the native encoder's frame of
    its records (the deterministic one for the device compress route);
    the records are what was produced, in order; the idempotence fields
    are one producer id and epoch, and base sequences that run on from
    the records before them.  Returns the batch count."""
    from librdkafka_tpu_torch.protocol.msgset import (iter_batches,
                                                      parse_records_v2)
    pids, nbatch = set(), 0
    for i, k in enumerate(keys):
        infos, frames, regions = [], [], []
        for _base, blob in cluster.partition(topic, i).log:
            for info, payload, full in iter_batches(blob):
                check(info.magic == 2 and info.codec == "lz4",
                      f"{topic}[{i}]: a batch is magic {info.magic} "
                      f"codec {info.codec}")
                infos.append(info)
                frames.append(bytes(payload))
                regions.append(bytes(full[V2_OF_Attributes:]))
        check(native.crc32c_many(regions).tolist()
              == [x.crc for x in infos], f"{topic}[{i}]: a batch CRC != "
              "the native crc32c of its region")
        raws = native.lz4f_decompress_many(frames, None)
        enc = (det_frames(raws) if det
               else native.lz4f_compress_many(raws))
        check(enc == frames, f"{topic}[{i}]: an lz4 frame != the native "
              f"{'deterministic' if det else 'default'} encoder's")
        seq, got = 0, []
        for info, raw in zip(infos, raws):
            check(info.base_sequence == seq,
                  f"{topic}[{i}]: base sequence {info.base_sequence} "
                  f"after {seq} records")
            seq += info.record_count
            pids.add((info.producer_id, info.producer_epoch))
            got.extend((r.key, r.value) for r in parse_records_v2(info, raw))
        check(got == [(k, v) for v in vals[i]],
              f"{topic}[{i}]: stored records != produced")
        nbatch += len(infos)
    check(len(pids) == 1 and next(iter(pids))[0] >= 0,
          f"{topic}: producer id/epoch not one idempotent pair: {pids}")
    return nbatch


def p6_consume(c, topic: str, keys, vals) -> float:
    """Assign every partition of ``topic`` from the beginning and read
    it all back through the CRC-checking consumer; each partition's
    (key, value, offset) sequence must be the produced one.  msgs/s from
    assign() to the last record."""
    from librdkafka_tpu_torch.client.consumer import TopicPartition
    from librdkafka_tpu_torch.protocol.proto import OFFSET_BEGINNING
    n = sum(len(v) for v in vals)
    nxt = [0] * len(keys)
    got = 0
    t0 = time.perf_counter()
    c.assign([TopicPartition(topic, i, OFFSET_BEGINNING)
              for i in range(len(keys))])
    deadline = time.monotonic() + 300
    while got < n:
        check(time.monotonic() < deadline,
              f"phase 6 {topic}: consumed {got} of {n}")
        for m in c.consume(min(10_000, n - got), 0.5):
            check(m.error is None, f"phase 6 {topic}: {m.error}")
            i, j = m.partition, nxt[m.partition]
            check(j < len(vals[i]) and m.offset == j and m.key == keys[i]
                  and m.value == vals[i][j],
                  f"phase 6 {topic}[{i}]: record {j} out of order or "
                  f"wrong (offset {m.offset})")
            nxt[i] = j + 1
            got += 1
    return n / (time.perf_counter() - t0)


def p6_corrupt(p, c, prov, errs: list, tag: str) -> None:
    """A stored batch with one byte flipped: the port's reader through
    the consumer's GPU provider raises CrcMismatch, and the consumer's
    ticketed fetch verify reports _BAD_MSG and delivers nothing."""
    from librdkafka_tpu_torch.client.consumer import TopicPartition
    from librdkafka_tpu_torch.client.errors import Err
    from librdkafka_tpu_torch.protocol.proto import OFFSET_BEGINNING
    topic = f"p6-bad-{tag}"
    for i in range(10):
        p.produce(topic, value=b"corrupt-%02d " % i * 40, partition=0)
    check(p.flush(60) == 0, f"{topic}: flush() did not drain")
    part = p._rk.mock_cluster.partition(topic, 0)
    base, blob = part.log[0]
    bad = bytearray(blob)
    bad[-5] ^= 0xFF
    try:
        submit_read(prov, [bytes(bad)]).result(120)
        fail(f"{topic}: a flipped byte passed the GPU reader")
    except CrcMismatch:
        pass
    part.log[0] = (base, bytes(bad))
    c.assign([TopicPartition(topic, 0, OFFSET_BEGINNING)])
    deadline = time.monotonic() + 30
    while not errs and time.monotonic() < deadline:
        m = c.poll(0.2)
        check(m is None or m.error is not None,
              f"{topic}: the corrupted batch was delivered")
    check(any(e.code == Err._BAD_MSG for e in errs),
          f"{topic}: the consumer reported {errs}, not _BAD_MSG")


def p6_rates(xs) -> str:
    med = statistics.median(xs)
    return (f"median {med:.1f} msgs/s, spread {min(xs):.1f}-{max(xs):.1f} "
            f"({(max(xs) - min(xs)) / med:.3f} of the median)")


def p6_leg(tag: str, backend: str, device: str, extra, det: bool,
           keys, vals, repeats: int) -> dict:
    """One leg: a Producer on the mock, a GPU Consumer with check.crcs,
    ``repeats`` topics of every record each.  Counts are zeroed after
    both clients' routes are warm and read after the last consume."""
    from librdkafka_tpu_torch import Consumer, Producer
    parts = len(keys)
    p = Producer(p6_conf(backend, device, parts, extra))
    c = None
    try:
        pprov = p._rk.codec_provider
        if backend == "gpu":
            check(pprov.wait_warm(300), f"6{tag}: producer route not warm")
        errs: list = []
        c = Consumer({"bootstrap.servers":
                      p._rk.mock_cluster.bootstrap_servers(),
                      "group.id": f"p6-{tag}",
                      "auto.offset.reset": "earliest", "check.crcs": True,
                      "compression.backend": "gpu", "gpu.device": device,
                      **P6_GPU, "error_cb": errs.append})
        cprov = c._rk.codec_provider
        check(cprov.wait_warm(300), f"6{tag}: consumer route not warm")
        peng = getattr(pprov, "_engine", None)
        p_launch0 = peng.stats["launches"] if peng is not None else 0
        crc.launches = 0
        lz4.launches = 0
        topics = [f"p6{tag}-r{r}" for r in range(repeats)]
        prod = [p6_produce(p, t, keys, vals) for t in topics]
        crc_produce, lz4_produce = crc.launches, lz4.launches
        cons = [p6_consume(c, t, keys, vals) for t in topics]
        counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        pstats = json.loads(p._rk.stats.emit_json()).get("codec_engine")
        cstats = json.loads(c._rk.stats.emit_json())["codec_engine"]
        nbatch = sum(p6_check_stored(p._rk.mock_cluster, t, keys, vals, det)
                     for t in topics)
        check(cstats["launches"] > 0, f"6{tag}: consumer made no CRC launch")
        no_cpu_route(cprov._engine, f"6{tag} consumer")
        if backend == "gpu":
            check(pstats is not None, f"6{tag}: no codec_engine in stats")
            no_cpu_route(peng, f"6{tag} producer")
            if pprov.compress_device:
                comp = pstats["compress"]
                check(comp["launches"] > 0 and comp["fused_crc"] > 0,
                      f"6{tag}: compress route idle: {comp}")
                no_cpu_compress(peng, f"6{tag} producer")
                check(crc_produce == 0 and
                      peng.stats["launches"] == p_launch0,
                      f"6{tag}: {crc_produce} CRC launches for producer "
                      "batches (the frames carry their CRCs)")
                check(lz4_produce > 0, f"6{tag}: no LZ4 launch")
            else:
                check(pstats["launches"] > 0 and crc_produce > 0,
                      f"6{tag}: producer made no CRC launch")
                check(lz4_produce == 0, f"6{tag}: an LZ4 launch on the "
                      "CRC-ticket route")
        p6_corrupt(p, c, cprov, errs, tag)
        n = parts * len(vals[0])
        print(f"phase 6{tag}: {backend}"
              f"{' + gpu.compress.device' if extra else ''}: {repeats} x "
              f"{n} records x {len(vals[0][0])} B over {parts} idempotent "
              f"partitions, {nbatch} batches exact (CRC, "
              f"{'deterministic' if det else 'default'} lz4 frames, "
              f"records, sequences), read back by a check.crcs GPU "
              f"consumer; corrupted batch -> CrcMismatch and _BAD_MSG")
        print(f"  produce {p6_rates(prod)}; consume {p6_rates(cons)}")
        print(f"  launches: crc_rows {counts['crc_rows']} (producer "
              f"{crc_produce}), lz4_rows {counts['lz4_rows']}; producer "
              f"engine {pstats and {k: pstats[k] for k in ('launches', 'jobs', 'host_jobs')}}"
              f"{pstats and ', compress ' + str({k: pstats['compress'][k] for k in ('launches', 'fused_crc')})}; "
              f"consumer engine "
              f"{ {k: cstats[k] for k in ('launches', 'jobs', 'host_jobs')} }")
        return {"counts": counts, "produce": prod, "consume": cons}
    finally:
        if c is not None:
            c.close()
        p.close()


def phase_client(device: str = "cuda", parts: int = P6_PARTS,
                 per_part: int = P6_PER_PART,
                 repeats: int = P6_REPEATS) -> dict:
    """Phase 6: Producer -> mock broker -> Consumer(check.crcs) through
    the port's entry points, three legs (6a the CPU provider, 6b the
    CRC-ticket route, 6c the device compress route).  Returns the
    kernels' launches summed over the GPU legs."""
    flat = payloads(parts * per_part, VALUE_SIZE)
    vals = [flat[i * per_part:(i + 1) * per_part] for i in range(parts)]
    keys = [b"p%02d" % i for i in range(parts)]
    print(f"phase 6: Producer -> mock -> Consumer(check.crcs), "
          f"{parts} x {per_part} x {VALUE_SIZE} B lz4 = "
          f"{parts * per_part} records a repeat, {repeats} repeats a leg")
    t0 = time.perf_counter()
    legs = [p6_leg("a", "cpu", device, None, False, keys, vals, repeats),
            p6_leg("b", "gpu", device, None, False, keys, vals, repeats),
            p6_leg("c", "gpu", device, {"gpu.compress.device": True}, True,
                   keys, vals, repeats)]
    print(f"phase 6: ok ({time.perf_counter() - t0:.1f} s, checks and "
          f"warm starts included)")
    # 6a's consumer is on the card too: every leg's launches count
    return {**{k: sum(leg["counts"][k] for leg in legs)
               for k in ("crc_rows", "lz4_rows")}, "legs": legs}


# ---------------------------------------------------------------- phase 7 --

P7_ROWS, P7_SUBS = 64, 6        # bench.py:1005-1031's mesh workload
P7_PER_PART, P7_REPEATS = 1600, 3


def p7_pool() -> list:
    """The mesh pool: the visible cards when there are two or more, else
    card 0 four times (the shards of a launch then run one after another
    on it: serialized_launch chains every launch of one card)."""
    n = torch.cuda.device_count()
    return ([f"cuda:{i}" for i in range(n)] if n >= 2
            else ["cuda:0"] * 4)


def p7_crcs(bufs, poly: str) -> list[int]:
    return [native.crc32c(b) if poly == "crc32c"
            else zlib.crc32(b) & 0xFFFFFFFF for b in bufs]


class ShardRecorder:
    """While ``on``, copies the staged inputs of every shard the engine
    launches (its pinned slot's bytes and its plan), so the plain version
    can be run on exactly what the kernel read."""

    def __init__(self):
        self.on = False
        self.shards: list = []
        self._orig = mesh._CrcStep.launch_slot
        rec = self

        def launch_slot(step, slot, plan, bufs):
            if rec.on:
                rec.shards.append((slot.host[:plan.nbytes].clone(), plan))
            return rec._orig(step, slot, plan, bufs)

        mesh._CrcStep.launch_slot = launch_slot

    def plain(self) -> list[int]:
        """crc_segments_reference on the card over every recorded shard's
        staged bytes, in launch order."""
        out = []
        for host, plan in self.shards:
            flat = host[:plan.flat_bytes].cuda()
            out += crc.crc_segments_reference(
                flat, torch.from_numpy(plan.offsets),
                torch.from_numpy(plan.lengths),
                torch.from_numpy(plan.sel)).cpu().tolist()
        return out

    def close(self) -> None:
        mesh._CrcStep.launch_slot = self._orig


def p7_engine(pool: list, k: int, rec: ShardRecorder) -> dict:
    """7a at ``k`` lanes: warm, then (counted) bench.py's mesh workload
    pipelined, test_0018's 16 x 64 KB + tail with its shards' staged
    inputs recorded, and a crc32c + crc32 group of 8k + 8 blocks that
    the fan-in merges into one fused launch (min_batches is the pair's
    buffer count, so neither job launches alone).  The governor is on,
    for the fused group, with no CPU fallback: no group can leave the
    card."""
    rng = np.random.default_rng(6)
    bench_rows = [rng.integers(0, 256, LZ4F_BLOCKSIZE, dtype=np.uint8)
                  .tobytes() for _ in range(P7_ROWS)]
    t18 = [rng.integers(0, 256, LZ4F_BLOCKSIZE, dtype=np.uint8).tobytes()
           for _ in range(16)] + [b"tail-block" * 7]
    mixed_c = bench_rows[:8 * k]
    mixed_l = [b"legacy-%d " % i * 400 for i in range(8)]
    want_bench = p7_crcs(bench_rows, "crc32c")
    eng = AsyncOffloadEngine(depth=2, fanin_window_s=0.5,
                             min_batches=len(mixed_c) + len(mixed_l),
                             governor=True, devices=pool, mesh_devices=k,
                             cpu_fallback=None)
    def bench_leg() -> float:
        """bench.py's leg: P7_SUBS submissions in flight at once (the
        dispatch thread merges the ones queued together), then every
        result; seconds."""
        t0 = time.perf_counter()
        tickets = [eng.submit(bench_rows, "crc32c", window=False)
                   for _ in range(P7_SUBS)]
        for t in tickets:
            check(t.result(300).tolist() == want_bench,
                  f"7a k={k}: bench workload != native crc32c")
        return time.perf_counter() - t0

    try:
        # warm, not counted: every lane's kernel, the sharded steps, and
        # the staging slots and device buffers of a merged leg's sizes
        for bufs in (t18, mixed_c):
            check(eng.submit(bufs, "crc32c", window=False).result(300)
                  .tolist() == p7_crcs(bufs, "crc32c"), f"7a k={k}: warm")
        bench_leg()
        s0 = dict(eng.stats)
        lanes0 = {r["id"]: (r["launches"], r["blocks"])
                  for r in eng.devices_snapshot()}
        crc.launches = 0
        mesh.crc_launches = 0
        eng.stage_latency_snapshot()             # drop the windows so far
        legs = [bench_leg() for _ in range(3)]
        lat = eng.stage_latency_snapshot()
        dt = statistics.median(legs)
        rec.shards.clear()
        rec.on = True
        got18 = eng.submit(t18, "crc32c", window=False).result(300).tolist()
        rec.on = False
        check(got18 == p7_crcs(t18, "crc32c"), f"7a k={k}: test_0018's "
              "group != native crc32c")
        tc = eng.submit(mixed_c, "crc32c", window=True)
        tl = eng.submit(mixed_l, "crc32", window=True)
        check(tc.result(300).tolist() == p7_crcs(mixed_c, "crc32c")
              and tl.result(300).tolist() == p7_crcs(mixed_l, "crc32"),
              f"7a k={k}: the mixed group != native crc32c / crc32")
        counts = {"crc_rows": crc.launches, "G": mesh.crc_launches}
        d = {key: eng.stats[key] - s0[key] for key in (
            "launches", "sharded_launches", "fused_launches", "blocks")}
        check(d["fused_launches"] >= 1, f"7a k={k}: the crc32c + crc32 "
              f"pair did not fuse: {d}")
        rows = eng.devices_snapshot()
        nlanes = len(rows)
        if nlanes > 1:
            check(d["sharded_launches"] >= 1, f"7a k={k}: no sharded "
                  f"launch: {d}")
            check(all(r["launches"] > lanes0[r["id"]][0] for r in rows),
                  f"7a k={k}: a lane did not record the sharded launch")
            # (a CPU pool, the rehearsal's, runs the plain version)
            check(counts["G"] >= nlanes or pool[0].startswith("cpu"),
                  f"7a k={k}: {counts['G']} shard launches")
        # test_0018's 17 blocks shard at k = 2 (8 a lane), not at k = 4
        check(bool(rec.shards) == (nlanes == 2), f"7a k={k}: "
              f"{len(rec.shards)} shards of test_0018's group recorded")
        check(not rec.shards or rec.plain() == got18, f"7a k={k}: the "
              "staged shards through crc_segments_reference != the "
              "engine's CRCs")
        check(eng._inflight_total() == 0, f"7a k={k}: launches left in "
              "flight")
        split = "; ".join(f"lane {r['id']} {r['launches'] - lanes0[r['id']][0]}"
                          f"/{r['blocks'] - lanes0[r['id']][1]}" for r in rows)
        mb = P7_SUBS * P7_ROWS * LZ4F_BLOCKSIZE / 1e6
        rate = mb / dt
        print(f"phase 7a: k={k}: {nlanes} lane(s); {P7_SUBS} x {P7_ROWS} x "
              f"64 KB in flight, median of 3 legs {rate:.1f} MB/s (legs "
              + ", ".join(f"{mb / x:.1f}" for x in legs)
              + f"); counted launches "
              f"{d['launches']} (sharded {d['sharded_launches']}, fused "
              f"{d['fused_launches']}), {counts['G']} shard launches; "
              f"launches/blocks a lane: {split}"
              + (f"; {len(rec.shards)} staged shards == plain version"
                 if rec.shards else ""))
        print("  stage_latency over the 3 legs (us, avg/p50/p99): "
              + "; ".join(f"{key} {lat[key]['avg']}/{lat[key]['p50']}/"
                          f"{lat[key]['p99']}" for key in
                          ("submit_wait", "launch", "reap")))
    finally:
        eng.close()
    check(mesh.step_cache_count() == 0, f"7a k={k}: close() left "
          f"{mesh.step_cache_count()} sharded steps")
    return {"rate": rate, "counts": counts}


def p7_codec_check(m, blocks) -> dict:
    """7b on ``blocks``: shard_compress == native encoder, crc32c and
    summed lengths, and == the per-shard plain version."""
    lz4.launches = 0
    mesh.codec_launches = 0
    outs, crcs, total = mesh.shard_compress(m, blocks)
    counts = {"lz4_rows": lz4.launches, "H": mesh.codec_launches}
    check(counts["H"] == m.size or m.devices[0].type == "cpu",
          f"7b: {counts['H']} shard launches for {m.size} shards")
    check(outs == [native.lz4_block_compress(b) for b in blocks],
          f"7b: {len(blocks)} blocks != the native block encoder")
    check(crcs.tolist() == [native.crc32c(b) for b in blocks],
          f"7b: {len(blocks)} blocks' CRCs != native crc32c")
    check(total == sum(len(o) for o in outs), "7b: total != the summed "
          "lengths")
    B = len(blocks)
    Bp = -(-B // m.size) * m.size
    data, lens = pad_right(blocks + [b""] * (Bp - B), LZ4F_BLOCKSIZE)
    valid = np.array([1] * B + [0] * (Bp - B), np.int32)
    comp, olen, pcrc, ptotal = mesh.sharded_codec_reference(
        m, data, lens, valid, True)
    klen = np.array([len(o) for o in outs], np.int64)
    err = max(int(np.abs(klen - olen[:B]).max()),
              int(np.abs(crcs.astype(np.int64)
                         - pcrc[:B].astype(np.int64)).max()),
              abs(total - ptotal))
    check(err == 0 and [comp[i, :olen[i]].tobytes() for i in range(B)]
          == outs, f"7b: {B} blocks: kernel != the per-shard plain version")
    print(f"phase 7b: shard_compress of {B} blocks over {m.size} shards == "
          f"native encoder, crc32c and summed lengths ({total} B) == "
          f"per-shard plain version; {counts['H']} lz4_rows launches")
    return {"counts": counts, "data": data, "lens": lens, "valid": valid,
            "olen": olen, "err": err}


def p7_standalone(p6b: dict, device: str = "cuda") -> dict:
    """7d: phase 6 leg b's Producer (CRC tickets, governor off, quorum 1,
    warm) plus gpu.mesh.devices=0, against the mock in its own process;
    every record read back in order through a check.crcs consumer."""
    from librdkafka_tpu_torch import Consumer, Producer
    proc = subprocess.Popen(
        [sys.executable, "-m", "librdkafka_tpu_torch.mock.standalone",
         "--partitions", str(P6_PARTS)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    p = c = None
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        bootstrap = proc.stdout.readline().strip() if ready else ""
        check(bool(bootstrap), "7d: the standalone mock did not start")
        conf = p6_conf("gpu", device, P6_PARTS, {"gpu.mesh.devices": 0})
        for key in ("test.mock.num.brokers", "test.mock.default.partitions"):
            conf.pop(key)
        conf["bootstrap.servers"] = bootstrap
        flat = payloads(P6_PARTS * P7_PER_PART, VALUE_SIZE)
        vals = [flat[i * P7_PER_PART:(i + 1) * P7_PER_PART]
                for i in range(P6_PARTS)]
        keys = [b"p%02d" % i for i in range(P6_PARTS)]
        p = Producer(conf)
        prov = p._rk.codec_provider
        check(prov.wait_warm(300), "7d: producer route not warm")
        c = Consumer({"bootstrap.servers": bootstrap, "group.id": "p7d",
                      "auto.offset.reset": "earliest", "check.crcs": True,
                      "compression.backend": "gpu", "gpu.device": device,
                      **P6_GPU})
        check(c._rk.codec_provider.wait_warm(300), "7d: consumer route "
              "not warm")
        peng = prov._engine
        s0 = dict(peng.stats)
        crc.launches = 0
        topics = [f"p7d-r{r}" for r in range(P7_REPEATS)]
        prod = [p6_produce(p, t, keys, vals) for t in topics]
        cons = [p6_consume(c, t, keys, vals) for t in topics]
        no_cpu_route(peng, "7d producer")
        no_cpu_route(c._rk.codec_provider._engine, "7d consumer")
        d = {key: peng.stats[key] - s0[key]
             for key in ("launches", "sharded_launches")}
        check(d["launches"] > 0, "7d: the producer made no CRC launch")
        lanes = len(peng._lanes)
        print(f"phase 7d: Producer -> standalone mock (own process, "
              f"{P6_PARTS} partitions) -> Consumer(check.crcs), "
              f"gpu.mesh.devices=0: {P7_REPEATS} x "
              f"{P6_PARTS * P7_PER_PART} records x {VALUE_SIZE} B, every "
              f"record back in order; producer lanes {lanes}, launches "
              f"{d['launches']}, sharded route "
              + ("engaged" if d["sharded_launches"] else
                 "not engaged" + (" (one card)" if lanes == 1 else ""))
              + f" ({d['sharded_launches']} sharded launches)")
        print(f"  own process: produce {p6_rates(prod)}; consume "
              f"{p6_rates(cons)}")
        print(f"  in process (phase 6b, this call): produce "
              f"{p6_rates(p6b['produce'])}; consume "
              f"{p6_rates(p6b['consume'])}")
        return {"crc_rows": crc.launches, "produce": prod, "consume": cons}
    finally:
        if c is not None:
            c.close()
        if p is not None:
            p.close()
        proc.kill()
        proc.wait(30)


def phase_mesh(p5: dict, p6: dict) -> dict:
    """Phase 7: the multi-device codec path (parallel/mesh.py: kernels G
    and H), its entry points and the standalone mock."""
    from librdkafka_tpu_torch.entry import dryrun_multichip, entry
    t_start = time.perf_counter()
    pool = p7_pool()
    one_card = torch.cuda.device_count() < 2
    print(f"phase 7: mesh pool {pool}: " + (
        "one card, each shard of a launch runs after the one before it "
        "on that card, so no time below is a scale-out figure"
        if one_card else f"{len(pool)} cards, shards on different cards "
        "overlap"))
    counts = {"crc_rows": 0, "lz4_rows": 0, "G": 0, "H": 0}
    rec = ShardRecorder()
    try:
        rates = {}
        for k in (1, 2, 4):
            r = p7_engine(pool, k, rec)
            rates[k] = r["rate"]
            for key, v in r["counts"].items():
                counts[key] += v
    finally:
        rec.close()

    # 7b: H over the pool
    m = mesh.make_mesh(devices=pool)
    check(mesh.shard_compress(m, [])[0] == [] and mesh.step_cache_count()
          == 0, "7b: the empty list built a step")
    blocks = p5["blocks"]
    main = p7_codec_check(m, blocks)
    odd = p7_codec_check(m, blocks[:-1])
    for r in (main, odd):
        for key, v in r["counts"].items():
            counts[key] += v

    # 7c: the entry points
    lz4.launches = 0
    mesh.codec_launches = 0
    step, (data, lens) = entry()
    got = step(data, lens)
    dryrun_multichip(4, devices=(pool * 4)[:4])
    counts["lz4_rows"] += lz4.launches
    counts["H"] += mesh.codec_launches
    want = lz4.lz4_rows_reference(data, lens, "raw")
    check(all(torch.equal(g, w) for g, w in zip(got, (want[0], want[1],
                                                        want[3]))),
          "7c: entry()'s step on the card != its plain version")
    print("phase 7c: entry()'s step on the card == plain version; "
          f"dryrun_multichip(4, devices={(pool * 4)[:4]}) passed")

    # 7d: the mock in its own process
    d = p7_standalone(p6["legs"][1])
    counts["crc_rows"] += d["crc_rows"]

    # numbers, after the counts: G at the bench workload's rows on a mesh
    # of up to four devices, H at phase 5's 1,024 blocks over the pool
    gdev = pool[:4] if len(pool) >= 4 else pool[:2]
    rng = np.random.default_rng(6)
    rows = [rng.integers(0, 256, LZ4F_BLOCKSIZE, dtype=np.uint8).tobytes()
            for _ in range(P7_ROWS)]
    gdata, gterms, gsel = rows_for(rows, ["crc32c"] * P7_ROWS)
    gm, gstep = mesh.sharded_crc_step(gdev, P7_ROWS // len(gdev),
                                      LZ4F_BLOCKSIZE, "crc32c")
    gk = gstep(gdata, gterms)
    gp = mesh.sharded_crc_reference(gm, gdata, gterms, gsel)
    g_err = int(np.abs(gk.astype(np.int64) - gp.astype(np.int64)).max())
    check(g_err == 0 and gk.tolist() == p7_crcs(rows, "crc32c"),
          "phase 7: G's step != plain version or native")
    g_ms = host_ms(lambda: gstep(gdata, gterms))
    g_plain = host_ms(lambda: mesh.sharded_crc_reference(gm, gdata, gterms,
                                                         gsel), 2)
    g_bound, g_by = bound(P7_ROWS, LZ4F_BLOCKSIZE, 1)
    hstep = mesh.sharded_codec_step(m, LZ4F_BLOCKSIZE, True)
    hargs = (main["data"], main["lens"], main["valid"])
    h_ms = host_ms(lambda: hstep(*hargs))
    h_plain = host_ms(lambda: mesh.sharded_codec_reference(m, *hargs), 2)
    h_bound, h_by = lz4_bound(main["lens"], main["olen"], "raw")
    mesh.release_step_cache()
    print(f"  G (sharded_crc_step over {len(gdev)} shards, {P7_ROWS} x 64 "
          f"KB rows from the host, host clock to the gathered CRCs): "
          f"{g_ms:.4f} ms; plain version {g_plain:.3f} ms; bound "
          f"{g_bound:.6f} ms ({g_by}); the engine's rates: " + "; ".join(
              f"k={k} {v:.1f} MB/s" for k, v in rates.items()))
    print(f"  H (sharded_codec_step over {m.size} shards, phase 5's "
          f"{len(blocks)} blocks from the host, with_crc, host clock to "
          f"the gathered rows): {h_ms:.4f} ms; plain version {h_plain:.3f} "
          f"ms; bound {h_bound:.5f} ms ({h_by}); phase 5's one lz4_rows "
          f"launch (\"raw\", L2 flushed, kernel only) "
          f"{p5['timing']['raw']['ms']:.4f} ms")
    print(f"phase 7: ok ({time.perf_counter() - t_start:.1f} s)")
    return {"counts": counts, "max_err": g_err,
            "h_err": max(main["err"], odd["err"]),
            "G": {"ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
                  "bound_by": g_by},
            "H": {"ms": h_ms, "plain_ms": h_plain, "bound_ms": h_bound,
                  "bound_by": h_by}}

# ---------------------------------------------------------------- phase 8 --

P8_LEGS = ("_engine_pipeline_leg", "_devcodec_leg", "_txn_leg",
           "_chaos_leg", "_external_storm_leg", "_fleet_leg",
           "_session_leg", "_fastlane_leg")


def p8_children() -> tuple:
    """Record the command line of every child the port's subprocess
    registry takes in (supervisors, broker relays, fleet workers), read
    from /proc when it is registered; returns (pid -> (role, argv),
    restore)."""
    from librdkafka_tpu_torch.mock import external
    seen: dict = {}
    register = external._register

    def recording(pids):
        register(pids)
        for pid, what in pids.items():
            argv: list = []
            deadline = time.monotonic() + 5.0
            while not argv and time.monotonic() < deadline:
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        argv = [a.decode() for a in f.read().split(b"\0")
                                if a]
                except OSError:
                    break
                if not argv:
                    time.sleep(0.01)
            seen[pid] = (what, argv)

    external._register = recording

    def restore():
        external._register = register
    return seen, restore


def p8_check_children(seen: dict, tag: str, workers: int = 0) -> str:
    """Every child is the port's: the supervisor runs the port's
    standalone module, each broker the port's relay and each fleet
    worker the port's worker, by path."""
    port = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "librdkafka_tpu_torch")
    want = {"sup": ["-m", "librdkafka_tpu_torch.mock.standalone"],
            "relay": [os.path.join(port, "mock", "_relay.py")],
            "worker": [os.path.join(port, "fleet", "_worker.py")]}
    n = {"sup": 0, "relay": 0, "worker": 0}
    for pid, (what, argv) in seen.items():
        kind = ("sup" if what == "standalone-supervisor" else
                "relay" if what.startswith("standalone-broker-") else
                "worker" if what.startswith("fleet-worker-") else None)
        check(kind is not None, f"{tag}: child {pid} is a {what!r}")
        check(argv[1:1 + len(want[kind])] == want[kind],
              f"{tag}: child {pid} ({what}) runs {argv}, not the port")
        n[kind] += 1
    check(n["sup"] >= 1 and n["relay"] >= 1,
          f"{tag}: no supervisor or broker child recorded: {n}")
    check(n["worker"] == workers,
          f"{tag}: {n['worker']} fleet workers, not {workers}")
    return (f"{n['sup']} supervisor(s), {n['relay']} broker relays"
            + (f", {n['worker']} workers" if workers else "")
            + ", every one the port's")


def p8_no_leak(tag: str) -> None:
    from librdkafka_tpu_torch.mock import external
    left = external.active_subprocess_pids()
    check(not left, f"{tag}: leaked subprocess(es) {left}")


def phase_robustness(device: str | None = None) -> dict:
    """Phase 8: the robustness tier through the port's entry points
    (analysis/stress.py, chaos/ and fleet/ at the JAX package's sizes),
    its device legs on ``device`` (the card unless "cpu").  (a)
    run_stress(): the eight legs under lockdep, clean, with the CRC
    kernel's launches in the engine leg and the LZ4 kernel's in the
    device-codec leg; (b) hot_topic_flood(seed=17): isolation holds and
    the compress route launched; (c) fast_external_kill9(seed=23) and (d)
    fleet_smoke(seed=51), every child process the port's.  Returns the
    kernels' launches of (a) and (b)."""
    from librdkafka_tpu_torch.analysis import lockdep, stress
    from librdkafka_tpu_torch.chaos.scenarios import (fast_external_kill9,
                                                      hot_topic_flood)
    from librdkafka_tpu_torch.fleet.scenarios import fleet_smoke
    t_phase = time.perf_counter()
    secs: dict = {}

    # 8a: the stress gate, each leg's time and launches recorded
    legs: dict = {}

    def timed(name, fn):
        def leg(*args):
            c0, l0, t0 = crc.launches, lz4.launches, time.perf_counter()
            try:
                return fn(*args)
            finally:
                legs[name] = {"s": time.perf_counter() - t0,
                              "crc_rows": crc.launches - c0,
                              "lz4_rows": lz4.launches - l0}
        return leg

    orig = {n: getattr(stress, n) for n in P8_LEGS}
    for n, fn in orig.items():
        setattr(stress, n, timed(n, fn))
    seen, restore = p8_children()
    try:
        t0 = time.perf_counter()
        crc.launches = lz4.launches = 0
        rep = stress.run_stress(device)
        a_counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        secs["8a"] = time.perf_counter() - t0
    finally:
        restore()
        for n, fn in orig.items():
            setattr(stress, n, fn)
    check(lockdep.clean(rep), "8a: lockdep report not clean:\n"
          + lockdep.format_report(rep))
    check(set(legs) == set(P8_LEGS), f"8a: legs run {sorted(legs)}")
    check(legs["_engine_pipeline_leg"]["crc_rows"] > 0,
          "8a: the engine leg made no crc_rows launch")
    check(legs["_devcodec_leg"]["lz4_rows"] > 0,
          "8a: the device-codec leg made no lz4_rows launch")
    p8_no_leak("8a")
    print(f"phase 8a: run_stress(device={device!r}) lockdep clean "
          f"({rep['acquisitions']} acquisitions, {rep['edges']} order "
          f"edges) in {secs['8a']:.3f} s; launches crc_rows "
          f"{a_counts['crc_rows']}, lz4_rows {a_counts['lz4_rows']}; "
          f"children: {p8_check_children(seen, '8a', workers=4)}")
    for n in P8_LEGS:
        leg = legs[n]
        print(f"  {n.strip('_')}: {leg['s']:.3f} s, crc_rows "
              f"{leg['crc_rows']}, lz4_rows {leg['lz4_rows']}")

    # 8b: the QoS flood at the JAX package's sizes, in this process as it
    # stands.  The collector's pauses during the flood are recorded (not
    # prevented), so a missed bound shows whether one of them covers it
    gc_ms: list = []
    gc_t0 = [0.0]

    def gc_probe(phase, _info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms.append((time.perf_counter() - gc_t0[0]) * 1e3)

    gc.callbacks.append(gc_probe)
    try:
        t0 = time.perf_counter()
        crc.launches = lz4.launches = 0
        flood = hot_topic_flood(seed=17, device=device,
                                raise_on_violation=False)
        b_counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        secs["8b"] = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(gc_probe)
    comp = flood["compress"]
    gc_line = (f"{len(gc_ms)} collector pauses, longest "
               f"{max(gc_ms, default=0.0):.1f} ms")
    check(flood["ok"], f"8b: isolation did not hold ({gc_line}): {flood}")
    check(flood["bulk_sent"] > 0
          and flood["bulk_acked"] == flood["bulk_sent"],
          f"8b: bulk messages left undelivered: {flood}")
    check(comp["launches"] > 0 and b_counts["lz4_rows"] > 0,
          f"8b: no compress launch: {comp}")
    cpu_routes = {k: comp[k] for k in ("warmup_miss_jobs", "shed_jobs",
                                       "routed_cpu_jobs", "cpu_jobs")}
    launched = comp["jobs"] - sum(cpu_routes.values())
    print(f"phase 8b: hot_topic_flood(seed=17) in {secs['8b']:.3f} s: "
          f"p99 unloaded {flood['p99_unloaded_ms']} ms, flooded "
          f"{flood['p99_flood_ms']} ms (bound {flood['bound_ms']} ms); "
          f"latency acked {flood['latency_acked']}/{flood['latency_sent']},"
          f" bulk acked {flood['bulk_acked']}/{flood['bulk_sent']}; "
          f"{gc_line}")
    print(f"  compress jobs {comp['jobs']}: launched {launched} in "
          f"{comp['launches']} launches ({comp['blocks']} blocks), "
          + ", ".join(f"{k} {v}" for k, v in cpu_routes.items())
          + f"; kernel launches crc_rows {b_counts['crc_rows']}, "
          f"lz4_rows {b_counts['lz4_rows']}")

    # 8c: the fast out-of-process storm, children the port's
    seen, restore = p8_children()
    try:
        t0 = time.perf_counter()
        ext = fast_external_kill9(seed=23)
        secs["8c"] = time.perf_counter() - t0
    finally:
        restore()
    kills = ext["pids_killed"]
    check(ext["ok"] and kills and all(e["verified_dead"] for e in kills),
          f"8c: {ext.get('violations')} kills {kills}")
    p8_no_leak("8c")
    print(f"phase 8c: fast_external_kill9(seed=23) in {secs['8c']:.3f} s: "
          f"acked {ext['acked']} == consumed {ext['consumed']}, "
          f"{len(kills)} pid-verified SIGKILL(s); "
          f"{p8_check_children(seen, '8c')}")

    # 8d: the fleet smoke, four worker processes
    seen, restore = p8_children()
    try:
        t0 = time.perf_counter()
        fl = fleet_smoke(seed=51)
        secs["8d"] = time.perf_counter() - t0
    finally:
        restore()
    kills = fl["pids_killed"]
    check(fl["ok"] and fl["workers"] == 4 and len(kills) == 1
          and kills[0]["verified_dead"], f"8d: {fl}")
    p8_no_leak("8d")
    fm = fl["fleet_metrics"]
    print(f"phase 8d: fleet_smoke(seed=51) in {secs['8d']:.3f} s: "
          f"{fl['workers']} workers, acked {fm['acked_total']}, consumed "
          f"{fl['consumed_by_group']}, 1 pid-verified SIGKILL, merged "
          f"oracles ok; {p8_check_children(seen, '8d', workers=4)}")
    print(f"phase 8: ok ({time.perf_counter() - t_phase:.3f} s: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items()) + ")")
    return {k: a_counts[k] + b_counts[k] for k in ("crc_rows", "lz4_rows")}


# ---------------------------------------------------------------- phase 9 --

P9_PER_PART, P9_TAIL, P9_REPEATS = 1600, 16, 3
P9_LIMIT_S = 60
#: gpu_smoke's legs: (a) CRC tickets, (b) the device compress route
P9_LEGS = {"a": "a", "b": "b:gpu.compress.device=true"}


def p9_build() -> dict:
    """9a: gcc libtkafka.so from the checkout, then the three C programs
    against it (one gcc each, started together)."""
    from librdkafka_tpu_torch.capi import build_capi, smoke
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    build_capi.build(force=True)
    t_lib = time.perf_counter() - t0
    srcs = {"gpu_smoke": smoke.SRC,
            "cpp_client": os.path.join(root, "librdkafka_tpu_torch",
                                       "examples", "cpp_client.cpp"),
            "capi_smoke": os.path.join(root, "tests", "capi_smoke.c")}
    exes: dict = {}
    errs: list = []

    def one(name):
        try:
            exes[name] = build_capi.compile_program(
                srcs[name], os.path.join(build_capi.BUILD_DIR, name))
        except RuntimeError as e:
            errs.append(e)

    t1 = time.perf_counter()
    ths = [threading.Thread(target=one, args=(n,)) for n in srcs]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    check(not errs, f"9a: a C program did not build: {errs}")
    print(f"phase 9a: libtkafka.so (gcc) {t_lib:.3f} s; gpu_smoke.c, "
          f"examples/cpp_client.cpp and tests/capi_smoke.c (gcc, in "
          f"parallel) {time.perf_counter() - t1:.3f} s")
    return exes


def p9_main_path(exe: str, p6: dict) -> dict:
    """9b: gpu_smoke on the card, legs a (CRC tickets) and b (device
    compress) at 64 x 1,600 x 1 KB a repeat, three repeats a leg.
    Returns the kernels' launches from the clients' stats deltas."""
    from librdkafka_tpu_torch.capi import smoke
    args = [exe, "--partitions", str(P6_PARTS), "--records",
            str(P9_PER_PART), "--tail", str(P9_TAIL), "--repeats",
            str(P9_REPEATS),
            "--conf", "compression.backend=gpu"]
    for k, v in P6_GPU.items():
        args += ["--conf", f"{k}={str(v).lower()}"]
    for leg in P9_LEGS.values():
        args += ["--leg", leg]
    t0 = time.perf_counter()
    r = subprocess.run(args, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if r.returncode != 0 or not r.stdout.rstrip().endswith("GPU-SMOKE-OK"):
        print(r.stdout[-4000:])
        print(r.stderr[-8000:], file=sys.stderr)
        fail(f"9b: gpu_smoke exited {r.returncode}")
    legs = smoke.read(r.stdout)
    counts = {"crc_rows": 0, "lz4_rows": 0}
    p6legs = {"a": ("6b", p6["legs"][1]), "b": ("6c", p6["legs"][2])}
    n = P6_PARTS * P9_PER_PART
    print(f"phase 9b: gpu_smoke (C, through libtkafka.so): Producer -> "
          f"mock -> Consumer(check.crcs), {P9_REPEATS} x {n} records x "
          f"{VALUE_SIZE} B over {P6_PARTS} idempotent partitions a leg "
          f"(tk_produce_batch, then a tail of {P9_TAIL} a partition "
          f"through tk_produce2 with headers and DRs), every record read "
          f"back in order; {dt:.3f} s")
    for name, rep in legs.items():
        prod = smoke.deltas(rep, "producer")
        cons = smoke.deltas(rep, "consumer")
        bad = {f"{who}.{k}": d[k] for who, d in (("producer", prod),
                                                 ("consumer", cons))
               for k in smoke.CPU_ROUTES if d[k]}
        check(not bad, f"9b leg {name}: jobs on the CPU route: {bad}")
        check(cons["launches"] > 0, f"9b leg {name}: no consumer launch")
        if name == "a":
            check(prod["launches"] > 0 and prod["compress.launches"] == 0,
                  f"9b leg a: producer launches {prod}")
        else:
            check(prod["compress.launches"] > 0 and prod["launches"] == 0,
                  f"9b leg b: producer launches {prod}")
        counts["crc_rows"] += prod["launches"] + cons["launches"]
        counts["lz4_rows"] += prod["compress.launches"]
        summ = rep["summary"]
        tag, p6leg = p6legs[name]
        route = "CRC tickets" if name == "a" else "gpu.compress.device"
        print(f"  leg {name} ({route}): warm after "
              f"{summ['warm_rounds']} round(s) ({summ['warm_s']:.3f} s), "
              f"leg {summ['leg_s']:.3f} s; "
              f"launches: producer crc_rows {prod['launches']}, lz4_rows "
              f"{prod['compress.launches']}; consumer crc_rows "
              f"{cons['launches']}; CPU routes 0")
        print(f"    from C: produce {p6_rates(summ['produce'])}; consume "
              f"{p6_rates(summ['consume'])}")
        print(f"    phase {tag} (Python, this call): produce "
              f"{p6_rates(p6leg['produce'])}; consume "
              f"{p6_rates(p6leg['consume'])}")
    check(set(legs) == set(P9_LEGS), f"9b: legs {sorted(legs)}")
    return counts


#: a sitecustomize for 9c's capi_smoke: the embedded interpreter's
#: sys.executable, and what it prints for -c, into $TK_EXE_REPORT
P9_SITE = """import json, os, subprocess, sys
out = os.environ.pop("TK_EXE_REPORT", None)
if out:
    r = subprocess.run([sys.executable, "-c", "print(6 * 7)"],
                       capture_output=True, text=True, timeout=60)
    with open(out, "w") as f:
        json.dump([sys.executable, r.returncode, r.stdout], f)
"""


def p9_abi(exes: dict) -> None:
    """9c: the reference's unchanged tests/capi_smoke.c and the port's
    cpp_client, linked against the port's library, both at once.
    capi_smoke runs with a sitecustomize first on PYTHONPATH that runs
    the embedded interpreter's sys.executable with -c (the GPU
    provider's transport probe, the standalone mock and fleet workers
    re-run it): it must be Python."""
    root = os.path.dirname(os.path.abspath(__file__))
    stub = os.path.join(root, "build", "p9-site")
    report = os.path.join(stub, "exe.json")
    os.makedirs(stub, exist_ok=True)
    with open(os.path.join(stub, "sitecustomize.py"), "w") as f:
        f.write(P9_SITE)
    t0 = time.perf_counter()
    envs = {"capi_smoke": dict(os.environ, PYTHONPATH=stub,
                               TK_EXE_REPORT=report),
            "cpp_client": None}
    procs = {n: subprocess.Popen([exes[n]], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=env)
             for n, env in envs.items()}
    outs = {}
    try:
        for n, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=180)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(30)
            check(proc.returncode == 0, f"9c: {n} exited "
                  f"{proc.returncode}: {err[-2000:]}")
            outs[n] = out
        with open(report) as f:
            exe, rc, printed = json.load(f)
    finally:
        shutil.rmtree(stub, ignore_errors=True)
    check("CAPI-OK" in outs["capi_smoke"] and "all pass"
          in outs["capi_smoke"], "9c: capi_smoke did not pass")
    check("CPP-OK" in outs["cpp_client"], "9c: cpp_client did not pass")
    check(rc == 0 and printed.strip() == "42" and
          os.path.basename(exe) != "capi_smoke",
          f"9c: the embedded sys.executable {exe!r} is not a Python that "
          f"runs -c (rc {rc}, printed {printed!r})")
    print(f"phase 9c: tests/capi_smoke.c (unchanged) and "
          f"examples/cpp_client.cpp against the port's libtkafka.so: "
          f"CAPI-OK ... all pass, CPP-OK "
          f"({time.perf_counter() - t0:.3f} s, both at once); the "
          f"embedded sys.executable is {exe} and runs -c")


#: 9d's runs of the performance example, in one process that calls its
#: main() once a run: torch is imported and the card set up once, while
#: 9c runs; the runs start when the mock's bootstrap comes on stdin
P9_PERF = """import sys, time
import torch
from librdkafka_tpu_torch.examples import performance
torch.cuda.init()
print("9d-ready", flush=True)
bootstrap = sys.stdin.readline().strip()
for tag, argv in %r:
    print("9d-run", tag, flush=True)
    t0 = time.perf_counter()
    performance.main(argv + ["-b", bootstrap])
    print(f"9d-secs {time.perf_counter() - t0:.3f}", flush=True)
"""
P9_ENGINE = re.compile(
    r"% codec engine: (\d+) CRC launches, (\d+) compress launches; CRC "
    r"jobs (\d+), (\d+) of them on the CPU; compress jobs (\d+), (\d+) of "
    r"them on the CPU")
P9_DELIVERED = (r"% (\d+) msgs delivered \(0 failed, 0 stuck\) in "
                r"[\d.]+s: ([\d,]+) msgs/s")
#: (tag, the example's arguments, the line that gives its count and rate)
P9_RUNS = (("-P cpu", ["-P", "-t", "perf-cpu", "--backend", "cpu"],
            P9_DELIVERED),
           ("-P gpu", ["-P", "-t", "perf-gpu", "--backend", "gpu"],
            P9_DELIVERED),
           ("-C gpu", ["-C", "-t", "perf-gpu", "--backend", "gpu"],
            r"% consumed (\d+) msgs in [\d.]+s: ([\d,]+) msgs/s"))


def p9_perf_start() -> tuple:
    """9d's set-up, started before 9c: the standalone mock (64
    partitions) and the example's process, which imports and sets up the
    card, then waits for the bootstrap."""
    root = os.path.dirname(os.path.abspath(__file__))
    base = ["-z", "lz4", "--partitions", str(P6_PARTS), "-c",
            str(P6_PARTS * P9_PER_PART)]
    mock = subprocess.Popen(
        [sys.executable, "-m", "librdkafka_tpu_torch.mock.standalone",
         "--partitions", str(P6_PARTS)], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    example = subprocess.Popen(
        [sys.executable, "-c",
         P9_PERF % ([(tag, extra + base) for tag, extra, _ in P9_RUNS],)],
        cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return mock, example


def p9_performance(mock, example, smi: str) -> dict:
    """9d: the performance example against the standalone mock: -P
    --backend cpu, -P --backend gpu, then -C --backend gpu reading the
    GPU run's topic back.  The GPU runs keep the provider's default
    governor (a user's view): each must launch on the card, and the jobs
    it served on the CPU are printed beside its launches.  Returns each
    run's reading."""
    n = P6_PARTS * P9_PER_PART
    t0 = time.perf_counter()
    ready, _, _ = select.select([mock.stdout], [], [], 60)
    bootstrap = mock.stdout.readline().strip() if ready else ""
    check(bool(bootstrap), "9d: the standalone mock did not start")
    ready, _, _ = select.select([example.stdout], [], [], 120)
    line = example.stdout.readline() if ready else ""
    check(line.strip() == "9d-ready", f"9d: the example's process did not "
          f"start: {line!r}")
    t_wait = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, err = example.communicate(bootstrap + "\n", timeout=300)
    secs = time.perf_counter() - t0
    check(example.returncode == 0, f"9d: the example exited "
          f"{example.returncode}: {out[-1000:]}{err[-2000:]}")
    outs = dict(part.split("\n", 1) for part in out.split("9d-run ")[1:])
    got = {}
    for tag, _, pat in P9_RUNS:
        run = outs.get(tag, "")
        m = re.search(pat, run)
        check(m is not None and int(m.group(1)) == n, f"9d {tag}: {run}")
        eng = P9_ENGINE.search(run)
        if tag.endswith("gpu"):
            check(eng is not None and int(eng.group(1)) > 0,
                  f"9d {tag}: no CRC launch on the card: {run}")
        run_s = re.search(r"9d-secs ([\d.]+)", run)
        got[tag] = (m.group(2), eng.group(0)[2:] if eng else "",
                    run_s.group(1) if run_s else "?")
    print(f"phase 9d: python -m librdkafka_tpu_torch.examples.performance "
          f"-z lz4 --partitions {P6_PARTS} -c {n} -b <standalone mock>, "
          f"three runs in one process ({secs:.3f} s, after {t_wait:.3f} s "
          f"more of set-up beside 9c; {smi}); the GPU runs are the "
          f"governed GPU backend:")
    for tag, (rate, eng, run_s) in got.items():
        print(f"  {tag}: {rate} msgs/s ({run_s} s with the client's "
              f"set-up){'; ' + eng if eng else ''}")
    cpu = float(got["-P cpu"][0].replace(",", ""))
    gpu = float(got["-P gpu"][0].replace(",", ""))
    print(f"  -P gpu / -P cpu: {gpu / cpu:.3f} (PERF.md's limit 0.95; "
          f"not checked here)")
    return got


def phase_capi(p6: dict, smi: str) -> dict:
    """Phase 9: the C ABI (librdkafka_tpu_torch/capi) on the card.
    Returns the kernels' launches of 9b."""
    t0 = time.perf_counter()
    exes = p9_build()
    counts = p9_main_path(exes["gpu_smoke"], p6)
    mock, example = p9_perf_start()
    try:
        p9_abi(exes)
        p9_performance(mock, example, smi)
    finally:
        for proc in (example, mock):
            if proc.poll() is None:
                proc.kill()
            proc.wait(30)
    secs = time.perf_counter() - t0
    check(secs <= P9_LIMIT_S, f"phase 9 took {secs:.3f} s, over its "
          f"{P9_LIMIT_S} s")
    print(f"phase 9: ok ({secs:.3f} s)")
    return counts


def kernel_line(main: dict, timing: dict, max_err: int) -> dict:
    """The crc_rows entry at the main path's shape (its produce regions
    as packed segments)."""
    return {"name": "crc_rows", "route": "cuda",
            "source": "librdkafka_tpu_torch/csrc/crc_rows.cu",
            "replaces": "librdkafka_tpu/ops/crc32c_jax.py:471",
            "launches": main["launches"], "max_abs_err": max_err,
            **timing, "library_ms": None}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    rng = np.random.default_rng(SEED)
    dev = phase_device()
    cpu_p = CpuCodecProvider()
    work = workload(cpu_p)
    max_err, timing = phase_kernel(rng, work["regions"])
    gpu = GpuCodecProvider(min_batches=1, pipeline_depth=0,
                           min_transport_mb_s=0)
    check(gpu.wait_warm(300), "the synchronous route did not warm")
    main_path = phase_main_path(gpu, cpu_p, work)
    engine = phase_engine(cpu_p, gpu, work, rng)
    gpu.close()
    comp = phase_lz4(cpu_p, work, rng)
    client = phase_client()
    mp = phase_mesh(comp, client)
    robust = phase_robustness()
    capi = phase_capi(client, dev["smi"])
    cnt = mp["counts"]
    main_path["launches"] += (engine["launches"] + client["crc_rows"]
                              + cnt["crc_rows"] + robust["crc_rows"]
                              + capi["crc_rows"])
    comp["launches"] += (client["lz4_rows"] + cnt["lz4_rows"]
                         + robust["lz4_rows"] + capi["lz4_rows"])
    line = kernel_line(main_path, timing, max(max_err, engine["max_err"]))
    lz4_line = {"name": "lz4_rows", "route": "cuda",
                "source": "librdkafka_tpu_torch/csrc/lz4_rows.cu",
                "replaces": "librdkafka_tpu/ops/lz4_jax.py:282",
                "launches": comp["launches"], "max_abs_err": comp["max_err"],
                "ms": comp["ms"], "plain_ms": comp["plain_ms"],
                "bound_ms": comp["bound_ms"], "bound_by": comp["bound_by"],
                "library_ms": None}
    # G and H launch the two kernels a shard; their launches are the
    # shard launches of phase 7's main path
    g_line = {"name": "sharded_crc_step", "route": "cuda",
              "source": "librdkafka_tpu_torch/parallel/mesh.py",
              "replaces": "librdkafka_tpu/parallel/mesh.py:155",
              "launches": cnt["G"], "max_abs_err": mp["max_err"],
              **mp["G"], "library_ms": None}
    h_line = {"name": "sharded_codec_step", "route": "cuda",
              "source": "librdkafka_tpu_torch/parallel/mesh.py",
              "replaces": "librdkafka_tpu/parallel/mesh.py:225",
              "launches": cnt["H"], "max_abs_err": mp["h_err"],
              **mp["H"], "library_ms": None}
    print(f"{dev['smi']}")
    print(json.dumps({"kernels": [line, lz4_line, g_line, h_line]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
