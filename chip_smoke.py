#!/usr/bin/env python3
"""Drive librdkafka_tpu_torch's main path on one NVIDIA GPU.

Run from the root of the repository, on a host with one CUDA card:

    python3 chip_smoke.py

Phase 1 prints the card and builds the kernels from the checkout's sources
(csrc/crc_rows.cu with nvcc, ops/native/codec.cpp with g++).  Phase 2 holds
the CRC row kernel against its plain PyTorch version and the CPU oracles
(native crc32c, zlib.crc32) at B in {1, 8, 128, 256} rows of 64 KB, for
crc32c rows, crc32 rows and mixed rows, and times it.  Phase 3 runs the
producer writer phase and the consumer fetch verify (write_batches /
read_batches) through GpuCodecProvider at the shape of BASELINE.json
config 5: 64 partitions, each one lz4 batch of 960 records x 1,024 B; the
wire bytes must equal the CPU provider's, a flipped byte must raise
CrcMismatch, and a legacy leg runs 64 MsgVer1 lz4 wrappers through
crc32_many.  Any mismatch exits non-zero.

The last two lines of standard output are a ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when no CUDA device is available.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from librdkafka_tpu_torch import (CpuCodecProvider, GpuCodecProvider,
                                  read_batches, write_batches)
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.ops import crc32c_torch as crc
from librdkafka_tpu_torch.ops.packing import pad_left
from librdkafka_tpu_torch.protocol.msgset import (CrcMismatch, Record,
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


def rows_for(bufs, polys_per_row):
    data, lens = pad_left(bufs, crc.BLOCK)
    terms = np.array([crc._term_host(int(n), p)
                      for n, p in zip(lens, polys_per_row)], dtype=np.int64)
    sel = np.array([crc.POLYS.index(p) for p in polys_per_row],
                   dtype=np.int32)
    return data, terms, sel


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
    t0 = time.perf_counter()
    crc._kernel_lib()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.lib()
    t_gpp = time.perf_counter() - t0
    print(f"build: crc_rows.cu (nvcc) {t_nvcc:.3f} s, codec.cpp (g++) "
          f"{t_gpp:.3f} s")
    for line in crc.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return {"name": name, "smi": smi}


# ---------------------------------------------------------------- phase 2 --

def phase_kernel(rng) -> int:
    """Kernel == plain version == CPU oracle; returns the max abs error
    between kernel and plain version (0 when they agree)."""
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
            want = [native.crc32c(b) if p == "crc32c"
                    else zlib.crc32(b) & 0xFFFFFFFF
                    for b, p in zip(bufs, polys)]
            check(got.cpu().tolist() == want,
                  f"kernel != CPU oracle at B={B} sel={mode}")
            if mode != "mixed":
                continue
            ms = kernel_ms(lambda: crc.crc_rows(d, t, s))
            plain = kernel_ms(lambda: crc.crc_rows_reference(d, t, s), 5)
            h2d = host_ms(lambda: torch.from_numpy(data).cuda())
            bms, _ = bound(B, crc.BLOCK, 2)
            print(f"  {B:<4} {mode:<7} {ms:9.4f} {bms:9.4f} {plain:9.3f} "
                  f"{h2d:7.3f}")
    print("phase 2: ok (kernel == plain == oracle, crc32c/crc32/mixed)")
    return max_err


# ---------------------------------------------------------------- phase 3 --

def phase_main_path(gpu, cpu_p) -> dict:
    vals = payloads(4096, VALUE_SIZE)
    parts = [[Record(value=vals[(p * RECORDS + i) % len(vals)])
              for i in range(RECORDS)] for p in range(PARTITIONS)]
    legacy = [write_msgset_v01(
        recs, magic=1, codec="lz4", now_ms=NOW_MS,
        compress_fn=lambda raw: cpu_p.compress_many("lz4", [raw])[0])
        for recs in parts]
    nmsgs = PARTITIONS * RECORDS

    # the counted run: the main path, produce then verify, plus the
    # legacy fetch leg
    crc.launches = 0
    wire = write_batches(gpu, parts, "lz4", NOW_MS)
    per_stage = {"produce": crc.launches}
    got = read_batches(gpu, wire)
    per_stage["verify"] = crc.launches - per_stage["produce"]
    got_legacy = read_batches(gpu, legacy)
    torch.cuda.synchronize()
    launches = crc.launches
    per_stage["legacy verify"] = launches - sum(per_stage.values())
    check(all(per_stage.values()),
          f"a main-path stage launched the crc_rows kernel 0 times: "
          f"{per_stage}")

    wire_cpu = write_batches(cpu_p, parts, "lz4", NOW_MS)
    check(wire == wire_cpu, "GPU provider wire bytes != CPU provider's")
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

    regions = [w[V2_OF_Attributes:] for w in wire]
    rows = sum(math.ceil(len(r) / crc.BLOCK) for r in regions)
    comp = sum(len(w) for w in wire)
    print(f"phase 3: {PARTITIONS} partitions x {RECORDS} x {VALUE_SIZE} B "
          f"lz4: {rows} compressed blocks per round ({comp} wire bytes); "
          f"launches per round: " + ", ".join(
              f"{k} {v}" for k, v in per_stage.items()))

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
    print(f"  crc32c_many of one round's {len(regions)} regions: gpu "
          f"{crc_ms['gpu']:.3f} ms, cpu {crc_ms['cpu']:.3f} ms (host clock)")
    busy = device_busy_share(lambda: write_batches(gpu, parts, "lz4", NOW_MS))
    print("  device busy share of one gpu produce round: "
          + ("not measured (profiler saw no device time)" if busy is None
             else f"{busy:.6f}"))
    print("phase 3: ok (round trip, wire == CPU provider, CrcMismatch, "
          "legacy leg)")
    return {"regions": regions, "launches": launches}


def kernel_line(main: dict, max_err: int) -> dict:
    """The crc_rows entry at the main path's shape (its produce rows)."""
    regions = main["regions"]
    blocks = [bytes(r[i:i + crc.BLOCK]) for r in regions
              for i in range(0, len(r), crc.BLOCK)]
    data, terms, sel = rows_for(blocks, ["crc32c"] * len(blocks))
    d = torch.from_numpy(data).cuda()
    t = torch.from_numpy(terms).cuda()
    s = torch.from_numpy(sel).cuda()
    got = crc.crc_rows(d, t, s)
    ref = crc.crc_rows_reference(d, t, s)
    err = max(max_err, int((got - ref).abs().max()))
    check(err == 0, "kernel != plain version at the main path's shape")
    ms = kernel_ms(lambda: crc.crc_rows(d, t, s))
    plain = kernel_ms(lambda: crc.crc_rows_reference(d, t, s), 5)
    bms, by = bound(len(blocks), crc.BLOCK, 1)
    return {"name": "crc_rows", "route": "cuda",
            "source": "librdkafka_tpu_torch/csrc/crc_rows.cu",
            "replaces": "librdkafka_tpu/ops/crc32c_jax.py:471",
            "launches": main["launches"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    rng = np.random.default_rng(SEED)
    dev = phase_device()
    max_err = phase_kernel(rng)
    gpu = GpuCodecProvider(min_batches=1)
    main_path = phase_main_path(gpu, CpuCodecProvider())
    gpu.close()
    line = kernel_line(main_path, max_err)
    print(f"{dev['smi']}")
    print(json.dumps({"kernels": [line]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
