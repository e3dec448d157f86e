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
the CPU print beside its launches.  Phase 9 fails past 60 s.  Phase 10
runs Kafka's exactly-once copy (the consume-transform-produce loop of
librdkafka's examples/transactions.c) through the port's public API on
two legs, each against its own in-process mock: (a) an idempotent GPU
Producer seeds eos-in, 64 partitions x 1,600 records x 1,024 B lz4,
keyed by the record's global index; (b) four copier
members, threads of this process (the first subscribes alone, the
others once its first transaction is open), each a read_committed cooperative-sticky
check.crcs GPU consumer of group eos-copy-<leg> and a transactional GPU
producer (eos-copier-<leg>-<k>), copy up to 750 records a transaction
to the same partition of eos-out, with send_offsets_to_transaction of
the positions read and commit_transaction; every 7th transaction of a
member (staggered by its index), and any whose group generation moved,
is flushed and aborted and the member seeks back to its committed
offsets; once half the input is copied member 3 closes and a fifth
member joins; leg a on the CRC tickets, leg b with
gpu.compress.device=true; (c) a read_committed check.crcs GPU consumer
reads eos-out.  Every input record must be read exactly once, the
group's committed offsets must equal eos-in's ends, every stored batch's
CRC the native crc32c, every data batch transactional lz4 with the
native encoder's frame (the deterministic one on leg b), at least one
ABORT marker a cadence abort; every copier's consumer and the verifier
launch crc_rows (control-batch regions among the verifier's), leg a's
producers crc_rows and leg b's lz4_rows with no CRC launch; no job on a
CPU route; every member aborts once; at least two incremental
rebalances while transactions are open; no engine thread or child
process left; 90 s at most.  It prints each leg's copy msgs/s, commit
latency p50 and p99, rebalance wall time and launches.  Phase 11 holds
the producer's delivery path and the consumer's API on the card, through
functions that take a client kit (port_kit(); the CPU tests pass the
JAX package's), on two legs ((a) CRC tickets, (b) gpu.compress.device=
true; governor off, warm), each against its own in-process mock of three
brokers: (a) an idempotent lz4 Producer with dr_msg_cb and dr_batch_cb
sends 64 partitions x 1,600 records x 1,024 B, all led by broker 1,
through produce_batch, a quarter of them with headers and a quarter with
explicit timestamps; flush() must return 0 with every DR served, each
success DR the produced record (headers, timestamp) at its stored
offset, each DR batch a stored batch, every stored batch's CRC the
native crc32c and its frame the native encoder's (the deterministic one
on leg b); then the error DRs on broker 3's topics, each per message
with its payload: a mixed produce_batch with an unknown partition, a
message.timeout.ms expiry while the mock holds the broker down, and
purge(in_flight) while it holds a request; (b) a check.crcs Consumer
with client.rack reads every record with consume(num_messages=...),
the even partitions from broker 2 as follower (KIP-392), pauses and
resumes half the partitions, withdraws the follower midway (reading goes
back to the leader), seeks a quarter of the partitions back 300 records
with fetched partitions parked in the verify pipeline, looks offsets up
by stored timestamps, commits to offset.store.method=file and restarts
from the files; every record after each seek point once and in order
with its headers and timestamp, fetches on the follower and on the
leader in the mock's request_log, CRC launches in each half; a regex
subscription then reads a matching topic created mid-run.  The
producer launches crc_rows on leg a and lz4_rows with no CRC launch on
leg b; no job of a counted client takes a CPU route.  (c) A GPU Producer
and Consumer with tickets in flight, the mock no longer answering
broker 2 and the consumer's broker-2 thread wedged: close() returns in
time, the engines are closed with their threads gone (checked on the
engine: Kafka.close() swallows its error), every ticket waiter returns
or fails "closed", and a fresh client launches crc_rows with exact CRCs.
It prints each leg's produce, follower and leader consume msgs/s and
launches; phase 11 fails past 60 s.  Phase 12 holds the port's
observability (obs/trace.py, obs/metrics.py, obs/collect.py and their
span sites in the client, the broker threads and the engine) on the
card: (a) phase 11's shape (64 partitions x 1,600 records x 1,024 B lz4,
idempotent) through a traced, metered Producer into an in-process mock
and back through a traced check.crcs GPU Consumer, on leg a (CRC
tickets) and leg b (gpu.compress.device=true), governor off and warm,
rings large enough never to wrap (checked); the dump has the Perfetto
shape test_0126 asserts and its stages; device_launch spans == the two
engines' CRC launches == crc_rows launches, compress_launch spans ==
compress launches == lz4_rows launches, each launch on card 0 unsharded
and read back after it ends on its lane, produce_tx == ack == the
mock's ProduceRequests == stored batches, crc_verify == the consumer's
verify tickets, engine.launches == the engines' launches in the
registry and in the stats blob's obs section, no CPU route, the wire
exact; after close() no ring and no instrument is left.  It prints each
leg's stage table (scripts/traceview.py, loaded by path) and the produce
rate with tracing off and on.  (b) The performance example's produce
loop (examples/performance.py:57-118) in this process against the
standalone mock, 102,400 records, four legs interleaved three times:
--backend cpu, the governed GPU default, gpu.warmup=false and
gpu.governor=false, tracing on; it prints each leg's median msgs/s, its
ratio to cpu, the engine's launches and CPU routes, the stage totals and
the application thread's longest gaps between enqueue instants with the
spans open meanwhile; every record delivered and each GPU leg launching.
(c) A request timeout forced on a traced GPU Producer after a lone
record and one round: the flight dump holds the fan-in wait, the round's
launch and readback and the timeout, dumps stop at FLIGHT_MAX_DUMPS, and
obs.collect merges it with a Consumer's trace_dump.  Phase 12 fails past
60 s.  Phase 13 holds the client's remaining planes on the card, legs a
(CRC tickets) and b (gpu.compress.device=true), governor off and warm:
(a) the same seeded rounds (64 partitions x 1,600 records x 1,024 B lz4,
fixed timestamps, batches cut by count, three repeats) over sasl_ssl on
a 3-broker mock with a TLS listener that requires a client certificate
(an idempotent SCRAM-SHA-512 Producer with a PKCS#12 keystore, an
OAUTHBEARER check.crcs Consumer) and over plaintext: the stored blobs
equal byte for byte and exact, every record read back; a wrong SCRAM
password and an unknown CA refused with the reference's DR code and no
thread left; msgs/s of both transports.  The certificates come from
tests/tlsutil.py (loaded by path) where cryptography imports, else from
the openssl command; with neither the phase fails.  (b) AdminClient over
sasl_ssl: create_topics (64 partitions, replication 3),
describe/alter_configs, a leg-a producer that grows with the topic to 96
partitions (create_partitions midway; every new partition's batch in
the CRC tickets after the growth), a GPU consumer of all 96, then
list/describe/delete_groups and delete_topics.  (c) MsgVer1 (0.10.2) and
MsgVer0 (0.9.0) brokers, 64 x 400 records each: lz4 wrappers written on
the host, every message CRC (outer and inner) == zlib.crc32, every
legacy region verified through crc32_submit in crc32 launches of
crc_rows, a flipped byte -> _BAD_MSG; then a mixed log (a MsgVer1 run,
then v2) over 64 partitions, its v2 batches verified inline on the host
by client/kafka.py's mixed-log split (the reference's route too).  (d)
sockem throttles the idempotent producer's link to 30 kB/s with a
ProduceRequest on the wire, then kills every connection: each record
stored once, in order, exact, every retried batch rebuilt through the
device route; a check.crcs consumer's connection killed mid-fetch;
head-of-line blocking on one producer over two brokers, one at 2,500 ms
RTT (the fast broker's 20 DRs under 2.0 s, p99 printed).  Phase 13 fails
past 90 s.  Phase 14 holds the producer's latency path, every
compression codec and the client under load on the card, through
functions that take a client kit like phases 10-13: (a) test_0055's
three cases with its own bounds (the least linger.ms 0 delivery under
150 ms; flush() under linger.ms 5,000 in under 2 s, the 50 lingering
records one stored batch; int_latency's max at least 250,000 us at
linger.ms 300), then 500 single 1 KB lz4 records at linger.ms 0 and
acks=all to one partition, each awaited, on four legs: the CPU provider,
the GPU provider on its governed defaults, leg a (CRC tickets, governor
off, quorum 1, warm) and leg b (leg a with gpu.compress.device=true);
produce->DR p50, p99 and max and each leg's routes (crc_rows / lz4_rows
launches, cpu_fallback_jobs, fanin_waits, fanin_skips) are printed;
legs a and b must make one launch a batch and take no CPU route, every
stored CRC must equal the native crc32c, the governed leg's routes are
printed as they fall; (b) one idempotent GPU Producer a leg (legs a and
b), global codec lz4 with topic-scope overrides none, gzip, snappy and
zstd and an lz4 topic that inherits, 16 partitions x 1,600 x 1 KB a
topic, fixed timestamps, batches cut by count: each stored batch's codec
bits its topic's, its CRC the native crc32c, the blobs equal byte for
byte to the same round through the CPU provider (the deterministic
encoder's round on leg b's lz4 topic), every batch's CRC region in the
producer's tickets (leg b: the lz4 batches through lz4_rows instead),
then a check.crcs GPU Consumer reads every record in order with a
verify region a stored batch, and a flipped byte in a gzip and in a
zstd batch reaches it as _BAD_MSG; whether zstandard imports is printed,
and without it the zstd topic is left out; (c) 4 application threads x
25,600 x 1 KB into one idempotent lz4 GPU Producer over 64 partitions on
2 brokers, every record exactly once and msg_cnt == msg_bytes == 0
after flush(), then the same while broker 1 is killed with a
ProduceRequest in flight and restarted (requeued batches counted and
rebuilt through the device route), two check.crcs GPU consumers in one
group, the second joining halfway (none lost, duplicates printed),
test_0112's backpressure on sockem at 24 KB/s (three bursts at each
threshold, interleaved: threshold 1 stores fewer batches in all than
1,000,000, each through a CRC ticket) and
message.copy.max.bytes 64 (a 10 B and a 4 KB value in one batch, one
CRC region); (d) test_0118's behaviours across the codec seam on leg a:
acks 0, 1 and -1, null key and value, MSG_SIZE_TOO_LARGE, an unknown
partition, the ut_handle_ProduceResponse retry rebuilt through the CRC
ticket, reconsume after seek through the verify tickets.  Phase 14
fails past 90 s or if a thread dies of an exception.  Any mismatch exits
non-zero.

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
from librdkafka_tpu_torch.protocol.proto import (OFFSET_BEGINNING,
                                                V2_OF_Attributes)

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

    def fused_codec_id(self, codec):
        # the fused native lz4 builder is the fast parse: keep lz4 on
        # compress_many above
        return None if codec == "lz4" else super().fused_codec_id(codec)


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


def p6_produce(p, topic: str, keys, vals, ts0: int | None = None) -> float:
    """Every record of ``vals[partition][j]``, keyed by partition, with
    explicit partitions (and timestamps ``ts0 + j`` when ``ts0`` is
    given), then flush(); msgs/s over produce() + flush()."""
    produce = p.produce
    n = sum(len(v) for v in vals)
    t0 = time.perf_counter()
    for j in range(len(vals[0])):
        ts = {} if ts0 is None else {"timestamp": ts0 + j}
        for i in range(len(vals)):
            produce(topic, value=vals[i][j], key=keys[i], partition=i, **ts)
    left = p.flush(300)
    dt = time.perf_counter() - t0
    check(left == 0, f"{topic}: flush() left {left} messages")
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


def p6_consume(c, topic: str, keys, vals, kill=None) -> float:
    """Assign every partition of ``topic`` from the beginning and read
    it all back through the CRC-checking consumer; each partition's
    (key, value, offset) sequence must be the produced one, each record
    once (``kill()`` runs when a quarter has been read).  msgs/s from
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
        check(time.monotonic() < deadline, f"{topic}: consumed {got} of {n}")
        for m in c.consume(min(10_000, n - got), 0.5):
            if kill is not None and got >= n // 4:
                kill()
                kill = None
            check(m.error is None, f"{topic}: {m.error}")
            i, j = m.partition, nxt[m.partition]
            check(j < len(vals[i]) and m.offset == j and m.key == keys[i]
                  and m.value == vals[i][j],
                  f"{topic}[{i}]: record {j} missing, doubled, out of "
                  f"order or wrong (offset {m.offset})")
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


# --------------------------------------------------------------- phase 10 --

P10_PER_PART, P10_TXN, P10_ABORT_EVERY, P10_MEMBERS = 1600, 750, 7, 4
P10_LIMIT_S = 90
#: seconds the mock holds the leave's rebalance open for the join
P10_HOLD_S = 1.0
EOS_IN, EOS_OUT = "eos-in", "eos-out"
#: every copier consumer's group keys (heartbeats inside the mock's 3 s
#: rebalance window)
EOS_GROUP = {"partition.assignment.strategy": "cooperative-sticky",
             "isolation.level": "read_committed", "check.crcs": True,
             "enable.auto.commit": False, "auto.offset.reset": "earliest",
             "heartbeat.interval.ms": 100, "session.timeout.ms": 6000}


class EosError(RuntimeError):
    """The exactly-once copy broke one of its checks."""


def port_kit():
    """The client package an exactly-once copy runs on: the port's.  The
    tests pass the JAX package's names in the same shape."""
    from types import SimpleNamespace

    from librdkafka_tpu_torch import Consumer, Producer
    from librdkafka_tpu_torch.client.consumer import TopicPartition
    from librdkafka_tpu_torch.mock.cluster import MockCluster
    return SimpleNamespace(Producer=Producer, Consumer=Consumer,
                           TopicPartition=TopicPartition,
                           MockCluster=MockCluster)


def eos_key(i: int, j: int, per_part: int) -> bytes:
    """The key of record j of input partition i: its global index."""
    return b"%08d" % (i * per_part + j)


def eos_engine(client):
    """The client's offload engine, or None on a provider without one."""
    return getattr(client._rk.codec_provider, "_engine", None)


def eos_warm(client) -> None:
    """Open a GPU (or TPU) client's device route before it counts."""
    prov = client._rk.codec_provider
    # the JAX package's wait_warm returns None
    if hasattr(prov, "wait_warm") and prov.wait_warm(300) is False:
        raise EosError("a client's device route did not warm")


def eos_count_control(client) -> list:
    """Count the control-batch regions the client's fetch verify hands
    its provider's CRC ticket: [regions, control regions]."""
    from librdkafka_tpu_torch.protocol.proto import ATTR_CONTROL
    prov = client._rk.codec_provider
    seen = [0, 0]
    submit = getattr(prov, "crc32c_submit", None)
    if submit is None:
        return seen

    def counting(bufs, *a, **kw):
        seen[0] += len(bufs)
        seen[1] += sum(1 for b in bufs
                       if int.from_bytes(bytes(b[:2]), "big") & ATTR_CONTROL)
        return submit(bufs, *a, **kw)
    prov.crc32c_submit = counting
    return seen


def eos_seed(kit, bootstrap: str, vals, backend: dict) -> None:
    """10a: an idempotent lz4 Producer writes ``vals[i][j]`` to partition
    i of eos-in, keyed by the record's global index, timestamped by it."""
    per = len(vals[0])
    p = kit.Producer({"bootstrap.servers": bootstrap,
                      "enable.idempotence": True, "compression.codec": "lz4",
                      "linger.ms": 5, "queue.buffering.max.messages":
                      1_000_000, **backend})
    try:
        eos_warm(p)
        for j in range(per):
            for i in range(len(vals)):
                p.produce(EOS_IN, value=vals[i][j], key=eos_key(i, j, per),
                          partition=i, timestamp=NOW_MS + i * per + j)
        left = p.flush(300)
        if left:
            raise EosError(f"seeding eos-in left {left} messages")
    finally:
        p.close()


class EosLeg:
    """What the members of one copy leg share: the input's end offsets,
    the offsets committed so far, the rebalance callbacks seen."""

    def __init__(self, kit, name: str, bootstrap: str, hwm: dict,
                 backend: dict, producer_extra: dict, txn_records: int,
                 abort_every: int, exact: bool):
        self.kit, self.name, self.bootstrap = kit, name, bootstrap
        self.hwm = hwm
        self.backend, self.producer_extra = backend, producer_extra
        self.txn_records, self.abort_every = txn_records, abort_every
        self.exact = exact
        self.lock = threading.Lock()
        self.committed: dict = {}
        self.done = threading.Event()
        self.t_begin = self.t_done = None
        # (t, member, kind, n, generation, partitions)
        self.events: list = []

    def copied(self) -> int:
        with self.lock:
            return sum(self.committed.values())

    def note_commit(self, offs) -> None:
        with self.lock:
            for tp in offs:
                self.committed[tp.partition] = max(
                    self.committed.get(tp.partition, 0), tp.offset)
            if all(self.committed.get(q, 0) >= end
                   for q, end in self.hwm.items()):
                self.t_done = time.monotonic()
                self.done.set()


class EosCopier(threading.Thread):
    """One copier member: a read_committed cooperative group consumer and
    a transactional producer, copying eos-in to the same partition of
    eos-out in transactions of up to ``txn_records`` records.  Every
    ``abort_every``-th transaction of a member (the members' cycles
    staggered by their index k) is flushed and aborted, and the member
    seeks its assignment back to its committed offsets, as librdkafka's
    examples/transactions.c does.  The member's clients are made, warm
    and initialised before it waits for ``go`` to subscribe."""

    def __init__(self, leg: EosLeg, k: int):
        super().__init__(name=f"eos-copier-{leg.name}-{k}", daemon=True)
        self.leg, self.k = leg, k
        self.go = threading.Event()
        self.leave = threading.Event()
        self.assigned: set = set()
        self.txns = self.aborts = self.commits = self.fenced = 0
        self.commit_ms: list = []
        self.engines: dict = {}
        self.error = None

    def run(self) -> None:
        import traceback
        try:
            self._copy()
        except Exception:         # reported by eos_copy, which raises
            self.error = traceback.format_exc()
            self.leg.done.set()

    def _note(self, kind: str, consumer, parts) -> None:
        leg = self.leg
        with leg.lock:
            keys = {tp.partition for tp in parts}
            if kind == "assign":
                self.assigned |= keys
            else:
                self.assigned -= keys
            leg.events.append((time.monotonic(), self.k, kind, len(keys),
                               consumer.consumer_group_metadata().generation,
                               frozenset(keys)))

    def _copy(self) -> None:
        leg, kit = self.leg, self.leg.kit
        tid = f"eos-copier-{leg.name}-{self.k}"
        p = kit.Producer({"bootstrap.servers": leg.bootstrap,
                          "transactional.id": tid, "compression.codec": "lz4",
                          "linger.ms": 5, **leg.backend, **leg.producer_extra})
        c = None
        try:
            c = kit.Consumer({"bootstrap.servers": leg.bootstrap,
                              "group.id": f"eos-copy-{leg.name}",
                              "client.id": tid, **EOS_GROUP, **leg.backend})
            eos_warm(p)
            eos_warm(c)
            peng = eos_engine(p)
            p_crc0 = peng.stats["launches"] if peng is not None else 0
            p.init_transactions(60)

            def on_assign(cons, parts):
                cons.incremental_assign(parts)
                self._note("assign", cons, parts)

            def on_revoke(cons, parts):
                cons.incremental_unassign(parts)
                self._note("revoke", cons, parts)
            while not (self.go.wait(0.1) or leg.done.is_set()):
                pass
            c.subscribe([EOS_IN], on_assign=on_assign, on_revoke=on_revoke)
            while not leg.done.is_set() and not self.leave.is_set():
                msgs = self._read(c)
                if msgs:
                    self._transaction(p, c, msgs, eos_member(c))
            self.engines = {"consumer": eos_snapshot(eos_engine(c)),
                            "producer": eos_snapshot(peng),
                            "producer_crc0": p_crc0}
        finally:
            if c is not None:
                c.close()
            p.close()

    def _read(self, c) -> list:
        """Up to txn_records records of partitions still assigned (a
        revoke served inside consume() drops that partition's records:
        its next owner reads them from the committed offset).  ``exact``
        reads exactly txn_records, for byte-equal runs."""
        leg = self.leg
        out: list = []
        while len(out) < leg.txn_records and not leg.done.is_set():
            for m in c.consume(leg.txn_records - len(out), 0.1):
                if m.error is not None:
                    raise EosError(f"{self.name}: consume: {m.error}")
                out.append(m)
            if not leg.exact or self.leave.is_set():
                break
        with leg.lock:
            owned = set(self.assigned)
        return [m for m in out if m.partition in owned]

    def _transaction(self, p, c, msgs, member: tuple) -> None:
        """Copy ``msgs`` in one transaction.  It aborts on the member's
        abort cadence, and when the member's generation or id moved from
        ``member`` (read with the records): the group may have handed
        their partitions on, and TxnOffsetCommit (v0-2) carries no
        generation for the coordinator to fence a stale member with
        (KIP-447)."""
        leg, kit = self.leg, self.leg.kit
        p.begin_transaction()
        with leg.lock:
            leg.t_begin = leg.t_begin or time.monotonic()
        hdr = [("copier", self.name.encode())]
        for m in msgs:
            p.produce(EOS_OUT, value=m.value, key=m.key,
                      partition=m.partition, timestamp=m.timestamp,
                      headers=hdr)
        self.txns += 1
        cadence = (self.txns + self.k) % leg.abort_every == 0
        if cadence or eos_member(c) != member:
            # the aborted records reach the log before the abort: its
            # ABORT markers and the LSO are what read_committed filters
            if p.flush(60):
                raise EosError(f"{self.name}: flush before abort timed out")
            p.abort_transaction(60)
            if cadence:
                self.aborts += 1
            else:
                self.fenced += 1
            for tp in c.committed(c.assignment(), 30):
                c.seek(kit.TopicPartition(EOS_IN, tp.partition,
                                          tp.offset if tp.offset >= 0
                                          else OFFSET_BEGINNING))
            return
        # the positions of the partitions this transaction read: after a
        # rewind, position() of a partition not read since still names
        # the offset delivered before the seek (ROADMAP.md queue 3)
        offs = c.position([kit.TopicPartition(EOS_IN, q)
                           for q in sorted({m.partition for m in msgs})])
        p.send_offsets_to_transaction(offs, c.consumer_group_metadata(), 60)
        t0 = time.perf_counter()
        p.commit_transaction(60)
        self.commit_ms.append((time.perf_counter() - t0) * 1e3)
        self.commits += 1
        leg.note_commit(offs)


def eos_applied(events: list, flag: dict) -> set:
    """The partitions the flagged move's old owner had applied through
    its rebalance callbacks before the flag's generation."""
    k = int(flag["from"].split("-")[3])       # eos-copier-<leg>-<k>-...
    held: set = set()
    for e in events:
        if e[1] == k and e[4] < flag["gen"]:
            held = held | e[5] if e[2] == "assign" else held - e[5]
    return held


def eos_member(consumer) -> tuple:
    """The consumer's group generation and member id."""
    md = consumer.consumer_group_metadata()
    return md.generation, md.member_id


def eos_snapshot(eng) -> dict | None:
    if eng is None:
        return None
    return {"stats": dict(eng.stats), "compress": dict(eng.compress_stats)}


def eos_wait(cond, what: str, timeout: float, leg: EosLeg) -> float:
    """Seconds until ``cond()``; raises past ``timeout``."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise EosError(f"leg {leg.name}: timed out waiting for {what}")
        time.sleep(0.01)
    return time.monotonic() - t0


def eos_copy(kit, name: str, bootstrap: str, hwm: dict, backend: dict,
             producer_extra: dict | None = None, members: int = P10_MEMBERS,
             txn_records: int = P10_TXN, abort_every: int = P10_ABORT_EVERY,
             leaver: int | None = 3, cluster=None, stagger: bool = True,
             exact: bool = False, timeout: float = 120.0) -> dict:
    """10b: ``members`` copier threads copy eos-in to eos-out until the
    group's committed offsets reach ``hwm``; with ``stagger`` the first
    subscribes alone and the others once its first transaction is open
    (two incremental rebalances under an open transaction, whose revoke
    the first member must answer inside the mock's 3 s window: a JIT
    compile in a first transaction can outlast it), else all at once.  Once half the input is copied
    member ``leaver`` closes (a cooperative leave), then, given the mock
    ``cluster``, one more member joins in the same rebalance.  Returns
    the copiers, the seconds from the leave until the live members own
    every partition, the rebalance callbacks and the copy's times;
    raises if a member failed or the copy did not end."""
    leg = EosLeg(kit, name, bootstrap, hwm, backend, producer_extra or {},
                 txn_records, abort_every, exact)
    copiers = [EosCopier(leg, k) for k in range(members)]
    # the joiner's clients are made and warm before the leave
    new = (EosCopier(leg, members)
           if leaver is not None and cluster is not None else None)
    total = sum(hwm.values())
    parts = set(hwm)

    def covered(live) -> bool:
        with leg.lock:
            owned = [c.assigned for c in live]
        return (set().union(*owned) == parts
                and sum(map(len, owned)) == len(parts))
    t0 = time.monotonic()
    for c in copiers:
        c.start()
    # staggered, the others' join is two incremental rebalances under
    # the first member's open transactions
    for c in copiers[:1 if stagger else members]:
        c.go.set()
    if new is not None:
        new.start()
        copiers.append(new)
    rebalance_s = None
    t_leave = None
    try:
        eos_wait(lambda: leg.t_begin is not None or leg.done.is_set(),
                 "the first transaction", timeout, leg)
        for c in copiers[1:members]:
            c.go.set()
        if leaver is not None:
            eos_wait(lambda: leg.copied() * 2 >= total or leg.done.is_set(),
                     "half the input copied", timeout, leg)
            t_leave = time.monotonic()
            if new is not None:
                # the leave and the join in one rebalance, the joiner
                # taking the leaver's unfinished partitions: in a later
                # rebalance the sticky strip would hand it a survivor's
                # lowest-numbered partitions, which a consumer draining a
                # partition at a time has mostly copied.  The mock holds
                # the generation open until P10_HOLD_S after the leave,
                # as a broker's group.initial.rebalance.delay.ms holds a
                # new group's first.
                g = cluster.groups[f"eos-copy-{name}"]
                with cluster._lock:
                    g.hold_until = time.monotonic() + P10_HOLD_S
            copiers[leaver].leave.set()
            live = [c for c in copiers if c.k != leaver]
            if new is not None:
                new.go.set()
                eos_wait(lambda: g.state == "PreparingRebalance"
                         or leg.done.is_set(), "the leave's rebalance",
                         timeout, leg)
                with cluster._lock:
                    g.rebalance_deadline = min(g.rebalance_deadline,
                                               g.hold_until)
            eos_wait(lambda: ((new is None or new.assigned)
                              and covered(live)) or leg.done.is_set(),
                     "the rebalances", timeout, leg)
            rebalance_s = time.monotonic() - t_leave
        leg.done.wait(max(0.0, timeout - (time.monotonic() - t0)))
    finally:
        leg.done.set()
        for c in copiers:
            c.join(60)
    wall = time.monotonic() - t0
    errs = [c.error for c in copiers if c.error]
    if errs:
        raise EosError(f"leg {name}: a copier failed:\n" + "\n".join(errs))
    if any(c.is_alive() for c in copiers):
        raise EosError(f"leg {name}: a copier did not exit")
    if leg.copied() != total:
        raise EosError(f"leg {name}: committed {leg.committed} of {hwm}")
    # the generations that moved partitions while transactions were open,
    # and those of them after the leave
    moved = {e[4]: e[0] for e in leg.events
             if e[3] and leg.t_begin is not None and e[0] >= leg.t_begin}
    after = {g for g, t in moved.items()
             if t_leave is not None and t >= t_leave}
    # the copy's own time: first assignment to the last commit
    copy_s = leg.t_done - min(e[0] for e in leg.events)
    return {"copiers": copiers, "rebalance_s": rebalance_s, "wall_s": wall,
            "copy_s": copy_s, "events": list(leg.events),
            "rebalances": len(moved), "after_leave": len(after),
            "t_leave": t_leave or t0, "t0": t0}


def eos_read(kit, bootstrap: str, backend: dict, parts: int, n: int,
             name: str) -> dict:
    """10c: a read_committed check.crcs Consumer reads eos-out from the
    beginning: every record it returns, as (partition, key, value,
    copier), with its engine and the regions its fetch verify handed the
    CRC ticket."""
    c = kit.Consumer({"bootstrap.servers": bootstrap,
                      "group.id": f"eos-verify-{name}",
                      "isolation.level": "read_committed",
                      "check.crcs": True, "auto.offset.reset": "earliest",
                      **backend})
    try:
        eos_warm(c)
        regions = eos_count_control(c)
        c.assign([kit.TopicPartition(EOS_OUT, i, OFFSET_BEGINNING)
                  for i in range(parts)])
        got: list = []
        deadline = time.monotonic() + 120
        quiet_until = None
        while quiet_until is None or time.monotonic() < quiet_until:
            if time.monotonic() > deadline:
                raise EosError(f"eos-out {name}: read {len(got)} of {n}")
            for m in c.consume(10_000, 0.1):
                if m.error is not None:
                    raise EosError(f"eos-out {name}: {m.error}")
                got.append((m.partition, m.key, m.value,
                            dict(m.headers or []).get("copier")))
            if quiet_until is None and len(got) >= n:
                quiet_until = time.monotonic() + 0.5   # nothing more
        return {"records": got, "engine": eos_snapshot(eos_engine(c)),
                "regions": regions[0], "control_regions": regions[1]}
    finally:
        c.close()


def eos_exactly_once(vals, got: list) -> None:
    """Every input record appears once in what was read, in its input
    partition, and nothing else does."""
    per = len(vals[0])
    want = {eos_key(i, j, per): (i, v) for i, vs in enumerate(vals)
            for j, v in enumerate(vs)}
    seen: dict = {}
    for part, key, value, _who in got:
        if want.get(key) != (part, value):
            raise EosError(f"eos-out: a record no input has: {key!r} in "
                           f"partition {part}")
        seen[key] = seen.get(key, 0) + 1
    dup = [k for k, c in seen.items() if c > 1]
    if dup or len(seen) != len(want):
        raise EosError(f"eos-out: {len(dup)} records twice, "
                       f"{len(want) - len(seen)} missing")


def eos_stored(cluster, parts: int, det: bool | None) -> dict:
    """Every stored batch of eos-out: its CRC == the native crc32c of its
    region, every data batch transactional lz4 whose frame == the native
    encoder's (``det``: the deterministic one; None: not compared), every
    control batch counted by type."""
    from librdkafka_tpu_torch.protocol.msgset import (iter_batches,
                                                      parse_records_v2)
    from librdkafka_tpu_torch.protocol.proto import CTRL_ABORT
    out = {"data": 0, "commit": 0, "abort": 0}
    for i in range(parts):
        infos, regions, frames = [], [], []
        for _base, blob in cluster.partition(EOS_OUT, i).log:
            for info, payload, full in iter_batches(blob):
                infos.append(info)
                regions.append(bytes(full[V2_OF_Attributes:]))
                if info.is_control:
                    key = parse_records_v2(info, payload)[0].key
                    # the control record's key: version i16, type i16
                    kind = ("abort" if int.from_bytes(key[2:4], "big")
                            == CTRL_ABORT else "commit")
                    out[kind] += 1
                    continue
                if not (info.is_transactional and info.codec == "lz4"):
                    raise EosError(f"eos-out[{i}]: a data batch is not "
                                   f"transactional lz4 ({info.codec})")
                frames.append(bytes(payload))
                out["data"] += 1
        if native.crc32c_many(regions).tolist() != [x.crc for x in infos]:
            raise EosError(f"eos-out[{i}]: a batch CRC != the native crc32c")
        if det is not None and frames:
            raws = native.lz4f_decompress_many(frames, None)
            enc = (det_frames(raws) if det
                   else native.lz4f_compress_many(raws))
            if enc != frames:
                raise EosError(f"eos-out[{i}]: an lz4 frame != the native "
                               f"{'deterministic' if det else 'default'} "
                               "encoder's")
    return out


def live_children() -> set:
    """Pids of this process's children that have not exited."""
    me, out = str(os.getpid()), set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                st = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if st[1] == me and st[0] != "Z":
            out.add(int(d))
    return out


def p10_leg(tag: str, extra: dict, vals, cluster, hwm: dict,
            device: str, txn_records: int) -> dict:
    """10b and 10c for one leg on the card: the copy, its figures, then
    every check of the phase; returns the leg's launches and figures."""
    parts = len(vals)
    backend = {"compression.backend": "gpu", "gpu.device": device, **P6_GPU}
    boot = cluster.bootstrap_servers()
    crc.launches = 0
    lz4.launches = 0
    res = eos_copy(port_kit(), tag, boot, hwm, backend, extra,
                   txn_records=txn_records, cluster=cluster)
    copy_crc, copy_lz4 = crc.launches, lz4.launches
    copiers = res["copiers"]
    n = sum(hwm.values())
    rate = n / res["copy_s"]
    read = eos_read(port_kit(), boot, backend, parts, n, tag)
    counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
    dev = bool(extra)
    stored = eos_stored(cluster, parts, det=dev)
    lat = sorted(x for cp in copiers for x in cp.commit_ms)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    print(f"phase 10{tag}: {'gpu.compress.device' if dev else 'CRC tickets'}"
          f": {n} records, {len(copiers)} members (txns, commits, aborts, "
          f"aborts on a new generation, partitions at the end: "
          f"{[(cp.txns, cp.commits, cp.aborts, cp.fenced, len(cp.assigned)) for cp in copiers]}"
          f"), {res['rebalances']} incremental rebalances while "
          f"transactions were open ({res['after_leave']} after the leave); "
          f"eos-out "
          f"{stored}")
    print(f"  copy {rate:.1f} msgs/s ({res['copy_s']:.3f} s from the first "
          f"assignment, {res['wall_s']:.3f} s with set-up; leave and join "
          f"at {res['t_leave'] - res['t0']:.3f} s); commit "
          f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms over {len(lat)}; "
          f"rebalance wall time (leave and join until every partition is "
          f"owned again) {res['rebalance_s']:.3f} s")
    print("  rebalance callbacks (s from the leave, member, kind, "
          "partitions, generation): " + str(
              [(round(e[0] - res["t_leave"], 3), e[1], e[2], e[3], e[4])
               for e in res["events"] if e[3]]))
    print(f"  launches: crc_rows {counts['crc_rows']} (copy {copy_crc}), "
          f"lz4_rows {counts['lz4_rows']} (copy {copy_lz4}); copier "
          f"consumers' CRC launches "
          f"{[cp.engines['consumer']['stats']['launches'] for cp in copiers]}"
          f", producers' "
          f"{[(cp.engines['producer']['stats']['launches'] - cp.engines['producer_crc0'], cp.engines['producer']['compress']['launches']) for cp in copiers]}"
          f" (crc, lz4); verifier {read['engine']['stats']['launches']} over "
          f"{read['regions']} regions, {read['control_regions']} of them "
          f"control batches")
    eos_exactly_once(vals, read["records"])
    g = cluster.groups[f"eos-copy-{tag}"]
    offs = {q: g.offsets.get((EOS_IN, q), (-1,))[0] for q in hwm}
    check(offs == hwm, f"10{tag}: committed offsets != eos-in's ends: "
          f"{ {q: (offs[q], hwm[q]) for q in hwm if offs[q] != hwm[q]} }")
    # the mock books a generation's owners at the leader's SyncGroup; a
    # member whose own SyncGroup then meets the next rebalance never
    # received those partitions, yet stays booked as their owner.  A flag
    # is a fault only if the old owner had applied the partition.
    real = [e for e in g.validation_errors
            if e["kind"] != "moved_without_revoke"
            or e["partition"] in eos_applied(res["events"], e)]
    check(not real, f"10{tag}: a partition moved from a member that held "
          f"it, without a revoke: {real[:3]}")
    if g.validation_errors:
        print(f"  the mock's ownership book flagged {len(g.validation_errors)}"
              f" move(s) from a member that never received the partition "
              f"(its SyncGroup met the next rebalance): "
              f"{g.validation_errors[:2]}")
    for cp in copiers:
        ce, pe = cp.engines["consumer"], cp.engines["producer"]
        check(ce["stats"]["launches"] > 0,
              f"10{tag}: copier {cp.k}'s consumer made no CRC launch")
        for eng_snap, what in ((ce, "consumer"), (pe, "producer")):
            bad = {k: eng_snap["stats"][k] for k in (
                "warmup_miss_jobs", "routed_cpu_jobs", "cpu_fallback_jobs")
                if eng_snap["stats"][k]}
            if dev and what == "producer":
                bad.update({k: eng_snap["compress"][k] for k in (
                    "cpu_jobs", "warmup_miss_jobs", "routed_cpu_jobs",
                    "shed_jobs") if eng_snap["compress"][k]})
            check(not bad, f"10{tag}: copier {cp.k}'s {what} served jobs on "
                  f"the CPU: {bad}")
        if dev:
            check(pe["compress"]["launches"] > 0,
                  f"10{tag}: copier {cp.k}'s producer made no LZ4 launch")
            check(pe["stats"]["launches"] == cp.engines["producer_crc0"],
                  f"10{tag}: copier {cp.k}'s producer made CRC launches "
                  "(its batch CRCs fold from the frames)")
        else:
            check(pe["stats"]["launches"] > cp.engines["producer_crc0"],
                  f"10{tag}: copier {cp.k}'s producer made no CRC launch")
        check(cp.aborts >= 1, f"10{tag}: copier {cp.k} never aborted")
    check(read["engine"]["stats"]["launches"] > 0
          and read["control_regions"] > 0,
          f"10{tag}: the verifier made {read['engine']['stats']['launches']}"
          f" CRC launches over {read['control_regions']} control regions")
    check(not any(read["engine"]["stats"][k] for k in (
        "warmup_miss_jobs", "routed_cpu_jobs", "cpu_fallback_jobs")),
        f"10{tag}: the verifier served jobs on the CPU")
    check(res["rebalances"] >= 2 and res["after_leave"] >= 1,
          f"10{tag}: {res['rebalances']} incremental rebalances while "
          f"transactions were open ({res['after_leave']} after the leave), "
          "not at least 2 (1)")
    check(stored["abort"] >= sum(cp.aborts for cp in copiers),
          f"10{tag}: {stored['abort']} ABORT markers for "
          f"{sum(cp.aborts for cp in copiers)} cadence aborts")
    if dev:
        check(copy_lz4 > 0, f"10{tag}: no LZ4 launch in the copy")
    return {"counts": counts, "rate": rate, "p50": p50, "p99": p99}


def phase_eos(smi: str, parts: int = PARTITIONS,
              per_part: int = P10_PER_PART, device: str = "cuda",
              txn_records: int = P10_TXN) -> dict:
    """Phase 10: the exactly-once copy (10a seed, 10b two legs of
    copiers, 10c verify) on the card.  Returns its launches."""
    import gc
    t0 = time.perf_counter()
    children0 = live_children()
    flat = payloads(parts * per_part, VALUE_SIZE)
    vals = [flat[i * per_part:(i + 1) * per_part] for i in range(parts)]
    kit = port_kit()
    legs = {}
    for tag, extra in (("a", {}), ("b", {"gpu.compress.device": True})):
        cluster = kit.MockCluster(num_brokers=1,
                                  topics={EOS_IN: parts, EOS_OUT: parts})
        try:
            eos_seed(kit, cluster.bootstrap_servers(), vals,
                     {"compression.backend": "gpu", "gpu.device": device,
                      **P6_GPU})
            hwm = {i: cluster.partition(EOS_IN, i).end_offset
                   for i in range(parts)}
            check(hwm == {i: per_part for i in range(parts)},
                  f"10a: eos-in's ends {set(hwm.values())}")
            legs[tag] = p10_leg(tag, extra, vals, cluster, hwm, device,
                                txn_records)
        finally:
            cluster.stop()
    gc.collect()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and [
            t for t in threading.enumerate() if "engine" in t.name]:
        time.sleep(0.05)
    left = [t.name for t in threading.enumerate() if "engine" in t.name
            or t.name.startswith("eos-copier")]
    check(not left, f"phase 10: threads left after close(): {left}")
    kids = live_children() - children0
    check(not kids, f"phase 10: child processes left: {kids}")
    secs = time.perf_counter() - t0
    print(f"  {smi}")
    check(secs <= P10_LIMIT_S, f"phase 10 took {secs:.3f} s, over its "
          f"{P10_LIMIT_S} s")
    print(f"phase 10: ok ({secs:.3f} s: 10a seed, 10b copy and 10c verify "
          f"on two legs, {parts} x {per_part} x {VALUE_SIZE} B)")
    return {k: sum(leg["counts"][k] for leg in legs.values())
            for k in ("crc_rows", "lz4_rows")}


# --------------------------------------------------------------- phase 11 --

P11_PER_PART = 1600
P11_LIMIT_S = 60
#: explicit record timestamps start here, above any wall clock, so each
#: batch's max timestamp is its last explicit one (offsets_for_times)
P11_TS0 = 4_000_000_000_000
#: records in each error-DR case
P11_ERR = 64
#: the main topic's leader, the follower of its even partitions, and the
#: broker the error-DR topics live on (the one the mock holds back)
P11_LEADER, P11_FOLLOWER, P11_ERR_BROKER = 1, 2, 3
#: seconds Kafka.close() may take past its flush: a wedged broker
#: thread's 2 s join, the main thread's, the engine's drain
P11_CLOSE_S = 5.0


class ApiError(RuntimeError):
    """Phase 11 (the delivery path and the consumer's API) broke one of
    its checks."""


def p11_check(cond: bool, msg: str) -> None:
    if not cond:
        raise ApiError(msg)


def p11_record(i: int, j: int, per: int, value: bytes) -> dict:
    """Record j of partition i as a produce_batch dict: keyed by its
    global index; every 4th (j % 4 == 1) carries headers, every 4th
    (j % 4 == 2) an explicit timestamp."""
    g = i * per + j
    m = {"value": value, "key": b"%08d" % g, "partition": i}
    if j % 4 == 1:
        m["headers"] = [("idx", b"%d" % g), ("nil", None)]
    elif j % 4 == 2:
        m["timestamp"] = P11_TS0 + g
    return m


def p11_same(rec, i: int, j: int, vals) -> bool:
    """Whether ``rec`` (a Message or a parsed Record) at offset j of
    partition i is the record produced there: key, value, headers, and
    the explicit timestamp where it has one."""
    per = len(vals[0])
    if not 0 <= j < per:
        return False
    want = p11_record(i, j, per, vals[i][j])
    return (rec.key == want["key"] and rec.value == want["value"]
            and list(rec.headers or ()) == want.get("headers", [])
            and rec.timestamp == want.get("timestamp", rec.timestamp))


def p11_cluster(kit, tag: str, parts: int):
    """Three in-process brokers: the main topic p11-<tag>, every
    partition led by broker 1 (broker 2 becomes the follower of the even
    ones in 11b), and broker 3 for the error-DR topics."""
    cluster = kit.MockCluster(num_brokers=3, topics={f"p11-{tag}": parts},
                              auto_create_topics=False)
    for i in range(parts):
        cluster.set_partition_leader(f"p11-{tag}", i, P11_LEADER)
    return cluster


def p11_topic_known(client, topic: str) -> None:
    """Wait for the client's metadata to know ``topic``'s partitions."""
    client.rk.get_topic(topic)
    deadline = time.monotonic() + 30
    while client.rk.topics[topic].partition_cnt <= 0:
        p11_check(time.monotonic() < deadline, f"{topic}: no metadata")
        client.poll(0.05)


def p11_stored(cluster, topic: str, vals, det: bool | None) -> dict:
    """Every stored batch of the main topic: its CRC == the native
    crc32c of its region, its frame == the native encoder's (the
    deterministic one when ``det``; None: not compared), its records
    the produced ones at their offsets with their headers and explicit
    timestamps, one idempotent producer id and epoch, base sequences
    running on.  Returns each partition's [(base offset, records)] and
    [(base offset, max timestamp)]."""
    from librdkafka_tpu_torch.protocol.msgset import (iter_batches,
                                                      parse_records_v2)
    per = len(vals[0])
    out = {"batches": [], "max_ts": []}
    pids = set()
    for i in range(len(vals)):
        infos, frames, regions = [], [], []
        for _base, blob in cluster.partition(topic, i).log:
            for info, payload, full in iter_batches(blob):
                p11_check(info.magic == 2 and info.codec == "lz4",
                          f"{topic}[{i}]: a batch is magic {info.magic} "
                          f"codec {info.codec}")
                infos.append(info)
                frames.append(bytes(payload))
                regions.append(bytes(full[V2_OF_Attributes:]))
        p11_check(native.crc32c_many(regions).tolist()
                  == [x.crc for x in infos],
                  f"{topic}[{i}]: a batch CRC != the native crc32c")
        raws = native.lz4f_decompress_many(frames, None)
        if det is not None:
            enc = (det_frames(raws) if det
                   else native.lz4f_compress_many(raws))
            p11_check(enc == frames, f"{topic}[{i}]: an lz4 frame != the "
                      f"native {'deterministic' if det else 'default'} "
                      "encoder's")
        nxt = 0
        for info, raw in zip(infos, raws):
            p11_check(info.base_sequence == nxt and info.base_offset == nxt,
                      f"{topic}[{i}]: batch at offset {info.base_offset}, "
                      f"sequence {info.base_sequence}, after {nxt} records")
            pids.add((info.producer_id, info.producer_epoch))
            for r in parse_records_v2(info, raw):
                p11_check(p11_same(r, i, r.offset, vals),
                          f"{topic}[{i}]: stored record at offset "
                          f"{r.offset} != produced")
            nxt += info.record_count
        p11_check(nxt == per, f"{topic}[{i}]: {nxt} records stored of {per}")
        out["batches"].append([(x.base_offset, x.record_count)
                               for x in infos])
        out["max_ts"].append([(x.base_offset, x.max_timestamp)
                              for x in infos])
    p11_check(len(pids) == 1 and next(iter(pids))[0] >= 0,
              f"{topic}: producer id/epoch not one idempotent pair: {pids}")
    return out


def p11_no_cpu(snap: dict | None, what: str, compress: bool) -> None:
    """An engine snapshot of a counted client: no job on a CPU route."""
    if snap is None:
        return
    bad = {k: snap["stats"][k] for k in (
        "warmup_miss_jobs", "routed_cpu_jobs", "cpu_fallback_jobs")
        if snap["stats"][k]}
    if compress:
        bad.update({k: snap["compress"][k] for k in (
            "cpu_jobs", "warmup_miss_jobs", "routed_cpu_jobs", "shed_jobs")
            if snap["compress"][k]})
    p11_check(not bad, f"{what}: jobs served on the CPU: {bad}")


def p11_wait(client, cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        p11_check(time.monotonic() < deadline, f"timed out: {what}")
        client.poll(0.05)


def p11_delivery(kit, cluster, vals, backend: dict, tag: str,
                 det: bool | None = None, chunk: int = 100) -> dict:
    """11a: an idempotent lz4 Producer with dr_msg_cb and dr_batch_cb
    sends every record of ``vals`` through produce_batch (a quarter with
    headers, a quarter with explicit timestamps) and flush()es; every DR
    must have been served when flush() returns 0, each success DR the
    produced record at its stored offset, each DR batch a stored batch.
    Then the error DRs on broker 3's topics: a mixed produce_batch with
    an unknown partition (per-message errors), a message.timeout.ms
    expiry while the mock holds the broker down, and purge(in_flight)
    while the mock holds a request."""
    parts, per = len(vals), len(vals[0])
    n = parts * per
    topic = f"p11-{tag}"
    bad: list = []
    seen = {"ok": 0, "batch": 0}
    other: dict = {}            # topic -> [(error name, value, offset)]
    other_batch: dict = {}      # topic -> records in dr_batch_cb
    dr_batches = [[] for _ in range(parts)]

    def on_msg(err, m):
        if m.topic != topic:
            other.setdefault(m.topic, []).append(
                (None if err is None else err.code.name, m.value, m.offset))
            return
        if err is not None or not p11_same(m, m.partition, m.offset, vals):
            bad.append((err, m.partition, m.offset))
        seen["ok"] += 1

    def on_batch(msgs):
        if msgs and msgs[0].topic != topic:
            other_batch[msgs[0].topic] = (other_batch.get(msgs[0].topic, 0)
                                          + len(msgs))
            return
        offs = [m.offset for m in msgs]
        parts_of = {m.partition for m in msgs}
        if (len(parts_of) != 1 or offs != list(range(offs[0],
                                                     offs[0] + len(offs)))
                or any(m.error is not None for m in msgs)):
            bad.append(("batch", sorted(parts_of), offs[:3]))
        else:
            dr_batches[msgs[0].partition].append((offs[0], len(offs)))
        seen["batch"] += len(msgs)

    p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "enable.idempotence": True, "compression.codec": "lz4",
                      "linger.ms": 5, "queue.buffering.max.messages":
                      1_000_000, "dr_msg_cb": on_msg, "dr_batch_cb": on_batch,
                      **backend})
    try:
        eos_warm(p)
        eng = eos_engine(p)
        s0 = eos_snapshot(eng)
        msgs = [[p11_record(i, j, per, vals[i][j]) for j in range(per)]
                for i in range(parts)]
        queued = 0
        t0 = time.perf_counter()
        for c0 in range(0, per, chunk):
            for i in range(parts):
                queued += p.produce_batch(topic, msgs[i][c0:c0 + chunk])
        left = p.flush(300)
        secs = time.perf_counter() - t0
        served = dict(seen)
        s1 = eos_snapshot(eng)
        p11_check(queued == n and not any("error" in m for ms in msgs
                                          for m in ms),
                  f"11a {tag}: produce_batch queued {queued} of {n}")
        p11_check(left == 0, f"11a {tag}: flush() left {left}")
        p11_check(served == {"ok": n, "batch": n},
                  f"11a {tag}: flush() returned 0 with DRs {served} of {n}")
        p11_check(not bad, f"11a {tag}: DRs != produced: {bad[:3]}")
        stored = p11_stored(cluster, topic, vals, det)
        p11_check([sorted(b) for b in dr_batches] == stored["batches"],
                  f"11a {tag}: DR batches != stored batches")
        errs = p11_error_drs(p, cluster, tag, other, other_batch)
        s2 = eos_snapshot(eng)
    finally:
        p.close()
    compress = bool(s1 and s1["compress"]["launches"])
    p11_no_cpu(s2, f"11a {tag} producer", compress)
    return {"rate": n / secs, "secs": secs, "batches":
            sum(map(len, stored["batches"])), "errors": errs,
            "max_ts": stored["max_ts"],
            "crc": s1 and s1["stats"]["launches"] - s0["stats"]["launches"],
            "lz4": s1 and (s1["compress"]["launches"]
                           - s0["compress"]["launches"]),
            "fused": s1 and s1["compress"]["fused_crc"]}


def p11_error_drs(p, cluster, tag: str, other: dict,
                  other_batch: dict) -> dict:
    """The error DRs of 11a, each per message with its payload: an
    unknown partition in a mixed produce_batch (the dict's error), a
    message.timeout.ms expiry (_MSG_TIMED_OUT) while broker 3 is down, a
    purge(in_flight) (_PURGE_INFLIGHT) while broker 3 holds a request."""
    out = {}
    vals = [b"err-%s-%03d " % (tag.encode(), k) * 8 for k in range(P11_ERR)]
    # a mixed batch: every third record to a partition the topic lacks
    mixed = f"p11x-mixed-{tag}"
    cluster.create_topic(mixed, 2)
    p11_topic_known(p, mixed)
    msgs = [{"value": v, "partition": k % 2 if k % 3 else 7 + k}
            for k, v in enumerate(vals)]
    queued = p.produce_batch(mixed, msgs)
    p11_check(p.flush(60) == 0, f"11a {tag}: {mixed} did not drain")
    errs = [(m.get("error") and m["error"].code.name, m["value"])
            for m in msgs]
    good = [v for k, v in enumerate(vals) if k % 3]
    p11_check(queued == len(good)
              and errs == [(None if k % 3 else "_UNKNOWN_PARTITION", v)
                           for k, v in enumerate(vals)],
              f"11a {tag}: mixed produce_batch queued {queued}, errors "
              f"{errs[:3]}")
    p11_check(sorted((str(e), v) for e, v, _o in other.get(mixed, []))
              == sorted(("None", v) for v in good),
              f"11a {tag}: the mixed batch's DRs != its good records")
    out["mixed"] = {"queued": queued, "unknown": len(vals) - queued}
    # message.timeout.ms expiry: the partition's leader is held down
    exp = f"p11x-exp-{tag}"
    cluster.create_topic(exp, 1)
    cluster.set_partition_leader(exp, 0, P11_ERR_BROKER)
    p.set_topic_conf(exp, {"message.timeout.ms": 500})
    cluster.set_broker_down(P11_ERR_BROKER)
    try:
        p.produce_batch(exp, [{"value": v, "partition": 0} for v in vals])
        p11_wait(p, lambda: len(other.get(exp, [])) >= len(vals),
                 f"11a {tag}: expiry DRs")
    finally:
        cluster.set_broker_down(P11_ERR_BROKER, False)
    got = other[exp]
    p11_check([(e, v) for e, v, _o in got]
              == [("_MSG_TIMED_OUT", v) for v in vals]
              and all(o < 0 for _e, _v, o in got),
              f"11a {tag}: expiry DRs {got[:2]}")
    out["expired"] = len(got)
    # purge(in_flight): a request the mock holds on broker 3
    pg = f"p11x-purge-{tag}"
    cluster.create_topic(pg, 1)
    cluster.set_partition_leader(pg, 0, P11_ERR_BROKER)
    p.produce(pg, value=b"warm", partition=0)
    p11_check(p.flush(60) == 0, f"11a {tag}: {pg} did not drain")
    with p.rk._brokers_lock:
        held = [b for b in p.rk.brokers.values()
                if b.nodeid == P11_ERR_BROKER]
    cluster.pause_broker(P11_ERR_BROKER)
    try:
        p.produce_batch(pg, [{"value": v, "partition": 0} for v in vals])
        p11_wait(p, lambda: any(b.waitresp for b in held),
                 f"11a {tag}: no request in flight to broker 3")
        t0 = time.monotonic()
        p.purge(in_queue=True, in_flight=True)
        left = p.flush(10)
        purge_s = time.monotonic() - t0
        p11_wait(p, lambda: len(other.get(pg, [])) >= len(vals) + 1,
                 f"11a {tag}: purge DRs")
    finally:
        cluster.resume_broker(P11_ERR_BROKER)
    got = other[pg][1:]
    codes = {e for e, _v, _o in got}
    p11_check(left == 0 and purge_s < 5.0, f"11a {tag}: flush() after "
              f"purge left {left} in {purge_s:.3f} s")
    p11_check(other[pg][0][0] is None and [v for _e, v, _o in got] == vals
              and codes <= {"_PURGE_INFLIGHT", "_PURGE_QUEUE"}
              and "_PURGE_INFLIGHT" in codes,
              f"11a {tag}: purge DRs {sorted(codes, key=str)}")
    out["purged"] = {c: sum(1 for e, _v, _o in got if e == c)
                     for c in sorted(codes)}
    n_err = {t: len(v) for t, v in other.items()}
    p11_check(other_batch == n_err, f"11a {tag}: dr_batch_cb saw "
              f"{other_batch}, dr_msg_cb {n_err}")
    return out


class P11Reader:
    """11b's delivery book: each partition's next offset, held exact
    through pause, seek and restart; every record's key, value, headers
    and explicit timestamp checked against what was produced."""

    def __init__(self, vals, topic: str):
        self.vals, self.topic = vals, topic
        # a fortieth of the records a call, so each stage of 11b starts
        # close to its mark
        self.chunk = max(10, min(10_000, len(vals) * len(vals[0]) // 40))
        self.nxt = [0] * len(vals)
        self.delivered = 0

    def progress(self) -> int:
        return sum(self.nxt)

    def take(self, msgs) -> None:
        for m in msgs:
            p11_check(m.error is None, f"11b {self.topic}: {m.error}")
            i, j = m.partition, self.nxt[m.partition]
            # a stale batch (fetched before a seek) or a duplicate shows
            # as an offset other than the partition's next
            p11_check(m.offset == j and p11_same(m, i, j, self.vals),
                      f"11b {self.topic}[{i}]: offset {m.offset} delivered "
                      f"where {j} was next, or its record != produced")
            self.nxt[i] = j + 1
            self.delivered += 1

    def read_to(self, c, target: int, timeout: float = 120.0) -> None:
        """consume(num_messages=...) until the book reaches ``target``."""
        deadline = time.monotonic() + timeout
        while self.progress() < target:
            p11_check(time.monotonic() < deadline, f"11b {self.topic}: "
                      f"{self.progress()} of {target} records read")
            self.take(c.consume(num_messages=self.chunk, timeout=0.5))


def p11_fetches(cluster, since: int, broker: int) -> int:
    """Fetch requests broker ``broker`` took since request_log[since]."""
    from librdkafka_tpu_torch.protocol.proto import ApiKey
    return sum(1 for b, api in cluster.request_log[since:]
               if b == broker and api == int(ApiKey.Fetch))


def p11_consume(kit, cluster, vals, backend: dict, tag: str, store: str,
                max_ts) -> dict:
    """11b: a check.crcs Consumer with client.rack reads 11a's records
    with consume(num_messages=...) from the follower of the even
    partitions (the odd ones from the leader), pauses and resumes half
    the partitions, withdraws the follower midway (reading goes back to
    the leader), seeks the quarter of the partitions furthest read back
    by 3/16 of a partition (300 records of 1,600) with fetch tickets
    parked, looks offsets up by stored timestamps, commits to the file
    store at 80 % and closes; a second Consumer resumes from the files.
    Every record after each seek point exactly once, in order, headers
    and timestamps as produced."""
    parts, per = len(vals), len(vals[0])
    n = parts * per
    topic = f"p11-{tag}"
    TP = kit.TopicPartition
    rewind = per * 3 // 16
    evens = [i for i in range(parts) if i % 2 == 0]
    odds = [i for i in range(parts) if i % 2]
    for i in evens:
        cluster.set_follower(topic, i, P11_FOLLOWER)
    conf = {"bootstrap.servers": cluster.bootstrap_servers(),
            "group.id": f"p11-{tag}", "check.crcs": True,
            "client.rack": "rack-b", "fetch.wait.max.ms": 50,
            # about a twelfth of the topic fetched ahead, so the leader
            # serves the half after the follower is withdrawn
            "queued.max.messages.kbytes": max(
                64, n * len(vals[0][0]) // 1024 // 12),
            "enable.auto.commit": False, "auto.offset.reset": "earliest",
            "offset.store.method": "file", "offset.store.path": store,
            "offset.store.sync.interval.ms": 0, **backend}
    book = P11Reader(vals, topic)
    out: dict = {}
    c = kit.Consumer(conf)
    try:
        eos_warm(c)
        eng = eos_engine(c)
        p11_check(c._rk.fetch_pipeline_depth >= 2, f"11b {tag}: fetch "
                  f"pipeline depth {c._rk.fetch_pipeline_depth}")
        s0 = eos_snapshot(eng)
        log0 = len(cluster.request_log)
        t0 = time.perf_counter()
        c.assign([TP(topic, i) for i in range(parts)])
        book.read_to(c, n // 5)
        c.pause([TP(topic, i) for i in odds])
        book.read_to(c, n * 7 // 20)
        c.resume([TP(topic, i) for i in odds])
        book.read_to(c, n // 2)
        # the follower withdrawn: NOT_LEADER from broker 2, back to 1
        with c._rk._brokers_lock:
            brokers = list(c._rk.brokers.values())
        out["delegated"] = sum(
            1 for i in evens
            if c._rk.get_toppar(topic, i, create=False).fetch_broker_id
            == P11_FOLLOWER)
        for i in evens:
            cluster.set_follower(topic, i, None)
        t1 = time.perf_counter()
        log1 = len(cluster.request_log)
        s1 = eos_snapshot(eng)
        d1 = book.delivered
        book.read_to(c, n * 3 // 5)
        # a quarter of the partitions rewound while fetched partitions
        # wait in the verify pipeline (their tickets in flight)
        deadline = time.monotonic() + 5
        while (not any(b._fetch_pending for b in brokers)
               and time.monotonic() < deadline):
            book.take(c.consume(num_messages=max(1, book.chunk // 10),
                                timeout=0.05))
        out["parked"] = sum(len(b._fetch_pending) for b in brokers)
        # the consumer drains the lowest-numbered partitions first: seek
        # the quarter that has read the most
        sought = sorted(range(parts), key=lambda i: -book.nxt[i])[
            :max(1, parts // 4)]
        p11_check(all(book.nxt[i] > 0 for i in sought),
                  f"11b {tag}: a partition to seek had no record read: "
                  f"{book.nxt}")
        out["rewound"] = 0
        for i in sought:
            s = max(0, book.nxt[i] - rewind)
            out["rewound"] += book.nxt[i] - s
            book.nxt[i] = s
            c.seek(TP(topic, i, s))
        # offsets_for_times on stored timestamps: the earliest stored
        # batch whose max timestamp reaches the target
        sample = sorted({0, parts // 2, parts - 1})
        targets = {i: P11_TS0 + i * per + (per // 2 // 4) * 4 + 2
                   for i in sample}
        want = {i: next(b for b, mts in max_ts[i] if mts >= targets[i])
                for i in sample}
        got = {r.partition: r.offset for r in c.offsets_for_times(
            [TP(topic, i, targets[i]) for i in sample], timeout=10)}
        p11_check(got == want, f"11b {tag}: offsets_for_times {got} != "
                  f"the stored batches' {want}")
        book.read_to(c, n * 4 // 5)

        def delegated():
            return [i for i in evens if c._rk.get_toppar(
                topic, i, create=False).fetch_broker_id is not None]
        # a partition reverts at its next fetch to the withdrawn follower
        # (NOT_LEADER); one whose records were all fetched ahead may not
        # have fetched since
        deadline = time.monotonic() + 15
        while delegated() and time.monotonic() < deadline:
            book.take(c.consume(num_messages=max(1, book.chunk // 10),
                                timeout=0.1))
        # the positions the book holds (after a seek the consumer's own
        # stored offset is still past the last record delivered)
        c.commit(offsets=[TP(topic, i, book.nxt[i]) for i in range(parts)],
                 asynchronous=False)
        committed = {r.partition: r.offset for r in c.committed(
            [TP(topic, i) for i in range(parts)])}
        files = {}
        for i in range(parts):
            with open(os.path.join(store, f"{topic}-{i}.offset")) as f:
                files[i] = int(f.read().strip())
        p11_check(committed == files == dict(enumerate(book.nxt)),
                  f"11b {tag}: committed offsets != the file store != "
                  f"the positions read")
        t2 = time.perf_counter()
        d2 = book.delivered
        log2 = len(cluster.request_log)
        s2 = eos_snapshot(eng)
        stuck = delegated()
    finally:
        c.close()
    p11_check(not stuck, f"11b {tag}: partitions {stuck[:4]} still fetch "
              "from the follower")
    c2 = kit.Consumer(conf)
    try:
        eos_warm(c2)
        eng2 = eos_engine(c2)
        s3 = eos_snapshot(eng2)
        t3 = time.perf_counter()
        c2.assign([TP(topic, i) for i in range(parts)])
        book.read_to(c2, n)
        t4 = time.perf_counter()
        s4 = eos_snapshot(eng2)
        extra = c2.consume(num_messages=100, timeout=0.5)
        p11_check(not [m for m in extra if m.error is None],
                  f"11b {tag}: records past the end")
    finally:
        c2.close()
    out.update({
        "follower_fetches": p11_fetches(cluster, log0, P11_FOLLOWER),
        "leader_fetches": p11_fetches(cluster, log1, P11_LEADER),
        "follower_after": p11_fetches(cluster, log2, P11_FOLLOWER),
        "follower_rate": d1 / (t1 - t0),
        "leader_rate": (d2 - d1) / (t2 - t1),
        "restart_rate": (book.delivered - d2) / (t4 - t3),
        "delivered": book.delivered})
    p11_check(out["follower_fetches"] > 0 and out["leader_fetches"] > 0
              and out["delegated"] > 0 and out["follower_after"] == 0,
              f"11b {tag}: fetches follower {out['follower_fetches']} "
              f"(delegated {out['delegated']}), leader after the "
              f"withdrawal {out['leader_fetches']}, follower after the "
              f"restart {out['follower_after']}")
    p11_check(book.delivered == n + out["rewound"],
              f"11b {tag}: {book.delivered} delivered, not {n} + "
              f"{out['rewound']} rewound")
    if s0 is not None:
        out["crc"] = [s1["stats"]["launches"] - s0["stats"]["launches"],
                      s2["stats"]["launches"] - s1["stats"]["launches"],
                      s4["stats"]["launches"] - s3["stats"]["launches"]]
        p11_no_cpu(s2, f"11b {tag} consumer", False)
        p11_no_cpu(s4, f"11b {tag} restarted consumer", False)
    return out


def p11_regex(kit, cluster, backend: dict, tag: str, n: int = 50) -> dict:
    """11b's regex subscription: a group consumer subscribed to
    ^p11r-<tag>-.* reads the matching topic, then a matching topic
    created mid-run; a topic that does not match is never read."""
    first, second, skip = f"p11r-{tag}-0", f"p11r-{tag}-1", f"p11q-{tag}"
    cluster.create_topic(first, 2)
    cluster.create_topic(skip, 1)
    p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "linger.ms": 5, **backend})
    c = None
    try:
        for t in (first, skip):
            for k in range(n):
                p.produce(t, value=b"%s-%03d" % (t.encode(), k),
                          partition=k % 2 if t == first else 0)
        p11_check(p.flush(60) == 0, f"11b {tag}: regex seed did not drain")
        c = kit.Consumer({"bootstrap.servers": cluster.bootstrap_servers(),
                          "group.id": f"p11r-{tag}", "check.crcs": True,
                          "auto.offset.reset": "earliest",
                          "topic.metadata.refresh.interval.ms": 400,
                          **backend})
        eos_warm(c)
        c.subscribe([f"^p11r-{tag}-.*"])

        def read(k):
            got = []
            deadline = time.monotonic() + 30
            while len(got) < k and time.monotonic() < deadline:
                got += [(m.topic, m.value) for m in
                        c.consume(num_messages=1000, timeout=0.3)
                        if m.error is None]
            return got
        got1 = read(n)
        # committed, so the rebalance onto the new topic resumes here
        c.commit(asynchronous=False)
        cluster.create_topic(second, 2)
        for k in range(n):
            p.produce(second, value=b"%s-%03d" % (second.encode(), k),
                      partition=k % 2)
        p11_check(p.flush(60) == 0, f"11b {tag}: regex topic did not drain")
        got2 = read(n)
        extra = [(m.topic, m.value)
                 for m in c.consume(num_messages=10, timeout=0.5)
                 if m.error is None]
        snap = eos_snapshot(eos_engine(c))
    finally:
        if c is not None:
            c.close()
        p.close()
    for t, got in ((first, got1), (second, got2)):
        p11_check(sorted(got) == [(t, b"%s-%03d" % (t.encode(), k))
                                  for k in range(n)],
                  f"11b {tag}: regex subscription read {len(got)} of {t}'s "
                  f"{n}: {got[:2]}")
    p11_check(not extra, f"11b {tag}: regex subscription read {extra[:2]}")
    p11_no_cpu(snap, f"11b {tag} regex consumer", False)
    return {"topics": [first, second], "records": len(got1) + len(got2)}


def p11_tickets(tickets, timeout: float = 10.0) -> dict:
    """Wait on every ticket from a thread of its own: each must resolve
    or fail with the engine's "closed" error, none may hang."""
    seen = {"resolved": 0, "closed": 0, "other": []}
    lock = threading.Lock()

    def wait(t):
        try:
            t.result(timeout)
            kind = "resolved"
        except RuntimeError as e:
            kind = "closed" if "closed" in str(e) else repr(e)
        except Exception as e:            # recorded, checked below
            kind = repr(e)
        with lock:
            if kind in ("resolved", "closed"):
                seen[kind] += 1
            else:
                seen["other"].append(kind)
    ths = [threading.Thread(target=wait, args=(t,), name=f"p11-ticket-{k}")
           for k, t in enumerate(tickets)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout + 5)
    seen["hung"] = sum(th.is_alive() for th in ths)
    return seen


def p11_engine_down(client, what: str) -> None:
    """Kafka.close() swallows the provider's close() error, so the
    engine's own state must show the drain: closed, its dispatch and
    warmup threads exited."""
    eng = eos_engine(client)
    if eng is None:
        return
    warm = getattr(eng, "_warmup_thread", None)
    p11_check(eng._closed and not eng._thread.is_alive()
              and (warm is None or not warm.is_alive()),
              f"11c: {what}'s engine still running after close()")


def p11_settled(client) -> None:
    """Wait for the client's warmup threads (the provider's, its
    engine's) to finish, so close() is timed against the wedged broker
    and the tickets, not against a kernel build in progress."""
    prov = client._rk.codec_provider
    for owner in (prov, getattr(prov, "_engine", None)):
        th = getattr(owner, "_warmup_thread", None)
        if th is not None:
            th.join(120)
            p11_check(not th.is_alive(), f"11c: {th.name} still running")


def p11_teardown(kit, backend: dict, tag: str, parts: int = 8,
                 per: int = 400) -> dict:
    """11c: a GPU Producer and a check.crcs Consumer with tickets in
    flight, then the mock stops answering broker 2 and the consumer's
    broker-2 thread is wedged (its serve loop a sleep): close() each
    client.  close() returns in time, no engine or warmup thread is left,
    every ticket resolves or fails "closed", a CRC batch the wedged
    thread submits after close() resolves exact; a fresh client
    afterwards launches and writes exact CRCs."""
    topic = f"p11c-{tag}"
    cluster = kit.MockCluster(num_brokers=2, topics={topic: parts},
                              auto_create_topics=False)
    TP = kit.TopicPartition
    out: dict = {}
    stuck = None
    try:
        p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                          "linger.ms": 5, "compression.codec": "lz4",
                          "queue.buffering.max.messages": 1_000_000,
                          **backend})
        c = kit.Consumer({"bootstrap.servers": cluster.bootstrap_servers(),
                          "group.id": f"p11c-{tag}", "check.crcs": True,
                          "auto.offset.reset": "earliest", **backend})
        try:
            for client in (p, c):
                eos_warm(client)
                p11_settled(client)
            vals = payloads(parts * per, VALUE_SIZE)
            for k, v in enumerate(vals):
                p.produce(topic, value=v, partition=k % parts)
            p11_check(p.flush(120) == 0, f"11c {tag}: seed did not drain")
            c.assign([TP(topic, i, OFFSET_BEGINNING) for i in range(parts)])
            read = 0
            deadline = time.monotonic() + 60
            while read < len(vals) // 2:
                p11_check(time.monotonic() < deadline,
                          f"11c {tag}: read {read} of {len(vals) // 2}")
                read += sum(1 for m in c.consume(num_messages=1000,
                                                 timeout=0.2)
                            if m.error is None)
            with c._rk._brokers_lock:
                stuck = next(b for b in c._rk.brokers.values()
                             if b.nodeid == 2)
            # a burst to fetch; wedge broker 2's thread while its fetch
            # pipeline holds partitions (best effort: a serve pass in
            # progress may still reap them); a second burst (producer
            # tickets in flight); then the mock stops answering broker 2
            for k, v in enumerate(vals):
                p.produce(topic, value=v, partition=k % parts)
            deadline = time.monotonic() + 2
            while not stuck._fetch_pending and time.monotonic() < deadline:
                c.consume(num_messages=50, timeout=0.01)
            stuck._serve = lambda: time.sleep(0.05)
            for k, v in enumerate(vals):
                p.produce(topic, value=v, partition=k % parts)
            cluster.pause_broker(2)
            tickets = []
            prov = c._rk.codec_provider
            if hasattr(prov, "crc32c_submit"):
                tickets = [prov.crc32c_submit([bytes(vals[k])] * 8)
                           for k in range(4)]
            for b in list(c._rk.brokers.values()):
                for pend in list(b._fetch_pending):
                    tickets += [t for t in (pend.crc_ticket,
                                            pend.legacy_ticket) if t]
                    tickets += [t for _c, _i, t in pend.dec_tickets]
            out["tickets"] = len(tickets)
        finally:
            t0 = time.monotonic()
            c.close()
            out["consumer_close_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            p.close(2.0)
            out["producer_close_s"] = time.monotonic() - t0
        p11_engine_down(c, f"11c {tag} consumer")
        p11_engine_down(p, f"11c {tag} producer")
        out["ticket_waits"] = p11_tickets(tickets)
        # the wedged thread outlived close(): a CRC batch it submits now
        # meets the closed engine and still resolves, exact
        regions = [bytes(v) for v in vals[:8]]
        late = type(stuck)._codec_submit(prov, "crc32c_submit",
                                         prov.crc32c_many, regions)
        p11_check([int(x) for x in late.result(10)]
                  == native.crc32c_many(regions).tolist(),
                  f"11c {tag}: a CRC batch submitted after close() != the "
                  "native crc32c")
        left = [t.name for t in threading.enumerate()
                if "engine" in t.name or "warmup" in t.name]
        p11_check(not left, f"11c {tag}: threads left: {left}")
        p11_check(out["consumer_close_s"] <= P11_CLOSE_S
                  and out["producer_close_s"] <= 2.0 + P11_CLOSE_S,
                  f"11c {tag}: close() took {out['consumer_close_s']:.3f} s"
                  f" (consumer), {out['producer_close_s']:.3f} s (producer)")
        w = out["ticket_waits"]
        p11_check(not w["hung"] and not w["other"],
                  f"11c {tag}: ticket waiters {w}")
        p11_check(stuck.thread.is_alive(), f"11c {tag}: the wedged broker "
                  "thread exited before close() met it")
    finally:
        if stuck is not None:
            stuck.terminate = True
            stuck.thread.join(5)
        cluster.resume_broker(2)
        cluster.stop()
    p11_check(stuck is None or not stuck.thread.is_alive(),
              f"11c {tag}: the wedged broker thread did not exit")
    # a fresh client: launches, exact CRCs
    fresh = kit.MockCluster(num_brokers=1, topics={topic: 4})
    try:
        p = kit.Producer({"bootstrap.servers": fresh.bootstrap_servers(),
                          "linger.ms": 5, **backend})
        try:
            eos_warm(p)
            s0 = eos_snapshot(eos_engine(p))
            for k in range(4 * 200):
                p.produce(topic, value=b"fresh-%04d " % k * 20,
                          partition=k % 4)
            p11_check(p.flush(60) == 0, f"11c {tag}: fresh client did not "
                      "drain")
            s1 = eos_snapshot(eos_engine(p))
        finally:
            p.close()
        from librdkafka_tpu_torch.protocol.msgset import iter_batches
        infos, regions = [], []
        for i in range(4):
            for _base, blob in fresh.partition(topic, i).log:
                for info, _payload, full in iter_batches(blob):
                    infos.append(info)
                    regions.append(bytes(full[V2_OF_Attributes:]))
        p11_check(infos and native.crc32c_many(regions).tolist()
                  == [x.crc for x in infos],
                  f"11c {tag}: the fresh client's CRCs != the native crc32c")
        if s0 is not None:
            out["fresh_launches"] = (s1["stats"]["launches"]
                                     - s0["stats"]["launches"])
            p11_check(out["fresh_launches"] > 0,
                      f"11c {tag}: the fresh client made no CRC launch")
            p11_no_cpu(s1, f"11c {tag} fresh producer", False)
    finally:
        fresh.stop()
    return out


def phase_api(smi: str, parts: int = PARTITIONS,
              per_part: int = P11_PER_PART, device: str = "cuda") -> dict:
    """Phase 11: the producer's delivery path (11a) and the consumer's
    API (11b) on two legs, then teardown under a wedged broker (11c), on
    the card.  Returns its launches."""
    import tempfile
    t0 = time.perf_counter()
    flat = payloads(parts * per_part, VALUE_SIZE)
    vals = [flat[i * per_part:(i + 1) * per_part] for i in range(parts)]
    kit = port_kit()
    backend = {"compression.backend": "gpu", "gpu.device": device, **P6_GPU}
    card = device != "cpu"
    total = {"crc_rows": 0, "lz4_rows": 0}
    for tag, extra in (("a", {}), ("b", {"gpu.compress.device": True})):
        dev = bool(extra)
        cluster = p11_cluster(kit, tag, parts)
        try:
            crc.launches = 0
            lz4.launches = 0
            d = p11_delivery(kit, cluster, vals, {**backend, **extra}, tag,
                             det=dev)
            a_crc, a_lz4 = crc.launches, lz4.launches
            print(f"phase 11, leg {tag} "
                  f"({'gpu.compress.device' if dev else 'CRC tickets'}): "
                  f"11a {parts * per_part} records x {VALUE_SIZE} B lz4 over "
                  f"{parts} idempotent partitions through produce_batch (a"
                  f" quarter with headers, a quarter with timestamps), "
                  f"dr_msg_cb + dr_batch_cb all served at flush(); "
                  f"{d['batches']} stored batches exact and equal to the DR"
                  f" batches; error DRs {d['errors']}")
            print(f"  produce {d['rate']:.1f} msgs/s ({d['secs']:.3f} s "
                  f"through flush()); producer launches crc {d['crc']}, "
                  f"lz4 {d['lz4']} [{smi}]")
            with tempfile.TemporaryDirectory() as store:
                r = p11_consume(kit, cluster, vals, backend, tag, store,
                                d["max_ts"])
            b_crc = crc.launches - a_crc
            rx = p11_regex(kit, cluster, backend, tag)
            counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        finally:
            cluster.stop()
        if dev:
            check(d["lz4"] > 0 and d["fused"] > 0 and d["crc"] == 0,
                  f"11a {tag}: producer launches lz4 {d['lz4']} (fused "
                  f"{d['fused']}), crc {d['crc']}: not the compress route")
            check(not card or a_lz4 > 0, f"11a {tag}: no lz4_rows launch")
        else:
            check(d["crc"] > 0 and d["lz4"] == 0, f"11a {tag}: producer "
                  f"launches crc {d['crc']}, lz4 {d['lz4']}")
            check(not card or a_crc > 0, f"11a {tag}: no crc_rows launch")
        check(min(r["crc"]) > 0, f"11b {tag}: consumer CRC launches "
              f"(follower half, leader half, restart) {r['crc']}")
        check(not card or b_crc > 0, f"11b {tag}: no crc_rows launch")
        for k in total:
            total[k] += counts[k]
        print(f"  11b: consume {r['follower_rate']:.1f} msgs/s with the "
              f"follower ({r['delegated']} partitions delegated, "
              f"{r['follower_fetches']} follower fetches), "
              f"{r['leader_rate']:.1f} from the leader "
              f"({r['leader_fetches']} fetches), {r['restart_rate']:.1f} "
              f"after the file-store restart; {r['delivered']} delivered "
              f"({r['rewound']} rewound by seek with {r['parked']} fetch "
              f"partitions parked); consumer CRC launches {r['crc']}; regex "
              f"{rx['records']} records of {rx['topics']} [{smi}]")
        print(f"  leg {tag} launches: crc_rows {counts['crc_rows']} (11a "
              f"{a_crc}, 11b {b_crc}), lz4_rows {counts['lz4_rows']} (11a "
              f"{a_lz4}) [{smi}]")
    crc.launches = 0
    t = p11_teardown(kit, backend, "c")
    check(not card or crc.launches > 0, "11c: no crc_rows launch")
    total["crc_rows"] += crc.launches
    print(f"phase 11c: close() with {t['tickets']} tickets in flight and a "
          f"wedged broker thread: consumer {t['consumer_close_s']:.3f} s, "
          f"producer {t['producer_close_s']:.3f} s (its flush 2 s); "
          f"ticket waiters {t['ticket_waits']}, a late submit exact; "
          f"fresh client "
          f"{t.get('fresh_launches')} CRC launches, CRCs exact; crc_rows "
          f"{crc.launches} [{smi}]")
    secs = time.perf_counter() - t0
    check(secs <= P11_LIMIT_S, f"phase 11 took {secs:.3f} s, over its "
          f"{P11_LIMIT_S} s")
    print(f"phase 11: ok ({secs:.3f} s: 11a delivery, 11b consumer API on "
          f"two legs, 11c teardown; {parts} x {per_part} x {VALUE_SIZE} B) "
          f"[{smi}]")
    return total


# --------------------------------------------------------------- phase 12 --

P12_PER_PART = 1600
P12_LIMIT_S = 60
#: events a thread's ring holds: a power of two that no thread of a 12a
#: leg fills (checked: every ring's write index stays below it)
P12_RING = 1 << 17
P12_REPEATS = 3
#: 12b stamps an ``enqueue`` instant on the application thread every this
#: many produce() calls: the fast lane's records enter no Python frame,
#: so the client's own instant marks only a partition's first record
P12_STAMP = 64
#: 12a's legs: (tag, the leg's extra gpu.* keys)
P12_TRACED_LEGS = (("a", {}), ("b", {"gpu.compress.device": True}))
#: test_0126's stages a traced produce -> consume round spans.  12a's
#: quorum of 1 records no fanin_wait (the fan-in waits only below the
#: quorum, and a group still below it after the window is served on the
#: CPU); 12c records one at test_0126's quorum of 2
P12_REQUIRED = ("enqueue", "batch_assembly", "compress", "crc_ticket",
                "fanin_wait", "device_launch", "readback", "produce_tx",
                "ack", "fetch_rx", "crc_verify", "decompress", "deliver")
#: 12b's legs: (tag, compression.backend, the leg's gpu.* keys)
P12_LEGS = (("cpu", "cpu", {}), ("governed", "gpu", {}),
            ("gpu.warmup=false", "gpu", {"gpu.warmup": False}),
            ("gpu.governor=false", "gpu", {"gpu.governor": False}))


def p12_traceview():
    """scripts/traceview.py, loaded by path (it belongs to neither
    package and imports only json, os and sys)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "traceview.py")
    spec = importlib.util.spec_from_file_location("p12_traceview", path)
    tv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tv)
    return tv


def p12_ns(us: float) -> int:
    """A dump's microseconds back to the tracer's integer nanoseconds."""
    return round(us * 1e3)


def p12_window(events: list, t0_ns: int, t1_ns: int) -> list:
    """The thread metadata and the events that start in [t0, t1]."""
    return [e for e in events if e["ph"] == "M"
            or t0_ns <= p12_ns(e["ts"]) <= t1_ns]


def p12_count(events: list, name: str) -> int:
    return sum(1 for e in events if e["ph"] != "M" and e["name"] == name)


def p12_threads(events: list, labels: dict) -> dict:
    """tid -> the thread's label (``labels``) or its name."""
    return {e["tid"]: labels.get(e["tid"], e["args"]["name"])
            for e in events if e["ph"] == "M" and e["name"] == "thread_name"}


def p12_stage_table(tv, events: list, wall_s: float, labels: dict) -> str:
    """traceview's per-span table of ``events``: count, total ms, share of
    ``wall_s``, p50 and p99 us, and the threads that recorded it."""
    names = p12_threads(events, labels)
    threads: dict = {}
    for e in events:
        if e["ph"] == "X":
            threads.setdefault(e["name"], set()).add(
                names.get(e["tid"], str(e["tid"])))
    rows = [f"    {'span':<16}{'count':>7}{'total ms':>11}{'share':>8}"
            f"{'p50 us':>10}{'p99 us':>10}  thread"]
    for s in tv.summarize(events)["stages"]:
        rows.append(f"    {s['name']:<16}{s['cnt']:>7}"
                    f"{s['total_us'] / 1e3:>11.3f}"
                    f"{s['total_us'] / 1e6 / wall_s:>8.3f}"
                    f"{s['p50_us']:>10.1f}{s['p99_us']:>10.1f}  "
                    f"{'+'.join(sorted(threads[s['name']]))}")
    return "\n".join(rows)


def p12_ordered(events: list, launch: str, reads: str, what: str,
                kind: str | None = None) -> int:
    """On each lane (an engine's dispatch thread and its device) the k-th
    ``reads`` span starts no earlier than the k-th ``launch`` span ends,
    and the two counts are equal.  Returns the lanes seen."""
    lanes: dict = {}
    for e in events:
        if e["ph"] != "X" or e["name"] not in (launch, reads):
            continue
        a = e.get("args") or {}
        if e["name"] == reads and kind is not None and a.get("kind") != kind:
            continue
        lanes.setdefault((e["tid"], a.get("device")), ([], []))[
            e["name"] == reads].append(e)
    for key, (ls, rs) in lanes.items():
        check(len(ls) == len(rs), f"{what}: lane {key}: {len(ls)} {launch} "
              f"spans, {len(rs)} {reads}")
        for k, (a, b) in enumerate(zip(ls, rs)):
            end = p12_ns(a["ts"]) + p12_ns(a["dur"])
            check(p12_ns(b["ts"]) >= end, f"{what}: lane {key}: {reads} "
                  f"{k} starts {end - p12_ns(b['ts'])} ns before {launch} "
                  f"{k} ends")
    return len(lanes)


def p12_rings_unwrapped(what: str) -> int:
    """Every thread's ring still holds all it recorded: its write index
    below its capacity.  Returns the largest index."""
    from librdkafka_tpu_torch.obs import trace
    with trace._lock:
        rings = list(trace._rings)
    top = max((r._pos for r in rings), default=0)
    for r in rings:
        check(r._pos < r.cap, f"{what}: the ring of {r.thread_name} wrapped "
              f"({r._pos} events, capacity {r.cap})")
    return top


def p12_conf(bootstrap: str, device: str, parts: int, extra: dict) -> dict:
    """A phase 6 GPU Producer's conf (leg keys ``extra``) on ``bootstrap``
    instead of its own mock."""
    conf = p6_conf("gpu", device, parts, extra)
    for key in ("test.mock.num.brokers", "test.mock.default.partitions"):
        conf.pop(key)
    conf["bootstrap.servers"] = bootstrap
    return conf


def p12_released(what: str) -> None:
    from librdkafka_tpu_torch.obs import metrics, trace
    check(not trace.enabled and trace.active_ring_count() == 0,
          f"{what}: tracing still on ({trace.active_ring_count()} rings)")
    check(not metrics.enabled and metrics.registered_count() == 0,
          f"{what}: metrics still registered ({metrics.registered_count()})")


def p12_traced_leg(tv, cluster, tag: str, extra: dict, keys, vals,
                   device: str, smi: str) -> dict:
    """12a, one leg: a traced and metered idempotent Producer and a
    traced check.crcs Consumer on the GPU backend, warm; the round's
    spans held against the engines' counters, the kernels' counters, the
    metrics registry, the mock's ProduceRequests and the wire."""
    import tempfile

    from librdkafka_tpu_torch import Consumer, Producer
    from librdkafka_tpu_torch.obs import metrics, trace
    card = device != "cpu"
    dev = "gpu.compress.device" in extra
    cextra = {k: v for k, v in extra.items() if k != "gpu.compress.device"}
    parts = len(keys)
    topic = f"p12-{tag}"
    ring = {"trace.enable": True, "trace.ring.events": P12_RING}
    metrics.enable()
    p = c = None
    try:
        p = Producer(p12_conf(cluster.bootstrap_servers(), device, parts,
                              {**extra, **ring}))
        c = Consumer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "group.id": f"p12-{tag}",
                      "auto.offset.reset": "earliest", "check.crcs": True,
                      "compression.backend": "gpu", "gpu.device": device,
                      **P6_GPU, **cextra, **ring})
        pprov, cprov = p._rk.codec_provider, c._rk.codec_provider
        check(pprov.wait_warm(300) and cprov.wait_warm(300),
              f"12a {tag}: a route did not warm")
        peng, ceng = pprov._engine, cprov._engine
        check(peng is not None and ceng is not None,
              f"12a {tag}: no engine")
        engines = (peng, ceng)
        s0 = [(dict(e.stats), dict(e.compress_stats)) for e in engines]
        m0 = metrics.counter("engine.launches").value
        log0 = len(cluster.request_log)
        crc.launches = 0
        lz4.launches = 0
        t_p0 = trace.now()
        rate = p6_produce(p, topic, keys, vals)
        t_p1 = trace.now()
        produces = sum(1 for _b, api in cluster.request_log[log0:]
                       if api == 0)
        crate = p6_consume(c, topic, keys, vals)
        t_c1 = trace.now()
        counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        d = [{k: e.stats[k] - st[k] for k in ("launches", "jobs")}
             | {"compress": e.compress_stats["launches"] - cs["launches"]}
             for e, (st, cs) in zip(engines, s0)]
        m1 = metrics.counter("engine.launches").value
        blob = json.loads(p._rk.stats.emit_json())
        engine_total = sum(e.stats["launches"] + e.compress_stats["launches"]
                           for e in engines)
        top = p12_rings_unwrapped(f"12a {tag}")
        path = os.path.join(tempfile.gettempdir(), f"p12-{tag}.json")
        n_dump = c.trace_dump(path)
        with open(path) as f:
            data = json.load(f)
        os.unlink(path)
        labels = {threading.get_ident(): "application",
                  peng._thread.ident: "producer engine",
                  ceng._thread.ident: "consumer engine"}
        no_cpu_route(peng, f"12a {tag} producer")
        no_cpu_route(ceng, f"12a {tag} consumer")
        if dev:
            no_cpu_compress(peng, f"12a {tag} producer")
    finally:
        if c is not None:
            c.close()
        if p is not None:
            p.close()
        metrics.disable()
    p12_released(f"12a {tag} after close()")
    evs = data["traceEvents"]
    check(isinstance(evs, list) and n_dump > 0, f"12a {tag}: empty dump")
    for e in evs:
        check({"name", "ph", "pid", "tid"} <= set(e)
              and (e["ph"] != "X" or {"ts", "dur"} <= set(e)),
              f"12a {tag}: an event out of the Perfetto shape: {e}")
    ts = [e["ts"] for e in evs if "ts" in e]
    check(ts == sorted(ts), f"12a {tag}: timestamps not sorted")
    check(any(e["ph"] == "M" and e["name"] == "thread_name" for e in evs),
          f"12a {tag}: no thread_name metadata")
    leg = p12_window(evs, t_p0, t_c1)
    names = {e["name"] for e in leg if e["ph"] != "M"}
    need = ({"compress_launch", "fused_crc"} if dev
            else set(P12_REQUIRED) - {"fanin_wait"})
    check(need <= names, f"12a {tag}: spans missing: {need - names}")
    launches = [e for e in leg if e["name"] == "device_launch"]
    comp = p12_count(leg, "compress_launch")
    crc_engine = d[0]["launches"] + d[1]["launches"]
    check(len(launches) == crc_engine == (counts["crc_rows"] if card
                                          else len(launches)),
          f"12a {tag}: device_launch spans {len(launches)}, engine CRC "
          f"launches {crc_engine}, crc_rows {counts['crc_rows']}")
    check(comp == d[0]["compress"] + d[1]["compress"]
          == (counts["lz4_rows"] if card else comp),
          f"12a {tag}: compress_launch spans {comp}, compress launches "
          f"{d[0]['compress']}, lz4_rows {counts['lz4_rows']}")
    check(len(launches) > 0 and (comp > 0) == dev,
          f"12a {tag}: {len(launches)} CRC and {comp} compress launches")
    one_card = card and torch.cuda.device_count() == 1
    for e in launches:
        a = e["args"]
        check(a["route"] == "device" and a["sharded"] is False
              and (a["device"] == 0 if one_card else a["device"] >= 0),
              f"12a {tag}: device_launch args {a}")
    tx, ack = p12_count(leg, "produce_tx"), p12_count(leg, "ack")
    check(tx == ack == produces > 0, f"12a {tag}: produce_tx {tx}, ack "
          f"{ack}, ProduceRequests logged {produces}")
    verify = p12_count(leg, "crc_verify")
    check(verify == d[1]["jobs"], f"12a {tag}: crc_verify spans {verify}, "
          f"consumer verify tickets {d[1]['jobs']}")
    lanes = p12_ordered(leg, "device_launch", "readback", f"12a {tag}",
                        kind="crc")
    if dev:
        lanes += p12_ordered(leg, "compress_launch", "fused_crc",
                             f"12a {tag}")
    check(m1 - m0 == sum(x["launches"] + x["compress"] for x in d),
          f"12a {tag}: engine.launches moved {m1 - m0}, engines "
          f"{[(x['launches'], x['compress']) for x in d]}")
    obs = blob["obs"]["counters"].get("engine.launches")
    check(obs == m1 == engine_total, f"12a {tag}: stats obs.counters "
          f"engine.launches {obs}, registry {m1}, engines {engine_total}")
    nbatch = p6_check_stored(cluster, topic, keys, vals, dev)
    check(nbatch == tx, f"12a {tag}: {nbatch} stored batches, {tx} "
          "produce_tx spans")
    prod_s = (t_p1 - t_p0) / 1e9
    cons_s = (t_c1 - t_p1) / 1e9
    print(f"phase 12a, leg {tag} "
          f"({'gpu.compress.device' if dev else 'CRC tickets'}): "
          f"{parts * len(vals[0])} records x {VALUE_SIZE} B lz4 over {parts} "
          f"idempotent partitions, trace.ring.events {P12_RING} (largest "
          f"ring index {top}), {nbatch} batches exact, every record read "
          f"back by a traced check.crcs consumer; dump {n_dump} events, "
          f"Perfetto shape")
    print(f"  spans == counters: device_launch {len(launches)} == engine "
          f"CRC launches {crc_engine} (producer {d[0]['launches']}, "
          f"consumer {d[1]['launches']}) == crc_rows {counts['crc_rows']}; "
          f"compress_launch {comp} == compress launches "
          f"{d[0]['compress']} == lz4_rows {counts['lz4_rows']}; "
          f"produce_tx {tx} == ack {ack} == ProduceRequests {produces}; "
          f"crc_verify {verify} == verify tickets {d[1]['jobs']}; "
          f"engine.launches +{m1 - m0} (stats obs {obs}); readbacks after "
          f"their launches on {lanes} lanes [{smi}]")
    print(f"  produce window ({prod_s:.3f} s, {rate:.1f} msgs/s; share = "
          f"of it):")
    print(p12_stage_table(tv, p12_window(evs, t_p0, t_p1), prod_s, labels))
    print(f"  consume window ({cons_s:.3f} s, {crate:.1f} msgs/s; share = "
          f"of it):")
    print(p12_stage_table(tv, p12_window(evs, t_p1, t_c1), cons_s, labels))
    return {"counts": counts}


def p12_rate_split(cluster, tag: str, extra: dict, keys, vals,
                   device: str) -> dict:
    """12a's produce rate with tracing off and on: one warm Producer of
    the leg (no trace.enable), the tracer switched on around the "on"
    runs (as the conf key does), off / on / on / off / off / on."""
    from librdkafka_tpu_torch import Producer
    from librdkafka_tpu_torch.obs import trace
    rates: dict = {"off": [], "on": []}
    p = Producer(p12_conf(cluster.bootstrap_servers(), device, len(keys),
                          extra))
    try:
        check(p._rk.codec_provider.wait_warm(300),
              f"12a {tag}: rate producer not warm")
        for r, mode in enumerate(("off", "on", "on", "off", "off", "on")):
            if mode == "on":
                trace.enable(ring=P12_RING)
            try:
                rates[mode].append(p6_produce(p, f"p12-{tag}-rate-{r}",
                                              keys, vals))
            finally:
                if mode == "on":
                    trace.disable()
    finally:
        p.close()
    return rates


def p12_perf_run(bootstrap: str, tag: str, backend: str, extra: dict,
                 device: str, count: int, parts: int, topic: str) -> dict:
    """12b, one run: examples/performance.py produce_mode's conf and loop
    (:57-118: linger 50 ms, batch.num.messages 10,000, lz4, DR callback,
    the rate window from after the client's construction to after
    flush()) with tracing on; the application thread stamps an
    ``enqueue`` instant every P12_STAMP produce() calls, and a watcher
    notes when the provider's warm-up thread ends."""
    from librdkafka_tpu_torch import Producer
    from librdkafka_tpu_torch.client.errors import Err, KafkaException
    from librdkafka_tpu_torch.obs import trace
    delivered, errors, stats = [0], [0], []

    def on_dr(err, msg):
        if err is None:
            delivered[0] += 1
        else:
            errors[0] += 1

    conf = {"bootstrap.servers": bootstrap, "linger.ms": 50,
            "batch.num.messages": 10000, "compression.codec": "lz4",
            "compression.backend": backend, "statistics.interval.ms": 3000,
            "stats_cb": lambda js: stats.append(json.loads(js)),
            "dr_msg_cb": on_dr,
            "trace.enable": True, "trace.ring.events": P12_RING}
    if backend == "gpu":
        conf.update({"gpu.device": device, **extra})
    p = Producer(conf)
    try:
        warm = getattr(p._rk.codec_provider, "_warmup_thread", None)
        ended: list = []
        if warm is not None:
            def watch():
                warm.join()
                ended.append(trace.now())
            threading.Thread(target=watch, daemon=True,
                             name="p12-warmup-watch").start()
        payload = bytes(bytearray(i & 0xFF for i in range(VALUE_SIZE)))
        produce, instant = p.produce, trace.instant
        t0 = time.monotonic()
        t0_ns = trace.now()
        for i in range(count):
            if i % P12_STAMP == 0:
                instant("app", "enqueue", {"i": i})
            while True:
                try:
                    produce(topic, value=payload, partition=i % parts)
                    break
                except KafkaException as e:
                    if e.error.code != Err._QUEUE_FULL:
                        raise
                    p.poll(0.01)
            if i % 10000 == 0:
                p.poll(0)
        rem = p.flush(300.0)
        dt = time.monotonic() - t0
        t1_ns = trace.now()
        eng = json.loads(p._rk.stats.emit_json()).get("codec_engine")
        events = p12_window(trace.collect_events(), t0_ns, t1_ns)
        check(rem == 0 and errors[0] == 0 and delivered[0] == count,
              f"12b {tag} {topic}: {delivered[0]} delivered, {errors[0]} "
              f"failed, {rem} stuck of {count}")
        warm_end = (ended[0] if ended else None) if warm is not None else 0
        return {"rate": delivered[0] / dt, "eng": eng, "events": events,
                "t0": t0_ns, "app": threading.get_ident(),
                "warm_end": warm_end}
    finally:
        p.close()


def p12_gaps(run: dict, k: int = 5) -> list:
    """The ``k`` longest gaps between consecutive ``enqueue`` instants of
    the application thread: (gap us, start ms into the window, the spans
    open on other threads during it, warm-up thread alive)."""
    evs = run["events"]
    names = p12_threads(evs, {})
    stamps = sorted(p12_ns(e["ts"]) for e in evs if e["ph"] == "i"
                    and e["name"] == "enqueue" and e["tid"] == run["app"])
    gaps = sorted(((b - a, a, b) for a, b in zip(stamps, stamps[1:])),
                  reverse=True)[:k]
    out = []
    for gap, a, b in gaps:
        spans = {}
        for e in evs:
            if e["ph"] != "X" or e["tid"] == run["app"]:
                continue
            s = p12_ns(e["ts"])
            over = min(b, s + p12_ns(e["dur"])) - max(a, s)
            if over > 0:
                key = f"{e['name']}@{names.get(e['tid'], e['tid'])}"
                spans[key] = spans.get(key, 0) + over
        top = sorted(spans.items(), key=lambda kv: -kv[1])[:4]
        alive = run["warm_end"] is None or run["warm_end"] > a
        out.append((gap / 1e3, (a - run["t0"]) / 1e6,
                    [(n, o / 1e3) for n, o in top], alive))
    return out


def p12_split(tv, device: str, parts: int, count: int, smi: str) -> dict:
    """12b: the governed GPU producer split, against the standalone mock
    in its own process; four legs interleaved, three repeats each."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "librdkafka_tpu_torch.mock.standalone",
         "--partitions", str(parts)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    runs: dict = {tag: [] for tag, _, _ in P12_LEGS}
    crc.launches = 0
    lz4.launches = 0
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        bootstrap = proc.stdout.readline().strip() if ready else ""
        check(bool(bootstrap), "12b: the standalone mock did not start")
        legs = list(enumerate(P12_LEGS))
        for r in range(P12_REPEATS):
            # interleaved: forward on even repeats, backward on odd ones
            for i, (tag, backend, extra) in (legs if r % 2 == 0
                                             else legs[::-1]):
                runs[tag].append(p12_perf_run(
                    bootstrap, tag, backend, extra, device, count, parts,
                    f"p12b-{i}-{r}"))
    finally:
        proc.kill()
        proc.wait(30)
    counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
    cpu = statistics.median(x["rate"] for x in runs["cpu"])
    print(f"phase 12b: the performance example's produce loop (-P -z lz4 "
          f"-s {VALUE_SIZE} -c {count}, {parts} partitions, linger 50 ms, "
          f"batch.num.messages 10,000) in this process against the "
          f"standalone mock (its own process), tracing on; four legs "
          f"interleaved, {P12_REPEATS} repeats each; every record "
          f"delivered [{smi}]")
    for tag, backend, extra in P12_LEGS:
        rs = runs[tag]
        rates = [x["rate"] for x in rs]
        med = statistics.median(rates)
        print(f"  {tag}: {p6_rates(rates)}; {med / cpu:.3f} x cpu")
        if backend == "gpu":
            keys = ("launches", "routed_cpu_jobs", "warmup_miss_jobs",
                    "explore_routes", "jobs")
            eng = [{k: x["eng"][k] for k in keys} for x in rs]
            check(all(e["launches"] > 0 for e in eng),
                  f"12b {tag}: a run made no CRC launch: {eng}")
            print(f"    engine per run: {eng}")
        totals: dict = {}
        for x in rs:
            for s in tv.summarize(x["events"])["stages"]:
                totals[s["name"]] = totals.get(s["name"], 0.0) + s["total_us"]
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        print("    stage totals (ms, 3 runs): " + ", ".join(
            f"{n} {t / 1e3:.1f}" for n, t in top))
        gaps = sorted(((g, k) for k, x in enumerate(rs) for g in p12_gaps(x)),
                      key=lambda gk: -gk[0][0])[:5]
        for (gap, at, spans, alive), k in gaps:
            print(f"    gap {gap:.1f} us at {at:.3f} ms (run {k}); warm-up "
                  f"thread {'alive' if alive else 'ended'}; open: "
                  + (", ".join(f"{n} {o:.1f} us" for n, o in spans)
                     or "nothing"))
        warm = [x["warm_end"] for x in rs]
        if backend == "gpu" and any(w != 0 for w in warm):
            print("    warm-up thread ended "
                  + ", ".join("still running" if w is None else
                              f"{(w - x['t0']) / 1e6:.3f} ms into the window"
                              for w, x in zip(warm, rs)))
    print(f"  12b launches: crc_rows {counts['crc_rows']}, lz4_rows "
          f"{counts['lz4_rows']} [{smi}]")
    return counts


def p12_flight(device: str, smi: str) -> dict:
    """12c: the flight recorder on the card.  A traced leg-a Producer at
    test_0126's launch quorum of 2 sends one record alone (its lone
    ticket waits in the fan-in window, then the CPU serves it) and one
    round through the engine; a request timeout is forced as test_0126
    forces it; the dump holds the fan-in wait, the round's launch and
    readback and the timeout, dumps stop at FLIGHT_MAX_DUMPS, and
    obs.collect merges the dump with a traced Consumer's trace_dump."""
    import tempfile

    from librdkafka_tpu_torch import Consumer, Producer
    from librdkafka_tpu_torch.client.broker import Broker, Request
    from librdkafka_tpu_torch.obs import collect, trace
    from librdkafka_tpu_torch.protocol.proto import ApiKey
    parts, per = PARTITIONS, 64
    ring = {"trace.enable": True, "trace.ring.events": P12_RING}
    vals = [[b"flight-%02d-%04d " % (i, j) * 20 for j in range(per)]
            for i in range(parts)]
    keys = [b"f%02d" % i for i in range(parts)]
    old_dir = trace.flight_dir
    crc.launches = 0
    with tempfile.TemporaryDirectory() as d:
        trace.flight_dir = d
        p = c = None
        try:
            p = Producer({**p6_conf("gpu", device, parts, ring),
                          "gpu.launch.min.batches": 2,
                          "socket.max.fails": 0})
            check(p._rk.codec_provider.wait_warm(300), "12c: not warm")
            check(trace._flight_count == 0, "12c: flight dumps already made")
            eng = p._rk.codec_provider._engine
            p.produce("p12c-solo", value=b"solo", partition=0)
            check(p.flush(60) == 0, "12c: the lone record stuck")
            l0 = eng.stats["launches"]
            p6_produce(p, "p12c", keys, vals)
            check(eng.stats["launches"] > l0, "12c: no launch in the round")
            b = Broker(p._rk, 999, "127.0.0.1", 1)      # never started
            try:
                b.waitresp[7] = Request(ApiKey.Metadata, {}, corrid=7,
                                        abs_timeout=time.monotonic() - 1.0)
                b._scan_timeouts(time.monotonic())
                check(b.c_req_timeouts == 1, "12c: no request timeout")
            finally:
                b._wakeup_r.close()
                b._wakeup_w.close()
            path = trace.last_flight_path
            check(path is not None and os.path.dirname(path) == d
                  and "request_timeout" in os.path.basename(path),
                  f"12c: flight dump {path}")
            more = [trace.flight_record(f"bound-{i}")
                    for i in range(trace.FLIGHT_MAX_DUMPS)]
            dumps = sorted(os.listdir(d))
            check(sum(x is not None for x in more)
                  == trace.FLIGHT_MAX_DUMPS - 1 and more[-1] is None
                  and len(dumps) == trace.FLIGHT_MAX_DUMPS,
                  f"12c: {len(dumps)} dumps for FLIGHT_MAX_DUMPS "
                  f"{trace.FLIGHT_MAX_DUMPS}")
            with open(path) as f:
                flight = json.load(f)["traceEvents"]
            c = Consumer({"bootstrap.servers":
                          p._rk.mock_cluster.bootstrap_servers(),
                          "group.id": "p12c", "auto.offset.reset": "earliest",
                          "check.crcs": True, "compression.backend": "gpu",
                          "gpu.device": device, **P6_GPU, **ring})
            check(c._rk.codec_provider.wait_warm(300), "12c: consumer cold")
            p6_consume(c, "p12c", keys, vals)
            cpath = os.path.join(d, "consumer.json")
            c.trace_dump(cpath)
            with open(cpath) as f:
                cons = json.load(f)["traceEvents"]
            merged = collect.merge([
                collect.ProcessDump("producer-flight", 1, flight),
                collect.ProcessDump("consumer", 2, cons)])
            mpath = os.path.join(d, "merged.json")
            n = collect.write(mpath, merged)
            with open(mpath) as f:
                data = json.load(f)
        finally:
            trace.flight_dir = old_dir
            if c is not None:
                c.close()
            if p is not None:
                p.close()
    p12_released("12c after close()")
    for e in flight:
        check({"name", "ph", "pid", "tid"} <= set(e)
              and (e["ph"] != "X" or {"ts", "dur"} <= set(e)),
              f"12c: a flight event out of the Perfetto shape: {e}")
    rt = [e for e in flight if e["name"] == "request_timeout"]
    check(len(rt) == 1, f"12c: {len(rt)} request_timeout instants")
    before = {e["name"] for e in flight
              if e["ph"] == "X" and e["ts"] < rt[0]["ts"]}
    check({"fanin_wait", "device_launch", "readback", "produce_tx",
           "ack"} <= before,
          f"12c: the dump lacks the round's spans: {sorted(before)}")
    evs = data["traceEvents"]
    labels = {e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "process_name"}
    body = [e["ts"] for e in evs if e["ph"] != "M"]
    check(data["displayTimeUnit"] == "ms" and labels ==
          {"producer-flight", "consumer"} and body == sorted(body)
          and n == len(body) > len(flight) - len(
              [e for e in flight if e["ph"] == "M"]),
          f"12c: merged timeline {n} events, labels {labels}")
    print(f"phase 12c: flight recorder on the card: a request timeout "
          f"after a lone record and one round ({parts} x {per} records) "
          f"dumped {len(flight)} events holding the lone ticket's "
          f"fanin_wait, the round's device_launch, readback, produce_tx "
          f"and ack, and the request_timeout instant; "
          f"dumps stopped at FLIGHT_MAX_DUMPS = {trace.FLIGHT_MAX_DUMPS}; "
          f"obs.collect merged it with the consumer's trace_dump into "
          f"{n} events on one timeline; crc_rows {crc.launches} [{smi}]")
    return {"crc_rows": crc.launches, "lz4_rows": 0}


def phase_obs(smi: str, parts: int = PARTITIONS,
              per_part: int = P12_PER_PART, device: str = "cuda") -> dict:
    """Phase 12: the port's observability on the card.  12a a traced
    round at full size on two legs, 12b the governed GPU producer split,
    12c the flight recorder.  Returns the kernels' launches."""
    from librdkafka_tpu_torch.mock.cluster import MockCluster
    t0 = time.perf_counter()
    p12_released("phase 12 start")
    tv = p12_traceview()
    flat = payloads(parts * per_part, VALUE_SIZE)
    vals = [flat[i * per_part:(i + 1) * per_part] for i in range(parts)]
    keys = [b"p%02d" % i for i in range(parts)]
    total = {"crc_rows": 0, "lz4_rows": 0}
    for tag, extra in P12_TRACED_LEGS:
        cluster = MockCluster(num_brokers=1, default_partitions=parts)
        try:
            leg = p12_traced_leg(tv, cluster, tag, extra, keys, vals,
                                 device, smi)
            crc.launches = 0
            lz4.launches = 0
            rates = p12_rate_split(cluster, tag, extra, keys, vals, device)
            counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        finally:
            cluster.stop()
        for k in total:
            total[k] += leg["counts"][k] + counts[k]
        print(f"  produce with tracing off: {p6_rates(rates['off'])}; on: "
              f"{p6_rates(rates['on'])} (off, on, on, off, off, on; not "
              f"gated); launches crc_rows {counts['crc_rows']}, lz4_rows "
              f"{counts['lz4_rows']} [{smi}]")
    split = p12_split(tv, device, parts, parts * per_part, smi)
    flight = p12_flight(device, smi)
    for k in total:
        total[k] += split[k] + flight[k]
    p12_released("phase 12 end")
    secs = time.perf_counter() - t0
    check(secs <= P12_LIMIT_S, f"phase 12 took {secs:.3f} s, over its "
          f"{P12_LIMIT_S} s")
    print(f"phase 12: ok ({secs:.3f} s: 12a traced rounds on two legs, 12b "
          f"the governed producer split, 12c the flight recorder; {parts} x "
          f"{per_part} x {VALUE_SIZE} B; launches crc_rows "
          f"{total['crc_rows']}, lz4_rows {total['lz4_rows']}) [{smi}]")
    return total


# --------------------------------------------------------------- phase 13 --

P13_PER_PART = 1600
P13_LIMIT_S = 90
P13_REPEATS = 3
#: batch.num.messages of 13a (with linger.ms 1,000): every batch is cut
#: by count, so the sasl_ssl round's blobs can equal the plaintext one's
P13_BATCH = 400
#: 13c: records a partition for each legacy broker version
P13_LEGACY_PER = 400
#: 13c's broker versions and the MessageSet magic each takes
P13_VERSIONS = (("0.10.2", 1), ("0.9.0", 0))
#: 13c's mixed log: a MsgVer1 run then a v2 run of this many records
P13_MIXED_RUN = 25
P13_USERS = {"alice": "wonderland"}
P13_LEGS = (("a", {}), ("b", {"gpu.compress.device": True}))


class PlaneError(RuntimeError):
    """Phase 13 (TLS, SASL, admin, legacy brokers, socket faults) broke
    one of its checks."""


def p13_check(cond: bool, msg: str) -> None:
    if not cond:
        raise PlaneError(msg)


def p13_certs(tmpdir: str) -> dict:
    """A CA, a server certificate for 127.0.0.1 / localhost, a client
    pair and a PKCS#12 keystore of it (password ``kstore``), in
    ``tmpdir``: from tests/tlsutil.py (loaded by path) where
    ``cryptography`` imports, else from the ``openssl`` command; with
    neither, phase 13 fails."""
    import importlib.util
    try:
        import cryptography
        crypto = cryptography.__version__
    except ImportError:
        crypto = None
    openssl = shutil.which("openssl")
    ver = (subprocess.run([openssl, "version"], capture_output=True,
                          text=True).stdout.strip() if openssl else None)
    print(f"phase 13 certificates: import cryptography "
          f"{crypto or 'fails'}; openssl version: {ver or 'absent'}; made "
          f"by {'tests/tlsutil.make_certs' if crypto else 'openssl'}")
    if crypto:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "tlsutil.py")
        spec = importlib.util.spec_from_file_location("p13_tlsutil", path)
        tlsutil = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tlsutil)
        return tlsutil.make_certs(tmpdir)
    if not openssl:
        raise PlaneError("phase 13 needs the cryptography package or the "
                         "openssl command to make its certificates: "
                         "neither is here")
    return p13_openssl_certs(openssl, tmpdir)


def p13_openssl_certs(openssl: str, tmpdir: str) -> dict:
    """tests/tlsutil.make_certs' files through the openssl command."""
    def run(*args):
        subprocess.run([openssl, *args], check=True, capture_output=True,
                       cwd=tmpdir)
    ext = os.path.join(tmpdir, "san.cnf")
    with open(ext, "w") as f:
        f.write("basicConstraints=critical,CA:FALSE\n"
                "subjectAltName=DNS:localhost,IP:127.0.0.1\n")
    run("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "30",
        "-subj", "/CN=mock-ca", "-keyout", "ca.key", "-out", "ca.pem",
        "-addext", "basicConstraints=critical,CA:TRUE")
    for name, cn in (("server", "localhost"), ("client", "mock-client")):
        run("req", "-newkey", "rsa:2048", "-nodes", "-subj", f"/CN={cn}",
            "-keyout", f"{name}.key", "-out", f"{name}.csr")
        run("x509", "-req", "-in", f"{name}.csr", "-CA", "ca.pem",
            "-CAkey", "ca.key", "-CAcreateserial", "-days", "30",
            "-out", f"{name}.pem", "-extfile", ext)
    run("pkcs12", "-export", "-inkey", "client.key", "-in", "client.pem",
        "-certfile", "ca.pem", "-name", "client", "-out", "client.p12",
        "-passout", "pass:kstore")
    j = lambda n: os.path.join(tmpdir, n)
    return {"ca": j("ca.pem"), "server_cert": j("server.pem"),
            "server_key": j("server.key"), "client_cert": j("client.pem"),
            "client_key": j("client.key"), "client_p12": j("client.p12")}


def p13_kit():
    """The port's names phase 13 drives."""
    from types import SimpleNamespace

    from librdkafka_tpu_torch import (AdminClient, ConfigResource, Consumer,
                                      NewPartitions, NewTopic, Producer)
    from librdkafka_tpu_torch.client import partition
    from librdkafka_tpu_torch.client.consumer import TopicPartition
    from librdkafka_tpu_torch.client.errors import Err
    from librdkafka_tpu_torch.mock.cluster import MockCluster
    from librdkafka_tpu_torch.mock.sockem import Sockem
    return SimpleNamespace(
        Producer=Producer, Consumer=Consumer, TopicPartition=TopicPartition,
        MockCluster=MockCluster, AdminClient=AdminClient, NewTopic=NewTopic,
        NewPartitions=NewPartitions, ConfigResource=ConfigResource,
        Sockem=Sockem, Err=Err, Toppar=partition.Toppar)


def p13_tls_cluster(kit, certs, topics: dict, brokers: int = 3):
    """A mock whose brokers speak TLS, require a client certificate and
    check SASL credentials (``P13_USERS``)."""
    return kit.MockCluster(
        num_brokers=brokers, topics=topics, auto_create_topics=False,
        tls={"certfile": certs["server_cert"], "keyfile": certs["server_key"],
             "cafile": certs["ca"], "require_client_cert": True},
        sasl_users=P13_USERS)


def p13_scram(certs, password: str = "wonderland") -> dict:
    """sasl_ssl with SCRAM-SHA-512, the client pair from the PKCS#12
    keystore."""
    return {"security.protocol": "sasl_ssl", "ssl.ca.location": certs["ca"],
            "ssl.keystore.location": certs["client_p12"],
            "ssl.keystore.password": "kstore",
            "sasl.mechanisms": "SCRAM-SHA-512", "sasl.username": "alice",
            "sasl.password": password}


def p13_oauth(certs) -> dict:
    """sasl_ssl with OAUTHBEARER (the built-in unsecured-JWS handler),
    the client pair from PEM files."""
    return {"security.protocol": "sasl_ssl", "ssl.ca.location": certs["ca"],
            "ssl.certificate.location": certs["client_cert"],
            "ssl.key.location": certs["client_key"],
            "sasl.mechanisms": "OAUTHBEARER",
            "enable.sasl.oauthbearer.unsecure.jwt": True,
            "sasl.oauthbearer.config": "principal=smoke"}


def p13_values(parts: int, per: int) -> list:
    flat = payloads(parts * per, VALUE_SIZE)
    return [flat[i * per:(i + 1) * per] for i in range(parts)]


def p13_keys(parts: int) -> list:
    return [b"p%02d" % i for i in range(parts)]


def p13_producer(kit, boot: str, backend: dict, extra: dict):
    """An idempotent lz4 GPU Producer, its route warm."""
    p = kit.Producer({"bootstrap.servers": boot, "enable.idempotence": True,
                      "compression.codec": "lz4", "linger.ms": 5,
                      "queue.buffering.max.messages": 1_000_000,
                      **backend, **extra})
    eos_warm(p)
    return p


def p13_consumer(kit, boot: str, backend: dict, group: str, extra: dict,
                 errs: list | None = None):
    """A check.crcs GPU Consumer, its route warm."""
    conf = {"bootstrap.servers": boot, "group.id": group,
            "auto.offset.reset": "earliest", "check.crcs": True,
            **backend, **extra}
    if errs is not None:
        conf["error_cb"] = errs.append
    c = kit.Consumer(conf)
    eos_warm(c)
    return c


def p13_blobs(cluster, topic: str) -> list:
    return [[bytes(b) for _o, b in part.log] for part in cluster.topics[topic]]


def p13_engines_clean(clients, compress: bool, what: str) -> None:
    """No job of a counted client's engine went to a CPU route."""
    for c in clients:
        p11_no_cpu(eos_snapshot(eos_engine(c)), what, compress)


def p13_threads() -> set:
    return {t for t in threading.enumerate() if t.is_alive() and (
        t.name.startswith("rdk:broker/") or "engine" in t.name)}


def p13_refused(kit, cluster, backend: dict, conf: dict, what: str) -> str:
    """A Producer that the cluster must refuse: its record times out
    (the code the reference's test_0097 asserts, held equal to the
    reference in tests/test_torch_security.py) and, after close(), none
    of its engine or broker threads is left."""
    before = p13_threads()
    drs: list = []
    p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "message.timeout.ms": 1000, "linger.ms": 5,
                      "dr_msg_cb": lambda e, m: drs.append(e),
                      **backend, **conf})
    try:
        p.produce("p13-tls-r0", value=b"refused", partition=0)
        p13_check(p.flush(15) == 0, f"{what}: flush() did not drain")
    finally:
        p.close()
    codes = [e.code.name if e is not None else None for e in drs]
    p13_check(codes == ["_MSG_TIMED_OUT"], f"{what}: DRs {codes}, not "
              "[_MSG_TIMED_OUT] as in the reference")
    deadline = time.monotonic() + 5
    while p13_threads() - before and time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(t.name for t in p13_threads() - before)
    p13_check(not left, f"{what}: threads left after close(): {left}")
    return codes[0]


def p13_tls(kit, certs, backend: dict, tag: str, extra: dict, parts: int,
            per: int, device: str, smi: str, refuse: bool) -> dict:
    """13a, one leg: the same seeded rounds (fixed timestamps, batches cut
    by count) over sasl_ssl (SCRAM-SHA-512 producer with a PKCS#12
    keystore, OAUTHBEARER consumer, mutual TLS) and over plaintext, each
    on its own 3-broker mock, three repeats interleaved; the stored blobs
    must be equal byte for byte, exact, and read back.  Returns the
    sasl_ssl cluster (13b runs on it: the caller stops it) and counts."""
    card = device != "cpu"
    keys, vals = p13_keys(parts), p13_values(parts, per)
    topics = {f"p13-tls-r{r}": parts for r in range(P13_REPEATS)}
    fixed = {"linger.ms": 1000, "batch.num.messages": P13_BATCH}
    sec = p13_tls_cluster(kit, certs, topics)
    plain = kit.MockCluster(num_brokers=3, topics=topics,
                            auto_create_topics=False)
    clients = []
    try:
        bk = {**backend, **extra}
        ps = p13_producer(kit, sec.bootstrap_servers(), bk,
                          {**fixed, **p13_scram(certs)})
        clients.append(ps)
        pp = p13_producer(kit, plain.bootstrap_servers(), bk, fixed)
        clients.append(pp)
        cs = p13_consumer(kit, sec.bootstrap_servers(), backend,
                          f"p13-{tag}", p13_oauth(certs))
        clients.append(cs)
        cp = p13_consumer(kit, plain.bootstrap_servers(), backend,
                          f"p13-{tag}", {})
        clients.append(cp)
        crc.launches = 0
        lz4.launches = 0
        eng0 = {id(c): dict(eos_engine(c).stats) for c in clients}
        rates = {"sasl_ssl": {"produce": [], "consume": []},
                 "plaintext": {"produce": [], "consume": []}}
        for t in topics:
            rates["plaintext"]["produce"].append(
                p6_produce(pp, t, keys, vals, ts0=NOW_MS))
            rates["sasl_ssl"]["produce"].append(
                p6_produce(ps, t, keys, vals, ts0=NOW_MS))
        prod = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        for t in topics:
            rates["plaintext"]["consume"].append(
                p6_consume(cp, t, keys, vals))
            rates["sasl_ssl"]["consume"].append(
                p6_consume(cs, t, keys, vals))
        counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        dev = bool(extra)
        for c in clients:
            launched = eos_engine(c).stats["launches"] - eng0[id(c)]["launches"]
            role = "producer" if c in (ps, pp) else "consumer"
            if role == "producer" and dev:
                p13_check(launched == 0, f"13a {tag}: a producer made "
                          f"{launched} CRC launches on the compress route")
                p13_check(eos_engine(c).compress_stats["launches"] > 0,
                          f"13a {tag}: a producer made no compress launch")
            else:
                p13_check(launched > 0, f"13a {tag}: a {role} made no CRC "
                          "launch")
        p13_engines_clean(clients, dev, f"13a {tag}")
        if card:
            p13_check(prod["lz4_rows" if dev else "crc_rows"] > 0,
                      f"13a {tag}: producer kernel launches {prod}")
            p13_check(counts["crc_rows"] - prod["crc_rows"] > 0,
                      f"13a {tag}: no crc_rows launch for the consumers")
            p13_check(dev or counts["lz4_rows"] == 0,
                      f"13a {tag}: an lz4_rows launch on the CRC tickets")
        nbatch = 0
        for t in topics:
            p13_check(p13_blobs(sec, t) == p13_blobs(plain, t),
                      f"13a {tag} {t}: the sasl_ssl blobs != the plaintext "
                      "round's")
            nbatch += p6_check_stored(sec, t, keys, vals, det=dev)
        refusals = {}
        if refuse:
            refusals["SCRAM password"] = p13_refused(
                kit, sec, backend, p13_scram(certs, "wrong"),
                "13a wrong SCRAM password")
            unknown = {k: v for k, v in p13_scram(certs).items()
                       if k != "ssl.ca.location"}
            refusals["unknown CA"] = p13_refused(
                kit, sec, backend, unknown, "13a unknown CA")
    except BaseException:
        sec.stop()                  # on success 13b runs on it first
        raise
    finally:
        for c in clients:
            c.close()
        plain.stop()
    n = parts * per
    print(f"phase 13a, leg {tag} "
          f"({'gpu.compress.device' if extra else 'CRC tickets'}): "
          f"{P13_REPEATS} x {n} records x {VALUE_SIZE} B lz4 over {parts} "
          f"idempotent partitions on 3 brokers, sasl_ssl (SCRAM-SHA-512 "
          f"producer, PKCS#12 keystore; OAUTHBEARER consumer; mutual TLS) "
          f"and plaintext: {nbatch} stored batches equal byte for byte, "
          f"exact (CRC, {'deterministic' if extra else 'default'} lz4 "
          f"frames, records, sequences), read back in order by check.crcs "
          f"GPU consumers; no CPU route"
          + (f"; refused: {refusals}, no thread left" if refuse else ""))
    for tr in ("sasl_ssl", "plaintext"):
        print(f"  {tr}: produce {p6_rates(rates[tr]['produce'])}; consume "
              f"{p6_rates(rates[tr]['consume'])} [{smi}]")
    print(f"  launches: crc_rows {counts['crc_rows']} (producers "
          f"{prod['crc_rows']}), lz4_rows {counts['lz4_rows']} [{smi}]")
    return {"cluster": sec, "counts": counts}


def p13_admin(kit, cluster, certs, backend: dict, parts: int, per: int,
              device: str, smi: str) -> dict:
    """13b: AdminClient over sasl_ssl makes a topic of ``parts``
    partitions at replication 3, describes and alters its config; a
    leg-a GPU Producer writes half of each partition's records, the topic
    grows to 1.5x ``parts`` midway, and the producer's metadata refresh
    carries the rest into the new partitions too, their batches in the
    CRC tickets; a GPU Consumer reads every partition; then the group
    ops after the consumer closed, and delete_topics."""
    card = device != "cpu"
    topic, group = "p13-admin", "p13-admin-g"
    grown = parts + parts // 2
    half = per // 2
    keys = p13_keys(grown)
    vals = p13_values(grown, per)
    vals = vals[:parts] + [v[:half] for v in vals[parts:]]
    sec = p13_scram(certs)
    admin = kit.AdminClient({"bootstrap.servers": cluster.bootstrap_servers(),
                             **sec})
    p = c = None
    try:
        def outcome(fut):
            try:
                return fut.result(timeout=30)
            except Exception as e:      # KafkaException: its code
                return e.error.code.name
        made = outcome(admin.create_topics(
            [kit.NewTopic(topic, parts, replication_factor=3)])[topic])
        p13_check(made is None, f"13b create_topics: {made}")
        res = kit.ConfigResource(kit.ConfigResource.TOPIC, topic)
        before = outcome(admin.describe_configs([res])[res])
        p13_check(before["retention.ms"].value == "604800000",
                  f"13b describe_configs: {before.get('retention.ms')}")
        res2 = kit.ConfigResource(kit.ConfigResource.TOPIC, topic,
                                  set_config={"retention.ms": "3600000"})
        altered = outcome(admin.alter_configs([res2])[res2])
        p13_check(altered is None, f"13b alter_configs: {altered}")
        p = p13_producer(kit, cluster.bootstrap_servers(), backend,
                         {**sec, "topic.metadata.refresh.interval.ms": 200})
        crc.launches = 0
        p6_produce(p, topic, keys, [v[:half] for v in vals[:parts]],
                   ts0=NOW_MS)
        first = crc.launches
        grow = outcome(admin.create_partitions(
            [kit.NewPartitions(topic, grown)])[topic])
        p13_check(grow is None, f"13b create_partitions: {grow}")
        p11_wait(p, lambda: p.rk.topics[topic].partition_cnt == grown,
                 f"13b producer metadata at {grown} partitions")
        regions: set = set()
        submit = p._rk.codec_provider.crc32c_submit

        def recording(bufs, *a, **kw):
            regions.update(bytes(b) for b in bufs)
            return submit(bufs, *a, **kw)
        p._rk.codec_provider.crc32c_submit = recording
        launch0 = eos_engine(p).stats["launches"]
        p6_produce(p, topic, keys, [v[half:] for v in vals[:parts]]
                    + vals[parts:], ts0=NOW_MS + half)
        after = crc.launches - first
        launched = eos_engine(p).stats["launches"] - launch0
        from librdkafka_tpu_torch.protocol.msgset import iter_batches
        new_batches = 0
        for q in range(parts, grown):
            for _o, blob in cluster.partition(topic, q).log:
                for info, _payload, full in iter_batches(blob):
                    p13_check(bytes(full[V2_OF_Attributes:]) in regions,
                              f"13b {topic}[{q}]: a new partition's batch "
                              "was not in the CRC tickets after the growth")
                    new_batches += 1
        p13_check(new_batches >= parts // 2 and launched > 0,
                  f"13b: {new_batches} batches in the new partitions, "
                  f"{launched} CRC launches after the growth")
        p13_check(not card or after > 0, "13b: no crc_rows launch after "
                  "the growth")
        nbatch = p6_check_stored(cluster, topic, keys, vals, det=False)
        p13_engines_clean([p], False, "13b producer")
        c = p13_consumer(kit, cluster.bootstrap_servers(), backend, group,
                         p13_oauth(certs))
        c.subscribe([topic])
        n = sum(map(len, vals))
        nxt, got = [0] * grown, 0
        deadline = time.monotonic() + 120
        while got < n:
            p13_check(time.monotonic() < deadline, f"13b read {got} of {n}")
            for m in c.consume(min(10_000, n - got), 0.5):
                p13_check(m.error is None, f"13b: {m.error}")
                i, j = m.partition, nxt[m.partition]
                p13_check(j < len(vals[i]) and m.offset == j
                          and m.value == vals[i][j],
                          f"13b {topic}[{i}]: record {j} missing, doubled "
                          "or wrong")
                nxt[i] = j + 1
                got += 1
        p13_check(eos_engine(c).stats["launches"] > 0,
                  "13b: the consumer made no CRC launch")
        p13_engines_clean([c], False, "13b consumer")
        listed = outcome(admin.list_groups())
        desc = outcome(admin.describe_groups([group])[group])
        p13_check((group, "consumer") in listed and desc["state"] == "Stable"
                  and len(desc["members"]) == 1,
                  f"13b list/describe_groups: {listed}, {desc}")
        c.close()
        c = None
        gone = outcome(admin.delete_groups([group])[group])
        deleted = outcome(admin.delete_topics([topic])[topic])
        p13_check(gone is None and deleted is None and topic not in
                  cluster.topics, f"13b delete_groups {gone}, delete_topics "
                  f"{deleted}")
    finally:
        if c is not None:
            c.close()
        if p is not None:
            p.close()
        admin.close()
    print(f"phase 13b: AdminClient over sasl_ssl: create_topics {parts} "
          f"partitions x replication 3, describe_configs retention.ms "
          f"604800000, alter_configs 3600000; the leg-a producer grew with "
          f"the topic to {grown} partitions ({new_batches} batches in the "
          f"new ones, each in the CRC tickets after the growth: {launched} "
          f"engine launches, crc_rows {after}); {nbatch} batches exact; "
          f"{n} records read back over {grown} partitions; list, describe "
          f"and delete_groups, delete_topics ok [{smi}]")
    return {"crc_rows": crc.launches, "lz4_rows": 0}


def p13_count_polys(client) -> dict:
    """Tally the polynomials of the CRC jobs each launch of the client's
    engine carries: {"crc32c": n, "crc32": n, "fused": n}."""
    eng = eos_engine(client)
    seen = {"crc32c": 0, "crc32": 0, "fused": 0}
    launch = eng._launch_crc

    def counting(group):
        rec = launch(group)
        if rec is not None:
            polys = {j.poly for j in group}
            seen["fused" if len(polys) > 1 else next(iter(polys))] += 1
        return rec
    eng._launch_crc = counting
    return seen


def p13_legacy_value(region: bytes) -> tuple:
    """(codec bits, value) of a MsgVer0/1 message's CRC region."""
    magic, attrs = region[0], region[1]
    o = 2 + (8 if magic == 1 else 0)
    klen = int.from_bytes(region[o:o + 4], "big", signed=True)
    o += 4 + max(klen, 0)
    vlen = int.from_bytes(region[o:o + 4], "big", signed=True)
    return attrs & 0x07, region[o + 4:o + 4 + vlen]


def p13_legacy_stored(cluster, topic: str, keys, vals, magic: int) -> int:
    """Every stored message of ``topic`` is a MsgVer``magic`` lz4 wrapper
    whose CRC == zlib.crc32 of its region, and so is every message inside
    it; the records are the produced ones in order, at the offsets the
    mock assigned like a broker (0, 1, ...).  Returns the wrappers."""
    from librdkafka_tpu_torch.protocol.msgset import parse_msgset_v01
    wrappers = 0
    for i in range(len(vals)):
        got = []
        for _o, blob in cluster.partition(topic, i).log:
            p13_check(blob[16] == magic, f"13c {topic}[{i}]: magic "
                      f"{blob[16]}, not {magic}")
            for _off, crc32, region in iter_legacy_crc_regions(blob):
                p13_check(zlib.crc32(region) == crc32,
                          f"13c {topic}[{i}]: a message CRC != zlib.crc32")
                codec, value = p13_legacy_value(region)
                p13_check(codec == 3, f"13c {topic}[{i}]: codec {codec}")
                inner = native.lz4f_decompress_many([value], None)[0]
                for _o2, c2, r2 in iter_legacy_crc_regions(inner):
                    p13_check(zlib.crc32(r2) == c2, f"13c {topic}[{i}]: an "
                              "inner message CRC != zlib.crc32")
                wrappers += 1
            got.extend((r.offset, r.key, r.value) for r in parse_msgset_v01(
                blob, lambda c, b: native.lz4f_decompress_many([b], None)[0]))
        p13_check(got == [(j, keys[i], v) for j, v in enumerate(vals[i])],
                  f"13c {topic}[{i}]: stored records != produced")
    return wrappers


def p13_legacy(kit, backend: dict, parts: int, device: str,
               smi: str) -> dict:
    """13c: MsgVer1 (0.10.2) and MsgVer0 (0.9.0, ApiVersions closes the
    connection) brokers: the producer writes lz4 wrappers on the host (no
    batched seam in either package), the GPU consumer verifies every
    message through crc32_submit (crc_rows, crc32 polynomial), a flipped
    byte reaches the application as _BAD_MSG; then a mixed log (a MsgVer1
    run, then v2) read end to end."""
    card = device != "cpu"
    keys, vals = p13_keys(parts), p13_values(parts, P13_LEGACY_PER)
    total = {"crc_rows": 0, "lz4_rows": 0}
    out = []
    for bver, magic in P13_VERSIONS:
        topic = f"p13-legacy-{magic}"
        cluster = kit.MockCluster(num_brokers=1, topics={topic: parts,
                                                         "p13-bad": 1},
                                  broker_version=bver)
        p = c = None
        try:
            old = {"broker.version.fallback": bver}
            p = p13_producer(kit, cluster.bootstrap_servers(), backend, old)
            p6_produce(p, topic, keys, vals, ts0=NOW_MS)
            wrappers = p13_legacy_stored(cluster, topic, keys, vals, magic)
            errs: list = []
            c = p13_consumer(kit, cluster.bootstrap_servers(), backend,
                             f"p13-legacy-{magic}", old, errs)
            polys = p13_count_polys(c)
            regions = [0]
            submit = c._rk.codec_provider.crc32_submit

            def counting(bufs, *a, **kw):
                regions[0] += len(bufs)
                return submit(bufs, *a, **kw)
            c._rk.codec_provider.crc32_submit = counting
            crc.launches = 0
            rate = p6_consume(c, topic, keys, vals)
            launches = crc.launches
            polys = dict(polys)     # the read's launches, not the corrupt one's
            p13_check(polys["crc32"] > 0 and polys["crc32c"] == 0
                      and regions[0] >= wrappers,
                      f"13c {bver}: launches by polynomial {polys}, "
                      f"{regions[0]} regions in crc32_submit of {wrappers}")
            p13_check(not card or launches > 0, f"13c {bver}: no crc_rows "
                      "launch")
            p13_engines_clean([c], False, f"13c {bver} consumer")
            p13_bad_legacy(kit, p, c, cluster, errs, bver)
            total["crc_rows"] += crc.launches
        finally:
            for cl in (c, p):
                if cl is not None:
                    cl.close()
            cluster.stop()
        out.append(f"{bver} (MsgVer{magic}): {wrappers} lz4 wrappers "
                   f"exact (zlib CRCs inside and out), read back at "
                   f"{rate:.1f} msgs/s, crc32 launches {polys['crc32']} "
                   f"(crc_rows {launches}), {regions[0]} legacy regions "
                   f"through crc32_submit, flipped byte -> _BAD_MSG")
    mixed = p13_mixed(kit, backend, parts, device)
    total["crc_rows"] += mixed["crc_rows"]
    print(f"phase 13c: {parts} x {P13_LEGACY_PER} x {VALUE_SIZE} B a "
          f"version; " + "; ".join(out) + f" [{smi}]")
    print(f"  mixed log over {parts} partitions ({P13_MIXED_RUN} MsgVer1 "
          f"then {P13_MIXED_RUN} v2 records each): {mixed['records']} read "
          f"in order; {mixed['legacy']} legacy regions through "
          f"crc32_submit, {mixed['inline']} v2 batches verified inline on "
          f"the host (client/kafka.py's mixed-log split, the reference's "
          f"route too, not a fallback) [{smi}]")
    return total


def p13_bad_legacy(kit, p, c, cluster, errs: list, bver: str) -> None:
    """A stored legacy wrapper with one byte flipped: the consumer
    reports _BAD_MSG and delivers nothing of it."""
    for i in range(10):
        p.produce("p13-bad", value=b"corrupt-%02d " % i * 40, partition=0)
    p13_check(p.flush(60) == 0, f"13c {bver}: p13-bad flush() did not drain")
    part = cluster.partition("p13-bad", 0)
    base, blob = part.log[0]
    bad = bytearray(blob)
    bad[-5] ^= 0xFF
    part.log[0] = (base, bytes(bad))
    c.assign([kit.TopicPartition("p13-bad", 0, OFFSET_BEGINNING)])
    deadline = time.monotonic() + 30
    while (not any(e.code == kit.Err._BAD_MSG for e in errs)
           and time.monotonic() < deadline):
        m = c.poll(0.2)
        p13_check(m is None or m.error is not None,
                  f"13c {bver}: the corrupted wrapper was delivered")
    p13_check(any(e.code == kit.Err._BAD_MSG for e in errs),
              f"13c {bver}: the consumer reported {errs}, not _BAD_MSG")


def p13_mixed(kit, backend: dict, parts: int, device: str) -> dict:
    """0118's test_mixed_msgver_log over ``parts`` partitions: each log
    holds a MsgVer1 run, then the v2 batch a GPU producer appends; a
    check.crcs GPU consumer reads every record in order.  Counts the
    legacy regions through crc32_submit and the v2 batches verified
    inline (client/kafka.py's mixed-log split calls verify_crc_v2)."""
    from librdkafka_tpu_torch.client import kafka as port_kafka
    from librdkafka_tpu_torch.protocol.msgset import Record
    run = P13_MIXED_RUN
    keys = p13_keys(parts)
    old = p13_values(parts, run)
    new = [[b"new-%d-%d " % (i, j) * 40 for j in range(run)]
           for i in range(parts)]
    cluster = kit.MockCluster(num_brokers=1, topics={"p13-mixed": parts})
    p = c = None
    inline = [0]
    verify = port_kafka.verify_crc_v2

    def counting(info, full):
        inline[0] += 1
        return verify(info, full)
    try:
        for i in range(parts):
            cluster.partition("p13-mixed", i).append(write_msgset_v01(
                [Record(key=keys[i], value=v, timestamp=NOW_MS + j)
                 for j, v in enumerate(old[i])], magic=1, codec=None,
                now_ms=NOW_MS))
        p = p13_producer(kit, cluster.bootstrap_servers(), backend,
                         {"linger.ms": 1000, "batch.num.messages": run})
        p6_produce(p, "p13-mixed", keys, new, ts0=NOW_MS)
        c = p13_consumer(kit, cluster.bootstrap_servers(), backend,
                         "p13-mixed", {})
        legacy = [0]
        submit = c._rk.codec_provider.crc32_submit

        def counting_submit(bufs, *a, **kw):
            legacy[0] += len(bufs)
            return submit(bufs, *a, **kw)
        c._rk.codec_provider.crc32_submit = counting_submit
        crc.launches = 0
        port_kafka.verify_crc_v2 = counting
        vals = [old[i] + new[i] for i in range(parts)]
        p6_consume(c, "p13-mixed", keys, vals)
        p13_check(legacy[0] >= parts * run and inline[0] >= parts,
                  f"13c mixed: {legacy[0]} legacy regions through "
                  f"crc32_submit, {inline[0]} v2 batches verified inline")
        p13_check(device == "cpu" or crc.launches > 0,
                  "13c mixed: no crc_rows launch")
        p13_engines_clean([c], False, "13c mixed consumer")
    finally:
        port_kafka.verify_crc_v2 = verify
        for cl in (c, p):
            if cl is not None:
                cl.close()
        cluster.stop()
    return {"records": parts * 2 * run, "legacy": legacy[0],
            "inline": inline[0], "crc_rows": crc.launches}


def p13_faults(kit, backend: dict, tag: str, extra: dict, parts: int,
               per: int, device: str, smi: str) -> dict:
    """13d, one leg: the idempotent GPU producer's link throttled to
    30 kB/s mid-ProduceRequest, then every connection killed: each
    record stored once, in order, exact, every retried batch rebuilt
    through the device route; a check.crcs GPU consumer's connection
    killed mid-fetch; then head-of-line blocking: one producer (one
    engine) on two brokers, one of them 2,500 ms away."""
    from librdkafka_tpu_torch.protocol.proto import ApiKey
    card = device != "cpu"
    dev = bool(extra)
    keys, vals = p13_keys(parts), p13_values(parts, per)
    topic = f"p13-net-{tag}"
    cluster = kit.MockCluster(num_brokers=1, topics={topic: parts,
                                                     "p13-warm": 1})
    em = kit.Sockem()
    cem = kit.Sockem()
    retries = [0]
    requeue = kit.Toppar.enqueue_retry_batch

    def counting(self, msgs):
        retries[0] += 1
        return requeue(self, msgs)
    p = c = None
    try:
        p = p13_producer(kit, cluster.bootstrap_servers(),
                         {**backend, **extra},
                         {"connect_cb": em.connect_cb,
                          "retry.backoff.ms": 50,
                          "message.send.max.retries": 20,
                          "message.timeout.ms": 120000})
        p.produce("p13-warm", value=b"warm", partition=0)
        p13_check(p.flush(30) == 0, f"13d {tag}: warm-up flush")
        prov = p._rk.codec_provider
        submitted = [0]
        if dev:
            submit_lz4 = prov.compress_submit

            def recording(codec, bufs, *a, **kw):
                submitted[0] += len(bufs) if codec == "lz4" else 0
                return submit_lz4(codec, bufs, *a, **kw)
            prov.compress_submit = recording
        else:
            submit_crc = prov.crc32c_submit

            def recording(bufs, *a, **kw):
                submitted[0] += len(bufs)
                return submit_crc(bufs, *a, **kw)
            prov.crc32c_submit = recording
        kit.Toppar.enqueue_retry_batch = counting
        crc.launches = 0
        lz4.launches = 0
        em.set(rate_bps=30000)
        t0 = time.perf_counter()
        n = parts * per
        for j in range(per):
            for i in range(parts):
                p.produce(topic, value=vals[i][j], key=keys[i], partition=i)
        # a ProduceRequest written to the throttled socket is mid-transfer
        p11_wait(p, lambda: any(r.api == ApiKey.Produce
                                for b in list(p._rk.brokers.values())
                                for r in list(b.waitresp.values())),
                 f"13d {tag}: a ProduceRequest on the wire")
        killed = em.kill_all()
        em.set(rate_bps=0)
        p13_check(p.flush(300) == 0, f"13d {tag}: flush() did not drain")
        secs = time.perf_counter() - t0
        kit.Toppar.enqueue_retry_batch = requeue
        prod = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        nbatch = p6_check_stored(cluster, topic, keys, vals, det=dev)
        p13_check(killed >= 1 and retries[0] >= 1,
                  f"13d {tag}: killed {killed} connections, {retries[0]} "
                  "batches requeued")
        p13_check(submitted[0] >= nbatch + retries[0],
                  f"13d {tag}: {submitted[0]} batches through the device "
                  f"route, fewer than {nbatch} stored + {retries[0]} retried")
        p13_check(not card or prod["lz4_rows" if dev else "crc_rows"] > 0,
                  f"13d {tag}: producer kernel launches {prod}")
        p13_engines_clean([p], dev, f"13d {tag} producer")
        # a twelfth of the topic fetched ahead: the kill lands with
        # fetches still to come
        c = p13_consumer(kit, cluster.bootstrap_servers(), backend,
                         f"p13-net-{tag}",
                         {"connect_cb": cem.connect_cb,
                          "queued.max.messages.kbytes":
                          max(64, n * VALUE_SIZE // 1024 // 12)})
        crc.launches = 0
        dropped = []
        rate = p6_consume(c, topic, keys, vals,
                           kill=lambda: dropped.append(cem.kill_all()))
        p13_check(dropped and dropped[0] >= 1, f"13d {tag}: no consumer "
                  "connection to kill")
        p13_check(eos_engine(c).stats["launches"] > 0 and
                  (not card or crc.launches > 0),
                  f"13d {tag}: the consumer made no CRC launch")
        p13_engines_clean([c], False, f"13d {tag} consumer")
        cons = crc.launches
    finally:
        kit.Toppar.enqueue_retry_batch = requeue
        for cl in (c, p):
            if cl is not None:
                cl.close()
        cluster.stop()
    holb = p13_holb(kit, {**backend, **extra}, tag, device)
    print(f"phase 13d, leg {tag} "
          f"({'gpu.compress.device' if dev else 'CRC tickets'}): link at "
          f"30 kB/s mid-ProduceRequest, {killed} connections killed: "
          f"{n} records x {VALUE_SIZE} B stored once, in order, in "
          f"{nbatch} exact batches after {retries[0]} requeued batches, "
          f"{submitted[0]} batches through the device route "
          f"({secs:.3f} s to flush); consumer connection killed mid-fetch "
          f"({dropped[0]}), every record read once in order at "
          f"{rate:.1f} msgs/s [{smi}]")
    print(f"  HOLB: fast broker's 20 DRs in {holb['max']:.3f} s (p99 "
          f"{holb['p99']:.3f} s), slow broker's from {holb['slow']:.3f} s; "
          f"launches crc_rows {prod['crc_rows'] + cons + holb['crc_rows']}, "
          f"lz4_rows {prod['lz4_rows'] + holb['lz4_rows']} [{smi}]")
    return {"crc_rows": prod["crc_rows"] + cons + holb["crc_rows"],
            "lz4_rows": prod["lz4_rows"] + holb["lz4_rows"]}


def p13_holb(kit, backend: dict, tag: str, device: str) -> dict:
    """0093's head-of-line blocking on one GPU producer (one engine for
    both broker threads): broker 1 at 2,500 ms RTT, broker 2's 20 DRs
    under 2.0 s."""
    cluster = kit.MockCluster(num_brokers=2, topics={"holb": 2})
    cluster.set_partition_leader("holb", 0, 1)
    cluster.set_partition_leader("holb", 1, 2)
    fast, slow = [], []
    p = None
    try:
        p = p13_producer(kit, cluster.bootstrap_servers(), backend,
                         {"linger.ms": 2})
        for q in (0, 1):
            p.produce("holb", value=b"w%d" % q * 64, partition=q)
        p13_check(p.flush(30) == 0, f"13d {tag} HOLB: warm-up flush")
        launch0 = eos_engine(p).stats["launches"]
        comp0 = eos_engine(p).compress_stats["launches"]
        crc.launches = 0
        lz4.launches = 0
        cluster.set_rtt(1, 2500)
        t0 = time.monotonic()
        for i in range(20):
            p.produce("holb", value=b"s%02d" % i * 64, partition=0,
                      on_delivery=lambda e, m: slow.append(
                          time.monotonic() - t0))
            p.produce("holb", value=b"f%02d" % i * 64, partition=1,
                      on_delivery=lambda e, m: fast.append(
                          time.monotonic() - t0))
        deadline = time.monotonic() + 10
        while len(fast) < 20 and time.monotonic() < deadline:
            p.poll(0.01)
        p13_check(len(fast) == 20 and max(fast) < 2.0,
                  f"13d {tag} HOLB: fast DRs {len(fast)} of 20, last at "
                  f"{max(fast, default=-1):.3f} s (limit 2.0)")
        p13_check(p.flush(30) == 0, f"13d {tag} HOLB: flush()")
        deadline = time.monotonic() + 5
        while len(slow) < 20 and time.monotonic() < deadline:
            p.poll(0.05)
        p13_check(len(slow) == 20 and min(slow) >= 2.0,
                  f"13d {tag} HOLB: slow DRs {len(slow)}, first at "
                  f"{min(slow, default=-1):.3f} s")
        eng = eos_engine(p)
        p13_check(eng.stats["launches"] - launch0 > 0
                  or eng.compress_stats["launches"] - comp0 > 0,
                  f"13d {tag} HOLB: the producer's engine launched nothing")
        p13_engines_clean([p], "gpu.compress.device" in backend,
                          f"13d {tag} HOLB")
        counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
    finally:
        if p is not None:
            p.close()
        cluster.stop()
    return {"max": max(fast), "p99": float(np.percentile(fast, 99)),
            "slow": min(slow), **counts}


def phase_planes(smi: str, parts: int = PARTITIONS,
                 per_part: int = P13_PER_PART, device: str = "cuda") -> dict:
    """Phase 13: the client's TLS, SASL, admin, legacy-broker and
    socket-fault planes on the card (13a-13d).  Returns its launches."""
    import tempfile
    t0 = time.perf_counter()
    kit = p13_kit()
    backend = {"compression.backend": "gpu", "gpu.device": device, **P6_GPU}
    total = {"crc_rows": 0, "lz4_rows": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]
    # a client thread that dies of an exception fails the phase (a dead
    # broker thread would pass "no thread left")
    died: list = []
    hook = threading.excepthook

    def record(args):
        died.append(f"{args.thread.name}: {args.exc_type.__name__}")
        hook(args)
    threading.excepthook = record
    try:
        with tempfile.TemporaryDirectory() as tmp:
            certs = p13_certs(tmp)
            for tag, extra in P13_LEGS:
                leg = p13_tls(kit, certs, backend, tag, extra, parts,
                              per_part, device, smi, refuse=tag == "a")
                try:
                    add(leg["counts"])
                    if tag == "a":
                        add(p13_admin(kit, leg["cluster"], certs, backend,
                                      parts, per_part, device, smi))
                finally:
                    leg["cluster"].stop()
        add(p13_legacy(kit, backend, parts, device, smi))
        for tag, extra in P13_LEGS:
            add(p13_faults(kit, backend, tag, extra, parts, per_part, device,
                           smi))
    finally:
        threading.excepthook = hook
    p13_check(not died, f"phase 13: threads died of exceptions: {died}")
    secs = time.perf_counter() - t0
    check(secs <= P13_LIMIT_S, f"phase 13 took {secs:.3f} s, over its "
          f"{P13_LIMIT_S} s")
    print(f"phase 13: ok ({secs:.3f} s: 13a TLS + SASL on two legs, 13b "
          f"admin, 13c legacy brokers and a mixed log, 13d socket faults "
          f"on two legs; {parts} x {per_part} x {VALUE_SIZE} B; launches "
          f"crc_rows {total['crc_rows']}, lz4_rows {total['lz4_rows']}) "
          f"[{smi}]")
    return total


# --------------------------------------------------------------- phase 14 --

P14_LIMIT_S = 90
#: 14a: single 1 KB records at linger.ms 0, acks=all, each awaited
P14_LAT_N = 500
#: 14b: the topic-scope codecs (one topic each; the lz4 topic inherits
#: the global lz4), partitions a topic, records a partition, and the
#: batch cut (with linger.ms 1,000 every batch is cut by count, so the
#: blobs of two rounds compare)
P14_CODECS = ("none", "gzip", "snappy", "lz4", "zstd")
P14_CODEC_PARTS, P14_CODEC_PER, P14_BATCH = 16, 1600, 400
#: 14c: application threads, records a thread, partitions, brokers
P14_THREADS, P14_THREAD_PER, P14_LOAD_PARTS = 4, 25600, 64
P14_LEGS = (("a", {}), ("b", {"gpu.compress.device": True}))


class LoadError(RuntimeError):
    """Phase 14 (latency, codecs, the client under load) broke one of its
    checks."""


def p14_check(cond: bool, msg: str) -> None:
    if not cond:
        raise LoadError(msg)


def p14_zstd() -> str | None:
    """The zstandard module's version, or None where it does not import
    (the zstd codec needs it in both packages)."""
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard.__version__


def p14_engine_delta(client, before: dict | None) -> dict:
    """The routes a client's engine took since ``before`` (its
    eos_snapshot): launches, CPU routes, fan-in waits and skips."""
    snap = eos_snapshot(eos_engine(client))
    if snap is None:
        return {}
    keys = ("launches", "cpu_fallback_jobs", "routed_cpu_jobs",
            "warmup_miss_jobs", "fanin_waits", "fanin_skips")
    out = {k: snap["stats"][k] - (before["stats"][k] if before else 0)
           for k in keys}
    out["compress.launches"] = (snap["compress"]["launches"] -
                                (before["compress"]["launches"]
                                 if before else 0))
    return out


def p14_batches(cluster, topic: str, parts: int) -> list:
    """Every stored batch of ``topic``, per partition: (info, records
    payload decompressed, full batch); each batch's CRC must equal the
    native crc32c of its region."""
    from librdkafka_tpu_torch.protocol.msgset import iter_batches
    dec = CpuCodecProvider()
    out = []
    for i in range(parts):
        rows = []
        for _base, blob in cluster.partition(topic, i).log:
            for info, payload, full in iter_batches(blob):
                rows.append((info, payload, full))
        crcs = native.crc32c_many([bytes(f[V2_OF_Attributes:])
                                   for _i, _p, f in rows]).tolist()
        p14_check(crcs == [inf.crc for inf, _p, _f in rows],
                  f"{topic}[{i}]: a stored CRC != the native crc32c")
        out.append([(inf, dec.decompress_many(inf.codec, [bytes(pl)])[0]
                     if inf.codec else bytes(pl), full)
                    for inf, pl, full in rows])
    return out


def p14_values(batches) -> list:
    """The (key, value) pairs of ``p14_batches``' output, per partition."""
    from librdkafka_tpu_torch.protocol.msgset import parse_records_v2
    return [[(r.key, r.value) for info, raw, _f in part
             for r in parse_records_v2(info, raw)] for part in batches]


def p14_wrap_submit(prov, attr: str, count) -> None:
    """Wrap ``prov.<attr>`` (crc32c_submit or compress_submit) so that
    ``count(args)`` sees every call's arguments first."""
    submit = getattr(prov, attr, None)
    if submit is None:
        return

    def wrapped(*a, **kw):
        count(*a)
        return submit(*a, **kw)
    setattr(prov, attr, wrapped)


def p14_region_codecs(prov) -> dict:
    """Count the v2 batch regions ``prov``'s CRC tickets carry, by the
    codec bits of their attributes (a region starts at them)."""
    from librdkafka_tpu_torch.protocol.proto import (ATTR_CODEC_MASK,
                                                    CODEC_NAMES)
    seen: dict = {}

    def count(bufs, *_):
        for b in bufs:
            c = CODEC_NAMES.get(int.from_bytes(bytes(b[:2]), "big")
                                & ATTR_CODEC_MASK, "none")
            seen[c] = seen.get(c, 0) + 1
    p14_wrap_submit(prov, "crc32c_submit", count)
    return seen


# ------------------------------------------------------------------ 14a --

def p14_deliver_one(p, topic: str, value: bytes, timeout: float = 10.0,
                    **kw) -> float:
    """0055's _deliver_one: seconds from produce() to the record's DR."""
    done: list = []
    t0 = time.monotonic()
    p.produce(topic, value=value, partition=0,
              on_delivery=lambda e, m: done.append((time.monotonic(), e)),
              **kw)
    deadline = t0 + timeout
    while not done and time.monotonic() < deadline:
        p.poll(0.001)
    p14_check(bool(done), f"{topic}: a record was never delivered")
    p14_check(done[0][1] is None, f"{topic}: DR error {done[0][1]}")
    return done[0][0] - t0


def p14_high_linger(kit, cluster, conf: dict, tag: str) -> float:
    """0055's second case: flush() overrides linger.ms 5,000."""
    topic = f"p14-high-{tag}"
    p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "linger.ms": 5000, "batch.num.messages": 10000,
                      **conf})
    try:
        eos_warm(p)
        p.produce(topic, value=b"warm", partition=0)
        p14_check(p.flush(10.0) == 0, f"14a {tag}: warm flush")
        for i in range(50):
            p.produce(topic, value=b"m%d" % i, partition=0)
        time.sleep(0.4)
        part = cluster.partition(topic, 0)
        p14_check(part.end_offset == 1, f"14a {tag}: a lingering record "
                  f"was sent before linger.ms (end offset {part.end_offset})")
        t0 = time.monotonic()
        p14_check(p.flush(10.0) == 0, f"14a {tag}: flush under linger")
        secs = time.monotonic() - t0
    finally:
        p.close()
    p14_check(secs < 2.0, f"14a {tag}: flush() waited {secs:.3f} s for "
              "linger.ms (0055's bound 2 s)")
    p14_check(part.end_offset == 51 and len(part.log) == 2,
              f"14a {tag}: the 50 lingering records are not one batch "
              f"(end offset {part.end_offset}, {len(part.log)} blobs)")
    return secs


def p14_int_latency(kit, cluster, conf: dict, tag: str) -> float:
    """0055's third case: int_latency's max (us) at linger.ms 300."""
    topic = f"p14-il-{tag}"
    blobs: list = []
    p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "linger.ms": 300, "statistics.interval.ms": 200,
                      "stats_cb": lambda js: blobs.append(json.loads(js)),
                      **conf})
    try:
        eos_warm(p)
        blobs.clear()
        for i in range(20):
            p.produce(topic, value=b"s%d" % i, partition=0)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            p.poll(0.1)
            if any(b["int_latency"]["cnt"] for b in blobs):
                break
    finally:
        p.close()
    il = next((b["int_latency"] for b in blobs if b["int_latency"]["cnt"]),
              None)
    p14_check(il is not None and il["max"] >= 250_000,
              f"14a {tag}: int_latency {il}, max not >= 250,000 us (0055)")
    return il["max"]


def p14_latency_leg(kit, cluster, tag: str, conf: dict, n: int, card: bool,
                    gated: bool) -> dict:
    """14a, one leg: 0055's three cases, then ``n`` single 1 KB records
    at linger.ms 0 and acks=all to one partition, each awaited; the
    produce -> DR latencies and the routes the engine took."""
    low = []
    p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "linger.ms": 0, "acks": -1,
                      "compression.codec": "lz4", **conf})
    topic = f"p14-lat-{tag}"
    try:
        eos_warm(p)
        p14_deliver_one(p, f"p14-low-{tag}", b"lat")   # the connection
        low = [p14_deliver_one(p, f"p14-low-{tag}", b"lat")
               for _ in range(5)]
        p14_deliver_one(p, topic, b"w" * VALUE_SIZE)   # topic's metadata
        base = cluster.partition(topic, 0).end_offset
        vals = payloads(n, VALUE_SIZE)
        before = eos_snapshot(eos_engine(p))
        crc.launches = 0
        lz4.launches = 0
        lat = [p14_deliver_one(p, topic, v) for v in vals]
        counts = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        routes = p14_engine_delta(p, before)
    finally:
        p.close()
    p14_check(min(low) < 0.15, f"14a {tag}: the least linger.ms=0 "
              f"delivery took {min(low) * 1000:.1f} ms, not under 150 ms "
              "(0055)")
    batches = p14_batches(cluster, topic, 1)[0][base:]
    got = [v for part in p14_values([batches]) for _k, v in part]
    p14_check(got == vals, f"14a {tag}: stored records != produced")
    nb = len(batches)
    if gated:
        dev = conf.get("gpu.compress.device", False)
        p14_check(nb == n, f"14a {tag}: {nb} batches for {n} awaited "
                  "records")
        want = ({"launches": 0, "compress.launches": nb} if dev
                else {"launches": nb, "compress.launches": 0})
        p14_check({k: routes[k] for k in want} == want,
                  f"14a {tag}: engine routes {routes}, not one launch a "
                  f"batch ({nb} batches)")
        p14_check(not any(routes[k] for k in (
            "cpu_fallback_jobs", "routed_cpu_jobs", "warmup_miss_jobs")),
            f"14a {tag}: jobs on a CPU route: {routes}")
        p11_no_cpu(eos_snapshot(eos_engine(p)), f"14a {tag}", dev)
        if card:
            want = ({"crc_rows": 0, "lz4_rows": nb} if dev
                    else {"crc_rows": nb, "lz4_rows": 0})
            p14_check(counts == want, f"14a {tag}: kernel launches "
                      f"{counts}, not {want}")
    ms = np.array(lat) * 1000.0
    return {"low_s": min(low), "p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)), "max": float(ms.max()),
            "batches": nb, "routes": routes, "counts": counts}


def p14_latency(kit, legs, n: int, device: str, smi: str) -> dict:
    """14a: 0055 on every leg (``legs``: (tag, producer conf, gated)),
    then the linger-0 run.  Returns each leg's readings and the kernel
    launches of the gated legs."""
    card = device != "cpu"
    out, total = {}, {"crc_rows": 0, "lz4_rows": 0}
    for tag, conf, gated in legs:
        cluster = kit.MockCluster(num_brokers=1, topics={
            f"p14-{k}-{tag}": 1 for k in ("low", "high", "il", "lat")})
        try:
            r = p14_latency_leg(kit, cluster, tag, conf, n, card, gated)
            r["flush_s"] = p14_high_linger(kit, cluster, conf, tag)
            r["int_latency_max_us"] = p14_int_latency(kit, cluster, conf,
                                                      tag)
        finally:
            cluster.stop()
        for k in total:
            total[k] += r["counts"][k]
        out[tag] = r
        rt = r["routes"]
        print(f"phase 14a, leg {tag}: 0055 least linger-0 delivery "
              f"{r['low_s'] * 1000:.3f} ms (< 150), flush under linger.ms "
              f"5000 {r['flush_s']:.3f} s (< 2, 50 records one batch), "
              f"int_latency max {r['int_latency_max_us']:.0f} us (>= "
              f"250,000); {n} x {VALUE_SIZE} B at linger.ms 0, acks=all, "
              f"each awaited: produce->DR p50 {r['p50']:.3f} ms, p99 "
              f"{r['p99']:.3f} ms, max {r['max']:.3f} ms; {r['batches']} "
              f"batches, CRCs exact [{smi}]")
        print(f"  routes: crc_rows {r['counts']['crc_rows']}, lz4_rows "
              f"{r['counts']['lz4_rows']}, engine "
              + (", ".join(f"{k} {v}" for k, v in rt.items()) if rt
                 else "none (CPU provider)")
              + ("" if gated else " (not gated: printed as they fall)"))
    out["counts"] = total
    return out


# ------------------------------------------------------------------ 14b --

def p14_codec_round(kit, cluster, conf: dict, codecs, keys, vals,
                    provider=None) -> dict:
    """One Producer (global codec lz4; topic p14-<codec> overrides it,
    the lz4 topic inherits) sends ``vals[i][j]`` to partition i of every
    codec's topic, the topics interleaved, with fixed timestamps and
    batches cut by count, then flush().  ``provider`` replaces the
    client's codec provider before the first record (the deterministic
    oracle).  Returns the producer's CRC-ticket regions by codec, its
    compress submissions and its engine's routes."""
    p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "enable.idempotence": True, "compression.codec": "lz4",
                      "linger.ms": 1000, "batch.num.messages": P14_BATCH,
                      "queue.buffering.max.messages": 1_000_000, **conf})
    try:
        if provider is not None:
            p._rk.codec_provider = provider
        eos_warm(p)
        for c in codecs:
            p.set_topic_conf(f"p14-{c}", {"compression.codec":
                                          "inherit" if c == "lz4" else c})
        prov = p._rk.codec_provider
        regions = p14_region_codecs(prov)
        comp = {}
        p14_wrap_submit(prov, "compress_submit", lambda codec, bufs, *_:
                        comp.__setitem__(codec, comp.get(codec, 0)
                                         + len(bufs)))
        before = eos_snapshot(eos_engine(p))
        produce = p.produce
        t0 = time.perf_counter()
        for j in range(len(vals[0])):
            for c in codecs:
                topic = f"p14-{c}"
                for i in range(len(vals)):
                    produce(topic, value=vals[i][j], key=keys[i],
                            partition=i, timestamp=NOW_MS + j)
        p14_check(p.flush(300) == 0, "14b: flush() did not drain")
        secs = time.perf_counter() - t0
        routes = p14_engine_delta(p, before)
        snap = eos_snapshot(eos_engine(p))
    finally:
        p.close()
    return {"regions": regions, "compress": comp, "routes": routes,
            "snap": snap, "secs": secs}


def p14_corrupt(kit, cluster, p, c, errs: list, codec: str,
                tag: str) -> None:
    """A ``codec`` batch with one byte flipped reaches the check.crcs
    consumer as _BAD_MSG and delivers nothing."""
    topic = f"p14-bad-{codec}-{tag}"
    p.set_topic_conf(topic, {"compression.codec": codec})
    for i in range(10):
        p.produce(topic, value=b"corrupt-%02d " % i * 40, partition=0)
    p14_check(p.flush(60) == 0, f"{topic}: flush() did not drain")
    part = cluster.partition(topic, 0)
    base, blob = part.log[0]
    p14_check(int.from_bytes(blob[V2_OF_Attributes:V2_OF_Attributes + 2],
                             "big") & 7 == {"gzip": 1, "zstd": 4}[codec],
              f"{topic}: the batch to corrupt is not {codec}")
    bad = bytearray(blob)
    bad[-5] ^= 0xFF
    part.log[0] = (base, bytes(bad))
    errs.clear()
    c.assign([kit.TopicPartition(topic, 0, OFFSET_BEGINNING)])
    deadline = time.monotonic() + 30
    while (not any(e.code == kit.Err._BAD_MSG for e in errs)
           and time.monotonic() < deadline):
        m = c.poll(0.2)
        p14_check(m is None or m.error is not None,
                  f"{topic}: the corrupted {codec} batch was delivered")
    p14_check(any(e.code == kit.Err._BAD_MSG for e in errs),
              f"{topic}: the consumer reported {errs}, not _BAD_MSG")
    c.unassign()


def p14_codecs(kit, backend: dict, legs, parts: int, per: int, device: str,
               smi: str) -> dict:
    """14b: the topic-scope codec matrix on each of ``legs`` ((tag,
    extra) over ``backend``), held to the CPU provider's round byte for
    byte (the deterministic encoder's on a compress-device leg's lz4
    topic), CRCs exact, every batch through the leg's kernel, then read
    back by a check.crcs GPU Consumer with two corrupted batches."""
    card = device != "cpu"
    zstd = p14_zstd()
    codecs = tuple(c for c in P14_CODECS if c != "zstd" or zstd)
    print(f"phase 14b: import zstandard {zstd or 'fails: the zstd topic is '
          'left out'}; codecs {', '.join(codecs)}")
    keys, vals = p13_keys(parts), p13_values(parts, per)
    topics = {f"p14-{c}": parts for c in codecs}

    def blobs_of(conf, provider=None, only=codecs):
        cl = kit.MockCluster(num_brokers=1, topics=topics,
                             auto_create_topics=False)
        try:
            p14_codec_round(kit, cl, conf, only, keys, vals, provider)
            return {c: p13_blobs(cl, f"p14-{c}") for c in only}
        finally:
            cl.stop()
    ref = blobs_of({"compression.backend": "cpu"})
    det = None
    if any(extra.get("gpu.compress.device") for _t, extra in legs):
        det = blobs_of({"compression.backend": "cpu"}, DetProvider(),
                       ("lz4",))["lz4"]
    total = {"crc_rows": 0, "lz4_rows": 0}
    out = {}
    for tag, extra in legs:
        dev = bool(extra.get("gpu.compress.device"))
        cluster = kit.MockCluster(num_brokers=1, topics={
            **topics, f"p14-bad-gzip-{tag}": 1, f"p14-bad-zstd-{tag}": 1},
            auto_create_topics=False)
        c = None
        try:
            crc.launches = 0
            lz4.launches = 0
            r = p14_codec_round(kit, cluster, {**backend, **extra}, codecs,
                                keys, vals)
            prod = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
            nb = {}
            for cd in codecs:
                t = f"p14-{cd}"
                batches = p14_batches(cluster, t, parts)
                want = None if cd == "none" else cd
                p14_check(all(inf.codec == want for part in batches
                              for inf, _r, _f in part),
                          f"14b {tag} {t}: a batch's codec bits are not "
                          f"{cd}'s")
                p14_check(p14_values(batches) ==
                          [[(k, v) for v in vals[i]]
                           for i, k in enumerate(keys)],
                          f"14b {tag} {t}: stored records != produced")
                nb[cd] = sum(len(part) for part in batches)
                oracle = det if dev and cd == "lz4" else ref[cd]
                p14_check(p13_blobs(cluster, t) == oracle,
                          f"14b {tag} {t}: the stored blobs != the CPU "
                          f"provider's round"
                          + (" (deterministic encoder)"
                             if dev and cd == "lz4" else ""))
            regions, comp = r["regions"], r["compress"]
            want = {cd: n for cd, n in nb.items() if not (dev and cd == "lz4")}
            p14_check(regions == want, f"14b {tag}: CRC-ticket regions by "
                      f"codec {regions}, stored batches {nb}")
            if dev:
                p14_check(comp.get("lz4", 0) == nb["lz4"] and
                          r["routes"]["compress.launches"] > 0,
                          f"14b {tag}: lz4 batches through the compress "
                          f"route {comp}, stored {nb['lz4']}")
            p11_no_cpu(r["snap"], f"14b {tag} producer", dev)
            p14_check(r["routes"]["launches"] > 0,
                      f"14b {tag}: the producer's engine made no CRC launch")
            if card:
                p14_check(prod["crc_rows"] > 0 and
                          (prod["lz4_rows"] > 0) == dev,
                          f"14b {tag}: producer kernel launches {prod}")
            # read back: every record in order, a verify region a batch
            errs: list = []
            c = p13_consumer(kit, cluster.bootstrap_servers(), backend,
                             f"p14-{tag}", {}, errs)
            verified = eos_count_control(c)
            cbefore = eos_snapshot(eos_engine(c))
            crc.launches = 0
            rates = {cd: p6_consume(c, f"p14-{cd}", keys, vals)
                     for cd in codecs}
            c.unassign()
            p14_check(verified[0] == sum(nb.values()),
                      f"14b {tag}: {verified[0]} verify-ticket regions for "
                      f"{sum(nb.values())} stored batches")
            croutes = p14_engine_delta(c, cbefore)
            p14_check(croutes["launches"] > 0 and
                      (not card or crc.launches > 0),
                      f"14b {tag}: the consumer made no CRC launch")
            p11_no_cpu(eos_snapshot(eos_engine(c)), f"14b {tag} consumer",
                       False)
            cons = crc.launches
            p = kit.Producer({"bootstrap.servers":
                              cluster.bootstrap_servers(), "linger.ms": 5,
                              "compression.backend": "cpu"})
            try:
                for cd in ("gzip", "zstd"):
                    if cd in codecs:
                        p14_corrupt(kit, cluster, p, c, errs, cd, tag)
            finally:
                p.close()
        finally:
            if c is not None:
                c.close()
            cluster.stop()
        counts = {"crc_rows": prod["crc_rows"] + cons,
                  "lz4_rows": prod["lz4_rows"]}
        for k in total:
            total[k] += counts[k]
        out[tag] = {"batches": nb, "secs": r["secs"]}
        n = len(codecs) * parts * per
        print(f"phase 14b, leg {tag} "
              f"({'gpu.compress.device' if dev else 'CRC tickets'}): "
              f"{n} records x {VALUE_SIZE} B over {len(codecs)} topics of "
              f"{parts} idempotent partitions ({n * VALUE_SIZE / 1e6:.1f} "
              f"MB) in {r['secs']:.3f} s; stored batches {nb}, codec bits "
              f"and CRCs exact, blobs == the CPU provider's round"
              f"{' (lz4: the deterministic encoder)' if dev else ''}; CRC "
              f"tickets {regions}"
              + (f", lz4 through lz4_rows {comp.get('lz4', 0)}" if dev
                 else "")
              + f"; read back in order ({sum(nb.values())} verify regions), "
              f"{'gzip and zstd' if 'zstd' in codecs else 'gzip'} flipped "
              f"byte -> _BAD_MSG [{smi}]")
        print("  consume msgs/s: " + ", ".join(
            f"{cd} {rt:.1f}" for cd, rt in rates.items())
            + f"; launches crc_rows {counts['crc_rows']}, lz4_rows "
            f"{counts['lz4_rows']} [{smi}]")
    out["counts"] = total
    out["codecs"] = codecs
    return out


# ------------------------------------------------------------------ 14c --

def p14_load_values(threads: int, per: int) -> list:
    """Each application thread's values: 1 KB, the thread and index in
    the first bytes."""
    flat = payloads(threads * per, VALUE_SIZE)
    return [[b"t%d-%06d|" % (t, j) + flat[t * per + j][10:]
             for j in range(per)] for t in range(threads)]


def p14_threads_produce(p, topic: str, vals, parts: int, mid=None) -> float:
    """``len(vals)`` application threads each produce their values round
    robin over ``parts`` partitions into one Producer; ``mid()`` runs on
    this thread once half the records are in.  msgs/s to flush()."""
    errors: list = []
    half = threading.Event()
    done = [0]
    lock = threading.Lock()
    n = sum(len(v) for v in vals)

    def worker(t):
        try:
            for j, v in enumerate(vals[t]):
                while True:
                    try:
                        p.produce(topic, value=v,
                                  partition=(t * len(vals[t]) + j) % parts)
                        break
                    except Exception as e:     # queue full: back off
                        if "QUEUE_FULL" not in str(e):
                            raise
                        p.poll(0.01)
                with lock:
                    done[0] += 1
                    if done[0] == n // 2:
                        half.set()
        except Exception as e:
            errors.append(e)
    t0 = time.perf_counter()
    ths = [threading.Thread(target=worker, args=(t,), name=f"p14-app-{t}")
           for t in range(len(vals))]
    for th in ths:
        th.start()
    if mid is not None:
        half.wait(120)
        mid()
    for th in ths:
        th.join()
    p14_check(not errors, f"14c: produce() failed: {errors[:3]}")
    p14_check(p.flush(300) == 0, f"14c {topic}: flush() did not drain")
    secs = time.perf_counter() - t0
    p14_check(p._rk.msg_cnt == 0 and p._rk.msg_bytes == 0,
              f"14c {topic}: msg_cnt {p._rk.msg_cnt}, msg_bytes "
              f"{p._rk.msg_bytes} after flush()")
    return n / secs


def p14_exactly_once(cluster, topic: str, parts: int, vals) -> int:
    """Every produced value in ``topic``'s log exactly once, CRCs exact;
    returns the batch count."""
    batches = p14_batches(cluster, topic, parts)
    got = sorted(v for part in p14_values(batches) for _k, v in part)
    want = sorted(v for t in vals for v in t)
    p14_check(len(got) == len(want) and got == want,
              f"14c {topic}: {len(got)} stored for {len(want)} produced "
              "(loss or duplication)")
    return sum(len(part) for part in batches)


def p14_group_read(kit, cluster, topic: str, backend: dict, n: int,
                   tag: str) -> dict:
    """0091's two consumers: a check.crcs GPU consumer of group
    p14-grp-<tag> reads ``topic``; a second joins once half is read.
    No record may be lost; duplicates are counted (the reference asserts
    at least once)."""
    conf = {"heartbeat.interval.ms": 100, "session.timeout.ms": 6000,
            "check.crcs": True}
    seen: dict = {}
    per = {1: 0, 2: 0}
    cs = [p13_consumer(kit, cluster.bootstrap_servers(), backend,
                       f"p14-grp-{tag}", conf)]
    try:
        cs[0].subscribe([topic])
        t0 = time.monotonic()
        deadline = t0 + 120
        quiet = None
        while time.monotonic() < deadline:
            got = 0
            for k, c in enumerate(cs, 1):
                for m in c.consume(2000, 0.05):
                    p14_check(m.error is None, f"14c {tag} group: "
                              f"{m.error}")
                    seen[m.value] = seen.get(m.value, 0) + 1
                    per[k] += 1
                    got += 1
            if len(cs) == 1 and len(seen) >= n // 2:
                c2 = p13_consumer(kit, cluster.bootstrap_servers(), backend,
                                  f"p14-grp-{tag}", conf)
                cs.append(c2)
                c2.subscribe([topic])
            if len(seen) >= n and len(cs) == 2 and cs[1].assignment():
                quiet = quiet or time.monotonic()
                if got == 0 and time.monotonic() - quiet > 0.5:
                    break
        assigned2 = len(cs[1].assignment()) if len(cs) == 2 else 0
        for c in cs:
            p11_no_cpu(eos_snapshot(eos_engine(c)), f"14c {tag} group",
                       False)
        launches = sum(eos_engine(c).stats["launches"] for c in cs
                       if eos_engine(c) is not None)
    finally:
        for c in cs:
            c.close()
    missing = n - len(seen)
    p14_check(missing == 0, f"14c {tag} group: {missing} records never "
              "consumed")
    p14_check(assigned2 >= 1, f"14c {tag} group: the second consumer was "
              "never assigned a partition")
    return {"dups": sum(seen.values()) - len(seen), "per": per,
            "secs": time.monotonic() - t0, "launches": launches}


#: 14c: 0112's burst runs this many times at each backpressure threshold,
#: interleaved, and the totals compare (one burst's count is load-bound)
P14_BP_ROUNDS = 3


def p14_burst(kit, backend: dict, tag: str, thresh: int) -> int:
    """0112's burst (300 x 100 B at linger.ms 0, paced) on a 24 KB/s
    sockem link with a 4 KB send buffer; returns the stored batches,
    each through a CRC ticket where the provider has an engine."""
    import socket as _socket
    cluster = kit.MockCluster(num_brokers=1, topics={"bp": 1})
    em = kit.Sockem(rate_bps=24 * 1024)

    def connect_cb(host, port, timeout):
        s = em.connect_cb(host, port, timeout)
        s.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDBUF, 4096)
        return s
    p = None
    try:
        p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                          "connect_cb": connect_cb,
                          "queue.buffering.backpressure.threshold": thresh,
                          "linger.ms": 0, "batch.num.messages": 10000,
                          "message.timeout.ms": 60000, **backend})
        eos_warm(p)
        regions = p14_region_codecs(p._rk.codec_provider)
        for i in range(300):
            p.produce("bp", value=b"y" * 100, partition=0)
            if i % 10 == 9:
                time.sleep(0.002)
        p14_check(p.flush(60.0) == 0, f"14c {tag} backpressure {thresh}: "
                  "flush()")
        nb = sum(len(part) for part in p14_batches(cluster, "bp", 1))
        p14_check(eos_engine(p) is None or sum(regions.values()) >= nb,
                  f"14c {tag} backpressure {thresh}: {regions} CRC regions "
                  f"for {nb} batches")
        p11_no_cpu(eos_snapshot(eos_engine(p)), f"14c {tag} backpressure",
                   False)
        return nb
    finally:
        if p is not None:
            p.close()
        cluster.stop()


def p14_backpressure(kit, backend: dict, tag: str) -> dict:
    """0112's backpressure: over ``P14_BP_ROUNDS`` interleaved bursts a
    threshold, threshold 1 stores strictly fewer batches than threshold
    1,000,000.  Returns each threshold's batches a burst."""
    out = {1: [], 1000000: []}
    for _ in range(P14_BP_ROUNDS):
        for thresh, counts in out.items():
            counts.append(p14_burst(kit, backend, tag, thresh))
    p14_check(sum(out[1]) < sum(out[1000000]), f"14c {tag}: backpressure "
              f"threshold 1 stored {out[1]} batches, not fewer than "
              f"{out[1000000]}")
    return out


def p14_copy_max(kit, backend: dict, tag: str) -> int:
    """0112's message.copy.max.bytes 64: a 10 B value (the arena lane)
    and a 4 KB one (the Message path) in one batch through the CRC
    ticket.  Returns the regions the ticket carried."""
    cluster = kit.MockCluster(num_brokers=1, topics={"kn": 1})
    p = None
    try:
        p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                          "message.copy.max.bytes": 64, "linger.ms": 200,
                          **backend})
        eos_warm(p)
        p.produce("kn", value=b"warm", partition=0)
        p14_check(p.flush(10) == 0, f"14c {tag} copy.max: warm flush")
        regions = p14_region_codecs(p._rk.codec_provider)
        small, big = b"s" * 10, b"B" * 4096
        p.produce("kn", value=small, partition=0)
        p.produce("kn", value=big, partition=0)
        p14_check(p.flush(10) == 0, f"14c {tag} copy.max: flush()")
        p11_no_cpu(eos_snapshot(eos_engine(p)), f"14c {tag} copy.max",
                   False)
    finally:
        if p is not None:
            p.close()
        cluster.stop()
    batches = p14_batches(cluster, "kn", 1)[0][1:]
    vals = [v for part in p14_values([batches]) for _k, v in part]
    p14_check(len(batches) == 1 and vals == [small, big],
              f"14c {tag} copy.max: {len(batches)} batches holding "
              f"{[len(v) for v in vals]} B values, not one of [10, 4096]")
    p14_check(sum(regions.values()) == 1, f"14c {tag} copy.max: "
              f"{regions} CRC-ticket regions for the batch")
    return sum(regions.values())


def p14_load(kit, backend: dict, tag: str, threads: int, per: int,
             parts: int, device: str, smi: str) -> dict:
    """14c on one leg: 0091's concurrent producers (plain and with a
    broker killed and restarted midway) and its two rebalancing
    consumers."""
    card = device != "cpu"
    vals = p14_load_values(threads, per)
    n = threads * per
    dev = bool(backend.get("gpu.compress.device"))
    cluster = kit.MockCluster(num_brokers=2,
                              topics={"p14-st": parts, "p14-bounce": parts})
    retries = [0]
    requeue = kit.Toppar.enqueue_retry_batch

    def counting(self, msgs):
        retries[0] += 1
        return requeue(self, msgs)
    p = None
    try:
        p = p13_producer(kit, cluster.bootstrap_servers(), backend,
                         {"message.send.max.retries": 10000,
                          "retry.backoff.ms": 50,
                          "message.timeout.ms": 120000})
        prov = p._rk.codec_provider
        submitted = [0]
        p14_wrap_submit(prov, "compress_submit" if dev else "crc32c_submit",
                        lambda *a: submitted.__setitem__(
                            0, submitted[0] + len(a[1] if dev else a[0])))
        crc.launches = 0
        lz4.launches = 0
        before = eos_snapshot(eos_engine(p))
        rate = p14_threads_produce(p, "p14-st", vals, parts)
        nb1 = p14_exactly_once(cluster, "p14-st", parts, vals)
        sub1 = submitted[0]
        p14_check(sub1 >= nb1, f"14c {tag}: {sub1} batches through the "
                  f"device route for {nb1} stored")
        from librdkafka_tpu_torch.protocol.proto import ApiKey

        def bounce():
            # a ProduceRequest held in flight, then the broker killed
            cluster.set_rtt(1, 300)
            p11_wait(p, lambda: any(
                r.api == ApiKey.Produce for b in list(p._rk.brokers.values())
                if b.nodeid == 1 for r in list(b.waitresp.values())),
                f"14c {tag}: a ProduceRequest in flight to broker 1")
            cluster.kill_broker(1)
            cluster.set_rtt(1, 0)
            time.sleep(0.3)
            cluster.restart_broker(1)
        kit.Toppar.enqueue_retry_batch = counting
        try:
            brate = p14_threads_produce(p, "p14-bounce", vals, parts,
                                        mid=bounce)
        finally:
            kit.Toppar.enqueue_retry_batch = requeue
        nb2 = p14_exactly_once(cluster, "p14-bounce", parts, vals)
        p14_check(retries[0] >= 1, f"14c {tag}: the broker kill requeued "
                  "no batch")
        p14_check(submitted[0] - sub1 >= nb2 + retries[0],
                  f"14c {tag}: {submitted[0] - sub1} batches through the "
                  f"device route, fewer than {nb2} stored + {retries[0]} "
                  "requeued")
        routes = p14_engine_delta(p, before)
        p11_no_cpu(eos_snapshot(eos_engine(p)), f"14c {tag} producer", dev)
        prod = {"crc_rows": crc.launches, "lz4_rows": lz4.launches}
        p14_check(routes["compress.launches" if dev else "launches"] > 0
                  and (not card or prod["lz4_rows" if dev else "crc_rows"]
                       > 0), f"14c {tag}: producer launches {routes} "
                  f"{prod}")
    finally:
        kit.Toppar.enqueue_retry_batch = requeue
        if p is not None:
            p.close()
    try:
        crc.launches = 0
        grp = p14_group_read(kit, cluster, "p14-st", backend, n, tag)
        cons = crc.launches
        p14_check(grp["launches"] > 0 and (not card or cons > 0),
                  f"14c {tag} group: no CRC launch")
    finally:
        cluster.stop()
    print(f"phase 14c, leg {tag}: {threads} application threads x {per} x "
          f"{VALUE_SIZE} B into one idempotent lz4 producer over {parts} "
          f"partitions on 2 brokers: exactly once in {nb1} batches, "
          f"msg_cnt == msg_bytes == 0, {rate:.1f} msgs/s; broker 1 killed "
          f"and restarted midway: exactly once in {nb2} batches, "
          f"{retries[0]} batches requeued and rebuilt through the device "
          f"route ({submitted[0] - sub1} through it), {brate:.1f} msgs/s "
          f"[{smi}]")
    print(f"  two check.crcs consumers in one group, the second joining "
          f"halfway: none lost, {grp['dups']} duplicates (reads "
          f"{grp['per']}) in {grp['secs']:.3f} s [{smi}]")
    return {"crc_rows": prod["crc_rows"] + cons,
            "lz4_rows": prod["lz4_rows"]}


def p14_knobs(kit, backend: dict, tag: str, device: str, smi: str) -> dict:
    """14c's conf knobs on one leg: 0112's backpressure and
    message.copy.max.bytes."""
    crc.launches = 0
    bp = p14_backpressure(kit, backend, tag)
    cm = p14_copy_max(kit, backend, tag)
    p14_check(device == "cpu" or crc.launches > 0, f"14c {tag}: "
              "backpressure and copy.max made no crc_rows launch")
    print(f"  backpressure at 24 KB/s, {P14_BP_ROUNDS} bursts each: "
          f"threshold 1 -> {bp[1]} batches, 1,000,000 -> {bp[1000000]}, "
          f"each through a CRC ticket; "
          f"message.copy.max.bytes 64: 10 B + 4 KB in one batch, {cm} CRC "
          f"region [{smi}]")
    return {"crc_rows": crc.launches, "lz4_rows": 0}


# ------------------------------------------------------------------ 14d --

def p14_behaviours(kit, backend: dict, device: str, smi: str) -> dict:
    """14d: 0118's behaviours that cross the codec seam, on leg a: acks
    0, 1 and -1, null key and value, MSG_SIZE_TOO_LARGE, an unknown
    partition, the ut_handle_ProduceResponse retry (rebuilt through the
    device route), reconsume after seek (identical records through the
    verify tickets)."""
    card = device != "cpu"
    cluster = kit.MockCluster(num_brokers=1, topics={"bh": 2})
    out = {}
    crc.launches = 0
    clients = []

    def producer(**conf):
        p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                          "linger.ms": 2, **backend, **conf})
        clients.append(p)
        eos_warm(p)
        return p
    try:
        for acks in (0, 1, -1):
            topic = f"p14-acks{acks}"
            p = producer(acks=acks)
            for i in range(20):
                p.produce(topic, value=b"a%d" % i * 50, partition=0)
            p14_check(p.flush(10) == 0, f"14d acks={acks}: flush()")
            got = [v for part in p14_values(p14_batches(cluster, topic, 1))
                   for _k, v in part]
            p14_check(got == [b"a%d" % i * 50 for i in range(20)],
                      f"14d acks={acks}: stored {len(got)} of 20")
            p11_no_cpu(eos_snapshot(eos_engine(p)), f"14d acks={acks}",
                       False)
            out[f"acks={acks}"] = eos_engine(p).stats["launches"]
        # 0118's unknown partition: a fresh producer's first record (the
        # topic's metadata not known yet) fails by DR; once the topic is
        # known, produce() raises, in both packages
        drs: list = []
        p = kit.Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                          "linger.ms": 2, "message.timeout.ms": 3000,
                          "message.max.bytes": 5000,
                          "dr_msg_cb": lambda e, m: drs.append(e),
                          **backend})
        clients.append(p)
        p.produce("bh", value=b"nope", partition=99)
        p14_check(p.flush(10) == 0, "14d unknown partition: flush()")
        p14_check([e and e.code for e in drs] ==
                  [kit.Err._UNKNOWN_PARTITION], f"14d: partition 99 of an "
                  f"unknown topic: DRs {drs}, not [_UNKNOWN_PARTITION]")
        eos_warm(p)
        raised = {}
        for what, part, size in (("unknown", 99, 10), ("size", 0, 6000)):
            try:
                p.produce("bh", value=b"Z" * size, partition=part)
            except kit.KafkaException as e:
                raised[what] = e.error.code
        p14_check(raised == {"unknown": kit.Err._UNKNOWN_PARTITION,
                             "size": kit.Err.MSG_SIZE_TOO_LARGE},
                  f"14d: produce() raised {raised}: partition 99 of a known "
                  "topic must raise _UNKNOWN_PARTITION, a 6,000 B record at "
                  "message.max.bytes 5,000 MSG_SIZE_TOO_LARGE")
        drs.clear()
        p.produce("bh", value=b"ok" * 100, partition=0)
        p.produce("bh", value=None, key=b"onlykey", partition=1)
        p.produce("bh", value=b"onlyvalue", key=None, partition=1)
        p14_check(p.flush(10) == 0, "14d: flush()")
        p14_check(drs == [None] * 3, f"14d: DRs {drs}")
        p11_no_cpu(eos_snapshot(eos_engine(p)), "14d nulls", False)
        seen, hook_drs = [], []

        def hook(broker_id, base_msgid, err):
            if not seen:
                seen.append((broker_id, base_msgid))
                return kit.KafkaError(kit.Err.REQUEST_TIMED_OUT,
                                      "ut injected", retriable=True)
            return None
        p = producer(**{"ut_handle_ProduceResponse": hook,
                        "retry.backoff.ms": 50,
                        "dr_msg_cb": lambda e, m: hook_drs.append(e)})
        regions = p14_region_codecs(p._rk.codec_provider)
        p.produce("p14-retry", value=b"retry-me" * 64, partition=0)
        p14_check(p.flush(10) == 0, "14d ut_handle_ProduceResponse: flush()")
        p14_check(seen and hook_drs == [None], f"14d: the injected retry "
                  f"(hook ran {len(seen)} times, DRs {hook_drs})")
        # not idempotent: the mock stored the first send, so the retry
        # stores it again (the reference's 0118 asserts only the DR)
        stored = [v for part in p14_values(p14_batches(cluster, "p14-retry",
                                                       1)) for _k, v in part]
        p14_check(stored and set(stored) == {b"retry-me" * 64}
                  and sum(regions.values()) >= 2,
                  f"14d: the retried batch went through {regions} CRC "
                  f"tickets, {len(stored)} stored")
        out["retry_regions"] = sum(regions.values())
        p = producer(**{"compression.codec": "lz4"})
        for i in range(40):
            p.produce("p14-rc", value=b"rc%02d" % i, key=b"k%02d" % i,
                      partition=0)
        p14_check(p.flush(10) == 0, "14d reconsume: flush()")
        c = p13_consumer(kit, cluster.bootstrap_servers(), backend,
                         "p14-rc", {})
        clients.append(c)
        verified = eos_count_control(c)

        def read(k):
            got = []
            deadline = time.monotonic() + 20
            while len(got) < k and time.monotonic() < deadline:
                m = c.poll(0.1)
                if m is not None and m.error is None:
                    got.append((m.partition, m.offset, m.key, m.value))
            return got
        c.assign([kit.TopicPartition("bh", 1, OFFSET_BEGINNING)])
        nulls = read(2)
        p14_check([(k, v) for _p, _o, k, v in nulls] ==
                  [(b"onlykey", None), (None, b"onlyvalue")],
                  f"14d: null key / value read back as {nulls}")
        c.assign([kit.TopicPartition("p14-rc", 0, OFFSET_BEGINNING)])
        first = read(40)
        v1 = verified[0]
        c.seek(kit.TopicPartition("p14-rc", 0, 0))
        second = read(40)
        p14_check(len(first) == 40 and first == second,
                  f"14d: reconsume after seek: {len(first)} then "
                  f"{len(second)} records, identical {first == second}")
        p14_check(v1 > 0 and verified[0] > v1, f"14d: verify regions "
                  f"{v1} then {verified[0]}: the re-read took no ticket")
        p11_no_cpu(eos_snapshot(eos_engine(c)), "14d consumer", False)
        out["verify_regions"] = verified[0]
    finally:
        for cl in clients:
            cl.close()
        cluster.stop()
    counts = {"crc_rows": crc.launches, "lz4_rows": 0}
    p14_check(not card or counts["crc_rows"] > 0, "14d: no crc_rows launch")
    print(f"phase 14d, leg a: acks 0 / 1 / -1 stored and exact (engine "
          f"launches {out['acks=0']} / {out['acks=1']} / {out['acks=-1']}); "
          f"null key and value read back; 6,000 B -> MSG_SIZE_TOO_LARGE; "
          f"partition 99 -> _UNKNOWN_PARTITION (by DR, then raised); "
          f"ut_handle_ProduceResponse "
          f"retry delivered once, {out['retry_regions']} CRC regions; "
          f"reconsume after seek identical ({out['verify_regions']} verify "
          f"regions); crc_rows {counts['crc_rows']} [{smi}]")
    return counts


def p14_kit():
    """The port's names phase 14 drives (phase 13's and the errors)."""
    from librdkafka_tpu_torch.client.errors import KafkaError, KafkaException
    kit = p13_kit()
    kit.KafkaError, kit.KafkaException = KafkaError, KafkaException
    return kit


def phase_latency_load(smi: str, parts: int = P14_CODEC_PARTS,
                       per: int = P14_CODEC_PER, lat_n: int = P14_LAT_N,
                       threads: int = P14_THREADS,
                       thread_per: int = P14_THREAD_PER,
                       load_parts: int = P14_LOAD_PARTS,
                       device: str = "cuda") -> dict:
    """Phase 14: the producer's latency path (14a), the topic-scope
    codec matrix (14b), the client under load (14c) and 0118's
    behaviours across the codec seam (14d).  Returns its launches."""
    t0 = time.perf_counter()
    kit = p14_kit()
    backend = {"compression.backend": "gpu", "gpu.device": device, **P6_GPU}
    total = {"crc_rows": 0, "lz4_rows": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]
    died: list = []
    hook = threading.excepthook

    def record(args):
        died.append(f"{args.thread.name}: {args.exc_type.__name__}")
        hook(args)
    threading.excepthook = record
    try:
        lat = p14_latency(kit, [
            ("cpu", {"compression.backend": "cpu"}, False),
            ("governed", {"compression.backend": "gpu",
                          "gpu.device": device}, False),
            ("a", backend, True),
            ("b", {**backend, "gpu.compress.device": True}, True)],
            lat_n, device, smi)
        add(lat["counts"])
        add(p14_codecs(kit, backend, P14_LEGS, parts, per, device,
                       smi)["counts"])
        add(p14_load(kit, backend, "a", threads, thread_per, load_parts,
                     device, smi))
        add(p14_knobs(kit, backend, "a", device, smi))
        add(p14_behaviours(kit, backend, device, smi))
    finally:
        threading.excepthook = hook
    p14_check(not died, f"phase 14: threads died of exceptions: {died}")
    secs = time.perf_counter() - t0
    check(secs <= P14_LIMIT_S, f"phase 14 took {secs:.3f} s, over its "
          f"{P14_LIMIT_S} s")
    print(f"phase 14: ok ({secs:.3f} s: 14a latency on four legs, 14b "
          f"codecs on two legs, 14c under load, 14d behaviours; launches "
          f"crc_rows {total['crc_rows']}, lz4_rows {total['lz4_rows']}) "
          f"[{smi}]")
    return total


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
    eos = phase_eos(dev["smi"])
    api = phase_api(dev["smi"])
    obs = phase_obs(dev["smi"])
    planes = phase_planes(dev["smi"])
    load = phase_latency_load(dev["smi"])
    cnt = mp["counts"]
    main_path["launches"] += (engine["launches"] + client["crc_rows"]
                              + cnt["crc_rows"] + robust["crc_rows"]
                              + capi["crc_rows"] + eos["crc_rows"]
                              + api["crc_rows"] + obs["crc_rows"]
                              + planes["crc_rows"] + load["crc_rows"])
    comp["launches"] += (client["lz4_rows"] + cnt["lz4_rows"]
                         + robust["lz4_rows"] + capi["lz4_rows"]
                         + eos["lz4_rows"] + api["lz4_rows"]
                         + obs["lz4_rows"] + planes["lz4_rows"]
                         + load["lz4_rows"])
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
