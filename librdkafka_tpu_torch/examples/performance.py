#!/usr/bin/env python3
"""Performance harness (reference: examples/rdkafka_performance.c, the
benchmark tool of record — produce mode prints msgs/s and MB/s like
:555-644; latency decomposition comes from the stats blob), on the
PyTorch / CUDA port.  ``--backend gpu``, the default, runs the clients
with ``compression.backend=gpu``: the GPU provider under its default
governor, which serves CRC jobs on the CPU until its route is warm and
wherever its cost model rates the CPU faster, and compresses on the CPU
unless ``gpu.compress.device`` is set.  The last lines count the codec
engine's launches and the jobs it served on the CPU.  Without a card
the run exits non-zero naming the missing card, never falling back to
the CPU; ``--backend cpu`` asks for the CPU provider.

    python -m librdkafka_tpu_torch.examples.performance -P   # produce to mock
    python -m librdkafka_tpu_torch.examples.performance -P -z lz4 -s 1024 \
        -c 200000 --backend cpu
    python -m librdkafka_tpu_torch.examples.performance -C -b host:9092
    python -m librdkafka_tpu_torch.examples.performance -P -b host:9092 -t t
"""
import argparse
import json
import sys
import time

from librdkafka_tpu_torch import Consumer, Producer
from librdkafka_tpu_torch.client.errors import Err, KafkaException


def _open(cls, conf):
    """The client; with --backend gpu on a host without a CUDA card the
    client raises, and the run exits non-zero naming the missing card."""
    try:
        return cls(conf)
    except RuntimeError as e:
        sys.exit(f"% --backend {conf['compression.backend']}: {e}")


def _engine_line(client) -> None:
    """The codec engine's launches, and of the jobs it took how many it
    served on the CPU (GPU backend)."""
    eng = json.loads(client.rk.stats.emit_json()).get("codec_engine")
    if eng is not None:
        comp = eng["compress"]
        cpu = (eng["routed_cpu_jobs"] + eng["warmup_miss_jobs"]
               + eng["cpu_fallback_jobs"])
        comp_cpu = (comp["routed_cpu_jobs"] + comp["warmup_miss_jobs"]
                    + comp["cpu_jobs"] + comp["shed_jobs"])
        print(f"% codec engine: {eng['launches']} CRC launches, "
              f"{comp['launches']} compress launches; CRC jobs "
              f"{eng['jobs']}, {cpu} of them on the CPU; compress jobs "
              f"{comp['jobs']}, {comp_cpu} of them on the CPU")


def produce_mode(args):
    conf = {"bootstrap.servers": args.bootstrap,
            "linger.ms": args.linger,
            "batch.num.messages": args.batch,
            "compression.codec": args.codec,
            "compression.backend": args.backend,
            "statistics.interval.ms": 3000,
            "stats_cb": lambda js: stats.append(json.loads(js))}
    if not args.bootstrap:
        conf["test.mock.num.brokers"] = args.mock_brokers
        conf["test.mock.default.partitions"] = args.partitions
    stats = []
    delivered = [0]
    errors = [0]

    def on_dr(err, msg):
        if err is None:
            delivered[0] += 1
        else:
            errors[0] += 1

    # -l: per-message produce->delivery latency, the
    # rdkafka_performance latency mode (reference
    # examples/rdkafka_performance.c:70,112-118 — msg opaque carries the
    # send timestamp, the DR handler feeds the histogram). Tracking a
    # timestamp per message forgoes the zero-alloc fast lane, exactly
    # like the reference's -l forgoes its zero-copy path.
    lat = None
    if args.latency:
        from librdkafka_tpu_torch.utils.hdrhistogram import HdrHistogram
        lat = HdrHistogram(1, 60_000_000, 3)   # 1us .. 60s

        def on_dr_lat(err, msg):
            if err is None:
                delivered[0] += 1
                lat.record(max(1, int((time.monotonic() - msg.opaque)
                                      * 1e6)))
            else:
                errors[0] += 1

        conf["dr_msg_cb"] = on_dr_lat
    else:
        conf["dr_msg_cb"] = on_dr
    p = _open(Producer, conf)
    payload = bytes(bytearray(i & 0xFF for i in range(args.size)))
    t0 = time.monotonic()
    for i in range(args.count):
        while True:
            try:
                if lat is not None:
                    p.produce(args.topic, value=payload,
                              partition=i % args.partitions,
                              opaque=time.monotonic())
                else:
                    p.produce(args.topic, value=payload,
                              partition=i % args.partitions)
                break
            except KafkaException as e:
                # the local queue is full (queue.buffering.max.messages):
                # serve delivery reports and retry
                if e.error.code != Err._QUEUE_FULL:
                    raise
                p.poll(0.01)
        if i % 10000 == 0:
            p.poll(0)
    rem = p.flush(300.0)
    dt = time.monotonic() - t0
    _engine_line(p)
    p.close()
    rate = delivered[0] / dt
    mb = delivered[0] * args.size / dt / 1e6
    print(f"% {delivered[0]} msgs delivered ({errors[0]} failed, "
          f"{rem} stuck) in {dt:.3f}s: {rate:,.0f} msgs/s, {mb:.2f} MB/s")
    if lat is not None and delivered[0]:
        p = lat.value_at_percentile
        print(f"% latency (us): min={lat.min_v} avg={lat.mean():.0f} "
              f"p50={p(50)} p95={p(95)} p99={p(99)} p99.99={p(99.99)} "
              f"max={lat.max_v}")
    if stats:
        il = stats[-1]["int_latency"]
        print(f"% int_latency p50={il['p50']}us p99={il['p99']}us")
    return rate


def consume_mode(args):
    conf = {"bootstrap.servers": args.bootstrap,
            "group.id": args.group,
            "auto.offset.reset": "earliest",
            "check.crcs": True,
            "compression.backend": args.backend}
    c = _open(Consumer, conf)
    c.subscribe([args.topic])
    n = 0
    nbytes = 0
    t0 = None
    idle_deadline = time.monotonic() + 30
    lat = None
    if args.latency:
        from librdkafka_tpu_torch.utils.hdrhistogram import HdrHistogram
        lat = HdrHistogram(1, 60_000_000, 3)
    while time.monotonic() < idle_deadline:
        m = c.poll(0.5)
        if m is None or m.error is not None:
            continue
        if t0 is None:
            t0 = time.monotonic()
        n += 1
        nbytes += len(m.value or b"")
        if lat is not None and m.timestamp:
            # end-to-end latency vs the producer CreateTime stamp
            # (reference -l consume path prints the same delta)
            lat.record(max(1, int(time.time() * 1000 - m.timestamp)
                           * 1000))
        idle_deadline = time.monotonic() + 3
        if args.count and n >= args.count:
            break
    dt = (time.monotonic() - t0) if t0 else 1
    _engine_line(c)
    c.close()
    print(f"% consumed {n} msgs in {dt:.3f}s: {n / dt:,.0f} msgs/s, "
          f"{nbytes / dt / 1e6:.2f} MB/s")
    if lat is not None and n:
        p = lat.value_at_percentile
        print(f"% e2e latency (us): min={lat.min_v} avg={lat.mean():.0f} "
              f"p50={p(50)} p99={p(99)} max={lat.max_v}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-P", action="store_true", help="produce mode")
    ap.add_argument("-C", action="store_true", help="consume mode")
    ap.add_argument("-b", dest="bootstrap", default="")
    ap.add_argument("-t", dest="topic", default="perf")
    ap.add_argument("-g", dest="group", default="perf-group")
    ap.add_argument("-s", dest="size", type=int, default=1024)
    ap.add_argument("-c", dest="count", type=int, default=100000)
    ap.add_argument("-l", dest="latency", action="store_true",
                    help="per-message latency mode (produce: "
                         "produce->DR; consume: CreateTime->poll)")
    ap.add_argument("-z", dest="codec", default="none",
                    choices=["none", "gzip", "snappy", "lz4", "zstd"])
    ap.add_argument("--backend", default="gpu", choices=["cpu", "gpu"])
    ap.add_argument("--linger", type=int, default=50)
    ap.add_argument("--batch", type=int, default=10000)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--mock-brokers", type=int, default=1)
    args = ap.parse_args(argv)
    if args.C:
        consume_mode(args)
    else:
        produce_mode(args)


if __name__ == "__main__":
    main()
