#!/usr/bin/env python
"""Apache Kafka ducktape-compatible verifiable client (the analog of
the reference's examples/kafkatest_verifiable_client.cpp): emits the
system-test JSON protocol on stdout so this framework can slot into
kafkatest-style orchestration.

Producer mode: sequential integer payloads, `producer_send_success` /
`producer_send_error` per delivery report, `tool_data` summary at exit.
Consumer mode: `records_consumed` batches (count + per-partition
min/max offsets), `offsets_committed` after each commit,
`partitions_assigned` / `partitions_revoked` on rebalance.
Both: `startup_complete` first, `shutdown_complete` last.

Examples:
  verifiable_client.py --producer --topic t --max-messages 1000 \\
      --bootstrap-server host:9092 [--acks -1] [--throughput N]
  verifiable_client.py --consumer --topic t --group-id g \\
      --bootstrap-server host:9092 [--max-messages N]
"""
import argparse
import json
import signal
import sys
import time

import os
# the directory that holds librdkafka_tpu_torch (run by path as well)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from librdkafka_tpu_torch import Consumer, Producer  # noqa: E402
from librdkafka_tpu_torch.client.errors import (  # noqa: E402
    Err, KafkaException)

run = True


def out(obj):
    print(json.dumps(obj), flush=True)


def do_producer(args):
    acked = [0]
    errors = [0]

    def dr(err, msg):
        if err is not None:
            errors[0] += 1
            out({"name": "producer_send_error", "message": str(err),
                 "topic": msg.topic, "key": None,
                 "value": msg.value.decode()})
        else:
            acked[0] += 1
            out({"name": "producer_send_success", "topic": msg.topic,
                 "partition": msg.partition, "offset": msg.offset,
                 "key": None, "value": msg.value.decode()})

    p = Producer({"bootstrap.servers": args.bootstrap_server,
                  "acks": args.acks, "linger.ms": 5,
                  "on_delivery": dr})
    out({"name": "startup_complete"})
    interval = 1.0 / args.throughput if args.throughput > 0 else 0
    sent = 0
    # --max-messages < 0 = unlimited (until SIGTERM), like the consumer
    while run and (args.max_messages < 0 or sent < args.max_messages):
        try:
            p.produce(args.topic, value=str(sent).encode())
        except KafkaException as e:
            if e.error.code != Err._QUEUE_FULL:
                raise       # fatal produce errors must surface, not spin
            # local queue full: serve delivery reports and retry
            # (the reference verifiable client does the same)
            p.poll(0.1)
            continue
        sent += 1
        p.poll(0)
        if interval:
            time.sleep(interval)
    p.flush(30.0)
    p.close()
    out({"name": "tool_data", "sent": sent, "acked": acked[0],
         "target_throughput": args.throughput})
    out({"name": "shutdown_complete"})


def do_consumer(args):
    ranges = {}            # (topic, part) -> [min, max]
    consumed = [0, 0]      # total, last-reported

    def report(immediate=False):
        if consumed[0] <= consumed[1] + (0 if immediate else 999):
            return
        out({"name": "records_consumed",
             "_totcount": consumed[0],
             "count": consumed[0] - consumed[1],
             "partitions": [
                 {"topic": t, "partition": pt,
                  "minOffset": lo, "maxOffset": hi}
                 for (t, pt), (lo, hi) in sorted(ranges.items())]})
        consumed[1] = consumed[0]
        ranges.clear()

    def on_assign(consumer, parts):
        # the rebalance-callback contract: the app applies the
        # assignment itself (confluent-kafka / reference rebalance_cb)
        consumer.assign(parts)
        out({"name": "partitions_assigned", "partitions": [
            {"topic": tp.topic, "partition": tp.partition}
            for tp in parts]})

    def on_revoke(consumer, parts):
        report(True)
        out({"name": "partitions_revoked", "partitions": [
            {"topic": tp.topic, "partition": tp.partition}
            for tp in parts]})
        consumer.unassign()

    c = Consumer({"bootstrap.servers": args.bootstrap_server,
                  "group.id": args.group_id,
                  "auto.offset.reset": "earliest",
                  "enable.auto.commit": False})
    c.subscribe([args.topic], on_assign=on_assign, on_revoke=on_revoke)
    out({"name": "startup_complete"})
    last_commit = time.monotonic()
    while run and (args.max_messages < 0 or consumed[0] < args.max_messages):
        m = c.poll(0.5)
        if m is None or m.error is not None:
            continue
        consumed[0] += 1
        key = (m.topic, m.partition)
        lo, hi = ranges.get(key, (m.offset, m.offset))
        ranges[key] = (min(lo, m.offset), max(hi, m.offset))
        report()
        if time.monotonic() - last_commit >= args.commit_interval_ms / 1e3:
            report(True)
            commit(c)
            last_commit = time.monotonic()
    report(True)
    commit(c)
    c.close()
    out({"name": "shutdown_complete"})


def commit(c):
    try:
        offsets = c.commit()
        out({"name": "offsets_committed", "success": True,
             "offsets": [
                 {"topic": tp.topic, "partition": tp.partition,
                  "offset": tp.offset} for tp in (offsets or [])]})
    except Exception as e:
        out({"name": "offsets_committed", "success": False,
             "error": str(e)})


def main():
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--producer", action="store_true")
    mode.add_argument("--consumer", action="store_true")
    ap.add_argument("--topic", required=True)
    ap.add_argument("--bootstrap-server", "--broker-list",
                    dest="bootstrap_server", required=True)
    ap.add_argument("--max-messages", type=int, default=-1)
    ap.add_argument("--throughput", type=int, default=-1)
    ap.add_argument("--acks", type=int, default=-1)
    ap.add_argument("--group-id", default="verifiable")
    ap.add_argument("--commit-interval-ms", type=int, default=5000)
    args = ap.parse_args()

    def stop(_sig, _frm):
        global run
        run = False
    signal.signal(signal.SIGTERM, stop)
    signal.signal(signal.SIGINT, stop)

    if args.producer:
        do_producer(args)
    else:
        do_consumer(args)


if __name__ == "__main__":
    main()
