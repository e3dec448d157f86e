#!/usr/bin/env python3
"""Minimal producer example (reference: examples/producer.c).

Run against the in-process mock cluster (no broker needed):
    python -m librdkafka_tpu_torch.examples.producer
or a real/bootstrap address:
    python -m librdkafka_tpu_torch.examples.producer host:9092 mytopic
"""
import sys

from librdkafka_tpu_torch import Producer


def main():
    bootstrap = sys.argv[1] if len(sys.argv) > 1 else ""
    topic = sys.argv[2] if len(sys.argv) > 2 else "example"
    conf = {"bootstrap.servers": bootstrap, "linger.ms": 5,
            "compression.codec": "lz4"}
    if not bootstrap:
        conf["test.mock.num.brokers"] = 1

    def on_dr(err, msg):
        if err is not None:
            print(f"delivery FAILED: {err}")
        else:
            print(f"delivered to {msg.topic}[{msg.partition}]@{msg.offset}")

    conf["dr_msg_cb"] = on_dr
    p = Producer(conf)
    for i in range(10):
        p.produce(topic, value=b"hello %d" % i, key=b"key%d" % i)
    remaining = p.flush(10.0)
    print(f"flush done, {remaining} messages remaining")
    p.close()


if __name__ == "__main__":
    main()
