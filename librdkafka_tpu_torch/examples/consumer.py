#!/usr/bin/env python3
"""Balanced consumer example (reference: examples/consumer.c):
subscribe, poll, commit via the group coordinator.

    python -m librdkafka_tpu_torch.examples.consumer host:9092 mytopic mygroup
"""
import sys

from librdkafka_tpu_torch import Consumer


def main():
    if len(sys.argv) < 4:
        print(f"usage: {sys.argv[0]} <bootstrap> <topic> <group>")
        return
    bootstrap, topic, group = sys.argv[1:4]
    c = Consumer({"bootstrap.servers": bootstrap,
                  "group.id": group,
                  "auto.offset.reset": "earliest",
                  "enable.auto.commit": True})
    c.subscribe([topic])
    try:
        while True:
            m = c.poll(1.0)
            if m is None:
                continue
            if m.error is not None:
                print(f"consumer error: {m.error}")
                continue
            print(f"{m.topic}[{m.partition}]@{m.offset}: "
                  f"key={m.key} value={m.value[:60]}")
    except KeyboardInterrupt:
        pass
    finally:
        c.close()


if __name__ == "__main__":
    main()
