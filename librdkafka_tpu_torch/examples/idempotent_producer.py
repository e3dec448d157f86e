#!/usr/bin/env python3
"""Idempotent producer example (reference:
examples/idempotent_producer.c): enable.idempotence=true gives strict
ordering and exactly-once delivery per partition; fatal errors indicate
a broken guarantee and must abort."""
import sys

from librdkafka_tpu_torch import Producer


def main():
    bootstrap = sys.argv[1] if len(sys.argv) > 1 else ""
    conf = {"bootstrap.servers": bootstrap,
            "enable.idempotence": True,
            "error_cb": lambda err: (print(f"FATAL: {err}"), sys.exit(1))
            if err.fatal else print(f"error: {err}")}
    if not bootstrap:
        conf["test.mock.num.brokers"] = 1
    p = Producer(conf)
    for i in range(100):
        p.produce("idemp", value=b"exactly-once %d" % i)
    print("flushed,", p.flush(30.0), "remaining;",
          "PID:", p.rk.idemp.pid, "epoch:", p.rk.idemp.epoch)
    p.close()


if __name__ == "__main__":
    main()
