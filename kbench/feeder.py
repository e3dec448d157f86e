"""The upstream producers of a copying cell: one idempotent producer of
the program, in a process of its own so that its CPU is not the
client's, writing the input topic that the cell's copiers read.

    python kbench/feeder.py --bootstrap ADDR --topic NAME --partitions N
        --width W --seed S --conf JSON

``--conf`` holds the producer's keys (the configuration's ``feeder``;
``compression.backend=cpu``: the feeder never touches the card).
Record ``i`` goes to partition ``i mod N`` with key ``i`` as 8 bytes
big-endian and value ``pool[i mod POOL]`` (``kbench.lib.records``, the
seed's pool of ``W``-byte records).  Prints ``{"ready": true}`` on its
first stdout line, then serves commands, one a line on stdin, each
answered by JSON lines:

    warm N RATE     records 0..N-1 at even gaps of 1/RATE s, then a
                    flush: ``{"sent", "acked", "failed", "lag_p99_ms"}``
    open RATE S     the next records at open_produce's Poisson arrivals
                    at RATE over S seconds (the same gaps for every
                    seed): ``{"t0"}`` at once (time.monotonic() of the
                    first due time), then, once sent and flushed, the
                    same counts as ``warm``; ``lag_p99_ms`` is the 99th
                    percentile of each record's send after its due time
    quit            close the producer and exit
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kbench.lib.delivery import queue_full  # noqa: E402


def arrivals():
    """open_produce's arrivals(seed, rate, seconds)."""
    path = os.path.join(ROOT, "kbench", "traffic", "open_produce.py")
    spec = importlib.util.spec_from_file_location("kbench_feeder_open", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.arrivals


class Feeder:
    def __init__(self, args):
        from librdkafka_tpu_torch import Producer
        from kbench.lib.records import POOL, make_pool
        self.topic, self.nparts = args.topic, args.partitions
        self.pool, self.npool = make_pool(args.seed, args.width), POOL
        self.seed = args.seed
        self.next = 0                   # the next record's index
        self.acked = self.failed = 0
        conf = dict(json.loads(args.conf), **{
            "bootstrap.servers": args.bootstrap,
            "dr_batch_cb": self._dr})
        self.p = Producer(conf)

    def _dr(self, msgs) -> None:
        if msgs[0].error is not None:
            self.failed += len(msgs)
        else:
            self.acked += len(msgs)

    def _send(self, when, t0: float):
        """Send the next ``len(when)`` records at ``t0 + when``; returns
        when each went."""
        import numpy as np
        produce, poll = self.p.produce, self.p.poll
        topic, nparts, pool, npool = (self.topic, self.nparts, self.pool,
                                      self.npool)
        sent_at = np.empty(len(when))
        for k, dt in enumerate(when):
            at = t0 + dt
            while (now := time.monotonic()) < at:
                poll(at - now)
            i = self.next
            while True:
                try:
                    produce(topic, value=pool[i % npool],
                            key=i.to_bytes(8, "big"), partition=i % nparts)
                    break
                except Exception as e:
                    if not queue_full(e):
                        raise
                    poll(0.001)
            self.next = i + 1
            sent_at[k] = time.monotonic()
        return sent_at

    def feed(self, due, out=None) -> dict:
        """The next ``len(due)`` records at ``due`` seconds from now."""
        import numpy as np
        t0 = time.monotonic()
        if out is not None:
            _emit(out, {"t0": t0})
        sent_at = self._send(due, t0)
        left = self.p.flush(60.0)
        return {"sent": self.next, "acked": self.acked,
                "failed": self.failed + left,
                "lag_p99_ms": float(np.percentile(
                    (sent_at - (t0 + due)) * 1e3, 99))}

    def close(self) -> None:
        self.p.close()


def _emit(out, obj: dict) -> None:
    out.write(json.dumps(obj) + "\n")
    out.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bootstrap", required=True)
    ap.add_argument("--topic", required=True)
    ap.add_argument("--partitions", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--conf", required=True)
    args = ap.parse_args(argv)
    f = Feeder(args)
    out = sys.stdout
    _emit(out, {"ready": True})
    try:
        for line in sys.stdin:
            cmd = line.split()
            if not cmd or cmd[0] == "quit":
                break
            if cmd[0] == "warm":
                import numpy as np
                _emit(out, f.feed(np.arange(int(cmd[1])) / float(cmd[2])))
            elif cmd[0] == "open":
                _emit(out, f.feed(arrivals()(f.seed, float(cmd[1]),
                                             float(cmd[2])), out))
    finally:
        f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
