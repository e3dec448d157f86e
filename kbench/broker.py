"""The broker the benchmark's clients talk to: the program's mock
cluster, in a process of its own, as a real broker would be.

    python kbench/broker.py --brokers 2 --topic NAME:PARTS
        [--retention-bytes N]

Prints ``bootstrap.servers`` on its first stdout line, then serves until
its stdin closes.  Commands, one a line on stdin:

    dump NAME   write the topic's logs to stdout: one JSON line
                ``{"parts": [[partition, start, end, nbytes], ...]}``
                then each partition's stored batches, ``nbytes`` each,
                in the order of the list
    quit        stop the cluster and exit

The logs are the broker's stored bytes, read back for the benchmark's
reference to judge; nothing else of the program's is handed over.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--brokers", type=int, default=1)
    ap.add_argument("--topic", required=True, metavar="NAME:PARTS")
    ap.add_argument("--retention-bytes", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from librdkafka_tpu_torch.mock.cluster import MockCluster

    name, _, parts = args.topic.partition(":")
    cluster = MockCluster(num_brokers=args.brokers,
                          topics={name: int(parts)},
                          retention_bytes=args.retention_bytes)
    out = sys.stdout.buffer
    out.write(cluster.bootstrap_servers().encode() + b"\n")
    out.flush()
    try:
        for line in sys.stdin:
            cmd = line.split()
            if not cmd or cmd[0] == "quit":
                break
            if cmd[0] == "dump":
                logs = [(p.id, p.start_offset, p.end_offset,
                         b"".join(blob for _base, blob in list(p.log)))
                        for p in cluster.topics[cmd[1]]]
                out.write(json.dumps({"parts": [
                    [i, s, e, len(b)] for i, s, e, b in logs]}).encode()
                    + b"\n")
                for *_, b in logs:
                    out.write(b)
                out.flush()
    finally:
        cluster.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
