"""A benchmark run with the timed path broken underneath, for the tests
that see ``correct`` come out false.

    python kbench/tests/faults.py FAULT --workload CELL ... (run.py's args)

Faults of the producing cells: ``unchanged`` (produce() returns and
enqueues nothing), ``half`` (every second record is left out),
``altered`` (the CRC kernel's plain version, where every CRC job is
sent, returns each checksum with a bit flipped).  A run on one chip has
no exchange between chips to leave out.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _wrap_produce(make):
    """Every Producer's produce() replaced by ``make(its produce)``."""
    from librdkafka_tpu_torch.client.producer import Producer
    init = Producer.__init__

    def __init__(self, conf):
        init(self, conf)
        self.produce = make(self.produce)
    Producer.__init__ = __init__


def _produce_unchanged():
    _wrap_produce(lambda plain: lambda *a, **k: None)


def _produce_half():
    def make(plain):
        n = [0]

        def produce(*a, **k):
            n[0] += 1
            if n[0] % 2:
                return plain(*a, **k)
        return produce
    _wrap_produce(make)


def _produce_altered():
    from kbench.lib.harness import Harness
    from librdkafka_tpu_torch.ops import crc32c_torch
    plain = crc32c_torch.crc_segments_reference
    crc32c_torch.crc_segments_reference = lambda *a, **k: plain(*a, **k) ^ 1
    conf = Harness.client_conf

    def client_conf(self, role, bootstrap, **extra):
        # every CRC job to the (broken) kernel: no CPU route around it
        return {**conf(self, role, bootstrap, **extra),
                "gpu.governor": False, "gpu.launch.min.batches": 1}
    Harness.client_conf = client_conf


FAULTS = {
    "open_produce": {"unchanged": _produce_unchanged,
                     "half": _produce_half, "altered": _produce_altered},
}


def main(argv=None) -> int:
    import json
    argv = list(sys.argv[1:] if argv is None else argv)
    fault, rest = argv[0], argv[1:]
    cell = rest[rest.index("--workload") + 1]
    with open(os.path.join(ROOT, "kbench", "workloads", cell + ".json")) as f:
        kind = json.load(f)["traffic"]
    FAULTS[kind][fault]()
    from kbench import run
    return run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
