#!/usr/bin/env python3
"""Where the QoS flood's latency tail comes from, on one CUDA card.

Runs ``analysis.stress.run_stress()`` once (as chip_smoke.py phase 8 does
before its flood), then ``chaos.scenarios.hot_topic_flood(seed=17)`` N
times in the same process, each reporting rather than raising.  For each
flood it prints the unloaded and flooded p99 against the bound, how the
compress jobs were routed, and three host-side suspects measured during
that flood: the longest garbage-collector pause, the interpreter stalls
(a thread that sleeps 1 ms and records every gap over 15 ms) and the
slowest pinned staging-slot and lane device-buffer allocations.  Run from
the root of the repository:

    python3 flood_tail.py [N]        # N floods, default 24

Exits non-zero without a card.  It measures; it asserts nothing about
the bound (chip_smoke.py does).
"""
from __future__ import annotations

import gc
import os
import subprocess
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from librdkafka_tpu_torch.analysis import stress          # noqa: E402
from librdkafka_tpu_torch.chaos.scenarios import hot_topic_flood  # noqa: E402
from librdkafka_tpu_torch.ops import crc32c_torch as crc  # noqa: E402

STALL_S = 0.015


class Probe:
    """GC pauses, interpreter stalls and allocation times, reset a flood."""

    def __init__(self):
        self.gc_ms: list[float] = []
        self.stalls_ms: list[float] = []
        self.allocs: list[tuple[str, int, float]] = []
        self._gc_t0 = 0.0
        gc.callbacks.append(self._gc)
        slot_init, reserve = crc.Slot.__init__, crc.LaneBuffers.reserve
        probe = self

        def timed_slot(slot, cap, pin):
            t0 = time.perf_counter()
            slot_init(slot, cap, pin)
            probe.allocs.append(("slot", cap,
                                 (time.perf_counter() - t0) * 1e3))

        def timed_reserve(bufs, nbytes, ntiles, S):
            t0 = time.perf_counter()
            reserve(bufs, nbytes, ntiles, S)
            probe.allocs.append(("device", nbytes,
                                 (time.perf_counter() - t0) * 1e3))

        crc.Slot.__init__ = timed_slot
        crc.LaneBuffers.reserve = timed_reserve
        threading.Thread(target=self._watch, name="flood-tail-watch",
                         daemon=True).start()

    def _gc(self, phase, _info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_ms.append((time.perf_counter() - self._gc_t0) * 1e3)

    def _watch(self):
        last = time.perf_counter()
        while True:
            time.sleep(0.001)
            now = time.perf_counter()
            if now - last > STALL_S:
                self.stalls_ms.append((now - last) * 1e3)
            last = now

    def reset(self):
        self.gc_ms.clear()
        self.stalls_ms.clear()
        self.allocs.clear()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flood_tail: needs a CUDA card")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    probe = Probe()
    t0 = time.perf_counter()
    stress.run_stress()
    print(f"run_stress(): {time.perf_counter() - t0:.3f} s")
    held, flooded = 0, []
    for i in range(n):
        probe.reset()
        r = hot_topic_flood(seed=17, raise_on_violation=False)
        c = r["compress"]
        held += bool(r["ok"])
        flooded.append(r["p99_flood_ms"])
        slot = max((a for a in probe.allocs if a[0] == "slot"),
                   key=lambda a: a[2], default=None)
        dev = max((a for a in probe.allocs if a[0] == "device"),
                  key=lambda a: a[2], default=None)
        print(f"flood {i}: ok {r['ok']}; p99 unloaded {r['p99_unloaded_ms']}"
              f" ms, flooded {r['p99_flood_ms']} ms, bound {r['bound_ms']}"
              f" ms; jobs {c['jobs']}: launches {c['launches']}, routed_cpu "
              f"{c['routed_cpu_jobs']}, warmup_miss {c['warmup_miss_jobs']},"
              f" shed {c['shed_jobs']}; gc max "
              f"{max(probe.gc_ms, default=0.0):.1f} ms; stalls > "
              f"{STALL_S * 1e3:.0f} ms {len(probe.stalls_ms)} (max "
              f"{max(probe.stalls_ms, default=0.0):.1f}); slowest slot "
              + (f"{slot[1]} B {slot[2]:.1f} ms" if slot else "none")
              + "; slowest device reserve "
              + (f"{dev[1]} B {dev[2]:.1f} ms" if dev else "none"))
    print(f"floods holding the bound: {held} of {n}; flooded p99 "
          f"{min(flooded)}-{max(flooded)} ms")


if __name__ == "__main__":
    main()
