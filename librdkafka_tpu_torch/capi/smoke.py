"""Read what ``gpu_smoke.c`` prints.

``gpu_smoke`` drives the port's main path from C through libtkafka.so
(see the comment at the top of ``gpu_smoke.c``).  Each leg prints its
clients' ``codec_engine`` statistics before and after its counted
window; :func:`read` gathers them per leg and :func:`deltas` gives each
client's change of the launch and CPU-route counters over the window.
"""
from __future__ import annotations

import json
import os

from . import build_capi

#: build it with build_capi.compile_program(SRC, exe)
SRC = os.path.join(build_capi.HERE, "gpu_smoke.c")
TAG = "GPU-SMOKE "

#: counters read from codec_engine; "compress." ones from its compress map
COUNTERS = ("launches", "routed_cpu_jobs", "warmup_miss_jobs",
            "cpu_fallback_jobs", "compress.launches", "compress.cpu_jobs",
            "compress.routed_cpu_jobs", "compress.warmup_miss_jobs",
            "compress.shed_jobs")
#: the counters that count jobs served on the CPU
CPU_ROUTES = tuple(k for k in COUNTERS if "launches" not in k)


def read(stdout: str) -> dict:
    """{leg: {"producer": {"before": ce, "after": ce}, "consumer": {...},
    "summary": {...}}} from gpu_smoke's output (ce: a codec_engine map,
    None on a client without the engine)."""
    legs: dict = {}
    for line in stdout.splitlines():
        if not line.startswith(TAG):
            continue
        obj = json.loads(line[len(TAG):])
        leg = legs.setdefault(obj["leg"], {})
        if "client" in obj:
            leg.setdefault(obj["client"], {})[obj["when"]] = \
                obj["codec_engine"]
        else:
            leg["summary"] = obj
    return legs


def _counter(ce, key: str) -> int:
    if ce is None:
        return 0
    if key.startswith("compress."):
        return ce["compress"][key[len("compress."):]]
    return ce[key]


def deltas(leg: dict, client: str) -> dict:
    """Each of ``COUNTERS``' change over a leg's counted window."""
    c = leg[client]
    return {k: _counter(c["after"], k) - _counter(c["before"], k)
            for k in COUNTERS}
