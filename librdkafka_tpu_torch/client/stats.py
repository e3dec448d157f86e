"""Windowed averages with percentiles (reference: rd_avg_t, src/rdavg.h,
over HdrHistogram, rdhdrhistogram.c).

The port's copy of the JAX package's ``client/stats.py``, holding only
:class:`Avg`: the offload engine's ``stage_latency`` windows.  The
statistics collector comes with the client slice.
"""
from __future__ import annotations

from ..analysis.locks import new_lock
from ..analysis.races import register_slots
from ..utils.hdrhistogram import HdrHistogram


class Avg:
    """Windowed HdrHistogram with rollover (reference: rd_avg_t,
    rdavg.h:37-165 — values accumulate into the current window; the
    stats emitter rolls the window over and renders min/avg/max +
    p50..p99.99, rdkafka.c:1582-1630). O(1) record, constant memory."""

    __slots__ = ("_hist", "_lock")

    #: STATISTICS.md percentile fields
    PCTS = ((50, "p50"), (75, "p75"), (90, "p90"), (95, "p95"),
            (99, "p99"), (99.99, "p99_99"))

    def __init__(self, lowest: int = 1, highest: int = 60_000_000,
                 sigfigs: int = 3):
        self._hist = HdrHistogram(lowest, highest, sigfigs)
        self._lock = new_lock("stats.avg")

    def add(self, v: float):
        with self._lock:
            self._hist.record(int(v))

    def rollover(self) -> dict:
        with self._lock:
            h = self._hist
            vals, stddev = h.snapshot([p for p, _ in self.PCTS])
            out = {"min": h.min_v, "max": h.max_v,
                   "avg": int(h.mean()), "sum": h.sum_v, "cnt": h.total,
                   "stddev": int(stddev),
                   "hdrsize": h.memsize,
                   "outofrange": h.out_of_range}
            for (pct, name), v in zip(self.PCTS, vals):
                out[name] = v
            h.reset()
        return out


# every histogram touch — record from the dispatch thread, rollover
# from the stats reader — holds stats.avg (analysis/races.py verifies
# the discipline; the slot form because Avg is __slots__)
register_slots(Avg, "_hist", prefix="stats.avg")
