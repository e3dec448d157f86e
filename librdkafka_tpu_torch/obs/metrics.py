"""Unified metrics registry: named counters, gauges and HdrHistogram
windows shared by every subsystem.

The stats JSON (client/stats.py) is per-CLIENT — one blob per Kafka
handle, rendered from that handle's internal counters.  This registry
is per-PROCESS: the offload engine, the broker IO threads, the fleet
runner and the chaos scheduler all register into ONE flat namespace,
so a bench artifact or a fleet verdict can carry a single versioned
snapshot of everything the process observed, regardless of how many
clients (or zero clients — the fleet runner) it ran.

Contract (same as obs/trace.py, gated by the same bench.py --smoke
overhead gate):

  * a module-level ``enabled`` flag; every hot site guards itself with
    ``if metrics.enabled:`` so the disabled cost is ONE attribute load;
  * ``enable()``/``disable()`` are refcounted; the LAST disable clears
    the registry (the conftest leak fixture asserts both);
  * instruments are get-or-create by name (``counter(n)``, ``gauge(n)``,
    ``window(n)``) — sites never hold references across enable cycles,
    so a cleared registry can never swallow later increments;
  * ``snapshot()`` renders the whole registry under a versioned schema
    (``SCHEMA``); window dicts carry exactly the STATISTICS.md window
    keys so the stats-schema test covers them bidirectionally.

Instrument costs are enabled-only: Counter.inc is one locked int add,
Window.record one locked HdrHistogram record (O(1), constant memory).
obs/ is outside the analysis lock-factory scope (like trace.py): plain
``threading.Lock`` keeps this module importable from anywhere without
dragging the analysis layer into stdlib-light processes.
"""
from __future__ import annotations

import threading
from typing import Optional

#: snapshot schema version — bump when the rendered shape changes
SCHEMA = 1

#: master switch — hot sites check THIS attribute inline
enabled = False

_lock = threading.Lock()
_enable_count = 0
_counters: dict[str, "Counter"] = {}
_gauges: dict[str, "Gauge"] = {}
_windows: dict[str, "Window"] = {}


class Counter:
    """Monotonic event count (e.g. ``engine.launches``)."""

    __slots__ = ("name", "_v", "_lk")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lk = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lk:
            self._v += n

    @property
    def value(self) -> int:
        with self._lk:
            return self._v


class Gauge:
    """Last-write-wins level (e.g. ``fleet.workers``)."""

    __slots__ = ("name", "_v", "_lk")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lk = threading.Lock()

    def set(self, v: float) -> None:
        with self._lk:
            self._v = v

    @property
    def value(self) -> float:
        with self._lk:
            return self._v


class Window:
    """HdrHistogram value distribution (microsecond convention, like
    the stats Avg windows).  Non-destructive snapshot: the registry is
    process-lifetime state, not an interval roller."""

    __slots__ = ("name", "_hist", "_lk")

    #: STATISTICS.md percentile fields (client/stats.py Avg.PCTS)
    PCTS = ((50, "p50"), (75, "p75"), (90, "p90"), (95, "p95"),
            (99, "p99"), (99.99, "p99_99"))

    def __init__(self, name: str, lowest: int = 1,
                 highest: int = 60_000_000, sigfigs: int = 2):
        from ..utils.hdrhistogram import HdrHistogram
        self.name = name
        self._hist = HdrHistogram(lowest, highest, sigfigs)
        self._lk = threading.Lock()

    def record(self, v: float) -> None:
        with self._lk:
            self._hist.record(max(1, int(v)))

    def render(self) -> dict:
        with self._lk:
            h = self._hist
            vals, stddev = h.snapshot([p for p, _ in self.PCTS])
            out = {"min": h.min_v, "max": h.max_v,
                   "avg": int(h.mean()), "sum": h.sum_v, "cnt": h.total,
                   "stddev": int(stddev), "hdrsize": h.memsize,
                   "outofrange": h.out_of_range}
            for (_pct, name), v in zip(self.PCTS, vals):
                out[name] = v
        return out


# ------------------------------------------------------ registration --
def counter(name: str) -> Counter:
    c = _counters.get(name)
    if c is None:
        with _lock:
            c = _counters.setdefault(name, Counter(name))
    return c


def gauge(name: str) -> Gauge:
    g = _gauges.get(name)
    if g is None:
        with _lock:
            g = _gauges.setdefault(name, Gauge(name))
    return g


def window(name: str) -> Window:
    w = _windows.get(name)
    if w is None:
        with _lock:
            w = _windows.setdefault(name, Window(name))
    return w


def registered_count() -> int:
    with _lock:
        return len(_counters) + len(_gauges) + len(_windows)


# ---------------------------------------------------- enable/disable --
def enable() -> None:
    """Turn the registry on (refcounted, like trace.enable)."""
    global enabled, _enable_count
    with _lock:
        _enable_count += 1
        enabled = True


def disable() -> None:
    """Drop one reference; the last one turns recording off and clears
    the registry (asserted by the conftest leak fixture)."""
    global enabled, _enable_count
    with _lock:
        if _enable_count > 0:
            _enable_count -= 1
        if _enable_count == 0:
            enabled = False
            _counters.clear()
            _gauges.clear()
            _windows.clear()


# -------------------------------------------------------- rendering --
def snapshot() -> dict:
    """The whole registry under the versioned schema — embedded in the
    per-client stats blob (STATISTICS.md ``obs``) and in every
    ``bench.py --json`` artifact."""
    with _lock:
        counters = list(_counters.values())
        gauges = list(_gauges.values())
        windows = list(_windows.values())
    return {
        "schema": SCHEMA,
        "enabled": enabled,
        "counters": {c.name: c.value for c in counters},
        "gauges": {g.name: g.value for g in gauges},
        "windows": {w.name: w.render() for w in windows},
    }
