"""Flight-recorder tracing: per-thread event rings + Chrome trace export.

The stats JSON (client/stats.py, STATISTICS.md) answers "how fast is the
pipeline on average"; this module answers "where did THIS ticket spend
its 800 microseconds".  The reference treats stats as a first-class
subsystem (rd_kafka_stats_emit_all, rdkafka.c:1473) but has no event
tracer — its nearest analog is the debug-context log stream (rdlog.c),
which serializes through one mutex and costs a format call per line.
This tracer is built for the deeply pipelined offload machine, where
the interesting latency lives BETWEEN threads (codec worker -> engine
dispatch -> device -> broker IO):

  * One fixed-size ring of events PER THREAD, written lock-free (each
    ring has a single writer; the GIL makes the index/slot stores safe
    to read from the dumper).  Recording never allocates beyond the
    event tuple and never blocks on another thread.
  * A module-level ``enabled`` flag: every hook site guards itself with
    ``if trace.enabled:`` so the disabled cost is ONE attribute load —
    measured against the hook count per message by the bench.py --smoke
    overhead gate (must stay < 2% of the produce budget).
  * Spans are Chrome "complete" events (ph="X"): the instrumentation
    site captures ``t0 = trace.now()`` and emits ONE event at resolve
    time with the computed duration — no begin/end pairing across the
    pipeline's thread hops.
  * Engine spans carry the ROUTING DECISION as args: ``device_launch``
    and ``readback`` stamp ``device=<id>`` (the dispatch lane's mesh
    device, or -1 for a whole-mesh sharded launch) plus
    ``sharded=bool``, so scripts/traceview.py and Perfetto can
    attribute launch latency per chip.
  * Flight recorder: on fatal error, CRC mismatch, or request timeout
    the last N events are auto-dumped to ``flight_dir`` (bounded per
    process) so the trace that EXPLAINS the failure survives it.

Export is the Chrome trace-event JSON array format — load with Perfetto
(https://ui.perfetto.dev), chrome://tracing, or scripts/traceview.py
offline.  See TRACING.md for the workflow.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional

#: master switch — hook sites check THIS attribute inline
#: (``if trace.enabled: trace.complete(...)``), so a disabled build
#: pays one module-attribute load per hook site and nothing else
enabled = False

#: auto-dump the rings on fatal error / CRC mismatch / request timeout
dump_on_fatal = True

#: per-thread ring capacity (events); power of two (conf-validated)
ring_events = 8192

#: where flight dumps land (default: the system temp dir)
flight_dir: Optional[str] = None

#: path of the most recent flight dump (test/diagnostic hook)
last_flight_path: Optional[str] = None

#: flight dumps are bounded per process: a CRC-mismatch storm must not
#: turn the tracer into a disk-filling loop
FLIGHT_MAX_DUMPS = 8

#: cross-process flow sampling: hot paths emit ``flow_*``
#: instants keyed by (topic, partition, offset) for offsets where
#: ``offset % flow_sample_every == 0`` (0 disables); obs/collect.py
#: stitches the produce->ack->fetch->deliver chain across processes
flow_sample_every = 64

_lock = threading.Lock()
_enable_count = 0            # enable()/disable() refcount (N clients)
_generation = 0              # bumped per enable cycle; stale rings die
_rings: list["_Ring"] = []   # registry (dump/flight iterate a snapshot)
_local = threading.local()
_flight_count = 0


class _Ring:
    """Fixed-capacity event ring with a single writer (its thread).

    Events are tuples ``(ts_ns, cat, name, ph, dur_ns, args)`` stored
    into a preallocated slot list; the write index wraps with a power-
    of-two mask.  Readers (dump/flight) take a GIL-consistent snapshot
    — a concurrently-written slot shows either the old or the new
    tuple, never a torn one."""

    __slots__ = ("tid", "thread_name", "gen", "cap", "_mask", "_buf",
                 "_pos")

    def __init__(self, cap: int, gen: int):
        self.tid = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self.gen = gen
        self.cap = cap
        self._mask = cap - 1
        self._buf: list = [None] * cap
        self._pos = 0

    def append(self, ev: tuple) -> None:
        i = self._pos
        self._buf[i & self._mask] = ev
        self._pos = i + 1

    def snapshot(self) -> list[tuple]:
        """Events in write order, oldest first."""
        pos = self._pos
        buf = list(self._buf)          # GIL-atomic slot copies
        if pos <= self.cap:
            out = buf[:pos]
        else:
            i = pos & self._mask
            out = buf[i:] + buf[:i]
        return [e for e in out if e is not None]

    @property
    def dropped(self) -> int:
        """Events this ring has overwritten (its oldest, once full)."""
        return max(0, self._pos - self.cap)


def now() -> int:
    """Monotonic nanoseconds — the trace timebase."""
    return time.monotonic_ns()


def _get_ring() -> _Ring:
    ring = getattr(_local, "ring", None)
    if ring is None or ring.gen != _generation:
        ring = _Ring(ring_events, _generation)
        _local.ring = ring
        with _lock:
            if ring.gen == _generation:     # enable state didn't move
                _rings.append(ring)
    return ring


# ------------------------------------------------------------ recording --
def evt(cat: str, name: str, ph: str = "i", ts: Optional[int] = None,
        dur: int = 0, args: Optional[dict] = None) -> None:
    """Generic event append (ph: Chrome phase — "X" span, "i" instant).
    Callers on hot paths must guard with ``if trace.enabled:``; this
    re-checks only to stay safe against a concurrent disable()."""
    if not enabled:
        return
    _get_ring().append((now() if ts is None else ts, cat, name, ph,
                        dur, args))


def complete(cat: str, name: str, t0_ns: int,
             args: Optional[dict] = None) -> None:
    """One span (ph="X") from ``t0_ns`` (a prior ``trace.now()``) to
    now — the workhorse: instrumentation sites stamp t0 at submit and
    emit the whole span at resolve time, so spans that cross thread
    hops need no begin/end pairing."""
    if not enabled:
        return
    t1 = now()
    _get_ring().append((t0_ns, cat, name, "X", t1 - t0_ns, args))


def instant(cat: str, name: str, args: Optional[dict] = None) -> None:
    if not enabled:
        return
    _get_ring().append((now(), cat, name, "i", 0, args))


# ------------------------------------------------------- enable/disable --
def enable(ring: Optional[int] = None, on_fatal: Optional[bool] = None,
           dump_dir: Optional[str] = None) -> None:
    """Turn tracing on (refcounted: each client that set trace.enable
    holds one reference; the last disable() clears the rings)."""
    global enabled, ring_events, dump_on_fatal, flight_dir
    global _enable_count, _generation, _flight_count
    with _lock:
        if ring is not None:
            r = int(ring)
            if r < 64 or (r & (r - 1)):
                raise ValueError(
                    f"trace ring capacity must be a power of two >= 64, "
                    f"got {r}")
            ring_events = r
        if on_fatal is not None:
            dump_on_fatal = bool(on_fatal)
        if dump_dir is not None:
            flight_dir = dump_dir
        if _enable_count == 0:
            _generation += 1
            _flight_count = 0
            _rings.clear()
        _enable_count += 1
        enabled = True


def disable() -> None:
    """Drop one enable() reference; the last one turns tracing off and
    releases every ring (the conftest leak fixture asserts this)."""
    global enabled, _enable_count
    with _lock:
        if _enable_count > 0:
            _enable_count -= 1
        if _enable_count == 0:
            enabled = False
            _rings.clear()


def active_ring_count() -> int:
    with _lock:
        return len(_rings)


# ----------------------------------------------------------------- dump --
def _collect() -> list[dict]:
    """All rings' events as Chrome trace-event dicts, sorted by ts.
    Rings of exited threads are kept — a dead broker thread's trail is
    exactly what a flight dump needs; disable() frees everything."""
    with _lock:
        rings = list(_rings)
    pid = os.getpid()
    out = []
    for r in rings:
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": r.tid, "args": {"name": r.thread_name,
                                           "dropped": r.dropped}})
        for ts_ns, cat, name, ph, dur_ns, args in r.snapshot():
            e = {"name": name, "cat": cat, "ph": ph, "pid": pid,
                 "tid": r.tid, "ts": ts_ns / 1e3}
            if ph == "X":
                e["dur"] = dur_ns / 1e3
            elif ph == "i":
                e["s"] = "t"
            if args:
                e["args"] = args
            out.append(e)
    out.sort(key=lambda e: e.get("ts", 0))
    return out


def dropped() -> dict:
    """Events overwritten so far in each thread's ring, by thread name
    (rings of one name summed): a count that a dump, or a reader of
    ``collect_events()``, is missing from the start of that thread's
    trail."""
    with _lock:
        rings = list(_rings)
    out: dict[str, int] = {}
    for r in rings:
        out[r.thread_name] = out.get(r.thread_name, 0) + r.dropped
    return out


def thread_dropped() -> int:
    """Events overwritten so far in the calling thread's ring."""
    return _get_ring().dropped


def collect_events() -> list[dict]:
    """Public snapshot of every ring as Chrome trace-event dicts —
    the cross-process collection payload (obs/collect.py): workers,
    relays and the rig supervisor ship THIS inline over their control
    channels instead of a file path."""
    return _collect()


def dump(path: str) -> int:
    """Write every ring's events as Chrome trace-event JSON (Perfetto /
    chrome://tracing / scripts/traceview.py). Returns the event count
    (metadata records excluded)."""
    events = _collect()
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return sum(1 for e in events if e["ph"] != "M")


def flight_record(reason: str) -> Optional[str]:
    """Flight-recorder dump: called from the fatal-error, CRC-mismatch
    and request-timeout paths (kafka.set_fatal_error, the fetch verify
    resolvers, broker._scan_timeouts).  Bounded per process; returns
    the dump path or None (disabled / bound reached / IO error)."""
    global _flight_count, last_flight_path
    if not (enabled and dump_on_fatal):
        return None
    with _lock:
        if _flight_count >= FLIGHT_MAX_DUMPS:
            return None
        _flight_count += 1
        n = _flight_count
    safe = "".join(c if c.isalnum() or c in "-_." else "-"
                   for c in reason)[:64]
    d = flight_dir or tempfile.gettempdir()
    path = os.path.join(d, f"tk_flight_{os.getpid()}_{n}_{safe}.json")
    try:
        instant("flight", "flight_record", {"reason": reason})
        dump(path)
    except OSError:
        return None
    last_flight_path = path
    return path
