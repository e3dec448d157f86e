"""One fleet client: a real OS process running one producer or one
consumer-group member of the port (``librdkafka_tpu_torch``) against the
supervised cluster.  The port's copy of the JAX package's
``fleet/_worker.py``.

Executed BY PATH (``python .../fleet/_worker.py``) from the fleet
driver — deliberately not ``-m``, and nothing package-flavored is
imported at module scope: the handshake line goes out while the
process is still pure stdlib, so spawning a hundred workers costs
milliseconds each, and the heavy import (the client package) happens
exactly once, after the driver's ``start`` command arrives with the
worker's spec.

Line protocol (one JSON object per line):

  stdout  {"pid": N, "ready": true}                      handshake
          {"type": "acks",     "rows": [[t,p,off,key,val,ts], ...]}
          {"type": "failed",   "rows": [[t,p,val,err], ...]}
          {"type": "consumed", "rows": [[t,p,off,val,ts], ...]}
          {"type": "group", "event": "assign"|"revoke",
           "member": name, "parts": [[t,p], ...]}
          {"type": "poll",  "member": name}               liveness
          {"type": "stats", "name", "produced", "acked", "consumed",
           "p50_ms", "p99_ms", "max_ms"}                  periodic
          {"type": "done",  "name", "summary": {...}}     final
          {"type": "error", "name", "error": repr}
          {"type": "clock", "token", "mono_ns"}           clock reply
          {"type": "flight", "path"}              flight-recorder dump
          {"type": "trace", "name", "pid", "mono_ns",
           "events": [...]}                     ring dump at exit
  stdin   {"cmd": "start", "bootstrap": "...", "spec": {...}}
          {"cmd": "clock", "token": ...}
          {"cmd": "stop"}

Observability: when ``spec["trace"]`` is set the worker
enables its own obs/trace.py rings (flight dumps land in
``spec["flight_dir"]``), answers the driver's ``clock`` offset
exchange with ``time.monotonic_ns()``, streams flight-dump paths the
moment they appear (so a worker that dies mid-storm already shipped
its evidence), and ships its whole ring dump inline as the final
``trace`` line before exiting — the driver merges every process's
dump into one timeline (obs/collect.py).

``ts`` stamps are ``time.monotonic()`` — on Linux CLOCK_MONOTONIC is
machine-wide, so the driver can correlate them with the chaos
timeline's ``mono`` stamps for recovery envelopes.  The worker exits
on ``stop``, on stdin EOF (driver died — orphan protection, same
double-wall as mock/_relay.py), or at the spec's ``max_s`` deadline.

All worker randomness (keys, partitions, pacing jitter) draws from
``random.Random(spec["seed"])`` — the fleet replay contract.
"""
import json
import os
import random
import selectors
import sys
import time

FLUSH_EVERY_S = 0.25        # ledger/stats streaming cadence
POLL_EVERY_S = 0.4          # group-liveness heartbeat cadence
ROW_CAP = 400               # max ledger rows per stdout line

_TR = None                  # obs.trace module when spec["trace"] is set
_last_flight = None


def _emit(obj) -> None:
    sys.stdout.write(json.dumps(obj, separators=(",", ":")) + "\n")
    sys.stdout.flush()


def _poll_ctl(cmd) -> bool:
    """Dispatch one driver command; True means stop.  The clock reply
    is stamped HERE, as close to the read as possible, so the driver's
    half-round-trip error bound stays honest."""
    if not cmd:
        return False
    c = cmd.get("cmd")
    if c == "stop":
        return True
    if c == "clock":
        _emit({"type": "clock", "token": cmd.get("token"),
               "mono_ns": time.monotonic_ns()})
    return False


def _flight_watch() -> None:
    """Stream any new flight-recorder dump path immediately — the
    driver must hold the evidence BEFORE a chaos verdict (or a worker
    death) needs it."""
    global _last_flight
    if _TR is not None and _TR.last_flight_path != _last_flight:
        _last_flight = _TR.last_flight_path
        _emit({"type": "flight", "path": _last_flight})


class _Stdin:
    """Non-blocking stdin command reader (selector + line buffer)."""

    def __init__(self):
        self._sel = selectors.DefaultSelector()
        self._sel.register(sys.stdin.fileno(), selectors.EVENT_READ)
        self._buf = b""
        self.eof = False

    def next_cmd(self, timeout: float = 0.0):
        """One decoded command dict, or None.  ``eof`` latches when
        the driver's pipe closes."""
        if b"\n" not in self._buf and not self.eof:
            if self._sel.select(timeout=timeout):
                chunk = os.read(sys.stdin.fileno(), 65536)
                if not chunk:
                    self.eof = True
                self._buf += chunk
        if b"\n" in self._buf:
            raw, _, self._buf = self._buf.partition(b"\n")
            try:
                return json.loads(raw)
            except ValueError:
                return None
        return None


def _lat_summary(hist) -> dict:
    if hist.total == 0:
        return {"p50_ms": None, "p99_ms": None, "max_ms": None}
    return {"p50_ms": round(hist.value_at_percentile(50) / 1000.0, 2),
            "p99_ms": round(hist.value_at_percentile(99) / 1000.0, 2),
            "max_ms": round(hist.max_v / 1000.0, 2)}


def _run_producer(spec: dict, bootstrap: str, ctl: _Stdin) -> dict:
    from librdkafka_tpu_torch import Producer
    from librdkafka_tpu_torch.fleet.traffic import (Pacer,
                                                    PartitionPicker,
                                                    ZipfSampler)
    from librdkafka_tpu_torch.utils.hdrhistogram import HdrHistogram

    name = spec["name"]
    topic = spec["topic"]
    rng = random.Random(spec["seed"])
    pacer = Pacer(spec["shape"])
    picker = PartitionPicker(spec["partitions"], spec.get("part_skew"), rng)
    keys = (ZipfSampler(spec["keys"], rng)
            if spec.get("keys") else None)
    hist = HdrHistogram(1, 60_000_000, 2)       # produce->ack latency, us

    p = Producer({
        "bootstrap.servers": bootstrap,
        "linger.ms": 2,
        "enable.idempotence": True,
        "message.send.max.retries": 1000,
        "retry.backoff.ms": 50,
        "message.timeout.ms": 120000,
        "reconnect.backoff.ms": 50,
        "reconnect.backoff.max.ms": 1000,       # chaos-rig tuning
    })
    acks: list = []
    failed: list = []
    produced = acked = 0

    def _dr(t_sent: float, value: str):
        def _cb(err, msg):
            nonlocal acked
            now = time.monotonic()
            if err is None:
                acked += 1
                hist.record(max(1, int((now - t_sent) * 1e6)))
                acks.append([msg.topic, msg.partition, msg.offset,
                             msg.key.decode("latin1") if msg.key else None,
                             value, round(now, 4)])
            else:
                failed.append([msg.topic, msg.partition, value, str(err)])
        return _cb

    t0 = time.monotonic()
    deadline = t0 + spec.get("max_s", 120.0)
    next_flush = t0 + FLUSH_EVERY_S
    stopping = False
    try:
        while True:
            now = time.monotonic()
            if now >= deadline:
                break
            cmd = ctl.next_cmd(0.0)
            if ctl.eof or _poll_ctl(cmd):
                stopping = True
            if stopping:
                break
            n = pacer.take(now - t0)
            for _ in range(n):
                value = "%s-%08d" % (name, produced)
                key = ("k%06d" % keys.rank()) if keys else None
                try:
                    p.produce(topic, value.encode(),
                              key=key.encode() if key else None,
                              partition=picker.pick(),
                              on_delivery=_dr(time.monotonic(), value))
                    produced += 1
                except Exception as e:   # _QUEUE_FULL etc: poll + retry
                    if "_QUEUE_FULL" not in repr(e):
                        raise
                    p.poll(0.05)
                    break
            p.poll(0)
            if now >= next_flush:
                next_flush = now + FLUSH_EVERY_S
                if acks:
                    _emit({"type": "acks", "rows": acks[:ROW_CAP]})
                    del acks[:ROW_CAP]
                if failed:
                    _emit({"type": "failed", "rows": failed[:ROW_CAP]})
                    del failed[:ROW_CAP]
                _emit({"type": "stats", "name": name, "produced": produced,
                       "acked": acked, **_lat_summary(hist)})
                _flight_watch()
            if n == 0:
                time.sleep(0.002)
    finally:
        left = p.flush(60.0)
        p.close()
        while acks:
            _emit({"type": "acks", "rows": acks[:ROW_CAP]})
            del acks[:ROW_CAP]
        if failed:
            _emit({"type": "failed", "rows": failed})
    return {"produced": produced, "acked": acked, "unflushed": left,
            **_lat_summary(hist)}


def _run_consumer(spec: dict, bootstrap: str, ctl: _Stdin) -> dict:
    from librdkafka_tpu_torch import Consumer

    name = spec["name"]
    c = Consumer({
        "bootstrap.servers": bootstrap,
        "group.id": spec["group"],
        "client.id": name.replace(":", "-"),
        "auto.offset.reset": "earliest",
        "isolation.level": spec.get("isolation", "read_uncommitted"),
        # strategy knob: "cooperative-sticky" runs the
        # KIP-429 incremental protocol — fleet_storm exercises it
        "partition.assignment.strategy":
            spec.get("strategy", "range,roundrobin"),
        "heartbeat.interval.ms": 400,   # inside the mock's 3s rebalance
        "session.timeout.ms": 6000,     # window (group tuning)
        "reconnect.backoff.ms": 50,
        "reconnect.backoff.max.ms": 1000,
    })

    def _on_assign(cons, parts):
        coop = cons.rebalance_protocol() == "COOPERATIVE"
        _emit({"type": "group", "event": "assign", "member": name,
               "incremental": coop,
               "parts": [[tp.topic, tp.partition] for tp in parts]})
        if coop:
            cons.incremental_assign(parts)
        else:
            cons.assign(parts)

    def _on_revoke(cons, parts):
        coop = cons.rebalance_protocol() == "COOPERATIVE"
        _emit({"type": "group", "event": "revoke", "member": name,
               "incremental": coop,
               "parts": [[tp.topic, tp.partition] for tp in parts]
               if coop else []})
        if coop:
            cons.incremental_unassign(parts)
        else:
            cons.unassign()

    rows: list = []
    consumed = 0
    t0 = time.monotonic()
    deadline = t0 + spec.get("max_s", 120.0)
    next_flush = t0 + FLUSH_EVERY_S
    next_poll_beat = t0
    try:
        c.subscribe(spec["topics"], on_assign=_on_assign,
                    on_revoke=_on_revoke)
        while True:
            now = time.monotonic()
            if now >= deadline:
                break
            cmd = ctl.next_cmd(0.0)
            if ctl.eof or _poll_ctl(cmd):
                break
            m = c.poll(0.1)
            if now >= next_poll_beat:
                next_poll_beat = now + POLL_EVERY_S
                _emit({"type": "poll", "member": name})
            if m is not None and m.error is None:
                consumed += 1
                rows.append([m.topic, m.partition, m.offset,
                             m.value.decode("latin1") if m.value else "",
                             round(time.monotonic(), 4)])
            if now >= next_flush:
                next_flush = now + FLUSH_EVERY_S
                while rows:
                    _emit({"type": "consumed", "rows": rows[:ROW_CAP]})
                    del rows[:ROW_CAP]
                _emit({"type": "stats", "name": name,
                       "consumed": consumed})
                _flight_watch()
    finally:
        c.close()
        while rows:
            _emit({"type": "consumed", "rows": rows[:ROW_CAP]})
            del rows[:ROW_CAP]
    return {"consumed": consumed}


def main() -> int:
    _emit({"pid": os.getpid(), "ready": True})
    ctl = _Stdin()
    # block (pure stdlib, cheap to sit here) until the driver starts us
    start = None
    deadline = time.monotonic() + 60.0
    while start is None:
        if time.monotonic() >= deadline or ctl.eof:
            return 1
        cmd = ctl.next_cmd(0.5)
        if cmd and cmd.get("cmd") == "start":
            start = cmd
        elif cmd and cmd.get("cmd") == "stop":
            return 0

    # the heavy import happens here, post-handshake: the port's parent
    # goes on sys.path exactly like mock/external.py's PYTHONPATH wiring
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if pkg_parent not in sys.path:
        sys.path.insert(0, pkg_parent)

    spec = start["spec"]
    name = spec.get("name", "w?")
    global _TR
    if spec.get("trace"):
        # the worker holds its OWN tracer reference (not via client
        # conf) so the rings survive client close() and can be shipped
        # inline as the final protocol line
        from librdkafka_tpu_torch.obs import trace as _obs_trace
        _TR = _obs_trace
        _TR.enable(dump_dir=spec.get("flight_dir"))
    try:
        if spec["role"] == "producer":
            summary = _run_producer(spec, start["bootstrap"], ctl)
        else:
            summary = _run_consumer(spec, start["bootstrap"], ctl)
        _emit({"type": "done", "name": name, "summary": summary})
        return 0
    except Exception as e:
        _emit({"type": "error", "name": name, "error": repr(e)})
        return 1
    finally:
        if _TR is not None:
            _flight_watch()
            events = _TR.collect_events()
            _TR.disable()
            _emit({"type": "trace", "name": name, "pid": os.getpid(),
                   "mono_ns": time.monotonic_ns(), "events": events})


if __name__ == "__main__":
    sys.exit(main())
