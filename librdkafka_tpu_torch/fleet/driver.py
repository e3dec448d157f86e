"""Fleet driver: spawn and supervise a population of real client OS
processes, merge their streamed ledgers into delivery oracles, and
aggregate fleet-level metrics.

The port's copy of the JAX package's ``fleet/driver.py``.  One
``FleetDriver`` owns N worker subprocesses (this package's
``fleet/_worker.py``, executed by path, so every client runs the port),
speaking the stdin/stdout JSON-line protocol
documented there.  Per worker, a named reader thread
(``fleet-rd-<name>``) ingests the stream:

  * acked-produce rows merge into EVERY group's ``DeliveryOracle``
    (fan-out: each consumer group must independently deliver the whole
    acked set — loss is judged per group, not "someone somewhere saw
    it");
  * consumed rows and group assign/revoke/poll events route to the
    worker's OWN group's oracle, so convergence/coverage/stuck
    invariants hold per group over the merged membership;
  * per-worker stats (produced/acked/consumed counts, produce->ack
    latency percentiles from the worker's HdrHistogram) land in the
    driver's stats table for the fleet aggregate.

Worker pids are registered in ``mock.external``'s subprocess registry
(as ``fleet-worker-<name>``) the moment they spawn, so the conftest
leak fixture fails any test that loses a worker exactly like a lost
broker relay — and ``reap_leaked()`` covers both.

Observability (``trace=True``): the driver enables its own
trace rings, tells every worker to do the same (flight dumps land in
a registered temp dir), runs the clock offset exchange per worker
(``clock_sync``), ingests streamed flight-dump paths and the final
inline ring dumps, and hands ``collect_traces()`` the per-process
dumps that obs/collect.py merges into ONE Perfetto timeline.
"""
from __future__ import annotations

import json
import os
import selectors
import subprocess
import sys
import threading
import time
from typing import Optional

from ..analysis.locks import new_lock
from ..analysis.races import shared_dict, shared_list
from ..chaos.oracle import DeliveryOracle
from ..mock import external
from ..obs import collect as _collect
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .traffic import TrafficPlan

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_worker.py")


class _Worker:
    """One spawned client process + its stream bookkeeping."""

    __slots__ = ("spec", "proc", "pid", "reader", "done_evt", "clock")

    def __init__(self, spec: dict, proc: subprocess.Popen):
        self.spec = spec
        self.proc = proc
        self.pid = proc.pid
        self.reader: Optional[threading.Thread] = None
        self.done_evt = threading.Event()
        #: (offset_ns, err_ns) from clock_sync — worker clock into the
        #: driver's timebase; None until the exchange completes
        self.clock: Optional[tuple] = None

    @property
    def name(self) -> str:
        return self.spec["name"]

    @property
    def role(self) -> str:
        return self.spec["role"]


class FleetDriver:  # lint: ok shared-state
    """shared-state pragma is NOT used — the cross-thread tables are
    declared below; procs/pids are start()/stop()-thread-only and the
    per-worker stream state is owned by its reader thread."""

    #: worker name -> latest stats line (reader threads write, the
    #: aggregator reads; all under fleet.driver)
    stats: dict
    #: worker name -> final done summary
    done: dict
    #: worker/protocol errors observed on any stream
    errors: list
    #: clock token -> (worker mono_ns, driver recv mono_ns)
    clock_samples: dict
    #: worker name -> final inline ring-dump payload
    traces: dict
    #: streamed flight-recorder dump records ({worker, path})
    flight_paths: list

    def __init__(self, bootstrap: str, plan: TrafficPlan, *,
                 launch_timeout: float = 30.0,
                 dump_dir: Optional[str] = None,
                 trace: bool = False):
        self.bootstrap = bootstrap
        self.plan = plan
        self.launch_timeout = launch_timeout
        self._lock = new_lock("fleet.driver")
        self.stats = shared_dict("fleet.stats")
        self.done = shared_dict("fleet.done")
        self.errors = shared_list("fleet.errors")
        self.clock_samples = shared_dict("fleet.clock")
        self.traces = shared_dict("fleet.traces")
        self.flight_paths = shared_list("fleet.flight")
        self.trace = trace
        self.trace_dir: Optional[str] = None
        if trace:
            # driver-side rings + a registered flight-dump dir shared
            # with every worker (released in stop(); conftest fails
            # tests that leak it)
            self.trace_dir = _collect.make_dump_dir("tk_fleet_")
            _trace.enable(dump_dir=self.trace_dir)
        # one oracle per consumer group: every group must deliver the
        # whole acked set (record_acks fans out), its own members feed
        # only its own group ledger
        self.oracles = [DeliveryOracle(dump_dir=dump_dir)
                        for _ in range(max(1, plan.n_groups))]
        self.workers: list[_Worker] = []
        self._started = False
        self._stopped = False

    # ------------------------------------------------------- lifecycle --
    def start(self) -> "FleetDriver":
        assert not self._started, "fleet already started"
        self._started = True
        t0 = _trace.now() if _trace.enabled else 0
        env = dict(os.environ)
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_parent + os.pathsep
                             + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        # spawn the whole population first (interpreter startups
        # overlap), then collect handshakes in order
        for spec in self.plan.specs:
            proc = subprocess.Popen(
                [sys.executable, _WORKER],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, env=env)
            w = _Worker(spec, proc)
            self.workers.append(w)
            external.register_pids(
                {proc.pid: f"fleet-worker-{spec['name']}"})
        deadline = time.monotonic() + self.launch_timeout
        try:
            for w in self.workers:
                hs = self._read_handshake(w, deadline)
                assert hs.get("ready") and hs.get("pid") == w.pid, \
                    f"worker {w.name} bad handshake: {hs}"
        except Exception:
            self.stop()
            raise
        for w in self.workers:
            spec = (dict(w.spec, trace=True, flight_dir=self.trace_dir)
                    if self.trace else w.spec)
            self._send(w, {"cmd": "start", "bootstrap": self.bootstrap,
                           "spec": spec})
            w.reader = threading.Thread(
                target=self._read_stream, args=(w,),
                name=f"fleet-rd-{w.name}", daemon=True)
            w.reader.start()
        if t0:
            _trace.complete("fleet", "fleet_start", t0,
                            {"workers": len(self.workers)})
        if _metrics.enabled:
            _metrics.gauge("fleet.workers").set(len(self.workers))
        return self

    def _read_handshake(self, w: _Worker, deadline: float) -> dict:
        fd = w.proc.stdout.fileno()
        sel = selectors.DefaultSelector()
        sel.register(fd, selectors.EVENT_READ)
        try:
            left = deadline - time.monotonic()
            if left <= 0 or not sel.select(timeout=left):
                raise TimeoutError(f"worker {w.name} handshake timeout")
        finally:
            sel.close()
        line = w.proc.stdout.readline()
        if not line:
            raise RuntimeError(
                f"worker {w.name} died at startup "
                f"(exit {w.proc.poll()})")
        return json.loads(line)

    def _send(self, w: _Worker, obj: dict) -> None:
        try:
            w.proc.stdin.write(
                json.dumps(obj, separators=(",", ":")).encode() + b"\n")
            w.proc.stdin.flush()
        except (OSError, ValueError):
            pass                        # already dead; reaped at stop()

    # --------------------------------------------------------- ingest --
    def _read_stream(self, w: _Worker) -> None:
        oracle = self._group_oracle(w)
        for line in iter(w.proc.stdout.readline, b""):
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            t = msg.get("type")
            if t == "acks":
                rows = [(r[0], r[1], r[2], r[3], r[4], None, r[5])
                        for r in msg["rows"]]
                if _metrics.enabled:
                    _metrics.counter("fleet.ack_rows").inc(len(rows))
                for o in self.oracles:
                    o.record_acks(rows)
            elif t == "consumed":
                oracle.record_consumed_rows(
                    [(r[0], r[1], r[2], r[3]) for r in msg["rows"]])
            elif t == "failed":
                for r in msg["rows"]:
                    oracle.record_failed(r[0], r[1], r[2], None, r[3])
            elif t == "group":
                # cooperative workers flag incremental deltas (KIP-429)
                # and revokes carry their partition set; eager events
                # keep the full-replace / full-revoke semantics
                if msg["event"] == "assign":
                    oracle.record_assign(
                        msg["member"],
                        [(p[0], p[1]) for p in msg["parts"]],
                        incremental=bool(msg.get("incremental")))
                elif msg["event"] == "revoke":
                    parts = msg.get("parts") or None
                    oracle.record_revoke(
                        msg["member"],
                        [(p[0], p[1]) for p in parts]
                        if msg.get("incremental") and parts else None)
            elif t == "poll":
                oracle.record_poll(msg["member"])
            elif t == "stats":
                with self._lock:
                    self.stats[msg["name"]] = msg
            elif t == "clock":
                # stamp the receive side of the offset exchange HERE,
                # in the reader, so queueing in clock_sync's poll loop
                # never widens the error bound
                with self._lock:
                    self.clock_samples[msg.get("token")] = (
                        msg["mono_ns"], time.monotonic_ns())
            elif t == "flight":
                if _trace.enabled:
                    _trace.instant("fleet", "flight_collected",
                                   {"worker": w.name})
                with self._lock:
                    self.flight_paths.append({"worker": w.name,
                                              "path": msg.get("path")})
            elif t == "trace":
                with self._lock:
                    self.traces[w.name] = msg
            elif t == "done":
                with self._lock:
                    self.done[msg["name"]] = msg["summary"]
                w.done_evt.set()
            elif t == "error":
                with self._lock:
                    self.errors.append(f"{msg.get('name')}: "
                                       f"{msg.get('error')}")
                w.done_evt.set()

    def _group_oracle(self, w: _Worker) -> DeliveryOracle:
        gi = w.spec.get("group_idx", 0)
        return self.oracles[gi if gi < len(self.oracles) else 0]

    # -------------------------------------------------- observability --
    def clock_sync(self, rounds: int = 3, timeout: float = 30.0) -> dict:
        """Per-worker clock offset exchange (the obs/collect.py model):
        ping each worker ``rounds`` times, keep the minimum-error
        round.  The first reply can lag seconds behind the worker's
        heavy package import, so the deadline covers the whole sync —
        run this during the traffic window, it costs the fleet
        nothing."""
        out: dict = {}
        deadline = time.monotonic() + timeout
        for w in self.workers:
            best = None
            for i in range(rounds):
                token = f"ck-{w.name}-{i}"
                t_send = time.monotonic_ns()
                self._send(w, {"cmd": "clock", "token": token})
                sample = None
                while time.monotonic() < deadline:
                    with self._lock:
                        sample = self.clock_samples.get(token)
                    if sample is not None or w.proc.poll() is not None:
                        break
                    time.sleep(0.005)
                if sample is None:
                    break
                off, err = _collect.align_offset(t_send, sample[0],
                                                 sample[1])
                if best is None or err < best[1]:
                    best = (off, err)
            w.clock = best
            if best is not None:
                out[w.name] = {"offset_ns": best[0], "err_ns": best[1]}
        return out

    def collect_traces(self, timeout: float = 30.0) -> list:
        """The per-process dumps for obs/collect.merge: the driver's
        own rings plus every worker's inline ring dump (workers ship
        theirs as the final protocol line before exiting — wait for
        stragglers, but never for a dead worker whose pipe drained)."""
        assert self.trace, "driver not constructed with trace=True"
        deadline = time.monotonic() + timeout
        names = {w.name for w in self.workers}
        while time.monotonic() < deadline:
            with self._lock:
                missing = names - set(self.traces)
            if not missing:
                break
            if all(w.proc.poll() is not None
                   and (w.reader is None or not w.reader.is_alive())
                   for w in self.workers if w.name in missing):
                break
            time.sleep(0.05)
        dumps = [_collect.ProcessDump("fleet-driver", os.getpid(),
                                      _trace.collect_events())]
        with self._lock:
            traces = dict(self.traces)
        for w in self.workers:
            payload = traces.get(w.name)
            if payload is None:
                continue
            off, err = w.clock if w.clock is not None else (0, 0)
            dumps.append(_collect.ProcessDump(
                f"worker-{w.name}", payload.get("pid", w.pid),
                payload.get("events", []), off, err))
        return dumps

    def flight_dumps(self, inline: bool = True) -> list:
        """Every flight-recorder dump the fleet produced: streamed
        paths first, then a sweep of the shared flight dir (a worker
        killed between writing the dump and streaming its path still
        left the file).  ``inline`` attaches the parsed payload — a
        chaos verdict must ship its evidence, not a path into a temp
        dir that stop() deletes."""
        with self._lock:
            records = [dict(r) for r in self.flight_paths]
        seen = {r["path"] for r in records}
        if self.trace_dir and os.path.isdir(self.trace_dir):
            for fn in sorted(os.listdir(self.trace_dir)):
                p = os.path.join(self.trace_dir, fn)
                if fn.startswith("tk_flight_") and p not in seen:
                    records.append({"worker": None, "path": p})
        for r in records:
            r["exists"] = bool(r["path"]) and os.path.isfile(r["path"])
            if inline and r["exists"]:
                try:
                    with open(r["path"]) as f:
                        payload = json.load(f)
                    r["events"] = sum(
                        1 for e in payload.get("traceEvents", [])
                        if e.get("ph") != "M")
                    r["payload"] = payload
                except (OSError, ValueError):
                    r["payload"] = None
        return records

    # ----------------------------------------------------------- stop --
    def stop_role(self, role: str, timeout: float = 60.0) -> None:
        """Graceful stop of one role tier (producers first, so the
        drain phase measures delivery, then consumers after the group
        verdict freezes — the Storm ordering, fleet-wide)."""
        targets = [w for w in self.workers if w.role == role]
        for w in targets:
            self._send(w, {"cmd": "stop"})
        deadline = time.monotonic() + timeout
        for w in targets:
            left = max(0.1, deadline - time.monotonic())
            try:
                w.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                try:
                    w.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass

    def stop(self) -> None:
        """Full teardown (idempotent): stop every worker, reap every
        pid, deregister from the leak registry, join readers."""
        if self._stopped:
            return
        self._stopped = True
        for w in self.workers:
            self._send(w, {"cmd": "stop"})
        deadline = time.monotonic() + 30.0
        for w in self.workers:
            left = max(0.1, deadline - time.monotonic())
            try:
                w.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                try:
                    w.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        for w in self.workers:
            if w.reader is not None:
                w.reader.join(10)
            for f in (w.proc.stdin, w.proc.stdout):
                try:
                    f.close()
                except OSError:
                    pass
        external.deregister_pids([w.pid for w in self.workers])
        if self.trace:
            # release the driver's tracer reference and the shared
            # flight-dump dir exactly once (conftest fails leaks of
            # either); callers collect traces/dumps BEFORE stop()
            self.trace = False
            _trace.disable()
            if self.trace_dir is not None:
                _collect.release_dump_dir(self.trace_dir)

    def __enter__(self) -> "FleetDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------- verdict --
    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every group's oracle has consumed every acked
        record (or the deadline makes the gap a loss verdict)."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if all(o.missing_count() == 0 for o in self.oracles):
                return True
            time.sleep(0.2)
        return all(o.missing_count() == 0 for o in self.oracles)

    def wait_converged(self, timeout: float = 25.0) -> Optional[float]:
        """Wait for every (group, topic) cover to converge; returns
        the convergence latency in seconds, or None (a violation)."""
        t0 = time.monotonic()
        end = t0 + timeout
        while time.monotonic() < end:
            if all(o.group_coverage(t, self.plan.partitions)["converged"]
                   for o in self.oracles for t in self.plan.topics):
                return round(time.monotonic() - t0, 2)
            time.sleep(0.2)
        return None

    def freeze_group_verdicts(self) -> list[dict]:
        """Snapshot each group's coverage BEFORE consumers stop — the
        teardown LeaveGroup cascade must not read as lost coverage."""
        now = time.monotonic()
        return [{"coverage": {t: o.group_coverage(t, self.plan.partitions)
                              for t in self.plan.topics},
                 "now": now}
                for o in self.oracles]

    def verify(self, *, converged_s: Optional[float],
               snapshots: Optional[list] = None,
               raise_on_violation: bool = True) -> list[dict]:
        """Judge every group's merged ledger: zero acked loss per
        group, coverage exact, nobody stuck.  Duplicates/order are
        relaxed — a multi-member group under kills is at-least-once
        (CHAOS.md) — while loss is always enforced."""
        reports = []
        for gi, o in enumerate(self.oracles):
            for topic in self.plan.topics:
                snap = snapshots[gi] if snapshots else None
                reports.append(o.verify(
                    check_duplicates=False, check_order=False,
                    check_group=True, group_topic=topic,
                    group_partitions=self.plan.partitions,
                    converged_s=converged_s,
                    coverage=snap["coverage"][topic] if snap else None,
                    now=snap["now"] if snap else None,
                    raise_on_violation=raise_on_violation))
        return reports

    # -------------------------------------------------------- metrics --
    def metrics(self) -> dict:
        """The fleet aggregate: total msgs/s over the acked window,
        per-client produce->ack p99 (max + median across clients), and
        raw per-worker summaries."""
        with self.oracles[0]._lock:
            acked_ts = sorted(self.oracles[0].acked_ts)
        with self._lock:
            stats = {k: dict(v) for k, v in self.stats.items()}
            done = {k: dict(v) for k, v in self.done.items()}
        for name, s in done.items():        # final beats periodic
            stats.setdefault(name, {}).update(s)
        p99s = {n: s["p99_ms"] for n, s in stats.items()
                if s.get("p99_ms") is not None}
        window = (acked_ts[-1] - acked_ts[0]) if len(acked_ts) > 1 else 0.0
        vals = sorted(p99s.values())
        return {
            "workers": len(self.workers),
            "acked_total": len(acked_ts),
            "fleet_msgs_s": (round(len(acked_ts) / window, 1)
                             if window > 0 else None),
            "client_p99_ms": p99s,
            "client_p99_ms_max": vals[-1] if vals else None,
            "client_p99_ms_median": (vals[len(vals) // 2]
                                     if vals else None),
            "produced_total": sum(s.get("produced", 0)
                                  for s in stats.values()),
            "consumed_total": sum(s.get("consumed", 0)
                                  for s in stats.values()),
        }

    def replay_key(self) -> str:
        return self.plan.replay_key()

    def set_worker_rlimit(self, name: str, nbytes: int) -> dict:
        """Memory-pressure fault on one WORKER process (the client
        side of the env_rlimit verb): soft RLIMIT_AS via prlimit —
        0 restores the soft limit to infinity."""
        import resource
        w = next(x for x in self.workers if x.name == name)
        soft = resource.RLIM_INFINITY if nbytes <= 0 else int(nbytes)
        old = resource.prlimit(w.pid, resource.RLIMIT_AS,
                               (soft, resource.RLIM_INFINITY))
        return {"worker": name, "pid": w.pid, "soft": soft, "old": old}
