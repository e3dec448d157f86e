"""Fault-schedule engine: a declarative DSL of timed fault steps,
executed by a scheduler thread against the mock cluster's controller
surface (``kill_broker``/``restart_broker``/``set_partition_leader``)
and the sockem network-shaping shim.

The reference builds its robustness story on exactly this shape —
scripted network/broker faults driven by test scenarios (tests/sockem.c
interposition; 0075-retry.c latency scripts; 0093-holb.c per-connection
shaping) — but each test hand-rolls its own timing loop.  Here the
script is data::

    sched = (Schedule(seed=42)
             .at(0.5, broker_kill("any"))
             .at(1.1, broker_restart())             # revives in kill order
             .at(1.5, net(delay_ms=200, jitter_ms=50))
             .at(2.0, leader_migrate("payments", "any"))
             .at(2.5, conn_kill()))
    chaos = ChaosScheduler(cluster, sockem=em)
    chaos.start(sched)
    ...                                             # drive traffic
    chaos.join()
    chaos.timeline                                  # what actually fired

**Determinism contract** (the replay-from-seed workflow, CHAOS.md):
steps execute in (time, insertion-order) order and every random choice
("any" broker, "any" partition, jittered repeat times) draws from one
``random.Random(schedule.seed)`` consumed in that same order.  Cluster
state that feeds a choice (the alive-broker set, current leaders) is
itself only mutated by earlier steps, so the same seed resolves the
same targets no matter how wall-clock scheduling jitters: the
``replay_key()`` of two runs with one seed is identical, and a failing
storm replays exactly.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..obs import metrics as _metrics


# ------------------------------------------------------------- actions --
class Action:
    """One fault step's behavior: ``resolve`` draws targets (consuming
    the schedule's rng — the ONLY rng use, so replays are exact), then
    ``apply`` executes against cluster/sockem."""

    name = "action"

    def resolve(self, ctx: "ChaosContext", rng: random.Random) -> dict:
        return {}

    def apply(self, ctx: "ChaosContext", resolved: dict) -> None:
        raise NotImplementedError

    def __repr__(self):
        return f"<{self.name}>"


class _BrokerKill(Action):
    name = "broker_kill"

    def __init__(self, target: int | str = "any"):
        self.target = target

    def resolve(self, ctx, rng):
        t = self.target
        if isinstance(t, int):
            b = t
        elif t == "any":
            alive = ctx.cluster.alive_brokers()
            if len(alive) <= ctx.min_alive:
                return {"broker": None, "skipped": "min_alive"}
            b = rng.choice(sorted(alive))
        elif t == "controller":
            b = ctx.cluster.controller_id
        elif t.startswith("coordinator:"):
            b = ctx.cluster.coordinator_for(t.split(":", 1)[1])
        elif t.startswith("leader:"):
            _, topic, part = t.split(":")
            b = ctx.cluster.partition(topic, int(part)).leader
        else:
            raise ValueError(f"broker_kill target {t!r}")
        if b in ctx.killed:
            return {"broker": None, "skipped": "already_down"}
        return {"broker": b}

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        info = ctx.cluster.kill_broker(b)
        ctx.killed.append(b)
        resolved["migrated"] = len(info["migrated"])


class _BrokerRestart(Action):
    name = "broker_restart"

    def __init__(self, target: int | str = "killed"):
        self.target = target

    def resolve(self, ctx, rng):
        if isinstance(self.target, int):
            return {"broker": self.target}
        # "killed": revive in kill order (FIFO) — the rolling-restart
        # shape; a restart with nothing down is a recorded no-op
        if not ctx.killed:
            return {"broker": None, "skipped": "none_down"}
        return {"broker": ctx.killed[0]}

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        ctx.cluster.restart_broker(b)
        if b in ctx.killed:
            ctx.killed.remove(b)


class _ProcKill9(_BrokerKill):
    """SIGKILL the broker's OS process (out-of-process tier:
    ``ClusterHandle.kill9`` really ``kill -9``s the relay; in-process
    ``MockCluster.kill9`` applies the same controller reaction).
    Target grammar and min_alive quorum floor are _BrokerKill's."""

    name = "proc_kill9"

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        info = ctx.cluster.kill9(b)
        ctx.killed.append(b)
        if isinstance(info, dict):
            resolved["migrated"] = len(info.get("migrated") or [])


class _ProcRestart(_BrokerRestart):
    """Respawn a killed broker process (same public port, fresh pid);
    in-process this is ``restart_broker``. Distinct timeline name so
    storms read honestly in either tier."""

    name = "proc_restart"


class _ProcPause(Action):
    """SIGSTOP the broker's process — the GC-pause/VM-freeze brownout:
    connects still succeed (kernel backlog) but nothing is served, so
    clients walk the request-timeout path instead of connect-refused.
    Resolution mirrors broker_kill's target grammar; a broker already
    paused or down is skipped, and ``min_alive`` counts only brokers
    that are both alive AND unpaused (a fully-frozen cluster would
    stall the storm clock itself)."""

    name = "proc_pause"

    def __init__(self, target: int | str = "any"):
        self.target = target

    def resolve(self, ctx, rng):
        t = self.target
        responsive = [b for b in ctx.cluster.alive_brokers()
                      if b not in ctx.paused]
        if isinstance(t, int):
            b = t
        elif t == "any":
            if len(responsive) <= ctx.min_alive:
                return {"broker": None, "skipped": "min_alive"}
            b = rng.choice(sorted(responsive))
        elif t == "controller":
            b = ctx.cluster.controller_id
        elif t.startswith("coordinator:"):
            b = ctx.cluster.coordinator_for(t.split(":", 1)[1])
        elif t.startswith("leader:"):
            _, topic, part = t.split(":")
            b = ctx.cluster.partition(topic, int(part)).leader
        else:
            raise ValueError(f"proc_pause target {t!r}")
        if b in ctx.paused or b in ctx.killed:
            return {"broker": None, "skipped": "unavailable"}
        return {"broker": b}

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        ctx.cluster.pause_broker(b)
        ctx.paused.append(b)


class _ProcCont(Action):
    """SIGCONT — thaw a paused broker process. ``"paused"`` resumes in
    pause order (FIFO, the brownout-ends shape)."""

    name = "proc_cont"

    def __init__(self, target: int | str = "paused"):
        self.target = target

    def resolve(self, ctx, rng):
        if isinstance(self.target, int):
            return {"broker": self.target}
        if not ctx.paused:
            return {"broker": None, "skipped": "none_paused"}
        return {"broker": ctx.paused[0]}

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        ctx.cluster.resume_broker(b)
        if b in ctx.paused:
            ctx.paused.remove(b)


def _resolve_broker(ctx, rng, target, *, busy=(), floor: bool = True):
    """Shared target grammar for the environment-fault verbs (the
    _BrokerKill grammar): int passthrough, ``"any"`` rng-drawn from
    the responsive pool, ``"controller"``, ``"coordinator:<key>"``,
    ``"leader:t:p"``.  The responsive pool excludes every degraded
    broker — paused, in an EIO window, browned, plus the verb's own
    ``busy`` list — and ``floor`` applies the min_alive quorum rule
    to "any": the pool AFTER this fault must stay above it (two
    different env faults may not jointly freeze the quorum)."""
    degraded = (set(ctx.paused) | set(ctx.eio) | set(ctx.browned)
                | set(busy))
    responsive = [b for b in ctx.cluster.alive_brokers()
                  if b not in degraded]
    if isinstance(target, int):
        return {"broker": target}
    if target == "any":
        if floor and len(responsive) <= ctx.min_alive:
            return {"broker": None, "skipped": "min_alive"}
        if not responsive:
            return {"broker": None, "skipped": "none_responsive"}
        return {"broker": rng.choice(sorted(responsive))}
    if target == "controller":
        return {"broker": ctx.cluster.controller_id}
    if target.startswith("coordinator:"):
        return {"broker":
                ctx.cluster.coordinator_for(target.split(":", 1)[1])}
    if target.startswith("leader:"):
        _, topic, part = target.split(":")
        return {"broker": ctx.cluster.partition(topic, int(part)).leader}
    raise ValueError(f"env verb target {target!r}")


class _EnvEio(Action):
    """Disk-full/EIO window on the storage plane: Produce on the
    target broker returns KAFKA_STORAGE_ERROR (retriable — exactly a
    real broker's failed-log-dir reaction) until env_eio_clear or
    heal().  An EIO'd broker cannot accept writes, so it counts
    against the quorum floor like a paused one."""

    name = "env_eio"

    def __init__(self, target: int | str = "any"):
        self.target = target

    def resolve(self, ctx, rng):
        r = _resolve_broker(ctx, rng, self.target, busy=ctx.eio)
        b = r.get("broker")
        if b is not None and (b in ctx.eio or b in ctx.killed):
            return {"broker": None, "skipped": "unavailable"}
        return r

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        ctx.cluster.set_storage_error(b, True)
        ctx.eio.append(b)


class _EnvEioClear(Action):
    """Heal an EIO window; ``"eio"`` heals in fault order (FIFO)."""

    name = "env_eio_clear"

    def __init__(self, target: int | str = "eio"):
        self.target = target

    def resolve(self, ctx, rng):
        if isinstance(self.target, int):
            return {"broker": self.target}
        if not ctx.eio:
            return {"broker": None, "skipped": "none_eio"}
        return {"broker": ctx.eio[0]}

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        ctx.cluster.set_storage_error(b, False)
        if b in ctx.eio:
            ctx.eio.remove(b)


class _EnvSkew(Action):
    """Clock-skew fault: the target broker's wall clock reads
    ``skew_ms`` off true.  No quorum impact (a skewed broker still
    serves); heal() restores every clock."""

    name = "env_skew"

    def __init__(self, skew_ms: float, target: int | str = "any"):
        self.skew_ms = skew_ms
        self.target = target

    def resolve(self, ctx, rng):
        r = _resolve_broker(ctx, rng, self.target,
                            busy=[b for b, _s in ctx.skewed], floor=False)
        if r.get("broker") is not None:
            r["skew_ms"] = self.skew_ms
        return r

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        ctx.cluster.set_clock_skew(b, self.skew_ms)
        ctx.skewed.append((b, self.skew_ms))


class _EnvRlimit(Action):
    """Memory pressure: soft RLIMIT_AS on the target broker's relay
    OS process (out-of-process tier only — the in-process mock has no
    per-broker process, so applying there records a schedule error).
    ``nbytes=0`` would be a heal; heal() restores infinity."""

    name = "env_rlimit"

    def __init__(self, nbytes: int, target: int | str = "any"):
        self.nbytes = nbytes
        self.target = target

    def resolve(self, ctx, rng):
        r = _resolve_broker(ctx, rng, self.target, busy=ctx.rlimited,
                            floor=False)
        if r.get("broker") is not None:
            r["rlim_bytes"] = self.nbytes
        return r

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        ctx.cluster.set_rlimit(b, self.nbytes)
        ctx.rlimited.append(b)


class _EnvBrownout(Action):
    """Asymmetric-partition brownout: one-direction drop/latency on
    the target broker's relay (ClusterHandle.brownout — the
    out-of-process sockem rx_drop/tx_drop analog).  A browned broker
    may be unable to serve (full one-direction drop), so it counts
    against the quorum floor."""

    name = "env_brownout"

    def __init__(self, target: int | str = "any", *,
                 rx_drop: bool = False, tx_drop: bool = False,
                 rx_delay_ms: float = 0.0, tx_delay_ms: float = 0.0):
        self.target = target
        self.knobs = {"rx_drop": rx_drop, "tx_drop": tx_drop,
                      "rx_delay_ms": rx_delay_ms,
                      "tx_delay_ms": tx_delay_ms}

    def resolve(self, ctx, rng):
        r = _resolve_broker(ctx, rng, self.target, busy=ctx.browned)
        b = r.get("broker")
        if b is not None and (b in ctx.browned or b in ctx.killed):
            return {"broker": None, "skipped": "unavailable"}
        if b is not None:
            r.update(self.knobs)
        return r

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        ctx.cluster.brownout(b, **self.knobs)
        ctx.browned.append(b)


class _EnvBrownoutClear(Action):
    """End a brownout; ``"browned"`` clears in fault order (FIFO)."""

    name = "env_brownout_clear"

    def __init__(self, target: int | str = "browned"):
        self.target = target

    def resolve(self, ctx, rng):
        if isinstance(self.target, int):
            return {"broker": self.target}
        if not ctx.browned:
            return {"broker": None, "skipped": "none_browned"}
        return {"broker": ctx.browned[0]}

    def apply(self, ctx, resolved):
        b = resolved.get("broker")
        if b is None:
            return
        ctx.cluster.clear_brownout(b)
        if b in ctx.browned:
            ctx.browned.remove(b)


class _LeaderMigrate(Action):
    name = "leader_migrate"

    def __init__(self, topic: str, partition: int | str = "any",
                 to: int | str = "any_other"):
        self.topic = topic
        self.partition = partition
        self.to = to

    def resolve(self, ctx, rng):
        parts = ctx.cluster.topics[self.topic]
        pnum = (self.partition if isinstance(self.partition, int)
                else rng.choice(range(len(parts))))
        cur = parts[pnum].leader
        if isinstance(self.to, int):
            to = self.to
        else:
            cands = sorted(b for b in ctx.cluster.alive_brokers()
                           if b != cur)
            if not cands:
                return {"partition": pnum, "to": None,
                        "skipped": "no_candidate"}
            to = rng.choice(cands)
        return {"topic": self.topic, "partition": pnum,
                "from": cur, "to": to}

    def apply(self, ctx, resolved):
        if resolved.get("to") is None:
            return
        ctx.cluster.set_partition_leader(
            resolved["topic"], resolved["partition"], resolved["to"])


class _Net(Action):
    """Live sockem re-shaping: any subset of delay/jitter/rate/
    max_write/rx_drop/tx_drop (None = leave unchanged)."""

    name = "net"

    def __init__(self, **knobs):
        self.knobs = knobs

    def resolve(self, ctx, rng):
        return dict(self.knobs)

    def apply(self, ctx, resolved):
        if ctx.sockem is None:
            raise RuntimeError("net() step requires a Sockem in the "
                               "ChaosScheduler (sockem=...)")
        ctx.sockem.set(**resolved)


class _ConnKill(Action):
    name = "conn_kill"

    def __init__(self, count: Optional[int] = None):
        self.count = count

    def resolve(self, ctx, rng):
        return {"count": self.count}

    def apply(self, ctx, resolved):
        if ctx.sockem is None:
            raise RuntimeError("conn_kill() step requires a Sockem in "
                               "the ChaosScheduler (sockem=...)")
        resolved["killed"] = ctx.sockem.kill(self.count)


class _Call(Action):
    """Escape hatch: run an arbitrary callable(ctx) — scenario-local
    faults (e.g. pushing a scripted error stack) without a new verb."""

    name = "call"

    def __init__(self, fn, label: str = ""):
        self.fn = fn
        self.label = label or getattr(fn, "__name__", "fn")

    def resolve(self, ctx, rng):
        return {"label": self.label}

    def apply(self, ctx, resolved):
        self.fn(ctx)


# DSL constructors (the schedule is data; these just read better than
# class names at call sites)
def broker_kill(target: int | str = "any") -> Action:
    return _BrokerKill(target)


def broker_restart(target: int | str = "killed") -> Action:
    return _BrokerRestart(target)


def proc_kill9(target: int | str = "any") -> Action:
    return _ProcKill9(target)


def proc_restart(target: int | str = "killed") -> Action:
    return _ProcRestart(target)


def proc_pause(target: int | str = "any") -> Action:
    return _ProcPause(target)


def proc_cont(target: int | str = "paused") -> Action:
    return _ProcCont(target)


def env_eio(target: int | str = "any") -> Action:
    return _EnvEio(target)


def env_eio_clear(target: int | str = "eio") -> Action:
    return _EnvEioClear(target)


def env_skew(skew_ms: float, target: int | str = "any") -> Action:
    return _EnvSkew(skew_ms, target)


def env_rlimit(nbytes: int, target: int | str = "any") -> Action:
    return _EnvRlimit(nbytes, target)


def env_brownout(target: int | str = "any", **knobs) -> Action:
    return _EnvBrownout(target, **knobs)


def env_brownout_clear(target: int | str = "browned") -> Action:
    return _EnvBrownoutClear(target)


def leader_migrate(topic: str, partition: int | str = "any",
                   to: int | str = "any_other") -> Action:
    return _LeaderMigrate(topic, partition, to)


def net(**knobs) -> Action:
    return _Net(**knobs)


def conn_kill(count: Optional[int] = None) -> Action:
    return _ConnKill(count)


def call(fn, label: str = "") -> Action:
    return _Call(fn, label)


# ------------------------------------------------------------ schedule --
@dataclass
class Step:
    t: float
    action: Action
    idx: int = 0


class Schedule:
    """An ordered fault script. ``at`` is chainable; ``every`` expands
    to repeated steps at build time so the executed step list — and
    therefore rng consumption order — is fixed before the storm."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.steps: list[Step] = []

    def at(self, t: float, action: Action) -> "Schedule":
        self.steps.append(Step(t=float(t), action=action,
                               idx=len(self.steps)))
        return self

    def every(self, start: float, interval: float, count: int,
              make_action) -> "Schedule":
        """``make_action``: an Action (reused) or a zero-arg factory
        (fresh Action per repeat)."""
        for i in range(count):
            a = make_action() if callable(make_action) \
                and not isinstance(make_action, Action) else make_action
            self.at(start + i * interval, a)
        return self

    def sorted_steps(self) -> list[Step]:
        return sorted(self.steps, key=lambda s: (s.t, s.idx))

    @property
    def duration(self) -> float:
        return max((s.t for s in self.steps), default=0.0)


# ----------------------------------------------------------- execution --
@dataclass
class ChaosContext:
    cluster: object
    sockem: object = None
    #: broker_kill("any") never drops the alive count below this —
    #: storms that must keep quorum (a 1-broker cluster can't serve)
    min_alive: int = 1
    #: brokers currently down, in kill order (broker_restart FIFO)
    killed: list = field(default_factory=list)
    #: brokers currently SIGSTOPped, in pause order (proc_cont FIFO)
    paused: list = field(default_factory=list)
    #: brokers in an EIO/disk-full window (env_eio_clear FIFO)
    eio: list = field(default_factory=list)
    #: (broker, skew_ms) clock-skew faults in effect
    skewed: list = field(default_factory=list)
    #: brokers whose relay carries a lowered RLIMIT_AS
    rlimited: list = field(default_factory=list)
    #: brokers under an asymmetric brownout (env_brownout_clear FIFO)
    browned: list = field(default_factory=list)


class ChaosScheduler:  # lint: ok shared-state
    """Executes a Schedule on its own thread ("chaos-sched-*": the
    conftest leak fixture fails any test that leaves one alive).

    shared-state pragma: the timeline and ctx books are written only
    by the scheduler thread; storms read them after join()/stop() (a
    happens-before edge), and heal() runs post-join on the storm
    thread.

    ``timeline`` records every step as it fires:
    ``{"idx", "t", "action", "resolved", "wall", "error"}`` — ``idx``/
    ``t``/``action``/``resolved`` are the deterministic replay key,
    ``wall`` is the observed offset (diagnostics only)."""

    _seq = 0

    def __init__(self, cluster, sockem=None, *, min_alive: int = 1,
                 name: Optional[str] = None):
        self.ctx = ChaosContext(cluster=cluster, sockem=sockem,
                                min_alive=min_alive)
        ChaosScheduler._seq += 1
        self.name = name or f"chaos-sched-{ChaosScheduler._seq}"
        self.timeline: list[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- run --------------------------------------------------------------
    def start(self, schedule: Schedule) -> "ChaosScheduler":
        assert self._thread is None, "scheduler already started"
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, args=(schedule,), name=self.name, daemon=True)
        self._thread.start()
        return self

    def run(self, schedule: Schedule) -> list[dict]:
        """Synchronous execution (no thread) — used by the replay
        determinism tests and anywhere the caller owns the clock."""
        self._execute(schedule, wait=False)
        return self.timeline

    def _run(self, schedule: Schedule) -> None:
        self._execute(schedule, wait=True)

    def _execute(self, schedule: Schedule, wait: bool) -> None:
        rng = random.Random(schedule.seed)
        t0 = time.monotonic()
        for step in schedule.sorted_steps():
            if wait:
                delay = t0 + step.t - time.monotonic()
                if delay > 0 and self._stop.wait(delay):
                    break
            if self._stop.is_set():
                break
            entry = {"idx": step.idx, "t": step.t,
                     "action": step.action.name,
                     "wall": round(time.monotonic() - t0, 4),
                     # absolute monotonic stamp: recovery-latency
                     # metrics correlate kills with the oracle's ack
                     # timestamps (excluded from the replay key)
                     "mono": time.monotonic()}
            try:
                resolved = step.action.resolve(self.ctx, rng)
                entry["resolved"] = resolved
                step.action.apply(self.ctx, resolved)
                if _metrics.enabled:
                    _metrics.counter("chaos.faults_fired").inc()
            except Exception as e:          # record, don't kill the storm
                entry["error"] = repr(e)
            self.timeline.append(entry)

    # -- lifecycle --------------------------------------------------------
    def join(self, timeout: float = 30.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            assert not self._thread.is_alive(), \
                f"chaos scheduler {self.name} did not finish"
            self._thread = None

    def stop(self) -> None:
        """Abort remaining steps and join (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def heal(self) -> None:
        """Restore a healthy cluster after the storm: thaw every
        paused broker, restart every broker the schedule left down,
        clear sockem shaping, and lift every environment fault (EIO
        windows, clock skew, rlimits, brownouts) — the drain phase
        must measure delivery, not leftover faults."""
        for b in list(self.ctx.paused):
            self.ctx.cluster.resume_broker(b)
            self.ctx.paused.remove(b)
        for b in list(self.ctx.killed):
            self.ctx.cluster.restart_broker(b)
            self.ctx.killed.remove(b)
        for b in list(self.ctx.eio):
            self.ctx.cluster.set_storage_error(b, False)
            self.ctx.eio.remove(b)
        for b, _skew in list(self.ctx.skewed):
            self.ctx.cluster.set_clock_skew(b, 0.0)
            self.ctx.skewed.remove((b, _skew))
        for b in list(self.ctx.rlimited):
            self.ctx.cluster.set_rlimit(b, 0)
            self.ctx.rlimited.remove(b)
        for b in list(self.ctx.browned):
            self.ctx.cluster.clear_brownout(b)
            self.ctx.browned.remove(b)
        if self.ctx.sockem is not None:
            self.ctx.sockem.set(delay_ms=0, jitter_ms=0, rate_bps=0,
                                max_write=0, rx_drop=False, tx_drop=False)

    # -- replay -----------------------------------------------------------
    def replay_key(self) -> list[tuple]:
        """The deterministic projection of the timeline: equal across
        runs with the same schedule + seed (the CHAOS.md replay
        contract); wall-clock offsets and counters are excluded."""
        out = []
        for e in self.timeline:
            res = e.get("resolved") or {}
            stable = tuple(sorted(
                (k, v) for k, v in res.items()
                if k in ("broker", "topic", "partition", "from", "to",
                         "skipped", "count", "label")
                or k in ("delay_ms", "jitter_ms", "rate_bps", "max_write",
                         "rx_drop", "tx_drop")
                # environment fault library
                or k in ("skew_ms", "rlim_bytes", "rx_delay_ms",
                         "tx_delay_ms")))
            out.append((e["idx"], e["t"], e["action"], stable))
        return out

    @property
    def errors(self) -> list[dict]:
        return [e for e in self.timeline if "error" in e]
