"""Fleet scenario library: whole client populations — real OS
processes — under generative traffic shapes and scheduled faults
against the supervised out-of-process cluster.

A ``FleetRun`` is the fleet analog of ``chaos.scenarios.Storm``: it
owns the external rig (``ClusterHandle``), the traffic plan, the
driver, and an optional chaos schedule, and runs the same phase
discipline — traffic under fire, heal, producer flush, drain,
convergence wait, verdict freeze, per-group oracle verify — so one
report carries delivery AND robustness AND fleet metrics.

Replay contract: a fleet run's ``replay_key`` is the pair
``[plan_key, schedule_key]`` — the traffic plan digest (every worker
spec resolved from the plan seed) plus the chaos timeline's resolved
targets.  Same seed, two separately launched rigs (fresh supervisor,
fresh workers) ⇒ identical key; wall-clock pacing and message counts
are execution, not identity.

Run via ``python -m librdkafka_tpu_torch.fleet`` (``--list``) or the
pytest ``fleet`` tier (``tests/test_torch_fleet.py``).
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

from ..chaos.oracle import OracleViolation
from ..chaos.schedule import (ChaosScheduler, Schedule, env_brownout,
                              env_brownout_clear, env_eio, env_eio_clear,
                              proc_kill9, proc_restart)
from ..chaos.scenarios import storm_metrics
from ..mock.external import ClusterHandle
from ..obs import collect as _collect
from .driver import FleetDriver
from .traffic import TrafficPlan, bursts, diurnal, flat, stack, zipf


class FleetRun:
    """One fleet run: external rig + plan + driver + optional chaos.

    Phases (the Storm discipline, population-wide): start workers →
    storm → heal → stop producers (flush) → drain every group → wait
    convergence → freeze group verdicts → stop consumers → verify
    per group → aggregate metrics."""

    def __init__(self, *, seed: int, brokers: int = 3,
                 partitions: int = 4, topic: str = "fleet",
                 producers: int = 2, groups: int = 1, group_size: int = 2,
                 shape: Optional[dict] = None, keys: Optional[dict] = None,
                 hot_partition_weight: float = 0.0,
                 strategy: str = "range,roundrobin",
                 min_alive: int = 1, duration_s: float = 3.0,
                 drain_s: float = 30.0, converge_s: float = 25.0,
                 worker_max_s: float = 120.0,
                 trace_path: Optional[str] = None):
        self.seed = seed
        self.topic = topic
        self.duration_s = duration_s
        self.drain_s = drain_s
        self.converge_s = converge_s
        self.trace_path = trace_path
        self.handle = ClusterHandle(brokers=brokers,
                                    topics={topic: partitions})
        if trace_path:
            # rig-side rings on from the start: supervisor ctl spans
            # and relay connection spans belong in the merged timeline
            self.handle.trace_enable()
        self.plan = TrafficPlan(
            seed, producers=producers, groups=groups,
            group_size=group_size, topics=[topic], partitions=partitions,
            shape=shape, keys=keys,
            hot_partition_weight=hot_partition_weight,
            strategy=strategy,
            max_s=worker_max_s)
        self.driver = FleetDriver(self.handle.bootstrap_servers(),
                                  self.plan, trace=bool(trace_path))
        self.chaos = ChaosScheduler(self.handle, min_alive=min_alive)

    def run(self, schedule: Optional[Schedule] = None, *,
            tamper: Optional[Callable] = None,
            raise_on_violation: bool = True) -> dict:
        t0 = time.monotonic()
        violation: Optional[OracleViolation] = None
        try:
            self.driver.start()
            if schedule is not None and schedule.steps:
                self.chaos.start(schedule)
            if self.trace_path:
                # overlaps the traffic window: replies come from the
                # workers' own run loops, costing the fleet nothing
                self.driver.clock_sync()
            time.sleep(self.duration_s)
            if schedule is not None and schedule.steps:
                self.chaos.join(timeout=schedule.duration + 30)
            self.chaos.heal()
            # producers first: their stop flushes every in-flight
            # batch and streams the final ack ledger rows
            self.driver.stop_role("producer")
            self.driver.drain(self.drain_s)
            converged_s = self.driver.wait_converged(self.converge_s)
            snapshots = self.driver.freeze_group_verdicts()
            self.driver.stop_role("consumer")

            if tamper is not None:
                tamper(self.driver.oracles)
            reports = []
            try:
                reports = self.driver.verify(
                    converged_s=converged_s, snapshots=snapshots,
                    raise_on_violation=raise_on_violation)
            except OracleViolation as v:
                violation = v
                reports = [v.report]

            o0 = self.driver.oracles[0]
            with o0._lock:
                acked_ts = list(o0.acked_ts)
            metrics = self.driver.metrics()
            report = {
                "ok": (violation is None
                       and all(r["ok"] for r in reports)),
                "seed": self.seed,
                "workers": self.plan.workers,
                "acked": reports[0]["acked"] if reports else len(acked_ts),
                "consumed_by_group": [
                    len(o.consumed) for o in self.driver.oracles],
                "group_reports": [
                    {"ok": r["ok"], "group": r.get("group"),
                     "violations": {k: len(v) for k, v
                                    in r["violations"].items() if v}}
                    for r in reports],
                "converged_s": converged_s,
                "wall_s": round(time.monotonic() - t0, 2),
                "fleet_metrics": metrics,
                "timeline": self.chaos.timeline,
                "replay_key": [self.plan.replay_key(),
                               self.chaos.replay_key()],
                "schedule_errors": self.chaos.errors,
                "errors": list(self.driver.errors),
                "proc_events": list(self.handle.proc_events),
            }
            sm = storm_metrics(self.chaos.timeline, acked_ts)
            if sm is not None:
                report["storm_metrics"] = sm
            report["kills_fired"] = sum(
                1 for e in self.chaos.timeline
                if e["action"] == "proc_kill9"
                and (e.get("resolved") or {}).get("broker"))
            if self.trace_path:
                # every worker shipped its ring dump on exit; the rig
                # contributes supervisor + relay dumps over the control
                # socket — ONE Perfetto file, flow links stitched
                dumps = self.driver.collect_traces()
                dumps.extend(self.handle.collect_traces())
                events = _collect.merge(dumps)
                events, links = _collect.stitch_flows(events)
                _collect.write(self.trace_path, events)
                report["trace"] = {
                    "path": self.trace_path,
                    "processes": len(dumps),
                    "pids": sorted({d.pid for d in dumps}),
                    "flow_links": links,
                }
                # the chaos-evidence satellite: flight dumps ride the
                # verdict (inline — their temp dir dies with stop())
                report["flight_dumps"] = self.driver.flight_dumps()
                if violation is not None:
                    violation.report["flight_dumps"] = \
                        report["flight_dumps"]
                    violation.report["trace"] = report["trace"]
            if violation is not None:
                raise violation
            return report
        finally:
            self.driver.stop()
            self.chaos.stop()
            self.handle.stop()


# ------------------------------------------------------------ library --
def fleet_mini(seed: int = 47, *, raise_on_violation: bool = True,
               trace_path: Optional[str] = None) -> dict:
    """Smallest real fleet (bench --fleet --smoke): 1 producer + 1
    single-member group — two client OS processes — no faults, merged
    oracle clean.  Proves the spawn/stream/merge machinery in seconds."""
    run = FleetRun(seed=seed, brokers=1, partitions=2,
                   producers=1, groups=1, group_size=1,
                   shape=flat(150.0), duration_s=1.5,
                   drain_s=15.0, converge_s=15.0,
                   trace_path=trace_path)
    return run.run(None, raise_on_violation=raise_on_violation)


def fleet_smoke(seed: int = 51, *, raise_on_violation: bool = True,
                trace_path: Optional[str] = None) -> dict:
    """Tier-1 fleet smoke (<15 s): 4 worker processes (2 producers
    with burst + hot-partition + Zipf-key traffic, one 2-member
    group) sustaining one pid-verified SIGKILL/respawn; per-group
    merged-oracle verify (zero acked loss, coverage exact)."""
    run = FleetRun(seed=seed, brokers=2, partitions=4,
                   producers=2, groups=1, group_size=2,
                   shape=stack(flat(60.0), bursts(0.0, 90.0, 1.2, 0.33)),
                   keys=zipf(50, 1.1), hot_partition_weight=0.5,
                   min_alive=1, duration_s=2.5,
                   drain_s=25.0, converge_s=20.0,
                   trace_path=trace_path)
    sched = (Schedule(seed=seed)
             .at(0.9, proc_kill9("any"))
             .at(1.7, proc_restart()))
    report = run.run(sched, raise_on_violation=raise_on_violation)
    report["pids_killed"] = [e for e in report["proc_events"]
                            if e["verb"] == "kill9"]
    return report


def fleet_storm(seed: int = 61, *, producers: int = 16,
                groups: int = 2, group_size: int = 4,
                strategy: str = "cooperative-sticky",
                raise_on_violation: bool = True) -> dict:
    """FLAGSHIP: ≥24 real client OS processes — 16
    producers under a diurnal+burst traffic shape with Zipf hot keys
    and hot-partition skew, plus 2 consumer groups × 4 members
    (fan-out: every group must deliver the whole acked set) — against
    the 3-broker supervised cluster, sustaining 3 pid-verified
    SIGKILL/respawn cycles, one asymmetric rx-drop brownout, and one
    disk-full/EIO window.  Per-group merged-oracle verify: zero acked
    loss, exact final coverage, convergence, nobody stuck.  The
    consumer groups run the KIP-429 cooperative protocol
    (``strategy`` knob; pass ``"range"`` for the eager baseline)."""
    run = FleetRun(seed=seed, brokers=3, partitions=8,
                   producers=producers, groups=groups,
                   group_size=group_size,
                   shape=stack(diurnal(8.0, 30.0, 6.0),
                               bursts(0.0, 25.0, 2.0, 0.3)),
                   keys=zipf(200, 1.2), hot_partition_weight=0.6,
                   strategy=strategy,
                   min_alive=2, duration_s=9.5,
                   drain_s=45.0, converge_s=30.0,
                   worker_max_s=180.0)
    sched = (Schedule(seed=seed)
             .at(1.5, proc_kill9("any"))
             .at(2.6, proc_restart())
             .at(3.2, env_brownout("any", rx_drop=True))
             .at(4.4, env_brownout_clear())
             .at(4.8, proc_kill9("any"))
             .at(5.9, proc_restart())
             .at(6.3, env_eio("any"))
             .at(7.3, env_eio_clear())
             .at(7.6, proc_kill9("any"))
             .at(8.4, proc_restart()))
    report = run.run(sched, raise_on_violation=raise_on_violation)
    report["pids_killed"] = [e for e in report["proc_events"]
                            if e["verb"] == "kill9"]
    report["brownouts"] = [e for e in report["proc_events"]
                           if e["verb"] == "brownout"]
    report["eio_windows"] = [e for e in report["proc_events"]
                             if e["verb"] == "eio"]
    return report


class FleetScenario(NamedTuple):
    fn: Callable
    desc: str
    tier: str          # "fast" (tier-1) | "slow"
    seed: int
    invariants: str


SCENARIOS: dict[str, FleetScenario] = {
    "fleet_mini": FleetScenario(
        fleet_mini,
        "2-worker minimum fleet (1 producer + 1 consumer), no faults "
        "— the bench --fleet --smoke leg", "fast", 47, "loss,group"),
    "fleet_smoke": FleetScenario(
        fleet_smoke,
        "tier-1 smoke: 4 worker processes, burst+hot-partition "
        "traffic, one pid-verified SIGKILL, <15s", "fast", 51,
        "loss,group"),
    "fleet_storm": FleetScenario(
        fleet_storm,
        "FLAGSHIP: ≥24 worker processes, diurnal+burst traffic with "
        "hot-key/hot-partition skew, 3 SIGKILLs + brownout + EIO "
        "window, per-group verify", "slow", 61, "loss,group"),
}
