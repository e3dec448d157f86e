"""The port's chaos tier (librdkafka_tpu_torch/chaos) held to the JAX
package's on the same seeds and ledgers: the fault schedules resolve to
identical timelines and ``replay_key``s against both packages' mock
clusters, the delivery oracle gives identical verdicts, violation kinds
and JSON diffs (clean, each invariant tripped, at-least-once relaxed,
the group and continuity invariants), the scenario registries agree, and
the tier-1 in-process scenarios (``fast_kill_restart``,
``fast_net_flap``, ``oracle_selftest``) pass through the port.  The
out-of-process scenarios are in tests/test_torch_external.py, the fleet
in tests/test_torch_fleet.py."""
import inspect
import io
import json
import os
import time
from contextlib import redirect_stdout

import pytest

from librdkafka_tpu.chaos import oracle as jax_oracle
from librdkafka_tpu.chaos import scenarios as jax_scen
from librdkafka_tpu.chaos import schedule as jax_sched
from librdkafka_tpu.chaos.__main__ import main as jax_chaos_main
from librdkafka_tpu.mock.cluster import MockCluster as JaxMockCluster
from librdkafka_tpu_torch.chaos import oracle as port_oracle
from librdkafka_tpu_torch.chaos import scenarios as port_scen
from librdkafka_tpu_torch.chaos import schedule as port_sched
from librdkafka_tpu_torch.chaos.__main__ import main as port_chaos_main
from librdkafka_tpu_torch.mock import external as port_external
from librdkafka_tpu_torch.mock.cluster import MockCluster as PortMockCluster
from librdkafka_tpu_torch.obs import collect as port_collect
from librdkafka_tpu_torch.obs import metrics as port_metrics
from librdkafka_tpu_torch.obs import trace as port_trace

PAIRS = {"jax": (jax_sched, JaxMockCluster),
         "port": (port_sched, PortMockCluster)}


@pytest.fixture(autouse=True)
def _port_rig_clean(tmp_path):
    """Flight dumps land in this test's own directory (the port's
    ``trace.flight_dir`` restored after); afterwards no port subprocess
    is alive (reaped if one is) and the port's obs plane is released."""
    prev = port_trace.flight_dir
    port_trace.flight_dir = str(tmp_path)
    try:
        yield
    finally:
        port_trace.flight_dir = prev
        leaked = port_external.active_subprocess_pids()
        if leaked:
            port_external.reap_leaked()
    assert not leaked, f"leaked port subprocess(es): {leaked}"
    assert not port_trace.enabled and port_trace.active_ring_count() == 0
    assert not port_metrics.enabled and port_metrics.registered_count() == 0
    assert port_collect.active_dump_dir_count() == 0


# ============================================================ schedules ==
def _storm_schedule(S, seed):
    return (S.Schedule(seed=seed)
            .at(0.0, S.broker_kill("any"))
            .at(0.0, S.leader_migrate("t", "any"))
            .at(0.0, S.broker_restart())
            .at(0.0, S.broker_kill("any"))
            .at(0.0, S.leader_migrate("t", "any"))
            .at(0.0, S.broker_kill("coordinator:g1"))
            .at(0.0, S.broker_restart())
            .at(0.0, S.broker_restart()))


def _proc_schedule(S, seed):
    return (S.Schedule(seed=seed)
            .at(0, S.proc_pause("any"))
            .at(0, S.proc_kill9("any"))
            .at(0, S.proc_cont())
            .at(0, S.proc_kill9("coordinator:g-x"))
            .at(0, S.proc_restart())
            .at(0, S.proc_restart()))


def _every_schedule(S, seed):
    return S.Schedule(seed=seed).every(0, 0, 4, lambda: S.broker_kill("any"))


def _run_schedule(pkg, build, seed, brokers=4, min_alive=2):
    S, MockCluster = PAIRS[pkg]
    c = MockCluster(num_brokers=brokers, topics={"t": 8})
    try:
        chaos = S.ChaosScheduler(c, min_alive=min_alive)
        chaos.run(build(S, seed))
        assert not chaos.errors, chaos.errors
        timeline = [(e["action"], e.get("resolved"))
                    for e in chaos.timeline]
        chaos.heal()
        return chaos.replay_key(), timeline, c.alive_brokers()
    finally:
        c.stop()


@pytest.mark.parametrize("build,seed,brokers,min_alive", [
    (_storm_schedule, 1234, 4, 2),
    (_storm_schedule, 7, 4, 2),
    (_proc_schedule, 77, 4, 2),
    (_proc_schedule, 5, 4, 1),
    (_every_schedule, 1, 2, 1),
], ids=["storm-1234", "storm-7", "proc-77", "proc-5", "every-1"])
def test_same_seed_same_timeline_as_jax(build, seed, brokers, min_alive):
    """Same seed => identical fault timeline and replay_key in both
    packages, every rng-resolved 'any' target and quorum skip included."""
    port = _run_schedule("port", build, seed, brokers, min_alive)
    assert port == _run_schedule("jax", build, seed, brokers, min_alive)
    assert port[0] == _run_schedule("port", build, seed, brokers,
                                    min_alive)[0]


def test_net_without_sockem_records_error_not_crash():
    c = PortMockCluster(num_brokers=1)
    try:
        chaos = port_sched.ChaosScheduler(c)       # no sockem wired
        chaos.run(port_sched.Schedule(seed=1).at(0, port_sched.net(
            delay_ms=5)).at(0, port_sched.broker_kill(1)))
        assert len(chaos.errors) == 1
        assert "Sockem" in chaos.errors[0]["error"]
        assert c.alive_brokers() == []
        chaos.heal()
        assert c.alive_brokers() == [1]
    finally:
        c.stop()


def test_threaded_scheduler_times_steps_and_joins():
    c = PortMockCluster(num_brokers=2, topics={"t": 1})
    try:
        chaos = port_sched.ChaosScheduler(c)
        chaos.start(port_sched.Schedule(seed=7)
                    .at(0.05, port_sched.broker_kill(2))
                    .at(0.25, port_sched.broker_restart()))
        chaos.join()
        assert [e["action"] for e in chaos.timeline] == \
            ["broker_kill", "broker_restart"]
        assert chaos.timeline[1]["wall"] >= 0.2
        assert c.alive_brokers() == [1, 2]
    finally:
        c.stop()


def test_scheduler_heal_resumes_paused_in_process():
    c = PortMockCluster(num_brokers=4, topics={"t": 4})
    try:
        info = c.kill9(2)
        assert info["broker"] == 2 and 2 not in c.alive_brokers()
        c.restart_broker(2)
        chaos = port_sched.ChaosScheduler(c, min_alive=1)
        chaos.run(port_sched.Schedule(seed=5)
                  .at(0, port_sched.proc_pause("any"))
                  .at(0, port_sched.proc_kill9("any"))
                  .at(0, port_sched.proc_pause("any")))
        assert len(chaos.ctx.paused) == 2 and len(chaos.ctx.killed) == 1
        chaos.heal()
        assert not chaos.ctx.paused and not chaos.ctx.killed
        assert c.paused_brokers() == []
        assert c.alive_brokers() == [1, 2, 3, 4]
    finally:
        c.stop()


# =============================================================== oracle ==
class _Msg:
    def __init__(self, topic, part, off, val):
        self.topic, self.partition, self.offset, self.value = (
            topic, part, off, val)


def _clean(o):
    for i in range(4):
        o.record_ack("t", 0, i, None, b"v%d" % i)
        o.record_consumed(_Msg("t", 0, i, b"v%d" % i))
    return {}


def _each_invariant(o):
    o.begin_txn("tx-c")
    o.commit_txn("tx-c")
    o.begin_txn("tx-a")
    o.abort_txn("tx-a")
    o.record_ack("t", 0, 0, None, b"c0", "tx-c")
    o.record_ack("t", 0, 1, None, b"c1", "tx-c")
    o.record_consumed(_Msg("t", 0, 0, b"c0"))
    o.record_ack("t", 1, 0, None, b"a0", "tx-a")
    o.record_consumed(_Msg("t", 1, 0, b"a0"))
    o.record_ack("t", 2, 0, None, b"d0")
    o.record_ack("t", 2, 1, None, b"d1")
    o.record_consumed(_Msg("t", 2, 1, b"d1"))
    o.record_consumed(_Msg("t", 2, 0, b"d0"))
    o.record_consumed(_Msg("t", 2, 0, b"d0"))
    return {}


def _redelivery(o):
    o.record_ack("t", 0, 0, None, b"x")
    o.record_consumed(_Msg("t", 0, 0, b"x"))
    o.record_consumed(_Msg("t", 0, 0, b"x"))
    return {}


def _relaxed(o):
    _redelivery(o)
    return {"check_duplicates": False, "check_order": False}


def _unknown_txn(o):
    o.begin_txn("tx-u")
    o.unknown_txn("tx-u")
    o.record_ack("t", 0, 0, None, b"u0", "tx-u")
    o.record_ack("t", 0, 1, None, b"u1", "tx-u")
    o.record_consumed(_Msg("t", 0, 0, b"u0"))
    return {}


def _group(o, converged_s=1.2):
    o.record_assign("m0", [("t", 0), ("t", 1)])
    o.record_assign("m1", [("t", 2), ("t", 3)])
    o.record_poll("m0")
    o.record_poll("m1")
    return {"check_group": True, "group_topic": "t",
            "group_partitions": 4, "converged_s": converged_s,
            "now": time.monotonic()}


def _group_unconverged(o):
    o.record_assign("m0", [("t", 0), ("t", 1)])
    o.record_assign("m1", [("t", 1)])
    o.record_poll("m0")
    o.record_poll("m1")
    return {"check_group": True, "group_topic": "t",
            "group_partitions": 4, "converged_s": None}


def _group_stuck(o):
    kw = _group(o, 0.5)
    o.record_poll("never-assigned")
    return kw


def _group_stopped_polling(o):
    kw = _group(o, 0.5)
    o.record_assign("m2", [])
    with o._lock:
        o.members["m2"]["last_poll"] = kw["now"] - 60.0
    return kw


def _group_departed(o):
    kw = _group_stopped_polling(o)
    o.record_member_closed("m2")
    return kw


def _group_off_by_default(o):
    o.record_poll("stuck-if-checked")
    return {}


def _continuity_gap(o):
    """A kept partition with a 3 s consume gap inside a 5 s rebalance
    window, with acked traffic in the window: a flow_gap."""
    o.record_acks([("t", 0, i, None, "v%d" % i, None, 100.0 + i)
                   for i in range(5)])
    o.record_consumed_rows([("t", 0, i, "v%d" % i) for i in range(5)])
    with o._lock:
        o.flow[("t", 0)] = [100.5, 103.5, 104.0]
        o.flow[("t", 1)] = [100.5, 101.5, 102.5, 103.5]
        o.windows.append(("m0", 100.0, 105.0,
                          frozenset({("t", 0), ("t", 1)})))
    return {"check_duplicates": False, "check_order": False,
            "check_continuity": True, "flow_stall_s": 2.0}


def _merge_tampered(o):
    o.record_acks([("t", 0, i, None, "p00-%08d" % i, None, 50.0)
                   for i in range(5)])
    rows = [("t", 0, i, "p00-%08d" % i) for i in range(5)]
    rows.pop(2)
    o.record_consumed_rows(rows)
    return {"check_duplicates": False, "check_order": False}


LEDGERS = {
    "clean": (_clean, True), "each_invariant": (_each_invariant, False),
    "redelivery": (_redelivery, False), "relaxed": (_relaxed, True),
    "unknown_txn": (_unknown_txn, False), "group_clean": (_group, True),
    "group_unconverged": (_group_unconverged, False),
    "group_stuck": (_group_stuck, False),
    "group_stopped_polling": (_group_stopped_polling, False),
    "group_departed": (_group_departed, True),
    "group_off_by_default": (_group_off_by_default, True),
    "continuity_gap": (_continuity_gap, False),
    "merge_tampered": (_merge_tampered, False),
}


def _verdict(mod, build, tmp):
    """(report without its paths and clock-dependent ages, the JSON diff
    on disk or None)."""
    o = mod.DeliveryOracle(dump_dir=tmp, track_flow=True)
    kw = build(o)
    try:
        rep = o.verify(**kw)
    except mod.OracleViolation as v:
        rep = v.report
    diff = None
    if rep.get("diff_path"):
        with open(rep["diff_path"]) as f:
            diff = json.load(f)
    rep = {k: v for k, v in rep.items()
           if k not in ("diff_path", "flight_path")}
    for row in rep["violations"].get("stuck_consumer", ()):
        row.pop("stale_s", None)
    if diff is not None:
        for row in diff["violations"].get("stuck_consumer", ()):
            row.pop("stale_s", None)
    return rep, diff


@pytest.mark.parametrize("case", sorted(LEDGERS))
def test_oracle_verdict_equals_jax(case, tmp_path):
    build, ok = LEDGERS[case]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    port, port_diff = _verdict(port_oracle, build, str(tmp_path / "port"))
    jax, jax_diff = _verdict(jax_oracle, build, str(tmp_path / "jax"))
    assert port["ok"] is ok, port
    assert port == jax
    assert port_diff == jax_diff
    assert (port_diff is None) is ok


def test_oracle_violation_carries_diff_and_no_flight_when_untraced(
        tmp_path):
    o = port_oracle.DeliveryOracle(dump_dir=str(tmp_path))
    _each_invariant(o)
    with pytest.raises(port_oracle.OracleViolation) as ei:
        o.verify()
    v = ei.value.report["violations"]
    assert [r["value"] for r in v["lost"]] == ["c1"]
    assert [r["value"] for r in v["aborted_seen"]] == ["a0"]
    assert v["duplicated"] and v["reordered"]
    assert [r["txn"] for r in v["torn_txns"]] == ["tx-c"]
    assert os.path.dirname(ei.value.report["diff_path"]) == str(tmp_path)
    assert ei.value.report["flight_path"] is None


# ============================================================= registry ==
def test_scenario_registry_equals_jax():
    assert list(port_scen.SCENARIOS) == list(jax_scen.SCENARIOS)
    for name, sc in port_scen.SCENARIOS.items():
        ref = jax_scen.SCENARIOS[name]
        assert (sc.tier, sc.seed, sc.invariants, sc.desc) == \
            (ref.tier, ref.seed, ref.invariants, ref.desc), name
        assert sc.fn.__name__ == ref.fn.__name__
        params = dict(inspect.signature(sc.fn).parameters)
        if name == "hot_topic_flood":
            assert params.pop("device").default is None
        assert [(p.name, p.default) for p in params.values()] == [
            (p.name, p.default)
            for p in inspect.signature(ref.fn).parameters.values()], name


def test_cli_list_equals_jax():
    outs = []
    for main in (port_chaos_main, jax_chaos_main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["--list"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "external_kill9_eos" in outs[0] and "soak" in outs[0]


def test_cli_device_reaches_only_device_scenarios(monkeypatch):
    seen = {}

    def flood(seed=17, *, device=None):
        seen["hot_topic_flood"] = (seed, device)
        return {"ok": True}

    def kill(seed=7):
        seen["fast_kill_restart"] = (seed,)
        return {"ok": True}

    for name, fn in (("hot_topic_flood", flood),
                     ("fast_kill_restart", kill)):
        monkeypatch.setitem(port_scen.SCENARIOS, name,
                            port_scen.SCENARIOS[name]._replace(fn=fn))
    with redirect_stdout(io.StringIO()):
        assert port_chaos_main(["--scenario", "hot_topic_flood",
                                "--scenario", "fast_kill_restart",
                                "--device", "cpu", "--seed", "3"]) == 0
    assert seen == {"hot_topic_flood": (3, "cpu"),
                    "fast_kill_restart": (3,)}


# ====================================================== fast scenarios ==
@pytest.mark.chaos
class TestFastScenarios:
    def test_fast_kill_restart(self):
        t0 = time.monotonic()
        r = port_scen.fast_kill_restart()
        assert r["ok"], r["violations"]
        assert not r["errors"] and not r["schedule_errors"]
        kills = [e for e in r["timeline"] if e["action"] == "broker_kill"
                 and (e.get("resolved") or {}).get("broker")]
        assert len(kills) == 1
        assert r["acked"] > 100 and r["consumed"] == r["acked"]
        assert time.monotonic() - t0 < 10, "tier-1 scenario budget blown"
        # the same seed resolves the same fault timeline as the JAX
        # package's storm
        assert r["replay_key"] == jax_scen.fast_kill_restart()["replay_key"]

    def test_fast_net_flap(self):
        t0 = time.monotonic()
        r = port_scen.fast_net_flap()
        assert r["ok"], r["violations"]
        assert not r["errors"] and not r["schedule_errors"]
        assert r["acked"] > 100 and r["consumed"] == r["acked"]
        assert time.monotonic() - t0 < 10, "tier-1 scenario budget blown"

    def test_oracle_selftest_dumps_flight_and_diff(self, tmp_path):
        r = port_scen.oracle_selftest()
        assert not r["ok"]
        assert r["violations"]["lost"] and r["violations"]["duplicated"]
        assert r["diff_path"] and os.path.exists(r["diff_path"])
        assert r["flight_path"] and os.path.exists(r["flight_path"])
        assert os.path.dirname(r["flight_path"]) == str(tmp_path)
        with open(r["flight_path"]) as f:
            flight = json.load(f)
        names = {e.get("name") for e in flight["traceEvents"]}
        assert "oracle_violation" in names


@pytest.mark.chaos
@pytest.mark.slow
class TestStorms:
    """test_0127's slow storms, through the port."""

    def test_flagship_rolling_restart_eos(self):
        r = port_scen.rolling_restart_eos(seed=1)
        assert r["ok"], r["violations"]
        assert r["kills_fired"] >= 5
        assert r["txns"]["committed"] > 10
        assert r["txns"]["aborted"] > 0
        assert r["txns"]["unknown"] == 0
        assert not r["schedule_errors"]

    def test_flagship_replay_same_seed_same_timeline(self):
        r1 = port_scen.rolling_restart_eos(seed=99)
        r2 = port_scen.rolling_restart_eos(seed=99)
        assert r1["ok"] and r2["ok"]
        assert r1["replay_key"] == r2["replay_key"]

    def test_coordinator_death_midcommit(self):
        r = port_scen.coordinator_death_midcommit(seed=2)
        assert r["ok"], r["violations"]
        assert r["txns"]["unknown"] == 0
        assert any(e["action"] == "broker_kill"
                   and (e.get("resolved") or {}).get("broker")
                   for e in r["timeline"])

    def test_leader_migration_midbatch(self):
        r = port_scen.leader_migration_midbatch(seed=3)
        assert r["ok"], r["violations"]
        migrated = [e for e in r["timeline"]
                    if e["action"] == "leader_migrate"
                    and (e.get("resolved") or {}).get("to")]
        assert len(migrated) >= 6
        assert r["acked"] > 300

    def test_slow_network_rebalance_zero_loss(self):
        r = port_scen.slow_network_rebalance(seed=4)
        assert r["ok"], r["violations"]
        assert not r["violations"]["lost"]
        assert r["consumed"] >= r["acked"]
