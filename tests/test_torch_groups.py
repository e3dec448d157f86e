"""Mirrors of test_0132_cooperative (KIP-429: the cooperative-sticky
assignor, Subscription v1, the client's two-phase incremental flow, static
members under cooperative, the mock's generation and ownership checks,
the oracle's continuity invariant, the lite member fleet and the fast
scenarios; every class but TestFlagship) and test_0102_static_membership
on the port.

The assignor, subscription and oracle cases compare the port's result
with the JAX package's on the same input.  The client cases consume
through the codec, so the port's clients run ``compression.backend=gpu,
gpu.device=cpu`` and each scenario runs on both packages at once
(``test_torch_txn.both``), the port's result equal to the reference's.
The lite member fleet and the two scenarios run on the port alone, with
the reference test's assertions: their members consume uncompressed
records through the CPU provider (as the reference's do), and their
timings are not comparable between two runs.
"""
import json
import os
import time

import pytest

from librdkafka_tpu.chaos import oracle as ref_oracle
from librdkafka_tpu.client import assignor as ref_assignor
from librdkafka_tpu_torch import Producer
from librdkafka_tpu_torch.chaos import oracle as port_oracle
from librdkafka_tpu_torch.chaos.members import LiteMemberFleet
from librdkafka_tpu_torch.client import assignor as port_assignor
from librdkafka_tpu_torch.mock.cluster import MockCluster
from librdkafka_tpu_torch.mock import external as port_external
from librdkafka_tpu_torch.obs import trace as port_trace

from test_torch_txn import both


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path):
    """The port's flight and diff dumps land in this test's directory;
    no port subprocess outlives it."""
    prev = port_trace.flight_dir
    port_trace.flight_dir = str(tmp_path)
    try:
        yield
    finally:
        port_trace.flight_dir = prev
    assert not port_external.active_subprocess_pids()
    assert not port_trace.enabled and port_trace.active_ring_count() == 0


# ================================================== the assignor ==

ASSIGNOR_CASES = {
    "fresh_group": ({"a": ["t"], "b": ["t"]}, {"t": 4}, None),
    "sticky_keeps_owned": ({"a": ["t"], "b": ["t"]}, {"t": 4},
                           {"a": {"t": [0, 1]}, "b": {"t": [2, 3]}}),
    "revoking_generation": ({"a": ["t"], "b": ["t"]}, {"t": 4},
                            {"a": {"t": [0, 1, 2, 3]}}),
    "conflicting_claims": ({"a": ["t"], "b": ["t"]}, {"t": 4},
                           {"a": {"t": [0, 1]}, "b": {"t": [1, 2]}}),
    "unsubscribed_claim": ({"a": ["t"], "b": ["t"]}, {"t": 2},
                           {"a": {"gone": [0]}}),
}


def _parts(out, m):
    return set(out[m].get("t", []))


@pytest.mark.parametrize("case", list(ASSIGNOR_CASES))
def test_cooperative_sticky_assignor_equals_reference(case):
    members, parts, owned = ASSIGNOR_CASES[case]
    port = port_assignor.cooperative_sticky_assignor(members, parts, owned)
    assert port == ref_assignor.cooperative_sticky_assignor(
        members, parts, owned)
    a, b = _parts(port, "a"), _parts(port, "b")
    if case == "fresh_group":
        assert sorted(a | b) == [0, 1, 2, 3] and abs(len(a) - len(b)) <= 1
    elif case == "sticky_keeps_owned":
        assert (a, b) == ({0, 1}, {2, 3})
    elif case == "revoking_generation":
        # the stripped partitions go to nobody this generation; the next
        # generation hands them to b and a keeps what it kept
        assert a < {0, 1, 2, 3} and len(a) == 2 and not b
        nxt = port_assignor.cooperative_sticky_assignor(
            members, parts, {"a": {"t": sorted(a)}})
        assert nxt == ref_assignor.cooperative_sticky_assignor(
            members, parts, {"a": {"t": sorted(a)}})
        assert _parts(nxt, "a") == a and _parts(nxt, "b") == {0, 1, 2, 3} - a
    elif case == "conflicting_claims":
        assert 1 not in a and 1 not in b
    else:
        assert sorted(a | b) == [0, 1] and not port["a"].get("gone")


def test_assignor_protocol_registry_equals_reference():
    assert port_assignor.ASSIGNOR_PROTOCOLS == ref_assignor.ASSIGNOR_PROTOCOLS
    assert port_assignor.ASSIGNOR_PROTOCOLS["cooperative-sticky"] == \
        "COOPERATIVE"


@pytest.mark.parametrize("topics,owned,want", [
    (["t1", "t2"], {"t1": [2, 0], "t2": []},
     {"version": 1, "topics": ["t1", "t2"],
      "owned_partitions": {"t1": [0, 2]}}),
    (["t"], None, {"version": 0, "topics": ["t"], "owned_partitions": {}})])
def test_subscription_v1_equals_reference(topics, owned, want):
    kw = {} if owned is None else {"owned": owned}
    blob = port_assignor.subscription_encode(topics, **kw)
    assert blob == ref_assignor.subscription_encode(topics, **kw)
    d = port_assignor.subscription_decode(blob)
    assert d == ref_assignor.subscription_decode(blob)
    assert {k: d[k] for k in want} == want


# ================================================ the client flow ==

def _consume_n(c, n, timeout=20):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        m = c.poll(0.2)
        if m is not None and m.error is None:
            got.append(m.value)
    return got


def _wait(cond, timeout=15, tick=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if tick is not None:
            tick()
        if cond():
            return True
        time.sleep(0.05)
    return False


def _keys(c):
    return {(tp.topic, tp.partition) for tp in c.assignment()}


def _coop(pkg, cluster, i, **extra):
    return pkg.Consumer(pkg.conf({
        "bootstrap.servers": cluster.bootstrap_servers(),
        "group.id": "coop-g", "client.id": f"c{i}",
        "partition.assignment.strategy": "cooperative-sticky",
        "auto.offset.reset": "earliest", "heartbeat.interval.ms": 300,
        "session.timeout.ms": 6000, **extra}))


def test_incremental_two_phase_keeps_survivors_fetching():
    """A second member joins: the first keeps half its partitions with
    their fetchers never restarted (toppar version unchanged), revokes
    the other half incrementally, and the mock sees no same-generation
    move."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"ct": 4})
        try:
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "linger.ms": 2}))
            for i in range(40):
                p.produce("ct", value=b"m%d" % i, partition=i % 4)
            assert p.flush(10) == 0
            p.close()
            c1 = _coop(pkg, cluster, 1)
            c1.subscribe(["ct"])
            got = sorted(_consume_n(c1, 40))
            out = [got, c1.rebalance_protocol(), len(c1.assignment())]
            vers = {k: c1._rk.get_toppar(*k).version for k in _keys(c1)}
            c2 = _coop(pkg, cluster, 2)
            c2.subscribe(["ct"])
            ok = _wait(lambda: len(c1.assignment()) == 2
                       and len(c2.assignment()) == 2,
                       tick=lambda: (c1.poll(0.05), c2.poll(0.05)))
            s1, s2 = _keys(c1), _keys(c2)
            with c1._rk.cgrp._lock:
                revokes = c1._rk.cgrp.incremental_revoke_cnt
            g = cluster.groups["coop-g"]
            out += [ok, not (s1 & s2) and len(s1 | s2) == 4,
                    all(c1._rk.get_toppar(*k).version == vers[k]
                        for k in s1), revokes >= 1, g.validation_errors,
                    g.protocol]
            c1.close()
            c2.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [sorted(b"m%d" % i for i in range(40)),
                           "COOPERATIVE", 4, True, True, True, True, [],
                           "cooperative-sticky"]


def test_incremental_assign_unassign_api():
    """incremental_assign/unassign compose the assignment without
    disturbing an unrelated partition's fetcher."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"ia": 4})
        try:
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "ia-g", "auto.offset.reset": "earliest"}))
            TP = pkg.TopicPartition
            c.incremental_assign([TP("ia", 0), TP("ia", 1)])
            out = [len(c.assignment())]
            tp0 = c._rk.get_toppar("ia", 0)
            _wait(lambda: tp0.fetch_state.name in ("ACTIVE", "OFFSET_QUERY"))
            v0 = tp0.version
            c.incremental_assign([TP("ia", 2)])
            out.append(len(c.assignment()))
            c.incremental_unassign([TP("ia", 1)])
            out += [sorted(_keys(c)), tp0.version == v0]
            c.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [2, 3, [("ia", 0), ("ia", 2)], True]


def test_mixed_protocol_downgrades_to_eager():
    """A cooperative+range member and a range-only member settle on the
    common EAGER assignor."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"mx": 2})
        try:
            c1 = _coop(pkg, cluster, 1, **{
                "partition.assignment.strategy": "cooperative-sticky,range"})
            c1.subscribe(["mx"])
            _wait(lambda: c1._rk.cgrp.join_state == "steady",
                  tick=lambda: c1.poll(0.05))
            out = [c1.rebalance_protocol()]
            c2 = _coop(pkg, cluster, 2, **{
                "partition.assignment.strategy": "range"})
            c2.subscribe(["mx"])
            out.append(_wait(lambda: c1.rebalance_protocol() == "EAGER"
                             and c2._rk.cgrp.join_state == "steady",
                             tick=lambda: (c1.poll(0.05), c2.poll(0.05))))
            out.append(cluster.groups["coop-g"].protocol)
            c1.close()
            c2.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == ["COOPERATIVE", True, "range"]


# ============================================= static members ==

def test_static_restart_reclaims_exact_assignment_zero_revokes():
    """A group.instance.id member restarting inside session.timeout.ms
    reclaims its exact assignment at the same generation; the other
    member sees no revoke and no fetcher bounce."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"sm": 4})
        try:
            conf = pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "gstat",
                "partition.assignment.strategy": "cooperative-sticky",
                "auto.offset.reset": "earliest",
                "heartbeat.interval.ms": 300, "session.timeout.ms": 30000})
            other = pkg.Consumer(dict(conf, **{"group.instance.id": "n-2",
                                               "client.id": "other"}))
            other.subscribe(["sm"])
            stat = pkg.Consumer(dict(conf, **{"group.instance.id": "n-1",
                                              "client.id": "stat"}))
            stat.subscribe(["sm"])
            out = [_wait(lambda: len(other.assignment()) == 2
                         and len(stat.assignment()) == 2,
                         tick=lambda: (other.poll(0.05), stat.poll(0.05)))]
            prior = sorted(_keys(stat))
            g = cluster.groups["gstat"]
            gen = g.generation
            reb = other._rk.cgrp.rebalance_cnt
            with other._rk.cgrp._lock:
                rev = other._rk.cgrp.incremental_revoke_cnt
            vers = {k: other._rk.get_toppar(*k).version
                    for k in _keys(other)}
            mid = stat._rk.cgrp.member_id
            stat.close()
            stat2 = pkg.Consumer(dict(conf, **{"group.instance.id": "n-1",
                                               "client.id": "stat"}))
            stat2.subscribe(["sm"])
            out.append(_wait(lambda: sorted(_keys(stat2)) == prior,
                             tick=lambda: (other.poll(0.05),
                                           stat2.poll(0.05))))
            deadline = time.monotonic() + 1.0
            while time.monotonic() < deadline:
                other.poll(0.05)
            with other._rk.cgrp._lock:
                rev2 = other._rk.cgrp.incremental_revoke_cnt
            out += [stat2._rk.cgrp.member_id == mid, g.generation == gen,
                    other._rk.cgrp.rebalance_cnt == reb, rev2 == rev,
                    all(other._rk.get_toppar(*k).version == v
                        for k, v in vers.items()), g.validation_errors]
            stat2.close()
            other.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [True] * 7 + [[]]


def test_static_member_keeps_member_id_across_restart():
    """test_0102: a static member's restart keeps its member_id and the
    group keeps one member."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"sm": 2})
        try:
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "linger.ms": 2}))
            for i in range(10):
                p.produce("sm", value=b"s%d" % i, partition=i % 2)
            assert p.flush(10.0) == 0
            p.close()
            conf = pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "gstat", "group.instance.id": "node-1",
                "auto.offset.reset": "earliest",
                "session.timeout.ms": 30000})
            c1 = pkg.Consumer(dict(conf))
            c1.subscribe(["sm"])
            got = sorted(_consume_n(c1, 10))
            mid1 = c1._rk.cgrp.member_id
            c1.close()
            c2 = pkg.Consumer(dict(conf))
            c2.subscribe(["sm"])
            _wait(lambda: c2._rk.cgrp.join_state == "steady",
                  tick=lambda: c2.poll(0.2))
            out = [got, "static-node-1" in mid1,
                   c2._rk.cgrp.member_id == mid1,
                   len(cluster.groups["gstat"].members)]
            c2.close()
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref == [sorted(b"s%d" % i for i in range(10)), True,
                           True, 1]


# ============================================ the mock's checks ==

def test_offset_commit_generation_fencing():
    """A stale generation's or an unknown member's commit is refused;
    a simple consumer's (generation -1) passes."""
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"oc": 1})
        try:
            g = cluster._group("ocg")
            with cluster._lock:
                g.generation = 5
                g.members["alive"] = pkg.GroupMember(
                    member_id="alive", client_id="x", client_host="h")
            codes = []
            for gen, member in ((5, "alive"), (4, "alive"), (5, "ghost"),
                                (-1, "")):
                r = cluster._h_OffsetCommit(None, 0, {}, {
                    "group_id": "ocg", "generation_id": gen,
                    "member_id": member, "topics": [{
                        "topic": "oc", "partitions": [{
                            "partition": 0, "offset": 7,
                            "metadata": None}]}]}, None)
                codes.append(r["topics"][0]["partitions"][0]["error_code"])
            return codes + [g.offsets[("oc", 0)][0]]
        finally:
            cluster.stop()
    port, ref = both(scenario)
    from librdkafka_tpu_torch.client.errors import Err
    assert port == ref == [0, Err.ILLEGAL_GENERATION.wire,
                           Err.UNKNOWN_MEMBER_ID.wire, 0, 7]


def test_ownership_validator_flags_same_generation_move():
    """The mock records a cooperative move with no revoke generation in
    between, and a double owner."""
    def scenario(pkg):
        from importlib import import_module
        enc = import_module(("librdkafka_tpu_torch" if pkg.port
                             else "librdkafka_tpu")
                            + ".client.assignor").assignment_encode
        cluster = pkg.MockCluster(num_brokers=1)
        try:
            g = pkg.MockGroup(group_id="vg", protocol="cooperative-sticky")
            g.members["a"] = pkg.GroupMember("a", "x", "h")
            g.members["b"] = pkg.GroupMember("b", "x", "h")
            kinds = []
            for gen, a, b in ((1, [0, 1], [2]), (2, [1], [0, 2]),
                              (3, [1, 2], [0, 2])):
                g.generation = gen
                g.members["a"].assignment = enc({"t": a})
                g.members["b"].assignment = enc({"t": b})
                with cluster._lock:
                    cluster._validate_group_assignment(g)
                kinds.append(sorted({e["kind"] for e in g.validation_errors}))
            return kinds
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref
    assert port[0] == [] and "moved_without_revoke" in port[1]
    assert "double_owner" in port[2]


# ============================================ oracle continuity ==

def _seed(o, t0, n=60, step=0.1):
    for i in range(n):
        ts = t0 + i * step
        o.record_ack("t", 0, i, None, b"0-%d" % i, ts=ts)
        o.record_consumed_rows([("t", 0, i, b"0-%d" % i, ts)])


def _continuity(mod, case):
    o = mod.DeliveryOracle(track_flow=True)
    t0 = time.monotonic() - 10
    if case != "quiet":
        _seed(o, t0)
    with o._lock:
        o.windows.append(("m", t0 + 1, t0 + 5, frozenset({("t", 0)})))
        if case == "gap":
            o.flow[("t", 0)] = [t0 + 1.0, t0 + 4.9]     # a 3.9 s hole
    r = o.verify(check_duplicates=False, check_order=False,
                 check_continuity=True, flow_stall_s=2.0,
                 raise_on_violation=False)
    return [r["ok"], r["continuity"]["windows"],
            sorted(k for k, v in r.get("violations", {}).items() if v),
            [v["partition"] for v in r.get("violations", {})
             .get("flow_gap", [])], bool(r.get("diff_path"))
            and os.path.exists(r["diff_path"])]


@pytest.mark.parametrize("case,want", [
    ("clean", [True, 1, [], [], False]),
    ("gap", [False, 1, ["flow_gap"], [0], True]),
    # a quiet partition (no acks in the window) owes nothing
    ("quiet", [True, 1, [], [], False])])
def test_continuity_verdict_equals_reference(case, want):
    port = _continuity(port_oracle, case)
    assert port == _continuity(ref_oracle, case) == want


def _lifecycle(mod):
    o = mod.DeliveryOracle(track_flow=True)
    o.record_assign("m", [("t", 0), ("t", 1)])
    o.record_rebalance_begin("m")
    out = ["m" in o._open_windows]
    o.record_revoke("m", [("t", 1)])
    out.append(sorted(o._open_windows["m"][1]))
    o.record_assign("m", [("t", 1)], incremental=True)
    out += ["m" not in o._open_windows, sorted(o.windows[-1][3])]
    o.record_rebalance_begin("m")
    o.record_revoke("m")
    return out + ["m" not in o._open_windows]


def test_window_lifecycle_equals_reference():
    """rebalance_begin opens a window, an incremental revoke narrows it,
    an assign closes it; an eager full revoke discards it."""
    assert _lifecycle(port_oracle) == _lifecycle(ref_oracle) == [
        True, [("t", 0)], True, [("t", 0)], True]


def _converge(mod):
    o = mod.DeliveryOracle()
    o.record_assign("m", [("t", 0)])
    o.record_poll("m")
    r = o.verify(check_duplicates=False, check_order=False,
                 check_group=True, group_topic="t", group_partitions=1,
                 converged_s=9.0, converge_bound_s=5.0,
                 raise_on_violation=False)
    return [r["ok"], [x["reason"] for x in r["violations"]["unconverged"]]]


def test_converge_bound_violation_equals_reference():
    assert _converge(port_oracle) == _converge(ref_oracle) == [
        False, ["convergence_exceeded_bound"]]


# ======================================= the port's churn harness ==

@pytest.mark.chaos
def test_lite_fleet_cooperative_churn_converges_with_continuity():
    """12 stable + 4 churning members converge to exact coverage with no
    flow gap; the coverage ledger and rebalance intervals fill."""
    cluster = MockCluster(num_brokers=2, topics={"lm": 8},
                          group_initial_rebalance_delay_ms=300)
    oracle = port_oracle.DeliveryOracle(track_flow=True)
    fleet = LiteMemberFleet(
        cluster.bootstrap_servers(), group_id="lg", topic="lm",
        partitions=8, members=12, oracle=oracle, seed=5,
        strategy="cooperative-sticky", threads=4, churn_members=4,
        churn_start_s=1.0, churn_period_s=0.3, churn_lifetime_s=1.5)
    try:
        p = Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "linger.ms": 2, "compression.codec": "none"})
        fleet.start()
        deadline = time.monotonic() + 30
        seq, conv = 0, False
        while time.monotonic() < deadline:
            p.produce("lm", b"v%08d" % seq, partition=seq % 8,
                      on_delivery=oracle.dr())
            seq += 1
            p.poll(0)
            time.sleep(0.002)
            if seq % 100 == 0:
                if oracle.group_coverage("lm", 8)["converged"] and \
                        fleet.live_member_count() == 12:
                    conv = True
                    break
        assert conv, oracle.group_coverage("lm", 8)
        p.flush(10)
        p.close()
        dl = time.monotonic() + 20
        while oracle.missing_count() > 0 and time.monotonic() < dl:
            time.sleep(0.2)
        cov, now = oracle.group_coverage("lm", 8), time.monotonic()
        fleet.stop()
        r = oracle.verify(check_duplicates=False, check_order=False,
                          check_group=True, group_topic="lm",
                          group_partitions=8, converged_s=1.0,
                          check_continuity=True, flow_stall_s=3.0,
                          coverage=cov, now=now)
        assert r["ok"]
        assert not list(fleet.errors)
        assert cluster.groups["lg"].validation_errors == []
        assert fleet.partition_unavailability(now)["total_s"] >= 0
        assert fleet.rebalancing_intervals(now)
    finally:
        fleet.stop()
        cluster.stop()


@pytest.mark.chaos
def test_lite_fleet_eager_strategy_stops_the_world():
    """The eager baseline on the same harness accrues coverage gaps."""
    cluster = MockCluster(num_brokers=1, topics={"eg": 8},
                          group_initial_rebalance_delay_ms=300)
    oracle = port_oracle.DeliveryOracle(track_flow=True)
    fleet = LiteMemberFleet(
        cluster.bootstrap_servers(), group_id="eg-g", topic="eg",
        partitions=8, members=6, oracle=oracle, seed=7, strategy="range",
        threads=2, churn_members=2, churn_start_s=1.0, churn_period_s=0.3,
        churn_lifetime_s=1.2)
    try:
        fleet.start()
        deadline = time.monotonic() + 25
        while time.monotonic() < deadline:
            if oracle.group_coverage("eg", 8)["converged"] and all(
                    m.state in ("stable", "done") for m in fleet._members):
                break
            time.sleep(0.2)
        unavail = fleet.partition_unavailability()
        fleet.stop()
        assert not list(fleet.errors)
        assert unavail["total_s"] > 0.2, unavail
    finally:
        fleet.stop()
        cluster.stop()


@pytest.mark.chaos
def test_fast_cooperative_churn():
    from librdkafka_tpu_torch.chaos.scenarios import fast_cooperative_churn
    t0 = time.monotonic()
    r = fast_cooperative_churn()
    assert r["ok"], r["violations"]
    assert not r["errors"] and not r["schedule_errors"]
    assert r["continuity"]["flow_gaps"] == 0
    assert r["converged_s"] is not None
    assert time.monotonic() - t0 < 16, "tier-1 scenario budget"


@pytest.mark.chaos
def test_oracle_continuity_selftest():
    from librdkafka_tpu_torch.chaos.scenarios import (
        oracle_continuity_selftest)
    r = oracle_continuity_selftest()
    assert not r["ok"] and r["violations"]["flow_gap"]
    assert r["diff_path"] and os.path.exists(r["diff_path"])
    assert r["flight_path"] and os.path.exists(r["flight_path"])
    with open(r["flight_path"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "oracle_violation" in names
