"""The port's fleet tier (librdkafka_tpu_torch/fleet) held to the JAX
package's: identical traffic plans (specs, plan JSON, replay keys),
samplers, partition pickers and pacer decisions on the same seeds,
identical environment-verb timelines, the same scenario registry and
CLI listing; the port's worker hand-shakes before it imports anything
of the package; and ``fleet_mini`` / ``fleet_smoke`` run four port
worker processes (checked by their command lines) against the port's
supervised cluster with a pid-verified SIGKILL and clean merged
oracles.  Test 0131's cases, held to the port."""
import io
import json
import os
import random
import selectors
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

from librdkafka_tpu.chaos import schedule as jax_sched
from librdkafka_tpu.fleet import scenarios as jax_fscen
from librdkafka_tpu.fleet import traffic as jax_traffic
from librdkafka_tpu.fleet.__main__ import main as jax_fleet_main
from librdkafka_tpu_torch.chaos import schedule as port_sched
from librdkafka_tpu_torch.chaos.oracle import DeliveryOracle, OracleViolation
from librdkafka_tpu_torch.fleet import scenarios as port_fscen
from librdkafka_tpu_torch.fleet import traffic as port_traffic
from librdkafka_tpu_torch.fleet.__main__ import main as port_fleet_main
from librdkafka_tpu_torch.mock import external as port_external
from librdkafka_tpu_torch.obs import collect as port_collect
from librdkafka_tpu_torch.obs import metrics as port_metrics
from librdkafka_tpu_torch.obs import trace as port_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "librdkafka_tpu_torch")
WORKER = os.path.join(PORT_DIR, "fleet", "_worker.py")
TRAFFIC = {"jax": jax_traffic, "port": port_traffic}


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


@pytest.fixture
def cmdlines(monkeypatch):
    """pid -> (role, argv) of every child the port's registry takes in,
    read from /proc when it is registered (a child that has only just
    exec'd can read empty for a moment)."""
    seen = {}
    register = port_external._register

    def _recording(pids):
        register(pids)
        for pid, what in pids.items():
            deadline = time.monotonic() + 5.0
            argv = []
            while not argv and time.monotonic() < deadline:
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        argv = [a.decode() for a in f.read().split(b"\0")
                                if a]
                except OSError:
                    break
                if not argv:
                    time.sleep(0.01)
            if argv:
                seen[pid] = (what, argv)

    monkeypatch.setattr(port_external, "_register", _recording)
    return seen


# ======================================================= traffic shapes ==
def _shapes(T):
    return [T.flat(42), T.diurnal(10, 30, 6.0), T.bursts(5, 50, 2.0, 0.25),
            T.stack(T.flat(10), T.bursts(0, 20, 2.0, 0.25)),
            T.stack(T.diurnal(8, 30, 6.0), T.bursts(0, 25, 2.0, 0.3))]


def test_rate_at_equals_jax():
    times = [i * 0.137 for i in range(120)]
    got = {k: [[T.rate_at(s, t) for t in times] for s in _shapes(T)]
           for k, T in TRAFFIC.items()}
    assert got["port"] == got["jax"]
    assert [T.rate_at(T.flat(42), 999) for T in TRAFFIC.values()] == [42, 42]
    with pytest.raises(ValueError):
        port_traffic.rate_at({"kind": "nope"}, 0)


@pytest.mark.parametrize("seed", [7, 11, 12345])
def test_samplers_and_pickers_equal_jax(seed):
    def draws(T):
        zs = T.ZipfSampler(T.zipf(20, 1.3), random.Random(seed))
        hot = T.PartitionPicker(8, T.hot_partitions(8, 3, 0.7),
                                random.Random(seed))
        uni = T.PartitionPicker(4, None, random.Random(seed))
        return ([zs.rank() for _ in range(500)],
                [hot.pick() for _ in range(500)],
                [uni.pick() for _ in range(200)])
    port = draws(port_traffic)
    assert port == draws(jax_traffic)
    ranks, hot, uni = port
    assert ranks.count(0) > ranks.count(10) and all(
        0 <= r < 20 for r in ranks)
    assert set(hot) <= set(range(8)) and set(uni) == set(range(4))


@pytest.mark.parametrize("rate", [100.0, 1000.0, 7.5])
def test_pacer_decisions_equal_jax(rate):
    def takes(T):
        p = T.Pacer(T.stack(T.flat(rate), T.bursts(0, rate, 2.0, 0.3)))
        ts = [0.0] + [i * 0.05 for i in range(1, 40)] + [60.0, 60.01]
        return [p.take(t) for t in ts]
    port = takes(port_traffic)
    assert port == takes(jax_traffic)
    assert port[0] == 0 and port[-2] <= port_traffic.Pacer.BURST_CAP


@pytest.mark.parametrize("seed", [5, 6, 51, 61])
def test_plan_equals_jax(seed):
    def mk(T):
        return T.TrafficPlan(seed, producers=3, groups=2, group_size=2,
                             partitions=8,
                             shape=T.stack(T.diurnal(8, 30, 6.0),
                                           T.bursts(0, 25, 2.0, 0.3)),
                             keys=T.zipf(100, 1.2),
                             hot_partition_weight=0.6)
    port, jax = mk(port_traffic), mk(jax_traffic)
    assert port.specs == jax.specs
    assert json.dumps(port.specs) == json.dumps(jax.specs)
    assert port.replay_key() == jax.replay_key()
    assert (port.workers, port.n_groups) == (7, 2)
    assert json.loads(json.dumps(port.specs)) == port.specs


# ================================================ env fault verbs (unit) ==
class _StubCluster:
    """Target-resolution surface + fault-call recorder (the external
    rig's shape, no processes)."""

    def __init__(self, n=4):
        self.n = n
        self.controller_id = 1
        self.calls = []

    def alive_brokers(self):
        return list(range(1, self.n + 1))

    def coordinator_for(self, key):
        return 2

    def partition(self, topic, part):
        class _P:
            leader = 3
        return _P()

    def set_storage_error(self, b, on=True):
        self.calls.append(("eio", b, on))

    def set_clock_skew(self, b, ms=0.0):
        self.calls.append(("skew", b, ms))

    def set_rlimit(self, b, nbytes):
        self.calls.append(("rlimit", b, nbytes))

    def brownout(self, b, **knobs):
        self.calls.append(("brownout", b, knobs))

    def clear_brownout(self, b):
        self.calls.append(("brownout_clear", b))


def _env_run(S, seed, n=4, min_alive=1):
    c = _StubCluster(n)
    chaos = S.ChaosScheduler(c, min_alive=min_alive)
    chaos.run(S.Schedule(seed=seed)
              .at(0, S.env_eio("any"))
              .at(0, S.env_skew(-1500.0, "any"))
              .at(0, S.env_rlimit(64 << 20, "any"))
              .at(0, S.env_brownout("any", rx_drop=True, tx_delay_ms=40.0))
              .at(0, S.env_eio("coordinator:g"))
              .at(0, S.env_brownout("leader:t:0", tx_drop=True))
              .at(0, S.env_brownout_clear())
              .at(0, S.env_eio_clear()))
    key = chaos.replay_key()
    chaos.heal()
    return key, c.calls, [e.get("resolved") for e in chaos.timeline]


@pytest.mark.parametrize("seed,n,min_alive", [(99, 4, 1), (100, 4, 1),
                                              (5, 3, 2)])
def test_env_verbs_equal_jax(seed, n, min_alive):
    port = _env_run(port_sched, seed, n, min_alive)
    assert port == _env_run(jax_sched, seed, n, min_alive)
    flat_items = [kv for _i, _t, _a, res in port[0] for kv in res]
    if min_alive == 1:
        for want in ("skew_ms", "rlim_bytes", "rx_drop", "tx_delay_ms"):
            assert any(k == want for k, _v in flat_items), want


# ===================================================== ledger merge ==
class TestLedgerMergeUnit:
    def test_clean_merge_verifies(self):
        o = DeliveryOracle()
        o.record_acks([("t", 0, i, None, "p00-%08d" % i, None, 10.0 + i)
                       for i in range(5)])
        o.record_consumed_rows([("t", 0, i, "p00-%08d" % i)
                                for i in range(5)])
        r = o.verify(check_duplicates=False, check_order=False)
        assert r["ok"] and r["acked"] == 5 and r["consumed"] == 5
        assert o.missing_count() == 0

    def test_worker_ts_feeds_recovery_clock(self):
        """A worker's stamp is kept as given; an in-process ack is
        stamped on arrival with the monotonic clock."""
        o = DeliveryOracle()
        o.record_acks([("t", 0, 0, None, "v0", None, 123.0)])
        before = time.monotonic()
        o.record_ack("t", 0, 1, None, "v1")
        with o._lock:
            assert o.acked_ts[0] == 123.0
            assert before <= o.acked_ts[1] <= time.monotonic()


# ============================================== worker spawn protocol ==
class TestWorkerProtocol:
    def test_handshake_is_package_free_and_stop_exits(self):
        """The port's worker hand-shakes BEFORE importing anything of the
        package (or torch), and exits 0 on an immediate stop: its
        -X importtime log holds neither."""
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", WORKER],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env)
        try:
            sel = selectors.DefaultSelector()
            sel.register(proc.stdout.fileno(), selectors.EVENT_READ)
            assert sel.select(timeout=10), "handshake timeout"
            sel.close()
            hs = json.loads(proc.stdout.readline())
            assert hs["ready"] and hs["pid"] == proc.pid
            proc.stdin.write(b'{"cmd":"stop"}\n')
            proc.stdin.flush()
            assert proc.wait(timeout=10) == 0
            imports = proc.stderr.read().decode()
        finally:
            proc.kill()
            proc.wait(timeout=5)
            proc.stdin.close()
            proc.stdout.close()
            proc.stderr.close()
        assert "import time:" in imports
        assert "librdkafka_tpu" not in imports
        assert "torch" not in imports


# ============================================ fleet runs (processes) ==
def _assert_port_fleet(seen, workers, brokers):
    roles = [what for what, _argv in seen.values()]
    assert sum(r.startswith("fleet-worker-") for r in roles) == workers
    assert roles.count("standalone-supervisor") == 1
    assert sum(r.startswith("standalone-broker-") for r in roles) >= brokers
    for what, argv in seen.values():
        if what.startswith("fleet-worker-"):
            assert argv[1] == WORKER, argv
        elif what == "standalone-supervisor":
            assert argv[1:3] == ["-m", "librdkafka_tpu_torch.mock.standalone"]
        else:
            assert argv[1] == os.path.join(PORT_DIR, "mock", "_relay.py")


@pytest.mark.fleet
class TestFleetRuns:
    def test_fleet_mini(self, cmdlines):
        """Two port workers spawn, stream and merge into a clean oracle.
        The scenario's 1.5 s window can close before a loaded host's
        producer has imported the package, so the traffic may be nil;
        what was acked was consumed.  This test checks the spawn and the
        merge; delivery is held by test_fleet_smoke_kill9_and_metrics
        (acked_total > 50)."""
        r = port_fscen.fleet_mini()
        assert r["ok"], r
        assert r["workers"] == 2 and not r["errors"]
        assert r["consumed_by_group"][0] >= r["fleet_metrics"]["acked_total"]
        _assert_port_fleet(cmdlines, workers=2, brokers=1)

    def test_fleet_smoke_kill9_and_metrics(self, cmdlines):
        t0 = time.monotonic()
        r = port_fscen.fleet_smoke()
        assert r["ok"], r
        assert r["workers"] == 4
        assert not r["errors"] and not r["schedule_errors"]
        kills = r["pids_killed"]
        assert kills and all(e["verified_dead"] for e in kills), \
            "fleet SIGKILL must be pid-verified"
        assert r["kills_fired"] == 1
        fm = r["fleet_metrics"]
        assert fm["acked_total"] > 50
        assert fm["fleet_msgs_s"] and fm["fleet_msgs_s"] > 0
        assert fm["client_p99_ms_max"] is not None
        assert fm["client_p99_ms"]
        assert set(fm["client_p99_ms"]) <= {"p00", "p01"}
        assert r["consumed_by_group"][0] >= fm["acked_total"]
        m = r["storm_metrics"]
        assert m["kills"] == 1
        assert m["recovery_ms"]["unrecovered"] == 0
        assert r["converged_s"] is not None
        assert time.monotonic() - t0 < 35, "fleet fast-tier budget blown"
        _assert_port_fleet(cmdlines, workers=4, brokers=2)
        assert {e["pid"] for e in kills} <= set(cmdlines)

    def test_fleet_replay_key_equals_jax(self):
        """Same seed => the port's fleet run resolves the same plan
        digest and fault timeline as a separately launched JAX-package
        rig."""
        def run_once(F, S, seed):
            run = F.FleetRun(seed=seed, brokers=2, partitions=2,
                             producers=1, groups=1, group_size=1,
                             shape={"kind": "flat", "rate": 120.0},
                             duration_s=1.2, drain_s=20.0, converge_s=15.0)
            sched = (S.Schedule(seed=seed)
                     .at(0.5, S.proc_kill9("any"))
                     .at(0.9, S.proc_restart()))
            r = run.run(sched)
            assert r["ok"], r
            return r["replay_key"]
        k1 = run_once(port_fscen, port_sched, 4747)
        assert k1 == run_once(jax_fscen, jax_sched, 4747)
        plan_key, sched_key = k1
        assert len(plan_key) == 16
        assert any(a == "proc_kill9" for _i, _t, a, _r in sched_key)

    def test_fleet_tampered_ledger_trips_merged_oracle(self):
        """A producer's ack ledger tampered after the merge (a record it
        never sent, as if acked) must raise OracleViolation naming it,
        with the JSON diff, through the real fleet run path."""
        def _tamper(oracles):
            oracles[0].record_acks([("fleet", 0, 10 ** 9, None,
                                     "p00-tampered", None, 0.0)])
        run = port_fscen.FleetRun(seed=49, brokers=1, partitions=2,
                                  producers=1, groups=1, group_size=1,
                                  shape=port_traffic.flat(150.0),
                                  duration_s=1.2, drain_s=15.0,
                                  converge_s=15.0)
        with pytest.raises(OracleViolation) as ei:
            run.run(None, tamper=_tamper)
        rep = ei.value.report
        assert [r["value"] for r in rep["violations"]["lost"]] == [
            "p00-tampered"]
        assert rep["diff_path"]


@pytest.mark.fleet
@pytest.mark.slow
class TestFleetFlagship:
    def test_flagship_fleet_storm(self):
        r = port_fscen.fleet_storm()
        assert r["ok"], r.get("group_reports")
        assert r["workers"] >= 24
        assert r["kills_fired"] >= 3
        kills = r["pids_killed"]
        assert len(kills) >= 3
        assert all(e["verified_dead"] and e["exit"] == -9 for e in kills)
        assert len({e["pid"] for e in kills}) == len(kills)
        assert any(e["rx_drop"] for e in r["brownouts"])
        assert any(e["on"] for e in r["eio_windows"])
        assert not r["schedule_errors"]
        assert len(r["group_reports"]) == 2
        assert all(g["ok"] for g in r["group_reports"])
        assert all(n >= r["acked"] for n in r["consumed_by_group"])
        fm = r["fleet_metrics"]
        assert fm["fleet_msgs_s"] > 0
        assert fm["client_p99_ms_max"] is not None
        assert r["storm_metrics"]["kills"] == 3
        assert r["storm_metrics"]["recovery_ms"]["unrecovered"] == 0


# =========================================================== registry ==
def test_scenario_registry_and_cli_equal_jax():
    assert list(port_fscen.SCENARIOS) == list(jax_fscen.SCENARIOS)
    for name, sc in port_fscen.SCENARIOS.items():
        ref = jax_fscen.SCENARIOS[name]
        assert (sc.tier, sc.seed, sc.invariants, sc.desc) == \
            (ref.tier, ref.seed, ref.invariants, ref.desc), name
    outs = []
    for main in (port_fleet_main, jax_fleet_main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["--list"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "fleet_storm" in outs[0]
