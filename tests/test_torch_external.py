"""The port's out-of-process chaos tier (librdkafka_tpu_torch/mock/
external.py and the chaos scenarios on it): a ``ClusterHandle`` spawns
the PORT's supervisor (``python -m librdkafka_tpu_torch.mock.standalone``)
and its broker relays, every pid lands in the port's registry and is
reaped by ``stop()``, the process verbs are pid-verified, the same seed
resolves the same fault timeline across supervisor launches and equals
the JAX package's ``ClusterHandle`` run, and ``fast_external_kill9``
passes through the port.  Test 0129's out-of-process cases, held to the
port."""
import os
import socket
import time

import pytest

from librdkafka_tpu.chaos import schedule as jax_sched
from librdkafka_tpu.mock.external import ClusterHandle as JaxClusterHandle
from librdkafka_tpu_torch.chaos import scenarios as port_scen
from librdkafka_tpu_torch.chaos import schedule as port_sched
from librdkafka_tpu_torch.mock import external as port_external
from librdkafka_tpu_torch.mock.external import (ClusterHandle,
                                                active_subprocess_pids,
                                                pid_alive)
from librdkafka_tpu_torch.obs import collect as port_collect
from librdkafka_tpu_torch.obs import metrics as port_metrics
from librdkafka_tpu_torch.obs import trace as port_trace

PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "librdkafka_tpu_torch")


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


def _assert_port_children(seen):
    """The supervisor runs the port's standalone module, each broker the
    port's relay, each fleet worker the port's worker, by path."""
    assert seen
    for pid, (what, argv) in seen.items():
        if what == "standalone-supervisor":
            assert argv[1:3] == ["-m", "librdkafka_tpu_torch.mock.standalone"]
        elif what.startswith("standalone-broker-"):
            assert argv[1] == os.path.join(PORT_DIR, "mock", "_relay.py")
        else:
            assert what.startswith("fleet-worker-"), what
            assert argv[1] == os.path.join(PORT_DIR, "fleet", "_worker.py")


@pytest.mark.chaos
class TestClusterHandle:
    def test_lifecycle_kill9_restart_pause_and_registry(self, cmdlines):
        """One launch, the whole control surface: handshake, status,
        pid-verified SIGKILL, same-port restart with a fresh pid,
        SIGSTOP/SIGCONT, control queries, and registry hygiene — every
        child is the port's."""
        h = ClusterHandle(brokers=3, topics={"t": 4})
        try:
            hs = h.handshake
            assert set(hs) >= {"bootstrap", "control", "pid", "brokers"}
            assert len(h.broker_pids) == 3
            assert all(pid_alive(p) for p in h.broker_pids.values())
            reg = active_subprocess_pids()
            assert h._proc.pid in reg
            assert all(p in reg for p in h.broker_pids.values())

            st = h.status()
            assert st["alive"] == [1, 2, 3] and st["down"] == []
            assert st["topics"]["t"] == [1, 2, 3, 1]
            assert h.coordinator_for("g-x") == h.coordinator_for("g-x")

            old_pid = h.broker_pids[2]
            old_port = h.broker_ports[2]
            r = h.kill9(2)
            assert r["exit"] == -9 and not pid_alive(old_pid)
            assert h.alive_brokers() == [1, 3]
            assert h.status()["down"] == [2]
            assert all(pv.leader != 2 for pv in h.topics["t"])
            with pytest.raises(ConnectionRefusedError):
                socket.create_connection(("127.0.0.1", old_port),
                                         timeout=2)

            r = h.restart_broker(2)
            assert r["port"] == old_port and r["pid"] != old_pid
            assert pid_alive(r["pid"])
            assert h.alive_brokers() == [1, 2, 3]
            s = socket.create_connection(("127.0.0.1", old_port),
                                         timeout=2)
            s.close()

            h.pause_broker(1)
            assert h.status()["paused"] == [1]
            h.resume_broker(1)
            assert h.status()["paused"] == []

            h.set_partition_leader("t", 0, 3)
            assert h.partition("t", 0).leader == 3

            kills = [e for e in h.proc_events if e["verb"] == "kill9"]
            assert kills and kills[0]["verified_dead"]
        finally:
            h.stop()
        assert h._proc.pid not in active_subprocess_pids()
        assert not pid_alive(h._proc.pid)
        assert all(not pid_alive(p) for p in h.broker_pids.values())
        # supervisor + 3 brokers + the restarted broker 2
        assert len(cmdlines) == 5
        _assert_port_children(cmdlines)

    def test_replay_key_identical_across_launches_and_to_jax(self):
        """Same seed => identical replay_key across two fresh port
        supervisors, and equal to the JAX package's ClusterHandle run of
        the same schedule."""
        def run_once(S, Handle, seed):
            h = Handle(brokers=3, topics={"t": 3})
            try:
                chaos = S.ChaosScheduler(h, min_alive=1)
                chaos.run(S.Schedule(seed=seed)
                          .at(0, S.proc_pause("any"))
                          .at(0, S.proc_kill9("any"))
                          .at(0, S.proc_cont())
                          .at(0, S.proc_kill9("coordinator:replay-g"))
                          .at(0, S.proc_restart())
                          .at(0, S.proc_restart()))
                assert not chaos.errors, chaos.errors
                chaos.heal()
                return chaos.replay_key()
            finally:
                h.stop()
        k1 = run_once(port_sched, ClusterHandle, 4242)
        assert k1 == run_once(port_sched, ClusterHandle, 4242)
        assert k1 == run_once(jax_sched, JaxClusterHandle, 4242)
        assert any(a == "proc_kill9" for _i, _t, a, _r in k1)


@pytest.mark.chaos
class TestFastExternalScenarios:
    def test_fast_external_kill9(self, cmdlines):
        t0 = time.monotonic()
        r = port_scen.fast_external_kill9()
        assert r["ok"], r["violations"]
        assert r["external"] and not r["errors"]
        assert not r["schedule_errors"]
        kills = r["pids_killed"]
        assert kills and all(e["verified_dead"] for e in kills), \
            "SIGKILL must be pid-verified"
        assert r["acked"] > 100 and r["consumed"] == r["acked"]
        m = r["storm_metrics"]
        assert m["storm_msgs_s"] > 0 and m["kills"] >= 1
        assert m["recovery_ms"]["p99"] is not None
        assert m["recovery_ms"]["unrecovered"] == 0
        assert time.monotonic() - t0 < 25, "fast-tier budget blown"
        _assert_port_children(cmdlines)
        assert {e["pid"] for e in kills} <= set(cmdlines)

    def test_fast_session_kill9(self):
        """The KIP-227 session cache dies with the SIGKILLed broker
        process; the client renegotiates and keeps delivering."""
        t0 = time.monotonic()
        r = port_scen.fast_session_kill9()
        assert r["ok"], r["violations"]
        assert r["external"] and not r["errors"]
        kills = r["pids_killed"]
        assert len(kills) == 2 and all(e["verified_dead"] for e in kills)
        assert r["consumed"] == r["acked"] > 0
        b1 = next(s for n, s in r["fetch_sessions"].items()
                  if n.endswith("/1"))
        assert b1["resets"] >= 1 and b1["full_fetches"] >= 2
        assert time.monotonic() - t0 < 35, "fast-tier budget blown"

    def test_fast_group_churn(self):
        t0 = time.monotonic()
        r = port_scen.fast_group_churn()
        assert r["ok"], r["violations"]
        g = r["group"]
        assert g["members"] == 6 and g["departed"] == 2
        assert g["coverage"]["converged"]
        assert r["converged_s"] is not None
        assert not r["violations"]["lost"]
        assert time.monotonic() - t0 < 30, "fast-tier budget blown"


@pytest.mark.chaos
@pytest.mark.slow
class TestExternalStorms:
    """test_0129's slow storms, through the port."""

    def test_flagship_external_kill9_eos(self):
        r = port_scen.external_kill9_eos(seed=21)
        assert r["ok"], r["violations"]
        assert r["kills_fired"] >= 3
        kills = r["pids_killed"]
        assert len(kills) >= 3
        assert all(e["verified_dead"] and e["exit"] == -9 for e in kills)
        assert len({e["pid"] for e in kills}) == len(kills)
        assert r["txns"]["committed"] > 10
        assert r["txns"]["aborted"] > 0
        assert r["txns"]["unknown"] == 0
        assert not r["schedule_errors"]
        assert r["group"]["coverage"]["converged"]
        assert r["storm_metrics"]["recovery_ms"]["unrecovered"] == 0

    def test_group_churn_coordinator_storm(self):
        r = port_scen.group_churn_coordinator_storm(seed=31)
        assert r["ok"], r["violations"]
        g = r["group"]
        assert g["members"] == 20 and g["departed"] == 8
        assert g["assignments"] > 25
        assert g["coverage"]["converged"] and r["converged_s"] is not None
        assert not r["violations"]["lost"]
        coord_kills = [e for e in r["timeline"]
                       if e["action"] == "broker_kill"
                       and (e.get("resolved") or {}).get("broker")]
        assert len(coord_kills) == 2


@pytest.mark.chaos
@pytest.mark.slow
@pytest.mark.soak
class TestSoak:
    def test_soak_kill9_txn_storm(self):
        r = port_scen.soak_kill9_txn_storm(seed=41, minutes=2.5)
        assert r["ok"], r["violations"]
        assert r["kills_fired"] >= 20
        assert r["txns"]["committed"] >= 800, r["txns"]
        assert r["acked"] >= 2500, r["acked"]
        assert r["txns"]["unknown"] == 0
        assert r["group"]["coverage"]["converged"]
        assert r["storm_metrics"]["recovery_ms"]["p99"] is not None
