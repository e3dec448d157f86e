"""Lockdep/lockset-enabled stress passes, the port's copy of the JAX
package's runtime gate (its ``analysis/stress.py``).

Drives every concurrent layer under instrumented locks and asserts a
clean lock-order graph:

  * **engine pipeline** — a gpu-backend producer (ticketed compress +
    CRC through the offload engine's dispatch lanes) and a CRC-checking
    consumer against the in-process mock, so app thread, rdk:main,
    broker threads, the engine dispatch thread and the mock cluster
    thread all interleave;
  * **txn commit/abort** — the transactional FSM's RLock+condvar
    against the coordinator paths;
  * **fast chaos storm** — one broker kill/restart under idempotent
    produce/consume (chaos scheduler + oracle + connect-retry paths).

Any cycle or held-across-blocking finding fails the gate (exit 1) with
both acquisition stacks printed.  Run: ``python -m
librdkafka_tpu_torch.analysis stress [--device cpu]``.

The two device legs (engine pipeline, device codec) launch the CRC and
LZ4 kernels on the card (``device=None``, ``gpu.device=cuda``) and raise
without one; ``device="cpu"`` runs them on the kernels' plain versions.
The other legs use the CPU codec provider, as the JAX package's do.

The ``races`` pass reruns the same legs under the Eraser-
style lockset detector (races.py): every declared shared field's
accesses refine their candidate locksets across app, rdk:main, broker,
codec-worker, engine dispatch/warmup, mock-cluster and chaos threads —
an empty-lockset write fails the gate with both access stacks.  It
then replays the engine-pipeline and txn legs under N seeded
schedules (interleave.SchedFuzzer): deterministic preemptions at the
lock/queue/descriptor yield points surface interleavings the default
scheduler never produces, each replayable via its ``replay_key``.
Run: ``python -m librdkafka_tpu_torch.analysis races``.
"""
from __future__ import annotations

import time
from typing import Optional

from . import interleave, lockdep, races

#: seeds for the schedule-explorer reruns (one fuzzer per seed; any
#: failure names its replay_key so the exact schedule re-runs)
SCHEDULE_SEEDS = (11, 23)


def _engine_pipeline_leg(device: Optional[str] = None) -> int:
    from .. import Consumer, Producer

    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "compression.backend": "gpu",
                  "gpu.device": device or "cuda",
                  "gpu.transport.min.mb.s": 0,
                  "gpu.launch.min.batches": 2, "gpu.governor": False,
                  "gpu.warmup": False, "compression.codec": "lz4",
                  "linger.ms": 5})
    c = None
    try:
        bs = p._rk.mock_cluster.bootstrap_servers()
        for i in range(300):
            p.produce("lockdep-eng", value=b"v%d" % i * 20,
                      partition=i % 4)
        assert p.flush(120.0) == 0, "engine leg: flush left messages"
        c = Consumer({"bootstrap.servers": bs, "group.id": "lockdep-g",
                      "auto.offset.reset": "earliest",
                      "check.crcs": True})
        c.subscribe(["lockdep-eng"])
        got = 0
        deadline = time.monotonic() + 60
        while got < 300 and time.monotonic() < deadline:
            m = c.poll(0.2)
            if m is not None and m.error is None:
                got += 1
        assert got == 300, f"engine leg: consumed {got}/300"
        return got
    finally:
        p.close()
        if c is not None:
            c.close()


def _devcodec_leg(device: Optional[str] = None) -> None:
    """The device compress route under instrumented locks — a
    gpu.compress.device producer with two QoS-weighted topics, so the
    engine's lz4 staging rings, fused compress→CRC launches and the
    governor's QoS tallies (submitter-side note_topics vs dispatch-
    side note_qos vs the stats emitter's snapshots) interleave with
    the broker/app/mock threads; a CRC-checking consumer proves the
    device frames byte-valid end to end."""
    from .. import Consumer, Producer

    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "compression.backend": "gpu",
                  "gpu.device": device or "cuda",
                  "gpu.transport.min.mb.s": 0,
                  "gpu.compress.device": True,
                  "gpu.launch.min.batches": 1, "gpu.governor": False,
                  "gpu.warmup": False, "compression.codec": "lz4",
                  "linger.ms": 5, "batch.num.messages": 16})
    c = None
    try:
        p._rk.set_topic_conf("lockdep-dc-lat", {"topic.qos.weight": 4.0})
        p._rk.set_topic_conf("lockdep-dc-bulk",
                             {"topic.qos.weight": 0.5})
        bs = p._rk.mock_cluster.bootstrap_servers()
        for i in range(120):
            topic = ("lockdep-dc-lat" if i % 3 else "lockdep-dc-bulk")
            p.produce(topic, value=b"dc%03d " % i * 12, key=b"k%d" % i)
        assert p.flush(120.0) == 0, "devcodec leg: flush left messages"
        eng = p._rk.codec_provider._engine
        snap = eng.compress_snapshot() if eng is not None else {}
        assert snap.get("launches", 0) >= 1, \
            f"devcodec leg: no device compress launch: {snap}"
        assert set(snap.get("qos", {})) >= {"lockdep-dc-lat",
                                            "lockdep-dc-bulk"}, snap
        c = Consumer({"bootstrap.servers": bs,
                      "group.id": "lockdep-dc-g",
                      "auto.offset.reset": "earliest",
                      "check.crcs": True})
        c.subscribe(["lockdep-dc-lat", "lockdep-dc-bulk"])
        got = 0
        deadline = time.monotonic() + 60
        while got < 120 and time.monotonic() < deadline:
            m = c.poll(0.2)
            if m is not None and m.error is None:
                got += 1
        assert got == 120, f"devcodec leg: consumed {got}/120"
    finally:
        p.close()
        if c is not None:
            c.close()


def _txn_leg() -> None:
    from .. import Producer

    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "transactional.id": "lockdep-tx",
                  "compression.codec": "lz4", "linger.ms": 1})
    try:
        p.init_transactions(30)
        p.begin_transaction()
        for i in range(20):
            p.produce("lockdep-txn", value=b"c%d" % i, partition=0)
        p.commit_transaction(30)
        p.begin_transaction()
        for i in range(20):
            p.produce("lockdep-txn", value=b"a%d" % i, partition=0)
        p.flush(30)
        p.abort_transaction(30)
    finally:
        p.close()


def _chaos_leg() -> None:
    from ..chaos.scenarios import fast_kill_restart

    res = fast_kill_restart(seed=7)
    assert res.get("ok", True), f"chaos leg violated delivery: {res}"


def _external_storm_leg() -> None:
    """The fast out-of-process storm — a real SIGKILL and a
    SIGSTOP brownout of broker OS processes while the instrumented
    client-side locks (broker reconnect, oracle, scheduler, handle
    control plane) feed the lock-order graph."""
    from ..chaos.scenarios import fast_external_kill9

    res = fast_external_kill9(seed=23)
    assert res.get("ok", True), f"external leg violated delivery: {res}"
    pids = [e for e in res.get("proc_events", []) if e["verb"] == "kill9"]
    assert pids and all(e["verified_dead"] for e in pids), \
        f"external leg: SIGKILL not pid-verified: {pids}"


def _fastlane_leg() -> None:
    """The widened arena fast lane under instrumented locks —
    app-thread produce() appends (murmur2 auto-partition + explicit
    timestamps + headers riding the C lane) race the broker thread's
    run take at linger.ms=0, while an interleaved shape-ineligible
    produce (per-message on_delivery) claims a hot toppar mid-stream so
    demote_arena's drain races concurrent appends (the broker-side
    "race" demotion path)."""
    from .. import Producer

    drs: list = []
    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "linger.ms": 0,
                  "dr_msg_cb": lambda e, m: drs.append(e)})
    try:
        p.set_topic_conf("lockdep-lane", {"partitioner": "murmur2"})
        # metadata warm-up: auto-partition needs the partition count
        t = p._rk.get_topic("lockdep-lane")
        deadline = time.monotonic() + 30
        while t.partition_cnt <= 0 and time.monotonic() < deadline:
            p.poll(0.05)
        assert t.partition_cnt > 0, "fastlane leg: no metadata"
        hdrs = [("k", b"v")]
        now_ms = int(time.time() * 1000)
        for i in range(400):
            p.produce("lockdep-lane", value=b"x%03d" % i,
                      key=b"k%02d" % (i % 37), timestamp=now_ms + i,
                      headers=hdrs)
            if i == 250:
                # shape-ineligible produce claims a toppar mid-run: if
                # the broker is mid-take this exercises the "race"
                # demotion, else the "ineligible" drain — both contend
                # with live appends
                p.produce("lockdep-lane", value=b"slow", partition=0,
                          on_delivery=lambda e, m: None)
            if i % 64 == 0:
                p.poll(0)
        assert p.flush(60.0) == 0, "fastlane leg: flush left messages"
        # the on_delivery produce routes to its own callback, not the
        # global dr_msg_cb: exactly the 400 lane messages land here
        assert len(drs) == 400 and all(e is None for e in drs), \
            f"fastlane leg: DRs {len(drs)}/400"
    finally:
        p.close()


def _session_leg() -> None:
    """Incremental fetch sessions under instrumented locks —
    a 16-partition interest set negotiates a session, runs incremental
    epochs, survives a broker-side cache eviction (top-level
    FETCH_SESSION_ID_NOT_FOUND → reset + epoch-0 renegotiation) and
    rides the forgotten_topics path on unassign, interleaving the
    per-broker session state with the mock's shared session cache."""
    from .. import Consumer, Producer
    from ..client.consumer import TopicPartition
    from ..mock.cluster import MockCluster

    cluster = MockCluster(num_brokers=1, topics={"sess": 16})
    c = None
    try:
        p = Producer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "linger.ms": 2})
        for i in range(200):
            p.produce("sess", value=b"s%03d" % i, partition=i % 16)
        assert p.flush(60.0) == 0, "session leg: flush left messages"
        p.close()
        c = Consumer({"bootstrap.servers": cluster.bootstrap_servers(),
                      "group.id": "lockdep-sess",
                      "auto.offset.reset": "earliest"})
        c.assign([TopicPartition("sess", i) for i in range(16)])
        got = 0
        deadline = time.monotonic() + 60
        while got < 100 and time.monotonic() < deadline:
            m = c.poll(0.2)
            if m is not None and m.error is None:
                got += 1
        assert got == 100, f"session leg: consumed {got}/100 pre-evict"
        assert cluster.evict_fetch_sessions() >= 1, \
            "session leg: no broker-side session to evict"
        while got < 200 and time.monotonic() < deadline:
            m = c.poll(0.2)
            if m is not None and m.error is None:
                got += 1
        assert got == 200, f"session leg: consumed {got}/200 post-evict"
        # the post-evict records may have been prefetched before the
        # eviction landed — keep polling until the next session fetch
        # hits FETCH_SESSION_ID_NOT_FOUND and resets
        reset_seen = False
        while not reset_seen and time.monotonic() < deadline:
            with c._rk._brokers_lock:
                brokers = list(c._rk.brokers.values())
            reset_seen = any(b._fetch_session.c_resets >= 1
                             for b in brokers)
            if not reset_seen:
                c.poll(0.1)
        assert reset_seen, \
            "session leg: eviction did not reset the client session"
        c.unassign()
        c.poll(0.2)
    finally:
        if c is not None:
            c.close()
        cluster.stop()


def _fleet_leg() -> None:
    """The tier-1 fleet smoke — 4 real client OS processes
    under burst traffic and a pid-verified SIGKILL while the driver's
    reader threads merge worker ledgers into the per-group oracles:
    the fleet.driver lock, oracle ledgers, handle control plane and
    scheduler all interleave under the instrumented locks."""
    from ..fleet.scenarios import fleet_smoke

    res = fleet_smoke(seed=51)
    assert res.get("ok", True), f"fleet leg violated delivery: {res}"
    pids = res.get("pids_killed", [])
    assert pids and all(e["verified_dead"] for e in pids), \
        f"fleet leg: SIGKILL not pid-verified: {pids}"


def run_stress(device: Optional[str] = None) -> dict:
    """Every leg under one enabled window; returns the lockdep report
    (``lockdep.clean(report)`` is the pass predicate).  ``device`` is
    the device legs' ``gpu.device``: the card unless ``"cpu"``."""
    lockdep.reset()
    lockdep.enable()
    try:
        _engine_pipeline_leg(device)
        _devcodec_leg(device)
        _txn_leg()
        _chaos_leg()
        _external_storm_leg()
        _fleet_leg()
        _session_leg()
        _fastlane_leg()
    finally:
        lockdep.disable()
    return lockdep.report()


def run_races(seeds=SCHEDULE_SEEDS, device: Optional[str] = None) -> tuple:
    """The lockset pass: the same legs under the race detector (which
    holds a lockdep reference — locksets come from its held-stack),
    then the engine + txn legs re-run under one seeded schedule per
    ``seed``.  Returns ``(races_report, schedule_keys)``.  ``device``
    as in :func:`run_stress`."""
    races.reset()
    lockdep.reset()
    races.enable()
    keys = []
    try:
        _engine_pipeline_leg(device)
        _devcodec_leg(device)
        _txn_leg()
        _chaos_leg()
        _fleet_leg()
        _session_leg()
        _fastlane_leg()
        for seed in seeds:
            fz = interleave.SchedFuzzer(seed)
            keys.append(fz.replay_key())
            interleave.install(fz)
            try:
                _engine_pipeline_leg(device)
                _txn_leg()
            finally:
                interleave.uninstall()
    finally:
        races.disable()
    return races.report(), keys


def races_main(device: Optional[str] = None) -> int:
    t0 = time.perf_counter()
    rep, keys = run_races(device=device)
    print(races.format_report(rep))
    print(f"races: lockset sweep (engine pipeline + device codec + txn "
          f"+ fast chaos "
          f"storm + fleet smoke + fetch sessions + fast lane) + {len(keys)} seeded "
          f"schedules {[k for k in keys]} "
          f"in {time.perf_counter() - t0:.1f}s")
    return 0 if races.clean(rep) else 1


def main(device: Optional[str] = None) -> int:
    t0 = time.perf_counter()
    rep = run_stress(device)
    print(lockdep.format_report(rep))
    print(f"stress: engine pipeline + device codec + txn commit/abort "
          f"+ fast chaos "
          f"storm + external SIGKILL storm + fleet smoke + fetch "
          f"sessions + fast lane in {time.perf_counter() - t0:.1f}s")
    return 0 if lockdep.clean(rep) else 1


if __name__ == "__main__":
    raise SystemExit(main())
