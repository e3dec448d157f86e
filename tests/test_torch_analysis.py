"""The port's copies of the analysis tier (librdkafka_tpu_torch/analysis)
held to test 0128's and 0130's cases: a planted AB/BA inversion is
found with both stacks, a planted empty-lockset write is found, and a
pass of the port's engine under its own lockdep and lockset detector
reports clean."""
import threading
import time

import numpy as np
import pytest

from librdkafka_tpu.analysis import lockdep as jax_lockdep
from librdkafka_tpu_torch.analysis import lockdep, locks, races
from librdkafka_tpu_torch.analysis.races import shared
from librdkafka_tpu_torch.obs import metrics as port_metrics
from librdkafka_tpu_torch.obs import trace as port_trace
from librdkafka_tpu_torch.ops import cpu as native


@pytest.fixture(autouse=True)
def _port_obs_clean():
    """The conftest checks the JAX package's obs state; this checks the
    port's: tracer and metrics disabled and empty after each test."""
    yield
    assert not port_trace.enabled and port_trace.active_ring_count() == 0
    assert not port_metrics.enabled and port_metrics.registered_count() == 0
    assert not lockdep.enabled and not races.enabled


class _Cell:
    v = shared("t_torch.cell.v")

    def __init__(self):
        self.v = 0


def _run_threads(*targets):
    ths = [threading.Thread(target=fn, name=f"t-torch-{i}", daemon=True)
           for i, fn in enumerate(targets)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    assert not any(t.is_alive() for t in ths)


def _abba(mod):
    """Plant an AB/BA inversion under ``mod`` (a lockdep module) and
    return its report."""
    with mod.scope():
        mod.enable()
        try:
            a = mod.DepLock("t.A")
            b = mod.DepLock("t.B")

            def fwd():
                with a:
                    with b:
                        pass

            th = threading.Thread(target=fwd, name="abba-fwd")
            th.start()
            th.join()
            with b:            # the inversion, safely sequenced
                with a:
                    pass
            return mod.report()
        finally:
            mod.disable()


def test_abba_inversion_caught_with_both_stacks():
    """The port's lockdep finds the inversion as the JAX package's does:
    one inconsistent_order pair, both edges, both threads."""
    reps = [_abba(lockdep), _abba(jax_lockdep)]
    pairs = [[c for c in rep["cycles"] if c["kind"] == "inconsistent_order"]
             for rep in reps]
    assert [len(p) for p in pairs] == [1, 1]
    c = pairs[0][0]
    assert set(c["path"]) == {"t.A", "t.B"} == set(pairs[1][0]["path"])
    assert {e["thread"] for e in c["edges"]} == {"abba-fwd", "MainThread"}
    assert all("test_torch_analysis" in e["stack"] for e in c["edges"])
    assert not lockdep.clean(reps[0])


def test_unguarded_write_race_reported():
    races.enable()
    try:
        with races.scope():
            c = _Cell()

            def w():
                for _ in range(3):
                    c.v += 1

            _run_threads(w, w)
            rep = races.report()
            assert not races.clean(rep)
            r = [x for x in rep["races"] if x["var"] == "t_torch.cell.v"][0]
            assert r["kind"] == "empty_lockset_write"
            assert r["other_stacks"] and len(r["threads"]) >= 2
    finally:
        races.disable()


def test_factory_plain_when_disabled_instrumented_when_enabled():
    assert type(locks.new_lock("t.plain")) is type(threading.Lock())
    with lockdep.scope():
        lockdep.enable()
        try:
            assert isinstance(locks.new_lock("t.dep"), lockdep.DepLock)
        finally:
            lockdep.disable()


def _fallback(bufs, poly):
    p = native.CpuCodecProvider()
    return p.crc32c_many(bufs) if poly == "crc32c" else p.crc32_many(bufs)


def test_engine_pass_clean_under_lockdep_and_races():
    """The engine (fan-in, fused launches, CPU serves, host jobs, warmup,
    snapshots from another thread, close) under the port's lockdep and
    lockset detector: no inversion, no lock held across the readback, no
    empty-lockset write."""
    from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
    rng = np.random.default_rng(30)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (10, 3000, 70_000)]
    with lockdep.scope(), races.scope():
        races.enable()
        try:
            eng = AsyncOffloadEngine(depth=2, fanin_window_s=0.002,
                                     min_batches=4, devices=["cpu"],
                                     warmup=True, cpu_fallback=_fallback)
            stop = threading.Event()

            def submitter(poly):
                for _ in range(6):
                    eng.submit(bufs, poly, window=True).result(60)
                    eng.submit(bufs * 2, poly, window=False).result(60)

            def reader():
                while not stop.is_set():
                    eng.governor_snapshot()
                    eng.gauges_snapshot()
                    eng.devices_snapshot()
                    time.sleep(0.001)

            rd = threading.Thread(target=reader, name="t-torch-reader")
            rd.start()
            try:
                assert eng.warm_wait(60)
                _run_threads(lambda: submitter("crc32c"),
                             lambda: submitter("crc32"))
                eng.submit_compute(sum, [1, 2], host=True).result(60)
                eng.stage_latency_snapshot()
            finally:
                stop.set()
                rd.join(30)
                eng.close()
            assert eng.stats["launches"] >= 1, eng.stats
            rep = races.report()
            assert races.clean(rep), races.format_report(rep)
            drep = lockdep.report()
            assert lockdep.clean(drep), lockdep.format_report(drep)
        finally:
            races.disable()
