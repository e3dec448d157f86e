"""The readers of the client's CPU by layer (``broker_idle_pass_cpu_us``,
``broker_ack_cpu_us``, ``native_pool_cpu_us``, ``unattributed_cpu_us``)
on synthetic readings: what each sums, and that each reads nothing from
a program without the tallies and counters it reads, or from a trail
whose ring overwrote tallies.

    python -m pytest kbench/tests/test_kbench_cpu_readers.py
"""
from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KB = os.path.dirname(HERE)


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(KB, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # a dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    return _load(os.path.join("metrics", metric + ".py"),
                 "kbench_test_metric_" + metric).read


def readings(**kw):
    Readings = _load(os.path.join("lib", "harness.py"),
                     "kbench_test_harness").Readings
    return Readings(seconds=30.0, **kw)


METRICS = ("broker_idle_pass_cpu_us", "broker_ack_cpu_us",
           "native_pool_cpu_us", "unattributed_cpu_us")


def tally(name: str, cpu_ns: dict, pool_ns: int = 0, ts: float = 0.0,
          tid: int = 1, dropped: int = 0):
    """A zero-length tally event as the window keeps it."""
    return {"name": name, "cat": "broker" if name == "pass_tally"
            else "codec", "ph": "X", "ts": ts, "dur": 0.0, "tid": tid,
            "args": {"t_start": ts - 1e5, "passes": 10, "cpu_ns": cpu_ns,
                     "pool_cpu_ns": pool_ns, "dropped": dropped,
                     **({"idle_passes": 4} if name == "pass_tally" else {})}}


SPANS = [
    tally("pass_tally", {"idle": 3_000_000, "recv": 5_000_000,
                         "ops": 1_000_000}, pool_ns=500_000, ts=1e6),
    tally("pass_tally", {"idle": 1_000_000, "recv": 3_000_000,
                         "send": 2_000_000}, ts=1.1e6),
    tally("codec_tally", {"busy": 4_000_000},
          pool_ns=1_500_000, ts=1.05e6, tid=2, dropped=7),
    {"name": "produce_tx", "cat": "produce", "ph": "X", "ts": 1.02e6,
     "dur": 50.0, "tid": 1, "args": {"batch": 1}},
]
ENGINE = {"turns": 100, "turn_cpu_ns": 6_000_000,
          "native_pool_cpu_ns": 7_000_000, "host_jobs": 9}


def full():
    return readings(delivered=1000, spans=list(SPANS), engine=dict(ENGINE),
                    client_cpu_s=0.05, app_thread_cpu_s=0.01)


def test_broker_idle_pass_cpu_sums_the_idle_phase():
    # 3 + 1 ms of idle passes over 1,000 records
    assert reader("broker_idle_pass_cpu_us")(full()) == 4.0


def test_broker_ack_cpu_sums_the_recv_phase():
    assert reader("broker_ack_cpu_us")(full()) == 8.0


def test_native_pool_cpu_adds_engine_and_tallies():
    # engine 7 ms + broker 0.5 ms + codec worker 1.5 ms
    assert reader("native_pool_cpu_us")(full()) == 9.0


def test_unattributed_cpu_is_what_is_left():
    # 50 ms - app 10 - tallies (9 + 6 + 4) - pools (0.5 + 1.5) - turns 6
    # - engine pool 7 = 6 ms
    got = reader("unattributed_cpu_us")(full())
    assert abs(got - 6.0) < 1e-9, got


def test_readers_read_nothing_from_a_program_without_them():
    """The parent of these metrics: no tallies, no new engine counters;
    every reader returns None and none raises."""
    old = readings(delivered=1000, client_cpu_s=0.05, app_thread_cpu_s=0.01,
                   spans=[s for s in SPANS if s["name"] == "produce_tx"],
                   engine={"host_jobs": 9, "launches": 3})
    for m in METRICS:
        assert reader(m)(old) is None, m


def test_readers_read_nothing_untraced_or_without_records():
    for r in (readings(delivered=1000, engine={}),
              readings(delivered=0, spans=list(SPANS),
                       engine=dict(ENGINE), client_cpu_s=0.05,
                       app_thread_cpu_s=0.01)):
        for m in METRICS:
            assert reader(m)(r) is None, m


def test_readers_read_nothing_from_a_wrapped_trail():
    """A thread whose ring overwrote events between two of its tallies
    (its ``dropped`` grew) may have lost tallies: every reader of the
    tallies reads nothing rather than an undercount.  A count that holds
    still, however large, is no loss inside the window."""
    r = full()
    r.spans.append(tally("pass_tally", {"idle": 1_000}, ts=1.2e6,
                         dropped=3))
    for m in METRICS:
        assert reader(m)(r) is None, m
    # the codec worker's ring: only the readers of its tallies
    r = full()
    r.spans.append(tally("codec_tally", {"busy": 1_000}, ts=1.2e6, tid=2,
                         dropped=8))
    assert reader("native_pool_cpu_us")(r) is None
    assert reader("unattributed_cpu_us")(r) is None
    assert reader("broker_idle_pass_cpu_us")(r) == 4.0
    r = full()
    r.spans.append(tally("codec_tally", {"busy": 1_000_000}, ts=1.2e6,
                         tid=2, dropped=7))
    assert reader("broker_ack_cpu_us")(r) == 8.0


def test_zero_length_tallies_change_no_gap_label_or_batch_count():
    """A tally is a zero-length span: the idle-gap label (the span open
    at a gap's middle) and ``batch_records`` read the same with the
    tallies as without them, unless a tally falls on a middle's exact
    microsecond."""
    devtrace = _load(os.path.join("lib", "devtrace.py"),
                     "kbench_test_devtrace")
    spans = [
        {"name": "produce_tx", "cat": "produce", "ph": "X", "ts": 100.0,
         "dur": 400.0},
        {"name": "ack", "cat": "produce", "ph": "X", "ts": 150.0,
         "dur": 100.0},
    ]
    tallies = [tally("pass_tally", {"idle": 1}, ts=t)
               for t in (120.0, 200.5, 380.0, 900.0)]
    for t_us in (50.0, 120.5, 175.0, 200.0, 300.0, 380.25, 700.0):
        assert (devtrace._label(spans + tallies, t_us)
                == devtrace._label(spans, t_us)), t_us
    br = reader("batch_records")
    assert (br(readings(delivered=500, spans=spans + tallies))
            == br(readings(delivered=500, spans=spans)) == 500.0)
