"""Mirrors of the event API, the plugin loader and the statistics cases no
other port test holds: test_0062_events (typed DR and error events, the
background event thread, the IO-event fd), test_0066_plugins
(``plugin.library.paths`` and its interceptors), and test_0053_stats'
HdrHistogram, ``Avg`` window, latency decomposition and stats emit under
broker churn.

Each case runs one scenario on both packages with the same inputs (the
reference case's conf, mapped for the port by ``port_conf``) and
compares what they return: event type sequences, DR payloads, stats key
trees, HdrHistogram percentiles on one numpy-seeded sample, and the
plugin fixture's call deltas, taken one package after the other.
"""
import json
import os
import select
import threading
import time

import numpy as np
import pytest

import plugin_fixture
from test_torch_observability import both, keytree

WINDOW_FIELDS = ("p50", "p75", "p90", "p95", "p99", "p99_99", "stddev",
                 "outofrange", "hdrsize")


def _collapse(types: list) -> list:
    """A type sequence with runs of one type folded into one entry."""
    return [t for i, t in enumerate(types) if i == 0 or types[i - 1] != t]


# ------------------------------------------------------- test_0062 ------

def test_queue_poll_typed_dr_events():
    def scenario(pkg):
        ev = pkg.mod("client.event")
        p = pkg.Producer(pkg.conf({"bootstrap.servers": "",
                                   "test.mock.num.brokers": 1,
                                   "linger.ms": 2, "enabled_events": "dr"}))
        try:
            for i in range(5):
                p.produce("ev", value=b"e%d" % i, partition=0)
            types, got = [], []
            deadline = time.monotonic() + 10
            while len(got) < 5 and time.monotonic() < deadline:
                e = p.rk.queue_poll(0.2)
                if e is None:
                    continue
                types.append(e.type)
                if e.type == ev.EVENT_DR:
                    got.extend(e.messages())
        finally:
            p.close()
        return {"types": _collapse(types) == [ev.EVENT_DR],
                "errors": [m.error for m in got],
                "values": sorted(m.value for m in got),
                "consts": (ev.EVENT_DR, ev.EVENT_ERROR, ev.EVENT_LOG,
                           ev.EVENT_STATS)}
    port, ref = both(scenario)
    assert port == ref
    assert ref["types"] and ref["errors"] == [None] * 5
    assert ref["values"] == [b"e%d" % i for i in range(5)]


def test_background_event_thread_serves_without_polling():
    def scenario(pkg):
        ev = pkg.mod("client.event")
        events = []
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": "", "test.mock.num.brokers": 1,
            "linger.ms": 2, "statistics.interval.ms": 150,
            "background_event_cb": events.append}))
        for i in range(10):
            p.produce("bg", value=b"b%d" % i, partition=0)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:      # no poll() at all
            drs = [m for e in list(events) if e.type == ev.EVENT_DR
                   for m in e.messages()]
            if len(drs) >= 10 and any(e.type == ev.EVENT_STATS
                                      for e in list(events)):
                break
            time.sleep(0.05)
        p.close()
        drs = [m for e in events if e.type == ev.EVENT_DR
               for m in e.messages()]
        stats = [json.loads(e.stats()) for e in events
                 if e.type == ev.EVENT_STATS]
        names = {ev.EVENT_DR: "dr", ev.EVENT_STATS: "stats"}
        return {"types": sorted({names.get(e.type, e.type) for e in events}),
                "drs": sorted(m.value for m in drs),
                "stats_type": stats[0]["type"] if stats else None}
    port, ref = both(scenario)
    assert port == ref
    assert ref["types"] == ["dr", "stats"]
    assert ref["drs"] == sorted(b"b%d" % i for i in range(10))
    assert ref["stats_type"] == "producer"


def test_error_event_type():
    """A message to an unreachable cluster expires into an error DR on
    the background thread: the same error code in both packages."""
    def scenario(pkg):
        ev = pkg.mod("client.event")
        events = []
        p = pkg.Producer(pkg.conf({"bootstrap.servers": "127.0.0.1:1",
                                   "message.timeout.ms": 1200,
                                   "background_event_cb": events.append}))
        p.produce("never", value=b"x", partition=0)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if any(e.type == ev.EVENT_DR for e in list(events)):
                break
            time.sleep(0.05)
        p.close()
        dr = [m for e in events if e.type == ev.EVENT_DR
              for m in e.messages()]
        return [(m.value, m.error.code.name if m.error else None)
                for m in dr]
    port, ref = both(scenario)
    assert port == ref
    assert ref and ref[0][0] == b"x" and ref[0][1] is not None


def test_io_event_fd_wakeup():
    """io_event_enable(fd): an op landing on the app-facing queue writes
    the payload byte (a DR for the producer, a fetch for the consumer)."""
    def scenario(pkg):
        cluster = pkg.mod("mock.cluster").MockCluster(num_brokers=1,
                                                        topics={"ioe": 1})
        fds = []
        try:
            r, w = os.pipe()
            fds += [r, w]
            os.set_blocking(w, False)
            p = pkg.Producer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "linger.ms": 2, "dr_msg_cb": lambda e, m: None}))
            p.io_event_enable(w, b"D")
            p.produce("ioe", value=b"x", partition=0)
            ready, _, _ = select.select([r], [], [], 10.0)
            dr_byte = os.read(r, 16)[:1] if ready else None
            p.flush(10.0)
            p.close()
            r2, w2 = os.pipe()
            fds += [r2, w2]
            os.set_blocking(w2, False)
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "gioe", "auto.offset.reset": "earliest"}))
            try:
                c.io_event_enable(w2, b"M")
                c.subscribe(["ioe"])
                ready, _, _ = select.select([r2], [], [], 15.0)
                fetch = b"M" in os.read(r2, 64) if ready else False
                m = c.poll(5.0)
                value = m.value if m is not None else None
            finally:
                c.close()
        finally:
            for fd in fds:
                os.close(fd)
            cluster.stop()
        return dr_byte, fetch, value
    port, ref = both(scenario)
    assert port == ref == (b"D", True, b"x")


# ------------------------------------------------------- test_0066 ------

PLUGIN_EXACT = ("conf_init", "on_new", "on_send", "on_acknowledgement")


def test_plugin_library_paths_loads_and_hooks_fire():
    """The reference fixture module loaded through plugin.library.paths
    by each package in turn: the same exact call deltas, and request and
    thread hooks firing in both."""
    def scenario(pkg):
        before = dict(plugin_fixture.CALLS)
        p = pkg.Producer(pkg.conf({"bootstrap.servers": "",
                                   "test.mock.num.brokers": 1,
                                   "plugin.library.paths": "plugin_fixture",
                                   "linger.ms": 2}))
        created = {k: plugin_fixture.CALLS[k] - before[k]
                   for k in ("conf_init", "on_new")}
        for i in range(10):
            p.produce("plug", value=b"x%d" % i, partition=0)
        assert p.flush(10.0) == 0
        p.close()
        delta = {k: plugin_fixture.CALLS[k] - before[k]
                 for k in plugin_fixture.CALLS}
        return {"created": created,
                "exact": {k: delta[k] for k in PLUGIN_EXACT},
                "fired": {k: delta[k] > 0 for k in delta
                          if k not in PLUGIN_EXACT}}
    port, ref = both(scenario, serial=True)
    assert port == ref
    assert ref["created"] == {"conf_init": 1, "on_new": 1}
    assert ref["exact"] == {"conf_init": 1, "on_new": 1, "on_send": 10,
                            "on_acknowledgement": 10}
    assert all(ref["fired"].values()), ref["fired"]


def test_plugin_custom_entry_point():
    def scenario(pkg):
        before = plugin_fixture.CALLS["conf_init"]
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": "", "test.mock.num.brokers": 1,
            "plugin.library.paths": "plugin_fixture:custom_entry"}))
        p.close()
        return plugin_fixture.CALLS["conf_init"] - before
    port, ref = both(scenario, serial=True)
    assert port == ref == 100


# ------------------------------------------------------- test_0053 ------

def _hdr(pkg):
    return pkg.mod("utils.hdrhistogram").HdrHistogram


class TestHdrHistogram:
    PCTS = (50, 75, 90, 95, 99, 99.99)

    def test_percentiles_vs_numpy(self):
        rng = np.random.default_rng(7)
        datas = (rng.integers(1, 1000, 20000),
                 rng.lognormal(8, 1.5, 20000).astype(int) + 1)

        def scenario(pkg):
            out = []
            for data in datas:
                h = _hdr(pkg)(1, 60_000_000, 3)
                for v in data.tolist():
                    h.record(v)
                out.append(([h.value_at_percentile(p) for p in self.PCTS],
                            h.min_v, h.max_v, h.mean(), h.stddev()))
            return out
        port, ref = both(scenario, serial=True)
        assert port == ref
        for data, (pcts, lo, hi, mean, sd) in zip(datas, ref):
            for p, got in zip(self.PCTS, pcts):
                want = float(np.percentile(data, p, method="inverted_cdf"))
                assert abs(got - want) / max(want, 1) < 0.002, (p, got, want)
            assert lo == data.min() and hi == data.max()
            assert abs(mean - data.mean()) / data.mean() < 0.001
            assert abs(sd - data.std()) / data.std() < 0.01

    def test_constant_and_edge_values(self):
        def scenario(pkg):
            h = _hdr(pkg)(1, 1000, 2)
            for _ in range(100):
                h.record(777)
            p50, p9999 = h.value_at_percentile(50), h.value_at_percentile(99.99)
            return (p50, p9999, h.record(0), h.record(5000), h.record(-1),
                    h.out_of_range, h.min_v)
        port, ref = both(scenario, serial=True)
        assert port == ref
        assert ref[0] == ref[1] and abs(ref[0] - 777) <= 777 * 0.01
        assert ref[2:] == (True, False, False, 2, 0)

    def test_memory_is_constant(self):
        def scenario(pkg):
            h = _hdr(pkg)(1, 60_000_000, 3)
            size0 = h.memsize
            for v in range(1, 200000, 7):
                h.record(v)
            return size0, h.memsize, h.total
        port, ref = both(scenario, serial=True)
        assert port == ref
        assert ref[0] == ref[1] and ref[2] == len(range(1, 200000, 7))

    def test_reset(self):
        def scenario(pkg):
            h = _hdr(pkg)()
            h.record(42)
            h.reset()
            return h.total, h.value_at_percentile(99)
        port, ref = both(scenario, serial=True)
        assert port == ref == (0, 0)


class TestAvg:
    def test_rollover_window_semantics(self):
        def scenario(pkg):
            a = pkg.mod("client.stats").Avg()
            for v in (100, 200, 300, 400):
                a.add(v)
            return a.rollover(), a.rollover()
        port, ref = both(scenario, serial=True)
        assert port == ref
        w, w2 = ref
        assert w["cnt"] == 4 and w["min"] == 100 and w["max"] == 400
        assert 245 <= w["avg"] <= 255
        assert w["p50"] >= 200 and w["p99"] >= 390 * 0.99
        assert {"stddev", "outofrange", "hdrsize"} <= set(w)
        assert w2["cnt"] == 0 and w2["p99"] == 0


def test_stats_blob_latency_decomposition():
    """The stats blobs of a two-broker produce: int_latency and each
    broker's rtt / outbuf_latency / throttle windows, with the same key
    tree in both packages."""
    def scenario(pkg):
        blobs = []
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": "", "test.mock.num.brokers": 2,
            "linger.ms": 2, "statistics.interval.ms": 200,
            "stats_cb": lambda js: blobs.append(json.loads(js))}))
        for i in range(300):
            p.produce("st", value=b"v%d" % i, partition=i % 4)
            if i % 50 == 0:
                p.poll(0)
                time.sleep(0.02)
        assert p.flush(15.0) == 0
        deadline = time.monotonic() + 5
        while not blobs and time.monotonic() < deadline:
            p.poll(0.1)
        p.close()
        best = max(blobs, key=lambda b: b["int_latency"]["cnt"])
        il = best["int_latency"]
        br = next(iter(best["brokers"].values()))
        return {"il_keys": sorted(il), "cnt": il["cnt"] > 0,
                "ordered": il["min"] <= il["p50"] <= il["p99"] <= il["max"],
                "rtt": any(b["rtt"]["cnt"] > 0 for blob in blobs
                           for b in blob["brokers"].values()),
                "broker_windows": {k: sorted(br[k]) for k in
                                   ("rtt", "outbuf_latency", "throttle")},
                "tree": keytree({**best, "brokers": sorted(
                    best["brokers"].values(), key=lambda b: b["nodeid"])})}
    port, ref = both(scenario)
    assert port["tree"] == ref["tree"]
    for r in (port, ref):
        assert set(WINDOW_FIELDS) <= set(r["il_keys"])
        assert r["cnt"] and r["ordered"] and r["rtt"]
    assert port["broker_windows"] == ref["broker_windows"]


def test_stats_emit_safe_during_broker_churn():
    """emit_json() while the broker table changes under it, in both
    packages: no 'dict changed size' error, the same blob keys."""
    def scenario(pkg):
        Broker = pkg.mod("client.broker").Broker
        p = pkg.Producer(pkg.conf({"bootstrap.servers": "",
                                   "test.mock.num.brokers": 2,
                                   "linger.ms": 2}))
        rk = p._rk
        errors, keys = [], set()
        stop = threading.Event()

        def emitter():
            try:
                while not stop.is_set():
                    keys.update(json.loads(rk.stats.emit_json()))
            except Exception as e:          # reported below
                errors.append(e)

        try:
            for i in range(50):
                p.produce("churn-t", value=b"x%d" % i, partition=i % 4)
            th = threading.Thread(target=emitter)
            th.start()
            try:
                for i in range(150):
                    b = Broker(rk, 1000 + i, "127.0.0.1", 1)
                    with rk._brokers_lock:
                        rk.brokers[b.nodeid] = b
                    with rk._brokers_lock:
                        del rk.brokers[b.nodeid]
                    b._wakeup_r.close()
                    b._wakeup_w.close()
            finally:
                stop.set()
                th.join(10)
            alive = th.is_alive()
            left = p.flush(15.0)
        finally:
            p.close()
        return errors, alive, left, "brokers" in keys
    port, ref = both(scenario)
    assert port == ref == ([], False, 0, True)

