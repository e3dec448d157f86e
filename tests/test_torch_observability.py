"""Mirrors of the observability plane on the port: test_0126_trace (every
case but the bench.py artifact) and test_0136_observability's metrics
registry, clock alignment, flow stitching, collector dump dirs, the fleet
driver's flight-dump sweep, the fleet's merged trace, the rig's traces and
traceview's merge (the trend-gate and bench cases test root scripts the
port does not copy).

Each case runs one scenario on both packages with the same inputs (the
reference case's conf; for the port mapped by ``port_conf``, so a
``tpu`` backend becomes ``gpu`` on ``gpu.device=cpu``) and compares what the two record: span name
sets, args key sets, stats ``obs`` key trees, snapshot schemas, dump
shapes, and counts where they are deterministic.  The autouse fixture
points both tracers' flight dumps at the test's directory and restores
both packages' tracer, metrics and collector state afterwards: a fleet
driver with ``trace=True`` leaves ``trace.flight_dir`` naming a directory
its ``stop()`` removed, and the next flight dump in the worker would fail.
"""
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import torch_port_only as port_only
from test_torch_client import port_conf
from test_torch_txn import both as both_at_once

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

WINDOW_KEYS = {"min", "max", "avg", "sum", "cnt", "stddev", "hdrsize",
               "outofrange", "p50", "p75", "p90", "p95", "p99", "p99_99"}

#: the stages test_0126's acceptance run must span
REQUIRED = {"enqueue", "batch_assembly", "compress", "crc_ticket",
            "fanin_wait", "device_launch", "readback", "produce_tx", "ack",
            "fetch_rx", "crc_verify", "decompress", "deliver"}

#: test_0126's device-routed producer conf (the port's through port_conf)
TRACED = {"bootstrap.servers": "", "test.mock.num.brokers": 1,
          "trace.enable": True, "trace.ring.events": 16384,
          "compression.backend": "tpu", "tpu.transport.min.mb.s": 0,
          "tpu.launch.min.batches": 2, "tpu.governor": False,
          "tpu.warmup": False, "compression.codec": "lz4",
          "linger.ms": 10}


def _pkg(port: bool) -> SimpleNamespace:
    root = "librdkafka_tpu_torch" if port else "librdkafka_tpu"

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    client = importlib.import_module(root)
    errors = m("client.errors")
    broker = m("client.broker")
    return SimpleNamespace(
        port=port, root=root, mod=m,
        Producer=client.Producer, Consumer=client.Consumer,
        Conf=m("client.conf").Conf, Err=errors.Err,
        KafkaError=errors.KafkaError, KafkaException=errors.KafkaException,
        Broker=broker.Broker, Request=broker.Request,
        ApiKey=m("protocol.proto").ApiKey,
        trace=m("obs.trace"), metrics=m("obs.metrics"),
        collect=m("obs.collect"), external=m("mock.external"),
        trace_py=os.path.join(ROOT, root, "obs", "trace.py"),
        conf=port_conf if port else dict)


PORT, REF = _pkg(True), _pkg(False)
PKGS = (PORT, REF)

_TRACE_STATE = ("flight_dir", "last_flight_path", "_flight_count",
                "enabled", "_enable_count", "flow_sample_every",
                "ring_events", "dump_on_fatal")


def both(scenario, *args, serial: bool = False):
    """``scenario(pkg, *args)`` on the port and on the JAX package (this
    file's namespaces): at once (``test_torch_txn.both``), or one after
    the other with ``serial``.  Returns (port result, reference result)."""
    if serial:
        return tuple(scenario(pkg, *args) for pkg in PKGS)
    return both_at_once(
        lambda pkg, *a: scenario(PORT if pkg.port else REF, *a), *args)


def keytree(obj):
    """The nested key structure of a JSON value (lists by their first
    element), without the values."""
    if isinstance(obj, dict):
        return {k: keytree(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [keytree(obj[0])] if obj else []
    return type(obj).__name__


def _load_traceview():
    spec = importlib.util.spec_from_file_location(
        "tk_traceview_torch_obs", os.path.join(ROOT, "scripts",
                                               "traceview.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _obs_state(tmp_path):
    """Both packages' tracer globals, metrics refcount and collector
    dump-dir registry saved, flight dumps pointed at ``tmp_path``, and
    everything restored after; the test must leave each plane released
    and no port subprocess alive."""
    saved = [({k: getattr(p.trace, k) for k in _TRACE_STATE},
              (p.metrics.enabled, p.metrics._enable_count),
              set(p.collect._dump_dirs)) for p in PKGS]
    for p in PKGS:
        p.trace.flight_dir = str(tmp_path)
    try:
        yield
        for p in PKGS:
            assert not p.trace.enabled and p.trace.active_ring_count() == 0
            assert not p.metrics.enabled
            assert p.metrics.registered_count() == 0
            assert p.collect.active_dump_dir_count() == 0
        leaked = PORT.external.active_subprocess_pids()
        if leaked:
            PORT.external.reap_leaked()
        assert not leaked, f"leaked port subprocess(es): {leaked}"
    finally:
        for p, (tr, (m_on, m_cnt), dirs) in zip(PKGS, saved):
            for k, v in tr.items():
                setattr(p.trace, k, v)
            p.metrics.enabled, p.metrics._enable_count = m_on, m_cnt
            with p.collect._lock:
                p.collect._dump_dirs.clear()
                p.collect._dump_dirs.update(dirs)


def _consume(c, n: int, timeout: float = 60.0) -> int:
    got = 0
    deadline = time.monotonic() + timeout
    while got < n and time.monotonic() < deadline:
        m = c.poll(0.2)
        if m is not None and m.error is None:
            got += 1
    return got


def _check_perfetto(evs: list) -> None:
    """test_0126's exporter contract."""
    assert isinstance(evs, list)
    for e in evs:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert "dur" in e and "ts" in e
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in evs)
    ts = [e["ts"] for e in evs if "ts" in e]
    assert ts == sorted(ts)


def _args_keys(evs: list) -> dict:
    out: dict = {}
    for e in evs:
        if e["ph"] != "M":
            out.setdefault(e["name"], set()).update(e.get("args") or {})
    return out


# ------------------------------------------------------- test_0126 ------

def test_trace_e2e_produce_consume_all_stages(tmp_path):
    """One traced produce + consume on each package: every stage of the
    pipeline spanned, the governor's route on the launch span, the dump
    Perfetto-loadable; the span args' key sets equal per name."""
    def scenario(pkg):
        p = pkg.Producer(pkg.conf(TRACED))
        c = None
        try:
            bs = p._rk.mock_cluster.bootstrap_servers()
            p.produce("tr", value=b"solo", partition=0)
            assert p.flush(120.0) == 0
            for i in range(200):
                p.produce("tr", value=b"v%d" % i * 20, partition=i % 4)
            assert p.flush(120.0) == 0
            c = pkg.Consumer({"bootstrap.servers": bs, "group.id": "g-trace",
                              "auto.offset.reset": "earliest",
                              "check.crcs": True, "trace.enable": True})
            c.subscribe(["tr"])
            got = _consume(c, 201)
            path = str(tmp_path / f"trace-{pkg.root}.json")
            n = c.trace_dump(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            p.close()
            if c is not None:
                c.close()
        evs = data["traceEvents"]
        _check_perfetto(evs)
        launch = next(e for e in evs if e["name"] == "device_launch")
        rb = next(e for e in evs if e["name"] == "readback")
        return {"got": got, "n": n > 0, "keys": _args_keys(evs),
                "route": launch["args"]["route"],
                "device_ok": launch["args"]["device"] >= -1,
                "rb_device": "device" in rb["args"],
                "off": (not pkg.trace.enabled
                        and pkg.trace.active_ring_count() == 0)}
    port, ref = both(scenario)
    for r in (port, ref):
        assert r["got"] == 201 and r["n"] and r["off"] and r["rb_device"]
        assert REQUIRED <= set(r["keys"]), REQUIRED - set(r["keys"])
        assert r["route"] == "device" and r["device_ok"]
        assert {"explored", "fused", "bucket", "blocks", "device",
                "sharded"} <= r["keys"]["device_launch"]
    common = set(port["keys"]) & set(ref["keys"])
    assert REQUIRED <= common
    # the port's own span args (CPU_ACCOUNTING.md) aside
    assert port_only.SPAN_ARGS <= port["keys"]["produce_tx"] & \
        port["keys"]["ack"]
    assert {k: port["keys"][k] - port_only.SPAN_ARGS for k in common} == \
        {k: ref["keys"][k] for k in common}


def test_trace_stats_share_instrumentation():
    """The stats decomposition of a device-routed produce: the same
    stage_latency windows and gauges in both blobs."""
    def scenario(pkg):
        conf = {k: v for k, v in TRACED.items() if not k.startswith("trace")}
        p = pkg.Producer(pkg.conf(conf))
        try:
            for i in range(200):
                p.produce("sl", value=b"v%d" % i * 20, partition=i % 4)
            assert p.flush(120.0) == 0
            blob = json.loads(p._rk.stats.emit_json())
        finally:
            p.close()
        ce = blob["codec_engine"]
        sl = ce["stage_latency"]
        b = next(iter(blob["brokers"].values()))
        return {"cnt": {k: sl[k]["cnt"] >= 1
                        for k in ("launch", "submit_wait", "reap")},
                "windows": {k: sorted(sl[k]) for k in sorted(sl)},
                "gauges": sorted(ce["gauges"]),
                "fetch_latency": "fetch_latency" in b}
    port, ref = both(scenario)
    assert port == ref
    assert all(ref["cnt"].values()) and ref["fetch_latency"]
    assert ref["gauges"] == ["fanin_occupancy", "inflight_launches",
                             "queue_depth"]


def test_ring_keeps_last_n_events():
    def scenario(pkg):
        tr = pkg.trace
        tr.enable(ring=64)
        try:
            for i in range(200):
                tr.instant("t", f"e{i}")
            evs = tr._local.ring.snapshot()
        finally:
            tr.disable()
        return ([e[2] for e in evs], tr.enabled, tr.active_ring_count())
    port, ref = both(scenario, serial=True)
    assert port == ref == ([f"e{i}" for i in range(136, 200)], False, 0)


def test_rings_are_per_thread_and_refcounted(tmp_path):
    def scenario(pkg):
        tr = pkg.trace
        tr.enable(ring=256)
        tr.enable(ring=256)             # a second client's reference
        try:
            tr.instant("t", "main-ev")
            th = threading.Thread(target=tr.instant, args=("t", "worker-ev"),
                                  name="trace-worker")
            th.start()
            th.join(5)
            rings = tr.active_ring_count()
            path = str(tmp_path / f"two-{pkg.root}.json")
            n = tr.dump(path)
            with open(path) as f:
                evs = json.load(f)["traceEvents"]
            tr.disable()                # first release: still enabled
            still = tr.enabled
        finally:
            tr.disable()
        return {"rings": rings, "n": n, "still": still,
                "tids": len({e["tid"] for e in evs if e["ph"] == "i"}),
                "names": sorted(e["name"] for e in evs if e["ph"] == "i"),
                "worker": "trace-worker" in {e["args"]["name"] for e in evs
                                             if e["ph"] == "M"},
                "off": (tr.enabled, tr.active_ring_count())}
    port, ref = both(scenario, serial=True)
    assert port == ref == {"rings": 2, "n": 2, "still": True, "tids": 2,
                           "names": ["main-ev", "worker-ev"], "worker": True,
                           "off": (False, 0)}


def test_disabled_recording_is_a_noop():
    def scenario(pkg):
        tr = pkg.trace
        tr.instant("t", "dropped")
        tr.complete("t", "dropped", tr.now())
        tr.evt("t", "dropped")
        return (tr.enabled, tr.active_ring_count(), tr.collect_events())
    port, ref = both(scenario, serial=True)
    assert port == ref == (False, 0, [])


def test_trace_conf_knobs_validate_at_set_time():
    """The trace.* properties: the same defaults, ranges, set()-time
    errors and the module-level guard in both packages."""
    def scenario(pkg):
        conf = pkg.Conf()
        out = {"defaults": [conf.get(k) for k in
                            ("trace.enable", "trace.ring.events",
                             "trace.dump.on.fatal")]}
        conf.set("trace.enable", "true")
        conf.set("trace.ring.events", 4096)
        out["set"] = [conf.get("trace.enable"), conf.get("trace.ring.events")]
        errs = []
        for v in (1000, 32, 1 << 23):
            with pytest.raises(pkg.KafkaException) as ei:
                conf.set("trace.ring.events", v)
            errs.append(str(ei.value))
        out["errors"] = errs
        conf.set("trace.dump.on.fatal", "false")
        out["fatal"] = conf.get("trace.dump.on.fatal")
        with pytest.raises(ValueError) as ei:
            pkg.trace.enable(ring=100)
        out["guard"] = (str(ei.value), pkg.trace.enabled)
        return out
    port, ref = both(scenario, serial=True)
    assert port == ref
    assert ref["defaults"] == [False, 8192, True]
    assert ref["set"] == [True, 4096] and ref["fatal"] is False
    assert "power of two" in ref["errors"][0]
    assert "outside allowed range" in ref["errors"][1]
    assert ref["guard"][1] is False


def test_flight_record_on_fatal_error(tmp_path):
    def scenario(pkg):
        p = pkg.Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                          "trace.enable": True, "linger.ms": 2})
        try:
            p.produce("fl", value=b"x", partition=0)
            assert p.flush(30.0) == 0
            p._rk.set_fatal_error(pkg.KafkaError(pkg.Err._FATAL,
                                                 "synthetic fatal"))
            path = pkg.trace.last_flight_path
        finally:
            p.close()
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        fr = [e for e in evs if e["name"] == "flight_record"]
        return {"dir": os.path.dirname(path) == str(tmp_path),
                "file": os.path.basename(path).split("_", 4)[4],
                "reason": fr[0]["args"]["reason"],
                "fatal_error": any(e["name"] == "fatal_error" for e in evs)}
    port, ref = both(scenario, serial=True)
    assert port == ref
    assert ref["dir"] and ref["fatal_error"] and "fatal" in ref["reason"]
    assert "fatal" in ref["file"]


def test_flight_record_on_request_timeout(tmp_path):
    """A request timed out on a broker thread dumps the rings with the
    ``request_timeout`` instant, under the same file name shape."""
    def scenario(pkg):
        p = pkg.Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                          "trace.enable": True, "socket.max.fails": 0})
        before = pkg.trace.last_flight_path
        try:
            b = pkg.Broker(p._rk, 999, "127.0.0.1", 1)     # never started
            try:
                b.waitresp[7] = pkg.Request(
                    pkg.ApiKey.Metadata, {}, corrid=7,
                    abs_timeout=time.monotonic() - 1.0)
                b._scan_timeouts(time.monotonic())
                timeouts = b.c_req_timeouts
                path = pkg.trace.last_flight_path
            finally:
                b._wakeup_r.close()
                b._wakeup_w.close()
        finally:
            p.close()
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        rt = [e for e in evs if e["name"] == "request_timeout"]
        return {"timeouts": timeouts, "new": path != before,
                "dir": os.path.dirname(path) == str(tmp_path),
                "file": os.path.basename(path).split("_", 4)[4],
                "instant": [(e["ph"], sorted(e.get("args") or {}))
                            for e in rt]}
    port, ref = both(scenario, serial=True)
    assert port == ref
    assert ref["timeouts"] == 1 and ref["new"] and ref["dir"]
    assert ref["file"] == "request_timeout_Metadata.json"
    assert len(ref["instant"]) == 1 and ref["instant"][0][0] == "i"


def test_flight_record_bounded_and_gateable(tmp_path):
    def scenario(pkg):
        tr = pkg.trace
        d = tmp_path / pkg.root
        d.mkdir()
        tr.enable(ring=256, on_fatal=False, dump_dir=str(d))
        try:
            gated = tr.flight_record("nope")
        finally:
            tr.disable()
        tr.enable(ring=256, on_fatal=True, dump_dir=str(d))
        try:
            tr.instant("t", "seed")
            paths = [tr.flight_record(f"r{i}")
                     for i in range(tr.FLIGHT_MAX_DUMPS + 3)]
        finally:
            tr.disable()
        made = [x for x in paths if x]
        return {"gated": gated, "max": tr.FLIGHT_MAX_DUMPS,
                "made": len(made), "exist": all(map(os.path.exists, made)),
                "files": sorted(os.listdir(d)).__len__(),
                "last": paths[-1]}
    port, ref = both(scenario, serial=True)
    assert port == ref == {"gated": None, "max": 8, "made": 8, "exist": True,
                           "files": 8, "last": None}


def test_traceview_summarize_and_render(tmp_path):
    """scripts/traceview.py over each package's own dump: the same
    stages, counts, per-device attribution and widest span."""
    tv = _load_traceview()

    def scenario(pkg):
        tr = pkg.trace
        tr.enable(ring=1024)
        try:
            for i in range(20):
                t0 = tr.now()
                time.sleep(0.001 if i != 7 else 0.02)   # one wide outlier
                tr.complete("stage", "work", t0, {"i": i})
            for dev in (0, 1, -1):
                t0 = tr.now()
                tr.complete("engine", "device_launch", t0,
                            {"device": dev, "sharded": dev == -1})
            tr.instant("stage", "blip")
            path = str(tmp_path / f"tv-{pkg.root}.json")
            tr.dump(path)
        finally:
            tr.disable()
        s = tv.summarize(tv.load_events(path))
        st = next(x for x in s["stages"] if x["name"] == "work")
        out = tv.render(s)
        return {"stages": sorted((x["name"], x["cat"], x["cnt"])
                                 for x in s["stages"]),
                "keys": sorted(st),
                "ordered": st["p50_us"] <= st["p99_us"] <= st["max_us"],
                "outlier": st["max_us"] >= 15_000,
                "widest": (s["widest"][0]["name"], s["widest"][0]["args"]),
                "instants": s["instants"],
                "devs": sorted(d["device"] for d in s["by_device"]
                               if d["name"] == "device_launch"),
                "render": ["work" in out, "top widest spans" in out,
                           "per-device launch attribution" in out]}
    port, ref = both(scenario, serial=True)
    assert port == ref
    assert ref["stages"] == [("device_launch", "engine", 3),
                             ("work", "stage", 20)]
    assert ref["ordered"] and ref["outlier"] and all(ref["render"])
    assert ref["widest"] == ("work", {"i": 7})
    assert ref["instants"] == {"blip": 1} and ref["devs"] == [-1, 0, 1]


# ------------------------------------------------------- test_0136 ------

class TestMetricsRegistry:
    def test_instruments_and_snapshot_schema(self):
        def scenario(pkg):
            mx = pkg.metrics
            mx.enable()
            try:
                c = mx.counter("t.count")
                c.inc()
                c.inc(4)
                same = mx.counter("t.count") is c
                mx.gauge("t.level").set(2.5)
                w = mx.window("t.lat_us")
                for v in (100, 200, 300):
                    w.record(v)
                snap = mx.snapshot()
                n = mx.registered_count()
            finally:
                mx.disable()
            after = mx.snapshot()
            return {"same": same, "schema": (snap["schema"], mx.SCHEMA),
                    "tree": keytree(snap), "counters": snap["counters"],
                    "gauges": snap["gauges"], "win": snap["windows"],
                    "n": n, "after": after,
                    "off": (mx.enabled, mx.registered_count())}
        port, ref = both(scenario, serial=True)
        assert port == ref
        assert ref["same"] and ref["schema"] == (1, 1) and ref["n"] == 3
        assert ref["counters"] == {"t.count": 5}
        assert ref["gauges"] == {"t.level": 2.5}
        assert set(ref["win"]["t.lat_us"]) == WINDOW_KEYS
        assert ref["win"]["t.lat_us"]["cnt"] == 3
        assert ref["after"]["enabled"] is False
        assert not ref["after"]["counters"] and ref["off"] == (False, 0)

    def test_enable_is_refcounted(self):
        def scenario(pkg):
            mx = pkg.metrics
            mx.enable()
            mx.enable()
            try:
                mx.counter("rc.count").inc()
                mx.disable()            # one reference left
                kept = (mx.enabled, mx.counter("rc.count").value)
            finally:
                mx.disable()
            return kept, (mx.enabled, mx.registered_count())
        port, ref = both(scenario, serial=True)
        assert port == ref == ((True, 1), (False, 0))

    def test_disabled_guard_sites_register_nothing(self):
        def scenario(pkg):
            mx = pkg.metrics
            if mx.enabled:              # the hot-site idiom
                mx.counter("never").inc()
            return mx.enabled, mx.registered_count(), mx.snapshot()
        port, ref = both(scenario, serial=True)
        assert port == ref
        assert ref[:2] == (False, 0)

    def test_engine_registers_launch_counter_live(self):
        """Device launches of a produce increment engine.launches by the
        engine's own launch count, and the stats blob's ``obs`` section
        carries the snapshot: the same key tree in both packages."""
        def scenario(pkg):
            pkg.metrics.enable()
            conf = {k: v for k, v in TRACED.items()
                    if not k.startswith("trace")}
            p = pkg.Producer(pkg.conf({**conf, "linger.ms": 5}))
            try:
                for i in range(64):
                    p.produce("mx", value=b"v%d" % i * 20, partition=i % 4)
                assert p.flush(120.0) == 0
                snap = pkg.metrics.snapshot()
                blob = json.loads(p._rk.stats.emit_json())
            finally:
                p.close()
                pkg.metrics.disable()
            ce = blob["codec_engine"]
            return {"launches": snap["counters"].get("engine.launches", 0),
                    "engine": ce["launches"] + ce["compress"]["launches"],
                    "obs_launches": blob["obs"]["counters"]["engine.launches"],
                    "enabled": blob["obs"]["enabled"],
                    "tree": keytree(blob["obs"]),
                    "left": pkg.metrics.registered_count()}
        port, ref = both(scenario)
        for r in (port, ref):
            assert r["launches"] >= 1 and r["launches"] == r["engine"]
            assert r["obs_launches"] == r["launches"]
            assert r["enabled"] is True and r["left"] == 0
        assert port["tree"] == ref["tree"]


_CHILD_SRC = r"""
import importlib.util, json, os, sys, time
spec = importlib.util.spec_from_file_location("tk_child_trace", sys.argv[1])
tr = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tr)
tr.enable()
for line in sys.stdin:
    cmd = json.loads(line)
    if "clock" in cmd:
        print(json.dumps({"mono_ns": tr.now()}), flush=True)
    elif "span" in cmd:
        t0 = tr.now()
        time.sleep(cmd["span"])
        tr.complete("xp", "work", t0, {"who": cmd["who"]})
        print(json.dumps({"ok": True}), flush=True)
    elif "dump" in cmd:
        print(json.dumps({"pid": os.getpid(),
                          "events": tr.collect_events()}), flush=True)
        break
"""


def _rpc(proc, obj):
    proc.stdin.write(json.dumps(obj) + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    assert line, "child died mid-exchange"
    return json.loads(line)


class TestClockAlignment:
    def test_align_offset_math(self):
        for pkg in PKGS:
            assert pkg.collect.align_offset(5900, 5000, 6100) == (1000, 100)
            assert pkg.collect.align_offset(0, 500, 1000) == (0, 500)
            assert pkg.collect.align_offset(10, 7, 31) == \
                PORT.collect.align_offset(10, 7, 31)

    def test_two_real_subprocesses_align_and_merge(self, tmp_path):
        """Two children per package, each running that package's
        obs/trace.py by path, clock-sampled over pipes, merged into one
        timeline: the same labels, order and metadata shape."""
        child = tmp_path / "child.py"
        child.write_text(_CHILD_SRC)

        def scenario(pkg):
            procs = []
            try:
                for _ in range(2):
                    procs.append(subprocess.Popen(
                        [sys.executable, str(child), pkg.trace_py],
                        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                        text=True))
                clocks = []
                for p in procs:
                    best = None
                    for _ in range(3):
                        t_send = time.monotonic_ns()
                        r = _rpc(p, {"clock": 1})
                        off, err = pkg.collect.align_offset(
                            t_send, r["mono_ns"], time.monotonic_ns())
                        if best is None or err < best[1]:
                            best = (off, err)
                    clocks.append(best)
                _rpc(procs[0], {"span": 0.02, "who": "a"})
                _rpc(procs[1], {"span": 0.02, "who": "b"})
                dumps = []
                for i, p in enumerate(procs):
                    d = _rpc(p, {"dump": 1})
                    dumps.append(pkg.collect.ProcessDump(
                        f"child-{i}", d["pid"], d["events"],
                        offset_ns=clocks[i][0], err_ns=clocks[i][1]))
                rcs = [p.wait(timeout=30) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait(timeout=10)
            events = pkg.collect.merge(dumps)
            meta = [e for e in events if e.get("ph") == "M"
                    and e["name"] == "process_name"]
            body = [e for e in events if e.get("ph") != "M"]
            spans = {e["args"]["who"]: e for e in body
                     if e.get("ph") == "X" and e["name"] == "work"}
            return {"rcs": rcs,
                    "aligned": all(0 <= err < 250_000_000
                                   and abs(off) <= err + 50_000_000
                                   for off, err in clocks),
                    "labels": sorted(m["args"]["name"] for m in meta),
                    "meta_keys": sorted(set().union(*(m["args"]
                                                      for m in meta))),
                    "pids": len({e["pid"] for e in body}),
                    "sorted": [e["ts"] for e in body]
                    == sorted(e["ts"] for e in body),
                    "who": sorted(spans),
                    "ordered": spans["a"]["ts"] + spans["a"]["dur"]
                    <= spans["b"]["ts"] + 1}
        port, ref = both(scenario, serial=True)
        assert port == ref == {
            "rcs": [0, 0], "aligned": True, "labels": ["child-0", "child-1"],
            "meta_keys": ["clock_err_us", "clock_offset_us", "name"],
            "pids": 2, "sorted": True, "who": ["a", "b"], "ordered": True}


class TestFlowStitching:
    def _pt(self, stage, ts, pid, off=0):
        return {"name": stage, "ph": "i", "cat": "flow", "pid": pid,
                "tid": 0, "ts": ts,
                "args": {"topic": "t", "partition": 0, "offset": off}}

    def test_stitch_unit_links_stage_chain(self):
        events = [self._pt("flow_produce", 10.0, 1),
                  self._pt("flow_ack", 20.0, 1),
                  self._pt("flow_fetch", 30.0, 2),
                  self._pt("flow_deliver", 40.0, 2),
                  self._pt("flow_produce", 50.0, 1, off=64)]
        port, ref = (p.collect.stitch_flows([dict(e) for e in events])
                     for p in PKGS)
        assert port == ref
        out, links = ref
        assert links == 3
        flows = [e for e in out if e.get("ph") in ("s", "t", "f")]
        assert [f["ph"] for f in flows] == ["s", "t", "t", "f"]
        assert flows[-1]["bp"] == "e"
        assert PORT.collect.FLOW_STAGES == REF.collect.FLOW_STAGES
        assert PORT.collect.flow_link_count(out) == 3

    def test_flow_points_through_real_client_paths(self):
        """flow_sample_every=1: each package's hot paths emit all four
        stages for the same records and stitch into full chains."""
        def scenario(pkg):
            tr = pkg.trace
            tr.flow_sample_every = 1        # restored by the fixture
            tr.enable()
            c = None
            p = pkg.Producer({"bootstrap.servers": "",
                              "test.mock.num.brokers": 1, "linger.ms": 2})
            try:
                bs = p._rk.mock_cluster.bootstrap_servers()
                for i in range(3):
                    p.produce("fl", value=b"v%d" % i, partition=0)
                assert p.flush(60.0) == 0
                c = pkg.Consumer({"bootstrap.servers": bs,
                                  "group.id": "g-flow",
                                  "auto.offset.reset": "earliest"})
                c.subscribe(["fl"])
                got = _consume(c, 3)
                events = tr.collect_events()
            finally:
                if c is not None:
                    c.close()
                p.close()
                tr.disable()
            stitched, links = pkg.collect.stitch_flows(events)
            by_id: dict = {}
            for e in stitched:
                if e.get("ph") in ("s", "t", "f"):
                    by_id.setdefault(e["id"], []).append(e["args"]["stage"])
            points = sorted((e["name"], e["args"]["offset"]) for e in events
                            if e.get("cat") == "flow" and e.get("ph") == "i")
            return {"got": got, "points": points, "links": links,
                    "chains": sorted(tuple(v) for v in by_id.values())}
        port, ref = both(scenario)
        assert port == ref
        assert ref["got"] == 3 and ref["links"] == 9
        assert ref["chains"] == [REF.collect.FLOW_STAGES] * 3


class TestCollectorDumpDirs:
    def test_dump_dir_registry_and_release(self):
        def scenario(pkg):
            col = pkg.collect
            n0 = col.active_dump_dir_count()
            d = col.make_dump_dir()
            try:
                made = (os.path.isdir(d), col.active_dump_dir_count() - n0)
            finally:
                col.release_dump_dir(d)
            gone = (col.active_dump_dir_count() - n0, os.path.exists(d))
            col.release_dump_dir(d)         # idempotent
            return made, gone, col.active_dump_dir_count() - n0
        port, ref = both(scenario, serial=True)
        assert port == ref == ((True, 1), (0, False), 0)

    def test_write_is_perfetto_loadable(self, tmp_path):
        events = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                   "args": {"name": "x"}},
                  {"name": "s", "ph": "X", "pid": 1, "tid": 0,
                   "ts": 1.0, "dur": 2.0}]
        out = []
        for pkg in PKGS:
            path = str(tmp_path / f"m-{pkg.root}.json")
            n = pkg.collect.write(path, events)
            with open(path) as f:
                out.append((n, f.read()))
        assert out[0] == out[1]
        data = json.loads(out[1][1])
        assert out[1][0] == 1 and isinstance(data["traceEvents"], list)
        assert data["displayTimeUnit"] == "ms"

    def test_merge_of_one_process_dumps(self, tmp_path):
        """A flight dump and a client's trace_dump of one process merged
        under two labels (what the card's flight-recorder check does):
        byte-equal Perfetto files from both packages' collectors."""
        flight = [{"name": "thread_name", "ph": "M", "pid": 7, "tid": 3,
                   "args": {"name": "engine"}},
                  {"name": "device_launch", "ph": "X", "pid": 7, "tid": 3,
                   "ts": 5.0, "dur": 1.5, "args": {"device": 0}},
                  {"name": "request_timeout", "ph": "i", "pid": 7, "tid": 4,
                   "ts": 9.0, "s": "t"}]
        consumer = [{"name": "crc_verify", "ph": "X", "pid": 7, "tid": 5,
                     "ts": 2.0, "dur": 4.0}]
        out = []
        for pkg in PKGS:
            events = pkg.collect.merge([
                pkg.collect.ProcessDump("producer-flight", 1, flight),
                pkg.collect.ProcessDump("consumer", 2, consumer, 1000, 10)])
            path = str(tmp_path / f"merged-{pkg.root}.json")
            n = pkg.collect.write(path, events)
            with open(path) as f:
                out.append((n, f.read()))
        assert out[0] == out[1]
        evs = json.loads(out[1][1])["traceEvents"]
        assert out[1][0] == 3
        assert [(e["name"], e["ts"]) for e in evs if e["ph"] != "M"] == \
            [("crc_verify", 3.0), ("device_launch", 5.0),
             ("request_timeout", 9.0)]
        assert {e["pid"] for e in evs} == {1, 2}


class TestFlightDumpSweep:
    def test_driver_flight_dumps_inline_and_sweep(self, tmp_path):
        """Each package's FleetDriver: streamed flight paths come back with
        inline payloads, and an orphan dump is found by the sweep."""
        def scenario(pkg):
            driver = pkg.mod("fleet.driver")
            traffic = pkg.mod("fleet.traffic")
            plan = traffic.TrafficPlan(7, producers=1, groups=1,
                                       group_size=1, topics=["t"],
                                       partitions=1)
            d = driver.FleetDriver("127.0.0.1:9", plan, trace=True)
            try:
                made = bool(d.trace_dir and os.path.isdir(d.trace_dir))
                streamed = os.path.join(d.trace_dir,
                                        "tk_flight_111_0_fatal.json")
                with open(streamed, "w") as f:
                    json.dump({"traceEvents": [
                        {"name": "flight_record", "ph": "i", "pid": 111,
                         "tid": 0, "ts": 1.0,
                         "args": {"reason": "fatal"}}]}, f)
                d.flight_paths.append({"worker": "p00", "path": streamed})
                first = d.flight_dumps()
                orphan = os.path.join(d.trace_dir,
                                      "tk_flight_222_0_kill.json")
                with open(orphan, "w") as f:
                    json.dump({"traceEvents": []}, f)
                second = d.flight_dumps()
            finally:
                d.stop()

            def strip(recs):
                return [{k: (v if k != "path" else os.path.basename(v))
                         for k, v in r.items()} for r in recs]
            return {"made": made, "first": strip(first),
                    "second": strip(second),
                    "dirs": pkg.collect.active_dump_dir_count()}
        port, ref = both(scenario, serial=True)
        assert port == ref
        assert ref["made"] and ref["dirs"] == 0
        assert len(ref["first"]) == 1 and ref["first"][0]["worker"] == "p00"
        assert ref["first"][0]["events"] == 1
        assert ref["first"][0]["payload"]["traceEvents"][0]["args"] == \
            {"reason": "fatal"}
        swept = [r for r in ref["second"]
                 if r["path"] == "tk_flight_222_0_kill.json"]
        assert len(ref["second"]) == 2 and swept[0]["worker"] is None
        assert swept[0]["exists"] and swept[0]["events"] == 0


@pytest.mark.fleet
class TestFleetMergedTrace:
    def test_fleet_mini_one_perfetto_trace_many_processes(self, tmp_path):
        """fleet_mini with trace_path on each package (one after the
        other, at the reference's size): one merged Perfetto trace of
        >= 3 processes with a cross-process flow; the same process labels
        and report keys."""
        def scenario(pkg):
            path = str(tmp_path / f"fleet-{pkg.root}.json")
            r = pkg.mod("fleet.scenarios").fleet_mini(trace_path=path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            meta = {e["args"]["name"]: e["pid"] for e in events
                    if e.get("ph") == "M" and e["name"] == "process_name"}
            by_id: dict = {}
            for e in events:
                if e.get("ph") in ("s", "t", "f") and e.get("cat") == "flow":
                    by_id.setdefault(e["id"], set()).add(e["pid"])
            tr = r["trace"]
            return {"ok": r["ok"], "path": tr["path"] == path,
                    "processes": tr["processes"] >= 3,
                    "pids": len(tr["pids"]) >= 3,
                    "links": tr["flow_links"] >= 1
                    and pkg.collect.flow_link_count(events)
                    == tr["flow_links"],
                    "flight": isinstance(r["flight_dumps"], list),
                    "labels": sorted({n if not n.startswith("worker-")
                                      else "worker-*" for n in meta}),
                    "distinct": len(set(meta.values())) >= 3,
                    "err_us": all("clock_err_us" in e["args"]
                                  for e in events if e.get("ph") == "M"
                                  and e["name"] == "process_name"),
                    "crosses": any(len(p) >= 2 for p in by_id.values()),
                    "trace_keys": sorted(tr)}
        port, ref = both(scenario, serial=True)
        assert port == ref
        assert all(v for k, v in ref.items()
                   if k not in ("labels", "trace_keys"))
        assert {"fleet-driver", "supervisor", "worker-*"} <= \
            set(ref["labels"])


class TestRigTraces:
    def test_cluster_handle_collects_supervisor_and_relay_rings(self):
        """Each package's out-of-process rig: the trace verbs reach the
        supervisor and its relay; the dumps carry control and connection
        spans and merge with one label a process."""
        def scenario(pkg):
            h = pkg.external.ClusterHandle(brokers=1, topics={"rt": 1})
            try:
                h.trace_enable()
                host, port = h.bootstrap_servers().split(",")[0].rsplit(
                    ":", 1)
                s = socket.create_connection((host, int(port)), timeout=10)
                s.close()
                time.sleep(0.3)         # let the relay log the close
                dumps = h.collect_traces()
            finally:
                h.stop()
            sup = next(d for d in dumps if d.name == "supervisor")
            relay = next(d for d in dumps if d.name.startswith("relay-"))
            events = pkg.collect.merge(dumps)
            return {"names": sorted(d.name for d in dumps),
                    "pids": len({d.pid for d in dumps}) == len(dumps),
                    "err": all(d.err_ns >= 0 for d in dumps),
                    "ctl": any(e.get("name") == "ctl_cmd"
                               for e in sup.events),
                    "conn": any(e.get("name") in ("conn", "conn_setup")
                                for e in relay.events),
                    "labels": len([e for e in events if e.get("ph") == "M"
                                   and e["name"] == "process_name"])
                    == len(dumps)}
        port, ref = both(scenario, serial=True)
        assert port == ref
        assert "supervisor" in ref["names"]
        assert any(n.startswith("relay-") for n in ref["names"])
        assert all(v for k, v in ref.items() if k != "names")


class TestTraceviewMerge:
    """scripts/traceview.py's merge over dumps that each package's
    collector wrote from the same events: equal summaries."""

    def _dump(self, pkg, tmp_path, name, pid, spans):
        path = str(tmp_path / f"{name}-{pkg.root}.json")
        pkg.collect.write(path, [{"name": n, "ph": "X", "pid": pid,
                                  "tid": 0, "ts": ts, "dur": dur,
                                  "cat": "t"} for n, ts, dur in spans])
        return path

    def test_merge_files_labels_bare_dumps(self, tmp_path):
        tv = _load_traceview()

        def scenario(pkg):
            a = self._dump(pkg, tmp_path, "prod", 5, [("enqueue", 1.0, 10.0)])
            b = self._dump(pkg, tmp_path, "cons", 5,
                           [("deliver", 2.0, 20.0)])
            merged = tv.merge_files([a, b])
            meta = [e for e in merged if e.get("ph") == "M"]
            labels = sorted(m["args"]["name"].split("-")[0] for m in meta)
            return labels, len({m["pid"] for m in meta}), sorted(
                (p["name"], p["process"].split("-")[0])
                for p in tv.summarize(merged)["by_process"])
        port, ref = both(scenario, serial=True)
        assert port == ref == (["cons", "prod"], 2,
                               [("deliver", "cons"), ("enqueue", "prod")])

    def test_single_process_summary_unchanged(self, tmp_path):
        tv = _load_traceview()

        def scenario(pkg):
            a = self._dump(pkg, tmp_path, "solo", 1, [("enqueue", 1.0, 10.0)])
            s = tv.summarize(tv.load_events(a))
            return s["by_process"], s["stages"]
        port, ref = both(scenario, serial=True)
        assert port == ref
        assert ref[0] == [] and ref[1][0]["name"] == "enqueue"

    def test_merged_trace_from_fleet_summarizes(self, tmp_path):
        tv = _load_traceview()

        def scenario(pkg):
            path = str(tmp_path / f"labelled-{pkg.root}.json")
            pkg.collect.write(path, pkg.collect.merge([
                pkg.collect.ProcessDump("w0", 9, [
                    {"name": "ack", "ph": "X", "pid": 9, "tid": 0,
                     "ts": 1.0, "dur": 5.0, "cat": "produce"}])]))
            s = tv.summarize(tv.merge_files([path]))
            return s["by_process"], "per-process attribution" in tv.render(s)
        port, ref = both(scenario, serial=True)
        assert port == ref == ([{"name": "ack", "process": "w0", "cnt": 1,
                                 "p50_us": 5.0, "max_us": 5.0,
                                 "total_us": 5.0}], True)


# ------------------------------------------------- the port's card path --

def test_flight_dump_holds_engine_spans_before_a_timeout(tmp_path):
    """The flight recorder on a device-routed producer (the card check's
    shape at a small size): after one round through the engine a forced
    request timeout dumps rings holding that round's launch and readback
    spans and the timeout instant; both packages write the same span
    names and FLIGHT_MAX_DUMPS bounds the dumps."""
    def scenario(pkg):
        d = tmp_path / pkg.root
        d.mkdir()
        p = pkg.Producer(pkg.conf({**TRACED, "socket.max.fails": 0}))
        try:
            pkg.trace.flight_dir = str(d)
            for i in range(64):
                p.produce("fr", value=b"v%d" % i * 20, partition=i % 4)
            assert p.flush(120.0) == 0
            b = pkg.Broker(p._rk, 999, "127.0.0.1", 1)     # never started
            try:
                b.waitresp[7] = pkg.Request(
                    pkg.ApiKey.Metadata, {}, corrid=7,
                    abs_timeout=time.monotonic() - 1.0)
                b._scan_timeouts(time.monotonic())
            finally:
                b._wakeup_r.close()
                b._wakeup_w.close()
            path = pkg.trace.last_flight_path
            more = [pkg.trace.flight_record(f"bound-{i}")
                    for i in range(pkg.trace.FLIGHT_MAX_DUMPS)]
        finally:
            p.close()
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        _check_perfetto(evs)
        names = {e["name"] for e in evs if e["ph"] != "M"}
        return {"in_dir": os.path.dirname(path) == str(d),
                "names": sorted(names & {"device_launch", "readback",
                                         "request_timeout", "produce_tx",
                                         "ack", "flight_record"}),
                "files": len(os.listdir(d)),
                "bounded": sum(x is not None for x in more)}
    port, ref = both(scenario)
    assert port == ref
    assert ref["in_dir"]
    assert ref["names"] == ["ack", "device_launch", "flight_record",
                            "produce_tx", "readback", "request_timeout"]
    assert ref["files"] == REF.trace.FLIGHT_MAX_DUMPS
    assert ref["bounded"] == REF.trace.FLIGHT_MAX_DUMPS - 1


def test_hdr_windows_of_stats_obs_are_equal():
    """The obs section's windows summarise the same samples the same way
    in both packages (HdrHistogram percentiles of a seeded sample)."""
    samples = np.random.default_rng(12).lognormal(6, 1.2, 5000).astype(int)

    def scenario(pkg):
        mx = pkg.metrics
        mx.enable()
        try:
            w = mx.window("lat_us")
            for v in samples:
                w.record(int(v) + 1)
            return mx.snapshot()["windows"]
        finally:
            mx.disable()
    port, ref = both(scenario, serial=True)
    assert port == ref
    assert ref["lat_us"]["cnt"] == len(samples)
