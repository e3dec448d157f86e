"""The benchmark's exactly-once copy (``eos64-copy-1kb``, traffic kind
``eos_copy``) and the program's counters and spans it reads.

- a rehearsal of the cell on the kernels' plain versions
  (``--device cpu``) at a small size: four copiers over 8 partitions,
  4,000 records in a 5 s window, every check 0;
- the plain reference (``kbench/reference/eos.py``) against faults
  injected into that rehearsal's output logs, each raising its count;
- the configuration's control (read_uncommitted and a deliberate abort a
  member) failing ``aborted_visible``;
- the transaction spans and counters, and the consumer's fetch counters,
  with and without ``trace.enable``;
- the cell's three new readers on synthetic readings;
- the reference importing nothing of either package, nor JAX.
"""
from __future__ import annotations

import json
import os
import pickle
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from kbench.lib.records import POOL, make_pool
from kbench.reference import batch as B
from kbench.reference.crc32c import crc32c_many
from kbench.reference.eos import EOS_CHECKS, _records, check_eos, visible

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KB = os.path.join(ROOT, "kbench")
CELL = "eos64-copy-1kb"
SEED = 4294967377
#: the launch quorum above any round's blocks: the codec jobs are served
#: by the native CPU encoder and checksums, not by the kernels' plain
#: versions, whose hundreds of torch calls a round each wait for the GIL
#: beside eight clients' threads (up to minutes: a commit's flush would
#: time out)
SMALL = ["--seconds", "5", "--device", "cpu",
         "--param", "rate=800", "--param", "warmup_records=400",
         "--param", "partitions=8", "--conf", "gpu.launch.min.batches=64"]
NPARTS = 8


def _rehearse(script: str, dump: str, *extra: str) -> dict:
    t0 = time.monotonic()
    pr = subprocess.run(
        [sys.executable, os.path.join(KB, script), "--workload", CELL,
         "--seed", str(SEED), *SMALL, "--param", f"dump_to={json.dumps(dump)}",
         *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert pr.returncode == 0, pr.stderr[-3000:]
    with open(dump, "rb") as f:
        logs = pickle.load(f)
    return {"result": json.loads(pr.stdout.strip().splitlines()[-1]),
            "wall_s": time.monotonic() - t0, **logs}


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    return _rehearse("run.py", str(tmp_path_factory.mktemp("eos") / "d"),
                     "--trace", "1")


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    return _rehearse("control.py", str(tmp_path_factory.mktemp("eos") / "c"),
                     "--trace", "0", "--control", "read-uncommitted-abort")


# ------------------------------------------------------------ rehearsal --

def test_rehearsal_is_correct(rehearsal):
    res = rehearsal["result"]
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(EOS_CHECKS) | {"uncopied",
                                                     "aborted_visible"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    # the Poisson arrivals inside the window (counted from its entry):
    # 800 a second for 5 s and more
    assert 700 < res["extra"]["feeder_rate"] < 900
    assert res["attempted"] > 3600 and res["failed"] == 0
    ex = res["extra"]
    assert len(ex["commits_per_member"]) == 4
    assert all(n > 0 for n in ex["commits_per_member"]), ex
    assert ex["txn"]["txn_commits"] > 0
    assert ex["txn"]["txn_commits"] == ex["txn"]["txn_begins"]
    assert ex["rebalances_after_setup"] == 0
    # every record fed was committed; the slices held records
    cov = res["covered"]
    assert cov["records_committed"] > 400 + res["attempted"]
    assert cov["records_sampled"] > 0 and cov["hidden_batches"] == 0
    # traced: the cell's readers read (delivered > 0)
    m = res["metrics"]
    for k in ("txn_cpu_us", "consume_cpu_us", "fetch_device_share",
              "engine_thread_cpu_us.eos", "device_compress_share.eos"):
        assert k in m, (k, m)
    assert m["txn_cpu_us"]["value"] > 0 and m["consume_cpu_us"]["value"] > 0
    # no device trace off the card
    assert "lz4_rows_roofline.eos" not in m
    assert res["device"]["platform"] == "cpu"


# ------------------------------------------------- faults in the logs --

def _zz(v: int) -> bytes:
    """A zigzag varint."""
    v = (v << 1) ^ (v >> 63)
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _encode(b: B.Batch, recs: list, key=None) -> bytes:
    """``b`` re-encoded uncompressed with ``recs`` (offset deltas
    renumbered; ``key`` replaces the first record's key), its CRC
    recomputed."""
    body = b""
    for i, r in enumerate(recs):
        k = key if (key is not None and i == 0) else r.key
        rec = (b"\0" + _zz(r.timestamp_delta) + _zz(i) + _zz(len(k)) + k
               + _zz(len(r.value)) + r.value + _zz(0))
        body += _zz(len(rec)) + rec
    n = len(recs)
    head = B.HEADER.pack(b.base_offset, B.HEADER_SIZE - 12 + len(body),
                         b.leader_epoch, 2, 0, b.attributes & ~7, n - 1,
                         b.first_timestamp, b.max_timestamp, b.producer_id,
                         b.producer_epoch, b.base_sequence, n)
    raw = bytearray(head + body)
    crc = int(crc32c_many(bytes(raw), [B.CRC_START], [len(raw)])[0])
    struct.pack_into(">I", raw, 17, crc)
    return bytes(raw)


def _relog(start: int, blobs: list) -> tuple:
    """A partition's (start, end, log) from batch blobs, base offsets
    renumbered from ``start``."""
    out, off = b"", start
    for blob in blobs:
        n = struct.unpack_from(">i", blob, B.HEADER_SIZE - 4)[0]
        out += struct.pack(">q", off) + blob[8:]
        off += n
    return start, off, out


def _split(part: tuple) -> list:
    start, end, log = part
    return [(b, log[b.start:b.start + b.length])
            for b in B.iter_batches(log)]


def _data(batches: list) -> list:
    return [i for i, (b, _) in enumerate(batches) if not b.control]


def _markers(batches: list, kind: int) -> list:
    out = []
    for i, (b, blob) in enumerate(batches):
        if b.control:
            k = struct.unpack(">hh", _records(blob, _at0(b))[0].key)[1]
            if k == kind:
                out.append(i)
    return out


def _at0(b: B.Batch) -> B.Batch:
    """``b`` as the first batch of a log holding it alone."""
    return B.Batch(**{**b.__dict__, "start": 0})


def _rewrite(logs: dict, p: int, i: int, recs_fn=None, key=None,
             drop=False) -> dict:
    batches = _split(logs[p])
    blobs = [blob for _, blob in batches]
    b, blob = batches[i]
    if drop:
        del blobs[i]
    else:
        recs = _records(blob, _at0(b))
        blobs[i] = _encode(_at0(b), recs_fn(recs) if recs_fn else recs, key)
    out = dict(logs)
    out[p] = _relog(logs[p][0], blobs)
    return out


def _judge(logs: dict, committed: dict) -> tuple:
    pool = make_pool(SEED, 1024)
    return check_eos(logs, committed, nparts=NPARTS,
                     expect=lambda i: pool[i % POOL], codec="lz4",
                     rng=np.random.default_rng([SEED, 1]), slice_batches=10)


def _fault(name: str, d: dict) -> tuple:
    """(logs, committed) of the rehearsal with fault ``name`` put in."""
    logs, committed = dict(d["logs"]), dict(d["committed"])
    p = 3
    batches = _split(logs[p])
    first = _data(batches)[0]
    if name == "duplicate_record":
        return _rewrite(logs, p, first,
                        lambda rs: rs[:1] + rs), committed
    if name == "dropped_record":
        # its last record: the first held key still anchors the count
        return _rewrite(logs, p, first, lambda rs: rs[:-1]), committed
    if name == "aborted_relabelled":
        # the control's logs: an ABORT marker turned into a COMMIT
        for q in sorted(logs):
            aborts = _markers(_split(logs[q]), 0)
            if aborts:
                return _rewrite(logs, q, aborts[0],
                                key=struct.pack(">hh", 0, 1)), committed
        raise AssertionError("no ABORT marker in the control's logs")
    if name == "flipped_byte":
        b, _ = batches[first]
        start, end, log = logs[p]
        raw = bytearray(log)
        raw[b.start + B.HEADER_SIZE + 5] ^= 0x01
        logs[p] = (start, end, bytes(raw))
        return logs, committed
    if name == "removed_commit":
        last = _markers(batches, 1)[-1]
        return _rewrite(logs, p, last, drop=True), committed
    if name == "offset_off_by_one":
        committed[p] += 1
        return logs, committed
    raise KeyError(name)


#: each fault and the count it must raise
FAULTS = {"duplicate_record": "count_bad", "dropped_record": "count_bad",
          "aborted_relabelled": "count_bad", "flipped_byte": "crc_bad",
          "removed_commit": "count_bad", "offset_off_by_one": "offsets_bad"}


def test_reference_passes_the_rehearsals_logs(rehearsal):
    counts, covered, hidden = _judge(rehearsal["logs"],
                                     rehearsal["committed"])
    assert counts == dict.fromkeys(EOS_CHECKS, 0)
    assert hidden == {}
    assert covered == {k: v for k, v in rehearsal["result"]["covered"].items()
                       if k != "hidden_batches"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_reference_counts_an_injected_fault(fault, rehearsal, control):
    d = control if fault == "aborted_relabelled" else rehearsal
    clean, _, _ = _judge(d["logs"], d["committed"])
    counts, _, _ = _judge(*_fault(fault, d))
    assert counts[FAULTS[fault]] > clean[FAULTS[fault]], counts


def test_visible_counts_hidden_offsets():
    hidden = {0: [(10, 19)], 2: [(5, 5), (40, 41)]}
    assert visible(hidden, {0: [9, 10, 19, 20], 2: [5, 41], 1: [10]}) == 4
    assert visible(hidden, {0: [], 2: [6]}) == 0


# -------------------------------------------------------------- control --

def test_control_shows_aborted_records(control):
    res = control["result"]
    assert res["correct"] is False
    assert res["checks"]["aborted_visible"]["value"] > 0
    assert res["extra"]["aborted_on_purpose"] == 4
    assert res["covered"]["hidden_batches"] > 0
    # the copy itself stayed exactly once: only the control's guarantee
    # broke
    bad = {k for k, c in res["checks"].items() if c["value"]}
    assert bad == {"aborted_visible"}, res["checks"]


# ------------------------------------------------- the program's counters --

def _cluster():
    from librdkafka_tpu_torch.mock.cluster import MockCluster
    return MockCluster(num_brokers=1, topics={"in": 2, "out": 2})


def _txn_round(traced: bool) -> tuple:
    from librdkafka_tpu_torch import Producer
    from librdkafka_tpu_torch.client.consumer import TopicPartition
    from librdkafka_tpu_torch.obs import trace
    cl = _cluster()
    try:
        p = Producer({"bootstrap.servers": cl.bootstrap_servers(),
                      "transactional.id": "tx-count", "linger.ms": 2,
                      "trace.enable": traced})
        try:
            p.init_transactions(30)
            p.begin_transaction()
            for i in range(20):
                p.produce("out", b"v%d" % i, partition=i % 2)
            p.send_offsets_to_transaction([TopicPartition("in", 0, 20)],
                                          "g-count", 30)
            p.commit_transaction(30)
            p.begin_transaction()
            p.produce("out", b"x", partition=0)
            p.flush(30)
            p.abort_transaction(30)
            tm = p._rk.txnmgr
            counts = {k: getattr(tm, k) for k in (
                "begins", "commits", "aborts", "commit_wall_ns", "cpu_ns")}
            blob = json.loads(p._rk.stats.emit_json())["eos"]
            spans = [e for e in trace.collect_events()
                     if e.get("cat") == "txn"]
        finally:
            p.close()
    finally:
        cl.stop()
    return counts, blob, spans


def test_txn_spans_and_counters_while_tracing():
    counts, blob, spans = _txn_round(True)
    assert counts["begins"] == 2 and counts["commits"] == 1
    assert counts["aborts"] == 1
    assert counts["commit_wall_ns"] > 0 and counts["cpu_ns"] > 0
    assert blob["txn_commits"] == 1 and blob["txn_cpu_ns"] > 0
    names = [e["name"] for e in spans]
    assert names.count("begin") == 2 and names.count("commit") == 1
    assert names.count("abort") == 1 and names.count("send_offsets") == 1
    assert "add_partitions" in names
    commit = next(e for e in spans if e["name"] == "commit")
    assert {"flush_ns", "end_txn_ns"} <= set(commit["args"])
    assert commit["dur"] * 1e3 >= commit["args"]["end_txn_ns"]


def test_txn_counters_without_tracing():
    counts, blob, spans = _txn_round(False)
    assert counts["begins"] == 2 and counts["commits"] == 1
    assert counts["aborts"] == 1 and counts["commit_wall_ns"] > 0
    assert counts["cpu_ns"] == 0 and blob["txn_cpu_ns"] == 0
    assert spans == []


def test_coordinators_are_looked_up_once_a_key():
    """Three transactions with offsets make one FindCoordinator for the
    transactional id and one for the group, not one a request."""
    from librdkafka_tpu_torch import Producer
    from librdkafka_tpu_torch.client.consumer import TopicPartition
    from librdkafka_tpu_torch.protocol.apis import ApiKey
    cl = _cluster()
    try:
        p = Producer({"bootstrap.servers": cl.bootstrap_servers(),
                      "transactional.id": "tx-coord", "linger.ms": 2})
        try:
            p.init_transactions(30)
            for k in range(3):
                p.begin_transaction()
                p.produce("out", b"v%d" % k, partition=k % 2)
                p.send_offsets_to_transaction(
                    [TopicPartition("in", 0, k + 1)], "g-coord", 30)
                p.commit_transaction(30)
            assert p._rk.txnmgr.commits == 3
        finally:
            p.close()
        finds = [a for _, a in cl.request_log
                 if a == int(ApiKey.FindCoordinator)]
        ends = [a for _, a in cl.request_log if a == int(ApiKey.EndTxn)]
    finally:
        cl.stop()
    assert len(ends) == 3
    assert len(finds) == 2


@pytest.mark.parametrize("backend,traced", [("cpu", False), ("gpu", True)])
def test_fetch_counters(backend, traced):
    from librdkafka_tpu_torch import Consumer, Producer
    cl = _cluster()
    try:
        p = Producer({"bootstrap.servers": cl.bootstrap_servers(),
                      "compression.codec": "lz4", "linger.ms": 5})
        try:
            for i in range(200):
                p.produce("in", b"v%04d" % i * 50, partition=i % 2)
            assert p.flush(30) == 0
        finally:
            p.close()
        conf = {"bootstrap.servers": cl.bootstrap_servers(),
                "group.id": "g-fetch", "auto.offset.reset": "earliest",
                "check.crcs": True, "trace.enable": traced}
        if backend == "gpu":
            conf.update({"compression.backend": "gpu", "gpu.device": "cpu",
                         "gpu.governor": False,
                         "gpu.launch.min.batches": 1})
        c = Consumer(conf)
        try:
            c.subscribe(["in"])
            got, end = 0, time.monotonic() + 30
            while got < 200 and time.monotonic() < end:
                got += len(c.consume(100, 0.2))
            rk = c._rk
            with rk._brokers_lock:
                brokers = list(rk.brokers.values())
            dev = sum(b.c_fetch_crc_bytes_device for b in brokers)
            host = sum(b.c_fetch_crc_bytes_host for b in brokers)
            cpu_ns = rk.fetch_cpu_ns
            stats = json.loads(rk.stats.emit_json())["brokers"]
            # a broker thread's tally goes out 100 ms after its last one
            c.consume(1, 0.3)
            from librdkafka_tpu_torch.obs import trace
            phases = {k for e in trace.collect_events()
                      if e.get("name") == "pass_tally"
                      for k in e["args"]["cpu_ns"]}
        finally:
            c.close()
    finally:
        cl.stop()
    # the fetch responses' handling has a tally phase of its own
    if traced:
        assert "fetch_recv" in phases, phases
    assert got == 200
    assert sum(b["fetch_crc_bytes_device"] + b["fetch_crc_bytes_host"]
               for b in stats.values()) == dev + host
    if backend == "cpu":
        assert dev == 0 and host > 0
    else:
        assert dev > 0 and host == 0
    assert (cpu_ns > 0) if traced else (cpu_ns == 0)


# --------------------------------------------------------------- readers --

def _reader(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kbench_eos_test_" + name, os.path.join(KB, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _readings(**kw):
    from kbench.lib.harness import Readings
    return Readings(seconds=30.0, **kw)


def _tally(cpu_ns: dict, tid: int = 1, dropped: int = 0) -> dict:
    return {"name": "pass_tally", "cat": "broker", "ph": "X", "ts": 1e6,
            "dur": 0.0, "tid": tid,
            "args": {"cpu_ns": cpu_ns, "dropped": dropped, "passes": 3}}


def test_txn_cpu_us_reads_the_counter():
    read = _reader("txn_cpu_us")
    txn = {"txn_cpu_ns": 3_000_000_000, "txn_commits": 1200}
    assert read(_readings(spans=[], delivered=600_000,
                          extra={"txn": txn})) == 5.0
    assert read(_readings(delivered=600_000, extra={"txn": txn})) is None
    assert read(_readings(spans=[], delivered=600_000,
                          extra={"txn": {"txn_commits": 1}})) is None
    assert read(_readings(spans=[], delivered=0, extra={"txn": txn})) is None
    assert read(_readings(spans=[], delivered=5)) is None


def test_consume_cpu_us_sums_poll_and_the_fetch_phase():
    read = _reader("consume_cpu_us")
    spans = [_tally({"fetch": 1_000_000_000, "fetch_recv": 1_000_000_000,
                     "recv": 9}),
             _tally({"fetch": 1_000_000_000}, tid=2)]
    fetch = {"fetch_cpu_ns": 3_000_000_000}
    assert read(_readings(spans=spans, delivered=1_000_000,
                          extra={"fetch": fetch})) == 6.0
    # a trail that lost tallies, no tallies, no counter, untraced
    lost = spans + [_tally({"fetch": 1}, tid=2, dropped=5)]
    assert read(_readings(spans=lost, delivered=1_000_000,
                          extra={"fetch": fetch})) is None
    assert read(_readings(spans=[], delivered=1_000_000,
                          extra={"fetch": fetch})) is None
    assert read(_readings(spans=spans, delivered=1_000_000)) is None
    assert read(_readings(delivered=1_000_000,
                          extra={"fetch": fetch})) is None


def test_copier_thread_cpu_us_reads_the_members_threads():
    read = _reader("copier_thread_cpu_us")
    threads = {"eos-copier-N": 3.0, "rdk:broker/N": 9.0, "MainThread": 1.0}
    assert read(_readings(thread_cpu_s=threads, delivered=1_000_000)) == 3.0
    assert read(_readings(thread_cpu_s={"MainThread": 1.0},
                          delivered=1_000_000)) is None
    assert read(_readings(thread_cpu_s=threads, delivered=0)) is None
    assert read(_readings(delivered=1_000_000)) is None


def test_fetch_device_share_reads_both_counters():
    read = _reader("fetch_device_share")
    f = {"fetch_crc_bytes_device": 300, "fetch_crc_bytes_host": 900}
    assert read(_readings(extra={"fetch": f})) == 25.0
    assert read(_readings(extra={"fetch": {"fetch_crc_bytes_device": 3}})) \
        is None
    assert read(_readings()) is None
    assert read(_readings(extra={"fetch": {"fetch_crc_bytes_device": 0,
                                           "fetch_crc_bytes_host": 0}})) \
        is None


# ------------------------------------------------------ the reference --

def test_reference_imports_neither_package_nor_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import kbench.reference.eos; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    pr = subprocess.run([sys.executable, "-c", code, ROOT], cwd=ROOT,
                        capture_output=True, text=True, timeout=120)
    assert pr.returncode == 0, pr.stderr
    loaded = set(json.loads(pr.stdout.replace("'", '"')))
    assert "kbench" in loaded
    assert not loaded & {"librdkafka_tpu_torch", "librdkafka_tpu", "jax",
                         "jaxlib", "torch"}, loaded
