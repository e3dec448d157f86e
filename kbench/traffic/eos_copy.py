"""Exactly-once copy: librdkafka's examples/transactions.c, the
consume-transform-produce loop, run by ``copiers`` members of one
consumer group, threads of the client's process, while a feeder process
(``kbench/feeder.py``, the upstream producers) writes the input topic at
a fixed rate.

Each member is a consumer of the input topic and a transactional
producer (``transactional.id`` = the group id and the member's index),
both built from the configuration.  It consumes, produces each record's
key and value to the same partition of the output topic and, every
``commit_ms`` if it copied anything since, sends the positions of the
partitions it read with the group's metadata
(``send_offsets_to_transaction``) and commits (``commit_transaction``).
Every blocking call has a timeout: a timeout fails the run.

Set-up: the broker process (which makes the input topic), the output
topic through the program's AdminClient, the feeder, the members' clients
(each GPU provider warm) and one stable assignment of the partitions
spread evenly over the members.  Then ``warmup_records`` fed at even
gaps at ``rate`` and committed, and the feeder's open_produce Poisson
arrivals at ``rate`` (the same gaps for every seed), which start
``LEAD_S`` before the window, so that it opens on a copy in its steady
state, and run ``TAIL_S`` past it, traced or not.  With ``--trace 1``
the device profiler is started and stopped once first, in set-up: its
first start holds every thread for seconds, and beside the running copy
it stalled the members.  A record counts as
delivered when the ``commit_transaction`` that holds it returns inside
the window, counted from the window's entry, where the harness reads the
client's CPU (it sets the window's start seconds later).  After it: a drain of up to 60 s in which the members copy
what was fed, the members' close, the group's committed offsets read by
a fresh consumer, and the output topic judged by
:func:`kbench.reference.eos.check_eos`; ``uncopied`` counts the records
due before the window's end and not committed after the drain, and
``aborted_visible`` the records of aborted or open transactions that a
consumer of the configuration's ``isolation.level`` returns.

A configuration's control may set ``eos_copy.aborts`` among its producer
keys: the transactions each member aborts on purpose at its first commit
points (it flushes, aborts and seeks back to its committed offsets, as
transactions.c does on an error).  It is taken out before the producer
is built.

Workload parameters: ``width``, ``copiers``, ``rate``, ``commit_ms``,
``warmup_records``, ``slice_batches``; for the tests only,
``partitions`` (over the configuration's, for small sizes) and
``dump_to`` (a file to pickle the output topic's logs and the committed
offsets into, for faults to be injected into).
"""
from __future__ import annotations

import json
import os
import pickle
import select
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

from kbench.feeder import arrivals
from kbench.lib.delivery import queue_full
from kbench.lib.harness import KBENCH, ROOT
from kbench.lib.records import POOL, make_pool
from kbench.reference.eos import check_eos, visible

#: seconds any one blocking call of the program may take
TIMEOUT = 30.0
#: records a consume() call takes at most
TAKE = 1000
#: the drain after the window, and the set-up's waits
DRAIN_S = 60.0
WAIT_S = 120.0
#: a stable assignment holds this long unchanged
STABLE_S = 0.5
#: the feeder's Poisson part starts this long before the window, so
#: that the window opens on a copy in its steady state, and runs this
#: long past the window's planned end (the harness takes seconds to open
#: a window beside a busy copy)
LEAD_S = 6.0
TAIL_S = 5.0
ABORTS_KEY = "eos_copy.aborts"


class RunError(RuntimeError):
    """The copy could not go on: a member failed or a wait timed out."""


class Feeder:
    """``kbench/feeder.py`` in its own process."""

    def __init__(self, h, bootstrap: str, topic: str):
        cfg = h.cfg
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(KBENCH, "feeder.py"),
             "--bootstrap", bootstrap, "--topic", topic,
             "--partitions", str(cfg["partitions"]),
             "--width", str(h.cell["traffic_params"]["width"]),
             "--seed", str(h.seed), "--conf", json.dumps(cfg["feeder"])],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT)

    def read(self, timeout: float) -> dict:
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout)
        line = self.proc.stdout.readline() if ready else b""
        if not line:
            raise RunError("the feeder did not answer")
        return json.loads(line)

    def send(self, cmd: str) -> None:
        self.proc.stdin.write(cmd.encode() + b"\n")
        self.proc.stdin.flush()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send("quit")
                self.proc.stdin.close()
                self.proc.wait(30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait(30)
        self.proc.stdout.close()


class Copier(threading.Thread):
    """One member: transactions.c's loop over its own two clients."""

    def __init__(self, k: int, c, p, topics: tuple, commit_s: float,
                 aborts: int, stop: threading.Event):
        super().__init__(name=f"eos-copier-{k}", daemon=True)
        self.k, self.c, self.p = k, c, p
        self.src, self.dst = topics
        self.commit_s, self.aborts_left, self.stop = commit_s, aborts, stop
        self.lock = threading.Lock()
        self.assigned: set = set()
        self.assign_changes = 0
        self.offsets: dict = {}             # input partition -> committed
        self.commits: list = []             # (returned at, records, ms)
        self.aborted = 0
        self.error = None

    def _assign(self, cons, parts) -> None:
        cons.incremental_assign(parts)
        with self.lock:
            self.assigned |= {tp.partition for tp in parts}
            self.assign_changes += 1

    def _revoke(self, cons, parts) -> None:
        cons.incremental_unassign(parts)
        with self.lock:
            self.assigned -= {tp.partition for tp in parts}
            self.assign_changes += 1

    def run(self) -> None:
        try:
            self._loop()
        except Exception:
            self.error = traceback.format_exc()

    def _produce(self, m) -> None:
        p = self.p
        while True:
            try:
                p.produce(self.dst, value=m.value, key=m.key,
                          partition=m.partition)
                return
            except Exception as e:
                if not queue_full(e):
                    raise
                p.poll(0.001)

    def _loop(self) -> None:
        from librdkafka_tpu_torch.client.consumer import TopicPartition
        c, p = self.c, self.p
        p.init_transactions(TIMEOUT)
        c.subscribe([self.src], on_assign=self._assign,
                    on_revoke=self._revoke)
        p.begin_transaction()
        n, read = 0, set()
        due = time.monotonic() + self.commit_s
        while not self.stop.is_set():
            msgs = c.consume(TAKE, max(0.0, min(due - time.monotonic(),
                                                0.05)))
            for m in msgs:
                if m.error is not None:
                    raise RunError(f"member {self.k}: consume: {m.error}")
                self._produce(m)
                read.add(m.partition)
            n += len(msgs)
            if time.monotonic() < due:
                continue
            due = time.monotonic() + self.commit_s
            if not n:
                continue
            if self.aborts_left:
                self._abort(TopicPartition)
            else:
                self._commit(TopicPartition, n, read)
            n, read = 0, set()
            p.begin_transaction()
        if n:
            self._commit(TopicPartition, n, read)

    def _commit(self, TopicPartition, n: int, read: set) -> None:
        """Commit the open transaction: the positions of the partitions
        it read (after a rewind, position() of a partition not read since
        still names the offset delivered before it), then the records."""
        c, p = self.c, self.p
        offs = [tp for tp in c.position(
            [TopicPartition(self.src, q) for q in sorted(read)])
            if tp.offset >= 0]
        p.send_offsets_to_transaction(offs, c.consumer_group_metadata(),
                                      TIMEOUT)
        t0 = time.perf_counter()
        p.commit_transaction(TIMEOUT)
        t1 = time.perf_counter()
        with self.lock:
            self.commits.append((t1, n, (t1 - t0) * 1e3))
            for tp in offs:
                self.offsets[tp.partition] = tp.offset

    def _abort(self, TopicPartition) -> None:
        """Abort the open transaction on purpose (a control's), its
        records stored first, and rewind to the committed offsets."""
        from librdkafka_tpu_torch.protocol.proto import OFFSET_BEGINNING
        c, p = self.c, self.p
        if p.flush(TIMEOUT):
            raise RunError(f"member {self.k}: flush before abort timed out")
        p.abort_transaction(TIMEOUT)
        self.aborts_left -= 1
        self.aborted += 1
        for tp in c.committed(c.assignment(), TIMEOUT):
            c.seek(TopicPartition(self.src, tp.partition,
                                  tp.offset if tp.offset >= 0
                                  else OFFSET_BEGINNING))


class Copy:
    """The members and what they committed."""

    def __init__(self, copiers: list):
        self.copiers = copiers

    def check(self) -> None:
        for m in self.copiers:
            if m.error:
                raise RunError(f"member {m.k} failed:\n{m.error}")
            if not m.is_alive():
                raise RunError(f"member {m.k} stopped")

    def wait(self, cond, what: str, timeout: float) -> None:
        end = time.monotonic() + timeout
        while not cond():
            self.check()
            if time.monotonic() > end:
                raise RunError(f"timed out waiting for {what}")
            time.sleep(0.02)

    def assignment(self) -> tuple:
        out = []
        for m in self.copiers:
            with m.lock:
                out.append((frozenset(m.assigned), m.assign_changes))
        return tuple(out)

    def offsets(self) -> dict:
        out: dict = {}
        for m in self.copiers:
            with m.lock:
                for q, off in m.offsets.items():
                    out[q] = max(out.get(q, 0), off)
        return out

    def commits(self) -> list:
        out = []
        for m in self.copiers:
            with m.lock:
                out += m.commits
        return sorted(out)


def _warm_profiler(device: str) -> None:
    """Start and stop the device profiler once: its first start (8.8 to
    19.7 s on an H100) holds every thread, so it is taken here, before
    the members join, and the window's own start is short."""
    from kbench.lib import devtrace
    handle = devtrace.start(device)
    if handle is not None:
        handle[0].stop()


def _fed(n: int, nparts: int) -> np.ndarray:
    """The first ``n`` records of the input by partition."""
    return np.bincount(np.arange(n) % nparts, minlength=nparts)


def counters(producers, consumers) -> tuple[dict, dict]:
    """The program's transaction counters summed over ``producers`` and
    its fetch counters over ``consumers``; a counter the program does
    not keep is left out."""
    txn: dict = {}
    for p in producers:
        tm = getattr(p._rk, "txnmgr", None)
        for k in ("begins", "commits", "aborts", "commit_wall_ns",
                  "cpu_ns"):
            v = getattr(tm, k, None)
            if isinstance(v, int):
                txn["txn_" + k] = txn.get("txn_" + k, 0) + v
    fetch: dict = {}
    for c in consumers:
        rk = c._rk
        v = getattr(rk, "fetch_cpu_ns", None)
        if isinstance(v, int):
            fetch["fetch_cpu_ns"] = fetch.get("fetch_cpu_ns", 0) + v
        with rk._brokers_lock:
            brokers = list(rk.brokers.values())
        for b in brokers:
            for k in ("fetch_crc_bytes_device", "fetch_crc_bytes_host"):
                v = getattr(b, "c_" + k, None)
                if isinstance(v, int):
                    fetch[k] = fetch.get(k, 0) + v
    return txn, fetch


def tally_sums(spans: list) -> dict:
    """The window's ``pass_tally`` (broker threads) and ``codec_tally``
    (codec workers) events summed: passes, idle passes and CPU seconds
    by phase."""
    out: dict = {}
    for e in spans:
        if e["name"] not in ("pass_tally", "codec_tally"):
            continue
        a = e["args"]
        d = out.setdefault(e["name"], {"passes": 0, "idle_passes": 0,
                                       "cpu_s": {}})
        d["passes"] += a.get("passes", 0)
        d["idle_passes"] += a.get("idle_passes", 0)
        for k, v in a.get("cpu_ns", {}).items():
            d["cpu_s"][k] = d["cpu_s"].get(k, 0.0) + v / 1e9
    return out


def txn_spans(spans: list) -> dict:
    """The median of the window's transaction spans (category ``txn``) by
    name, and of a commit's parts (``commit.flush``, ``commit.end_txn``),
    in ms."""
    got: dict = {}
    for e in spans:
        if e.get("cat") != "txn":
            continue
        got.setdefault(e["name"], []).append(e["dur"] / 1e3)
        for part in ("flush", "end_txn"):
            ns = (e.get("args") or {}).get(part + "_ns")
            if ns is not None:
                got.setdefault(f"commit.{part}", []).append(ns / 1e6)
    return {k: float(np.median(v)) for k, v in sorted(got.items())}


def _delta(a: dict, b: dict) -> dict:
    return {k: v - a.get(k, 0) for k, v in b.items()}


def run(h) -> None:
    from librdkafka_tpu_torch import AdminClient, Consumer, NewTopic, Producer
    from librdkafka_tpu_torch.client.consumer import TopicPartition

    t = h.cell["traffic_params"]
    cfg = h.cfg
    if "partitions" in t:             # the tests' small sizes only
        cfg["partitions"] = int(t["partitions"])
    nparts = cfg["partitions"]
    src, dst = cfg["topics"]["input"], cfg["topics"]["output"]
    rate = float(t["rate"])
    members = int(t["copiers"])
    warm = int(t["warmup_records"]) // nparts * nparts
    pool = make_pool(h.seed, t["width"])
    if h.trace:
        _warm_profiler(h.device)
    broker = h.broker(src)
    h.mark("broker")
    admin = AdminClient({"bootstrap.servers": broker.bootstrap})
    try:
        fut = admin.create_topics([NewTopic(dst, nparts, 1)])[dst]
        fut.result(TIMEOUT)
    finally:
        admin.close()
    feeder = Feeder(h, broker.bootstrap, src)
    try:
        _run(h, t, broker, feeder, pool, members, warm, rate, (src, dst),
             Consumer, Producer, TopicPartition)
    finally:
        feeder.close()


def _run(h, t, broker, feeder, pool, members, warm, rate, topics,
         Consumer, Producer, TopicPartition) -> None:
    cfg = h.cfg
    nparts = cfg["partitions"]
    src, dst = topics
    group = cfg["consumer"]["group.id"]
    stop = threading.Event()
    copiers, producers, consumers = [], [], []
    for k in range(members):
        pconf = h.client_conf("producer", broker.bootstrap,
                              **{"transactional.id": f"{group}-{k}"})
        aborts = int(pconf.pop(ABORTS_KEY, 0))
        p = h.own(Producer(pconf))
        c = h.own(Consumer(h.client_conf("consumer", broker.bootstrap)))
        producers.append(p)
        consumers.append(c)
        copiers.append(Copier(k, c, p, topics, t["commit_ms"] / 1e3,
                              aborts, stop))
    for cl in producers + consumers:
        prov = cl._rk.codec_provider
        if hasattr(prov, "wait_warm") and not prov.wait_warm(300.0):
            raise RunError("a GPU provider did not warm")
    if feeder.read(WAIT_S).get("ready") is not True:
        raise RunError("the feeder did not start")
    h.mark("clients")
    copy = Copy(copiers)
    try:
        for m in copiers:
            m.start()

        def even() -> bool:
            got = [a for a, _ in copy.assignment()]
            return (sum(map(len, got)) == nparts
                    and len(frozenset().union(*got)) == nparts
                    and {len(a) for a in got} == {nparts // members})
        copy.wait(even, "an even assignment", WAIT_S)
        # stable: the assignment unchanged for STABLE_S
        while True:
            before = copy.assignment()
            time.sleep(STABLE_S)
            if copy.assignment() == before and even():
                break
            copy.wait(even, "an even assignment", WAIT_S)
        h.mark("assigned")
        n_rebalance0 = sum(n for _, n in copy.assignment())
        feeder.send(f"warm {warm} {rate}")
        res = feeder.read(WAIT_S)
        if res["acked"] != warm or res["failed"]:
            raise RunError(f"the feeder's warm-up: {res}")
        per = warm // nparts
        copy.wait(lambda: (len(o := copy.offsets()) == nparts
                           and min(o.values()) >= per),
                  "the warm-up's commits", WAIT_S)
        h.mark("copied")
        # the Poisson part: LEAD_S before the window, TAIL_S after it;
        # when each record of the stream is due, in time.perf_counter()
        # (the feeder's clock is time.monotonic())
        span = h.seconds + LEAD_S + TAIL_S
        feeder.send(f"open {rate} {span}")
        shift = time.monotonic() - time.perf_counter()
        t_open = feeder.read(TIMEOUT)["t0"] - shift
        due = np.concatenate([np.full(warm, -np.inf),
                              t_open + arrivals()(h.seed, rate, span)])
        while (now := time.perf_counter()) < t_open + LEAD_S:
            copy.check()
            time.sleep(min(0.05, t_open + LEAD_S - now))
        h.setup_done()
        _window(h, t, broker, feeder, copy, producers, consumers, pool,
                due, topics, n_rebalance0, stop, Consumer, TopicPartition)
    finally:
        stop.set()
        for m in copiers:
            m.join(TIMEOUT * 3)


def _window(h, t, broker, feeder, copy, producers, consumers, pool, due,
            topics, n_rebalance0, stop, Consumer, TopicPartition) -> None:
    """``due``: when each record of the feeder's stream is due
    (perf_counter)."""
    cfg = h.cfg
    nparts = cfg["partitions"]
    src, dst = topics
    txn0, fetch0 = counters(producers, consumers)
    # the harness reads the client's CPU as the window opens, then every
    # thread's (seconds beside a busy copy) and only then sets w.t0: the
    # records count from where the CPU does
    t_enter = time.perf_counter()
    with h.window(producers + consumers) as w:
        while (now := time.perf_counter()) < w.deadline:
            copy.check()
            time.sleep(min(0.1, w.deadline - now))
        txn1, fetch1 = counters(producers, consumers)
    # the window's entry to its start (traced: the profiler's start)
    h.r.extra["window_open_s"] = w.t0 - t_enter
    h.r.extra["txn"] = _delta(txn0, txn1)
    h.r.extra["fetch"] = _delta(fetch0, fetch1)
    if h.r.spans is not None:
        h.r.extra["tallies"] = tally_sums(h.r.spans)
        h.r.extra["txn_span_ms_p50"] = txn_spans(h.r.spans)
    commits = copy.commits()
    inside = [(t1, n, ms) for t1, n, ms in commits
              if t_enter <= t1 <= w.deadline]
    h.r.delivered = sum(n for _, n, _ in inside)
    # the backlog: records due but not committed, at the window's start,
    # middle and end
    for name, at in (("backlog_start", w.t0),
                     ("backlog_mid", w.t0 + h.seconds / 2),
                     ("backlog_end", w.deadline)):
        h.r.extra[name] = int(np.sum(due <= at) - sum(
            n for t1, n, _ in commits if t1 <= at))
    fed = feeder.read(TAIL_S + 2 * DRAIN_S)
    ms = [x for _, _, x in inside]
    if ms:
        h.r.extra["txn_commit_ms_p50"] = float(np.percentile(ms, 50))
        h.r.extra["txn_commit_ms_p99"] = float(np.percentile(ms, 99))
        h.r.extra["records_per_txn"] = h.r.delivered / len(inside)
    h.r.extra["commits_per_member"] = [
        sum(1 for t1, _, _ in m.commits if t_enter <= t1 <= w.deadline)
        for m in copy.copiers]
    offered = int(np.sum((due >= t_enter) & (due <= w.deadline)))
    h.r.extra["feeder_rate"] = offered / (w.deadline - t_enter)
    h.r.extra["feeder_lag_p99_ms"] = fed["lag_p99_ms"]
    # the drain: every record fed copied, or DRAIN_S
    want = _fed(fed["sent"], nparts)
    t_drain = time.monotonic()
    end = t_drain + DRAIN_S
    while time.monotonic() < end:
        copy.check()
        got = copy.offsets()
        if all(got.get(q, 0) >= want[q] for q in range(nparts)):
            break
        time.sleep(0.05)
    h.r.extra["drain_s"] = time.monotonic() - t_drain
    # records committed in each second from the window's start
    h.r.extra["committed_per_s"] = np.histogram(
        [t1 - w.t0 for t1, _, _ in copy.commits()],
        bins=np.arange(int(h.seconds) + 3),
        weights=[n for _, n, _ in copy.commits()])[0].astype(int).tolist()
    got = copy.offsets()
    before_end = _fed(int(np.sum(due <= w.deadline)), nparts)
    uncopied = int(sum(max(0, int(before_end[q]) - got.get(q, 0))
                       for q in range(nparts)))
    h.r.extra["rebalances_after_setup"] = (
        sum(n for _, n in copy.assignment()) - n_rebalance0)
    h.r.extra["aborted_on_purpose"] = sum(m.aborted for m in copy.copiers)
    stop.set()
    for m in copy.copiers:
        m.join(TIMEOUT * 3)
        if m.is_alive():
            raise RunError(f"member {m.k} did not stop")
        if m.error:
            raise RunError(f"member {m.k} failed:\n{m.error}")
    for cl in consumers + producers:
        h.drop(cl)
    h.attempted = offered
    h.failed = uncopied + fed["failed"]
    h.check("uncopied", uncopied, 0)
    t_ref = time.perf_counter()
    # a fresh consumer of the configuration: the group's committed
    # offsets, then what it returns of aborted or open transactions
    v = h.own(Consumer(h.client_conf(
        "consumer", broker.bootstrap, **{"compression.backend": "cpu"})))
    committed = {tp.partition: tp.offset for tp in v.committed(
        [TopicPartition(src, q) for q in range(nparts)], TIMEOUT)}
    logs = broker.dump(dst)
    if t.get("dump_to"):              # the tests' fault injection only
        with open(t["dump_to"], "wb") as f:
            pickle.dump({"logs": logs, "committed": committed}, f)
    counts, h.covered, hidden = check_eos(
        logs, committed, nparts=nparts,
        expect=lambda i: pool[i % POOL],
        codec=cfg["producer"]["compression.codec"],
        rng=np.random.default_rng([h.seed, 1]),
        slice_batches=t["slice_batches"])
    h.covered["hidden_batches"] = sum(map(len, hidden.values()))
    seen = _read_hidden(v, dst, hidden, TopicPartition)
    h.drop(v)
    h.r.extra["reference_s"] = time.perf_counter() - t_ref
    for k, val in counts.items():
        h.check(k, val, 0)
    h.check("aborted_visible", visible(hidden, seen), 0)


def _read_hidden(v, topic: str, hidden: dict, TopicPartition) -> dict:
    """The offsets ``v`` returns from the first to the last offset of
    each partition's ``hidden`` batches."""
    seen: dict = {p: [] for p in hidden}
    if not hidden:
        return seen
    last = {p: max(z for _, z in spans) for p, spans in hidden.items()}
    v.assign([TopicPartition(topic, p, min(a for a, _ in spans))
              for p, spans in hidden.items()])
    end = time.monotonic() + TIMEOUT
    quiet = time.monotonic() + 3.0
    while time.monotonic() < min(end, quiet):
        for m in v.consume(TAKE, 0.1):
            if m.error is None and m.partition in seen:
                seen[m.partition].append(m.offset)
                quiet = time.monotonic() + 3.0
        pos = v.position([TopicPartition(topic, p) for p in hidden])
        if all(tp.offset > last[tp.partition] for tp in pos):
            break
    return seen
