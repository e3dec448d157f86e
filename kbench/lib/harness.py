"""What every traffic kind shares: the broker process, the client's
configuration, the measured window and what is read around it.

A traffic module (``kbench/traffic/<kind>.py``) defines ``run(h)``.  It
builds its clients from ``h.client_conf(...)``, warms them, calls
``h.setup_done()``, measures inside ``with h.window(engines) as w:``,
fills ``h.r`` (a :class:`Readings`) and the compared numbers with
``h.check(name, value, limit)``, and judges what the window produced
once the window has closed.  Metrics are then read from ``h.r`` by the
readers in ``kbench/metrics/``.
"""
from __future__ import annotations

import json
import os
import re
import resource
import select
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KBENCH = os.path.join(ROOT, "kbench")


@dataclass
class Readings:
    """Everything a metric reader may read; a reading that a run did not
    take stays None (its readers then return None)."""
    seconds: float                          # the window asked for
    setup_s: float | None = None
    delivered: int | None = None            # records acked in the window
    consumed: int | None = None             # records the app received
    client_cpu_s: float | None = None       # getrusage, the whole client
    app_thread_cpu_s: float | None = None   # the harness's own thread
    thread_cpu_s: dict | None = None        # CPU of each thread, by name
    engine: dict | None = None              # engine counter deltas
    spans: list | None = None               # the program's trace events
    dev: dict | None = None                 # the device trace's summary
    extra: dict = field(default_factory=dict)


class Broker:
    """``kbench/broker.py`` in its own process (the program's mock
    cluster), started and stopped by the harness."""

    def __init__(self, brokers: int, topic: str, partitions: int,
                 retention_bytes: int):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(KBENCH, "broker.py"),
             "--brokers", str(brokers), "--topic", f"{topic}:{partitions}",
             "--retention-bytes", str(retention_bytes)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT)
        ready, _, _ = select.select([self.proc.stdout], [], [], 60.0)
        line = self.proc.stdout.readline().decode().strip() if ready else ""
        if not line:
            self.close()
            raise RuntimeError("the broker process did not start")
        self.bootstrap = line

    def cpu_s(self) -> float:
        """The broker process's user + system CPU seconds so far."""
        with open(f"/proc/{self.proc.pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")

    def dump(self, topic: str) -> dict:
        """{partition: (start_offset, end_offset, stored bytes)}."""
        self.proc.stdin.write(f"dump {topic}\n".encode())
        self.proc.stdin.flush()
        head = json.loads(self.proc.stdout.readline())
        out = {}
        for p, start, end, n in head["parts"]:
            data = self.proc.stdout.read(n)
            if len(data) != n:
                raise RuntimeError("the broker's dump was cut off")
            out[p] = (start, end, data)
        return out

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(b"quit\n")
                self.proc.stdin.close()
                self.proc.wait(30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait(30)
        self.proc.stdout.close()


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def thread_cpu_s() -> dict:
    """User + system CPU seconds of this process's threads, summed by
    thread name with its digits (ports, lane numbers) folded to ``N``."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out: dict[str, float] = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
        except OSError:                  # the thread has just ended
            continue
        name = names.get(int(tid)) or stat[stat.index("(") + 1:
                                            stat.rindex(")")]
        fields = stat.rsplit(")", 1)[1].split()
        name = re.sub(r"\d+", "N", name)
        out[name] = out.get(name, 0.0) + (
            int(fields[11]) + int(fields[12])) / tick
    return out


def engine_counters(clients) -> dict:
    """The offload engines' counters summed over ``clients``."""
    out: dict = {}
    for c in clients:
        eng = getattr(c._rk.codec_provider, "_engine", None)
        if eng is None:
            continue
        for k, v in dict(eng.stats).items():
            out[k] = out.get(k, 0) + v
        for k, v in dict(eng.compress_stats).items():
            out["compress_" + k] = out.get("compress_" + k, 0) + v
    return out


class Harness:
    def __init__(self, args, cell: dict, cfg: dict, t_start: float,
                 device: str):
        self.seed = args.seed
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.cell, self.cfg = cell, cfg
        self.device = device                     # "cuda", or "cpu" in tests
        self.t_start = t_start
        self.r = Readings(seconds=self.seconds)
        self.checks: dict[str, tuple] = {}
        self.covered: dict = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self._brokers: list[Broker] = []
        self._clients: list = []
        self.mark("imported")

    # ------------------------------------------------------------ set-up --
    def broker(self, topic: str) -> Broker:
        cfg = self.cfg
        b = Broker(cfg["brokers"], topic, cfg["partitions"],
                   cfg["retention_bytes"])
        self._brokers.append(b)
        return b

    def client_conf(self, role: str, bootstrap: str, **extra) -> dict:
        """The configuration's ``producer`` or ``consumer`` keys, the
        broker's address, and this run's device and tracing keys."""
        conf = dict(self.cfg[role])
        conf["bootstrap.servers"] = bootstrap
        if conf.get("compression.backend") == "gpu":
            conf["gpu.device"] = self.device
        if self.trace:
            conf["trace.enable"] = True
            conf["trace.ring.events"] = 1 << 20
        conf.update(extra)
        return conf

    def own(self, client):
        """Close ``client`` when the run ends, whatever happens."""
        self._clients.append(client)
        return client

    def drop(self, client) -> None:
        """Close an owned client now."""
        self._clients.remove(client)
        client.close()

    def mark(self, name: str) -> None:
        """Seconds from the process's start to this point of set-up, kept
        in the result's ``extra`` so that a slow set-up shows its step."""
        self.r.extra.setdefault("setup_marks", {})[name] = (
            time.perf_counter() - self.t_start)

    def setup_done(self) -> None:
        self.r.setup_s = time.perf_counter() - self.t_start

    # ------------------------------------------------------------ window --
    @contextmanager
    def window(self, clients):
        """Measure the block: the host clock, the client's CPU, the
        engines' counters and, with ``--trace 1``, the device trace and
        the program's spans.  ``w.deadline`` is when the loop stops."""
        from librdkafka_tpu_torch.obs import trace as ptrace
        from . import devtrace
        w = _Window()
        e0 = engine_counters(clients)
        prof = devtrace.start(self.device) if self.trace else None
        cpu0, th0 = _cpu_s(), time.thread_time()
        threads0 = thread_cpu_s()
        b0 = [b.cpu_s() for b in self._brokers]
        t0_ns = time.monotonic_ns()
        w.t0 = time.perf_counter()
        w.deadline = w.t0 + self.seconds
        yield w
        t1_ns = time.monotonic_ns()
        self.r.client_cpu_s = _cpu_s() - cpu0
        # where the client's CPU went, by thread
        self.r.thread_cpu_s = {k: v - threads0.get(k, 0.0)
                               for k, v in thread_cpu_s().items()}
        self.r.extra["thread_cpu_s"] = sorted(
            self.r.thread_cpu_s.items(), key=lambda kv: -kv[1])[:10]
        # the broker's share of a core over the window: near 1 means the
        # one-process broker, not the client, may set the pace
        self.r.extra["broker_cpu_cores"] = sum(
            b.cpu_s() for b in self._brokers) - sum(b0)
        self.r.extra["broker_cpu_cores"] /= max(time.perf_counter() - w.t0,
                                                1e-9)
        self.r.app_thread_cpu_s = time.thread_time() - th0
        e1 = engine_counters(clients)
        self.r.engine = {k: v - e0.get(k, 0) for k, v in e1.items()}
        if self.trace:
            self.r.spans = [e for e in ptrace.collect_events()
                            if e.get("ph") == "X"
                            and t0_ns <= e["ts"] * 1e3 <= t1_ns]
        if prof is not None:
            tr = time.perf_counter()
            self.r.dev = devtrace.finish(prof, t0_ns, t1_ns, self.r.spans)
            self.r.extra.update(trace_read_s=time.perf_counter() - tr,
                                trace_events=self.r.dev["events"],
                                trace_marker=self.r.dev["marker"])
        if self.device == "cuda":
            import torch
            self.memory_peak = max(torch.cuda.max_memory_allocated(d)
                                   for d in range(torch.cuda.device_count()))

    def check(self, name: str, value, limit) -> None:
        self.checks[name] = (value, limit)

    def close(self) -> None:
        while self._clients:
            self._clients.pop().close()
        for b in self._brokers:
            b.close()
        self._brokers.clear()


class _Window:
    t0: float
    deadline: float
