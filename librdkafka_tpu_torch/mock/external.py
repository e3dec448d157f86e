"""Client-side handle for the supervised out-of-process mock cluster,
the port's copy of the JAX package's ``mock/external.py``.

``ClusterHandle`` launches ``python -m librdkafka_tpu_torch.mock.standalone
--supervise`` (this package's supervisor, never the JAX package's) as a
subprocess, parses its JSON handshake, and speaks
the supervisor's line-protocol control plane.  It presents the same
target-resolution surface the chaos schedule DSL resolves against on
an in-process ``MockCluster`` — ``alive_brokers()``, ``controller_id``,
``coordinator_for``, ``topics``/``partition``, ``kill_broker``/
``kill9``/``restart_broker``/``pause_broker``/``resume_broker``,
``set_partition_leader`` — so one ``Schedule`` drives either tier and
``replay_key`` stays seed-deterministic against real OS processes.

Every spawned pid (supervisor + brokers) is tracked in a module-level
registry; the conftest leak fixture asserts it empty after every test
and ``reap_leaked()`` SIGKILLs stragglers so one leaked rig cannot
poison the rest of the suite.
"""
from __future__ import annotations

import json
import os
import selectors
import signal
import socket
import subprocess
import sys
import time
from collections import namedtuple
from typing import Optional

from ..analysis.locks import new_lock

#: pid -> "what" for every live subprocess any ClusterHandle spawned
#: (supervisor and brokers); asserted empty by the conftest leak
#: fixture after each test
_ACTIVE_PIDS: dict[int, str] = {}
_REG_LOCK = new_lock("mock.external.registry")

PartView = namedtuple("PartView", ["leader"])


def active_subprocess_pids() -> dict[int, str]:
    """Snapshot of the live standalone-subprocess registry."""
    with _REG_LOCK:
        return dict(_ACTIVE_PIDS)


def reap_leaked() -> list[int]:
    """SIGKILL every registered subprocess and clear the registry —
    the leak fixture's cleanup arm, so a test that lost its handle
    fails loudly HERE instead of starving every later test."""
    with _REG_LOCK:
        pids = list(_ACTIVE_PIDS)
        _ACTIVE_PIDS.clear()
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, OSError):
            pass
    return pids


def _register(pids: dict[int, str]) -> None:
    with _REG_LOCK:
        _ACTIVE_PIDS.update(pids)


def _deregister(pids) -> None:
    with _REG_LOCK:
        for pid in pids:
            _ACTIVE_PIDS.pop(pid, None)


# public registry surface for other subprocess-spawning rigs (the
# fleet driver registers every worker pid here, so the one conftest
# leak fixture polices brokers AND fleet clients)
def register_pids(pids: dict[int, str]) -> None:
    _register(pids)


def deregister_pids(pids) -> None:
    _deregister(pids)


def pid_alive(pid: int) -> bool:
    """True iff ``pid`` still exists (signal-0 probe)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class ClusterHandle:  # lint: ok shared-state
    """A supervised N-broker-process mock cluster, as one object.

    shared-state pragma: down/paused sets and proc_events are mutated
    only under ``mock.external.handle``; the control-plane socket is
    the cross-process boundary (no shared memory).

    >>> h = ClusterHandle(brokers=3, topics={"chaos": 4})
    >>> h.bootstrap_servers()
    '127.0.0.1:...,...'
    >>> h.kill9(2)            # real SIGKILL of broker 2's OS process
    >>> h.restart_broker(2)   # same public port, fresh pid
    >>> h.stop()
    """

    def __init__(self, brokers: int = 3, topics: Optional[dict] = None,
                 default_partitions: int = 4,
                 launch_timeout: float = 60.0):
        self.num_brokers = brokers
        self._lock = new_lock("mock.external.handle")
        self._down: set[int] = set()
        self._paused: set[int] = set()
        #: every confirmed process fault, for reports/tests:
        #: {"verb", "broker", "pid", "exit"/"new_pid", "verified_dead"}
        self.proc_events: list[dict] = []
        self._stopped = False

        cmd = [sys.executable, "-m", "librdkafka_tpu_torch.mock.standalone",
               "--supervise", "--brokers", str(brokers),
               "--partitions", str(default_partitions)]
        for name, parts in (topics or {}).items():
            cmd += ["--topic", f"{name}:{parts}"]
        env = dict(os.environ)
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_parent + os.pathsep
                             + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        self._proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, env=env)
        try:
            self.handshake = self._read_handshake(launch_timeout)
            self.control_port = self.handshake["control"]
            self.broker_ports = {int(b): info["port"] for b, info
                                 in self.handshake["brokers"].items()}
            self.broker_pids = {int(b): info["pid"] for b, info
                                in self.handshake["brokers"].items()}
            self._ctl = socket.create_connection(
                ("127.0.0.1", self.control_port), timeout=20)
            self._ctl_buf = b""
        except Exception:
            self._proc.kill()
            self._proc.wait()
            raise
        _register({self._proc.pid: "standalone-supervisor",
                   **{pid: f"standalone-broker-{b}"
                      for b, pid in self.broker_pids.items()}})

    # ----------------------------------------------------------- wire --
    def _read_handshake(self, timeout: float) -> dict:
        fd = self._proc.stdout.fileno()
        sel = selectors.DefaultSelector()
        sel.register(fd, selectors.EVENT_READ)
        deadline = time.monotonic() + timeout
        buf = b""
        try:
            while b"\n" not in buf:
                left = deadline - time.monotonic()
                if left <= 0 or not sel.select(timeout=left):
                    raise TimeoutError(
                        f"supervisor handshake not received in {timeout}s")
                chunk = os.read(fd, 4096)
                if not chunk:
                    rc = self._proc.poll()
                    raise RuntimeError(
                        f"supervisor exited during handshake (rc={rc})")
                buf += chunk
        finally:
            sel.close()
        return json.loads(buf.split(b"\n", 1)[0])

    def _ctl_cmd(self, line: str) -> dict:
        """One control round-trip; raises on protocol/transport error,
        returns the decoded JSON reply (``{"error": ...}`` replies
        raise RuntimeError so schedules record them in the timeline)."""
        with self._lock:
            self._ctl.sendall(line.encode() + b"\n")
            while b"\n" not in self._ctl_buf:
                chunk = self._ctl.recv(65536)
                if not chunk:
                    raise ConnectionError("supervisor control socket EOF")
                self._ctl_buf += chunk
            raw, _, self._ctl_buf = self._ctl_buf.partition(b"\n")
        resp = json.loads(raw)
        if "error" in resp:
            raise RuntimeError(f"control {line.split()[0]!r}: "
                               f"{resp['error']}")
        return resp

    # ---------------------------------------- schedule target surface --
    def bootstrap_servers(self) -> str:
        return self.handshake["bootstrap"]

    def alive_brokers(self) -> list[int]:
        with self._lock:
            return [b for b in range(1, self.num_brokers + 1)
                    if b not in self._down]

    def paused_brokers(self) -> list[int]:
        with self._lock:
            return sorted(self._paused)

    @property
    def controller_id(self) -> int:
        return self.status()["controller"]

    def coordinator_for(self, key: str) -> int:
        return self._ctl_cmd(f"coordinator {key}")["broker"]

    @property
    def topics(self) -> dict[str, list[PartView]]:
        st = self.status()
        return {t: [PartView(leader=ld) for ld in leaders]
                for t, leaders in st["topics"].items()}

    def partition(self, topic: str, part: int) -> PartView:
        return self.topics[topic][part]

    def set_partition_leader(self, topic: str, part: int,
                             broker_id: int) -> None:
        self._ctl_cmd(f"leader {topic} {part} {broker_id}")

    def create_topic(self, name: str, partitions: int = 4) -> None:
        self._ctl_cmd(f"create_topic {name} {partitions}")

    def status(self) -> dict:
        return self._ctl_cmd("status")

    # ----------------------------------------------- process faults --
    def kill9(self, broker_id: int) -> dict:
        """SIGKILL broker ``broker_id``'s OS process.  Returns after
        the supervisor reaped it and migrated leadership; the event —
        with pid-liveness verification — lands in ``proc_events``."""
        resp = self._ctl_cmd(f"kill9 {broker_id}")
        pid = resp["pid"]
        with self._lock:
            self._down.add(broker_id)
            self._paused.discard(broker_id)
            self.proc_events.append({
                "verb": "kill9", "broker": broker_id, "pid": pid,
                "exit": resp.get("exit"),
                # reaped by the supervisor => the pid must be GONE
                "verified_dead": not pid_alive(pid)})
        _deregister([pid])
        return resp

    # the generic schedule verbs map onto the process faults, so a
    # Schedule written for MockCluster drives this handle unchanged
    kill_broker = kill9

    def restart_broker(self, broker_id: int) -> dict:
        resp = self._ctl_cmd(f"restart {broker_id}")
        with self._lock:
            self._down.discard(broker_id)
            self.broker_pids[broker_id] = resp["pid"]
            self.proc_events.append({
                "verb": "restart", "broker": broker_id,
                "pid": resp["pid"], "port": resp["port"]})
        _register({resp["pid"]: f"standalone-broker-{broker_id}"})
        return resp

    def pause_broker(self, broker_id: int) -> dict:
        resp = self._ctl_cmd(f"stop {broker_id}")
        with self._lock:
            self._paused.add(broker_id)
            self.proc_events.append({"verb": "pause", "broker": broker_id,
                                     "pid": resp.get("pid")})
        return resp

    def resume_broker(self, broker_id: int) -> dict:
        resp = self._ctl_cmd(f"cont {broker_id}")
        with self._lock:
            self._paused.discard(broker_id)
            self.proc_events.append({"verb": "resume", "broker": broker_id,
                                     "pid": resp.get("pid")})
        return resp

    # ------------------------------------ environment fault library --
    def set_storage_error(self, broker_id: Optional[int] = None,
                          on: bool = True) -> dict:
        """Disk-full/EIO window on the supervisor's storage plane
        (``env_eio``): Produce on the affected broker(s) returns
        KAFKA_STORAGE_ERROR until healed.  None = every broker."""
        resp = self._ctl_cmd(f"eio {broker_id or 0} {1 if on else 0}")
        with self._lock:
            self.proc_events.append({"verb": "eio", "broker": broker_id,
                                     "on": on})
        return resp

    def set_clock_skew(self, broker_id: int, skew_ms: float = 0.0) -> dict:
        """Clock-skew fault (``env_skew``): broker ``broker_id``'s
        wall clock reads ``skew_ms`` off true (0 heals)."""
        resp = self._ctl_cmd(f"skew {broker_id} {skew_ms}")
        with self._lock:
            self.proc_events.append({"verb": "skew", "broker": broker_id,
                                     "skew_ms": skew_ms})
        return resp

    def set_rlimit(self, broker_id: int, nbytes: int) -> dict:
        """Memory pressure (``env_rlimit``): soft RLIMIT_AS on the
        broker's relay OS process via prlimit (0 restores infinity)."""
        resp = self._ctl_cmd(f"rlimit {broker_id} {int(nbytes)}")
        with self._lock:
            self.proc_events.append({"verb": "rlimit",
                                     "broker": broker_id,
                                     "pid": resp.get("pid"),
                                     "soft": resp.get("soft")})
        return resp

    def brownout(self, broker_id: int, *, rx_drop: bool = False,
                 tx_drop: bool = False, rx_delay_ms: float = 0.0,
                 tx_delay_ms: float = 0.0) -> dict:
        """Asymmetric-partition brownout (``env_brownout``): live
        one-direction drop/latency knobs on the broker's relay — the
        out-of-process analog of sockem's rx_drop/tx_drop."""
        knobs = {"rx_drop": rx_drop, "tx_drop": tx_drop,
                 "rx_delay_ms": rx_delay_ms, "tx_delay_ms": tx_delay_ms}
        blob = json.dumps(knobs, separators=(",", ":"))
        resp = self._ctl_cmd(f"brownout {broker_id} {blob}")
        with self._lock:
            self.proc_events.append({"verb": "brownout",
                                     "broker": broker_id, **knobs})
        return resp

    def clear_brownout(self, broker_id: int) -> dict:
        return self.brownout(broker_id)

    # --------------------------------------------------- observability --
    def trace_enable(self) -> dict:
        """Rig-wide tracing on: supervisor rings + every relay's
        (relays respawned by ``restart`` rejoin)."""
        return self._ctl_cmd("trace 1")

    def trace_disable(self) -> dict:
        return self._ctl_cmd("trace 0")

    def collect_traces(self) -> list:
        """The rig's per-process dumps for ``obs/collect.merge``:
        supervisor + every alive relay, every clock mapped into THIS
        process's timebase (handle->supervisor offset from the
        ``clock`` verb round trip, supervisor->relay offsets measured
        supervisor-side and composed here)."""
        from ..obs import collect as _collect
        t_send = time.monotonic_ns()
        ck = self._ctl_cmd("clock")
        t_recv = time.monotonic_ns()
        sup_off, sup_err = _collect.align_offset(
            t_send, ck["mono_ns"], t_recv)
        resp = self._ctl_cmd("trace_dump")
        return [_collect.ProcessDump(
                    p["name"], p.get("pid") or 0, p.get("events", []),
                    sup_off + p.get("offset_ns", 0),
                    sup_err + p.get("err_ns", 0))
                for p in resp.get("procs", [])]

    # -------------------------------------------------------- teardown --
    def pids(self) -> dict[str, int]:
        with self._lock:
            return {"supervisor": self._proc.pid,
                    **{f"broker-{b}": pid
                       for b, pid in self.broker_pids.items()}}

    def stop(self) -> None:
        """Tear the whole rig down and deregister every pid
        (idempotent).  Escalates: control shutdown -> stdin EOF ->
        SIGKILL, then verifies each broker pid is actually gone."""
        if self._stopped:
            return
        self._stopped = True
        try:
            self._ctl_cmd("shutdown")
        except (OSError, RuntimeError, ConnectionError, json.JSONDecodeError):
            pass
        try:
            self._ctl.close()
        except OSError:
            pass
        try:
            self._proc.stdin.close()       # EOF: second exit trigger
        except OSError:
            pass
        try:
            self._proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        try:
            self._proc.stdout.close()
        except OSError:
            pass
        # the supervisor kills its children on shutdown; SIGKILL any
        # survivor (e.g. supervisor itself was SIGKILLed mid-test)
        with self._lock:
            broker_pids = list(self.broker_pids.values())
        for pid in broker_pids:
            if pid_alive(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except (ProcessLookupError, OSError):
                    pass
        _deregister([self._proc.pid] + broker_pids)

    def __enter__(self) -> "ClusterHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
