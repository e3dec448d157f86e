"""Run the mock cluster as a standalone process — one-process mode and
the supervised **multi-process** mode.  The port's copy of
librdkafka_tpu/mock/standalone.py, on the port's mock cluster.

One-process mode (the interop and benchmark shape)::

    python -m librdkafka_tpu_torch.mock.standalone [--brokers N]
        [--partitions N] [--topic NAME:PARTS ...]

prints ``bootstrap.servers`` on the first stdout line and serves until
killed: an external client gets brokers that do not share its
GIL/process, but all N brokers still live in THIS one interpreter.

Supervised mode (``--supervise``) is the out-of-process chaos tier::

    python -m librdkafka_tpu_torch.mock.standalone --supervise --brokers 3

The parent becomes a **supervisor**: it holds the storage/controller
plane (a MockCluster on internal ports — the state an acks=all quorum
would preserve) and spawns one OS process per broker (`_relay.py`,
pure stdlib) binding that broker's PUBLIC port.  Faults then hit real
processes: ``kill -9`` loses half-written frames and refuses connects,
``SIGSTOP``/``SIGCONT`` model GC-pause/VM-freeze brownouts — none of
which the in-process tier can express (see CHAOS.md).

Handshake: the first stdout line is one JSON object::

    {"bootstrap": "127.0.0.1:p1,...", "control": <port>,
     "pid": <supervisor pid>, "brokers": {"1": {"port": p, "pid": pid}}}

Control plane: a line protocol on the control port — one command line
in, one JSON line out::

    kill9 <id>       SIGKILL broker <id>'s process, reap it, migrate
                     leadership+coordinator off it (reply carries pid,
                     exit status and the migration summary)
    stop <id>        SIGSTOP (freeze); cont <id> thaws
    restart <id>     respawn a killed broker on the SAME public port
    status           liveness/pids/ports/leaders/metadata_version
    coordinator <k>  coordinator broker for group/txn key <k>
    leader <t> <p> <b>   migrate partition leadership
    shutdown         kill every broker process and exit

Environment fault library (faults a kill/stop schedule cannot express;
each maps to a chaos ``env_*`` verb):

    eio <id|0> <1|0>     disk-full/EIO window on the storage plane
                         (0 = every broker): Produce returns
                         KAFKA_STORAGE_ERROR until healed
    skew <id> <ms>       clock skew: broker <id>'s wall clock reads
                         <ms> off true (0 heals)
    rlimit <id> <bytes>  memory pressure: soft RLIMIT_AS on the
                         broker's relay process via prlimit
                         (0 restores infinity)

Observability verbs (OBSERVABILITY.md):

    trace <0|1>      rig-wide tracing: the supervisor's obs/trace.py
                     rings plus every relay's (relay stdin command)
    clock            reply carries mono_ns — the collector's offset
                     exchange (obs/collect.align_offset)
    trace_dump       the rig's whole merged-timeline contribution:
                     supervisor + per-relay ring dumps inline, relays
                     clock-aligned to the supervisor
    brownout <id> <json> asymmetric partition: forward one-direction
                         rx/tx drop + latency knobs to the relay's
                         stdin (see mock/_relay.py); all-zero heals

The supervisor exits on ``shutdown`` or when its stdin reaches EOF
(the process that launched it died) — and each relay watches ITS stdin
the same way, so no broker process can outlive the rig.  The relay is
this package's ``_relay.py``, run by path: it imports nothing of either
package.
"""
from __future__ import annotations

import argparse
import json
import os
import selectors
import signal
import socket
import subprocess
import sys
import threading
import time

from ..analysis.locks import new_cond
from ..obs import collect as _obs_collect
from ..obs import trace as _trace
from .cluster import MockCluster

_RELAY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_relay.py")


class Supervisor:  # lint: ok shared-state
    """Parent of one relay OS process per broker; owns the MockCluster
    storage/controller plane and the line-protocol control socket.

    All child waits go through ``Popen.wait`` (reaper threads) or
    condvar waits — no sleep-polling anywhere in the wait paths.

    shared-state pragma: the proc/port/pid tables are mutated only
    under ``mock.supervisor`` (the condvar's lock serializes the ctl
    loop against the reaper threads); cross-PROCESS state is the relay
    handshake, not shared memory."""

    def __init__(self, num_brokers: int, topics=None,
                 default_partitions: int = 4, retention_bytes: int = 0):
        self.cluster = MockCluster(num_brokers=num_brokers, topics=topics,
                                   default_partitions=default_partitions,
                                   retention_bytes=retention_bytes)
        self.num_brokers = num_brokers
        self._cond = new_cond("mock.supervisor")
        self.procs: dict[int, subprocess.Popen] = {}
        self.public_ports: dict[int, int] = {}
        self.pids: dict[int, int] = {}
        self.exited: dict[int, int] = {}      # broker -> last exit status
        self.migrated: dict[int, list] = {}   # broker -> last kill summary
        self.down: set[int] = set()
        self.paused: set[int] = set()
        #: leftover relay-stdout bytes per broker (brownout acks)
        self._rbufs: dict[int, bytearray] = {}
        #: rig-side tracing: ``trace 1`` enables the
        #: supervisor's own rings AND every relay's (stdin command)
        self._tracing = False
        self.shutdown = threading.Event()

        for b in range(1, num_brokers + 1):
            self._spawn(b, 0)
        self._ctl_ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._ctl_ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ctl_ls.bind(("127.0.0.1", 0))
        self._ctl_ls.listen(8)
        self._ctl_ls.setblocking(False)
        self.control_port = self._ctl_ls.getsockname()[1]
        self._ctl_thread = threading.Thread(target=self._ctl_loop,
                                            name="standalone-ctl",
                                            daemon=True)
        self._ctl_thread.start()

    # ------------------------------------------------------- lifecycle --
    def _spawn(self, b: int, port: int) -> dict:
        """Start broker ``b``'s relay process on ``port`` (0 =
        ephemeral) and register it; returns the relay handshake."""
        proc = subprocess.Popen(
            [sys.executable, _RELAY, "--broker-id", str(b),
             "--port", str(port),
             "--upstream", f"127.0.0.1:{self.cluster._ports[b]}"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)
        line = proc.stdout.readline()
        if not line:
            rc = proc.wait()
            raise RuntimeError(f"broker {b} relay died at startup "
                               f"(exit {rc}, port {port})")
        hs = json.loads(line)
        with self._cond:
            self.procs[b] = proc
            self.public_ports[b] = hs["port"]
            self.pids[b] = hs["pid"]
            self.down.discard(b)
            self.exited.pop(b, None)
        self.cluster.set_advertised_port(b, hs["port"])
        threading.Thread(target=self._reap, args=(b, proc),
                         name=f"standalone-reap-{b}-{hs['pid']}",
                         daemon=True).start()
        if self._tracing:
            # a relay respawned mid-trace (restart verb) joins the
            # rig-wide trace session like its predecessor
            self._relay_cmd(b, {"trace": 1})
        return hs

    def _reap(self, b: int, proc: subprocess.Popen) -> None:
        """Blocks in ``Popen.wait`` until broker ``b``'s process dies
        (kill9 command or an outside ``kill -9 <pid>``), then runs the
        controller reaction: mark down, migrate leadership."""
        rc = proc.wait()
        with self._cond:
            if self.procs.get(b) is not proc:
                return          # already superseded by a restart
            self.exited[b] = rc if rc is not None else -1
            self.down.add(b)
            self.paused.discard(b)
        info = self.cluster.kill_broker(b)
        with self._cond:
            self.migrated[b] = [list(m) for m in info["migrated"]]
            self._cond.notify_all()

    def close(self) -> None:
        self.shutdown.set()
        if self._tracing:
            self._tracing = False
            _trace.disable()
        with self._cond:
            procs = dict(self.procs)
        for proc in procs.values():
            try:
                proc.kill()     # SIGKILL terminates stopped children too
            except (ProcessLookupError, OSError):
                pass
        for proc in procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self.cluster.stop()
        try:
            self._ctl_ls.close()
        except OSError:
            pass

    # --------------------------------------------------------- control --
    def handshake(self) -> dict:
        with self._cond:
            return {
                "bootstrap": ",".join(
                    f"127.0.0.1:{self.public_ports[b]}"
                    for b in sorted(self.public_ports)),
                "control": self.control_port,
                "pid": os.getpid(),
                "brokers": {str(b): {"port": self.public_ports[b],
                                     "pid": self.pids[b]}
                            for b in sorted(self.public_ports)},
            }

    def _cmd_kill9(self, b: int) -> dict:
        with self._cond:
            proc = self.procs.get(b)
            if proc is None or b in self.down:
                return {"error": f"broker {b} is not running"}
            pid = self.pids[b]
        try:
            proc.send_signal(signal.SIGKILL)    # kills SIGSTOPped ones too
        except (ProcessLookupError, OSError):
            pass
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self.exited.get(b) is not None, timeout=15)
            if not ok:
                return {"error": f"broker {b} did not reap within 15s"}
            return {"ok": True, "broker": b, "pid": pid,
                    "exit": self.exited.get(b),
                    "migrated": self.migrated.get(b, [])}

    def _cmd_restart(self, b: int) -> dict:
        with self._cond:
            if b not in self.down:
                return {"error": f"broker {b} is not down"}
            port = self.public_ports[b]
        # storage plane first: the relay must find its upstream alive
        self.cluster.restart_broker(b)
        try:
            hs = self._spawn(b, port)
        except (RuntimeError, OSError) as e:
            self.cluster.set_broker_down(b, True)
            return {"error": f"restart failed: {e}"}
        return {"ok": True, "broker": b, "pid": hs["pid"],
                "port": hs["port"]}

    def _cmd_pause(self, b: int) -> dict:
        with self._cond:
            if self.procs.get(b) is None or b in self.down:
                return {"error": f"broker {b} is not running"}
            if b in self.paused:
                return {"ok": True, "broker": b, "skipped": "paused"}
            pid = self.pids[b]
            self.paused.add(b)
        try:
            os.kill(pid, signal.SIGSTOP)
        except (ProcessLookupError, OSError) as e:
            return {"error": f"SIGSTOP failed: {e}"}
        return {"ok": True, "broker": b, "pid": pid}

    def _cmd_cont(self, b: int) -> dict:
        with self._cond:
            if b not in self.paused:
                return {"ok": True, "broker": b, "skipped": "not_paused"}
            pid = self.pids[b]
            self.paused.discard(b)
        try:
            os.kill(pid, signal.SIGCONT)
        except (ProcessLookupError, OSError) as e:
            return {"error": f"SIGCONT failed: {e}"}
        return {"ok": True, "broker": b, "pid": pid}

    def _cmd_rlimit(self, b: int, nbytes: int) -> dict:
        """Memory pressure on broker ``b``'s relay process: lower its
        soft RLIMIT_AS (hard limit stays infinite so the verb heals
        without privileges).  ``nbytes=0`` restores infinity."""
        import resource
        with self._cond:
            if self.procs.get(b) is None or b in self.down:
                return {"error": f"broker {b} is not running"}
            pid = self.pids[b]
        soft = resource.RLIM_INFINITY if nbytes <= 0 else int(nbytes)
        try:
            old = resource.prlimit(pid, resource.RLIMIT_AS,
                                   (soft, resource.RLIM_INFINITY))
        except (OSError, ValueError) as e:
            return {"error": f"prlimit failed: {e}"}
        return {"ok": True, "broker": b, "pid": pid,
                "soft": -1 if soft == resource.RLIM_INFINITY else soft,
                "old_soft": (-1 if old[0] == resource.RLIM_INFINITY
                             else old[0])}

    def _cmd_brownout(self, b: int, knobs: dict) -> dict:
        """Asymmetric-partition brownout: forward the knob set to the
        relay's stdin and wait for its ack line.  Refused for paused
        brokers (a SIGSTOPped relay cannot ack — and SIGCONT would
        already be the right verb to end THAT fault)."""
        with self._cond:
            proc = self.procs.get(b)
            if proc is None or b in self.down:
                return {"error": f"broker {b} is not running"}
            if b in self.paused:
                return {"error": f"broker {b} is paused (SIGSTOP); "
                                 "cont it before a brownout"}
        line = json.dumps({"set": knobs},
                          separators=(",", ":")).encode() + b"\n"
        try:
            proc.stdin.write(line)
            proc.stdin.flush()
        except (OSError, ValueError) as e:
            return {"error": f"relay stdin write failed: {e}"}
        ack = self._read_relay_line(b, proc, timeout=5.0)
        if ack is None or not ack.get("ok"):
            return {"error": f"relay did not ack brownout: {ack}"}
        return {"ok": True, "broker": b, "knobs": ack.get("knobs")}

    def _relay_cmd(self, b: int, obj: dict, timeout: float = 5.0):
        """One JSON command to broker ``b``'s relay stdin, one ack line
        back (None when the relay is down/paused or never acks)."""
        with self._cond:
            proc = self.procs.get(b)
            if proc is None or b in self.down or b in self.paused:
                return None
        line = json.dumps(obj, separators=(",", ":")).encode() + b"\n"
        try:
            proc.stdin.write(line)
            proc.stdin.flush()
        except (OSError, ValueError):
            return None
        return self._read_relay_line(b, proc, timeout=timeout)

    def _cmd_trace(self, on: int) -> dict:
        """Rig-wide trace switch: the supervisor's rings plus a
        ``{"trace": n}`` command to every alive relay."""
        if on and not self._tracing:
            self._tracing = True
            _trace.enable()
        elif not on and self._tracing:
            self._tracing = False
            _trace.disable()
        with self._cond:
            alive = sorted(b for b in self.procs if b not in self.down)
        acks = {}
        for b in alive:
            ack = self._relay_cmd(b, {"trace": int(bool(on))})
            acks[str(b)] = bool(ack and ack.get("ok"))
        return {"ok": True, "trace": bool(on), "relays": acks}

    def _cmd_trace_dump(self) -> dict:
        """The rig's whole contribution to a merged timeline: the
        supervisor's ring dump plus every alive relay's, each relay
        clock-aligned to the SUPERVISOR via a stdin round trip (the
        collecting client aligns the supervisor to itself with the
        ``clock`` verb and adds the offsets)."""
        procs = [{"name": "supervisor", "pid": os.getpid(),
                  "offset_ns": 0, "err_ns": 0,
                  "events": (_trace.collect_events()
                             if self._tracing else [])}]
        with self._cond:
            alive = sorted(b for b in self.procs if b not in self.down)
        for b in alive:
            t_send = time.monotonic_ns()
            ck = self._relay_cmd(b, {"clock": 1})
            t_recv = time.monotonic_ns()
            dump = self._relay_cmd(b, {"trace_dump": 1}, timeout=10.0)
            if not dump or not dump.get("ok"):
                continue
            off = err = 0
            if ck and ck.get("ok"):
                off, err = _obs_collect.align_offset(
                    t_send, ck["mono_ns"], t_recv)
            procs.append({"name": f"relay-{b}", "pid": dump.get("pid"),
                          "offset_ns": off, "err_ns": err,
                          "events": dump.get("events", [])})
        return {"ok": True, "procs": procs}

    def _read_relay_line(self, b: int, proc, timeout: float):
        """One JSON line from the relay's stdout (raw fd + per-broker
        leftover buffer; the buffered handshake readline left nothing
        behind — the relay writes strictly one line per event)."""
        buf = self._rbufs.setdefault(b, bytearray())
        fd = proc.stdout.fileno()
        deadline = time.monotonic() + timeout
        sel = selectors.DefaultSelector()
        try:
            sel.register(fd, selectors.EVENT_READ)
        except (OSError, ValueError):
            return None
        try:
            while b"\n" not in buf:
                left = deadline - time.monotonic()
                if left <= 0 or not sel.select(timeout=left):
                    return None
                try:
                    chunk = os.read(fd, 4096)
                except OSError:
                    return None
                if not chunk:
                    return None
                buf += chunk
        finally:
            sel.close()
        raw, _, rest = bytes(buf).partition(b"\n")
        self._rbufs[b] = bytearray(rest)
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def _cmd_status(self) -> dict:
        with self._cond:
            snap = {
                "ok": True,
                "alive": sorted(set(range(1, self.num_brokers + 1))
                                - self.down),
                "down": sorted(self.down),
                "paused": sorted(self.paused),
                "brokers": {str(b): {"port": self.public_ports.get(b),
                                     "pid": self.pids.get(b)}
                            for b in range(1, self.num_brokers + 1)},
            }
        with self.cluster._lock:
            snap["controller"] = self.cluster.controller_id
            snap["metadata_version"] = self.cluster.metadata_version
            snap["topics"] = {t: [p.leader for p in parts]
                              for t, parts in self.cluster.topics.items()}
            snap["storage_err"] = sorted(self.cluster._storage_err)
            snap["clock_skews"] = {str(b): s for b, s in
                                   self.cluster._clock_skew_ms.items()}
        return snap

    def _dispatch(self, line: str) -> dict:
        parts = line.split()
        if not parts:
            return {"error": "empty command"}
        cmd, args = parts[0], parts[1:]
        try:
            if cmd == "kill9":
                return self._cmd_kill9(int(args[0]))
            if cmd == "stop":
                return self._cmd_pause(int(args[0]))
            if cmd == "cont":
                return self._cmd_cont(int(args[0]))
            if cmd == "restart":
                return self._cmd_restart(int(args[0]))
            if cmd == "status":
                return self._cmd_status()
            if cmd == "coordinator":
                return {"ok": True,
                        "broker": self.cluster.coordinator_for(args[0])}
            if cmd == "leader":
                self.cluster.set_partition_leader(
                    args[0], int(args[1]), int(args[2]))
                return {"ok": True}
            if cmd == "create_topic":
                self.cluster.create_topic(args[0], int(args[1]))
                return {"ok": True}
            if cmd == "eio":
                b = int(args[0])
                info = self.cluster.set_storage_error(
                    b or None, bool(int(args[1])))
                return {"ok": True, "broker": b, **info}
            if cmd == "skew":
                b = int(args[0])
                self.cluster.set_clock_skew(b, float(args[1]))
                return {"ok": True, "broker": b,
                        "skew_ms": float(args[1])}
            if cmd == "rlimit":
                return self._cmd_rlimit(int(args[0]), int(args[1]))
            if cmd == "brownout":
                return self._cmd_brownout(
                    int(args[0]), json.loads(" ".join(args[1:])))
            if cmd == "trace":
                return self._cmd_trace(int(args[0]))
            if cmd == "clock":
                return {"ok": True, "mono_ns": time.monotonic_ns()}
            if cmd == "trace_dump":
                return self._cmd_trace_dump()
            if cmd == "shutdown":
                self.shutdown.set()
                return {"ok": True, "bye": True}
        except (ValueError, IndexError, KeyError) as e:
            return {"error": f"{cmd}: {e!r}"}
        return {"error": f"unknown command {cmd!r}"}

    def _ctl_loop(self) -> None:
        sel = selectors.DefaultSelector()
        sel.register(self._ctl_ls, selectors.EVENT_READ, "accept")
        bufs: dict[socket.socket, bytearray] = {}
        while not self.shutdown.is_set():
            try:
                events = sel.select(timeout=0.2)
            except OSError:
                break
            for key, _mask in events:
                if key.data == "accept":
                    try:
                        s, _ = self._ctl_ls.accept()
                    except OSError:
                        continue
                    bufs[s] = bytearray()
                    sel.register(s, selectors.EVENT_READ, "conn")
                    continue
                s = key.fileobj
                try:
                    data = s.recv(4096)
                except OSError:
                    data = b""
                if not data:
                    try:
                        sel.unregister(s)
                    except (KeyError, ValueError):
                        pass
                    s.close()
                    bufs.pop(s, None)
                    continue
                bufs[s] += data
                while b"\n" in bufs[s]:
                    raw, _, rest = bytes(bufs[s]).partition(b"\n")
                    bufs[s] = bytearray(rest)
                    line_s = raw.decode(errors="replace").strip()
                    t0 = _trace.now() if _trace.enabled else 0
                    resp = self._dispatch(line_s)
                    if t0:
                        _trace.complete(
                            "rig", "ctl_cmd", t0,
                            {"cmd": line_s.split()[0] if line_s else ""})
                    try:
                        s.sendall(json.dumps(resp).encode() + b"\n")
                    except OSError:
                        pass


def _supervise_main(args) -> int:
    topics = {}
    for spec in args.topic:
        name, _, parts = spec.partition(":")
        topics[name] = int(parts or args.partitions)
    sup = Supervisor(num_brokers=args.brokers, topics=topics or None,
                     default_partitions=args.partitions,
                     retention_bytes=args.retention_mb << 20)
    print(json.dumps(sup.handshake()), flush=True)

    def _stdin_watch():
        # a raw read: a daemon thread parked inside the buffered reader
        # would hold its lock through interpreter shutdown (a fatal
        # error at exit after the ``shutdown`` verb)
        try:
            while os.read(sys.stdin.fileno(), 4096):
                pass
        except (OSError, ValueError):
            pass
        sup.shutdown.set()

    threading.Thread(target=_stdin_watch, name="standalone-stdin",
                     daemon=True).start()
    try:
        sup.shutdown.wait()
    except KeyboardInterrupt:
        pass
    finally:
        sup.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--brokers", type=int, default=1)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--topic", action="append", default=[],
                    metavar="NAME:PARTS")
    ap.add_argument("--seconds", type=float, default=0,
                    help="exit after this long (0 = run until killed; "
                         "one-process mode only)")
    ap.add_argument("--retention-mb", type=int, default=0,
                    help="per-partition log retention cap in MB "
                         "(0 = unbounded)")
    ap.add_argument("--supervise", action="store_true",
                    help="multi-process mode: one OS process per broker "
                         "+ a control socket (the out-of-process chaos "
                         "tier; see CHAOS.md)")
    args = ap.parse_args(argv)

    if args.supervise:
        return _supervise_main(args)

    topics = {}
    for spec in args.topic:
        name, _, parts = spec.partition(":")
        topics[name] = int(parts or args.partitions)

    cluster = MockCluster(num_brokers=args.brokers,
                          topics=topics or None,
                          default_partitions=args.partitions,
                          retention_bytes=args.retention_mb << 20)
    print(cluster.bootstrap_servers(), flush=True)
    try:
        parent = os.getppid()
        deadline = time.monotonic() + args.seconds if args.seconds else None
        while deadline is None or time.monotonic() < deadline:
            time.sleep(0.5)
            # a SIGKILLed parent (bench timeout, crashed harness)
            # reparents us to init: exit instead of lingering as an
            # orphan eating the benchmark host's CPU
            if os.getppid() != parent:
                break
    except KeyboardInterrupt:
        pass
    finally:
        cluster.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
