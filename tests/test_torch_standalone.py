"""The port's out-of-process mock (librdkafka_tpu_torch/mock/standalone.py
and _relay.py) held against the JAX package's.

``python -m librdkafka_tpu_torch.mock.standalone`` serves the port's mock
cluster from a process of its own: one process prints bootstrap.servers,
``--supervise`` prints a JSON handshake and spawns one relay process a
broker (the port's ``_relay.py``, run by path).  A port Producer on the
GPU provider (the kernels' plain versions, ``gpu.device=cpu``) produces
through it and a Consumer with ``check.crcs`` reads every record back; the
batches it stores equal, byte for byte, what the reference's standalone
mock stores for the same produce.  A fixture kills and reaps every process
a test spawned.
"""
import json
import os
import select
import signal
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import pytest

from librdkafka_tpu_torch import Consumer, Producer
from librdkafka_tpu_torch.client.consumer import TopicPartition
from librdkafka_tpu_torch.protocol import apis
from librdkafka_tpu_torch.protocol.msgset import iter_batches, verify_crc_v2
from librdkafka_tpu_torch.protocol.proto import OFFSET_BEGINNING, ApiKey

REPO = Path(__file__).resolve().parent.parent
RELAY = REPO / "librdkafka_tpu_torch" / "mock" / "_relay.py"
NOW_MS = 1_700_000_000_000


@pytest.fixture
def spawn():
    """Start a standalone mock (the port's, or the reference's with
    ``pkg="librdkafka_tpu"``); every process it started, relays included,
    is killed and reaped after the test."""
    procs, pids = [], []

    def start(*args, pkg="librdkafka_tpu_torch", supervise=False):
        cmd = [sys.executable, "-m", f"{pkg}.mock.standalone", *args]
        if supervise:
            cmd.append("--supervise")
        p = subprocess.Popen(cmd, cwd=REPO, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
        procs.append(p)
        ready, _, _ = select.select([p.stdout], [], [], 60)
        line = p.stdout.readline().strip() if ready else ""
        assert line, "standalone mock did not start: " + (
            p.stderr.read()[-500:] if p.poll() is not None else "no output")
        if supervise:
            hs = json.loads(line)
            pids.extend(b["pid"] for b in hs["brokers"].values())
            return p, hs
        return p, line

    yield start
    for p in procs:
        p.kill()
        p.wait(15)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + 10
    while pids and time.monotonic() < deadline:
        pids = [pid for pid in pids if Path(f"/proc/{pid}").exists()
                and "Z" not in _state(pid)]
        time.sleep(0.05)
    assert not pids, f"relay processes outlived the test: {pids}"


def _state(pid: int) -> str:
    try:
        return Path(f"/proc/{pid}/stat").read_text().split(") ")[1][0]
    except (OSError, IndexError):
        return "Z"


def _ctl(port: int, line: str) -> dict:
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(line.encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            assert chunk, "control socket closed"
            buf += chunk
    return json.loads(buf)


def _fetch_records(bootstrap: str, topic: str, partition: int) -> bytes:
    """The records a broker returns for (topic, partition) from offset
    0, by one raw Fetch request."""
    host, port = bootstrap.split(",")[0].split(":")
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(apis.build_request(ApiKey.Fetch, 1, "raw", {
            "replica_id": -1, "max_wait_time": 100, "min_bytes": 1,
            "max_bytes": 1 << 24, "isolation_level": 1,
            "topics": [{"topic": topic, "partitions": [
                {"partition": partition, "fetch_offset": 0,
                 "max_bytes": 1 << 24}]}]}))
        head = b""
        while len(head) < 4:
            head += s.recv(4 - len(head))
        (n,) = struct.unpack(">i", head)
        body = b""
        while len(body) < n:
            body += s.recv(n - len(body))
    _, resp = apis.parse_response(ApiKey.Fetch, body)
    part = resp["topics"][0]["partitions"][0]
    assert part["error_code"] == 0, part
    return bytes(part["records"])


def _values(parts, per):
    return [[b"sa-p%d-r%03d " % (i, j) * (5 + j % 30) for j in range(per)]
            for i in range(parts)]


GPU = {"compression.backend": "gpu", "gpu.device": "cpu",
       "gpu.governor": False, "gpu.launch.min.batches": 1}


def test_one_process_handshake(spawn):
    p, bootstrap = spawn("--brokers", "2", "--topic", "hs:3")
    addrs = bootstrap.split(",")
    assert len(addrs) == 2
    for a in addrs:
        host, port = a.split(":")
        assert host == "127.0.0.1" and int(port) > 0
        socket.create_connection((host, int(port)), timeout=5).close()
    assert p.poll() is None


def test_producer_consumer_round_trip_through_the_process(spawn):
    """A port Producer on the GPU provider (lz4, the CRC tickets) into
    the mock in its own process, then a check.crcs Consumer on the GPU
    provider: every batch verifies, every record comes back in order."""
    parts, per = 4, 60
    _, bootstrap = spawn("--brokers", "1", "--topic", f"rt:{parts}")
    vals = _values(parts, per)
    p = Producer({"bootstrap.servers": bootstrap, "compression.codec": "lz4",
                  "linger.ms": 5, "enable.idempotence": True, **GPU})
    c = None
    try:
        assert p._rk.codec_provider.wait_warm(120)
        for j in range(per):
            for i in range(parts):
                p.produce("rt", value=vals[i][j], key=b"k%d" % i,
                          partition=i)
        assert p.flush(120) == 0
        assert p._rk.codec_provider._engine.stats["launches"] > 0
        for i in range(parts):
            for info, _payload, full in iter_batches(
                    _fetch_records(bootstrap, "rt", i)):
                assert verify_crc_v2(info, full)
        c = Consumer({"bootstrap.servers": bootstrap, "group.id": "sa",
                      "auto.offset.reset": "earliest", "check.crcs": True,
                      **GPU})
        c.assign([TopicPartition("rt", i, OFFSET_BEGINNING)
                  for i in range(parts)])
        got = [[] for _ in range(parts)]
        deadline = time.monotonic() + 60
        while sum(map(len, got)) < parts * per:
            assert time.monotonic() < deadline, "consumer stalled"
            for m in c.consume(parts * per, 1.0):
                assert m.error is None, m.error
                got[m.partition].append(m.value)
        assert got == vals
        assert c._rk.codec_provider._engine.stats["launches"] > 0
    finally:
        if c is not None:
            c.close()
        p.close()


def test_supervised_spawns_the_ports_relays_and_kill9_refuses(spawn):
    """--supervise: the handshake names one relay process a broker, each
    running the port's _relay.py by path; a kill -9 of one relay is
    reaped, marks its broker down, and its port refuses connects."""
    sup, hs = spawn("--brokers", "2", "--topic", "sv:2", supervise=True)
    assert set(hs) >= {"bootstrap", "control", "pid", "brokers"}
    assert hs["pid"] == sup.pid and sorted(hs["brokers"]) == ["1", "2"]
    for b in hs["brokers"].values():
        argv = Path(f"/proc/{b['pid']}/cmdline").read_bytes().split(b"\0")
        assert argv[1] == str(RELAY).encode(), argv
        assert not any(a.startswith(b"librdkafka_tpu") for a in argv)
    assert hs["bootstrap"] == ",".join(
        f"127.0.0.1:{hs['brokers'][b]['port']}" for b in ("1", "2"))
    st = _ctl(hs["control"], "status")
    assert st["ok"] and st["alive"] == [1, 2]
    victim = hs["brokers"]["2"]
    os.kill(victim["pid"], signal.SIGKILL)
    deadline = time.monotonic() + 15
    while _ctl(hs["control"], "status")["down"] != [2]:
        assert time.monotonic() < deadline, "the killed relay was not reaped"
        time.sleep(0.05)
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", victim["port"]), timeout=5)
    socket.create_connection(
        ("127.0.0.1", hs["brokers"]["1"]["port"]), timeout=5).close()
    assert _ctl(hs["control"], "shutdown")["bye"]
    assert sup.wait(30) == 0


def test_stored_batches_equal_the_reference_standalone(spawn):
    """The same produce (fixed batch boundaries and timestamps, the CPU
    provider) into the port's standalone mock and the reference's: the
    batches each returns by Fetch are equal, byte for byte."""
    parts, per, batch = 2, 40, 20
    vals = _values(parts, per)
    stored = []
    for pkg in ("librdkafka_tpu_torch", "librdkafka_tpu"):
        _, bootstrap = spawn("--brokers", "1", "--topic", f"eq:{parts}",
                             pkg=pkg)
        p = Producer({"bootstrap.servers": bootstrap,
                      "compression.codec": "lz4", "linger.ms": 1000,
                      "batch.num.messages": batch,
                      "enable.idempotence": False})
        try:
            for j in range(per):
                for i in range(parts):
                    p.produce("eq", value=vals[i][j], key=b"k%d" % i,
                              partition=i, timestamp=NOW_MS + j)
            assert p.flush(120) == 0
        finally:
            p.close()
        stored.append([_fetch_records(bootstrap, "eq", i)
                       for i in range(parts)])
    port, ref = stored
    assert port == ref
    assert [sum(1 for _ in iter_batches(r)) for r in port] == \
        [per // batch] * parts
