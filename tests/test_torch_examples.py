"""The port's examples (librdkafka_tpu_torch/examples) held against the
JAX package's (examples/).

- verifiable_client.py: test_0116_verifiable's three cases against the
  port's standalone mock process (killed and reaped after the module);
- producer, consumer, idempotent_producer and admin run with the same
  arguments as the reference's copies and print the same lines;
- performance.py --backend cpu at a small count, and --backend gpu (the
  default) with no card visible exits non-zero naming the missing card.
"""
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENT = os.path.join(ROOT, "librdkafka_tpu_torch", "examples",
                      "verifiable_client.py")
ENV = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def mock_proc():
    child = subprocess.Popen(
        [sys.executable, "-m", "librdkafka_tpu_torch.mock.standalone",
         "--brokers", "1", "--topic", "vt:2", "--topic", "ex:4"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=ENV)
    ready, _, _ = select.select([child.stdout], [], [], 30)
    bs = child.stdout.readline().strip() if ready else ""
    try:
        if not bs:
            pytest.fail("standalone mock failed to start")
        yield bs
    finally:
        child.kill()
        child.wait(30)


def _example(pkg: str, name: str, *args, timeout=90) -> str:
    """Run one example of the port (pkg "port", as a module) or of the
    reference (pkg "ref", by path); returns its stdout."""
    cmd = ([sys.executable, "-m", f"librdkafka_tpu_torch.examples.{name}"]
           if pkg == "port" else
           [sys.executable, os.path.join(ROOT, "examples", f"{name}.py")])
    r = subprocess.run([*cmd, *args], capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT, env=ENV)
    assert r.returncode == 0, (pkg, name, r.stderr[-2000:])
    return r.stdout


def _run(args, timeout=90):
    r = subprocess.run(
        [sys.executable, CLIENT, *args], cwd=ROOT, env=ENV,
        capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-800:]
    return [json.loads(line) for line in r.stdout.splitlines()
            if line.strip()]


def test_verifiable_producer(mock_proc):
    lines = _run(["--producer", "--topic", "vt", "--max-messages", "300",
                  "--bootstrap-server", mock_proc])
    names = [x["name"] for x in lines]
    assert names[0] == "startup_complete"
    assert names[-1] == "shutdown_complete"
    acks = [x for x in lines if x["name"] == "producer_send_success"]
    assert len(acks) == 300
    assert {a["topic"] for a in acks} == {"vt"}
    tool = next(x for x in lines if x["name"] == "tool_data")
    assert tool["sent"] == tool["acked"] == 300


def test_verifiable_consumer(mock_proc):
    _run(["--producer", "--topic", "vt", "--max-messages", "300",
          "--bootstrap-server", mock_proc])
    lines = _run(["--consumer", "--topic", "vt", "--max-messages", "300",
                  "--group-id", "vg", "--bootstrap-server", mock_proc,
                  "--commit-interval-ms", "300"])
    names = [x["name"] for x in lines]
    assert names[0] == "startup_complete"
    assert names[-1] == "shutdown_complete"
    assert "partitions_assigned" in names
    consumed = [x for x in lines if x["name"] == "records_consumed"]
    assert consumed and consumed[-1]["_totcount"] == 300
    for batch in consumed:
        for p in batch["partitions"]:
            assert 0 <= p["minOffset"] <= p["maxOffset"]
    commits = [x for x in lines if x["name"] == "offsets_committed"]
    assert commits and all(c["success"] for c in commits)


def test_verifiable_two_consumer_rebalance(mock_proc):
    """A second consumer joins the group mid-stream: both sides emit the
    rebalance events and the partitions split disjointly."""
    def read_until(proc, name, timeout=60):
        lines = []
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(json.loads(line))
            if lines[-1]["name"] == name:
                return lines
        raise AssertionError(
            f"never saw {name}: {[x['name'] for x in lines]}")

    _run(["--producer", "--topic", "vt", "--max-messages", "400",
          "--bootstrap-server", mock_proc])
    cmd = [sys.executable, CLIENT, "--consumer", "--topic", "vt",
           "--group-id", "vreb", "--bootstrap-server", mock_proc,
           "--commit-interval-ms", "300"]
    c1 = c2 = None
    try:
        c1 = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                              cwd=ROOT, env=ENV)
        l1 = read_until(c1, "partitions_assigned")
        c2 = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                              cwd=ROOT, env=ENV)
        l1 += read_until(c1, "partitions_revoked")
        l1 += read_until(c1, "partitions_assigned")
        l2 = read_until(c2, "partitions_assigned")
        c1.terminate()
        c2.terminate()
        out1, _ = c1.communicate(timeout=30)
        out2, _ = c2.communicate(timeout=30)
        l1 += [json.loads(x) for x in out1.splitlines() if x.strip()]
        l2 += [json.loads(x) for x in out2.splitlines() if x.strip()]
    finally:
        for proc in (c1, c2):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(30)
    assert l1[-1]["name"] == "shutdown_complete"
    assert l2[-1]["name"] == "shutdown_complete"
    last1 = [x for x in l1 if x["name"] == "partitions_assigned"][-1]
    last2 = [x for x in l2 if x["name"] == "partitions_assigned"][-1]
    p1 = {(p["topic"], p["partition"]) for p in last1["partitions"]}
    p2 = {(p["topic"], p["partition"]) for p in last2["partitions"]}
    assert p1 and p2 and not (p1 & p2), (p1, p2)


@pytest.mark.parametrize("name", ["producer", "idempotent_producer",
                                  "admin"])
def test_example_prints_what_the_reference_prints(name):
    """In-process mock, no arguments.  Lines are compared sorted: the
    producer's delivery reports of different partitions arrive in
    either order."""
    port = _example("port", name).splitlines()
    ref = _example("ref", name).splitlines()
    assert port and sorted(port) == sorted(ref)


def _consume(pkg: str, bootstrap: str, topic: str, want: int) -> list:
    """consumer.py <bootstrap> <topic> <group> until it printed ``want``
    records, then SIGINT (its way out)."""
    cmd = ([sys.executable, "-m", "librdkafka_tpu_torch.examples.consumer"]
           if pkg == "port" else
           [sys.executable, os.path.join(ROOT, "examples", "consumer.py")])
    proc = subprocess.Popen([*cmd, bootstrap, topic, f"ex-{pkg}"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT,
                            env=dict(ENV, PYTHONUNBUFFERED="1"))
    lines: list = []

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 60
        while len(lines) < want and time.monotonic() < deadline:
            time.sleep(0.05)
        proc.send_signal(signal.SIGINT)
        proc.wait(30)
        reader.join(30)
        assert proc.returncode == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    return lines


def test_consumer_example_prints_what_the_reference_prints(mock_proc):
    """producer.py writes ten keyed records to a 4-partition topic of
    the standalone mock; both packages' consumer.py read them all (each
    its own group) and print the same lines."""
    _example("port", "producer", mock_proc, "ex")
    port = _consume("port", mock_proc, "ex", 10)
    ref = _consume("ref", mock_proc, "ex", 10)
    assert len(port) == 10 and sorted(port) == sorted(ref)


def test_performance_cpu_backend():
    out = _example("port", "performance", "-P", "-z", "lz4", "-c", "2000",
                   "--partitions", "4", "--backend", "cpu")
    assert "% 2000 msgs delivered (0 failed, 0 stuck)" in out


def test_performance_gpu_backend_without_a_card_exits_nonzero():
    """No card visible: the run stops and names the missing card; it
    never falls back to the CPU provider."""
    r = subprocess.run(
        [sys.executable, "-m", "librdkafka_tpu_torch.examples.performance",
         "-P", "-c", "100", "--backend", "gpu"],
        capture_output=True, text=True, timeout=90, cwd=ROOT,
        env=dict(ENV, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "msgs delivered" not in r.stdout


def test_performance_defaults_to_the_card():
    """With no --backend the example asks for the card: on a host with
    none it stops, never measuring the CPU provider unasked."""
    r = subprocess.run(
        [sys.executable, "-m", "librdkafka_tpu_torch.examples.performance",
         "-P", "-c", "100"],
        capture_output=True, text=True, timeout=90, cwd=ROOT,
        env=dict(ENV, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "--backend gpu" in r.stderr and "no CUDA device" in r.stderr
    assert "msgs delivered" not in r.stdout
