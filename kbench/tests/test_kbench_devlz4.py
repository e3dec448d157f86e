"""The card's lz4 route in the benchmark (``idem64-devlz4-open-1kb``):
its readers (``device_compress_share``, ``compress_route_cpu_us``,
``lz4_rows_roofline``) on synthetic readings, each reading nothing
without its counters or device trace, and a short rehearsal of the cell
and of its control on the kernels' plain versions (``--device cpu``).

    python -m pytest kbench/tests/test_kbench_devlz4.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KB = os.path.dirname(HERE)
ROOT = os.path.dirname(KB)
sys.path.insert(0, ROOT)
from kbench.tests.test_kbench_cpu_readers import _load, readings  # noqa: E402

CELL = "idem64-devlz4-open-1kb"


def _metric(name: str):
    return _load(os.path.join("metrics", name + ".py"),
                 "kbench_test_devlz4_" + name)


#: the engine's counter deltas of a window on the route, as
#: ``harness.engine_counters`` names them
ENGINE = {"compress_jobs": 120, "compress_launches": 90,
          "compress_bytes_in": 90_000_000, "compress_bytes_out": 50_000_000,
          "compress_cpu_bytes_in": 10_000_000,
          "compress_fill_cpu_ns": 600_000_000,
          "compress_sync_cpu_ns": 300_000_000,
          "compress_frame_cpu_ns": 100_000_000}
DEV = {"busy_s": 0.2, "window_s": 30.0,
       "kernel_s": {"_anonymous_namespace_::lz4_rows_kernel": 0.05,
                    "Memcpy HtoD (Pinned -> Device)": 0.1}}


def test_device_compress_share_reads_the_launched_share():
    read = _metric("device_compress_share").read
    assert read(readings(engine=dict(ENGINE))) == 90.0
    # the parent's engine: no cpu_bytes_in counter
    old = {k: v for k, v in ENGINE.items() if k != "compress_cpu_bytes_in"}
    assert read(readings(engine=old)) is None
    assert read(readings()) is None
    idle = dict(ENGINE, compress_bytes_in=0, compress_cpu_bytes_in=0)
    assert read(readings(engine=idle)) is None
    assert read(readings(engine=dict(idle, compress_cpu_bytes_in=5))) == 0.0


def test_compress_route_cpu_us_sums_the_three_counters():
    read = _metric("compress_route_cpu_us").read
    r = readings(engine=dict(ENGINE), spans=[], delivered=2_000_000)
    assert read(r) == 1e9 / 1e3 / 2_000_000
    assert read(readings(engine=dict(ENGINE), delivered=2_000_000)) is None
    for k in ("compress_fill_cpu_ns", "compress_sync_cpu_ns",
              "compress_frame_cpu_ns"):
        e = {x: v for x, v in ENGINE.items() if x != k}
        assert read(readings(engine=e, spans=[],
                             delivered=2_000_000)) is None
    assert read(readings(engine=dict(ENGINE), spans=[],
                         delivered=0)) is None


def test_lz4_rows_roofline_reads_the_kernel_time():
    m = _metric("lz4_rows_roofline")
    got = m.read(readings(engine=dict(ENGINE), dev=DEV))
    assert got == 100.0 * 140_000_000 / 3.35e12 / 0.05
    assert m.read(readings(engine=dict(ENGINE))) is None
    no_kernel = dict(DEV, kernel_s={"Memcpy HtoD (Pinned -> Device)": 0.1})
    assert m.read(readings(engine=dict(ENGINE), dev=no_kernel)) is None
    assert m.read(readings(dev=DEV)) is None


def test_lz4_rows_roofline_stays_below_100_on_the_measured_launch():
    """The main path's launch as the bring-up measured it on an H100
    (1,024 blocks of 64 KB in 0.7079 ms), with the most its frames could
    hold (every block stored raw): a share well under 100%."""
    m = _metric("lz4_rows_roofline")
    nin = 1024 * 65536
    nout = nin + 1024 * 4 + 11
    share = m.roofline(m.round_bytes({"compress_bytes_in": nin,
                                      "compress_bytes_out": nout}),
                       0.7079e-3)
    assert 0 < share < 100
    assert round(share, 2) == 5.66


def _run(script: str, *extra: str) -> dict:
    """The cell at a size the CPU runs in seconds.  At 200 records a
    second over 64 partitions a round holds a batch or two of one
    record, below the launch quorum of four blocks, so the rehearsal
    lowers the quorum to one block to send rounds to the kernel's plain
    version."""
    pr = subprocess.run(
        [sys.executable, os.path.join(KB, script), "--workload", CELL,
         "--seed", "4294967377", "--seconds", "2", "--device", "cpu",
         "--param", "rate=200", "--param", "warmup_records=64",
         "--conf", "gpu.launch.min.batches=1", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert pr.returncode == 0, pr.stderr[-3000:]
    return json.loads(pr.stdout.strip().splitlines()[-1])


def test_rehearsal_runs_the_route():
    res = _run("run.py", "--trace", "1")
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["covered"]["records_sampled"] > 0
    m = res["metrics"]
    assert m["device_compress_share"]["value"] > 0
    assert m["compress_route_cpu_us"]["value"] > 0
    assert m["engine_thread_cpu_us.devlz4"]["value"] > 0
    # no device trace off the card
    assert "lz4_rows_roofline" not in m


def test_control_is_not_correct():
    res = _run("control.py", "--trace", "0", "--control", "no-idempotence")
    assert res["correct"] is False
    assert res["checks"]["seq_bad"]["value"] > 0
