"""The harness: BENCHMARK.json against its required shape and the
files it names, a short rehearsal of each traffic kind on the kernels'
plain versions (``--device cpu``), each control and each fault of the
timed path coming out not correct, and, on a card, a short run of each
cell.

    python -m pytest kbench/tests/test_kbench_harness.py
    python -m pytest -m gpu kbench/tests/test_kbench_harness.py   # card
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KB = os.path.join(ROOT, "kbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def test_benchmark_json_shape():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["kbench"] and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1


def test_every_workload_file_names_a_config_and_a_traffic_kind():
    for f in os.listdir(os.path.join(KB, "workloads")):
        cell = _json(os.path.join(KB, "workloads", f))
        assert os.path.exists(os.path.join(KB, "configs",
                                           cell["config"] + ".json"))
        assert os.path.exists(os.path.join(KB, "traffic",
                                           cell["traffic"] + ".py"))


def test_files_named_by_the_benchmark_exist():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        body = _json(os.path.join(ROOT, c["file"]))
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["controls"], "a configuration names its control"
    for w in b["workloads"]:
        cell = _json(os.path.join(KB, "workloads", w["name"] + ".json"))
        assert cell["config"] == w["config"] in configs
        assert cell["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(KB, "traffic",
                                           w["traffic"] + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        base = m["name"].split(".")[0]
        assert os.path.exists(os.path.join(KB, "metrics", base + ".py"))


#: each traffic kind at a size the CPU runs in seconds
SMALL = {
    "open_produce": ["--param", "rate=200", "--param",
                     "warmup_records=64"],
}


def workload(cell: str) -> dict:
    return _json(os.path.join(KB, "workloads", cell + ".json"))


def _run(script: str, cell: str, *extra: str, seconds: str = "2"):
    kind = workload(cell)["traffic"]
    pr = subprocess.run(
        [sys.executable, os.path.join(KB, script), "--workload", cell,
         "--seed", "4294967311", "--seconds", seconds, "--trace", "0",
         *SMALL[kind], *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert pr.returncode == 0, pr.stderr[-3000:]
    return json.loads(pr.stdout.strip().splitlines()[-1]), pr.stderr


def _one_cell_per_kind() -> list[str]:
    """A cell of each traffic kind."""
    seen = {}
    for n in (w["name"] for w in bench()["workloads"]):
        seen.setdefault(workload(n)["traffic"], n)
    return list(seen.values())


@pytest.mark.parametrize("cell", _one_cell_per_kind())
def test_rehearsal_prints_the_result_line(cell):
    res, err = _run("run.py", cell, "--device", "cpu")
    assert list(res)[:5] == list(RESULT_KEYS) and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert res["covered"]["records_sampled"] > 0
    # each compared number is also one of stderr's last lines
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert tail == [f"check {k} {v['value']} limit {v['limit']}"
                    for k, v in res["checks"].items()]


def _controls() -> list[tuple[str, str]]:
    out = []
    for cell in _one_cell_per_kind():
        cfg = _json(os.path.join(KB, "configs",
                                 workload(cell)["config"] + ".json"))
        for c in cfg["controls"]:
            out.append((cell, c["name"]))
    return out


@pytest.mark.parametrize("cell,control", _controls())
def test_control_is_not_correct(cell, control):
    res, _ = _run("control.py", cell, "--device", "cpu",
                  "--control", control)
    assert res["correct"] is False


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and kbench/, a run
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(KB, tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = bench()["workloads"][0]["name"]
    pr = subprocess.run(
        [sys.executable, "kbench/run.py", "--workload", cell, "--seed", "1",
         "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert pr.returncode != 0 and '"correct"' not in pr.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pr = subprocess.run(
        [sys.executable, os.path.join(KB, "run.py"), "--workload", cell,
         "--seed", "4294967331", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert pr.returncode == 0, pr.stderr[-3000:]
    res = json.loads(pr.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
