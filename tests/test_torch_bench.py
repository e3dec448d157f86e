"""The port's benchmark entry point (``python -m librdkafka_tpu_torch.bench``)
held to the root ``bench.py`` on the CPU: the reference's bench cases
(0126's JSON artifact, 0129's and 0131's static schema checks of the
chaos and fleet legs, 0136's TestBenchTrendAppend) on the port's module,
the trend rows of both modules for the same artifacts, the artifact keys
of the default leg, one small run of the ``--pipeline`` and ``--smoke``
legs on ``--device cpu`` whose rows the unchanged scripts/trendgate.py
gates, and the exit without CUDA.

The port renames ``tpu`` to ``gpu`` in key names (:data:`RENAMED`), adds
``device`` and ``kernel_launches`` to every artifact, and leaves out
``crc_mfu_pct`` (its CRC kernel does no matrix product).
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

import librdkafka_tpu_torch.bench as port

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT_SRC = os.path.join(ROOT, "librdkafka_tpu_torch", "bench.py")
REF_SRC = os.path.join(ROOT, "bench.py")

#: the reference's artifact keys the port names with ``gpu``
RENAMED = {"tpu_crc_device_ms": "gpu_crc_device_ms",
           "tpu_crc_mb_s": "gpu_crc_mb_s",
           "host_pipeline_tpu_backend_msgs_s":
               "host_pipeline_gpu_backend_msgs_s"}
#: the keys every port artifact adds
PORT_ONLY = ("obs", "device", "kernel_launches")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """The root bench.py (it imports numpy and the standard library at
    module level; its legs import the JAX package when they run)."""
    return _load(REF_SRC, "tk_bench_ref_torch")


def _dict_keys(src: str, fn_name: str) -> set:
    """Every constant key of the dict literals in function ``fn_name``."""
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    return {getattr(k, "value", None)
            for n in ast.walk(fn) if isinstance(n, ast.Dict)
            for k in n.keys} - {None}


def _run(args, tmp_path, env=None, timeout=120):
    """The port's bench as users run it, its trend ledger in tmp_path."""
    e = {**os.environ, "BENCH_TREND_PATH": str(tmp_path / "trend.jsonl"),
         **(env or {})}
    return subprocess.run([sys.executable, "-m", "librdkafka_tpu_torch.bench",
                           *args], cwd=ROOT, env=e, capture_output=True,
                          text=True, timeout=timeout)


# ------------------------------------------------------ 0126's artifact --

def test_bench_json_artifact(tmp_path, monkeypatch, ref):
    """--json <path>: the leg's summary is also written as an artifact
    carrying the obs-registry snapshot, as the reference's is."""
    monkeypatch.setenv("BENCH_TREND_PATH", str(tmp_path / "trend.jsonl"))
    got = {}
    for name, mod in (("port", port), ("ref", ref)):
        out = str(tmp_path / f"{name}.json")
        monkeypatch.setattr("sys.argv", ["bench", "--smoke", "--json", out,
                                         "--device", "cpu"])
        mod._emit({"metric": "unit", "value": 1})
        with open(out) as f:
            got[name] = json.load(f)
        assert got[name]["obs"]["schema"] == 1
        monkeypatch.setattr("sys.argv", ["bench", "--smoke", "--device",
                                         "cpu"])
        mod._emit({"metric": "unit2"})    # no --json: print only
        with open(out) as f:
            assert json.load(f)["metric"] == "unit"
    assert got["port"]["device"]["platform"] == "cpu"
    assert set(got["port"]["kernel_launches"]) == {"crc_rows", "lz4_rows"}
    for k in PORT_ONLY:
        got["port"].pop(k)
    got["ref"].pop("obs")
    assert got["port"] == got["ref"] == {"metric": "unit", "value": 1}
    # a smoke artifact without its metrics appends no row
    assert not (tmp_path / "trend.jsonl").exists()


# ------------------------------------------- 0129's and 0131's schemas --

@pytest.mark.parametrize("fn, keys", [
    ("chaos_bench", ("storm_msgs_s", "recovery_p99_ms", "recovery_p50_ms",
                     "recovery_max_ms", "storm_kills")),
    ("fleet_bench", ("fleet_msgs_s", "client_p99_ms_max", "storm_kills",
                     "recovery_p50_ms", "recovery_p99_ms"))])
def test_leg_emits_robustness_schema(fn, keys):
    """The chaos and fleet legs surface their headline numbers at the
    artifact's top level, as the reference's do."""
    src = open(PORT_SRC).read()
    got = _dict_keys(src, fn)
    for want in keys:
        assert want in got, f"{fn} must emit {want!r}"
    assert _dict_keys(open(REF_SRC).read(), fn) <= got
    assert "fleet_mini" in src and "--fleet" in src


def test_default_leg_and_codec_offload_keys(ref):
    """The default leg emits the reference's keys (``tpu`` renamed; the
    reference's one-device mesh skip has no counterpart: the port's mesh
    pool has at least two lanes); codec_offload has no MFU and no TPU
    peak."""
    psrc, rsrc = open(PORT_SRC).read(), open(REF_SRC).read()
    rename = lambda keys: {RENAMED.get(k, k) for k in keys}   # noqa: E731
    assert (rename(_dict_keys(rsrc, "main")) - {"skipped", "n_devices"}
            <= _dict_keys(psrc, "main"))
    rkeys = rename(_dict_keys(rsrc, "codec_offload")) - {"crc_mfu_pct"}
    pkeys = _dict_keys(psrc, "codec_offload")
    assert rkeys <= pkeys
    assert "crc_mfu_pct" not in pkeys and "tpu" not in " ".join(pkeys)
    for peak in (r"\b819\b", r"\b394\b", "INT8_TOPS", "v5e"):
        assert not re.search(peak, psrc), peak


def test_legs_are_the_references():
    """Every leg flag of the reference's main() is a leg of the port's."""
    def flags(path):
        return {n.value for n in ast.walk(ast.parse(open(path).read()))
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value.startswith("--") and " " not in n.value}
    assert flags(REF_SRC) <= flags(PORT_SRC)


# ------------------------------------------- 0136's TestBenchTrendAppend --

ARTIFACTS = [
    ("smoke", ["--smoke"], {
        "elapsed_s": 12.5,
        "trace_overhead": {"produce_ns_per_msg": 1500.0,
                           "combined_overhead_pct": 0.4}}),
    ("smoke", ["--smoke"], {
        "elapsed_s": 9.0, "trace_overhead": {"produce_ns_per_msg": 1234.0,
                                             "overhead_pct": 0.2}}),
    ("fleet_smoke", ["--fleet", "--smoke"], {
        "fleet_msgs_s": 800.0, "client_p99_ms_max": 40.0,
        "converged_s": 3.0, "recovery_p99_ms": None}),
    ("fleet", ["--fleet"], {"fleet_msgs_s": 900, "ok": False}),
    ("chaos", ["--chaos"], {"storm_msgs_s": 5000.0,
                            "recovery_p50_ms": 20.0,
                            "recovery_p99_ms": 80.0, "ok": True}),
    ("partitions_smoke", ["--partitions", "--smoke"], {
        "wire_reduction": 53.8, "stats_emit_flatness": 1.2,
        "scale": {"1000": {"produce_msgs_s": 40000,
                           "stats_emit_ms": 0.3}}}),
    ("partitions", ["--partitions"], {
        "wire_reduction": 60.0, "stats_emit_flatness": 2.0,
        "scale": {"1000": {"produce_msgs_s": 1, "stats_emit_ms": 0.1},
                  "100000": {"produce_msgs_s": 2, "stats_emit_ms": 0.2}}}),
    (None, ["--pipeline"], {"fake_latency": {"sync_s": 1.0}}),
    (None, [], {"tpu_crc_mb_s": 1.0, "host_pipeline_tpu_backend_msgs_s": 2}),
]


def _port_artifact(obj: dict) -> dict:
    return {RENAMED.get(k, k): v for k, v in obj.items()}


class TestBenchTrendAppend:
    def test_trend_metrics_pick_per_leg(self):
        mx = port._trend_metrics("smoke", ARTIFACTS[0][2])
        assert mx["produce_ns_per_msg"] == {"v": 1500.0, "dir": "lower"}
        assert mx["obs_overhead_pct"] == {"v": 0.4, "dir": "lower"}
        assert mx["elapsed_s"]["dir"] == "lower"
        mx = port._trend_metrics("fleet_smoke", ARTIFACTS[2][2])
        assert mx["fleet_msgs_s"] == {"v": 800.0, "dir": "higher"}
        assert mx["client_p99_ms_max"]["dir"] == "lower"
        # non-numeric / missing values are dropped, not fabricated
        assert "recovery_p99_ms" not in mx

    def test_trend_append_writes_schema_row(self, tmp_path, monkeypatch):
        path = str(tmp_path / "sub" / "trend.jsonl")
        monkeypatch.setenv("BENCH_TREND_PATH", path)
        monkeypatch.setattr(sys, "argv", ["bench", "--smoke", "--anchor"])
        port._trend_append({
            "elapsed_s": 9.0,
            "trace_overhead": {"produce_ns_per_msg": 1234.0}})
        tg = _load(os.path.join(ROOT, "scripts", "trendgate.py"),
                   "tk_trendgate_torch")
        rows = tg.load_rows(path)
        assert len(rows) == 1
        row = rows[0]
        assert row["leg"] == "smoke" and row["anchor"] is True
        assert row["schema"] == port.TREND_SCHEMA == 1
        assert row["metrics"]["produce_ns_per_msg"]["v"] == 1234.0
        assert row["rev"] and row["utc"]

    @pytest.mark.parametrize("leg, argv, obj", ARTIFACTS,
                             ids=[" ".join(a) or "default"
                                  for _l, a, _o in ARTIFACTS])
    def test_rows_equal_reference(self, tmp_path, monkeypatch, ref, leg,
                                  argv, obj):
        """For the same artifact (``tpu`` keys renamed for the port) both
        modules pick the same leg, metrics and row."""
        rows = {}
        for name, mod, art in (("port", port, _port_artifact(obj)),
                               ("ref", ref, obj)):
            path = tmp_path / f"{name}.jsonl"
            monkeypatch.setenv("BENCH_TREND_PATH", str(path))
            monkeypatch.setattr(sys, "argv", ["bench", *argv, "--anchor"])
            assert mod._trend_leg() == leg
            if leg is not None:
                assert mod._trend_metrics(leg, art) == \
                    ref._trend_metrics(leg, obj)
            mod._trend_append(art)
            rows[name] = ([json.loads(x) for x in open(path)]
                          if path.exists() else [])
        for r in rows["port"] + rows["ref"]:
            r.pop("utc")
        assert rows["port"] == rows["ref"]
        assert len(rows["port"]) == (leg is not None)

    def test_default_ledger_is_the_ports(self, monkeypatch, ref):
        monkeypatch.delenv("BENCH_TREND_PATH", raising=False)
        path = port._trend_path()
        assert path == os.path.join(ROOT, "build", "librdkafka_tpu_torch",
                                    "BENCH_TREND.jsonl")
        assert os.path.abspath(path) != os.path.abspath(ref._trend_path())


# ------------------------------------------------------- runs on the CPU --

def test_pipeline_leg_on_cpu(tmp_path):
    """``--device cpu --pipeline`` at tiny sizes: both legs bit-exact
    (the run asserts it), the engine on the kernel's plain version, the
    artifact equal to the printed line, no trend row (an untracked leg)."""
    out = tmp_path / "pipe.json"
    r = _run(["--device", "cpu", "--pipeline", "--json", str(out)],
             tmp_path, env={"BENCH_PIPE_JOBS": "4", "BENCH_PIPE_BATCHES": "2",
                            "BENCH_PIPE_LAT_MS": "1.0"})
    assert r.returncode == 0, r.stderr
    art = json.loads(out.read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == art
    assert art["device"] == {"platform": "cpu",
                             "kind": "plain versions on the host"}
    assert art["kernel_launches"] == {"crc_rows": 0, "lz4_rows": 0}
    assert art["jobs"] == 4 and art["fake_latency"]["latency_ms"] == 1.0
    eng = art["engine"]
    assert "error" not in eng, eng
    assert eng["engine_stats"]["launches"] > 0
    assert eng["engine_stats"]["cpu_fallback_jobs"] == 0
    assert not (tmp_path / "trend.jsonl").exists()


def test_smoke_leg_on_cpu_rows_pass_trendgate(tmp_path, ref):
    """``--device cpu --smoke --anchor``: every engine leg bit-identical,
    the overhead gates measured (whether they pass depends on the host's
    load), and the row it appends is the reference's row for the same
    artifact and passes the unchanged trendgate."""
    out = tmp_path / "smoke.json"
    r = _run(["--device", "cpu", "--smoke", "--anchor", "--json", str(out)],
             tmp_path)
    assert r.returncode == 0, r.stderr
    art = json.loads(out.read_text())
    for leg in ("sync", "pipelined", "fetch_pipeline", "governor", "fused",
                "device_codec", "mesh", "fetch_session", "fast_lane"):
        assert art["legs"][leg].startswith("bit-identical"), (leg, art)
    for gate in ("trace_overhead", "lockdep_overhead", "races_overhead"):
        assert art[gate]["overhead_pct"] >= 0 and "pass" in art[gate]
    ledger = tmp_path / "trend.jsonl"
    rows = [json.loads(x) for x in open(ledger)]
    assert len(rows) == 1 and rows[0]["anchor"] is True
    assert rows[0]["metrics"] == ref._trend_metrics("smoke", art)
    g = subprocess.run([sys.executable, "scripts/trendgate.py", "--ledger",
                        str(ledger)], cwd=ROOT, capture_output=True,
                       text=True, timeout=60)
    assert g.returncode == 0, (g.stdout, g.stderr)


def test_exits_without_cuda_and_without_device_cpu(tmp_path):
    """No CUDA and no ``--device cpu``: non-zero before any leg runs."""
    r = _run(["--pipeline", "--json", str(tmp_path / "x.json")], tmp_path,
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout == "" and "--device cpu" in r.stderr
    assert not (tmp_path / "x.json").exists()


def test_device_flag_takes_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["bench", "--device", "tpu"])
    with pytest.raises(SystemExit):
        port._device()
    monkeypatch.setattr(sys, "argv", ["bench", "--device", "cpu"])
    assert port._device() == "cpu"
    assert port._mesh_pool() == ["cpu"] * 8
    assert port._engine_devices() == ["cpu"]
    assert port._gpu_conf() == {"compression.backend": "gpu",
                                "gpu.device": "cpu"}
