"""The benchmark of ``librdkafka_tpu_torch`` on NVIDIA GPUs.

    python3 kbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: the
cell's traffic kind (``kbench/traffic/<kind>.py``) against the program's
clients built from the cell's configuration (``kbench/configs/``), with
its parameters (``kbench/workloads/<cell>.json``).  Its last stdout line
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer ones
with ``--trace 1``), ``device`` and, traced, ``breakdown``; then
``checks``, each number compared with its limit, also printed as the
last lines of stderr.  A metric is read by ``kbench/metrics/<name>.py``
(the name up to its first dot).

Exits non-zero, printing no result, without enough CUDA devices, when
the program is not in the checkout, or when the JAX package or JAX has
been loaded.  ``--device cpu`` runs the kernels' plain versions on the
host: tests only, never a measurement.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

# the imports below follow the clock on purpose: set-up counts them
import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

#: top-level modules that must never be loaded in a run (the JAX package
#: and JAX itself), compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "librdkafka_tpu")


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _fail(msg: str, code: int = 2) -> None:
    print(f"kbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of a metric: ``kbench/metrics/<name up to the first
    dot>.py``, its ``read(readings)``."""
    base = metric.split(".")[0]
    return _load(os.path.join(HERE, "metrics", base + ".py"),
                 "kbench_metric_" + base).read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports in a run of this kind."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    # KEY=JSON over the cell's traffic parameters: the rate sweep and the
    # tests' small sizes, never the benchmark's own runs
    ap.add_argument("--param", action="append", default=[],
                    help=argparse.SUPPRESS)
    # KEY=JSON over the configuration's client keys (producer and
    # consumer): readings of another setting, never the benchmark's runs
    ap.add_argument("--conf", action="append", default=[],
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    path = os.path.join(HERE, "workloads", args.workload + ".json")
    if not os.path.exists(path):
        _fail(f"no workload file for {args.workload!r}")
    with open(path) as f:
        cell = json.load(f)
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        _fail(f"BENCHMARK.json names no workload {args.workload!r}")
    if cell["config"] != entry["config"]:
        _fail(f"{args.workload}: its file names config {cell['config']!r}")
    with open(os.path.join(HERE, "configs", entry["config"] + ".json")) as f:
        cfg = json.load(f)
    for kv in args.param:
        k, _, v = kv.partition("=")
        cell["traffic_params"][k] = json.loads(v)
    for kv in args.conf:
        k, _, v = kv.partition("=")
        for role in ("producer", "consumer"):
            cfg[role][k] = json.loads(v)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    build = os.path.join(ROOT, "build", "kbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            _fail("no CUDA device", 3)
        if torch.cuda.device_count() < entry["chips"]:
            _fail(f"{args.workload} needs {entry['chips']} GPUs, "
                  f"{torch.cuda.device_count()} visible", 3)
    try:
        import librdkafka_tpu_torch
    except ImportError as e:
        _fail(f"the program is not in this checkout: {e}")
    if not os.path.abspath(librdkafka_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        _fail("librdkafka_tpu_torch was imported from outside the "
              f"checkout: {librdkafka_tpu_torch.__file__}")

    from kbench.lib.harness import Harness
    traffic = _load(os.path.join(HERE, "traffic", cell["traffic"] + ".py"),
                    "kbench_traffic_" + cell["traffic"])
    h = Harness(args, cell, cfg, T_START, args.device)
    try:
        traffic.run(h)
    finally:
        h.close()

    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        v = reader(m["name"])(h.r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if args.device == "cuda" else "plain versions"),
              "count": entry["chips"],
              "memory_peak_bytes": h.memory_peak}
    out = {"correct": all(v <= lim for v, lim in h.checks.values()),
           "attempted": h.attempted, "failed": h.failed,
           "metrics": metrics, "device": device}
    if args.trace and h.r.dev is not None:
        device["busy_s"] = h.r.dev["busy_s"]
        device["window_s"] = h.r.dev["window_s"]
        out["breakdown"] = h.r.dev["breakdown"]
    out["covered"] = h.covered
    out["extra"] = h.r.extra
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in h.checks.items()}
    bad = forbidden_loaded()
    if bad:
        _fail(f"loaded in this run: {', '.join(bad)}")
    for k, (v, lim) in h.checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
