"""Runs of the benchmark one after another, each in its own process, as
the checks of the benchmark make them; for measuring spreads, proving
cells and sweeping a rate.

    python3 kbench/series.py --cell CELL --seeds 11,12,13 [--trace 0|1]
        [--seconds S] [--param KEY=JSON ...] [--out FILE.jsonl]
        [--control NAME] [--conf KEY=JSON ...]

Each run's result line (or its failure) goes to ``--out`` as one JSON
line with the run's wall time, and a summary of every metric (median
and quartile spread over the runs) is printed at the end.  With
``--control NAME`` each run is ``kbench/control.py`` instead, which puts
the named control in the program's place.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def host() -> str:
    """Free memory and disk, printed between runs: a run that leaks
    either shows here before the machine runs out."""
    with open("/proc/meminfo") as f:
        mem = {k: v.split()[0] for k, v in
               (line.split(":", 1) for line in f)}
    st = os.statvfs(ROOT)
    return (f"MemAvailable {int(mem['MemAvailable']) >> 20} GiB, "
            f"disk free {st.f_bavail * st.f_frsize >> 30} GiB")


def spread(vals: list) -> float | None:
    """Interquartile distance over the median (statistics.quantiles)."""
    if len(vals) < 2:
        return None
    q1, med, q3 = statistics.quantiles(vals, n=4)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--param", action="append", default=[])
    ap.add_argument("--control")
    ap.add_argument("--conf", action="append", default=[])
    ap.add_argument("--out")
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    print(f"card: {card()}", flush=True)
    rows = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, os.path.join(
            HERE, "control.py" if args.control else "run.py"),
            "--workload", args.cell, "--seed", seed,
            "--seconds", str(seconds), "--trace", str(args.trace)]
        if args.control:
            cmd += ["--control", args.control]
        for p in args.param:
            cmd += ["--param", p]
        for c in args.conf:
            cmd += ["--conf", c]
        t0 = time.perf_counter()
        try:
            pr = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                text=True, timeout=args.timeout)
            rc, out, err = pr.returncode, pr.stdout, pr.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        wall = time.perf_counter() - t0
        lines = out.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines and rc == 0 else None
        except json.JSONDecodeError:
            res = None
        row = {"cell": args.cell, "seed": int(seed), "trace": args.trace,
               "seconds": seconds, "control": args.control,
               "param": args.param, "conf": args.conf, "rc": rc, "wall_s": wall,
               "result": res}
        if res is None or not res.get("correct"):
            row["stderr_tail"] = err[-3000:]
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        brief = ({k: v["value"] for k, v in res["metrics"].items()}
                 if res else None)
        print(json.dumps({"seed": int(seed), "rc": rc,
                          "wall_s": round(wall, 1),
                          "correct": res and res["correct"],
                          "metrics": brief,
                          "device": res and res["device"],
                          "extra": res and res.get("extra")}), flush=True)
        if row.get("stderr_tail"):
            print(row["stderr_tail"][-1500:], flush=True)
        print(host(), flush=True)
    ok = [r["result"] for r in rows if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    for k in names:
        vals = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        print(f"{k}: median {statistics.median(vals)!r} spread "
              f"{spread(vals)!r} n {len(vals)} values {vals!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
