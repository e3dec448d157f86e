"""CLI fleet runner: ``python -m librdkafka_tpu_torch.fleet``.

    python -m librdkafka_tpu_torch.fleet --list
    python -m librdkafka_tpu_torch.fleet --scenario fleet_smoke --seed 51
    python -m librdkafka_tpu_torch.fleet --fast        # tier-1 set
    python -m librdkafka_tpu_torch.fleet --all         # including the flagship

Exit status 0 iff every requested run's merged-oracle verdict is
clean.  ``replay_key`` + ``--seed`` is the replay workflow, exactly
like the chaos CLI: same seed ⇒ same plan digest + fault timeline,
against freshly launched rigs.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..chaos.oracle import OracleViolation
from .scenarios import SCENARIOS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m librdkafka_tpu_torch.fleet",
        description="multi-process client fleets against the "
                    "supervised out-of-process cluster")
    ap.add_argument("--scenario", action="append", default=[],
                    help="scenario name (repeatable); see --list")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the scenario's default seed "
                         "(replay-from-seed)")
    ap.add_argument("--fast", action="store_true",
                    help="run the fast (tier-1) scenario set")
    ap.add_argument("--all", action="store_true",
                    help="run every scenario, flagship included")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios (name, tier, default seed, "
                         "invariants checked) and exit")
    args = ap.parse_args(argv)

    if args.list:
        print(f"{'scenario':24s} {'tier':5s} {'seed':>5s}  "
              f"invariants checked")
        for name, sc in SCENARIOS.items():
            print(f"{name:24s} {sc.tier:5s} {sc.seed:5d}  "
                  f"{sc.invariants}")
            print(f"{'':24s} {'':5s} {'':5s}  - {sc.desc}")
        return 0

    names = list(args.scenario)
    if args.all:
        names = list(SCENARIOS)
    elif args.fast:
        names = [n for n, sc in SCENARIOS.items() if sc.tier == "fast"]
    if not names:
        ap.error("pick --scenario NAME, --fast, or --all (see --list)")

    rc = 0
    for name in names:
        if name not in SCENARIOS:
            print(f"unknown scenario {name!r} (see --list)",
                  file=sys.stderr)
            return 2
        kwargs = {} if args.seed is None else {"seed": args.seed}
        print(f"== {name} ==", file=sys.stderr)
        try:
            report = SCENARIOS[name].fn(**kwargs)
        except OracleViolation as v:
            report = v.report
            rc = 1
        print(json.dumps(report, indent=1, default=str))
        ok = report.get("ok")
        fm = report.get("fleet_metrics") or {}
        print(f"== {name}: {'PASS' if ok else 'FAIL'} "
              f"(workers={report.get('workers')} "
              f"acked={report.get('acked')} "
              f"fleet_msgs_s={fm.get('fleet_msgs_s')})", file=sys.stderr)
        if not ok:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
