"""CLI storm runner: ``python -m librdkafka_tpu_torch.chaos``.

    python -m librdkafka_tpu_torch.chaos --list
    python -m librdkafka_tpu_torch.chaos --scenario external_kill9_eos --seed 21
    python -m librdkafka_tpu_torch.chaos --fast          # the tier-1 smoke set
    python -m librdkafka_tpu_torch.chaos --all           # everything but soak
    python -m librdkafka_tpu_torch.chaos --all --soak    # everything
    python -m librdkafka_tpu_torch.chaos --fast --device cpu

``--device`` goes to the scenarios that drive a device route
(``hot_topic_flood``): ``cuda`` (their default) or ``cpu``, the kernels'
plain versions.

Exit status 0 iff every requested storm's oracle verdict is clean
(``oracle_selftest`` passes by *detecting* its planted violation).
Reports print as JSON — the ``replay_key`` field plus ``--seed`` is the
replay workflow: same seed, same fault timeline, byte-for-byte (also
against the out-of-process cluster: a fresh supervisor resolves the
same targets).
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys

from .oracle import OracleViolation
from .scenarios import SCENARIOS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m librdkafka_tpu_torch.chaos",
        description="chaos storms over the mock cluster (in-process "
                    "and out-of-process tiers)")
    ap.add_argument("--scenario", action="append", default=[],
                    help="scenario name (repeatable); see --list")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the scenario's default seed "
                         "(replay-from-seed)")
    ap.add_argument("--fast", action="store_true",
                    help="run the fast (tier-1) scenario set")
    ap.add_argument("--all", action="store_true",
                    help="run every scenario except the soak tier "
                         "(add --soak to include it)")
    ap.add_argument("--soak", action="store_true",
                    help="include the multi-minute soak storms in "
                         "--all (or run them via --scenario)")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios (name, tier, default seed, "
                         "invariants checked) and exit")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="device of the scenarios with a device route "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    if args.list:
        print(f"{'scenario':32s} {'tier':5s} {'seed':>5s}  "
              f"invariants checked")
        for name, sc in SCENARIOS.items():
            print(f"{name:32s} {sc.tier:5s} {sc.seed:5d}  "
                  f"{sc.invariants}")
            print(f"{'':32s} {'':5s} {'':5s}  - {sc.desc}")
        return 0

    names = list(args.scenario)
    if args.all:
        names = [n for n, sc in SCENARIOS.items()
                 if sc.tier != "soak" or args.soak]
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
        fn = SCENARIOS[name].fn
        kwargs = {} if args.seed is None else {"seed": args.seed}
        if (args.device is not None
                and "device" in inspect.signature(fn).parameters):
            kwargs["device"] = args.device
        print(f"== {name} ==", file=sys.stderr)
        try:
            report = fn(**kwargs)
        except OracleViolation as v:
            report = v.report
            rc = 1
        # timeline is valuable but long; keep stderr JSON complete and
        # stdout summary humane
        print(json.dumps(report, indent=1, default=str))
        ok = report.get("ok")
        if name == "oracle_selftest":
            ok = not ok and report.get("diff_path")
        status = "PASS" if ok else "FAIL"
        print(f"== {name}: {status} (acked={report.get('acked')} "
              f"consumed={report.get('consumed')})", file=sys.stderr)
        if not ok:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
