"""A cell's control: the run with the program configured to break one
guarantee its configuration states, which the comparison has to find.

    python3 kbench/control.py --workload CELL --seed N --seconds S
        [--trace 0|1] [--control NAME]

The configuration file's ``controls`` name each control and the client
keys it sets over the configuration's own (``producer`` and
``consumer``).  Without ``--control`` the configuration's first control
runs.  The run is ``run.py``'s in every other respect; its ``correct``
has to read false.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--control")
    ap.add_argument("--workload", required=True)
    args, rest = ap.parse_known_args(argv)
    with open(os.path.join(HERE, "workloads",
                           args.workload + ".json")) as f:
        config = json.load(f)["config"]
    with open(os.path.join(HERE, "configs", config + ".json")) as f:
        controls = json.load(f)["controls"]
    ctl = next(c for c in controls
               if args.control in (None, c["name"]))
    print(f"kbench control {ctl['name']}: {ctl['why']}", file=sys.stderr)

    from kbench import run
    from kbench.lib.harness import Harness
    plain = Harness.client_conf

    def client_conf(self, role, bootstrap, **extra):
        conf = plain(self, role, bootstrap, **extra)
        conf.update(ctl.get(role, {}))
        return conf

    Harness.client_conf = client_conf
    try:
        return run.main(rest + ["--workload", args.workload])
    finally:
        Harness.client_conf = plain


if __name__ == "__main__":
    sys.exit(main())
