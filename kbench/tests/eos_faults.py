"""The exactly-once copy's run with its timed path broken underneath,
as faults.py runs the producing cells':

    python kbench/tests/eos_faults.py FAULT --workload eos64-copy-1kb ...

The faults wrap the copiers' producers (the feeder runs in a process of
its own and is untouched): ``unchanged`` (produce() returns and enqueues
nothing, while the members still commit the positions they read) and
``half`` (every second record is left out of the output).
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from kbench.tests import faults  # noqa: E402

EOS_FAULTS = {"unchanged": faults._produce_unchanged,
              "half": faults._produce_half}


def main(argv=None) -> int:
    faults.FAULTS["eos_copy"] = EOS_FAULTS
    return faults.main(argv)


if __name__ == "__main__":
    sys.exit(main())
