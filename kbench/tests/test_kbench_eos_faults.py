"""Each fault of the exactly-once copy's timed path makes the run's
``correct`` false (see eos_faults.py), on the kernels' plain versions
(``--device cpu``).

    python -m pytest kbench/tests/test_kbench_eos_faults.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from kbench.tests.conftest import EOS_SMALL
from kbench.tests.eos_faults import EOS_FAULTS
from kbench.tests.test_kbench_harness import KB, ROOT, bench, workload

CELLS = [w["name"] for w in bench()["workloads"]
         if workload(w["name"])["traffic"] == "eos_copy"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(EOS_FAULTS))
def test_eos_fault_is_not_correct(cell, fault):
    pr = subprocess.run(
        [sys.executable, os.path.join(KB, "tests", "eos_faults.py"), fault,
         "--workload", cell, "--seed", "4294967319", "--seconds", "2",
         "--trace", "0", "--device", "cpu", *EOS_SMALL],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert pr.returncode == 0, pr.stderr[-3000:]
    res = json.loads(pr.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
