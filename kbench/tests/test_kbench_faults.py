"""Each fault of the timed path that a cell can have makes the run's
``correct`` false: a step that returns its state unchanged, half of the
work left out, an answer altered where it is produced (see faults.py).
The kernels' plain versions stand in for the card (``--device cpu``).

    python -m pytest kbench/tests/test_kbench_faults.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from kbench.tests.faults import FAULTS
from kbench.tests.test_kbench_harness import (KB, ROOT, SMALL,
                                              _one_cell_per_kind, workload)


def _cases():
    return [(cell, f) for cell in _one_cell_per_kind()
            for f in FAULTS[workload(cell)["traffic"]]]


@pytest.mark.parametrize("cell,fault", _cases())
def test_fault_is_not_correct(cell, fault):
    kind = workload(cell)["traffic"]
    pr = subprocess.run(
        [sys.executable, os.path.join(KB, "tests", "faults.py"), fault,
         "--workload", cell, "--seed", "4294967319", "--seconds", "2",
         "--trace", "0", "--device", "cpu", *SMALL[kind]],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert pr.returncode == 0, pr.stderr[-3000:]
    res = json.loads(pr.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
