"""The ``eos_copy`` traffic kind in the harness's tests: its rehearsal
size (``SMALL``), and an empty ``FAULTS`` entry, because its faults run
through ``eos_faults.py`` (``test_kbench_eos_faults.py``), not through
``faults.py``, which ``test_kbench_faults.py`` starts."""
from kbench.tests import faults, test_kbench_harness

#: 4 copiers over 8 partitions at 800 records a second; codec jobs on
#: the native CPU paths (the kernels' plain versions, hundreds of torch
#: calls a round beside eight clients, can hold a commit for seconds)
EOS_SMALL = ["--param", "rate=800", "--param", "warmup_records=400",
             "--param", "partitions=8",
             "--conf", "gpu.launch.min.batches=64"]

test_kbench_harness.SMALL.setdefault("eos_copy", EOS_SMALL)
faults.FAULTS.setdefault("eos_copy", {})
