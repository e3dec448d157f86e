"""The benchmark's plain reference of the deterministic LZ4 frame encoder
(``kbench/reference/lz4_encode.py``) held against the port's encoders on
the benchmark's own records: the native deterministic encoder
(``ops.cpu.lz4f_compress_many(deterministic=True)``) and the engine's
compress route on CPU lanes (the ``lz4_rows`` kernel's plain version)
give its frames byte for byte, the reference decoder reads them back,
and the default fast encoder does not (so the comparison can fail).
Also the benchmark's readers of the route on synthetic readings
(``kbench/tests/test_kbench_devlz4.py``; its rehearsal of the cell and
of its control, which start the benchmark's processes, run with
kbench's own tests).
"""
import importlib.util
import os

import numpy as np
import pytest

from kbench.lib.records import make_pool
from kbench.reference.lz4 import decode_frame
from kbench.reference.lz4_encode import encode_frame
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.ops import lz4_torch
from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 4294967377
POOL = make_pool(SEED, 1024)

#: one record, a 300-record batch, a batch that crosses a 64 KB block,
#: and 64 KB of seeded random (incompressible) bytes
CASES = {
    "one_record": POOL[0],
    "batch_300": b"".join(POOL[:300]),
    "crosses_64k": b"".join(POOL[1000:1070]),
    "random_64k": np.random.default_rng(SEED).integers(
        0, 256, 1 << 16, dtype=np.uint8).tobytes(),
}


def _det(bufs):
    return native.lz4f_compress_many([bytes(b) for b in bufs],
                                     deterministic=True)


def _crc_fallback(bufs, poly):
    p = native.CpuCodecProvider()
    return p.crc32c_many(bufs) if poly == "crc32c" else p.crc32_many(bufs)


@pytest.fixture(scope="module")
def reference():
    return {k: encode_frame(v) for k, v in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_native_deterministic_encoder(case, reference):
    assert reference[case] == _det([CASES[case]])[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_decodes_back(case, reference):
    assert decode_frame(reference[case]) == CASES[case]


def test_reference_equals_engine_route_on_cpu_lanes(reference):
    """One launched round of every case through ``submit_compress`` on a
    CPU lane: each frame the reference's."""
    eng = AsyncOffloadEngine(devices=["cpu"], depth=2, min_batches=1,
                             warmup=False, cpu_fallback=_crc_fallback,
                             cpu_compress_fallback=_det)
    names = sorted(CASES)
    try:
        got = eng.submit_compress([CASES[k] for k in names],
                                  window=False).result(300)
        assert eng.compress_stats["launches"] == 1
    finally:
        eng.close()
    assert lz4_torch.device_kernel_count() == 0
    assert {k: bytes(f) for k, f in zip(names, got)} == \
        {k: reference[k] for k in names}


def test_fast_encoder_differs_from_reference(reference):
    """The default fast parse writes another (equally valid) stream: a
    comparison with the reference tells the two apart."""
    batch = CASES["batch_300"]
    fast = native.lz4f_compress_many([batch])[0]
    assert fast != reference["batch_300"]
    assert decode_frame(fast) == batch


def _load_kbench_checks():
    path = os.path.join(ROOT, "kbench", "tests", "test_kbench_devlz4.py")
    spec = importlib.util.spec_from_file_location(
        "kbench_devlz4_for_tier1", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CHECKS = _load_kbench_checks()


@pytest.mark.parametrize(
    "check", sorted(n for n in dir(_CHECKS) if n.startswith("test_")
                   and n not in ("test_rehearsal_runs_the_route",
                                 "test_control_is_not_correct")))
def test_benchmark_devlz4(check):
    """kbench/tests/test_kbench_devlz4.py's checks of the route's readers
    on synthetic readings."""
    getattr(_CHECKS, check)()
