"""The port's analysis gate (librdkafka_tpu_torch/analysis/{lint,stress,
__main__}.py): both linters report the same findings on each rule's
fixture (test 0128's and test 0130's snippets; the port's lock-factory
scope names ``ops/gpu.py`` where the JAX package's names ``ops/tpu.py``),
the port's ``lint_package()`` is clean, the port's CONFIGURATION.md is
its conf table's generated document (so no ``gpu.*`` property ships
without a row), the lockset detector sees the engine's staging rings
under ``engine.staging``, importing the port (and running a CPU client)
loads no torch, the stress gate's device legs raise without a card, and
``run_stress(device="cpu")`` drives every leg lockdep-clean."""
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from librdkafka_tpu.analysis import lint as jax_lint
from librdkafka_tpu.analysis import stress as jax_stress
from librdkafka_tpu_torch.analysis import lint, lockdep, races, stress
from librdkafka_tpu_torch.analysis.__main__ import main as analysis_main
from librdkafka_tpu_torch.client import conf as port_conf
from librdkafka_tpu_torch.mock import external as port_external
from librdkafka_tpu_torch.obs import collect as port_collect
from librdkafka_tpu_torch.obs import metrics as port_metrics
from librdkafka_tpu_torch.obs import trace as port_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "librdkafka_tpu_torch")


@pytest.fixture(autouse=True)
def _port_rig_clean(tmp_path):
    """Flight dumps land in this test's own directory (the port's
    ``trace.flight_dir`` restored after); afterwards no port subprocess
    is alive (reaped if one is), the port's obs plane is released and
    neither checker is left on."""
    prev = port_trace.flight_dir
    port_trace.flight_dir = str(tmp_path)
    try:
        yield
    finally:
        port_trace.flight_dir = prev
        leaked = port_external.active_subprocess_pids()
        if leaked:
            port_external.reap_leaked()
    assert not leaked, f"leaked port subprocess(es): {leaked}"
    assert not port_trace.enabled and port_trace.active_ring_count() == 0
    assert not port_metrics.enabled and port_metrics.registered_count() == 0
    assert port_collect.active_dump_dir_count() == 0
    assert not lockdep.enabled and not races.enabled


# ============================================================ lint rules ==
_CONF_BAD = ('PROPERTIES = [\n'
             '    _p("x.ms", GLOBAL, "int", 5, "doc"),\n'
             ']\n')
_CONF_GOOD = ('PROPERTIES = [\n'
              '    _p("x.ms", GLOBAL, "int", 5, "doc", vmin=0, vmax=9),\n'
              '    _p("y.ms", GLOBAL, "int", 5, "Alias.", alias="x.ms"),\n'
              ']\n')
_SLEEP = "import time\nwhile True:\n    time.sleep(0.1)\n"
_TRACE = "_trace.instant('a', 'b')\n"
_GUARD_VAR = ("def f():\n"
              "    t0 = _trace.now() if _trace.enabled else 0\n"
              "    if t0:\n"
              "        _trace.complete('a', 'b', t0)\n")
_GUARD_ATTR = ("class P:\n"
               "    def s(self):\n"
               "        if _trace.enabled:\n"
               "            self.t0 = _trace.now()\n"
               "    def f(self):\n"
               "        if self.t0:\n"
               "            _trace.complete('a', 'b', self.t0)\n")
_EXCEPT = "try:\n    f()\nexcept:\n    pass\n"
_RANDOM = "import random\nx = random.random()\n"
_THREAD = "import threading\nt = threading.Thread(target=f)\n"
_THREAD_SUB = ("import threading\n"
               "class P(threading.Thread):  # lint: ok shared-state\n"
               "    def __init__(self):\n"
               "        super().__init__(daemon=True)\n")
_ACQUIRE = "lk.acquire()\ntry:\n    f()\nfinally:\n    lk.release()\n"
_LOCK = "import threading\nlk = threading.Lock()\n"
_RACY = ("from ..analysis.locks import new_lock\n\n"
         "class Racy:\n"
         "    def __init__(self):\n"
         "        self._lock = new_lock('x.y')\n"
         "        self.table = {}\n")
_DECLARED = ("from ..analysis.locks import new_lock\n"
             "from ..analysis.races import shared\n\n"
             "class Fine:\n"
             "    table = shared('x.table')\n\n"
             "    def __init__(self):\n"
             "        self._lock = new_lock('x.y')\n"
             "        self.table = {}\n")
_SLOTS = ("from ..analysis.races import register_slots\n"
          "import threading\n\n"
          "class SlotFine:\n"
          "    __slots__ = ('q',)\n"
          "    def __init__(self):\n"
          "        self.t = threading.Thread(target=None, name='x')\n\n"
          "register_slots(SlotFine, 'q')\n")
_PRAGMA = ("from ..analysis.locks import new_lock\n\n"
           "class Judged:  # lint: ok shared-state\n"
           "    def __init__(self):\n"
           "        self._lock = new_lock('x.y')\n")

#: (id, source, path in the port, doc names, rules the port must find)
RULE_CASES = [
    ("sleep-poll", _SLEEP, "client/x.py", None, ["sleep-poll"]),
    ("sleep-poll-out-of-scope", _SLEEP, "ops/x.py", None, []),
    ("sleep-poll-no-loop", "import time\ntime.sleep(0.1)\n",
     "client/x.py", None, []),
    ("sleep-poll-pragma", _SLEEP.replace(
        "(0.1)\n", "(0.1)  # lint: ok sleep-poll\n"), "client/x.py", None, []),
    ("conf-prop-range", _CONF_BAD, "client/conf.py", {"x.ms"},
     ["conf-prop"]),
    ("conf-prop-good", _CONF_GOOD, "client/conf.py", {"x.ms", "y.ms"}, []),
    ("conf-prop-doc-row", _CONF_GOOD, "client/conf.py", {"x.ms"},
     ["conf-prop"]),
    ("conf-prop-other-file", _CONF_BAD, "client/other.py", None, []),
    ("trace-guard", _TRACE, "client/x.py", None, ["trace-guard"]),
    ("trace-guard-guarded", "if _trace.enabled:\n    " + _TRACE,
     "client/x.py", None, []),
    ("trace-guard-var", _GUARD_VAR, "ops/x.py", None, []),
    ("trace-guard-attr", _GUARD_ATTR, "client/x.py", None, []),
    ("trace-guard-tracer-exempt", _TRACE.replace("_trace", "trace"),
     "obs/trace.py", None, []),
    ("bare-except", _EXCEPT, "utils/x.py", None, ["bare-except"]),
    ("bare-except-named", _EXCEPT.replace("except:", "except Exception:"),
     "utils/x.py", None, []),
    ("chaos-random", _RANDOM, "chaos/x.py", None, ["chaos-random"]),
    ("chaos-random-fleet", _RANDOM, "fleet/x.py", None, ["chaos-random"]),
    ("chaos-random-seeded",
     "import random\nrng = random.Random(7)\nx = rng.random()\n",
     "chaos/x.py", None, []),
    ("chaos-random-out-of-scope", _RANDOM, "mock/x.py", None, []),
    ("thread-name", _THREAD, "ops/x.py", None, ["thread-name"]),
    ("thread-name-named", _THREAD.replace("f)", "f, name='x')"),
     "ops/x.py", None, []),
    ("thread-name-subclass", _THREAD_SUB, "mock/x.py", None,
     ["thread-name"]),
    ("thread-name-subclass-named", _THREAD_SUB.replace(
        "daemon=True", "daemon=True, name='p'"), "mock/x.py", None, []),
    ("manual-acquire", _ACQUIRE, "client/x.py", None, ["manual-acquire"]),
    ("manual-acquire-with", "with lk:\n    f()\n", "client/x.py", None, []),
    ("manual-acquire-lockdep-exempt", _ACQUIRE, "analysis/lockdep.py",
     None, []),
    *[(f"lock-factory-{p}", _LOCK, p, None, ["lock-factory"])
      for p in ("client/x.py", "mock/x.py", "chaos/x.py", "fleet/x.py",
                "ops/engine.py", "ops/gpu.py")],
    ("lock-factory-obs", _LOCK, "obs/x.py", None, []),
    ("lock-factory-kernel-module", _LOCK, "ops/crc32c_torch.py", None, []),
    ("lock-factory-factory", "lk = new_lock('x')\n", "client/x.py", None,
     []),
    ("shared-state", _RACY, "client/fake.py", None, ["shared-state"]),
    ("shared-state-declared", _DECLARED, "client/fake.py", None, []),
    ("shared-state-slots", _SLOTS, "mock/fake.py", None, []),
    ("shared-state-pragma", _PRAGMA, "client/fake.py", None, []),
    ("shared-state-out-of-scope", _RACY, "obs/fake.py", None, []),
]


def _jax_path(path):
    """The JAX package's name for a port path: its device provider is
    ops/tpu.py where the port's is ops/gpu.py."""
    return "ops/tpu.py" if path == "ops/gpu.py" else path


@pytest.mark.parametrize("src,path,docs,want",
                         [c[1:] for c in RULE_CASES],
                         ids=[c[0] for c in RULE_CASES])
def test_lint_findings_equal_jax(src, path, docs, want):
    port = lint.lint_source(src, path, doc_names=docs)
    ref = jax_lint.lint_source(src, _jax_path(path), doc_names=docs)
    assert [f.rule for f in port] == want
    assert [(f.line, f.rule) for f in port] == \
        [(f.line, f.rule) for f in ref]


def test_lint_scope_renames_tpu_to_gpu():
    assert lint.lint_source(_LOCK, "ops/tpu.py") == []
    assert [f.rule for f in jax_lint.lint_source(_LOCK, "ops/tpu.py")] == [
        "lock-factory"]


def test_lint_doc_row_names_the_port_generator():
    (f,) = lint.lint_source(_CONF_GOOD, "client/conf.py", doc_names={"x.ms"})
    assert "python -m librdkafka_tpu_torch.client.conf" in f.msg


def test_lint_clean_over_the_port():
    findings = lint.lint_package()
    assert findings == [], "\n".join(str(f) for f in findings)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert analysis_main(["lint", "--device", "cpu"]) == 0
    assert "lint: clean" in buf.getvalue()


def test_analysis_cli_rejects_unknown_device():
    with redirect_stdout(io.StringIO()):
        assert analysis_main(["stress", "--device", "tpu"]) == 2
        assert analysis_main(["nope"]) == 2


# ==================================================== configuration doc ==
def test_port_configuration_md_is_generated():
    """The port's CONFIGURATION.md is exactly what ``python -m
    librdkafka_tpu_torch.client.conf`` prints, so every property of its
    table, each gpu.* key included, has a row the linter can see."""
    with open(os.path.join(PORT_DIR, "CONFIGURATION.md")) as f:
        assert f.read() == port_conf.generate_configuration_md() + "\n"
    names = lint._doc_names(PORT_DIR)
    gpu = {p.name for p in port_conf.PROPERTIES
           if p.name.startswith("gpu.") and not p.hidden}
    assert len(gpu) == 11 and gpu <= names
    assert {p.name for p in port_conf.PROPERTIES if not p.hidden} <= names


# ====================================================== staging lockset ==
def test_races_sees_staging_rings_under_engine_staging():
    """A pipelined round through the engine on the CPU lanes: the
    lockset detector records the staging rings' accesses from the
    dispatch thread and the closing thread, and their candidate lockset
    is exactly the staging lock."""
    from librdkafka_tpu_torch import GpuCodecProvider, submit_batches
    from librdkafka_tpu_torch.protocol.msgset import Record
    with lockdep.scope(), races.scope() as st:
        races.enable()
        try:
            prov = GpuCodecProvider(device="cpu", min_batches=1,
                                    governor=False, min_transport_mb_s=0,
                                    mesh_devices=1)
            try:
                assert prov.wait_warm(60)
                parts = [[Record(value=b"x%d" % i * 40) for i in range(20)]
                         for _ in range(8)]
                a = submit_batches(prov, parts, "lz4", 1_700_000_000_000)
                b = submit_batches(prov, parts, "lz4", 1_700_000_000_000)
                a.result()
                b.result()
                assert prov._engine.stats["launches"] >= 2
            finally:
                prov.close()
            staged = [vs for vs in st.vars.values()
                      if vs.var in ("engine.staging.rings",
                                    "engine.staging.next")
                      and vs.state == "shared_modified"]
            assert {vs.var for vs in staged} == {"engine.staging.rings",
                                                 "engine.staging.next"}
            for vs in staged:
                assert races._lockset_names(vs.lockset) == [
                    "engine.staging"], vs.var
                assert len(set(vs.threads.values())) >= 2
            rep = races.report()
            assert races.clean(rep), races.format_report(rep)
        finally:
            races.disable()


# ============================================================ import cost ==
def test_import_and_cpu_client_load_no_torch():
    """Importing the port, its standalone mock, chaos and fleet, and a
    produce -> consume round trip on the CPU provider with check.crcs
    leave torch unloaded (the GPU provider is exported lazily)."""
    code = (
        "import sys\n"
        "import librdkafka_tpu_torch\n"
        "import librdkafka_tpu_torch.mock.standalone\n"
        "import librdkafka_tpu_torch.chaos, librdkafka_tpu_torch.fleet\n"
        "import librdkafka_tpu_torch.analysis.stress\n"
        "assert 'torch' not in sys.modules, 'import'\n"
        "from librdkafka_tpu_torch import Consumer, Producer\n"
        "p = Producer({'bootstrap.servers': '', 'test.mock.num.brokers': 1,"
        " 'compression.codec': 'lz4', 'linger.ms': 2})\n"
        "for i in range(20):\n"
        "    p.produce('t', value=b'v%d' % i, partition=0)\n"
        "assert p.flush(30) == 0\n"
        "c = Consumer({'bootstrap.servers':"
        " p._rk.mock_cluster.bootstrap_servers(), 'group.id': 'g',"
        " 'auto.offset.reset': 'earliest', 'check.crcs': True})\n"
        "c.subscribe(['t'])\n"
        "got = 0\n"
        "for _ in range(200):\n"
        "    m = c.poll(0.1)\n"
        "    got += m is not None and m.error is None\n"
        "    if got == 20:\n"
        "        break\n"
        "c.close()\n"
        "p.close()\n"
        "assert got == 20, got\n"
        "assert 'torch' not in sys.modules, 'client'\n"
        "from librdkafka_tpu_torch import GpuCodecProvider\n"
        "assert 'torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


# ============================================================ stress gate ==
def test_schedule_seeds_equal_jax():
    assert stress.SCHEDULE_SEEDS == jax_stress.SCHEDULE_SEEDS
    assert len(stress.SCHEDULE_SEEDS) >= 2


@pytest.mark.parametrize("leg", ["_engine_pipeline_leg", "_devcodec_leg"])
def test_device_legs_raise_without_a_card(monkeypatch, leg):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(stress, leg)()


@pytest.mark.chaos
@pytest.mark.fleet
def test_run_stress_on_cpu_lockdep_clean():
    """Every leg of the gate (engine pipeline and device codec on the
    kernels' plain versions, txn, fast chaos storm, external SIGKILL
    storm, fleet smoke, fetch sessions, fast lane) under one lockdep
    window: no cycle, no lock held across a blocking call."""
    rep = stress.run_stress(device="cpu")
    assert lockdep.clean(rep), lockdep.format_report(rep)
    assert rep["acquisitions"] > 0
