"""The port's C ABI (librdkafka_tpu_torch/capi): libtkafka.so built by gcc
from the hand-written shim tkafka.c, held against the JAX package's
library (librdkafka_tpu/capi, built here with its own cffi strings into
the test's temporary directory).

- the declarations equal the reference's, and tkafka.h compiles alone;
- the reference's unchanged tests/capi_smoke.c links against the port's
  library and passes, also with stub librdkafka_tpu, jax and cffi
  packages (that raise on import) first on PYTHONPATH;
- the embedded interpreter's sys.executable is a Python that runs -c;
- one C program linked against each library prints the same session;
- the port's cpp_client.cpp round trip, and capi/gpu_smoke.c on the
  plain versions of the kernels (gpu.device=cpu), both legs; without a
  card, compression.backend=gpu fails from C instead of falling back.
"""
import json
import os
import re
import subprocess
import sys
import sysconfig

import pytest

from librdkafka_tpu.capi import build_capi as ref_capi
from librdkafka_tpu.client import conf as ref_conf
from librdkafka_tpu_torch.capi import build_capi, smoke
from librdkafka_tpu_torch.client import conf as port_conf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPI_SMOKE = os.path.join(ROOT, "tests", "capi_smoke.c")
EXAMPLES = os.path.join(ROOT, "librdkafka_tpu_torch", "examples")


def _norm(s: str) -> str:
    return re.sub(r"\s+", " ", s).strip()


def _run(exe, *args, env=None, timeout=120):
    r = subprocess.run([exe, *args], capture_output=True, text=True,
                       timeout=timeout, env=env)
    assert r.returncode == 0, (r.returncode, r.stdout[-2000:],
                               r.stderr[-3000:])
    return r.stdout


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    """The port's library and the C programs linked against it."""
    d = tmp_path_factory.mktemp("capi")
    build_capi.build()
    return {name: build_capi.compile_program(src, str(d / name))
            for name, src in (
                ("capi_smoke", CAPI_SMOKE),
                ("capi_client", os.path.join(EXAMPLES, "capi_client.c")),
                ("cpp_client", os.path.join(EXAMPLES, "cpp_client.cpp")),
                ("gpu_smoke", smoke.SRC))}


def test_declarations_equal_the_reference():
    assert _norm(build_capi.TYPES) == _norm(ref_capi.TYPES)
    assert _norm(build_capi.FUNCS) == _norm(ref_capi.FUNCS)
    names = re.findall(r"\b(tk_\w+)\(", build_capi.FUNCS)
    assert len(names) == len(set(names)) == 42
    assert "typedef struct tk_msg" in build_capi.TYPES


def test_header_compiles_alone(tmp_path):
    build_capi.build()
    src = tmp_path / "hdr.c"
    src.write_text('#include "tkafka.h"\nint main(void){return 0;}\n')
    subprocess.run(["gcc", "-std=c99", "-fsyntax-only", "-I",
                    build_capi.BUILD_DIR, str(src)],
                   check=True, capture_output=True)
    with open(build_capi.HEADER) as f:
        assert f.read() == build_capi.HEADER_TEXT


def _stub_env(tmp_path, report=None) -> dict:
    """PYTHONPATH led by librdkafka_tpu, jax and cffi packages that raise
    on import, and a sitecustomize that (with ``report``) writes the
    embedded interpreter's sys.executable and what it prints for -c."""
    stub = tmp_path / "stub"
    for name in ("librdkafka_tpu", "jax", "cffi"):
        (stub / name).mkdir(parents=True)
        (stub / name / "__init__.py").write_text(
            f"raise ImportError('the embedded interpreter imported {name}')\n")
    (stub / "sitecustomize.py").write_text(
        "import json, os, subprocess, sys\n"
        "out = os.environ.pop('TK_EXE_REPORT', None)\n"
        "if out:\n"
        "    r = subprocess.run([sys.executable, '-c', 'print(6 * 7)'],\n"
        "                       capture_output=True, text=True, timeout=60)\n"
        "    with open(out, 'w') as f:\n"
        "        json.dump([sys.executable, r.returncode, r.stdout], f)\n")
    env = dict(os.environ, PYTHONPATH=str(stub))
    if report is not None:
        env["TK_EXE_REPORT"] = str(report)
    return env


@pytest.mark.parametrize("stubbed", [False, True],
                         ids=["plain", "reference-stubbed"])
def test_reference_capi_smoke_on_port_library(bins, tmp_path, stubbed):
    """tests/capi_smoke.c, unchanged, against the port's library; with
    stubbed=True the embedded interpreter may import nothing of the JAX
    package, jax or cffi."""
    env = _stub_env(tmp_path) if stubbed else None
    out = _run(bins["capi_smoke"], env=env)
    assert "CAPI-OK" in out and "all pass" in out


def test_embedded_sys_executable_runs_python(bins, tmp_path):
    """sys.executable inside a C program's interpreter is the Python that
    built the library (runs -c), not the C program (the port's
    capi_client example, which takes no -c)."""
    report = tmp_path / "exe.txt"
    out = _run(bins["capi_client"], "", "40",
               env=_stub_env(tmp_path, report))
    assert "consumed 40 messages" in out
    exe, rc, printed = json.loads(report.read_text())
    assert rc == 0 and printed.strip() == "42"
    assert os.path.abspath(exe) == os.path.abspath(sys.executable)
    assert os.path.basename(exe) != "capi_client"


PARITY_C = r"""
/* One client session through tkafka.h, printed normalised.  argv[1]: a
 * file of conf property names. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "tkafka.h"

#define TOPIC "parity"
#define PARTS 3
#define COUNT 60
#define BATCH 12

static unsigned long long rng = 0x9E3779B97F4A7C15ULL;
static unsigned next(void) {
    rng ^= rng << 13; rng ^= rng >> 7; rng ^= rng << 17;
    return (unsigned)(rng >> 11);
}

static void hex(const char *p, size_t n) {
    if (!p) { printf("null"); return; }
    printf("x");
    for (size_t i = 0; i < n; i++) printf("%02x", (unsigned char)p[i]);
}

static long long dr_ok, dr_err, dr_opq;
static void on_dr(long long opaque, int err, int32_t part, int64_t off) {
    (void)part; (void)off;
    if (err) dr_err++; else { dr_ok++; dr_opq += opaque; }
}

int main(int argc, char **argv) {
    char buf[16384], errstr[512];
    if (argc != 2) return 2;
    if (tk_version(buf, sizeof buf) > 0) printf("version %s\n", buf);
    for (int e = -200; e <= 200; e++)
        if (tk_err2str(e, buf, sizeof buf) > 0) printf("err %d %s\n", e, buf);
    tk_handle_t p = tk_producer_new(
        "{\"bootstrap.servers\": \"\", \"test.mock.num.brokers\": 1,"
        " \"linger.ms\": 5, \"compression.codec\": \"lz4\"}",
        errstr, sizeof errstr);
    if (!p) { fprintf(stderr, "producer: %s\n", errstr); return 1; }
    FILE *f = fopen(argv[1], "r");
    char name[256];
    while (f && fgets(name, sizeof name, f)) {
        name[strcspn(name, "\n")] = 0;
        int r = tk_conf_get(p, name, buf, sizeof buf);
        printf("conf %s %d %s\n", name, r, r > 0 ? buf : "");
    }
    if (f) fclose(f);
    if (tk_create_topic(p, TOPIC, PARTS, 10000) != 0) return 1;
    tk_set_dr_cb(p, on_dr);
    for (int i = 0; i < COUNT; i++) {
        char key[16], val[256], hv1[16];
        int kl = snprintf(key, sizeof key, "k%d", i);
        size_t vl = next() % 200;
        for (size_t j = 0; j < vl; j++) val[j] = (char)next();
        const char *hn[3] = {"h1", "hnull", "bin"};
        snprintf(hv1, sizeof hv1, "v%d", i);
        const char *hv[3] = {hv1, NULL, val};
        size_t hl[3] = {strlen(hv1), 0, vl < 5 ? vl : 5};
        if (tk_produce2(p, TOPIC, i % PARTS, i % 7 ? key : NULL,
                        i % 7 ? (size_t)kl : 0, i % 11 ? val : NULL,
                        i % 11 ? vl : 0, 0, hn, hv, hl, i % 5 ? 0 : 3,
                        i) != 0)
            return 1;
    }
    char base[BATCH * 64];
    int32_t kls[BATCH], vls[BATCH];
    size_t off = 0;
    for (int i = 0; i < BATCH; i++) {
        kls[i] = i % 3 ? -1 : 2;
        if (kls[i] > 0) { memcpy(base + off, "bk", 2); off += 2; }
        vls[i] = i % 4 ? (int32_t)(next() % 40) : -1;
        for (int j = 0; j < vls[i]; j++) base[off++] = (char)next();
    }
    printf("batch %lld\n",
           tk_produce_batch(p, TOPIC, 1, base, kls, vls, BATCH));
    if (tk_flush(p, 30000) != 0) return 1;
    printf("dr %lld %lld %lld outq %lld\n", dr_ok, dr_err, dr_opq,
           tk_outq_len(p));
    char bs[256];
    if (tk_mock_bootstrap(p, bs, sizeof bs) <= 0) return 1;
    char conf[512];
    snprintf(conf, sizeof conf,
             "{\"bootstrap.servers\": \"%s\", \"group.id\": \"pg\","
             " \"auto.offset.reset\": \"earliest\","
             " \"enable.auto.commit\": false, \"check.crcs\": true}", bs);
    tk_handle_t c = tk_consumer_new(conf, errstr, sizeof errstr);
    if (!c) { fprintf(stderr, "consumer: %s\n", errstr); return 1; }
    int32_t parts[PARTS] = {0, 1, 2};
    int64_t offs[PARTS] = {-2, -2, -2};
    if (tk_assign(c, TOPIC, parts, offs, PARTS) != 0) return 1;
    int got = 0;
    for (int polls = 0; got < COUNT + BATCH && polls < 600; polls++) {
        tk_msg_t m;
        int r = tk_consumer_poll(c, 100, &m);
        if (r < 0) return 1;
        if (r == 0) continue;
        if (m.err) { printf("msgerr %d\n", m.err); tk_msg_free(&m); continue; }
        got++;
        printf("msg %s %d %lld key=", m.topic, m.partition,
               (long long)m.offset);
        hex(m.key, m.key_len);
        printf(" value=");
        hex(m.payload, m.len);
        for (int h = 0; h < m.hdr_cnt; h++) {
            printf(" %s=", m.hdr_names[h]);
            hex(m.hdr_vals[h], m.hdr_val_lens[h]);
        }
        printf("\n");
        tk_msg_free(&m);
    }
    printf("consumed %d\n", got);
    if (tk_commit(c, 0) != 0) return 1;
    for (int i = 0; i < PARTS; i++) {
        int64_t lo = -9, hi = -9;
        int r = tk_query_watermark_offsets(c, TOPIC, i, &lo, &hi, 10000);
        printf("watermarks %d %d %lld %lld\n", i, r, (long long)lo,
               (long long)hi);
        printf("committed %d %lld\n", i, tk_committed(c, TOPIC, i, 10000));
        printf("position %d %lld\n", i, tk_position(c, TOPIC, i));
    }
    if (tk_metadata_json(c, buf, sizeof buf, 10000) <= 0) return 1;
    printf("metadata %s\n", buf);
    tk_destroy(c);
    tk_destroy(p);
    printf("PARITY-END\n");
    return 0;
}
"""


def _session(stdout: str) -> list:
    """The parity program's lines, sorted (partitions interleave by
    timing); of tk_metadata_json only each topic's partitions and
    leaders (the brokers' host:port differ between two mocks)."""
    lines = []
    for line in stdout.splitlines():
        if line.startswith("metadata "):
            md = json.loads(line[len("metadata "):])
            line = "metadata " + json.dumps(md["topics"], sort_keys=True)
        lines.append(line)
    return sorted(lines)


def test_parity_with_the_reference_library(bins, tmp_path):
    """The same C program, linked once against each library, on the CPU
    provider with the same seeded records and explicit partitions,
    prints the same session: tk_version, tk_err2str of -200..200,
    tk_conf_get of every property both conf tables share, every
    record's partition, offset, key, value and headers, DR counts,
    watermarks, tk_committed, tk_position and the topics and partitions
    of tk_metadata_json.  Left out: timestamps (records produced with
    timestamp 0 take the wall clock), the brokers' addresses, and the
    property builtin.features (each names its own codec backend,
    "tpu-codec" against "gpu-codec")."""
    import cffi
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ffi = cffi.FFI()
    ffi.embedding_api(ref_capi.CDEF)
    ffi.set_source("tkafka_cffi", ref_capi.TYPES)
    ffi.embedding_init_code(ref_capi.INIT)
    ffi.compile(tmpdir=str(ref_dir), target=str(ref_dir / "libtkafka.so"))
    (ref_dir / "tkafka.h").write_text(ref_capi.HEADER_TEXT)
    src = tmp_path / "parity.c"
    src.write_text(PARITY_C)
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ref_exe = str(tmp_path / "parity_ref")
    subprocess.run(["gcc", "-O1", "-o", ref_exe, str(src), "-I",
                    str(ref_dir), "-L", str(ref_dir), "-ltkafka",
                    f"-Wl,-rpath,{ref_dir}", f"-Wl,-rpath,{libdir}"],
                   check=True, capture_output=True)
    port_exe = build_capi.compile_program(str(src),
                                          str(tmp_path / "parity_port"))
    shared = ({p.name for p in ref_conf.PROPERTIES}
              & {p.name for p in port_conf.PROPERTIES})
    names = tmp_path / "names.txt"
    names.write_text("\n".join(sorted(shared - {"builtin.features"})) + "\n")
    # the reference's embedded interpreter finds its package by PYTHONPATH
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    ref = _session(_run(ref_exe, str(names), env=env))
    port = _session(_run(port_exe, str(names)))
    assert "PARITY-END" in port and "consumed 72" in port
    assert sum(x.startswith("conf ") for x in port) == len(shared) - 1
    assert sum(x.startswith("msg ") for x in port) == 72
    assert port == ref


def test_cpp_client_round_trip(bins):
    """The port's examples/cpp_client.cpp over tkafka.hpp."""
    assert "CPP-OK" in _run(bins["cpp_client"])


@pytest.mark.parametrize("leg", ["a", "b:gpu.compress.device=true"],
                         ids=["crc-tickets", "device-compress"])
def test_gpu_smoke_on_the_plain_versions(bins, leg):
    """capi/gpu_smoke.c with compression.backend=gpu on gpu.device=cpu
    (the kernels' plain versions), 4 partitions x 50 records: every
    record read back in order (the program checks it), every DR
    delivered, and the counted window's stats deltas show engine
    launches on both clients and no job on the CPU route."""
    out = _run(bins["gpu_smoke"], "--partitions", "4", "--records", "50",
               "--tail", "8", "--repeats", "2",
               "--conf", "compression.backend=gpu", "--conf",
               "gpu.device=cpu", "--conf", "gpu.governor=false", "--conf",
               "gpu.launch.min.batches=1", "--leg", leg)
    assert out.rstrip().endswith("GPU-SMOKE-OK")
    (name, rep), = smoke.read(out).items()
    assert rep["summary"]["dr_ok"] >= 2 * 4 * 8
    prod, cons = smoke.deltas(rep, "producer"), smoke.deltas(rep, "consumer")
    assert cons["launches"] > 0
    if name == "b":
        assert prod["compress.launches"] > 0 and prod["launches"] == 0
    else:
        assert prod["launches"] > 0 and prod["compress.launches"] == 0
    assert not any(d[k] for d in (prod, cons) for k in smoke.CPU_ROUTES)


def test_gpu_smoke_rejects_an_unknown_argument(bins):
    """A re-run with an interpreter's arguments (`-c ...`) exits 2 at
    once instead of driving a second session."""
    r = subprocess.run([bins["gpu_smoke"], "-c", "print(1)"],
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 2 and "unknown" in r.stderr


def test_gpu_backend_from_c_without_a_card_fails(bins):
    """compression.backend=gpu with no card visible: tk_producer_new
    returns 0 with the reason in errstr (no fallback to the CPU), and
    gpu_smoke exits 1 naming it."""
    r = subprocess.run([bins["gpu_smoke"], "--partitions", "1", "--records",
                        "1", "--tail", "0", "--conf",
                        "compression.backend=gpu"],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert "producer_new: no CUDA device" in r.stderr
    assert "GPU-SMOKE" not in r.stdout
