"""Build libtkafka.so — the C ABI over the port, with an embedded CPython.

The declarations (``TYPES`` + ``FUNCS``) are the JAX package's C ABI,
declaration for declaration, so a C program written against one
library links against the other unchanged.  The library itself is a
hand-written C shim (``tkafka.c``): each ``tk_*`` takes the interpreter
lock and calls the same-named function of ``_embed.py``, pointers
crossing as integer addresses.  ``gcc`` compiles it against the running
Python's headers and links its shared libpython; nothing else is needed
at build or run time.

The interpreter a C program embeds reports the Python that built the
library as ``sys.executable`` (baked in at build time), so code that
re-runs ``sys.executable`` — the GPU provider's transport probe, the
standalone mock's relays, fleet workers — starts Python, never the C
program.

Build:  python -m librdkafka_tpu_torch.capi.build_capi
        (writes libtkafka.so and tkafka.h into
        build/librdkafka_tpu_torch/capi/ at the repository root)
"""
from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(HERE)
#: the directory that holds the package, put on the embedded sys.path
PKG_PARENT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(PKG_PARENT, "build", "librdkafka_tpu_torch", "capi")
SO = os.path.join(BUILD_DIR, "libtkafka.so")
HEADER = os.path.join(BUILD_DIR, "tkafka.h")
#: the Python and the checkout the library was built for (baked into it)
STAMP = os.path.join(BUILD_DIR, "libtkafka.so.built-for")
SHIM = os.path.join(HERE, "tkafka.c")
_lock = threading.Lock()

TYPES = r"""
typedef struct tk_msg {
    char   *topic;      /* owned by the message; freed by tk_msg_free */
    int32_t partition;
    int64_t offset;
    int64_t timestamp;  /* ms since epoch, -1 if unset */
    char   *key;        /* NULL when the record has no key */
    size_t  key_len;
    char   *payload;    /* NULL only for null-value records */
    size_t  len;
    int     err;        /* 0 = ok */
    /* First-class headers (reference rd_kafka_header_get_all): raw
     * byte values, no escaping. All arrays are owned by the message
     * and freed by tk_msg_free. */
    int     hdr_cnt;
    char  **hdr_names;    /* NUL-terminated utf-8 names */
    char  **hdr_vals;     /* raw bytes (NUL-padded); NULL = null value */
    size_t *hdr_val_lens;
} tk_msg_t;

/* Handles are opaque integers (0 = error; details in errstr). */
typedef long long tk_handle_t;

/* Per-message delivery report trampoline (reference dr_msg_cb):
 * err 0 = delivered; opaque is the value passed to tk_produce2. */
typedef void (*tk_dr_cb_t)(long long opaque, int err,
                           int32_t partition, int64_t offset);

/* Observability callbacks (reference rd_kafka_conf_set_log_cb /
 * _set_error_cb / _set_stats_cb). Strings are valid only for the
 * duration of the call — copy if you keep them. They fire on the
 * thread that calls tk_poll/tk_flush (log may also fire on internal
 * threads, like the reference's non-queued log_cb). */
typedef void (*tk_log_cb_t)(int level, const char *fac, const char *msg);
typedef void (*tk_error_cb_t)(int err, const char *reason);
typedef void (*tk_stats_cb_t)(const char *json_str);
"""

FUNCS = r"""
extern tk_handle_t tk_producer_new(const char *conf_json,
                                   char *errstr, int errstr_size);
extern tk_handle_t tk_consumer_new(const char *conf_json,
                                   char *errstr, int errstr_size);
extern int  tk_produce(tk_handle_t h, const char *topic, int32_t partition,
                       const char *key, size_t key_len,
                       const char *payload, size_t len);
extern int  tk_produce2(tk_handle_t h, const char *topic,
                        int32_t partition,
                        const char *key, size_t key_len,
                        const char *payload, size_t len,
                        int64_t timestamp_ms,
                        const char **hdr_names, const char **hdr_vals,
                        const size_t *hdr_val_lens, int hdr_cnt,
                        long long opaque);
extern long long tk_produce_batch(tk_handle_t h, const char *topic,
                                  int32_t partition, const char *base,
                                  const int32_t *klens,
                                  const int32_t *vlens, int count);
extern int  tk_set_dr_cb(tk_handle_t h, tk_dr_cb_t cb);
extern int  tk_poll(tk_handle_t h, int timeout_ms);
extern long long tk_outq_len(tk_handle_t h);
extern int  tk_flush(tk_handle_t h, int timeout_ms);
extern int  tk_subscribe(tk_handle_t h, const char *topics_csv);
extern int  tk_assign(tk_handle_t h, const char *topic,
                      const int32_t *partitions,
                      const int64_t *offsets, int nparts);
extern int  tk_unassign(tk_handle_t h);
extern int  tk_consumer_poll(tk_handle_t h, int timeout_ms, tk_msg_t *out);
extern int  tk_commit(tk_handle_t h, int async_flag);
extern long long tk_committed(tk_handle_t h, const char *topic,
                              int32_t partition, int timeout_ms);
extern int  tk_seek(tk_handle_t h, const char *topic, int32_t partition,
                    int64_t offset);
extern int  tk_create_topic(tk_handle_t h, const char *topic,
                            int num_partitions, int timeout_ms);
extern int  tk_delete_topic(tk_handle_t h, const char *topic,
                            int timeout_ms);
extern void tk_msg_free(tk_msg_t *m);
extern int  tk_mock_bootstrap(tk_handle_t h, char *buf, int size);
extern void tk_destroy(tk_handle_t h);

/* --- introspection & offset queries (reference rdkafka.h:
 *     rd_kafka_version_str, rd_kafka_err2str,
 *     rd_kafka_query_watermark_offsets, rd_kafka_offsets_for_times,
 *     rd_kafka_position, rd_kafka_pause/resume_partitions,
 *     rd_kafka_purge, rd_kafka_metadata, rd_kafka_conf_dump) --- */
extern int  tk_version(char *buf, int size);
extern int  tk_err2str(int err, char *buf, int size);
extern int  tk_query_watermark_offsets(tk_handle_t h, const char *topic,
                                       int32_t partition, int64_t *lo,
                                       int64_t *hi, int timeout_ms);
extern long long tk_offsets_for_times(tk_handle_t h, const char *topic,
                                      int32_t partition, int64_t ts_ms,
                                      int timeout_ms);
extern long long tk_position(tk_handle_t h, const char *topic,
                             int32_t partition);
extern int  tk_pause(tk_handle_t h, const char *topic, int32_t partition);
extern int  tk_resume(tk_handle_t h, const char *topic, int32_t partition);
extern int  tk_purge(tk_handle_t h, int in_queue, int in_flight);
extern int  tk_metadata_json(tk_handle_t h, char *buf, int size,
                             int timeout_ms);
extern int  tk_conf_dump_json(tk_handle_t h, char *buf, int size);

/* --- r5: callbacks, per-property conf, admin breadth (reference
 *     rdkafka.h: conf_set/conf_get, log/error/stats callbacks,
 *     DescribeConfigs/AlterConfigs/CreatePartitions, ListGroups/
 *     DescribeGroups) --- */
extern int  tk_set_log_cb(tk_handle_t h, tk_log_cb_t cb);
extern int  tk_set_error_cb(tk_handle_t h, tk_error_cb_t cb);
extern int  tk_set_stats_cb(tk_handle_t h, tk_stats_cb_t cb);
extern int  tk_conf_set(tk_handle_t h, const char *name,
                        const char *value);
extern int  tk_conf_get(tk_handle_t h, const char *name,
                        char *buf, int size);
/* restype: 2 = TOPIC, 4 = BROKER, 3 = GROUP (reference
 * rd_kafka_ResourceType_t). describe fills JSON {name: value}. */
extern int  tk_describe_configs(tk_handle_t h, int restype,
                                const char *name, char *buf, int size,
                                int timeout_ms);
extern int  tk_alter_configs(tk_handle_t h, int restype,
                             const char *name, const char *conf_json,
                             int timeout_ms);
extern int  tk_create_partitions(tk_handle_t h, const char *topic,
                                 int new_total, int timeout_ms);
/* JSON [[group_id, protocol_type], ...] */
extern int  tk_list_groups(tk_handle_t h, char *buf, int size,
                           int timeout_ms);
/* JSON {state, protocol_type, protocol, members: [...]} */
extern int  tk_describe_group(tk_handle_t h, const char *group,
                              char *buf, int size, int timeout_ms);
extern int  tk_delete_group(tk_handle_t h, const char *group,
                            int timeout_ms);
"""

CDEF = TYPES + FUNCS

HEADER_TEXT = (
    "/* tkafka.h — C API for librdkafka_tpu_torch, the PyTorch / CUDA\n"
    " * client (a second-language binding over the same core; reference\n"
    " * surface: src/rdkafka.h).\n"
    " * Link: -ltkafka  (plus the embedded CPython the .so carries). */\n"
    "#pragma once\n"
    "#include <stdint.h>\n"
    "#include <stddef.h>\n"
    "#ifdef __cplusplus\nextern \"C\" {\n#endif\n"
    + CDEF +
    "#ifdef __cplusplus\n}\n#endif\n")


def python_link() -> tuple[str, list[str]]:
    """(the shared libpython's directory, the linker arguments for it)
    of the running interpreter; raises when it was built without one."""
    cv = sysconfig.get_config_var
    libdir = cv("LIBDIR") or ""
    if not cv("Py_ENABLE_SHARED"):
        raise RuntimeError(
            f"{sys.executable} has no shared libpython (Py_ENABLE_SHARED="
            f"{cv('Py_ENABLE_SHARED')}, LDLIBRARY={cv('LDLIBRARY')}): "
            "libtkafka.so embeds CPython and needs one")
    return libdir, [f"-L{libdir}", f"-lpython{cv('LDVERSION')}",
                    *(cv("LIBS") or "").split(), f"-Wl,-rpath,{libdir}"]


def _c_string(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def build(force: bool = False) -> str:
    """gcc tkafka.c into ``SO`` and write ``HEADER`` when either is
    missing or older than this file or the shim, or the library was built
    by another Python or for another checkout (``STAMP``); returns
    ``SO``."""
    # not realpath(): a venv's python finds its site-packages through
    # its own path (pyvenv.cfg beside it)
    exe = os.path.abspath(sys.executable)
    stamp = f"{exe}\n{PKG_PARENT}\n"
    with _lock:
        newest = max(os.path.getmtime(__file__), os.path.getmtime(SHIM))
        if (not force and all(os.path.exists(p) and
                              os.path.getmtime(p) >= newest
                              for p in (SO, HEADER))
                and _read(STAMP) == stamp):
            return SO
        if not os.access(exe, os.X_OK):
            raise RuntimeError(f"sys.executable {exe!r} is not executable")
        _libdir, link = python_link()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # per-process temp names: parallel test workers may build at once
        tag = f".{os.getpid()}.tmp"
        with open(HEADER + tag, "w") as f:
            f.write(HEADER_TEXT)
        os.replace(HEADER + tag, HEADER)
        cmd = ["gcc", "-O2", "-std=c11", "-shared", "-fPIC", "-pthread",
               "-Wall",
               "-I", BUILD_DIR, "-I", sysconfig.get_paths()["include"],
               f"-DTK_PYTHON={_c_string(exe)}",
               f"-DTK_PKG_PARENT={_c_string(PKG_PARENT)}",
               "-o", SO + tag, SHIM, *link]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"gcc failed for {SHIM}:\n{res.stderr}")
        os.replace(SO + tag, SO)
        with open(STAMP + tag, "w") as f:
            f.write(stamp)
        os.replace(STAMP + tag, STAMP)
        return SO


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def compile_program(src: str, exe: str) -> str:
    """Compile and link a C (``.c``) or C++ program against the port's
    libtkafka.so (built if stale), with ``tkafka.h`` and ``tkafka.hpp``
    on the include path and rpaths to the library and libpython;
    returns ``exe``."""
    so = build()
    libdir, _link = python_link()
    cxx = not src.endswith(".c")
    cmd = (["g++", "-std=c++17"] if cxx else ["gcc"]) + [
        "-O1", "-Wall", "-o", exe, src, "-I", BUILD_DIR, "-I", HERE,
        "-L", os.path.dirname(so), "-ltkafka",
        f"-Wl,-rpath,{os.path.dirname(so)}", f"-Wl,-rpath,{libdir}"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"compiling {src} failed:\n{res.stderr}")
    return exe


if __name__ == "__main__":
    print(build(force=True))
