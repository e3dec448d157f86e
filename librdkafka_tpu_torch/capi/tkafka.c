/* tkafka.c — libtkafka.so: the C ABI of tkafka.h over the port's client.
 *
 * Every tk_* function takes the interpreter lock and calls the
 * same-named function of librdkafka_tpu_torch.capi._embed, pointer
 * arguments crossing as integer addresses; the Python side reads and
 * writes the caller's memory through them.  The first call starts the
 * embedded interpreter (build_capi.py bakes in TK_PYTHON, the Python
 * that built the library, and TK_PKG_PARENT, the directory that holds
 * the package) and then releases the lock, so the client's broker,
 * engine and warmup threads run while the C caller is outside the
 * library.  Callbacks come back into C through ctypes, which drops the
 * lock around the call: a callback may call tk_* again.
 *
 * A consumed message's fields are malloc'd here and freed by
 * tk_msg_free; nothing of a message stays on the Python side.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <pthread.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "tkafka.h"

#ifndef TK_PYTHON
#error "build with -DTK_PYTHON=\"<path of the python executable>\""
#endif
#ifndef TK_PKG_PARENT
#error "build with -DTK_PKG_PARENT=\"<directory holding the package>\""
#endif

#define ADDR(p) ((unsigned long long)(uintptr_t)(p))

static pthread_once_t init_once = PTHREAD_ONCE_INIT;
static PyObject *embed;          /* the _embed module; NULL if it failed */
static char init_error[512];

/* str() of the pending exception into init_error; the traceback goes
 * to stderr. */
static void keep_error(const char *what) {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    PyObject *s = value ? PyObject_Str(value) : NULL;
    const char *msg = s ? PyUnicode_AsUTF8(s) : NULL;
    snprintf(init_error, sizeof init_error, "%s: %s", what,
             msg ? msg : "unknown error");
    Py_XDECREF(s);
    PyErr_Clear();
    PyErr_Restore(type, value, tb);
    PyErr_Print();
}

/* At exit the process tears down the CUDA runtime and the C++ statics
 * of the libraries Python loaded; no Python thread (a daemon left by a
 * handle the caller never destroyed) may run Python code then.  The
 * interpreter is not finalized: that would wait on, or strand, live
 * client threads. */
static void hold_gil_at_exit(void) {
    PyGILState_Ensure();
}

static void start(void) {
    int owner = !Py_IsInitialized();
    PyGILState_STATE gil = PyGILState_UNLOCKED;
    if (owner) {
        PyConfig config;
        PyConfig_InitPythonConfig(&config);
        config.install_signal_handlers = 0;  /* the C program's signals */
        config.parse_argv = 0;
        config.buffered_stdio = 0;  /* nothing is flushed at exit */
        /* sys.executable: code that re-runs it must start Python, not
         * this program; it also finds the prefix (and a venv's
         * site-packages) of the Python that built the library. */
        PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                              TK_PYTHON);
        if (!PyStatus_Exception(st))
            st = PyConfig_SetBytesString(&config, &config.executable,
                                         TK_PYTHON);
        if (!PyStatus_Exception(st))
            st = Py_InitializeFromConfig(&config);
        PyConfig_Clear(&config);
        if (PyStatus_Exception(st)) {
            snprintf(init_error, sizeof init_error,
                     "embedded Python (%s) did not start: %s", TK_PYTHON,
                     st.err_msg ? st.err_msg : "unknown error");
            fprintf(stderr, "libtkafka: %s\n", init_error);
            return;
        }
    } else {
        gil = PyGILState_Ensure();
    }
    PyObject *path = PySys_GetObject("path");            /* borrowed */
    PyObject *root = PyUnicode_DecodeFSDefault(TK_PKG_PARENT);
    if (path && root && PySequence_Contains(path, root) == 0)
        PyList_Append(path, root);
    Py_XDECREF(root);
    PyErr_Clear();
    embed = PyImport_ImportModule("librdkafka_tpu_torch.capi._embed");
    if (!embed)
        keep_error("import librdkafka_tpu_torch.capi._embed failed");
    if (owner) {
        atexit(hold_gil_at_exit);
        PyEval_SaveThread();
    } else {
        PyGILState_Release(gil);
    }
}

static int ready(void) {
    pthread_once(&init_once, start);
    return embed != NULL;
}

/* _embed.<name>(*args), args built from fmt (a tuple format): its
 * integer result, or dflt when the library did not start or the call
 * raised (the error printed). */
static long long call(long long dflt, const char *name, const char *fmt,
                      ...) {
    if (!ready())
        return dflt;
    PyGILState_STATE gil = PyGILState_Ensure();
    va_list ap;
    va_start(ap, fmt);
    PyObject *args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    PyObject *fn = args ? PyObject_GetAttrString(embed, name) : NULL;
    PyObject *res = fn ? PyObject_CallObject(fn, args) : NULL;
    Py_XDECREF(fn);
    Py_XDECREF(args);
    if (!res)
        PyErr_Print();
    long long r = dflt;
    if (res && PyLong_Check(res)) {
        r = PyLong_AsLongLong(res);
        if (r == -1 && PyErr_Occurred()) {
            PyErr_Print();
            r = dflt;
        }
    }
    Py_XDECREF(res);
    PyGILState_Release(gil);
    return r;
}

static tk_handle_t new_handle(const char *kind, const char *conf_json,
                              char *errstr, int errstr_size) {
    if (!ready()) {
        if (errstr && errstr_size > 0)
            snprintf(errstr, (size_t)errstr_size, "%s", init_error);
        return 0;
    }
    return call(0, kind, "(KKi)", ADDR(conf_json), ADDR(errstr),
                errstr_size);
}

tk_handle_t tk_producer_new(const char *conf_json, char *errstr,
                            int errstr_size) {
    return new_handle("tk_producer_new", conf_json, errstr, errstr_size);
}

tk_handle_t tk_consumer_new(const char *conf_json, char *errstr,
                            int errstr_size) {
    return new_handle("tk_consumer_new", conf_json, errstr, errstr_size);
}

int tk_produce(tk_handle_t h, const char *topic, int32_t partition,
               const char *key, size_t key_len, const char *payload,
               size_t len) {
    return (int)call(-1, "tk_produce", "(LKiKKKK)", h, ADDR(topic),
                     (int)partition, ADDR(key), (unsigned long long)key_len,
                     ADDR(payload), (unsigned long long)len);
}

int tk_produce2(tk_handle_t h, const char *topic, int32_t partition,
                const char *key, size_t key_len, const char *payload,
                size_t len, int64_t timestamp_ms, const char **hdr_names,
                const char **hdr_vals, const size_t *hdr_val_lens,
                int hdr_cnt, long long opaque) {
    return (int)call(-1, "tk_produce2", "(LKiKKKKLKKKiL)", h, ADDR(topic),
                     (int)partition, ADDR(key), (unsigned long long)key_len,
                     ADDR(payload), (unsigned long long)len,
                     (long long)timestamp_ms, ADDR(hdr_names),
                     ADDR(hdr_vals), ADDR(hdr_val_lens), hdr_cnt, opaque);
}

long long tk_produce_batch(tk_handle_t h, const char *topic,
                          int32_t partition, const char *base,
                          const int32_t *klens, const int32_t *vlens,
                          int count) {
    return call(-1, "tk_produce_batch", "(LKiKKKi)", h, ADDR(topic),
                (int)partition, ADDR(base), ADDR(klens), ADDR(vlens),
                count);
}

int tk_set_dr_cb(tk_handle_t h, tk_dr_cb_t cb) {
    return (int)call(-1, "tk_set_dr_cb", "(LK)", h, ADDR(cb));
}

int tk_poll(tk_handle_t h, int timeout_ms) {
    return (int)call(-1, "tk_poll", "(Li)", h, timeout_ms);
}

long long tk_outq_len(tk_handle_t h) {
    return call(-1, "tk_outq_len", "(L)", h);
}

int tk_flush(tk_handle_t h, int timeout_ms) {
    return (int)call(-1, "tk_flush", "(Li)", h, timeout_ms);
}

int tk_subscribe(tk_handle_t h, const char *topics_csv) {
    return (int)call(-1, "tk_subscribe", "(LK)", h, ADDR(topics_csv));
}

int tk_assign(tk_handle_t h, const char *topic, const int32_t *partitions,
              const int64_t *offsets, int nparts) {
    return (int)call(-1, "tk_assign", "(LKKKi)", h, ADDR(topic),
                     ADDR(partitions), ADDR(offsets), nparts);
}

int tk_unassign(tk_handle_t h) {
    return (int)call(-1, "tk_unassign", "(L)", h);
}

static void msg_clear(tk_msg_t *m) {
    memset(m, 0, sizeof *m);
    m->partition = -1;
    m->offset = -1;
    m->timestamp = -1;
}

/* A malloc'd, NUL-terminated copy of bytes object b (NULL for None);
 * sets *len.  Returns 0 on success. */
static int dup_bytes(PyObject *b, char **out, size_t *len) {
    *out = NULL;
    if (len)
        *len = 0;
    if (b == Py_None)
        return 0;
    char *p;
    Py_ssize_t n;
    if (PyBytes_AsStringAndSize(b, &p, &n) < 0)
        return -1;
    char *c = malloc((size_t)n + 1);
    if (!c)
        return -1;
    memcpy(c, p, (size_t)n);
    c[n] = '\0';
    *out = c;
    if (len)
        *len = (size_t)n;
    return 0;
}

/* Fill m from _embed.tk_consumer_poll's tuple (topic, partition, offset,
 * timestamp, key, value, headers).  Returns 0, or -1 with m freed. */
static int fill_msg(PyObject *t, tk_msg_t *m) {
    PyObject *topic, *key, *value, *hdrs;
    long long part, off, ts;
    if (!PyArg_ParseTuple(t, "OLLLOOO", &topic, &part, &off, &ts, &key,
                          &value, &hdrs) ||
        !PyList_Check(hdrs))
        return -1;
    m->partition = (int32_t)part;
    m->offset = off;
    m->timestamp = ts;
    if (dup_bytes(topic, &m->topic, NULL) < 0 ||
        dup_bytes(key, &m->key, &m->key_len) < 0 ||
        dup_bytes(value, &m->payload, &m->len) < 0)
        goto fail;
    Py_ssize_t n = PyList_GET_SIZE(hdrs);
    if (n > 0) {
        m->hdr_names = calloc((size_t)n, sizeof(char *));
        m->hdr_vals = calloc((size_t)n, sizeof(char *));
        m->hdr_val_lens = calloc((size_t)n, sizeof(size_t));
        if (!m->hdr_names || !m->hdr_vals || !m->hdr_val_lens)
            goto fail;
        m->hdr_cnt = (int)n;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *hn, *hv;
            if (!PyArg_ParseTuple(PyList_GET_ITEM(hdrs, i), "OO", &hn, &hv)
                || dup_bytes(hn, &m->hdr_names[i], NULL) < 0
                || dup_bytes(hv, &m->hdr_vals[i], &m->hdr_val_lens[i]) < 0)
                goto fail;
        }
    }
    return 0;
fail:
    tk_msg_free(m);
    return -1;
}

int tk_consumer_poll(tk_handle_t h, int timeout_ms, tk_msg_t *out) {
    /* the caller's struct starts as garbage: every field is set before
     * any return */
    msg_clear(out);
    if (!ready())
        return -1;
    PyGILState_STATE gil = PyGILState_Ensure();
    int r = -2;   /* a raise must not read as "no message" */
    PyObject *res = PyObject_CallMethod(embed, "tk_consumer_poll", "(Li)",
                                        h, timeout_ms);
    if (!res) {
        PyErr_Print();
    } else if (PyLong_Check(res)) {
        r = (int)PyLong_AsLong(res);
    } else if (PyTuple_Check(res) && PyTuple_GET_SIZE(res) == 1) {
        out->err = (int)PyLong_AsLong(PyTuple_GET_ITEM(res, 0));
        r = 1;
    } else if (PyTuple_Check(res)) {
        r = fill_msg(res, out) == 0 ? 1 : -2;
    }
    if (PyErr_Occurred())
        PyErr_Print();
    Py_XDECREF(res);
    PyGILState_Release(gil);
    return r;
}

void tk_msg_free(tk_msg_t *m) {
    if (!m)
        return;
    free(m->topic);
    free(m->key);
    free(m->payload);
    for (int i = 0; i < m->hdr_cnt; i++) {
        if (m->hdr_names)
            free(m->hdr_names[i]);
        if (m->hdr_vals)
            free(m->hdr_vals[i]);
    }
    free(m->hdr_names);
    free(m->hdr_vals);
    free(m->hdr_val_lens);
    m->topic = m->key = m->payload = NULL;
    m->hdr_names = m->hdr_vals = NULL;
    m->hdr_val_lens = NULL;
    m->hdr_cnt = 0;
}

int tk_commit(tk_handle_t h, int async_flag) {
    return (int)call(-2, "tk_commit", "(Li)", h, async_flag);
}

long long tk_committed(tk_handle_t h, const char *topic, int32_t partition,
                       int timeout_ms) {
    return call(-2000002, "tk_committed", "(LKii)", h, ADDR(topic),
                (int)partition, timeout_ms);
}

int tk_seek(tk_handle_t h, const char *topic, int32_t partition,
            int64_t offset) {
    return (int)call(-1, "tk_seek", "(LKiL)", h, ADDR(topic),
                     (int)partition, (long long)offset);
}

int tk_create_topic(tk_handle_t h, const char *topic, int num_partitions,
                    int timeout_ms) {
    return (int)call(-1, "tk_create_topic", "(LKii)", h, ADDR(topic),
                     num_partitions, timeout_ms);
}

int tk_delete_topic(tk_handle_t h, const char *topic, int timeout_ms) {
    return (int)call(-1, "tk_delete_topic", "(LKi)", h, ADDR(topic),
                     timeout_ms);
}

int tk_mock_bootstrap(tk_handle_t h, char *buf, int size) {
    return (int)call(-1, "tk_mock_bootstrap", "(LKi)", h, ADDR(buf), size);
}

void tk_destroy(tk_handle_t h) {
    call(0, "tk_destroy", "(L)", h);
}

int tk_version(char *buf, int size) {
    return (int)call(-1, "tk_version", "(Ki)", ADDR(buf), size);
}

int tk_err2str(int err, char *buf, int size) {
    return (int)call(-1, "tk_err2str", "(iKi)", err, ADDR(buf), size);
}

int tk_query_watermark_offsets(tk_handle_t h, const char *topic,
                               int32_t partition, int64_t *lo, int64_t *hi,
                               int timeout_ms) {
    return (int)call(-1, "tk_query_watermark_offsets", "(LKiKKi)", h,
                     ADDR(topic), (int)partition, ADDR(lo), ADDR(hi),
                     timeout_ms);
}

long long tk_offsets_for_times(tk_handle_t h, const char *topic,
                               int32_t partition, int64_t ts_ms,
                               int timeout_ms) {
    return call(-2, "tk_offsets_for_times", "(LKiLi)", h, ADDR(topic),
                (int)partition, (long long)ts_ms, timeout_ms);
}

long long tk_position(tk_handle_t h, const char *topic, int32_t partition) {
    return call(-1001, "tk_position", "(LKi)", h, ADDR(topic),
                (int)partition);
}

int tk_pause(tk_handle_t h, const char *topic, int32_t partition) {
    return (int)call(-1, "tk_pause", "(LKi)", h, ADDR(topic),
                     (int)partition);
}

int tk_resume(tk_handle_t h, const char *topic, int32_t partition) {
    return (int)call(-1, "tk_resume", "(LKi)", h, ADDR(topic),
                     (int)partition);
}

int tk_purge(tk_handle_t h, int in_queue, int in_flight) {
    return (int)call(-1, "tk_purge", "(Lii)", h, in_queue, in_flight);
}

int tk_metadata_json(tk_handle_t h, char *buf, int size, int timeout_ms) {
    return (int)call(-1, "tk_metadata_json", "(LKii)", h, ADDR(buf), size,
                     timeout_ms);
}

int tk_conf_dump_json(tk_handle_t h, char *buf, int size) {
    return (int)call(-1, "tk_conf_dump_json", "(LKi)", h, ADDR(buf), size);
}

int tk_set_log_cb(tk_handle_t h, tk_log_cb_t cb) {
    return (int)call(-1, "tk_set_log_cb", "(LK)", h, ADDR(cb));
}

int tk_set_error_cb(tk_handle_t h, tk_error_cb_t cb) {
    return (int)call(-1, "tk_set_error_cb", "(LK)", h, ADDR(cb));
}

int tk_set_stats_cb(tk_handle_t h, tk_stats_cb_t cb) {
    return (int)call(-1, "tk_set_stats_cb", "(LK)", h, ADDR(cb));
}

int tk_conf_set(tk_handle_t h, const char *name, const char *value) {
    return (int)call(-2, "tk_conf_set", "(LKK)", h, ADDR(name), ADDR(value));
}

int tk_conf_get(tk_handle_t h, const char *name, char *buf, int size) {
    return (int)call(-2, "tk_conf_get", "(LKKi)", h, ADDR(name), ADDR(buf),
                     size);
}

int tk_describe_configs(tk_handle_t h, int restype, const char *name,
                        char *buf, int size, int timeout_ms) {
    return (int)call(-1, "tk_describe_configs", "(LiKKii)", h, restype,
                     ADDR(name), ADDR(buf), size, timeout_ms);
}

int tk_alter_configs(tk_handle_t h, int restype, const char *name,
                     const char *conf_json, int timeout_ms) {
    return (int)call(-1, "tk_alter_configs", "(LiKKi)", h, restype,
                     ADDR(name), ADDR(conf_json), timeout_ms);
}

int tk_create_partitions(tk_handle_t h, const char *topic, int new_total,
                         int timeout_ms) {
    return (int)call(-1, "tk_create_partitions", "(LKii)", h, ADDR(topic),
                     new_total, timeout_ms);
}

int tk_list_groups(tk_handle_t h, char *buf, int size, int timeout_ms) {
    return (int)call(-1, "tk_list_groups", "(LKii)", h, ADDR(buf), size,
                     timeout_ms);
}

int tk_describe_group(tk_handle_t h, const char *group, char *buf, int size,
                      int timeout_ms) {
    return (int)call(-1, "tk_describe_group", "(LKKii)", h, ADDR(group),
                     ADDR(buf), size, timeout_ms);
}

int tk_delete_group(tk_handle_t h, const char *group, int timeout_ms) {
    return (int)call(-1, "tk_delete_group", "(LKi)", h, ADDR(group),
                     timeout_ms);
}
