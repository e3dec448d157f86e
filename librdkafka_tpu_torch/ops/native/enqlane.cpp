// Native produce() enqueue lane — the GIL-ceiling fix.
//
// librdkafka_tpu_torch's copy of librdkafka_tpu/ops/native/enqlane.cpp,
// built as an extension module of its own name (tk_torch_enqlane), so the
// two packages' lanes load side by side in one process.
//
// The reference's produce hot path (rd_kafka_toppar_enq_msg called from
// rd_kafka_producev, rdkafka_msg.c:299/rdkafka_broker.c:3242) does zero
// allocations per record: payloads land in preallocated queues and the
// msgset writer walks them.  The Python client paid ~7 µs/message on the
// app thread building a Message object and deque-appending it, then the
// broker thread paid again iterating those objects to feed the native
// framer (tk_frame_v2, codec.cpp:468).
//
// This module is a CPython extension (not ctypes — per-call overhead
// matters at ~1 µs/record): an Arena is a per-toppar growable byte
// buffer + per-record (klen, vlen, enq_us) arrays.  produce() appends
// key/value straight into it in ONE C call; the broker thread take()s a
// contiguous run — base bytes + length arrays — that tk_frame_v2
// consumes directly with no per-record Python work on either side.
// Records default to the batch build time (timestamp=0 = "now"); an
// explicit produce(timestamp=) is stored per record, and headers are
// pre-encoded into a side arena — the framer (tk_frame_v2_run) walks
// all of it natively.  The monotonic enq_us feeds message.timeout.ms
// and latency stats.
//
// Thread contract: every method holds the GIL for its entire (short)
// duration — the GIL is the lock, exactly like the Python deques it
// replaces.  App thread appends; broker thread takes; main thread
// expires/clears.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <stdint.h>
#include <string.h>
#include <time.h>
#ifdef __GLIBC__
#include <malloc.h>
#endif

#include <vector>

static inline int64_t now_us(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000 + ts.tv_nsec / 1000;
}

typedef struct {
    PyObject_HEAD
    uint8_t *buf;        // concatenated key||value payload bytes
    int64_t cap, len;
    int32_t *klens;      // -1 = null key
    int32_t *vlens;      // -1 = null value
    int64_t *enq;        // CLOCK_MONOTONIC µs at append
    int64_t *boff;       // boff[i] = payload offset of record i; boff[count] = len
    // widened eligibility (explicit timestamps + record headers):
    // tss[i] is the record's CreateTime ms (0 = unset -> batch build
    // time); hbuf is a side arena of PRE-ENCODED wire header blobs
    // (count varint + per-header framing, encoded once at produce()
    // time), hoff[i]..hoff[i+1] delimiting record i's blob (empty =
    // no headers).  take() hands the framer these arrays verbatim.
    int64_t *tss;
    uint8_t *hbuf;
    int64_t hcap;
    int64_t *hoff;       // hoff[i] = header-blob offset; hoff[count] = used
    int32_t count, rcap;
    int32_t start;       // first un-taken record (partial takes)
} Arena;

static int arena_grow_buf(Arena *a, int64_t need) {
    if (a->len + need <= a->cap) return 0;
    int64_t ncap = a->cap ? a->cap : 1 << 16;
    while (a->len + need > ncap) ncap *= 2;
    uint8_t *nb = (uint8_t *)PyMem_Realloc(a->buf, ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    a->buf = nb;
    a->cap = ncap;
    return 0;
}

static int arena_grow_recs(Arena *a) {
    if (a->count < a->rcap) return 0;
    int32_t ncap = a->rcap ? a->rcap * 2 : 1024;
    int32_t *nk = (int32_t *)PyMem_Realloc(a->klens, ncap * 4);
    if (!nk) { PyErr_NoMemory(); return -1; }
    a->klens = nk;
    int32_t *nv = (int32_t *)PyMem_Realloc(a->vlens, ncap * 4);
    if (!nv) { PyErr_NoMemory(); return -1; }
    a->vlens = nv;
    int64_t *ne = (int64_t *)PyMem_Realloc(a->enq, ncap * 8);
    if (!ne) { PyErr_NoMemory(); return -1; }
    a->enq = ne;
    int64_t *nt = (int64_t *)PyMem_Realloc(a->tss, ncap * 8);
    if (!nt) { PyErr_NoMemory(); return -1; }
    a->tss = nt;
    int64_t *nb = (int64_t *)PyMem_Realloc(a->boff, (ncap + 1) * 8);
    if (!nb) { PyErr_NoMemory(); return -1; }
    a->boff = nb;
    int64_t *nh = (int64_t *)PyMem_Realloc(a->hoff, (ncap + 1) * 8);
    if (!nh) { PyErr_NoMemory(); return -1; }
    a->hoff = nh;
    a->rcap = ncap;
    return 0;
}

static int arena_grow_hbuf(Arena *a, int64_t need) {
    int64_t used = a->hoff[a->count];
    if (used + need <= a->hcap) return 0;
    int64_t ncap = a->hcap ? a->hcap : 1 << 12;
    while (used + need > ncap) ncap *= 2;
    uint8_t *nb = (uint8_t *)PyMem_Realloc(a->hbuf, ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    a->hbuf = nb;
    a->hcap = ncap;
    return 0;
}

static void arena_reset(Arena *a) {
    a->count = 0;
    a->start = 0;
    a->len = 0;
    a->boff[0] = 0;
    a->hoff[0] = 0;
}

// Reclaim the consumed prefix: partial takes leave [0, boff[start])
// garbage that would otherwise grow with cumulative produced volume
// under sustained production (the arena never fully drains when
// records arrive faster than the per-batch take cap).
static void arena_compact(Arena *a) {
    int32_t live = a->count - a->start;
    int64_t base = a->boff[a->start];
    int64_t hbase = a->hoff[a->start];
    if (live > 0) {
        memmove(a->buf, a->buf + base, (size_t)(a->len - base));
        memmove(a->klens, a->klens + a->start, (size_t)live * 4);
        memmove(a->vlens, a->vlens + a->start, (size_t)live * 4);
        memmove(a->enq, a->enq + a->start, (size_t)live * 8);
        memmove(a->tss, a->tss + a->start, (size_t)live * 8);
        if (hbase > 0)
            memmove(a->hbuf, a->hbuf + hbase,
                    (size_t)(a->hoff[a->count] - hbase));
        for (int32_t i = 0; i <= live; i++) {
            a->boff[i] = a->boff[a->start + i] - base;
            a->hoff[i] = a->hoff[a->start + i] - hbase;
        }
        a->len -= base;
    } else {
        a->len = 0;
        a->boff[0] = 0;
        a->hoff[0] = 0;
    }
    a->count = live;
    a->start = 0;
}

// Shared append body (arena_append + lane_produce): grow, compact a
// large consumed prefix, copy payloads, stamp the record.  ts_ms is
// the record's CreateTime (0 = unset); hp/hl the pre-encoded header
// blob (hl = 0: no headers).
static int arena_do_append(Arena *a, const char *kp, int64_t kl,
                           const char *vp, int64_t vl, int64_t ts_ms,
                           const uint8_t *hp, int64_t hl) {
    int64_t need = (kl > 0 ? kl : 0) + (vl > 0 ? vl : 0);
    if (a->start > 0
        && (a->boff[a->start] >= (1 << 20) || a->start >= 8192))
        arena_compact(a);
    if (arena_grow_buf(a, need) < 0 || arena_grow_recs(a) < 0) return -1;
    if (hl > 0 && arena_grow_hbuf(a, hl) < 0) return -1;
    if (kl > 0) { memcpy(a->buf + a->len, kp, kl); a->len += kl; }
    if (vl > 0) { memcpy(a->buf + a->len, vp, vl); a->len += vl; }
    int32_t i = a->count;
    a->klens[i] = (int32_t)kl;
    a->vlens[i] = (int32_t)vl;
    a->enq[i] = now_us();
    a->tss[i] = ts_ms;
    int64_t hused = a->hoff[i];
    if (hl > 0) { memcpy(a->hbuf + hused, hp, hl); hused += hl; }
    a->count = i + 1;
    a->boff[a->count] = a->len;
    a->hoff[a->count] = hused;
    return 0;
}

// append(key: bytes|None, value: bytes|None[, ts_ms: int,
//        hblob: bytes|None]) -> remaining count
// ts_ms = 0 means "unset" (batch build time); hblob is a pre-encoded
// wire header blob (see client/arena.py encode_headers).
static PyObject *arena_append(Arena *a, PyObject *const *args,
                              Py_ssize_t nargs) {
    if (nargs < 2 || nargs > 4) {
        PyErr_SetString(PyExc_TypeError,
                        "append(key, value[, ts_ms, hblob])");
        return NULL;
    }
    PyObject *key = args[0], *val = args[1];
    int64_t kl = -1, vl = -1;
    const char *kp = NULL, *vp = NULL;
    if (key != Py_None) {
        if (!PyBytes_Check(key)) {
            PyErr_SetString(PyExc_TypeError, "key must be bytes or None");
            return NULL;
        }
        kl = PyBytes_GET_SIZE(key);
        kp = PyBytes_AS_STRING(key);
    }
    if (val != Py_None) {
        if (!PyBytes_Check(val)) {
            PyErr_SetString(PyExc_TypeError, "value must be bytes or None");
            return NULL;
        }
        vl = PyBytes_GET_SIZE(val);
        vp = PyBytes_AS_STRING(val);
    }
    int64_t ts_ms = 0;
    if (nargs >= 3) {
        ts_ms = PyLong_AsLongLong(args[2]);
        if (PyErr_Occurred()) return NULL;
    }
    const uint8_t *hp = NULL;
    int64_t hl = 0;
    if (nargs == 4 && args[3] != Py_None) {
        if (!PyBytes_Check(args[3])) {
            PyErr_SetString(PyExc_TypeError, "hblob must be bytes or None");
            return NULL;
        }
        hl = PyBytes_GET_SIZE(args[3]);
        hp = (const uint8_t *)PyBytes_AS_STRING(args[3]);
    }
    if (arena_do_append(a, kp, kl, vp, vl, ts_ms, hp, hl) < 0) return NULL;
    return PyLong_FromLong(a->count - a->start);
}

// take(max_count, max_bytes)
//   -> (base, klens, vlens, count, nbytes, enq_first_us, enq_last_us,
//       tss|None, hbuf|None, hlens|None)
//      | None when empty
// tss is raw int64 timestamps (ms, 0 = unset) ONLY when some record in
// the run carries an explicit timestamp; hbuf/hlens (concatenated
// pre-encoded header blobs + raw int32 per-record blob lengths) ONLY
// when some record carries headers.  The all-default run — the hot
// shape — keeps the original 3-buffer descriptor (plus three Nones) so
// the framer's zero-delta path stays allocation-minimal.
static PyObject *arena_take(Arena *a, PyObject *const *args,
                            Py_ssize_t nargs) {
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "take(max_count, max_bytes)");
        return NULL;
    }
    int64_t max_count = PyLong_AsLongLong(args[0]);
    int64_t max_bytes = PyLong_AsLongLong(args[1]);
    if (PyErr_Occurred()) return NULL;
    int32_t avail = a->count - a->start;
    if (avail <= 0) Py_RETURN_NONE;
    int32_t n = 0;
    int64_t nb = 0;
    int ts_any = 0;
    while (n < avail && n < max_count) {
        int64_t rl = a->boff[a->start + n + 1] - a->boff[a->start + n];
        if (n > 0 && nb + rl > max_bytes) break;
        nb += rl;
        if (a->tss[a->start + n]) ts_any = 1;
        n++;
    }
    int32_t s = a->start;
    int64_t h_total = a->hoff[s + n] - a->hoff[s];
    PyObject *base = PyBytes_FromStringAndSize(
        (const char *)(a->buf + a->boff[s]), nb);
    PyObject *kb = PyBytes_FromStringAndSize((const char *)(a->klens + s),
                                             (Py_ssize_t)n * 4);
    PyObject *vb = PyBytes_FromStringAndSize((const char *)(a->vlens + s),
                                             (Py_ssize_t)n * 4);
    PyObject *tsb = NULL, *hb = NULL, *hlb = NULL;
    if (ts_any)
        tsb = PyBytes_FromStringAndSize((const char *)(a->tss + s),
                                        (Py_ssize_t)n * 8);
    if (h_total > 0) {
        hb = PyBytes_FromStringAndSize(
            (const char *)(a->hbuf + a->hoff[s]), (Py_ssize_t)h_total);
        hlb = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)n * 4);
        if (hlb) {
            int32_t *hl = (int32_t *)PyBytes_AS_STRING(hlb);
            for (int32_t i = 0; i < n; i++)
                hl[i] = (int32_t)(a->hoff[s + i + 1] - a->hoff[s + i]);
        }
    }
    if (!base || !kb || !vb || (ts_any && !tsb)
        || (h_total > 0 && (!hb || !hlb))) {
        Py_XDECREF(base); Py_XDECREF(kb); Py_XDECREF(vb);
        Py_XDECREF(tsb); Py_XDECREF(hb); Py_XDECREF(hlb);
        return NULL;
    }
    int64_t ef = a->enq[s], el = a->enq[s + n - 1];
    a->start = s + n;
    if (a->start == a->count) arena_reset(a);
    if (!tsb) { tsb = Py_None; Py_INCREF(tsb); }
    if (!hb) { hb = Py_None; Py_INCREF(hb); }
    if (!hlb) { hlb = Py_None; Py_INCREF(hlb); }
    PyObject *r = Py_BuildValue("(NNNiLLLNNN)", base, kb, vb, (int)n,
                                (long long)nb, (long long)ef, (long long)el,
                                tsb, hb, hlb);
    return r;
}

// expire(cutoff_us) -> (count, nbytes): drop the prefix enqueued at or
// before cutoff_us (message.timeout.ms scan)
static PyObject *arena_expire(Arena *a, PyObject *arg) {
    int64_t cutoff = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return NULL;
    int32_t n = 0;
    int64_t nb = 0;
    while (a->start < a->count && a->enq[a->start] <= cutoff) {
        nb += a->boff[a->start + 1] - a->boff[a->start];
        a->start++;
        n++;
    }
    if (a->start == a->count) arena_reset(a);
    return Py_BuildValue("(iL)", (int)n, (long long)nb);
}

// Materialize records [start, start+n) as (key|None, value|None, ts_ms,
// hblob|None) tuples — shared by expire_records and drain_records.
static PyObject *arena_record_tuples(Arena *a, int32_t n) {
    PyObject *list = PyList_New(n);
    if (!list) return NULL;
    for (int32_t i = 0; i < n; i++) {
        int32_t r = a->start + i;
        int64_t off = a->boff[r];
        int32_t kl = a->klens[r], vl = a->vlens[r];
        int64_t hl = a->hoff[r + 1] - a->hoff[r];
        PyObject *k, *v, *ts, *h;
        if (kl < 0) { k = Py_None; Py_INCREF(k); }
        else {
            k = PyBytes_FromStringAndSize((const char *)(a->buf + off), kl);
            off += kl;
        }
        if (vl < 0) { v = Py_None; Py_INCREF(v); }
        else
            v = PyBytes_FromStringAndSize((const char *)(a->buf + off), vl);
        ts = PyLong_FromLongLong(a->tss[r]);
        if (hl > 0)
            h = PyBytes_FromStringAndSize(
                (const char *)(a->hbuf + a->hoff[r]), (Py_ssize_t)hl);
        else { h = Py_None; Py_INCREF(h); }
        if (!k || !v || !ts || !h) {
            Py_XDECREF(k); Py_XDECREF(v); Py_XDECREF(ts); Py_XDECREF(h);
            Py_DECREF(list);
            return NULL;
        }
        PyObject *t = PyTuple_Pack(4, k, v, ts, h);
        Py_DECREF(k); Py_DECREF(v); Py_DECREF(ts); Py_DECREF(h);
        if (!t) { Py_DECREF(list); return NULL; }
        PyList_SET_ITEM(list, i, t);
    }
    return list;
}

// expire_records(cutoff_us) -> [(key, value, ts_ms, hblob|None), ...]:
// drop the prefix enqueued at or before cutoff_us, MATERIALIZED — the
// message.timeout.ms scan uses this instead of expire() when a
// delivery-report consumer needs the records for error DRs
static PyObject *arena_expire_records(Arena *a, PyObject *arg) {
    int64_t cutoff = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return NULL;
    int32_t n = 0;
    while (a->start + n < a->count && a->enq[a->start + n] <= cutoff)
        n++;
    PyObject *list = arena_record_tuples(a, n);
    if (!list) return NULL;
    a->start += n;
    if (a->start == a->count) arena_reset(a);
    return list;
}

// clear() -> (count, nbytes): drop everything (purge)
static PyObject *arena_clear(Arena *a, PyObject *Py_UNUSED(ignored)) {
    int32_t n = a->count - a->start;
    int64_t nb = a->boff[a->count] - a->boff[a->start];
    arena_reset(a);
    return Py_BuildValue("(iL)", (int)n, (long long)nb);
}

// drain_records() -> [(key, value, ts_ms, hblob|None), ...]: demotion
// path when a toppar mixes fast-lane and Message traffic (rare; FIFO
// preserved by converting the arena prefix into Message objects)
static PyObject *arena_drain_records(Arena *a, PyObject *Py_UNUSED(ig)) {
    int32_t n = a->count - a->start;
    PyObject *list = arena_record_tuples(a, n);
    if (!list) return NULL;
    arena_reset(a);
    return list;
}

static PyObject *arena_first_enq_us(Arena *a, PyObject *Py_UNUSED(ig)) {
    if (a->start >= a->count) return PyLong_FromLong(-1);
    return PyLong_FromLongLong(a->enq[a->start]);
}

static PyObject *arena_nbytes(Arena *a, PyObject *Py_UNUSED(ig)) {
    return PyLong_FromLongLong(a->boff[a->count] - a->boff[a->start]);
}

static Py_ssize_t arena_length(PyObject *self) {
    Arena *a = (Arena *)self;
    return a->count - a->start;
}

static PyObject *arena_new(PyTypeObject *type, PyObject *args,
                           PyObject *kwds) {
    Arena *a = (Arena *)type->tp_alloc(type, 0);
    if (!a) return NULL;
    a->buf = NULL; a->cap = 0; a->len = 0;
    a->klens = NULL; a->vlens = NULL; a->enq = NULL;
    a->tss = NULL; a->hbuf = NULL; a->hcap = 0;
    a->boff = (int64_t *)PyMem_Malloc(8);
    a->hoff = (int64_t *)PyMem_Malloc(8);
    if (!a->boff || !a->hoff) { Py_DECREF(a); return PyErr_NoMemory(); }
    a->boff[0] = 0;
    a->hoff[0] = 0;
    a->count = 0; a->rcap = 0; a->start = 0;
    return (PyObject *)a;
}

static void arena_dealloc(Arena *a) {
    PyMem_Free(a->buf);
    PyMem_Free(a->klens);
    PyMem_Free(a->vlens);
    PyMem_Free(a->enq);
    PyMem_Free(a->tss);
    PyMem_Free(a->hbuf);
    PyMem_Free(a->boff);
    PyMem_Free(a->hoff);
    Py_TYPE(a)->tp_free((PyObject *)a);
}

// ============================================================ Lane =====
//
// The whole produce() hot path as ONE C call: argument parsing,
// eligibility, queue-full accounting, toppar lookup, arena append.
// The Python wrapper binds the public Producer.produce directly to
// Lane.produce; ineligible calls tail into the stored Python fallback
// (the Message path).  Counters live here — C methods are atomic under
// the GIL, replacing the Python-side msg_cnt lock for the hot path.

typedef struct {
    PyObject_HEAD
    PyObject *map;        // dict {(topic, partition) -> (Arena, toppar)}
    PyObject *fallback;   // rk._produce_slow(topic, value, key, ...)
    PyObject *wake;       // rk._wake_fast(toppar) on empty->non-empty
    // hot-path lookup cache: per-topic partition-indexed entry lists
    // (the tuple-pack + dict-hash per produce() measured ~40% of the
    // enqueue cost). cache_topic/cache_entries are the last-used fast
    // slot (pointer-identity hit); cache_map keeps every topic's list
    // so multi-topic round-robin pays one str-keyed dict get per
    // switch, not a list rebuild. Maintained by map_set/map_del —
    // Python must mutate the map through those, not directly.
    PyObject *cache_topic;    // strong ref, may be NULL
    PyObject *cache_entries;  // strong PyList of entry|None, may be NULL
    PyObject *cache_map;      // strong dict {topic -> PyList}, may be NULL
    // native auto-partition: {topic -> (partition_cnt, mode)} installed
    // by Python once metadata is known (part_set) and invalidated on
    // metadata change (part_del).  mode 1 = "murmur2" (null/empty key
    // hashes as b""), mode 2 = "murmur2_random" (falsy key falls back
    // to the Python random partitioner).
    PyObject *part_map;
    int64_t msg_cnt, msg_bytes;
    int64_t max_msgs, max_bytes;
    int64_t copy_max;     // message.copy.max.bytes: larger values keep a
                          // Python reference (Message path) instead of
                          // being copied into the arena
    int enabled;          // conf-level eligibility (no DR consumers)
    int fatal;            // set_fatal_error happened: produce must raise
    // engagement accounting (satellite: arena.engaged / per-reason
    // fallback breakdown in stats JSON) — GIL-atomic like msg_cnt
    int64_t c_engaged;       // records appended via the fast lane
    int64_t c_fb_disabled;   // lane disabled / fatal / bad call shape
    int64_t c_fb_shape;      // non-bytes payloads, callbacks, opaque...
    int64_t c_fb_oversize;   // payload or header blob > copy_max
    int64_t c_fb_qfull;      // queue-full: slow path raises
    int64_t c_fb_noent;      // toppar not registered yet (first sight)
    int64_t c_fb_autopart;   // partition=UA with no native partitioner
} Lane;

static PyObject *lane_new(PyTypeObject *type, PyObject *args,
                          PyObject *kwds) {
    Lane *l = (Lane *)type->tp_alloc(type, 0);
    if (!l) return NULL;
    l->map = PyDict_New();
    if (!l->map) { Py_DECREF(l); return NULL; }
    l->fallback = NULL;
    l->wake = NULL;
    l->cache_topic = NULL;
    l->cache_entries = NULL;
    l->cache_map = NULL;
    l->part_map = PyDict_New();
    if (!l->part_map) { Py_DECREF(l); return NULL; }
    l->msg_cnt = 0; l->msg_bytes = 0;
    l->max_msgs = 100000; l->max_bytes = 1LL << 30;
    l->copy_max = 65535;
    l->enabled = 0; l->fatal = 0;
    l->c_engaged = 0;
    l->c_fb_disabled = 0; l->c_fb_shape = 0; l->c_fb_oversize = 0;
    l->c_fb_qfull = 0; l->c_fb_noent = 0; l->c_fb_autopart = 0;
    return (PyObject *)l;
}

// GC support: Lane participates in a reference cycle by design
// (Kafka -> _lane -> fallback/wake bound methods -> Kafka), so it must
// be traversable or every producer instance leaks permanently.
static int lane_traverse(Lane *l, visitproc visit, void *arg) {
    Py_VISIT(l->map);
    Py_VISIT(l->fallback);
    Py_VISIT(l->wake);
    Py_VISIT(l->cache_topic);
    Py_VISIT(l->cache_entries);
    Py_VISIT(l->cache_map);
    Py_VISIT(l->part_map);
    return 0;
}

static int lane_clear(Lane *l) {
    Py_CLEAR(l->map);
    Py_CLEAR(l->fallback);
    Py_CLEAR(l->wake);
    Py_CLEAR(l->cache_topic);
    Py_CLEAR(l->cache_entries);
    Py_CLEAR(l->cache_map);
    Py_CLEAR(l->part_map);
    return 0;
}

static void lane_cache_invalidate(Lane *l) {
    Py_CLEAR(l->cache_topic);
    Py_CLEAR(l->cache_entries);
    Py_CLEAR(l->cache_map);
}

// map_set(topic, partition, entry): install an (Arena, toppar) entry.
// The ONLY legal way to mutate lane.map (keeps the lookup cache sound).
static PyObject *lane_map_set(Lane *l, PyObject *const *args,
                              Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "map_set(topic, partition, entry)");
        return NULL;
    }
    PyObject *key = PyTuple_Pack(2, args[0], args[1]);
    if (!key) return NULL;
    int r = PyDict_SetItem(l->map, key, args[2]);
    Py_DECREF(key);
    if (r < 0) return NULL;
    lane_cache_invalidate(l);
    Py_RETURN_NONE;
}

// map_del(topic, partition) -> removed entry | None
static PyObject *lane_map_del(Lane *l, PyObject *const *args,
                              Py_ssize_t nargs) {
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "map_del(topic, partition)");
        return NULL;
    }
    PyObject *key = PyTuple_Pack(2, args[0], args[1]);
    if (!key) return NULL;
    PyObject *ent = PyDict_GetItemWithError(l->map, key);  // borrowed
    if (!ent) {
        Py_DECREF(key);
        if (PyErr_Occurred()) return NULL;
        Py_RETURN_NONE;
    }
    Py_INCREF(ent);
    if (PyDict_DelItem(l->map, key) < 0) {
        Py_DECREF(key); Py_DECREF(ent);
        return NULL;
    }
    Py_DECREF(key);
    lane_cache_invalidate(l);
    return ent;
}

// part_set(topic, partition_cnt, mode): enable native auto-partition
// for the topic.  mode 1 = "murmur2", mode 2 = "murmur2_random" (falsy
// keys still fall back to the Python random partitioner).
static PyObject *lane_part_set(Lane *l, PyObject *const *args,
                               Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError,
                        "part_set(topic, partition_cnt, mode)");
        return NULL;
    }
    if (!PyLong_Check(args[1]) || !PyLong_Check(args[2])) {
        PyErr_SetString(PyExc_TypeError, "cnt and mode must be int");
        return NULL;
    }
    PyObject *ent = PyTuple_Pack(2, args[1], args[2]);
    if (!ent) return NULL;
    int r = PyDict_SetItem(l->part_map, args[0], ent);
    Py_DECREF(ent);
    if (r < 0) return NULL;
    Py_RETURN_NONE;
}

// part_del(topic): drop the topic's auto-partition entry (metadata
// change invalidates the cached partition count)
static PyObject *lane_part_del(Lane *l, PyObject *arg) {
    if (PyDict_Contains(l->part_map, arg) == 1
        && PyDict_DelItem(l->part_map, arg) < 0)
        return NULL;
    if (PyErr_Occurred()) return NULL;
    Py_RETURN_NONE;
}

// counters() -> {"engaged": n, "fallback": {reason: n, ...}}
static PyObject *lane_counters(Lane *l, PyObject *Py_UNUSED(ig)) {
    return Py_BuildValue(
        "{s:L,s:{s:L,s:L,s:L,s:L,s:L,s:L}}",
        "engaged", (long long)l->c_engaged,
        "fallback",
        "disabled", (long long)l->c_fb_disabled,
        "shape", (long long)l->c_fb_shape,
        "oversize", (long long)l->c_fb_oversize,
        "queue_full", (long long)l->c_fb_qfull,
        "no_entry", (long long)l->c_fb_noent,
        "auto_partition", (long long)l->c_fb_autopart);
}

static void lane_dealloc(Lane *l) {
    PyObject_GC_UnTrack(l);
    lane_clear(l);
    Py_TYPE(l)->tp_free((PyObject *)l);
}

// configure(fallback, wake, max_msgs, max_bytes[, copy_max])
static PyObject *lane_configure(Lane *l, PyObject *const *args,
                                Py_ssize_t nargs) {
    if (nargs != 4 && nargs != 5) {
        PyErr_SetString(
            PyExc_TypeError,
            "configure(fallback, wake, max_msgs, max_bytes[, copy_max])");
        return NULL;
    }
    Py_INCREF(args[0]); Py_XSETREF(l->fallback, args[0]);
    Py_INCREF(args[1]); Py_XSETREF(l->wake, args[1]);
    l->max_msgs = PyLong_AsLongLong(args[2]);
    l->max_bytes = PyLong_AsLongLong(args[3]);
    if (nargs == 5) l->copy_max = PyLong_AsLongLong(args[4]);
    if (PyErr_Occurred()) return NULL;
    Py_RETURN_NONE;
}

// acct(dn, dbytes) -> (msg_cnt, msg_bytes): shared accounting for the
// Message path / DR / purge / timeout sites (atomic under the GIL)
static PyObject *lane_acct(Lane *l, PyObject *const *args,
                           Py_ssize_t nargs) {
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "acct(dn, dbytes)");
        return NULL;
    }
    l->msg_cnt += PyLong_AsLongLong(args[0]);
    l->msg_bytes += PyLong_AsLongLong(args[1]);
    if (PyErr_Occurred()) return NULL;
    return Py_BuildValue("(LL)", (long long)l->msg_cnt,
                         (long long)l->msg_bytes);
}

// full() -> bool: queue-full check for the Message path
static PyObject *lane_full(Lane *l, PyObject *const *args,
                           Py_ssize_t nargs) {
    int64_t sz = 0;
    if (nargs == 1) sz = PyLong_AsLongLong(args[0]);
    return PyBool_FromLong(l->msg_cnt >= l->max_msgs
                           || l->msg_bytes + sz > l->max_bytes);
}

static const char *const lane_kwnames[] = {
    "topic", "value", "key", "partition", "on_delivery", "timestamp",
    "headers", "opaque", NULL};
// interned kwname objects (module init): caller kwnames are interned by
// CPython, so pointer equality is the common case
static PyObject *lane_kw_interned[8];
static PyObject *k_error_interned;   // per-item "error" key (produce_batch)

// toppar-entry lookup with the last-topic cache (shared by produce and
// produce_batch).  Returns a BORROWED entry or NULL (NULL + raised
// error = real failure; NULL without = unknown toppar).
static PyObject *lane_lookup(Lane *l, PyObject *topic, int64_t part,
                             PyObject *part_o) {
    if (topic == l->cache_topic && l->cache_entries
        && part < PyList_GET_SIZE(l->cache_entries)) {
        PyObject *ent = PyList_GET_ITEM(l->cache_entries, part);
        if (ent != Py_None) return ent;
    }
    PyObject *tmp = NULL;
    if (!part_o) { tmp = PyLong_FromLongLong(part); part_o = tmp; }
    if (!part_o) return NULL;
    PyObject *kt = PyTuple_Pack(2, topic, part_o);
    Py_XDECREF(tmp);
    if (!kt) return NULL;
    PyObject *ent = PyDict_GetItemWithError(l->map, kt);
    Py_DECREF(kt);
    if (!ent) return NULL;
    // populate the cache: each topic keeps its own entries list in
    // cache_map (str-keyed, hash cached in the str object), so a
    // multi-topic round-robin switches lists instead of rebuilding
    // them. The fast slot is repointed ONLY after every allocation
    // succeeded — a poisoned slot would route records to the wrong
    // topic's arena.
    if (l->cache_topic != topic) {
        if (!l->cache_map) {
            l->cache_map = PyDict_New();
            if (!l->cache_map) return NULL;
        }
        PyObject *lst = PyDict_GetItemWithError(l->cache_map, topic);
        if (!lst) {
            if (PyErr_Occurred()) return NULL;
            lst = PyList_New(0);
            if (!lst) return NULL;
            if (PyDict_SetItem(l->cache_map, topic, lst) < 0) {
                Py_DECREF(lst);
                return NULL;
            }
            Py_DECREF(lst);          // the dict's reference keeps it
        }
        Py_INCREF(topic);
        Py_XSETREF(l->cache_topic, topic);
        Py_INCREF(lst);
        Py_XSETREF(l->cache_entries, lst);
    }
    while (PyList_GET_SIZE(l->cache_entries) <= part) {
        if (PyList_Append(l->cache_entries, Py_None) < 0) return NULL;
    }
    Py_INCREF(ent);
    PyList_SetItem(l->cache_entries, part, ent);
    return ent;
}

// Java-compatible murmur2 (utils/hash.py murmur2; reference
// rd_murmur2, rdmurmur2.c:19) — trailing bytes read as SIGNED chars,
// exactly like org.apache.kafka.common.utils.Utils.murmur2.
static uint32_t tk_murmur2(const uint8_t *data, int64_t n) {
    const uint32_t M = 0x5BD1E995u;
    uint32_t h = 0x9747B28Cu ^ (uint32_t)n;
    int64_t i = 0;
    for (; n - i >= 4; i += 4) {
        uint32_t k = (uint32_t)data[i] | ((uint32_t)data[i + 1] << 8)
                   | ((uint32_t)data[i + 2] << 16)
                   | ((uint32_t)data[i + 3] << 24);
        k *= M;
        k ^= k >> 24;
        k *= M;
        h *= M;
        h ^= k;
    }
    switch (n - i) {
    case 3: h ^= (uint32_t)(int8_t)data[i + 2] << 16; /* fallthrough */
    case 2: h ^= (uint32_t)(int8_t)data[i + 1] << 8;  /* fallthrough */
    case 1: h ^= (uint32_t)(int8_t)data[i];
            h *= M;
    }
    h ^= h >> 13;
    h *= M;
    h ^= h >> 15;
    return h;
}

// zigzag varint append (protocol/varint.enc_i64 semantics)
static void hv_varint(std::vector<uint8_t> &v, int64_t val) {
    uint64_t z = ((uint64_t)val << 1) ^ (uint64_t)(val >> 63);
    while (z >= 0x80) { v.push_back((uint8_t)(z | 0x80)); z >>= 7; }
    v.push_back((uint8_t)z);
}

// Encode produce(headers=...) into the record's wire header framing
// (count varint + per-header key/value framing) — the exact bytes
// MsgsetWriterV2._build_py emits.  Accepts a tuple/list of (str|bytes,
// bytes|None) 2-tuples; anything else returns -1 with NO exception
// pending (the caller falls back to the Python Message path, which
// owns the full normalization/raising semantics).
static int encode_headers_blob(PyObject *hdrs, std::vector<uint8_t> &out) {
    int is_tuple = PyTuple_Check(hdrs);
    if (!is_tuple && !PyList_Check(hdrs)) return -1;
    Py_ssize_t nh = is_tuple ? PyTuple_GET_SIZE(hdrs)
                             : PyList_GET_SIZE(hdrs);
    out.clear();
    hv_varint(out, nh);
    for (Py_ssize_t i = 0; i < nh; i++) {
        PyObject *it = is_tuple ? PyTuple_GET_ITEM(hdrs, i)
                                : PyList_GET_ITEM(hdrs, i);
        if (!PyTuple_Check(it) || PyTuple_GET_SIZE(it) != 2) return -1;
        PyObject *hk = PyTuple_GET_ITEM(it, 0);
        PyObject *hv = PyTuple_GET_ITEM(it, 1);
        const char *kp;
        Py_ssize_t kl;
        if (PyUnicode_Check(hk)) {
            kp = PyUnicode_AsUTF8AndSize(hk, &kl);
            if (!kp) { PyErr_Clear(); return -1; }
        } else if (PyBytes_Check(hk)) {
            kp = PyBytes_AS_STRING(hk);
            kl = PyBytes_GET_SIZE(hk);
        } else {
            return -1;
        }
        hv_varint(out, kl);
        out.insert(out.end(), (const uint8_t *)kp,
                   (const uint8_t *)kp + kl);
        if (hv == Py_None) {
            hv_varint(out, -1);
        } else if (PyBytes_Check(hv)) {
            Py_ssize_t vl = PyBytes_GET_SIZE(hv);
            hv_varint(out, vl);
            const char *vp = PyBytes_AS_STRING(hv);
            out.insert(out.end(), (const uint8_t *)vp,
                       (const uint8_t *)vp + vl);
        } else {
            return -1;
        }
    }
    return 0;
}

// per-thread header-blob scratch for lane_produce (file scope so the
// eligibility gotos never jump over its declaration)
static thread_local std::vector<uint8_t> lane_hscratch;

// produce(topic, value=None, key=None, partition=-1, on_delivery=None,
//         timestamp=0, headers=(), opaque=None)
// The public producer entry point.  Eligible records append straight
// into the per-toppar arena; everything else tail-calls the fallback.
// Widened eligibility: explicit non-negative timestamps,
// record headers (pre-encoded into the side arena), and partition=UA
// via native murmur2 auto-partition when Python installed a part_map
// entry for the topic.
static PyObject *lane_produce(Lane *l, PyObject *const *args,
                              Py_ssize_t nargs, PyObject *kwnames) {
    PyObject *argv[8] = {NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL};
    if (nargs > 8) { // >8 positionals: fallback raises the proper TypeError
        if (!l->fallback) {
            PyErr_SetString(PyExc_RuntimeError, "lane fallback not set");
            return NULL;
        }
        return PyObject_Vectorcall(l->fallback, args, nargs, kwnames);
    }
    Py_ssize_t npos = nargs;
    for (Py_ssize_t i = 0; i < npos; i++) argv[i] = args[i];
    int eligible_kw = 1;
    if (kwnames) {
        Py_ssize_t nkw = PyTuple_GET_SIZE(kwnames);
        for (Py_ssize_t i = 0; i < nkw; i++) {
            PyObject *name = PyTuple_GET_ITEM(kwnames, i);
            int hit = 0;
            for (int j = 0; lane_kwnames[j]; j++) {
                if (name == lane_kw_interned[j]
                    || PyObject_RichCompareBool(name, lane_kw_interned[j],
                                                Py_EQ) == 1) {
                    if (j < npos) {
                        // duplicate positional+keyword: route to the
                        // Python fallback for the proper TypeError
                        eligible_kw = 0;
                        break;
                    }
                    argv[j] = args[nargs + i];
                    hit = 1;
                    break;
                }
            }
            if (!eligible_kw) break;
            if (!hit) { eligible_kw = 0; argv[0] = NULL; break; }
        }
    }
    PyObject *topic = argv[0], *value = argv[1], *key = argv[2];
    PyObject *partition = argv[3];
    PyObject *part_o = NULL;     // PyLong for lane_lookup (may be arg)
    const uint8_t *hp = NULL;
    int64_t hl = 0;
    int64_t ts_ms = 0;
    long long part = -1;
    if (!l->enabled || l->fatal) { l->c_fb_disabled++; goto fallback; }
    if (!eligible_kw || topic == NULL || !PyUnicode_Check(topic)
        || !(value == NULL || value == Py_None || PyBytes_Check(value))
        || !(key == NULL || key == Py_None || PyBytes_Check(key))
        || (partition != NULL && !PyLong_Check(partition))
        || !(argv[4] == NULL || argv[4] == Py_None)      // on_delivery
        || !(argv[7] == NULL || argv[7] == Py_None)) {   // opaque
        l->c_fb_shape++;
        goto fallback;
    }
    if (argv[5] != NULL) {                               // timestamp
        if (!PyLong_Check(argv[5])) { l->c_fb_shape++; goto fallback; }
        ts_ms = PyLong_AsLongLong(argv[5]);
        if (ts_ms < 0 || PyErr_Occurred()) {
            PyErr_Clear();
            l->c_fb_shape++;
            goto fallback;
        }
    }
    if (argv[6] != NULL && argv[6] != Py_None) {         // headers
        int empty =
            (PyTuple_Check(argv[6]) && PyTuple_GET_SIZE(argv[6]) == 0)
            || (PyList_Check(argv[6]) && PyList_GET_SIZE(argv[6]) == 0);
        if (!empty) {
            if (encode_headers_blob(argv[6], lane_hscratch) < 0) {
                l->c_fb_shape++;
                goto fallback;
            }
            hp = lane_hscratch.data();
            hl = (int64_t)lane_hscratch.size();
        }
    }
    if (partition != NULL) {
        part = PyLong_AsLongLong(partition);
        if (PyErr_Occurred()) {
            PyErr_Clear();
            l->c_fb_shape++;
            goto fallback;
        }
        part_o = partition;
    }
    if (part < 0) {
        // partition=UA: native murmur2 auto-partition.  part_map is
        // installed by Python only for the murmur2-family partitioners
        // once the topic's partition count is known (and dropped on
        // metadata change), so a hit here is bit-exact vs the Python
        // partitioner.
        PyObject *pe = PyDict_GetItemWithError(l->part_map, topic);
        if (!pe) {
            if (PyErr_Occurred()) return NULL;
            l->c_fb_autopart++;
            goto fallback;
        }
        long long cnt = PyLong_AsLongLong(PyTuple_GET_ITEM(pe, 0));
        long long mode = PyLong_AsLongLong(PyTuple_GET_ITEM(pe, 1));
        int keyed = key != NULL && key != Py_None
                    && PyBytes_GET_SIZE(key) > 0;
        if (cnt <= 0 || (mode == 2 && !keyed)) {
            // murmur2_random routes falsy keys through the Python
            // random partitioner — not reproducible here
            l->c_fb_autopart++;
            goto fallback;
        }
        const uint8_t *kd = keyed
            ? (const uint8_t *)PyBytes_AS_STRING(key)
            : (const uint8_t *)"";
        int64_t kn = keyed ? PyBytes_GET_SIZE(key) : 0;
        part = (long long)((tk_murmur2(kd, kn) & 0x7FFFFFFFu)
                           % (uint32_t)cnt);
        part_o = NULL;           // lane_lookup builds the PyLong
    }
    {
        // last-topic cache: pointer-identity topic + partition index
        // replaces tuple-pack + dict-hash on the steady-state path
        PyObject *ent = lane_lookup(l, topic, part, part_o);
        if (!ent) {
            if (PyErr_Occurred()) return NULL;
            l->c_fb_noent++;
            goto fallback;       // first sight: Python sets the entry up
        }
        Arena *a = (Arena *)PyTuple_GET_ITEM(ent, 0);
        int64_t kl = (key && key != Py_None) ? PyBytes_GET_SIZE(key) : -1;
        int64_t vl = (value && value != Py_None)
                         ? PyBytes_GET_SIZE(value) : -1;
        int64_t sz = (kl > 0 ? kl : 0) + (vl > 0 ? vl : 0);
        if (sz > l->copy_max || hl > l->copy_max) {
            l->c_fb_oversize++;
            goto fallback;      // message.copy.max.bytes (and the
                                // message.max.bytes cap the caller
                                // folds in): keep a reference /
                                // let the slow path size-check
        }
        if (l->msg_cnt >= l->max_msgs
            || l->msg_bytes + sz > l->max_bytes) {
            l->c_fb_qfull++;
            goto fallback;      // slow path raises _QUEUE_FULL
        }
        if (arena_do_append(
                a, kl >= 0 ? PyBytes_AS_STRING(key) : NULL, kl,
                vl >= 0 ? PyBytes_AS_STRING(value) : NULL, vl,
                ts_ms, hp, hl) < 0)
            return NULL;
        l->msg_cnt += 1;
        l->msg_bytes += sz;
        l->c_engaged += 1;
        if (a->count - a->start == 1 && l->wake) {
            // empty -> non-empty: wake the leader broker
            PyObject *tp = PyTuple_GET_ITEM(ent, 1);
            PyObject *r = PyObject_CallOneArg(l->wake, tp);
            if (!r) return NULL;
            Py_DECREF(r);
        }
        Py_RETURN_NONE;
    }
    // slow path: the Python Message pipeline (also first-sight setup)
fallback:
    // eligibility parsing may have left an OverflowError pending (e.g.
    // partition or timestamp outside int64) — clear before calling out
    if (PyErr_Occurred()) PyErr_Clear();
    if (!l->fallback) {
        PyErr_SetString(PyExc_RuntimeError, "lane fallback not set");
        return NULL;
    }
    return PyObject_Vectorcall(l->fallback, args, nargs, kwnames);
}

// produce_batch(topic, msgs, start, default_partition)
//   -> (next_index, appended)
// Append eligible dict records from msgs[start:] straight into their
// toppar arenas without a Python frame per record (the C analog of
// rd_kafka_produce_batch, rdkafka_msg.c:478).  Stops at the first item
// needing the Python path (headers/timestamp/opaque/oversize/queue-full/
// unknown toppar) and returns its index so the wrapper can handle that
// ONE item (preserving FIFO and per-item error semantics) and re-enter.
static PyObject *lane_produce_batch(Lane *l, PyObject *const *args,
                                    Py_ssize_t nargs) {
    if (nargs != 4) {
        PyErr_SetString(PyExc_TypeError,
                        "produce_batch(topic, msgs, start, default_part)");
        return NULL;
    }
    PyObject *topic = args[0], *msgs = args[1];
    int64_t start = PyLong_AsLongLong(args[2]);
    int64_t defpart = PyLong_AsLongLong(args[3]);
    if (PyErr_Occurred()) return NULL;
    if (!PyList_Check(msgs)) {
        PyErr_SetString(PyExc_TypeError, "msgs must be a list");
        return NULL;
    }
    int64_t n = PyList_GET_SIZE(msgs);
    int64_t appended = 0, i = start;
    PyObject *k_value = lane_kw_interned[1], *k_key = lane_kw_interned[2];
    PyObject *k_part = lane_kw_interned[3], *k_ts = lane_kw_interned[5];
    PyObject *k_hdrs = lane_kw_interned[6];
    if (!(l->enabled && !l->fatal && PyUnicode_Check(topic)))
        return Py_BuildValue("(LL)", (long long)start, 0LL);
    for (; i < n; i++) {
        PyObject *m = PyList_GET_ITEM(msgs, i);
        if (!PyDict_Check(m)) break;
        PyObject *value = PyDict_GetItemWithError(m, k_value);
        if (!value && PyErr_Occurred()) return NULL;
        PyObject *key = PyDict_GetItemWithError(m, k_key);
        if (!key && PyErr_Occurred()) return NULL;
        PyObject *part_o = PyDict_GetItemWithError(m, k_part);
        if (!part_o && PyErr_Occurred()) return NULL;
        PyObject *ts = PyDict_GetItemWithError(m, k_ts);
        if (!ts && PyErr_Occurred()) return NULL;
        PyObject *hdrs = PyDict_GetItemWithError(m, k_hdrs);
        if (!hdrs && PyErr_Occurred()) return NULL;
        int64_t part = defpart;
        if (part_o) {
            if (!PyLong_Check(part_o)) break;
            part = PyLong_AsLongLong(part_o);
            if (PyErr_Occurred()) { PyErr_Clear(); break; }
        }
        int ok =
            part >= 0
            && (value == NULL || value == Py_None || PyBytes_Check(value))
            && (key == NULL || key == Py_None || PyBytes_Check(key))
            && (ts == NULL || (PyLong_Check(ts)
                               && PyLong_AsLongLong(ts) == 0))
            && (hdrs == NULL || hdrs == Py_None
                || (PyTuple_Check(hdrs) && PyTuple_GET_SIZE(hdrs) == 0)
                || (PyList_Check(hdrs) && PyList_GET_SIZE(hdrs) == 0));
        if (!ok) {
            // a timestamp outside int64 leaves OverflowError pending —
            // clear it before handing the item to the Python path
            if (PyErr_Occurred()) PyErr_Clear();
            break;
        }
        // toppar lookup via the same last-topic cache as produce()
        PyObject *ent = lane_lookup(l, topic, part, part_o);
        if (!ent) {
            if (PyErr_Occurred()) return NULL;
            break;                 // unknown toppar: Python sets it up
        }
        int64_t kl = (key && key != Py_None) ? PyBytes_GET_SIZE(key) : -1;
        int64_t vl = (value && value != Py_None)
                         ? PyBytes_GET_SIZE(value) : -1;
        int64_t sz = (kl > 0 ? kl : 0) + (vl > 0 ? vl : 0);
        if (sz > l->copy_max) break;
        if (l->msg_cnt >= l->max_msgs || l->msg_bytes + sz > l->max_bytes)
            break;                 // Python raises/records _QUEUE_FULL
        Arena *a = (Arena *)PyTuple_GET_ITEM(ent, 0);
        if (arena_do_append(
                a, kl >= 0 ? PyBytes_AS_STRING(key) : NULL, kl,
                vl >= 0 ? PyBytes_AS_STRING(value) : NULL, vl,
                0, NULL, 0) < 0)
            return NULL;
        l->msg_cnt += 1;
        l->msg_bytes += sz;
        l->c_engaged += 1;
        appended++;
        if (a->count - a->start == 1 && l->wake) {
            PyObject *tp = PyTuple_GET_ITEM(ent, 1);
            PyObject *r = PyObject_CallOneArg(l->wake, tp);
            if (!r) return NULL;
            Py_DECREF(r);
        }
        // clear a stale per-item error from a previous attempt
        if (k_error_interned
            && PyDict_Contains(m, k_error_interned) == 1)
            PyDict_DelItem(m, k_error_interned);
    }
    return Py_BuildValue("(LL)", (long long)i, (long long)appended);
}

// produce_raw(topic, partition, base_addr, klens_addr, vlens_addr,
//             count) -> appended count | -1 (toppar not registered)
// The C-ABI batch lane (capi tk_produce_batch): the caller hands the
// ARENA-LAYOUT arrays (concatenated key||value bytes + int32 len
// arrays, -1 = null) by address and the whole run appends in one
// GIL-held native pass — the reference's rd_kafka_produce_batch with
// the enqueue lane's memory layout. Stops early on queue-full.
static PyObject *lane_produce_raw(Lane *l, PyObject *const *args,
                                  Py_ssize_t nargs) {
    if (nargs != 6) {
        PyErr_SetString(PyExc_TypeError,
                        "produce_raw(topic, partition, base_addr, "
                        "klens_addr, vlens_addr, count)");
        return NULL;
    }
    PyObject *topic = args[0];
    int64_t part = PyLong_AsLongLong(args[1]);
    const uint8_t *base = (const uint8_t *)PyLong_AsVoidPtr(args[2]);
    const int32_t *klens = (const int32_t *)PyLong_AsVoidPtr(args[3]);
    const int32_t *vlens = (const int32_t *)PyLong_AsVoidPtr(args[4]);
    int64_t count = PyLong_AsLongLong(args[5]);
    if (PyErr_Occurred()) return NULL;
    if (!(l->enabled && !l->fatal && part >= 0 && PyUnicode_Check(topic)))
        return PyLong_FromLong(-1);
    PyObject *ent = lane_lookup(l, topic, part, NULL);
    if (!ent) {
        if (PyErr_Occurred()) return NULL;
        return PyLong_FromLong(-1);
    }
    Arena *a = (Arena *)PyTuple_GET_ITEM(ent, 0);
    int was_empty = (a->count == a->start);
    const uint8_t *src = base;
    int64_t i = 0;
    for (; i < count; i++) {
        int64_t kl = klens[i], vl = vlens[i];
        int64_t sz = (kl > 0 ? kl : 0) + (vl > 0 ? vl : 0);
        if (sz > l->copy_max) break;
        if (l->msg_cnt >= l->max_msgs || l->msg_bytes + sz > l->max_bytes)
            break;
        const uint8_t *kp = kl > 0 ? src : NULL;
        if (kl > 0) src += kl;
        const uint8_t *vp = vl > 0 ? src : NULL;
        if (vl > 0) src += vl;
        if (arena_do_append(a, (const char *)kp, kl,
                            (const char *)vp, vl, 0, NULL, 0) < 0)
            return NULL;
        l->msg_cnt += 1;
        l->msg_bytes += sz;
        l->c_engaged += 1;
    }
    if (i > 0 && was_empty && l->wake) {
        PyObject *tp = PyTuple_GET_ITEM(ent, 1);
        PyObject *r = PyObject_CallOneArg(l->wake, tp);
        if (!r) return NULL;
        Py_DECREF(r);
    }
    return PyLong_FromLongLong(i);
}

// murmur2_partition(key: bytes, partition_cnt: int) -> int
// Module-level parity hook: the exact partition lane_produce computes
// natively, exported so tests can sweep it against utils/hash.py.
static PyObject *mod_murmur2_partition(PyObject *Py_UNUSED(self),
                                       PyObject *const *args,
                                       Py_ssize_t nargs) {
    if (nargs != 2 || !PyBytes_Check(args[0])) {
        PyErr_SetString(PyExc_TypeError,
                        "murmur2_partition(key: bytes, cnt: int)");
        return NULL;
    }
    long long cnt = PyLong_AsLongLong(args[1]);
    if (PyErr_Occurred()) return NULL;
    if (cnt <= 0) {
        PyErr_SetString(PyExc_ValueError, "partition_cnt must be > 0");
        return NULL;
    }
    uint32_t h = tk_murmur2((const uint8_t *)PyBytes_AS_STRING(args[0]),
                            PyBytes_GET_SIZE(args[0]));
    return PyLong_FromUnsignedLong((h & 0x7FFFFFFFu) % (uint32_t)cnt);
}

// ==================================================== fused builder =====
//
// build_batch: ArenaBatch -> complete wire RecordBatch (v2 header +
// records, compressed, CRC patched) in ONE call with the GIL released.
// The 3-phase Python pipeline (frame -> compress_many -> assemble ->
// patch_crc) moves each 1MB batch through ~5 user-space copies plus
// per-phase ctypes glue; on a 1-core host that memory traffic IS the
// producer ceiling.  Fusing drops it to: frame into a reused scratch,
// compress scratch -> the output bytes, header+CRC in place.
// (Reference: rd_kafka_msgset_writer_finalize does header+CRC in place
// on the accumulated rd_buf, rdkafka_msgset_writer.c:1230.)
//
// The codec functions live in codec.cpp, compiled into this extension
// (build.py links both translation units).

extern "C" {
int64_t tk_frame_v2_bound(int64_t payload_bytes, int count);
int64_t tk_frame_v2(const uint8_t *base, const int32_t *klens,
                    const int32_t *vlens, const int64_t *ts_deltas,
                    int count, uint8_t *out, int64_t cap);
int64_t tk_frame_v2_run(const uint8_t *base, const int32_t *klens,
                        const int32_t *vlens, const int64_t *tss,
                        int64_t now_ms, const uint8_t *hbuf,
                        const int32_t *hlens, int count,
                        uint8_t *out, int64_t cap,
                        int64_t *first_ts, int64_t *max_ts);
int64_t tk_lz4f_bound(int64_t n);
int64_t tk_lz4f_compress_fast(const uint8_t *src, int64_t n,
                              uint8_t *dst, int64_t cap);
int64_t tk_lz4f_decompress(const uint8_t *src, int64_t n,
                           uint8_t *dst, int64_t cap);
int64_t tk_snappy_bound(int64_t n);
int64_t tk_snappy_compress(const uint8_t *src, int64_t n,
                           uint8_t *dst, int64_t cap);
int64_t tk_snappy_uncompressed_length(const uint8_t *src, int64_t n);
int64_t tk_lz4f_decompressed_size(const uint8_t *src, int64_t n);
int64_t tk_snappy_decompress(const uint8_t *src, int64_t n,
                             uint8_t *dst, int64_t cap);
uint32_t tk_crc32c(const uint8_t *p, int64_t n, uint32_t crc);
}

// RecordBatch v2 header layout (public Apache Kafka protocol; mirrors
// proto.py V2_OF_* and reference rdkafka_proto.h RD_KAFKAP_MSGSET_V2_OF_*)
static const int64_t V2_HDR = 61;
static const int64_t V2_OF_CRC = 17;
static const int64_t V2_OF_ATTR = 21;

static inline void be16(uint8_t *p, uint16_t v) {
    p[0] = (uint8_t)(v >> 8); p[1] = (uint8_t)v;
}
static inline void be32(uint8_t *p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24); p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8); p[3] = (uint8_t)v;
}
static inline void be64(uint8_t *p, uint64_t v) {
    be32(p, (uint32_t)(v >> 32)); be32(p + 4, (uint32_t)v);
}

// build_batch(base, klens, vlens, count, now_ms, pid, epoch, base_seq,
//             codec_id[, attr_flags[, tss, hbuf, hlens]]) -> bytes
// codec_id: 0 none, 2 snappy, 3 lz4 (the wire attribute values).
// attr_flags: extra v2 attribute bits OR'd into the attribute word
// (the transactional bit 0x10 for EOS batches; codec bits still come
// from the compression outcome).
// tss/hbuf/hlens (each bytes|None) are the arena run's per-record
// explicit-timestamp int64s and pre-encoded header blobs; with all
// three None every record carries now_ms (fast-lane default) so
// first=max=now_ms and every delta is 0 — exactly what
// MsgsetWriterV2._build_py emits for the same records.
static PyObject *mod_build_batch(PyObject *Py_UNUSED(self),
                                 PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 9 && nargs != 10 && nargs != 13) {
        PyErr_SetString(PyExc_TypeError,
                        "build_batch(base, klens, vlens, count, now_ms, "
                        "pid, epoch, base_seq, codec_id[, attr_flags"
                        "[, tss, hbuf, hlens]])");
        return NULL;
    }
    Py_buffer base, kb, vb;
    Py_buffer tsb = {0}, hb = {0}, hlb = {0};
    int has_ts = 0, has_h = 0;
    if (PyObject_GetBuffer(args[0], &base, PyBUF_SIMPLE) < 0) return NULL;
    if (PyObject_GetBuffer(args[1], &kb, PyBUF_SIMPLE) < 0) {
        PyBuffer_Release(&base); return NULL;
    }
    if (PyObject_GetBuffer(args[2], &vb, PyBUF_SIMPLE) < 0) {
        PyBuffer_Release(&base); PyBuffer_Release(&kb); return NULL;
    }
    int64_t count = PyLong_AsLongLong(args[3]);
    int64_t now_ms = PyLong_AsLongLong(args[4]);
    int64_t pid = PyLong_AsLongLong(args[5]);
    int64_t epoch = PyLong_AsLongLong(args[6]);
    int64_t base_seq = PyLong_AsLongLong(args[7]);
    int64_t codec = PyLong_AsLongLong(args[8]);
    int64_t attr_flags = nargs >= 10 ? PyLong_AsLongLong(args[9]) : 0;
    PyObject *out = NULL;
    if (PyErr_Occurred()) goto done;
    if (nargs == 13) {
        if (args[10] != Py_None) {
            if (PyObject_GetBuffer(args[10], &tsb, PyBUF_SIMPLE) < 0)
                goto done;
            has_ts = 1;
        }
        if (args[11] != Py_None) {
            if (PyObject_GetBuffer(args[11], &hb, PyBUF_SIMPLE) < 0)
                goto done;
            has_h = 1;
            if (args[12] == Py_None
                || PyObject_GetBuffer(args[12], &hlb, PyBUF_SIMPLE) < 0) {
                if (!PyErr_Occurred())
                    PyErr_SetString(PyExc_ValueError,
                                    "build_batch: hbuf without hlens");
                goto done;
            }
        }
    }
    if (count <= 0 || (int64_t)kb.len < count * 4
        || (int64_t)vb.len < count * 4
        || (has_ts && (int64_t)tsb.len < count * 8)
        || (has_h && (int64_t)hlb.len < count * 4)
        || (codec != 0 && codec != 2 && codec != 3)) {
        PyErr_SetString(PyExc_ValueError, "build_batch: bad arguments");
        goto done;
    }
    {
        int64_t fbound = tk_frame_v2_bound(
            base.len + (has_h ? (int64_t)hb.len : 0), (int)count);
        // worst-case payload: compressed bound, or the raw records when
        // incompressible (stored plain, attributes codec bits = 0)
        int64_t cap;
        if (codec == 3) cap = tk_lz4f_bound(fbound);
        else if (codec == 2) cap = tk_snappy_bound(fbound);
        else cap = fbound;
        if (cap < fbound) cap = fbound;
        out = PyBytes_FromStringAndSize(NULL, V2_HDR + cap);
        if (!out) goto done;
        uint8_t *o = (uint8_t *)PyBytes_AS_STRING(out);
        int64_t rlen = -1, plen = -1;
        int64_t first_ts = now_ms, max_ts = now_ms;
        int attr_codec = 0;
        const int64_t *tss_p =
            has_ts ? (const int64_t *)tsb.buf : NULL;
        const uint8_t *hbuf_p = has_h ? (const uint8_t *)hb.buf : NULL;
        const int32_t *hlens_p = has_h ? (const int32_t *)hlb.buf : NULL;
        // per-thread scratch for the uncompressed records (reused
        // across batches; freed when the thread exits)
        static thread_local std::vector<uint8_t> scratch;
        Py_BEGIN_ALLOW_THREADS
        if (codec == 0) {
            rlen = tk_frame_v2_run((const uint8_t *)base.buf,
                                   (const int32_t *)kb.buf,
                                   (const int32_t *)vb.buf,
                                   tss_p, now_ms, hbuf_p, hlens_p,
                                   (int)count, o + V2_HDR, cap,
                                   &first_ts, &max_ts);
            plen = rlen;
        } else {
            if ((int64_t)scratch.size() < fbound)
                scratch.resize((size_t)fbound);
            rlen = tk_frame_v2_run((const uint8_t *)base.buf,
                                   (const int32_t *)kb.buf,
                                   (const int32_t *)vb.buf,
                                   tss_p, now_ms, hbuf_p, hlens_p,
                                   (int)count, scratch.data(), fbound,
                                   &first_ts, &max_ts);
            if (rlen >= 0) {
                int64_t clen =
                    codec == 3
                        ? tk_lz4f_compress_fast(scratch.data(), rlen,
                                                o + V2_HDR, cap)
                        : tk_snappy_compress(scratch.data(), rlen,
                                             o + V2_HDR, cap);
                if (clen >= 0 && clen < rlen) {
                    plen = clen;
                    attr_codec = (int)codec;
                } else {          // incompressible: store plain
                    memcpy(o + V2_HDR, scratch.data(), (size_t)rlen);
                    plen = rlen;
                }
            }
        }
        if (rlen >= 0) {
            be64(o, 0);                               // BaseOffset
            be32(o + 8, (uint32_t)(V2_HDR - 12 + plen));  // Length
            // PartitionLeaderEpoch=0, matching the reference writer
            // (rdkafka_msgset_writer.c:368) and MsgsetWriterV2.assemble
            be32(o + 12, 0);
            o[16] = 2;                                // Magic
            be32(o + V2_OF_CRC, 0);                   // CRC placeholder
            be16(o + V2_OF_ATTR, (uint16_t)(attr_codec | attr_flags));
            be32(o + 23, (uint32_t)(count - 1));      // LastOffsetDelta
            be64(o + 27, (uint64_t)first_ts);         // FirstTimestamp
            be64(o + 35, (uint64_t)max_ts);           // MaxTimestamp
            be64(o + 43, (uint64_t)pid);
            be16(o + 51, (uint16_t)epoch);
            be32(o + 53, (uint32_t)base_seq);
            be32(o + 57, (uint32_t)count);
            be32(o + V2_OF_CRC,
                 tk_crc32c(o + V2_OF_ATTR, V2_HDR - V2_OF_ATTR + plen, 0));
        }
        Py_END_ALLOW_THREADS
        if (rlen < 0) {
            Py_CLEAR(out);
            PyErr_SetString(PyExc_ValueError,
                            "build_batch: frame capacity shortfall");
            goto done;
        }
        if (_PyBytes_Resize(&out, V2_HDR + plen) < 0) out = NULL;
    }
done:
    PyBuffer_Release(&base);
    PyBuffer_Release(&kb);
    PyBuffer_Release(&vb);
    if (has_ts) PyBuffer_Release(&tsb);
    if (has_h) {
        PyBuffer_Release(&hb);
        if (hlb.obj) PyBuffer_Release(&hlb);
    }
    return out;
}

// ============================================ fetch materialization =====
//
// materialize_v2: bulk-create delivery-ready client Message objects
// straight off tk_parse_v2's field table.  The Python loop sets 18
// slot attributes per record through bytecode (~1.5-2 us/record — the
// consumer budget); here each Message is tp_alloc + direct slot-offset
// stores.  Slot offsets come from the class's member descriptors, so
// this tracks the Python class definition (a missing slot fails loudly
// at first call, not per record).
// (Reference analog: rd_kafka_msgset_reader_msg_parse builds rko_msg
// structs inline, rdkafka_msgset_reader.c:902.)

#include <descrobject.h>

static const char *const MSG_SLOTS[] = {
    "topic", "partition", "key", "value", "headers", "offset",
    "timestamp", "timestamp_type", "error", "opaque", "msgid",
    "retries", "status", "enq_time", "ts_backoff", "latency_us",
    "on_delivery", "size", NULL};
enum {
    S_TOPIC, S_PARTITION, S_KEY, S_VALUE, S_HEADERS, S_OFFSET,
    S_TIMESTAMP, S_TSTYPE, S_ERROR, S_OPAQUE, S_MSGID,
    S_RETRIES, S_STATUS, S_ENQ, S_BACKOFF, S_LATENCY,
    S_ONDEL, S_SIZE, S_NSLOTS};

static PyTypeObject *msg_type_cached = NULL;
static Py_ssize_t msg_slot_off[S_NSLOTS];

static int resolve_msg_slots(PyTypeObject *type) {
    for (int i = 0; MSG_SLOTS[i]; i++) {
        PyObject *d = PyDict_GetItemString(type->tp_dict, MSG_SLOTS[i]);
        if (!d || !PyObject_TypeCheck(d, &PyMemberDescr_Type)) {
            PyErr_Format(PyExc_TypeError,
                         "materialize_v2: %s.%s is not a slot member",
                         type->tp_name, MSG_SLOTS[i]);
            return -1;
        }
        msg_slot_off[i] = ((PyMemberDescrObject *)d)->d_member->offset;
    }
    msg_type_cached = type;
    return 0;
}

static inline void slot_set(PyObject *m, int slot, PyObject *v) {
    // tp_alloc zeroed the slot; store a NEW reference (caller increfs)
    *(PyObject **)((char *)m + msg_slot_off[slot]) = v;
}

// materialize_v2(msg_type, records: bytes, fields_addr: int, n: int,
//                topic: str, partition: int, base_off: int, fo: int,
//                base_ts: int, append_ts: int, log_append: int,
//                tstype: int, status: object)
//   -> (list[Message], total_payload_bytes, header_fixups | None)
// header_fixups: [(list_index, ho, nh), ...] for records with headers —
// the (rare) header parse stays in Python.
static PyObject *mod_materialize_v2(PyObject *Py_UNUSED(self),
                                    PyObject *const *args,
                                    Py_ssize_t nargs) {
    if (nargs != 13) {
        PyErr_SetString(PyExc_TypeError, "materialize_v2: 13 args");
        return NULL;
    }
    PyTypeObject *type = (PyTypeObject *)args[0];
    if (!PyType_Check(args[0])) {
        PyErr_SetString(PyExc_TypeError, "arg 0 must be the Message type");
        return NULL;
    }
    if (type != msg_type_cached && resolve_msg_slots(type) < 0)
        return NULL;
    Py_buffer rb;
    if (PyObject_GetBuffer(args[1], &rb, PyBUF_SIMPLE) < 0) return NULL;
    const int64_t *fields = (const int64_t *)PyLong_AsVoidPtr(args[2]);
    int64_t n = PyLong_AsLongLong(args[3]);
    PyObject *topic = args[4];
    int64_t partition = PyLong_AsLongLong(args[5]);
    int64_t base_off = PyLong_AsLongLong(args[6]);
    int64_t fo = PyLong_AsLongLong(args[7]);
    int64_t base_ts = PyLong_AsLongLong(args[8]);
    PyObject *append_ts_obj = args[9];      // PyLong (shared when log_append)
    int log_append = (int)PyLong_AsLong(args[10]);
    PyObject *tstype = args[11];
    PyObject *status = args[12];
    if (PyErr_Occurred()) { PyBuffer_Release(&rb); return NULL; }
    const char *rbase = (const char *)rb.buf;
    int64_t rblen = rb.len;

    PyObject *list = PyList_New(0);
    PyObject *fixups = NULL;
    PyObject *part_obj = PyLong_FromLongLong(partition);
    PyObject *zero = PyLong_FromLong(0);
    PyObject *fzero = PyFloat_FromDouble(0.0);
    int64_t total = 0;
    // one-entry timestamp memo: fast-lane batches carry one timestamp
    int64_t ts_memo_v = INT64_MIN;
    PyObject *ts_memo = NULL;
    if (!list || !part_obj || !zero || !fzero) goto fail;
    for (int64_t i = 0; i < n; i++) {
        const int64_t *f = fields + i * 8;
        int64_t off = base_off + f[1];
        if (off < fo) continue;
        int64_t ko = f[2], kl = f[3], vo = f[4], vl = f[5];
        if (kl > 0 && (ko < 0 || ko + kl > rblen)) goto bounds;
        if (vl > 0 && (vo < 0 || vo + vl > rblen)) goto bounds;
        {
            PyObject *m = type->tp_alloc(type, 0);
            if (!m) goto fail;
            PyObject *key, *value, *headers, *off_o, *ts_o, *size_o;
            if (kl >= 0) key = PyBytes_FromStringAndSize(rbase + ko, kl);
            else { key = Py_None; Py_INCREF(key); }
            if (vl >= 0) value = PyBytes_FromStringAndSize(rbase + vo, vl);
            else { value = Py_None; Py_INCREF(value); }
            headers = PyList_New(0);
            off_o = PyLong_FromLongLong(off);
            if (log_append) {
                ts_o = append_ts_obj; Py_INCREF(ts_o);
            } else {
                int64_t tsv = base_ts + f[0];
                if (tsv != ts_memo_v || !ts_memo) {
                    Py_XDECREF(ts_memo);
                    ts_memo = PyLong_FromLongLong(tsv);
                    ts_memo_v = tsv;
                }
                ts_o = ts_memo; Py_XINCREF(ts_o);
            }
            int64_t sz = (vl > 0 ? vl : 0) + (kl > 0 ? kl : 0);
            size_o = PyLong_FromLongLong(sz);
            if (!key || !value || !headers || !off_o || !ts_o || !size_o) {
                Py_XDECREF(key); Py_XDECREF(value); Py_XDECREF(headers);
                Py_XDECREF(off_o); Py_XDECREF(ts_o); Py_XDECREF(size_o);
                Py_DECREF(m);
                goto fail;
            }
            Py_INCREF(topic);  slot_set(m, S_TOPIC, topic);
            Py_INCREF(part_obj); slot_set(m, S_PARTITION, part_obj);
            slot_set(m, S_KEY, key);
            slot_set(m, S_VALUE, value);
            slot_set(m, S_HEADERS, headers);
            slot_set(m, S_OFFSET, off_o);
            slot_set(m, S_TIMESTAMP, ts_o);
            Py_INCREF(tstype); slot_set(m, S_TSTYPE, tstype);
            Py_INCREF(Py_None); slot_set(m, S_ERROR, Py_None);
            Py_INCREF(Py_None); slot_set(m, S_OPAQUE, Py_None);
            Py_INCREF(zero); slot_set(m, S_MSGID, zero);
            Py_INCREF(zero); slot_set(m, S_RETRIES, zero);
            Py_INCREF(status); slot_set(m, S_STATUS, status);
            Py_INCREF(fzero); slot_set(m, S_ENQ, fzero);
            Py_INCREF(fzero); slot_set(m, S_BACKOFF, fzero);
            Py_INCREF(zero); slot_set(m, S_LATENCY, zero);
            Py_INCREF(Py_None); slot_set(m, S_ONDEL, Py_None);
            slot_set(m, S_SIZE, size_o);
            PyObject_GC_UnTrack(m);   // acyclic leaves only (see lazy)
            total += sz;
            if (PyList_Append(list, m) < 0) { Py_DECREF(m); goto fail; }
            Py_DECREF(m);
            if (f[7] > 0) {            // record carries headers: fix up
                if (!fixups) {
                    fixups = PyList_New(0);
                    if (!fixups) goto fail;
                }
                PyObject *t = Py_BuildValue(
                    "(nLL)", PyList_GET_SIZE(list) - 1,
                    (long long)f[6], (long long)f[7]);
                if (!t || PyList_Append(fixups, t) < 0) {
                    Py_XDECREF(t); goto fail;
                }
                Py_DECREF(t);
            }
        }
    }
    {
        PyObject *r = Py_BuildValue("(OLO)", list, (long long)total,
                                    fixups ? fixups : Py_None);
        Py_DECREF(list);
        Py_XDECREF(fixups);
        Py_XDECREF(ts_memo);
        Py_DECREF(part_obj); Py_DECREF(zero); Py_DECREF(fzero);
        PyBuffer_Release(&rb);
        return r;
    }
bounds:
    PyErr_SetString(PyExc_ValueError,
                    "materialize_v2: record field out of bounds");
fail:
    Py_XDECREF(list);
    Py_XDECREF(fixups);
    Py_XDECREF(ts_memo);
    Py_XDECREF(part_obj); Py_XDECREF(zero); Py_XDECREF(fzero);
    PyBuffer_Release(&rb);
    return NULL;
}

// crc32c_many(buffers) -> list[int]
// Per-buffer CRC32C with no join copy: the ctypes provider path
// concatenated every region into one contiguous base first (a ~2 GB/s
// memcpy in front of a ~15 GB/s hardware CRC).
static PyObject *mod_crc32c_many(PyObject *Py_UNUSED(self),
                                 PyObject *const *args,
                                 Py_ssize_t nargs) {
    if (nargs != 1) {
        PyErr_SetString(PyExc_TypeError, "crc32c_many(buffers)");
        return NULL;
    }
    PyObject *seq = PySequence_Fast(args[0], "crc32c_many: not a sequence");
    if (!seq) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject *out = PyList_New(n);
    if (!out) { Py_DECREF(seq); return NULL; }
    std::vector<Py_buffer> bufs((size_t)n);
    Py_ssize_t got = 0;
    for (; got < n; got++) {
        if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(seq, got),
                               &bufs[got], PyBUF_SIMPLE) < 0)
            break;
    }
    if (got == n) {
        std::vector<uint32_t> crcs((size_t)n);
        Py_BEGIN_ALLOW_THREADS
        for (Py_ssize_t i = 0; i < n; i++)
            crcs[i] = tk_crc32c((const uint8_t *)bufs[i].buf,
                                bufs[i].len, 0);
        Py_END_ALLOW_THREADS
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *v = PyLong_FromUnsignedLong(crcs[i]);
            if (!v) { Py_CLEAR(out); break; }
            PyList_SET_ITEM(out, i, v);
        }
    } else {
        Py_CLEAR(out);
    }
    for (Py_ssize_t i = 0; i < got; i++) PyBuffer_Release(&bufs[i]);
    Py_DECREF(seq);
    return out;
}

// decompress_many(codec_id, buffers, hints|None) -> list[bytes|None]
// codec_id: 3 lz4-frame, 2 raw snappy.  Output bytes are written in
// place (alloc, decompress with the GIL released, shrink) — no join of
// the inputs, no string_at copy of the outputs.  A buffer that fails
// comes back None (caller falls back / errors the batch).
static PyObject *mod_decompress_many(PyObject *Py_UNUSED(self),
                                     PyObject *const *args,
                                     Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError,
                        "decompress_many(codec_id, buffers, hints)");
        return NULL;
    }
    int64_t codec = PyLong_AsLongLong(args[0]);
    if (PyErr_Occurred()) return NULL;
    if (codec != 2 && codec != 3) {
        PyErr_SetString(PyExc_ValueError, "codec_id must be 2 or 3");
        return NULL;
    }
    PyObject *seq = PySequence_Fast(args[1],
                                    "decompress_many: not a sequence");
    if (!seq) return NULL;
    PyObject *hints = args[2] == Py_None ? NULL : args[2];
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject *out = PyList_New(n);
    if (!out) { Py_DECREF(seq); return NULL; }
    for (Py_ssize_t i = 0; i < n; i++) {
        Py_buffer src;
        if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(seq, i), &src,
                               PyBUF_SIMPLE) < 0) {
            Py_DECREF(seq); Py_DECREF(out);
            return NULL;
        }
        int64_t cap = 0;
        if (hints) {
            PyObject *h = PySequence_GetItem(hints, i);
            if (h) { cap = PyLong_AsLongLong(h); Py_DECREF(h); }
            if (PyErr_Occurred()) PyErr_Clear();
        }
        if (codec == 2) {
            int64_t ul = tk_snappy_uncompressed_length(
                (const uint8_t *)src.buf, src.len);
            if (ul >= 0 && ul > cap) cap = ul;
        } else if (cap <= 0) {
            // lz4: exact size by a write-free sequence walk — the 4x
            // guess below re-decodes high-ratio batches (40x is normal
            // for templated payloads) through the retry loop
            int64_t ul = tk_lz4f_decompressed_size(
                (const uint8_t *)src.buf, src.len);
            if (ul > 0) cap = ul;
        }
        if (cap <= 0) cap = 4 * src.len + (64 << 10);
        PyObject *b = NULL;
        int64_t r = -4;
        // untrusted input: never let the retry doubling request more
        // than the format's max expansion (~255:1 for lz4; snappy's
        // preamble is authoritative but bounded the same way)
        const int64_t cap_max = 256 * src.len + (64 << 10);
        if (cap > cap_max) cap = cap_max;
        for (int attempt = 0; attempt < 8; attempt++) {
            b = PyBytes_FromStringAndSize(NULL, cap);
            if (!b) break;
            uint8_t *dst = (uint8_t *)PyBytes_AS_STRING(b);
            Py_BEGIN_ALLOW_THREADS
            r = codec == 3
                    ? tk_lz4f_decompress((const uint8_t *)src.buf,
                                         src.len, dst, cap)
                    : tk_snappy_decompress((const uint8_t *)src.buf,
                                           src.len, dst, cap);
            Py_END_ALLOW_THREADS
            if (r != -4) break;          // -4 = capacity shortfall
            Py_DECREF(b); b = NULL;
            cap *= 4;
            if (cap > cap_max) {
                if (cap / 4 >= cap_max) break;   // already tried max
                cap = cap_max;
            }
        }
        PyBuffer_Release(&src);
        if (b && r >= 0 && _PyBytes_Resize(&b, r) == 0) {
            PyList_SET_ITEM(out, i, b);
        } else {
            Py_XDECREF(b);
            if (PyErr_Occurred()) PyErr_Clear();
            Py_INCREF(Py_None);
            PyList_SET_ITEM(out, i, Py_None);
        }
    }
    Py_DECREF(seq);
    return out;
}

// materialize_arena(msg_type, base, klens, vlens, count, topic,
//                   partition, base_offset, msgid_base, enq_time,
//                   retries, status, error) -> list[Message]
// Bulk Message creation from the ARENA layout (concatenated key||value
// + int32 len arrays) — the delivery-report path's ArenaBatch
// materialization (kafka.dr_msgq), same slot-store scheme as
// materialize_v2.  base_offset < 0 stores offset -1 per message.
static PyObject *mod_materialize_arena(PyObject *Py_UNUSED(self),
                                       PyObject *const *args,
                                       Py_ssize_t nargs) {
    if (nargs != 13) {
        PyErr_SetString(PyExc_TypeError, "materialize_arena: 13 args");
        return NULL;
    }
    PyTypeObject *type = (PyTypeObject *)args[0];
    if (!PyType_Check(args[0])) {
        PyErr_SetString(PyExc_TypeError, "arg 0 must be the Message type");
        return NULL;
    }
    if (type != msg_type_cached && resolve_msg_slots(type) < 0)
        return NULL;
    Py_buffer base, kb, vb;
    if (PyObject_GetBuffer(args[1], &base, PyBUF_SIMPLE) < 0) return NULL;
    if (PyObject_GetBuffer(args[2], &kb, PyBUF_SIMPLE) < 0) {
        PyBuffer_Release(&base); return NULL;
    }
    if (PyObject_GetBuffer(args[3], &vb, PyBUF_SIMPLE) < 0) {
        PyBuffer_Release(&base); PyBuffer_Release(&kb); return NULL;
    }
    int64_t count = PyLong_AsLongLong(args[4]);
    PyObject *topic = args[5];
    int64_t partition = PyLong_AsLongLong(args[6]);
    int64_t base_off = PyLong_AsLongLong(args[7]);
    int64_t msgid_base = PyLong_AsLongLong(args[8]);
    PyObject *enq_time = args[9];       // float (shared)
    PyObject *retries = args[10];       // int (shared)
    PyObject *status = args[11];
    PyObject *error = args[12];         // KafkaError | None (shared)
    PyObject *list = NULL, *part_obj = NULL, *ts_obj = NULL;
    PyObject *fzero = NULL, *zero = NULL;
    const int32_t *kl = (const int32_t *)kb.buf;
    const int32_t *vl = (const int32_t *)vb.buf;
    const char *src = (const char *)base.buf;
    int64_t remain = base.len;
    if (PyErr_Occurred()) goto done;
    if (count < 0 || (int64_t)kb.len < count * 4
        || (int64_t)vb.len < count * 4) {
        PyErr_SetString(PyExc_ValueError, "materialize_arena: bad args");
        goto done;
    }
    list = PyList_New(0);
    part_obj = PyLong_FromLongLong(partition);
    {
        // fast-lane records carry no per-record wall clock; DR messages
        // report the materialization time (Message.__init__ behavior)
        struct timespec ts;
        clock_gettime(CLOCK_REALTIME, &ts);
        ts_obj = PyLong_FromLongLong((int64_t)ts.tv_sec * 1000
                                     + ts.tv_nsec / 1000000);
    }
    fzero = PyFloat_FromDouble(0.0);
    zero = PyLong_FromLong(0);
    if (!list || !part_obj || !ts_obj || !fzero || !zero) goto fail;
    for (int64_t i = 0; i < count; i++) {
        int64_t k_len = kl[i], v_len = vl[i];
        int64_t need = (k_len > 0 ? k_len : 0) + (v_len > 0 ? v_len : 0);
        if (need > remain) {
            PyErr_SetString(PyExc_ValueError,
                            "materialize_arena: short base buffer");
            goto fail;
        }
        PyObject *m = type->tp_alloc(type, 0);
        if (!m) goto fail;
        PyObject *key, *value, *headers, *off_o, *msgid_o, *size_o;
        if (k_len >= 0) {
            key = PyBytes_FromStringAndSize(src, k_len);
            src += k_len; remain -= k_len;
        } else { key = Py_None; Py_INCREF(key); }
        if (v_len >= 0) {
            value = PyBytes_FromStringAndSize(src, v_len);
            src += v_len; remain -= v_len;
        } else { value = Py_None; Py_INCREF(value); }
        headers = PyList_New(0);
        off_o = PyLong_FromLongLong(base_off >= 0 ? base_off + i : -1);
        msgid_o = PyLong_FromLongLong(msgid_base + i);
        size_o = PyLong_FromLongLong((k_len > 0 ? k_len : 0)
                                     + (v_len > 0 ? v_len : 0));
        if (!key || !value || !headers || !off_o || !msgid_o || !size_o) {
            Py_XDECREF(key); Py_XDECREF(value); Py_XDECREF(headers);
            Py_XDECREF(off_o); Py_XDECREF(msgid_o); Py_XDECREF(size_o);
            Py_DECREF(m);
            goto fail;
        }
        Py_INCREF(topic);  slot_set(m, S_TOPIC, topic);
        Py_INCREF(part_obj); slot_set(m, S_PARTITION, part_obj);
        slot_set(m, S_KEY, key);
        slot_set(m, S_VALUE, value);
        slot_set(m, S_HEADERS, headers);
        slot_set(m, S_OFFSET, off_o);
        Py_INCREF(ts_obj); slot_set(m, S_TIMESTAMP, ts_obj);
        Py_INCREF(zero); slot_set(m, S_TSTYPE, zero);
        Py_INCREF(error); slot_set(m, S_ERROR, error);
        Py_INCREF(Py_None); slot_set(m, S_OPAQUE, Py_None);
        slot_set(m, S_MSGID, msgid_o);
        Py_INCREF(retries); slot_set(m, S_RETRIES, retries);
        Py_INCREF(status); slot_set(m, S_STATUS, status);
        Py_INCREF(enq_time); slot_set(m, S_ENQ, enq_time);
        Py_INCREF(fzero); slot_set(m, S_BACKOFF, fzero);
        Py_INCREF(zero); slot_set(m, S_LATENCY, zero);
        Py_INCREF(Py_None); slot_set(m, S_ONDEL, Py_None);
        slot_set(m, S_SIZE, size_o);
        PyObject_GC_UnTrack(m);       // acyclic leaves only (see lazy)
        if (PyList_Append(list, m) < 0) { Py_DECREF(m); goto fail; }
        Py_DECREF(m);
    }
    goto done;
fail:
    Py_CLEAR(list);
done:
    Py_XDECREF(part_obj); Py_XDECREF(ts_obj);
    Py_XDECREF(fzero); Py_XDECREF(zero);
    PyBuffer_Release(&base);
    PyBuffer_Release(&kb);
    PyBuffer_Release(&vb);
    return list;
}

// ----------------- lazy fetch materialization + delivery cursor -------
// FetchMessage (client/msg.py) stores the shared records buffer plus
// packed (offset<<32 | len) ints; .value/.key slice lazily in Python.
// Cuts the per-record cost from ~874 ns (PyBytes value copy) to the
// tp_alloc + a handful of stores (reference analog:
// rko_msg points into the fetch buffer, rdkafka_msgset_reader.c:715).

static const char *const FM_SLOTS[] = {
    "topic", "partition", "offset", "timestamp", "timestamp_type",
    "error", "status", "_buf", "_v", "_k", "_h", NULL};
enum { F_TOPIC, F_PART, F_OFFSET, F_TS, F_TSTYPE, F_ERROR, F_STATUS,
       F_BUF, F_V, F_K, F_H, F_NSLOTS };
static PyTypeObject *fm_type_cached = NULL;
static Py_ssize_t fm_slot_off[F_NSLOTS];

static int resolve_fm_slots(PyTypeObject *type) {
    for (int i = 0; FM_SLOTS[i]; i++) {
        PyObject *d = PyDict_GetItemString(type->tp_dict, FM_SLOTS[i]);
        if (!d || !PyObject_TypeCheck(d, &PyMemberDescr_Type)) {
            PyErr_Format(PyExc_TypeError,
                         "materialize_v2_lazy: %s.%s is not a slot member",
                         type->tp_name, FM_SLOTS[i]);
            return -1;
        }
        fm_slot_off[i] = ((PyMemberDescrObject *)d)->d_member->offset;
    }
    fm_type_cached = type;
    return 0;
}

static inline void fslot_set(PyObject *m, int slot, PyObject *v) {
    *(PyObject **)((char *)m + fm_slot_off[slot]) = v;
}

// materialize_v2_lazy(fm_type, records, fields_addr, n, topic,
//                     partition, base_off, fo, base_ts, append_ts,
//                     log_append, tstype)
//   -> (list[FetchMessage], total_payload_bytes, header_fixups | None)
static PyObject *mod_materialize_v2_lazy(PyObject *Py_UNUSED(self),
                                         PyObject *const *args,
                                         Py_ssize_t nargs) {
    if (nargs != 13) {
        PyErr_SetString(PyExc_TypeError, "materialize_v2_lazy: 13 args");
        return NULL;
    }
    PyTypeObject *type = (PyTypeObject *)args[0];
    if (!PyType_Check(args[0])) {
        PyErr_SetString(PyExc_TypeError,
                        "arg 0 must be the FetchMessage type");
        return NULL;
    }
    if (type != fm_type_cached && resolve_fm_slots(type) < 0)
        return NULL;
    PyObject *records = args[1];
    Py_buffer rb;
    if (PyObject_GetBuffer(records, &rb, PyBUF_SIMPLE) < 0) return NULL;
    const int64_t *fields = (const int64_t *)PyLong_AsVoidPtr(args[2]);
    int64_t n = PyLong_AsLongLong(args[3]);
    PyObject *topic = args[4];
    int64_t partition = PyLong_AsLongLong(args[5]);
    int64_t base_off = PyLong_AsLongLong(args[6]);
    int64_t fo = PyLong_AsLongLong(args[7]);
    int64_t base_ts = PyLong_AsLongLong(args[8]);
    PyObject *append_ts_obj = args[9];      // PyLong (shared, log_append)
    int log_append = (int)PyLong_AsLong(args[10]);
    PyObject *tstype = args[11];
    PyObject *status = args[12];
    if (PyErr_Occurred()) { PyBuffer_Release(&rb); return NULL; }
    int64_t rblen = rb.len;
    PyBuffer_Release(&rb);   // `records` object itself is what we keep

    PyObject *list = PyList_New(0);
    PyObject *fixups = NULL;
    PyObject *part_obj = PyLong_FromLongLong(partition);
    int64_t total = 0;
    int64_t ts_memo_v = INT64_MIN;
    PyObject *ts_memo = NULL;
    if (!list || !part_obj) goto fail;
    for (int64_t i = 0; i < n; i++) {
        const int64_t *f = fields + i * 8;
        int64_t off = base_off + f[1];
        if (off < fo) continue;
        int64_t ko = f[2], kl = f[3], vo = f[4], vl = f[5];
        if (kl > 0 && (ko < 0 || ko + kl > rblen)) goto bounds;
        if (vl > 0 && (vo < 0 || vo + vl > rblen)) goto bounds;
        {
            PyObject *m = type->tp_alloc(type, 0);
            if (!m) goto fail;
            PyObject *off_o = PyLong_FromLongLong(off);
            PyObject *ts_o;
            if (log_append) {
                ts_o = append_ts_obj; Py_INCREF(ts_o);
            } else {
                int64_t tsv = base_ts + f[0];
                if (tsv != ts_memo_v || !ts_memo) {
                    Py_XDECREF(ts_memo);
                    ts_memo = PyLong_FromLongLong(tsv);
                    ts_memo_v = tsv;
                }
                ts_o = ts_memo; Py_XINCREF(ts_o);
            }
            PyObject *v_o, *k_o;
            if (vl >= 0) v_o = PyLong_FromLongLong((vo << 32) | vl);
            else { v_o = Py_None; Py_INCREF(v_o); }
            if (kl >= 0) k_o = PyLong_FromLongLong((ko << 32) | kl);
            else { k_o = Py_None; Py_INCREF(k_o); }
            if (!off_o || !ts_o || !v_o || !k_o) {
                Py_XDECREF(off_o); Py_XDECREF(ts_o);
                Py_XDECREF(v_o); Py_XDECREF(k_o); Py_DECREF(m);
                goto fail;
            }
            Py_INCREF(topic);    fslot_set(m, F_TOPIC, topic);
            Py_INCREF(part_obj); fslot_set(m, F_PART, part_obj);
            fslot_set(m, F_OFFSET, off_o);
            fslot_set(m, F_TS, ts_o);
            Py_INCREF(tstype);   fslot_set(m, F_TSTYPE, tstype);
            Py_INCREF(Py_None);  fslot_set(m, F_ERROR, Py_None);
            Py_INCREF(status);   fslot_set(m, F_STATUS, status);
            Py_INCREF(records);  fslot_set(m, F_BUF, records);
            fslot_set(m, F_V, v_o);
            fslot_set(m, F_K, k_o);
            Py_INCREF(Py_None);  fslot_set(m, F_H, Py_None);
            // every slot holds an acyclic leaf (str/int/bytes/None);
            // untrack so a deep fetched-message backlog costs the
            // cyclic GC nothing — gen2 passes over a 300k-message
            // queue measured 2.5x off the whole consume rate (the
            // tuple-of-atomics untrack rationale, CPython gcmodule)
            PyObject_GC_UnTrack(m);
            total += (vl > 0 ? vl : 0) + (kl > 0 ? kl : 0);
            if (PyList_Append(list, m) < 0) { Py_DECREF(m); goto fail; }
            Py_DECREF(m);
            if (f[7] > 0) {            // record carries headers: fix up
                if (!fixups) {
                    fixups = PyList_New(0);
                    if (!fixups) goto fail;
                }
                PyObject *t = Py_BuildValue(
                    "(nLL)", PyList_GET_SIZE(list) - 1,
                    (long long)f[6], (long long)f[7]);
                if (!t || PyList_Append(fixups, t) < 0) {
                    Py_XDECREF(t); goto fail;
                }
                Py_DECREF(t);
            }
        }
    }
    {
        PyObject *r = Py_BuildValue("(OLO)", list, (long long)total,
                                    fixups ? fixups : Py_None);
        Py_DECREF(list);
        Py_XDECREF(fixups);
        Py_XDECREF(ts_memo);
        Py_DECREF(part_obj);
        return r;
    }
bounds:
    PyErr_SetString(PyExc_ValueError,
                    "materialize_v2_lazy: record field out of bounds");
fail:
    Py_XDECREF(list);
    Py_XDECREF(fixups);
    Py_XDECREF(ts_memo);
    Py_XDECREF(part_obj);
    return NULL;
}

// materialize_arena_lazy(fm_type, base, klens, vlens, count, topic,
//                        partition, base_offset, ts_ms, tstype,
//                        status, error) -> list[FetchMessage]
// The DR-path analog of materialize_v2_lazy: delivery-report messages
// hold the arena batch's base buffer + packed offsets; key/value bytes
// are created only if the app's DR callback reads them (most read
// only error/offset/topic). Reference analog: DR event batching,
// rd_kafka_event_message_array (rdkafka_event.c:33).
static PyObject *mod_materialize_arena_lazy(PyObject *Py_UNUSED(self),
                                            PyObject *const *args,
                                            Py_ssize_t nargs) {
    if (nargs != 12) {
        PyErr_SetString(PyExc_TypeError, "materialize_arena_lazy: 12 args");
        return NULL;
    }
    PyTypeObject *type = (PyTypeObject *)args[0];
    if (!PyType_Check(args[0])) {
        PyErr_SetString(PyExc_TypeError,
                        "arg 0 must be the FetchMessage type");
        return NULL;
    }
    if (type != fm_type_cached && resolve_fm_slots(type) < 0)
        return NULL;
    PyObject *base_obj = args[1];
    Py_buffer base, kb, vb;
    if (PyObject_GetBuffer(base_obj, &base, PyBUF_SIMPLE) < 0) return NULL;
    if (PyObject_GetBuffer(args[2], &kb, PyBUF_SIMPLE) < 0) {
        PyBuffer_Release(&base); return NULL;
    }
    if (PyObject_GetBuffer(args[3], &vb, PyBUF_SIMPLE) < 0) {
        PyBuffer_Release(&base); PyBuffer_Release(&kb); return NULL;
    }
    int64_t count = PyLong_AsLongLong(args[4]);
    PyObject *topic = args[5];
    int64_t partition = PyLong_AsLongLong(args[6]);
    int64_t base_off = PyLong_AsLongLong(args[7]);
    PyObject *ts_obj = args[8];       // PyLong ms (shared)
    PyObject *tstype = args[9];
    PyObject *status = args[10];
    PyObject *error = args[11];       // KafkaError | None (shared)
    const int32_t *kl = (const int32_t *)kb.buf;
    const int32_t *vl = (const int32_t *)vb.buf;
    int64_t blen = base.len;
    PyObject *list = NULL, *part_obj = NULL;
    if (PyErr_Occurred()) goto done;
    if (count < 0 || (int64_t)kb.len < count * 4
        || (int64_t)vb.len < count * 4) {
        PyErr_SetString(PyExc_ValueError, "materialize_arena_lazy: bad args");
        goto done;
    }
    list = PyList_New(0);
    part_obj = PyLong_FromLongLong(partition);
    if (!list || !part_obj) goto fail;
    {
        int64_t off = 0;
        for (int64_t i = 0; i < count; i++) {
            int64_t k_len = kl[i], v_len = vl[i];
            int64_t need = (k_len > 0 ? k_len : 0) + (v_len > 0 ? v_len : 0);
            if (off + need > blen) {
                PyErr_SetString(PyExc_ValueError,
                                "materialize_arena_lazy: short base");
                goto fail;
            }
            PyObject *m = type->tp_alloc(type, 0);
            if (!m) goto fail;
            PyObject *k_o, *v_o;
            if (k_len >= 0) {
                k_o = PyLong_FromLongLong((off << 32) | k_len);
                off += k_len;
            } else { k_o = Py_None; Py_INCREF(k_o); }
            if (v_len >= 0) {
                v_o = PyLong_FromLongLong((off << 32) | v_len);
                off += v_len;
            } else { v_o = Py_None; Py_INCREF(v_o); }
            PyObject *off_o = PyLong_FromLongLong(
                base_off >= 0 ? base_off + i : -1);
            if (!k_o || !v_o || !off_o) {
                Py_XDECREF(k_o); Py_XDECREF(v_o); Py_XDECREF(off_o);
                Py_DECREF(m); goto fail;
            }
            Py_INCREF(topic);    fslot_set(m, F_TOPIC, topic);
            Py_INCREF(part_obj); fslot_set(m, F_PART, part_obj);
            fslot_set(m, F_OFFSET, off_o);
            Py_INCREF(ts_obj);   fslot_set(m, F_TS, ts_obj);
            Py_INCREF(tstype);   fslot_set(m, F_TSTYPE, tstype);
            Py_INCREF(error);    fslot_set(m, F_ERROR, error);
            Py_INCREF(status);   fslot_set(m, F_STATUS, status);
            Py_INCREF(base_obj); fslot_set(m, F_BUF, base_obj);
            fslot_set(m, F_V, v_o);
            fslot_set(m, F_K, k_o);
            Py_INCREF(Py_None);  fslot_set(m, F_H, Py_None);
            PyObject_GC_UnTrack(m);   // acyclic leaves only
            if (PyList_Append(list, m) < 0) { Py_DECREF(m); goto fail; }
            Py_DECREF(m);
        }
    }
    goto done;
fail:
    Py_CLEAR(list);
done:
    Py_XDECREF(part_obj);
    PyBuffer_Release(&base);
    PyBuffer_Release(&kb);
    PyBuffer_Release(&vb);
    return list;
}

// Delivery cursor: the consumer app thread's per-message walk
// (consumer._next_pending's inner loop) as one C call per message —
// staleness barrier, assignment check, offset advance
// (reference: rd_kafka_q_serve_rkmessages, rdkafka_queue.c:519).

static const char *const TP_SLOTS[] = {
    "version", "app_offset", "stored_offset", NULL};
enum { T_VERSION, T_APPOFF, T_STOREDOFF, T_NSLOTS };
static PyTypeObject *tp_type_cached = NULL;
static Py_ssize_t tp_slot_off[T_NSLOTS];

static int resolve_tp_slots(PyTypeObject *type) {
    for (int i = 0; TP_SLOTS[i]; i++) {
        PyObject *d = PyDict_GetItemString(type->tp_dict, TP_SLOTS[i]);
        if (!d || !PyObject_TypeCheck(d, &PyMemberDescr_Type)) {
            PyErr_Format(PyExc_TypeError,
                         "cursor: %s.%s is not a slot member",
                         type->tp_name, TP_SLOTS[i]);
            return -1;
        }
        tp_slot_off[i] = ((PyMemberDescrObject *)d)->d_member->offset;
    }
    tp_type_cached = type;
    return 0;
}

typedef struct {
    PyObject_HEAD
    PyObject *tp;        // Toppar (slotted)
    PyObject *msgs;      // list of messages
    PyObject *key;       // (topic, partition)
    long long ver;
    Py_ssize_t i, n;
} TkCursor;

static void cursor_dealloc(TkCursor *c) {
    Py_XDECREF(c->tp);
    Py_XDECREF(c->msgs);
    Py_XDECREF(c->key);
    Py_TYPE(c)->tp_free((PyObject *)c);
}

// cursor.next(assignment, auto_store) -> message | None (exhausted)
static PyObject *cursor_next_m(TkCursor *c, PyObject *const *args,
                               Py_ssize_t nargs) {
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "next(assignment, auto_store)");
        return NULL;
    }
    PyObject *assignment = args[0];
    int auto_store = PyObject_IsTrue(args[1]);
    if (auto_store < 0) return NULL;
    char *tpb = (char *)c->tp;
    while (c->i < c->n) {
        PyObject *m = PyList_GET_ITEM(c->msgs, c->i);
        c->i++;
        // staleness barrier: seek()/pause()/rebalance bump tp.version
        PyObject *vo = *(PyObject **)(tpb + tp_slot_off[T_VERSION]);
        long long ver = vo ? PyLong_AsLongLong(vo) : -1;
        if (ver != c->ver) continue;
        int in_asgn = PySequence_Contains(assignment, c->key);
        if (in_asgn < 0) return NULL;
        if (!in_asgn) continue;           // revoked: drop
        PyObject *off_obj;
        if (Py_TYPE(m) == fm_type_cached) {
            off_obj = *(PyObject **)((char *)m + fm_slot_off[F_OFFSET]);
            Py_XINCREF(off_obj);
        } else {
            off_obj = PyObject_GetAttrString(m, "offset");
        }
        if (!off_obj) return NULL;
        long long off1 = PyLong_AsLongLong(off_obj) + 1;
        Py_DECREF(off_obj);
        if (off1 == 0 && PyErr_Occurred()) return NULL;
        PyObject *off1_o = PyLong_FromLongLong(off1);
        if (!off1_o) return NULL;
        PyObject **slot = (PyObject **)(tpb + tp_slot_off[T_APPOFF]);
        Py_XDECREF(*slot);
        *slot = off1_o;                    // steals the new ref
        if (auto_store) {
            slot = (PyObject **)(tpb + tp_slot_off[T_STOREDOFF]);
            Py_INCREF(off1_o);
            Py_XDECREF(*slot);
            *slot = off1_o;
        }
        Py_INCREF(m);
        return m;
    }
    Py_RETURN_NONE;
}

static PyMethodDef cursor_methods[] = {
    {"next", (PyCFunction)(void (*)(void))cursor_next_m, METH_FASTCALL,
     "next(assignment, auto_store) -> message | None"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject CursorType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    "tk_torch_enqlane.Cursor",           /* tp_name */
    sizeof(TkCursor),              /* tp_basicsize */
};

// cursor_new(tp, msgs, ver, key) -> Cursor
static PyObject *mod_cursor_new(PyObject *Py_UNUSED(self),
                                PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 4 || !PyList_Check(args[1])) {
        PyErr_SetString(PyExc_TypeError, "cursor_new(tp, msgs, ver, key)");
        return NULL;
    }
    PyTypeObject *tpt = Py_TYPE(args[0]);
    if (tpt != tp_type_cached && resolve_tp_slots(tpt) < 0)
        return NULL;
    long long ver = PyLong_AsLongLong(args[2]);
    if (ver == -1 && PyErr_Occurred()) return NULL;
    TkCursor *c = PyObject_New(TkCursor, &CursorType);
    if (!c) return NULL;
    Py_INCREF(args[0]); c->tp = args[0];
    Py_INCREF(args[1]); c->msgs = args[1];
    Py_INCREF(args[3]); c->key = args[3];
    c->ver = ver;
    c->i = 0;
    c->n = PyList_GET_SIZE(args[1]);
    return (PyObject *)c;
}

static PyMethodDef module_methods[] = {
    {"build_batch", (PyCFunction)(void (*)(void))mod_build_batch,
     METH_FASTCALL,
     "build_batch(base, klens, vlens, count, now_ms, pid, epoch, "
     "base_seq, codec_id[, attr_flags[, tss, hbuf, hlens]]) -> wire "
     "RecordBatch bytes"},
    {"materialize_arena",
     (PyCFunction)(void (*)(void))mod_materialize_arena, METH_FASTCALL,
     "materialize_arena(...) -> list[Message] (arena layout)"},
    {"materialize_v2", (PyCFunction)(void (*)(void))mod_materialize_v2,
     METH_FASTCALL,
     "materialize_v2(...) -> (messages, total_bytes, header_fixups)"},
    {"materialize_v2_lazy",
     (PyCFunction)(void (*)(void))mod_materialize_v2_lazy, METH_FASTCALL,
     "materialize_v2_lazy(...) -> (messages, total_bytes, fixups); "
     "messages hold lazy (buffer, packed-offset) payload refs"},
    {"cursor_new", (PyCFunction)(void (*)(void))mod_cursor_new,
     METH_FASTCALL,
     "cursor_new(tp, msgs, ver, key) -> delivery Cursor"},
    {"materialize_arena_lazy",
     (PyCFunction)(void (*)(void))mod_materialize_arena_lazy,
     METH_FASTCALL,
     "materialize_arena_lazy(...) -> list[FetchMessage] (DR path; "
     "key/value created lazily from the arena base buffer)"},
    {"crc32c_many", (PyCFunction)(void (*)(void))mod_crc32c_many,
     METH_FASTCALL, "crc32c_many(buffers) -> list[int] (no join copy)"},
    {"murmur2_partition",
     (PyCFunction)(void (*)(void))mod_murmur2_partition, METH_FASTCALL,
     "murmur2_partition(key, cnt) -> int (Java-compatible parity hook)"},
    {"decompress_many", (PyCFunction)(void (*)(void))mod_decompress_many,
     METH_FASTCALL,
     "decompress_many(codec_id, buffers, hints) -> list[bytes|None]"},
    {NULL, NULL, 0, NULL}};

static PyMemberDef lane_members[] = {
    {"map", T_OBJECT_EX, offsetof(Lane, map), READONLY,
     "{(topic, partition) -> (Arena, toppar)}"},
    {"enabled", T_INT, offsetof(Lane, enabled), 0,
     "conf-level fast-lane eligibility"},
    {"fatal", T_INT, offsetof(Lane, fatal), 0,
     "fatal error pending: produce raises"},
    {NULL}};

static PyObject *lane_get_msg_cnt(Lane *l, void *c) {
    return PyLong_FromLongLong(l->msg_cnt);
}
static PyObject *lane_get_msg_bytes(Lane *l, void *c) {
    return PyLong_FromLongLong(l->msg_bytes);
}
static PyGetSetDef lane_getset[] = {
    {"msg_cnt", (getter)lane_get_msg_cnt, NULL, "queued+inflight msgs"},
    {"msg_bytes", (getter)lane_get_msg_bytes, NULL, "queued bytes"},
    {NULL}};

static PyMethodDef lane_methods[] = {
    {"produce", (PyCFunction)(void (*)(void))lane_produce,
     METH_FASTCALL | METH_KEYWORDS, "the public produce() entry point"},
    {"configure", (PyCFunction)(void (*)(void))lane_configure,
     METH_FASTCALL, "configure(fallback, wake, max_msgs, max_bytes)"},
    {"acct", (PyCFunction)(void (*)(void))lane_acct, METH_FASTCALL,
     "acct(dn, dbytes) -> (msg_cnt, msg_bytes)"},
    {"full", (PyCFunction)(void (*)(void))lane_full, METH_FASTCALL,
     "full(sz=0) -> bool"},
    {"map_set", (PyCFunction)(void (*)(void))lane_map_set, METH_FASTCALL,
     "map_set(topic, partition, entry): install a fast-lane entry"},
    {"map_del", (PyCFunction)(void (*)(void))lane_map_del, METH_FASTCALL,
     "map_del(topic, partition) -> removed entry | None"},
    {"produce_batch", (PyCFunction)(void (*)(void))lane_produce_batch,
     METH_FASTCALL,
     "produce_batch(topic, msgs, start, default_part) -> (next, appended)"},
    {"produce_raw", (PyCFunction)(void (*)(void))lane_produce_raw,
     METH_FASTCALL,
     "produce_raw(topic, part, base_addr, klens_addr, vlens_addr, n)"},
    {"part_set", (PyCFunction)(void (*)(void))lane_part_set,
     METH_FASTCALL,
     "part_set(topic, partition_cnt, mode): native auto-partition"},
    {"part_del", (PyCFunction)lane_part_del, METH_O,
     "part_del(topic): drop the auto-partition entry"},
    {"counters", (PyCFunction)lane_counters, METH_NOARGS,
     "counters() -> {'engaged': n, 'fallback': {reason: n}}"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject LaneType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    "tk_torch_enqlane.Lane",             /* tp_name */
    sizeof(Lane),                  /* tp_basicsize */
};

static PyMethodDef arena_methods[] = {
    {"append", (PyCFunction)(void (*)(void))arena_append, METH_FASTCALL,
     "append(key, value[, ts_ms, hblob]) -> remaining record count"},
    {"take", (PyCFunction)(void (*)(void))arena_take, METH_FASTCALL,
     "take(max_count, max_bytes) -> run tuple or None"},
    {"expire", (PyCFunction)arena_expire, METH_O,
     "expire(cutoff_us) -> (count, nbytes) dropped"},
    {"expire_records", (PyCFunction)arena_expire_records, METH_O,
     "expire_records(cutoff_us) -> [(key, value, ts, hblob), ...]"},
    {"clear", (PyCFunction)arena_clear, METH_NOARGS,
     "clear() -> (count, nbytes) dropped"},
    {"drain_records", (PyCFunction)arena_drain_records, METH_NOARGS,
     "drain_records() -> [(key, value, ts, hblob), ...] and reset"},
    {"first_enq_us", (PyCFunction)arena_first_enq_us, METH_NOARGS,
     "first_enq_us() -> int64 (-1 when empty)"},
    {"nbytes", (PyCFunction)arena_nbytes, METH_NOARGS,
     "nbytes() -> payload bytes queued"},
    {NULL, NULL, 0, NULL}};

static PySequenceMethods arena_as_sequence = {
    arena_length,   /* sq_length */
};

static PyTypeObject ArenaType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    "tk_torch_enqlane.Arena",            /* tp_name */
    sizeof(Arena),                 /* tp_basicsize */
};

static struct PyModuleDef enqlane_module = {
    PyModuleDef_HEAD_INIT, "tk_torch_enqlane",
    "Native per-toppar produce() enqueue arena", -1, module_methods};

PyMODINIT_FUNC PyInit_tk_torch_enqlane(void) {
#ifdef __GLIBC__
    // ~1MB decompressed-batch buffers sit above glibc's default mmap
    // threshold: every fetch batch costs mmap + page-fault + kernel
    // zeroing + munmap TLB churn (measured 186 MB/s effective decode
    // cold vs 2 GB/s once glibc recycles; behind a lazy-paging VM a
    // first touch measured ~21 us/page). Raise the thresholds so
    // batch-sized allocations live on the recycling heap; glibc's own
    // dynamic tuning does the same — but only after the first drain
    // has already paid the 10x. Process-wide policy, so the embedding
    // app can veto it: TKAFKA_MALLOC_TUNE=0.
    const char *tune = getenv("TKAFKA_MALLOC_TUNE");
    if (!tune || strcmp(tune, "0") != 0) {
        mallopt(M_MMAP_THRESHOLD, 64 << 20);
        mallopt(M_TRIM_THRESHOLD, 512 << 20);
    }
#endif
    CursorType.tp_dealloc = (destructor)cursor_dealloc;
    CursorType.tp_flags = Py_TPFLAGS_DEFAULT;
    CursorType.tp_methods = cursor_methods;
    if (PyType_Ready(&CursorType) < 0) return NULL;
    ArenaType.tp_dealloc = (destructor)arena_dealloc;
    ArenaType.tp_flags = Py_TPFLAGS_DEFAULT;
    ArenaType.tp_methods = arena_methods;
    ArenaType.tp_new = arena_new;
    ArenaType.tp_as_sequence = &arena_as_sequence;
    if (PyType_Ready(&ArenaType) < 0) return NULL;
    for (int j = 0; lane_kwnames[j]; j++) {
        lane_kw_interned[j] = PyUnicode_InternFromString(lane_kwnames[j]);
        if (!lane_kw_interned[j]) return NULL;
    }
    k_error_interned = PyUnicode_InternFromString("error");
    if (!k_error_interned) return NULL;
    LaneType.tp_dealloc = (destructor)lane_dealloc;
    LaneType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC;
    LaneType.tp_traverse = (traverseproc)lane_traverse;
    LaneType.tp_clear = (inquiry)lane_clear;
    LaneType.tp_methods = lane_methods;
    LaneType.tp_members = lane_members;
    LaneType.tp_getset = lane_getset;
    LaneType.tp_new = lane_new;
    if (PyType_Ready(&LaneType) < 0) return NULL;
    PyObject *m = PyModule_Create(&enqlane_module);
    if (!m) return NULL;
    Py_INCREF(&ArenaType);
    if (PyModule_AddObject(m, "Arena", (PyObject *)&ArenaType) < 0) {
        Py_DECREF(&ArenaType);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&LaneType);
    if (PyModule_AddObject(m, "Lane", (PyObject *)&LaneType) < 0) {
        Py_DECREF(&LaneType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
