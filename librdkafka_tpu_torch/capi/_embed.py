"""The bodies of libtkafka.so's ``tk_*`` functions (tkafka.c calls them).

One function per C entry point, same name and argument order; every
pointer arrives as an integer address (0 = NULL) and is read or written
through ``ctypes``.  Handles are small integers into ``_handles``.  The
C side fills consumed messages itself: ``tk_consumer_poll`` returns a
tuple for it to copy, and ``tk_msg_free`` is C alone.
"""
from __future__ import annotations

import ctypes
import json
import threading

import numpy as np

import librdkafka_tpu_torch
from librdkafka_tpu_torch import (AdminClient, ConfigResource, Consumer,
                                  NewPartitions, NewTopic, Producer)
from librdkafka_tpu_torch.client.consumer import TopicPartition
from librdkafka_tpu_torch.client.errors import Err
from librdkafka_tpu_torch.client.kafka import Kafka

_handles: dict = {}
_next = [1]
_lock = threading.Lock()

_DR_CB = ctypes.CFUNCTYPE(None, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int32, ctypes.c_int64)
_LOG_CB = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_char_p,
                           ctypes.c_char_p)
_ERR_CB = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_char_p)
_STATS_CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p)

_dr_cbs: dict = {}     # handle -> _DR_CB
_obs_cbs: dict = {}    # (handle, kind) -> C callback


def _str(addr: int):
    return ctypes.string_at(addr).decode() if addr else None


def _bytes(addr: int, n: int):
    return ctypes.string_at(addr, n) if addr else None


def _i32s(addr: int, n: int) -> np.ndarray:
    if not addr and n > 0:
        raise ValueError("NULL int32 array")
    return np.frombuffer(ctypes.string_at(addr, 4 * n), dtype=np.int32)


def _write_cstr(addr: int, size: int, s) -> int:
    b = s.encode() if isinstance(s, str) else bytes(s)
    if not addr or size <= 0 or len(b) + 1 > size:
        return -1
    ctypes.memmove(addr, b + b"\0", len(b) + 1)
    return len(b)


def _register(obj) -> int:
    with _lock:
        h = _next[0]
        _next[0] += 1
        _handles[h] = obj
    return h


def _fail(errstr: int, errstr_size: int, exc: BaseException) -> int:
    if errstr and errstr_size > 0:
        msg = str(exc).encode()[: errstr_size - 1]
        ctypes.memmove(errstr, msg + b"\0", len(msg) + 1)
    return 0


def tk_producer_new(conf_json, errstr, errstr_size):
    try:
        return _register(Producer(json.loads(_str(conf_json))))
    except Exception as e:
        return _fail(errstr, errstr_size, e)


def tk_consumer_new(conf_json, errstr, errstr_size):
    try:
        return _register(Consumer(json.loads(_str(conf_json))))
    except Exception as e:
        return _fail(errstr, errstr_size, e)


def tk_produce(h, topic, partition, key, key_len, payload, length):
    p = _handles.get(h)
    if p is None:
        return -1
    try:
        p.produce(_str(topic), value=_bytes(payload, length),
                  key=_bytes(key, key_len), partition=partition)
        return 0
    except Exception:
        return -1


def tk_flush(h, timeout_ms):
    p = _handles.get(h)
    if p is None:
        return -1
    try:
        return int(p.flush(timeout_ms / 1000.0))
    except Exception:
        return -1


def tk_set_dr_cb(h, cb):
    if _handles.get(h) is None:
        return -1
    _dr_cbs[h] = _DR_CB(cb) if cb else None
    return 0


def _dr_trampoline(h, opaque):
    cb = _dr_cbs.get(h)
    if cb is None:
        return None

    def on_delivery(err, m, _cb=cb, _op=opaque):
        _cb(_op, int(err.code) if err is not None else 0,
            m.partition, m.offset if m.offset is not None else -1)
    return on_delivery


def tk_produce2(h, topic, partition, key, key_len, payload, length,
                timestamp_ms, hdr_names, hdr_vals, hdr_val_lens, hdr_cnt,
                opaque):
    # produce with headers / timestamp / per-message opaque + DR
    # callback (reference rd_kafka_producev with RD_KAFKA_V_HEADER /
    # V_OPAQUE / V_TIMESTAMP).
    p = _handles.get(h)
    if p is None:
        return -1
    try:
        headers = []
        if hdr_cnt > 0:
            pp = ctypes.POINTER(ctypes.c_void_p)
            names = ctypes.cast(hdr_names, pp)
            vals = ctypes.cast(hdr_vals, pp)
            lens = ctypes.cast(hdr_val_lens, ctypes.POINTER(ctypes.c_size_t))
            for i in range(hdr_cnt):
                headers.append((_str(names[i]),
                                _bytes(vals[i] or 0, lens[i])))
        p.produce(_str(topic), value=_bytes(payload, length),
                  key=_bytes(key, key_len), partition=partition,
                  timestamp=int(timestamp_ms) if timestamp_ms > 0 else 0,
                  headers=headers, on_delivery=_dr_trampoline(h, opaque))
        return 0
    except Exception:
        return -1


def tk_produce_batch(h, topic, partition, base, klens, vlens, count):
    # Arena-layout batch produce: base = concatenated key||value bytes,
    # klens/vlens int32 arrays (-1 = null) -- the enqueue lane's own
    # memory layout, so a run appends in ONE native pass that reads the
    # caller's memory in place (reference rd_kafka_produce_batch,
    # rdkafka_msg.c:478). Returns records enqueued.
    p = _handles.get(h)
    if p is None:
        return -1
    done = 0
    try:
        t = _str(topic)
        raw = getattr(p._rk._lane, "produce_raw", None)
        ka, va = _i32s(klens, count), _i32s(vlens, count)
        ends = np.concatenate(([0], np.cumsum(
            np.maximum(ka, 0).astype(np.int64)
            + np.maximum(va, 0).astype(np.int64))))
        while done < count:
            if raw is not None:
                n = raw(t, int(partition), base + int(ends[done]),
                        klens + 4 * done, vlens + 4 * done, count - done)
                if n > 0:
                    done += n
                    continue
            # first sight (toppar not registered) or ineligible: ONE
            # record through the Python path, then retry the lane
            off, kl, vl = int(ends[done]), int(ka[done]), int(va[done])
            k = ctypes.string_at(base + off, kl) if kl >= 0 else None
            off += max(kl, 0)
            v = ctypes.string_at(base + off, vl) if vl >= 0 else None
            p.produce(t, value=v, key=k, partition=int(partition))
            done += 1
        return done
    except Exception:
        return done    # records enqueued before the failure


def tk_poll(h, timeout_ms):
    # Serve the handle's reply queue (DR trampolines fire here or in
    # tk_flush; reference rd_kafka_poll). On a consumer handle this
    # serves the NON-message ops (errors/stats) like rd_kafka_poll on a
    # consumer -- messages come via tk_consumer_poll.
    obj = _handles.get(h)
    if obj is None:
        return -1
    try:
        if isinstance(obj, Consumer):
            return int(obj.poll_kafka(timeout_ms / 1000.0))
        return int(obj.poll(timeout_ms / 1000.0))
    except Exception:
        return -1


def tk_outq_len(h):
    obj = _handles.get(h)
    if obj is None:
        return -1
    try:
        return len(obj)
    except Exception:
        return -1


def tk_assign(h, topic, partitions, offsets, nparts):
    # Simple-consumer assignment with optional start offsets
    # (reference rd_kafka_assign; offsets NULL or -1001 = stored/auto).
    c = _handles.get(h)
    if c is None:
        return -1
    try:
        t = _str(topic)
        parts = _i32s(partitions, nparts)
        offs = (np.frombuffer(ctypes.string_at(offsets, 8 * nparts),
                              dtype=np.int64) if offsets
                else np.full(nparts, -1001, dtype=np.int64))
        c.assign([TopicPartition(t, int(p), int(o))
                  for p, o in zip(parts, offs)])
        return 0
    except Exception:
        return -1


def tk_unassign(h):
    c = _handles.get(h)
    if c is None:
        return -1
    try:
        c.unassign()
        return 0
    except Exception:
        return -1


def tk_commit(h, async_flag):
    c = _handles.get(h)
    if c is None:
        return -1
    try:
        c.commit(asynchronous=bool(async_flag))
        return 0
    except Exception:
        return -2


def tk_committed(h, topic, partition, timeout_ms):
    # Committed offset for one partition; -1001 = none, < -2000000 =
    # error (code folded in).
    c = _handles.get(h)
    if c is None:
        return -2000001
    try:
        res = c.committed([TopicPartition(_str(topic), int(partition))],
                          timeout=timeout_ms / 1000.0)
        return int(res[0].offset)
    except Exception:
        return -2000002


def tk_seek(h, topic, partition, offset):
    c = _handles.get(h)
    if c is None:
        return -1
    try:
        c.seek(TopicPartition(_str(topic), int(partition), int(offset)))
        return 0
    except Exception:
        return -1


def _admin_for(h):
    # Lazy AdminClient against the handle's cluster (its in-process
    # mock, or its bootstrap.servers).
    obj = _handles.get(h)
    if obj is None:
        return None
    a = getattr(obj, "_tk_admin", None)
    if a is None:
        cluster = getattr(obj._rk, "mock_cluster", None)
        bs = (cluster.bootstrap_servers() if cluster is not None
              else obj._rk.conf.get("bootstrap.servers"))
        a = AdminClient({"bootstrap.servers": bs})
        obj._tk_admin = a
    return a


def _wait_all(futs, timeout_ms):
    for f in futs.values():
        f.result(timeout_ms / 1000.0)


def tk_create_topic(h, topic, num_partitions, timeout_ms):
    try:
        a = _admin_for(h)
        if a is None:
            return -1
        _wait_all(a.create_topics(
            [NewTopic(_str(topic), num_partitions=num_partitions)],
            operation_timeout=timeout_ms / 1000.0), timeout_ms)
        return 0
    except Exception:
        return -1


def tk_delete_topic(h, topic, timeout_ms):
    try:
        a = _admin_for(h)
        if a is None:
            return -1
        _wait_all(a.delete_topics([_str(topic)],
                                  operation_timeout=timeout_ms / 1000.0),
                  timeout_ms)
        return 0
    except Exception:
        return -1


def tk_subscribe(h, topics_csv):
    c = _handles.get(h)
    if c is None:
        return -1
    try:
        c.subscribe([t.strip() for t in _str(topics_csv).split(",")
                     if t.strip()])
        return 0
    except Exception:
        return -1


def tk_consumer_poll(h, timeout_ms):
    # 1-tuple (err,) for an error event, the message's fields for a
    # message; 0 = nothing, -1 = no such handle, -2 = the poll raised.
    c = _handles.get(h)
    if c is None:
        return -1
    try:
        m = c.poll(timeout_ms / 1000.0)
    except Exception:
        return -2
    if m is None:
        return 0
    if m.error is not None:
        return (int(m.error.code),)
    return ((m.topic or "").encode(), m.partition, m.offset,
            m.timestamp if m.timestamp else -1, _opt_bytes(m.key),
            _opt_bytes(m.value),
            [(k.encode(), _opt_bytes(v)) for k, v in (m.headers or ())])


def _opt_bytes(b):
    # bytes() of a bytes object is the object itself: no copy
    return None if b is None else bytes(b)


def tk_mock_bootstrap(h, buf, size):
    # bootstrap.servers of the handle's in-process mock cluster
    # (test.mock.num.brokers), for wiring a second client to it
    obj = _handles.get(h)
    if obj is None:
        return -1
    cluster = getattr(obj._rk, "mock_cluster", None)
    if cluster is None:
        return -1
    return _write_cstr(buf, size, cluster.bootstrap_servers())


def tk_destroy(h):
    obj = _handles.pop(h, None)
    _dr_cbs.pop(h, None)   # handle ids are never reused: drop the DR
                           # trampoline or registrations leak forever
    for kind in ("log", "err", "stats"):
        _obs_cbs.pop((h, kind), None)
    if obj is not None:
        try:
            obj.close()
        except Exception:
            pass
    return 0


def tk_version(buf, size):
    # reference: rd_kafka_version_str()
    return _write_cstr(buf, size, librdkafka_tpu_torch.__version__)


def tk_err2str(err, buf, size):
    # reference: rd_kafka_err2str / rd_kafka_err2name
    try:
        name = Err(err).name
    except ValueError:
        name = f"UNKNOWN_ERR_{err}"
    return _write_cstr(buf, size, name)


def tk_query_watermark_offsets(h, topic, partition, lo, hi, timeout_ms):
    # reference: rd_kafka_query_watermark_offsets (consumer handles)
    c = _handles.get(h)
    if not isinstance(c, Consumer) or not (lo and hi):
        return -1
    try:
        low, high = c.get_watermark_offsets(
            TopicPartition(_str(topic), partition),
            timeout=timeout_ms / 1000.0)
        ctypes.c_int64.from_address(lo).value = int(low)
        ctypes.c_int64.from_address(hi).value = int(high)
        return 0
    except Exception:
        return -1


def tk_offsets_for_times(h, topic, partition, ts_ms, timeout_ms):
    # reference: rd_kafka_offsets_for_times; returns the offset, -1 =
    # timestamp past log end (reference semantics), -2 = error
    c = _handles.get(h)
    if not isinstance(c, Consumer):
        return -2
    try:
        out = c.offsets_for_times(
            [TopicPartition(_str(topic), partition, ts_ms)],
            timeout=timeout_ms / 1000.0)
        return int(out[0].offset)
    except Exception:
        return -2


def tk_position(h, topic, partition):
    # reference: rd_kafka_position; next offset to consume, -1001 when
    # the partition is not assigned/positioned
    c = _handles.get(h)
    if not isinstance(c, Consumer):
        return -1001
    try:
        return int(c.position([TopicPartition(_str(topic),
                                              partition)])[0].offset)
    except Exception:
        return -1001


def tk_pause(h, topic, partition):
    c = _handles.get(h)
    if not isinstance(c, Consumer):
        return -1
    try:
        c.pause([TopicPartition(_str(topic), partition)])
        return 0
    except Exception:
        return -1


def tk_resume(h, topic, partition):
    c = _handles.get(h)
    if not isinstance(c, Consumer):
        return -1
    try:
        c.resume([TopicPartition(_str(topic), partition)])
        return 0
    except Exception:
        return -1


def tk_purge(h, in_queue, in_flight):
    # reference: rd_kafka_purge (producer handles)
    p = _handles.get(h)
    if not isinstance(p, Producer):
        return -1
    try:
        p.purge(in_queue=bool(in_queue), in_flight=bool(in_flight))
        return 0
    except Exception:
        return -1


def tk_metadata_json(h, buf, size, timeout_ms):
    # reference: rd_kafka_metadata, flattened to JSON for C callers:
    # {"brokers": {id: "host:port"}, "controller_id": n,
    #  "topics": {name: {partition: leader}}}
    obj = _handles.get(h)
    if obj is None:
        return -1
    rk = obj._rk
    try:
        rk.metadata_refresh("tk_metadata")
        # producer/consumer handles refresh SPARSELY (their known
        # topics), so waiting for a FULL enumeration would never
        # resolve — a warm cache (>=1 broker) is the reference's
        # rd_kafka_metadata(all_topics=0) behavior
        if not rk.metadata_wait(lambda: rk.metadata["brokers"],
                                timeout_ms / 1000.0):
            return -1
        with rk._metadata_lock:
            md = rk.metadata
            snap = {"brokers": {str(i): f"{b[0]}:{b[1]}"
                                if isinstance(b, (tuple, list)) else str(b)
                                for i, b in md["brokers"].items()},
                    "controller_id": md.get("controller_id", -1),
                    "topics": {t: {str(p): ldr for p, ldr in ps.items()}
                               for t, ps in md["topics"].items()}}
        return _write_cstr(buf, size, json.dumps(snap))
    except Exception:
        return -1


def tk_conf_dump_json(h, buf, size):
    # reference: rd_kafka_conf_dump — the handle's effective conf
    obj = _handles.get(h)
    if obj is None:
        return -1
    try:
        safe = {k: (v if isinstance(v, (str, int, float, bool,
                                        type(None))) else repr(v))
                for k, v in obj._rk.conf.dump().items()}
        return _write_cstr(buf, size, json.dumps(safe))
    except Exception:
        return -1


# ---- observability callbacks, per-property conf, admin breadth ----

def tk_set_log_cb(h, cb):
    obj = _handles.get(h)
    if obj is None:
        return -1
    _obs_cbs[(h, "log")] = _LOG_CB(cb) if cb else None

    def log_cb(level, fac, msg, _h=h):
        c = _obs_cbs.get((_h, "log"))
        if c is None:
            return
        lv = (level if isinstance(level, int)
              else Kafka._LOG_LEVELS.get(level, 6))
        c(lv, str(fac).encode(), str(msg).encode())
    obj._rk.conf.set("log_cb", log_cb)
    obj._rk.log_cb = log_cb        # live handles read the cached ref
    return 0


def tk_set_error_cb(h, cb):
    obj = _handles.get(h)
    if obj is None:
        return -1
    _obs_cbs[(h, "err")] = _ERR_CB(cb) if cb else None

    def error_cb(err, _h=h):
        c = _obs_cbs.get((_h, "err"))
        if c is None:
            return
        c(int(err.code), str(err).encode())
    obj._rk.conf.set("error_cb", error_cb)
    return 0


def tk_set_stats_cb(h, cb):
    # fires from tk_poll/tk_flush once statistics.interval.ms elapses
    # (set it in conf_json at creation, or via tk_conf_set)
    obj = _handles.get(h)
    if obj is None:
        return -1
    _obs_cbs[(h, "stats")] = _STATS_CB(cb) if cb else None

    def stats_cb(blob, _h=h):
        c = _obs_cbs.get((_h, "stats"))
        if c is None:
            return
        c(blob.encode())
    obj._rk.conf.set("stats_cb", stats_cb)
    return 0


def tk_conf_set(h, name, value):
    # per-property set on the live handle (reference rd_kafka_conf_set;
    # post-creation mutation revalidates cached eligibility decisions
    # through the conf listeners)
    obj = _handles.get(h)
    if obj is None:
        return -1
    try:
        obj._rk.conf.set(_str(name), _str(value))
        return 0
    except Exception:
        return -2


def tk_conf_get(h, name, buf, size):
    obj = _handles.get(h)
    if obj is None:
        return -1
    try:
        v = obj._rk.conf.get(_str(name))
        if isinstance(v, bool):
            v = "true" if v else "false"
        return _write_cstr(buf, size, str(v))
    except Exception:
        return -2


def tk_describe_configs(h, restype, name, buf, size, timeout_ms):
    try:
        a = _admin_for(h)
        if a is None:
            return -1
        r = ConfigResource(int(restype), _str(name))
        futs = a.describe_configs([r], operation_timeout=timeout_ms / 1000.0)
        entries = futs[r].result(timeout_ms / 1000.0)
        return _write_cstr(buf, size, json.dumps(
            {n: e.value for n, e in entries.items()}))
    except Exception:
        return -1


def tk_alter_configs(h, restype, name, conf_json, timeout_ms):
    try:
        a = _admin_for(h)
        if a is None:
            return -1
        r = ConfigResource(int(restype), _str(name))
        for k, v in json.loads(_str(conf_json)).items():
            r.set_config(k, v)
        futs = a.alter_configs([r], operation_timeout=timeout_ms / 1000.0)
        futs[r].result(timeout_ms / 1000.0)
        return 0
    except Exception:
        return -1


def tk_create_partitions(h, topic, new_total, timeout_ms):
    try:
        a = _admin_for(h)
        if a is None:
            return -1
        _wait_all(a.create_partitions(
            [NewPartitions(_str(topic), int(new_total))],
            operation_timeout=timeout_ms / 1000.0), timeout_ms)
        return 0
    except Exception:
        return -1


def tk_list_groups(h, buf, size, timeout_ms):
    try:
        a = _admin_for(h)
        if a is None:
            return -1
        fut = a.list_groups(operation_timeout=timeout_ms / 1000.0)
        return _write_cstr(buf, size,
                           json.dumps(fut.result(timeout_ms / 1000.0)))
    except Exception:
        return -1


def _jsonable(v):
    if isinstance(v, bytes):
        return v.decode("latin-1")
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def tk_describe_group(h, group, buf, size, timeout_ms):
    try:
        a = _admin_for(h)
        if a is None:
            return -1
        g = _str(group)
        futs = a.describe_groups([g], operation_timeout=timeout_ms / 1000.0)
        info = futs[g].result(timeout_ms / 1000.0)
        return _write_cstr(buf, size, json.dumps(_jsonable(info)))
    except Exception:
        return -1


def tk_delete_group(h, group, timeout_ms):
    try:
        a = _admin_for(h)
        if a is None:
            return -1
        g = _str(group)
        futs = a.delete_groups([g], operation_timeout=timeout_ms / 1000.0)
        futs[g].result(timeout_ms / 1000.0)
        return 0
    except Exception:
        return -1
