/* tkafka.hpp — header-only C++ RAII wrapper over libtkafka.so, the C ABI
 * of librdkafka_tpu_torch (the PyTorch / CUDA client; its tkafka.h is
 * written by build_capi.py into build/librdkafka_tpu_torch/capi/).
 *
 * The rebuild's src-cpp/ analog (reference: src-cpp/rdkafkacpp.h — a
 * thin delegating wrapper over the C ABI with callbacks trampolined
 * through C function pointers). Class surface mirrors the RdKafka::
 * namespace shape in miniature: Conf, Producer, Consumer, Message,
 * DeliveryReportCb, EventCb.
 *
 * Ownership rules match the reference wrapper:
 *   - Producer/Consumer: heap-allocated via create(), delete closes.
 *   - Message: returned by Consumer::consume(); caller deletes (frees
 *     the underlying tk_msg_t).
 *   - Conf: plain value type; set() before create().
 */
#pragma once

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <utility>
#include <vector>

#include "tkafka.h"

namespace tkafka {

enum ErrorCode { ERR_NO_ERROR = 0, ERR_UNKNOWN = -1 };

inline std::string version() {
    char buf[64];
    return tk_version(buf, sizeof buf) > 0 ? std::string(buf)
                                           : std::string();
}

inline std::string err2str(int err) {
    char buf[128];
    return tk_err2str(err, buf, sizeof buf) > 0 ? std::string(buf)
                                                : std::string("UNKNOWN");
}

/* ------------------------------------------------------------- Conf -- */
class Conf {
  public:
    void set(const std::string &name, const std::string &value) {
        kv_[name] = value;
    }
    std::string get(const std::string &name) const {
        auto it = kv_.find(name);
        return it == kv_.end() ? std::string() : it->second;
    }
    /* JSON object for tk_producer_new/tk_consumer_new. Every value is
     * emitted as a quoted string — the conf layer coerces strings to
     * the declared property type exactly like the reference's all-
     * string rd_kafka_conf_set, so "10"/"true"/"007" all arrive with
     * their intended semantics (an unquoted-literal heuristic would
     * retype string-valued properties that merely look numeric). */
    std::string dump_json() const {
        std::string out = "{";
        bool first = true;
        for (const auto &kv : kv_) {
            if (!first) out += ", ";
            first = false;
            out += '"';
            out += escape(kv.first);
            out += "\": \"";
            out += escape(kv.second);
            out += '"';
        }
        return out + "}";
    }

  private:
    static std::string escape(const std::string &s) {
        std::string o;
        char u[8];
        for (unsigned char c : s) {
            if (c == '"' || c == '\\') {
                o += '\\';
                o += static_cast<char>(c);
            } else if (c < 0x20) {
                /* control chars (PEM blobs carry newlines) must be
                 * \u-escaped or json.loads rejects the conf */
                std::snprintf(u, sizeof u, "\\u%04x", c);
                o += u;
            } else {
                o += static_cast<char>(c);
            }
        }
        return o;
    }
    std::map<std::string, std::string> kv_;
};

/* ---------------------------------------------------------- Message -- */
class Message {
  public:
    Message() { std::memset(&m_, 0, sizeof m_); }
    explicit Message(const tk_msg_t &m) : own_(true), m_(m) {}
    ~Message() {
        if (own_) tk_msg_free(&m_);
    }
    Message(const Message &) = delete;
    Message &operator=(const Message &) = delete;

    int err() const { return m_.err; }
    std::string errstr() const { return err2str(m_.err); }
    std::string topic_name() const {
        return m_.topic ? std::string(m_.topic) : std::string();
    }
    int32_t partition() const { return m_.partition; }
    int64_t offset() const { return m_.offset; }
    int64_t timestamp() const { return m_.timestamp; }
    const void *payload() const { return m_.payload; }
    size_t len() const { return m_.len; }
    const void *key_pointer() const { return m_.key; }
    size_t key_len() const { return m_.key_len; }
    std::string key() const {
        return m_.key ? std::string(m_.key, m_.key_len) : std::string();
    }
    std::string value() const {
        return m_.payload ? std::string(m_.payload, m_.len)
                          : std::string();
    }
    /* Raw-byte header list; a null header value becomes an empty
     * string here — use headers_raw() when the null/empty distinction
     * matters. */
    std::vector<std::pair<std::string, std::string>> headers() const {
        std::vector<std::pair<std::string, std::string>> out;
        for (int i = 0; i < m_.hdr_cnt; i++) {
            out.emplace_back(
                std::string(m_.hdr_names[i]),
                m_.hdr_vals[i]
                    ? std::string(m_.hdr_vals[i], m_.hdr_val_lens[i])
                    : std::string());
        }
        return out;
    }
    /* Headers with the null-value signal preserved (value ignored,
     * null_value=true for headers produced with a NULL value). */
    std::vector<struct Header> headers_raw() const;

  private:
    bool own_ = false;
    tk_msg_t m_;
};

/* ------------------------------------------------- callback classes -- */
class DeliveryReportCb {
  public:
    virtual ~DeliveryReportCb() = default;
    virtual void dr_cb(long long opaque, int err, int32_t partition,
                       int64_t offset) = 0;
};

class EventCb {     /* log + error + stats events (reference EventCb) */
  public:
    virtual ~EventCb() = default;
    virtual void log_cb(int level, const char *fac, const char *msg) {}
    virtual void error_cb(int err, const char *reason) {}
    virtual void stats_cb(const char *json) {}
};

namespace detail {
/* C callbacks can't capture state and the tk_* callback signatures
 * carry no handle — but DR/log/stats callbacks only ever fire inside
 * THIS thread's tk_poll/tk_flush call, so a thread-local "current
 * handle owner" resolves the dispatch (the reference trampolines via
 * rd_kafka_conf_set_opaque instead; the C layer here keeps opaque for
 * per-message use). */
struct Current {
    DeliveryReportCb *dr = nullptr;
    EventCb *ev = nullptr;
};
inline Current &current() {
    thread_local Current c;
    return c;
}
inline void dr_thunk(long long opaque, int err, int32_t partition,
                     int64_t offset) {
    if (current().dr) current().dr->dr_cb(opaque, err, partition, offset);
}
inline void log_thunk(int level, const char *fac, const char *msg) {
    if (current().ev) current().ev->log_cb(level, fac, msg);
}
inline void err_thunk(int err, const char *reason) {
    if (current().ev) current().ev->error_cb(err, reason);
}
inline void stats_thunk(const char *json) {
    if (current().ev) current().ev->stats_cb(json);
}
/* RAII scope: installs this handle's callbacks as the thread's
 * current dispatch targets for the duration of a poll/flush. */
struct Scope {
    Scope(DeliveryReportCb *dr, EventCb *ev) : prev_(current()) {
        current().dr = dr;
        current().ev = ev;
    }
    ~Scope() { current() = prev_; }
    Current prev_;
};
}  // namespace detail

/* ----------------------------------------------------------- Handle -- */
class Handle {
  public:
    virtual ~Handle() {
        if (h_) tk_destroy(h_);
    }
    Handle(const Handle &) = delete;
    Handle &operator=(const Handle &) = delete;

    int poll(int timeout_ms) {
        detail::Scope s(dr_, ev_);
        return tk_poll(h_, timeout_ms);
    }
    long long outq_len() const { return tk_outq_len(h_); }
    bool conf_set(const std::string &n, const std::string &v) {
        return tk_conf_set(h_, n.c_str(), v.c_str()) == 0;
    }
    std::string conf_get(const std::string &n) const {
        char buf[512];
        return tk_conf_get(h_, n.c_str(), buf, sizeof buf) > 0
                   ? std::string(buf)
                   : std::string();
    }
    void set_event_cb(EventCb *ev) {
        ev_ = ev;
        tk_set_log_cb(h_, detail::log_thunk);
        tk_set_error_cb(h_, detail::err_thunk);
        tk_set_stats_cb(h_, detail::stats_thunk);
    }
    std::string mock_bootstrap() const {
        char buf[256];
        return tk_mock_bootstrap(h_, buf, sizeof buf) > 0
                   ? std::string(buf)
                   : std::string();
    }
    tk_handle_t c_handle() const { return h_; }

  protected:
    Handle() = default;
    tk_handle_t h_ = 0;
    DeliveryReportCb *dr_ = nullptr;
    EventCb *ev_ = nullptr;
};

/* --------------------------------------------------------- Producer -- */
struct Header {
    std::string name;
    std::string value;
    bool null_value = false;
};

inline std::vector<Header> Message::headers_raw() const {
    std::vector<Header> out;
    for (int i = 0; i < m_.hdr_cnt; i++) {
        Header h;
        h.name = m_.hdr_names[i];
        if (m_.hdr_vals[i])
            h.value.assign(m_.hdr_vals[i], m_.hdr_val_lens[i]);
        else
            h.null_value = true;
        out.push_back(std::move(h));
    }
    return out;
}

class Producer : public Handle {
  public:
    static Producer *create(const Conf &conf, std::string &errstr) {
        char err[512] = {0};
        tk_handle_t h = tk_producer_new(conf.dump_json().c_str(), err,
                                        sizeof err);
        if (!h) {
            errstr = err;
            return nullptr;
        }
        auto *p = new Producer();
        p->h_ = h;
        return p;
    }
    void set_dr_cb(DeliveryReportCb *cb) {
        dr_ = cb;
        tk_set_dr_cb(h_, detail::dr_thunk);
    }
    int produce(const std::string &topic, int32_t partition,
                const void *payload, size_t len, const void *key = nullptr,
                size_t key_len = 0,
                const std::vector<Header> &headers = {},
                int64_t timestamp_ms = 0, long long opaque = 0) {
        if (headers.empty() && timestamp_ms == 0 && opaque == 0)
            return tk_produce(h_, topic.c_str(), partition,
                              static_cast<const char *>(key), key_len,
                              static_cast<const char *>(payload), len);
        std::vector<const char *> hn, hv;
        std::vector<size_t> hl;
        for (const auto &h : headers) {
            hn.push_back(h.name.c_str());
            hv.push_back(h.null_value ? nullptr : h.value.data());
            hl.push_back(h.null_value ? 0 : h.value.size());
        }
        return tk_produce2(h_, topic.c_str(), partition,
                           static_cast<const char *>(key), key_len,
                           static_cast<const char *>(payload), len,
                           timestamp_ms, hn.data(), hv.data(), hl.data(),
                           static_cast<int>(hn.size()), opaque);
    }
    int flush(int timeout_ms) {
        detail::Scope s(dr_, ev_);
        return tk_flush(h_, timeout_ms);
    }
    int purge(bool in_queue = true, bool in_flight = false) {
        return tk_purge(h_, in_queue, in_flight);
    }
    /* admin conveniences (reference exposes these via AdminClient) */
    int create_topic(const std::string &t, int partitions,
                     int timeout_ms = 10000) {
        return tk_create_topic(h_, t.c_str(), partitions, timeout_ms);
    }
    int delete_topic(const std::string &t, int timeout_ms = 10000) {
        return tk_delete_topic(h_, t.c_str(), timeout_ms);
    }
    int create_partitions(const std::string &t, int new_total,
                          int timeout_ms = 10000) {
        return tk_create_partitions(h_, t.c_str(), new_total,
                                    timeout_ms);
    }
    /* JSON blob results; empty string = error */
    std::string describe_configs(int restype, const std::string &name,
                                 int timeout_ms = 10000) {
        std::string buf(16384, '\0');
        int r = tk_describe_configs(h_, restype, name.c_str(), &buf[0],
                                    (int)buf.size(), timeout_ms);
        if (r <= 0) return std::string();
        buf.resize((size_t)r);
        return buf;
    }
    int alter_configs(int restype, const std::string &name,
                      const std::string &conf_json,
                      int timeout_ms = 10000) {
        return tk_alter_configs(h_, restype, name.c_str(),
                                conf_json.c_str(), timeout_ms);
    }
    std::string list_groups(int timeout_ms = 10000) {
        std::string buf(16384, '\0');
        int r = tk_list_groups(h_, &buf[0], (int)buf.size(), timeout_ms);
        if (r <= 0) return std::string();
        buf.resize((size_t)r);
        return buf;
    }
    std::string describe_group(const std::string &group,
                               int timeout_ms = 10000) {
        std::string buf(16384, '\0');
        int r = tk_describe_group(h_, group.c_str(), &buf[0],
                                  (int)buf.size(), timeout_ms);
        if (r <= 0) return std::string();
        buf.resize((size_t)r);
        return buf;
    }
    int delete_group(const std::string &group, int timeout_ms = 10000) {
        return tk_delete_group(h_, group.c_str(), timeout_ms);
    }

  private:
    Producer() = default;
};

/* --------------------------------------------------------- Consumer -- */
class TopicPartition {
  public:
    TopicPartition(std::string t, int32_t p, int64_t off = -1001)
        : topic(std::move(t)), partition(p), offset(off) {}
    std::string topic;
    int32_t partition;
    int64_t offset;
};

class Consumer : public Handle {
  public:
    static Consumer *create(const Conf &conf, std::string &errstr) {
        char err[512] = {0};
        tk_handle_t h = tk_consumer_new(conf.dump_json().c_str(), err,
                                        sizeof err);
        if (!h) {
            errstr = err;
            return nullptr;
        }
        auto *c = new Consumer();
        c->h_ = h;
        return c;
    }
    int subscribe(const std::vector<std::string> &topics) {
        std::string csv;
        for (const auto &t : topics) {
            if (!csv.empty()) csv += ',';
            csv += t;
        }
        return tk_subscribe(h_, csv.c_str());
    }
    int assign(const std::vector<TopicPartition> &parts) {
        if (parts.empty()) return tk_unassign(h_);
        /* the C surface assigns per topic */
        int rc = 0;
        std::map<std::string,
                 std::pair<std::vector<int32_t>, std::vector<int64_t>>>
            by_topic;
        for (const auto &tp : parts) {
            by_topic[tp.topic].first.push_back(tp.partition);
            by_topic[tp.topic].second.push_back(tp.offset);
        }
        for (const auto &kv : by_topic)
            rc |= tk_assign(h_, kv.first.c_str(), kv.second.first.data(),
                            kv.second.second.data(),
                            static_cast<int>(kv.second.first.size()));
        return rc;
    }
    int unassign() { return tk_unassign(h_); }
    /* nullptr = nothing within the timeout; caller owns the Message */
    Message *consume(int timeout_ms) {
        detail::Scope s(dr_, ev_);
        tk_msg_t m;
        int r = tk_consumer_poll(h_, timeout_ms, &m);
        if (r <= 0) return nullptr;
        return new Message(m);
    }
    int commit(bool async_commit = false) {
        return tk_commit(h_, async_commit);
    }
    long long committed(const std::string &topic, int32_t partition,
                        int timeout_ms = 5000) {
        return tk_committed(h_, topic.c_str(), partition, timeout_ms);
    }
    int seek(const TopicPartition &tp) {
        return tk_seek(h_, tp.topic.c_str(), tp.partition, tp.offset);
    }
    long long position(const std::string &topic, int32_t partition) {
        return tk_position(h_, topic.c_str(), partition);
    }
    int pause(const std::string &topic, int32_t partition) {
        return tk_pause(h_, topic.c_str(), partition);
    }
    int resume(const std::string &topic, int32_t partition) {
        return tk_resume(h_, topic.c_str(), partition);
    }
    int query_watermark_offsets(const std::string &topic,
                                int32_t partition, int64_t *lo,
                                int64_t *hi, int timeout_ms = 5000) {
        return tk_query_watermark_offsets(h_, topic.c_str(), partition,
                                          lo, hi, timeout_ms);
    }

  private:
    Consumer() = default;
};

}  // namespace tkafka
