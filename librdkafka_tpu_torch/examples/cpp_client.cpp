/* C++ client example over the tkafka.hpp RAII wrapper (the rebuild's
 * src-cpp analog; reference: examples/rdkafka_example.cpp), linked
 * against the PyTorch / CUDA port's libtkafka.so.
 *
 * Round trip: producer with a DeliveryReportCb + headers -> in-process
 * mock cluster -> consumer group reads everything back, verifies
 * payloads + raw-byte header values, commits. Prints CPP-OK on
 * success; exits non-zero on any failure.
 *
 * Build (from the repository root; B = build/librdkafka_tpu_torch/capi,
 * which holds tkafka.h; tkafka.hpp is in librdkafka_tpu_torch/capi):
 *   python -m librdkafka_tpu_torch.capi.build_capi
 *   g++ -std=c++17 -o cpp_client \
 *       librdkafka_tpu_torch/examples/cpp_client.cpp \
 *       -I $B -I librdkafka_tpu_torch/capi -L $B -ltkafka -Wl,-rpath,$PWD/$B
 * (or build_capi.compile_program(src, exe), which tests/test_torch_capi.py
 * uses)
 */
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "tkafka.hpp"

class CountingDr : public tkafka::DeliveryReportCb {
  public:
    long long ok = 0, failed = 0, opaque_sum = 0;
    void dr_cb(long long opaque, int err, int32_t, int64_t) override {
        if (err == 0) {
            ok++;
            opaque_sum += opaque;
        } else {
            failed++;
        }
    }
};

class StatsEv : public tkafka::EventCb {
  public:
    int stats_seen = 0;
    void stats_cb(const char *json) override {
        if (json && std::strstr(json, "\"brokers\"")) stats_seen++;
    }
};

int main() {
    const int N = 40;
    std::string errstr;

    tkafka::Conf pconf;
    pconf.set("bootstrap.servers", "");
    pconf.set("test.mock.num.brokers", "1");
    pconf.set("linger.ms", "5");
    pconf.set("compression.codec", "lz4");
    pconf.set("statistics.interval.ms", "100");
    std::unique_ptr<tkafka::Producer> p(
        tkafka::Producer::create(pconf, errstr));
    if (!p) {
        std::fprintf(stderr, "producer: %s\n", errstr.c_str());
        return 1;
    }
    CountingDr dr;
    StatsEv ev;
    p->set_dr_cb(&dr);
    p->set_event_cb(&ev);

    if (p->create_topic("cppt", 2) != 0) {
        std::fprintf(stderr, "create_topic failed\n");
        return 1;
    }

    const char binval[4] = {'\0', '\x01', '\xfe', 'z'};
    for (int i = 0; i < N; i++) {
        char val[64], key[16];
        std::snprintf(val, sizeof val, "cpp-message-%03d", i);
        std::snprintf(key, sizeof key, "k%d", i);
        std::vector<tkafka::Header> hs = {
            {"lang", "c++17", false},
            {"bin", std::string(binval, 4), false},
        };
        if (p->produce("cppt", i % 2, val, std::strlen(val), key,
                       std::strlen(key), hs, 0, i) != 0) {
            std::fprintf(stderr, "produce %d failed\n", i);
            return 1;
        }
    }
    if (p->flush(30000) != 0) {
        std::fprintf(stderr, "flush left messages\n");
        return 1;
    }
    if (dr.ok != N || dr.failed != 0
        || dr.opaque_sum != 1LL * N * (N - 1) / 2) {
        std::fprintf(stderr, "dr: ok=%lld failed=%lld opq=%lld\n", dr.ok,
                     dr.failed, dr.opaque_sum);
        return 1;
    }
    for (int i = 0; i < 50 && !ev.stats_seen; i++) p->poll(100);
    if (!ev.stats_seen) {
        std::fprintf(stderr, "no stats event\n");
        return 1;
    }

    tkafka::Conf cconf;
    cconf.set("bootstrap.servers", p->mock_bootstrap());
    cconf.set("group.id", "gcpp");
    cconf.set("auto.offset.reset", "earliest");
    cconf.set("check.crcs", "true");
    std::unique_ptr<tkafka::Consumer> c(
        tkafka::Consumer::create(cconf, errstr));
    if (!c) {
        std::fprintf(stderr, "consumer: %s\n", errstr.c_str());
        return 1;
    }
    c->subscribe({"cppt"});

    int got = 0, hdr_ok = 0, bin_ok = 0;
    for (int polls = 0; got < N && polls < 600; polls++) {
        std::unique_ptr<tkafka::Message> m(c->consume(100));
        if (!m) continue;
        if (m->err() != 0) continue;
        got++;
        if (m->value().rfind("cpp-message-", 0) != 0) {
            std::fprintf(stderr, "bad payload %s\n", m->value().c_str());
            return 1;
        }
        for (const auto &h : m->headers()) {
            if (h.first == "lang" && h.second == "c++17") hdr_ok++;
            if (h.first == "bin" && h.second == std::string(binval, 4))
                bin_ok++;
        }
    }
    if (got != N || hdr_ok != N || bin_ok != N) {
        std::fprintf(stderr, "consume got=%d hdr=%d bin=%d\n", got,
                     hdr_ok, bin_ok);
        return 1;
    }
    if (c->commit(false) != 0) {
        std::fprintf(stderr, "commit failed\n");
        return 1;
    }
    long long c0 = c->committed("cppt", 0), c1 = c->committed("cppt", 1);
    if ((c0 > 0 ? c0 : 0) + (c1 > 0 ? c1 : 0) != N) {
        std::fprintf(stderr, "committed %lld+%lld != %d\n", c0, c1, N);
        return 1;
    }

    /* admin from C++ */
    if (p->create_partitions("cppt", 4) != 0) {
        std::fprintf(stderr, "create_partitions failed\n");
        return 1;
    }
    std::string cfg = p->describe_configs(2 /* TOPIC */, "cppt");
    if (cfg.empty() || cfg[0] != '{') {
        std::fprintf(stderr, "describe_configs: %s\n", cfg.c_str());
        return 1;
    }
    std::string groups = p->list_groups();
    if (groups.find("gcpp") == std::string::npos) {
        std::fprintf(stderr, "list_groups: %s\n", groups.c_str());
        return 1;
    }

    std::printf("CPP-OK produced=%d consumed=%d headers-raw=%d stats=%d "
                "admin-ok v=%s\n",
                N, got, bin_ok, ev.stats_seen,
                tkafka::version().c_str());
    return 0;
}
