/* C client example over the PyTorch / CUDA port's C ABI (tkafka.h +
 * libtkafka.so, built by `python -m librdkafka_tpu_torch.capi.build_capi`)
 * — the second-language binding surface, playing the role src-cpp/
 * plays for the reference.
 *
 * Build (from the repository root; B = build/librdkafka_tpu_torch/capi):
 *   python -m librdkafka_tpu_torch.capi.build_capi
 *   gcc -o capi_client librdkafka_tpu_torch/examples/capi_client.c \
 *       -I $B -L $B -ltkafka -Wl,-rpath,$PWD/$B
 *   ./capi_client "" 100            # in-process mock cluster
 *   ./capi_client host:9092 100     # external broker/mock
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "tkafka.h"

int main(int argc, char **argv) {
    const char *bootstrap = argc > 1 ? argv[1] : "";
    int count = argc > 2 ? atoi(argv[2]) : 100;
    char errstr[512];
    char conf[512];

    if (bootstrap[0] == '\0')
        snprintf(conf, sizeof(conf),
                 "{\"bootstrap.servers\": \"\","
                 " \"test.mock.num.brokers\": 1,"
                 " \"compression.codec\": \"lz4\", \"linger.ms\": 5}");
    else
        snprintf(conf, sizeof(conf),
                 "{\"bootstrap.servers\": \"%s\","
                 " \"compression.codec\": \"lz4\", \"linger.ms\": 5}",
                 bootstrap);

    tk_handle_t p = tk_producer_new(conf, errstr, sizeof(errstr));
    if (!p) {
        fprintf(stderr, "producer_new failed: %s\n", errstr);
        return 1;
    }
    char payload[128];
    for (int i = 0; i < count; i++) {
        snprintf(payload, sizeof(payload), "c-example-%06d", i);
        if (tk_produce(p, "capi-topic", 0, NULL, 0,
                       payload, strlen(payload)) != 0) {
            fprintf(stderr, "produce %d failed\n", i);
            return 1;
        }
    }
    if (tk_flush(p, 30000) != 0) {
        fprintf(stderr, "flush left messages undelivered\n");
        return 1;
    }
    printf("produced %d messages\n", count);

    char bs[256];
    if (bootstrap[0] == '\0') {
        if (tk_mock_bootstrap(p, bs, sizeof(bs)) <= 0) {
            fprintf(stderr, "mock_bootstrap failed\n");
            return 1;
        }
        bootstrap = bs;
    }
    snprintf(conf, sizeof(conf),
             "{\"bootstrap.servers\": \"%s\", \"group.id\": \"capi-g\","
             " \"auto.offset.reset\": \"earliest\","
             " \"check.crcs\": true}", bootstrap);
    tk_handle_t c = tk_consumer_new(conf, errstr, sizeof(errstr));
    if (!c) {
        fprintf(stderr, "consumer_new failed: %s\n", errstr);
        return 1;
    }
    if (tk_subscribe(c, "capi-topic") != 0) {
        fprintf(stderr, "subscribe failed\n");
        return 1;
    }
    int got = 0, polls = 0;
    while (got < count && polls++ < 600) {
        tk_msg_t m;
        int r = tk_consumer_poll(c, 100, &m);
        if (r < 0) {
            fprintf(stderr, "poll error %d\n", r);
            return 1;
        }
        if (r == 1) {
            if (m.err == 0)
                got++;
            tk_msg_free(&m);
        }
    }
    printf("consumed %d messages\n", got);
    tk_destroy(c);
    tk_destroy(p);
    return got == count ? 0 : 1;
}
