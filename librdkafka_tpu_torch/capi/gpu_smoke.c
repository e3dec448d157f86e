/* gpu_smoke.c — the port's main path driven from C through libtkafka.so.
 *
 * For each leg: a producer on an in-process mock broker (idempotent,
 * lz4, linger 5 ms, the conf's codec keys) and a consumer with
 * check.crcs=true, both with statistics every 250 ms.  Warm-up rounds
 * run until one goes through the device alone (the codec engine's
 * launches > 0 on both clients, every CPU-route counter unchanged).
 * Then the counted window: REPEATS topics created with tk_create_topic,
 * each filled through tk_produce_batch (the arena fast lane) and
 * flushed, then a tail of TAIL records a partition through tk_produce2
 * (raw-byte headers, a DR callback counting deliveries) and flushed,
 * then read back by the consumer from tk_assign, every record's offset,
 * key, value and headers checked in order per partition against the
 * generator below.
 *
 * Output, one JSON object a line after the tag "GPU-SMOKE ": each
 * client's codec_engine stats before and after the window, and a
 * leg's rates (msgs/s of each repeat's produce and consume).  The
 * last line is "GPU-SMOKE-OK".  Any record that does not match exits 1;
 * an argument it does not know exits 2.  The window's launches and
 * CPU routes are checked by the reader of this output (capi/smoke.py's
 * deltas); the C side counts them only to end its warm-up.
 *
 *   gpu_smoke [--partitions N] [--records N] [--repeats N] [--tail N]
 *             [--conf key=value]...
 *             [--leg NAME[:key=value[,key=value]...]]...
 *
 * --conf keys go to both clients of every leg, a leg's keys to its
 * producer.  Values are passed as strings (the conf layer coerces
 * them, as rd_kafka_conf_set does).  Build it with
 * librdkafka_tpu_torch.capi.build_capi.compile_program.
 */
#include <inttypes.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "tkafka.h"

#define MAX_CONF 32
#define MAX_LEGS 8
#define STATS_MS 250

#define SIZE 1024   /* value bytes */

static int P = 64, N = 1600, REPEATS = 3, TAIL = 16;
static const char *confs[MAX_CONF];
static int nconf;
static struct {
    char name[32];
    char *kv;   /* "k=v,k=v" or NULL */
} legs[MAX_LEGS];
static int nlegs;

static void fail(const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    fprintf(stderr, "gpu_smoke: FAIL: ");
    vfprintf(stderr, fmt, ap);
    fprintf(stderr, "\n");
    va_end(ap);
    exit(1);
}

static void usage(const char *arg) {
    fprintf(stderr, "gpu_smoke: unknown or bad argument: %s\n", arg);
    exit(2);
}

static double now_s(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (double)t.tv_sec + (double)t.tv_nsec * 1e-9;
}

static long long wall_us(void) {
    struct timespec t;
    clock_gettime(CLOCK_REALTIME, &t);
    return (long long)t.tv_sec * 1000000LL + t.tv_nsec / 1000;
}

/* ------------------------------------------------------------ records -- */

/* Record j of partition p: key "p%02d", value the benchmark's JSON
 * event (bench.py _payloads) numbered p * N + j, repeated to SIZE
 * bytes. */
static void gen_value(int p, int j, char *out) {
    char base[160];
    long long seq = (long long)p * N + j;
    int n = snprintf(base, sizeof base,
                     "{\"seq\": %07lld, \"user\": \"u%05lld\", \"event\": "
                     "\"click\", \"props\": "
                     "\"abcdefghijklmnopqrstuvwxyz0123456789\"}",
                     seq, seq % 1000);
    for (int i = 0; i < SIZE; i++)
        out[i] = base[i % n];
}

static int key_of(int p, char *out) { return snprintf(out, 16, "p%02d", p); }

/* A partition's records in the arena layout tk_produce_batch takes:
 * key||value of each record back to back. */
typedef struct {
    char *base;
    int32_t *klens, *vlens;
    int klen;
} arena_t;

static arena_t *arenas;

static void make_arenas(void) {
    arenas = calloc((size_t)P, sizeof *arenas);
    if (!arenas)
        fail("out of memory");
    for (int p = 0; p < P; p++) {
        char key[16];
        int kl = key_of(p, key);
        arena_t *a = &arenas[p];
        a->klen = kl;
        a->base = malloc((size_t)N * (size_t)(kl + SIZE));
        a->klens = malloc(sizeof(int32_t) * (size_t)N);
        a->vlens = malloc(sizeof(int32_t) * (size_t)N);
        if (!a->base || !a->klens || !a->vlens)
            fail("out of memory");
        for (int j = 0; j < N; j++) {
            char *r = a->base + (size_t)j * (size_t)(kl + SIZE);
            memcpy(r, key, (size_t)kl);
            gen_value(p, j, r + kl);
            a->klens[j] = kl;
            a->vlens[j] = SIZE;
        }
    }
}

static const char *value_at(int p, int j) {
    return arenas[p].base + (size_t)j * (size_t)(arenas[p].klen + SIZE)
           + arenas[p].klen;
}

static const char *HDR_NAMES[2] = {"src", "bin"};
static const char HDR_BIN[3] = {'\0', (char)0xff, 'x'};

/* ------------------------------------------------------------- stats --- */

typedef struct {
    long long ts;   /* the blob's "ts" (wall clock, us) */
    char *ce;       /* its codec_engine object, NULL when absent */
} stats_t;

static stats_t pstats, cstats;

/* The JSON value that starts at s ('{' or '['), copied. */
static char *json_object(const char *s) {
    int depth = 0, in_str = 0;
    const char *e = s;
    for (; *e; e++) {
        if (in_str) {
            if (*e == '\\' && e[1])
                e++;
            else if (*e == '"')
                in_str = 0;
        } else if (*e == '"') {
            in_str = 1;
        } else if (*e == '{' || *e == '[') {
            depth++;
        } else if (*e == '}' || *e == ']') {
            if (--depth == 0)
                break;
        }
    }
    if (!*e)
        return NULL;
    size_t n = (size_t)(e - s) + 1;
    char *out = malloc(n + 1);
    if (out) {
        memcpy(out, s, n);
        out[n] = '\0';
    }
    return out;
}

static void keep(stats_t *st, const char *js) {
    const char *ts = strstr(js, "\"ts\": ");
    const char *ce = strstr(js, "\"codec_engine\": ");
    free(st->ce);
    st->ce = ce ? json_object(ce + strlen("\"codec_engine\": ")) : NULL;
    st->ts = ts ? strtoll(ts + 6, NULL, 10) : 0;
}

static void on_pstats(const char *js) { keep(&pstats, js); }
static void on_cstats(const char *js) { keep(&cstats, js); }

/* The first integer "key": n in s (0 when s is NULL or lacks it).
 * codec_engine opens with the engine's own counters, so its first
 * "launches" is the engine's CRC launches. */
static long long num(const char *s, const char *key) {
    char pat[64];
    snprintf(pat, sizeof pat, "\"%s\": ", key);
    const char *k = s ? strstr(s, pat) : NULL;
    return k ? strtoll(k + strlen(pat), NULL, 10) : 0;
}

/* codec_engine's last key is "compress": its object. */
static const char *compress_of(const char *ce) {
    const char *last = NULL;
    for (const char *k = ce; k && (k = strstr(k, "\"compress\": {")); k++)
        last = k;
    return last;
}

typedef struct {
    long long launches, comp_launches, cpu_routes;
} counts_t;

static counts_t counts(const char *ce) {
    counts_t c = {0, 0, 0};
    if (!ce)
        return c;
    const char *comp = compress_of(ce);
    c.launches = num(ce, "launches");
    c.comp_launches = num(comp, "launches");
    c.cpu_routes = num(ce, "warmup_miss_jobs") + num(ce, "routed_cpu_jobs")
                   + num(ce, "cpu_fallback_jobs") + num(comp, "cpu_jobs")
                   + num(comp, "warmup_miss_jobs")
                   + num(comp, "routed_cpu_jobs") + num(comp, "shed_jobs");
    return c;
}

/* Both clients' stats emitted after this call began: serve the
 * producer's queue and the consumer's (which must hold no record). */
static void snapshot(tk_handle_t p, tk_handle_t c) {
    long long t = wall_us();
    double deadline = now_s() + 10.0;
    while (pstats.ts < t || cstats.ts < t) {
        if (now_s() > deadline)
            fail("no fresh statistics within 10 s");
        tk_poll(p, 20);
        tk_msg_t m;
        int r = tk_consumer_poll(c, 20, &m);
        if (r < 0)
            fail("consumer poll error %d", r);
        if (r == 1) {
            int err = m.err;
            tk_msg_free(&m);
            fail("unexpected message on the consumer (err %d)", err);
        }
    }
}

static void print_stats(const char *leg, const char *when) {
    printf("GPU-SMOKE {\"leg\": \"%s\", \"when\": \"%s\", "
           "\"client\": \"producer\", \"codec_engine\": %s}\n",
           leg, when, pstats.ce ? pstats.ce : "null");
    printf("GPU-SMOKE {\"leg\": \"%s\", \"when\": \"%s\", "
           "\"client\": \"consumer\", \"codec_engine\": %s}\n",
           leg, when, cstats.ce ? cstats.ce : "null");
    fflush(stdout);
}

/* ---------------------------------------------------------- delivery --- */

static long long dr_ok, dr_err, dr_opaque_sum;

static void on_dr(long long opaque, int err, int32_t partition,
                  int64_t offset) {
    (void)partition;
    (void)offset;
    if (err == 0) {
        dr_ok++;
        dr_opaque_sum += opaque;
    } else {
        dr_err++;
    }
}

/* ------------------------------------------------------------ phases --- */

static void append_kv(char *conf, size_t size, const char *kv) {
    const char *eq = strchr(kv, '=');
    size_t n = strlen(conf);
    snprintf(conf + n, size - n, ", \"%.*s\": \"%s\"", (int)(eq - kv), kv,
             eq + 1);
}

static void common_conf(char *conf, size_t size) {
    for (int i = 0; i < nconf; i++)
        append_kv(conf, size, confs[i]);
    strncat(conf, "}", size - strlen(conf) - 1);
}

static void create_topic(tk_handle_t p, const char *topic) {
    if (tk_create_topic(p, topic, P, 30000) != 0)
        fail("create_topic %s", topic);
}

/* The first n records of every partition of topic: the first n - tail
 * through tk_produce_batch, flushed, then the rest through tk_produce2
 * with headers and a DR each, flushed.  (A per-message DR callback moves
 * its partition off the fast lane, the reference's rule: sent while the
 * run is still queued, it would turn the run into per-record messages.)
 * Returns msgs/s over both produce calls and flushes. */
static double produce(tk_handle_t p, const char *topic, int n, int tail) {
    long long ok0 = dr_ok, opq0 = dr_opaque_sum, want_opq = 0;
    double t0 = now_s();
    for (int i = 0; i < P; i++) {
        arena_t *a = &arenas[i];
        long long got = tk_produce_batch(p, topic, i, a->base, a->klens,
                                         a->vlens, n - tail);
        if (got != n - tail)
            fail("%s[%d]: produce_batch %lld of %d", topic, i, got,
                 n - tail);
    }
    int left = tk_flush(p, 300000);
    if (left != 0)
        fail("%s: flush left %d messages", topic, left);
    for (int i = 0; i < P; i++) {
        char key[16];
        int kl = key_of(i, key);
        for (int j = n - tail; j < n; j++) {
            const char *hv[2] = {"gpu_smoke", HDR_BIN};
            size_t hl[2] = {strlen("gpu_smoke"), sizeof HDR_BIN};
            long long opq = (long long)i * N + j + 1;
            want_opq += opq;
            if (tk_produce2(p, topic, i, key, (size_t)kl, value_at(i, j),
                            (size_t)SIZE, 0, HDR_NAMES, hv, hl, 2, opq) != 0)
                fail("%s[%d]: produce2 of record %d", topic, i, j);
        }
    }
    left = tk_flush(p, 300000);
    double dt = now_s() - t0;
    if (left != 0)
        fail("%s: flush left %d messages", topic, left);
    if (tk_outq_len(p) != 0)
        fail("%s: outq_len %lld after flush", topic, tk_outq_len(p));
    if (dr_ok - ok0 != (long long)tail * P || dr_err != 0
        || dr_opaque_sum - opq0 != want_opq)
        fail("%s: DRs delivered %lld of %d (%lld failed)", topic,
             dr_ok - ok0, tail * P, dr_err);
    return (double)n * P / dt;
}

/* Assign every partition of topic from the beginning and read its n
 * records back, each checked in order.  Returns msgs/s. */
static double consume(tk_handle_t c, const char *topic, int n, int tail) {
    int32_t *parts = malloc(sizeof(int32_t) * (size_t)P);
    int64_t *offs = malloc(sizeof(int64_t) * (size_t)P);
    int *nxt = calloc((size_t)P, sizeof(int));
    if (!parts || !offs || !nxt)
        fail("out of memory");
    for (int i = 0; i < P; i++) {
        parts[i] = i;
        offs[i] = -2; /* OFFSET_BEGINNING */
    }
    long long want = (long long)n * P, got = 0;
    double t0 = now_s(), deadline = t0 + 300.0;
    if (tk_assign(c, topic, parts, offs, P) != 0)
        fail("%s: assign", topic);
    while (got < want) {
        if (now_s() > deadline)
            fail("%s: consumed %lld of %lld", topic, got, want);
        tk_msg_t m;
        int r = tk_consumer_poll(c, 500, &m);
        if (r < 0)
            fail("%s: consumer poll error %d", topic, r);
        if (r == 0)
            continue;
        if (m.err != 0)
            fail("%s: consumer error %d", topic, m.err);
        int i = m.partition, j = i >= 0 && i < P ? nxt[i] : -1;
        char key[16];
        int kl = key_of(i, key);
        int ok = j >= 0 && j < n && m.offset == j
                 && m.topic && strcmp(m.topic, topic) == 0
                 && m.key_len == (size_t)kl && memcmp(m.key, key, kl) == 0
                 && m.len == (size_t)SIZE && m.payload
                 && memcmp(m.payload, value_at(i, j), (size_t)SIZE) == 0;
        if (ok && j >= n - tail)
            ok = m.hdr_cnt == 2 && strcmp(m.hdr_names[0], "src") == 0
                 && m.hdr_val_lens[0] == strlen("gpu_smoke")
                 && memcmp(m.hdr_vals[0], "gpu_smoke", 9) == 0
                 && strcmp(m.hdr_names[1], "bin") == 0
                 && m.hdr_val_lens[1] == sizeof HDR_BIN
                 && memcmp(m.hdr_vals[1], HDR_BIN, sizeof HDR_BIN) == 0;
        else if (ok)
            ok = m.hdr_cnt == 0;
        if (!ok)
            fail("%s[%d]: record %d wrong or out of order (offset %" PRId64
                 ")", topic, i, j, m.offset);
        tk_msg_free(&m);
        nxt[i]++;
        got++;
    }
    double dt = now_s() - t0;
    free(parts);
    free(offs);
    free(nxt);
    return (double)want / dt;
}

static void run_leg(int li) {
    const char *leg = legs[li].name;
    char conf[4096], bootstrap[256], errstr[512], topic[128];
    snprintf(conf, sizeof conf,
             "{\"bootstrap.servers\": \"\", \"test.mock.num.brokers\": \"1\","
             " \"enable.idempotence\": \"true\","
             " \"compression.codec\": \"lz4\", \"linger.ms\": \"5\","
             " \"queue.buffering.max.messages\": \"1000000\","
             " \"statistics.interval.ms\": \"%d\"", STATS_MS);
    if (legs[li].kv) {
        char *kv = strdup(legs[li].kv);
        for (char *s = strtok(kv, ","); s; s = strtok(NULL, ","))
            append_kv(conf, sizeof conf, s);
        free(kv);
    }
    common_conf(conf, sizeof conf);
    double t_leg = now_s();
    tk_handle_t p = tk_producer_new(conf, errstr, sizeof errstr);
    if (!p)
        fail("leg %s: producer_new: %s", leg, errstr);
    if (tk_set_dr_cb(p, on_dr) != 0 || tk_set_stats_cb(p, on_pstats) != 0)
        fail("leg %s: producer callbacks", leg);
    if (tk_mock_bootstrap(p, bootstrap, sizeof bootstrap) <= 0)
        fail("leg %s: mock_bootstrap", leg);
    snprintf(conf, sizeof conf,
             "{\"bootstrap.servers\": \"%s\", \"group.id\": \"gpu-smoke-%s\","
             " \"auto.offset.reset\": \"earliest\", \"check.crcs\": \"true\","
             " \"statistics.interval.ms\": \"%d\"",
             bootstrap, leg, STATS_MS);
    common_conf(conf, sizeof conf);
    tk_handle_t c = tk_consumer_new(conf, errstr, sizeof errstr);
    if (!c)
        fail("leg %s: consumer_new: %s", leg, errstr);
    if (tk_set_stats_cb(c, on_cstats) != 0)
        fail("leg %s: consumer stats callback", leg);

    /* warm-up: one topic, a round of a few records a partition at a
     * time, until a round runs on the device alone */
    int warm_n = N < 16 ? N : 16, warm_tail = warm_n < 2 ? warm_n : 2;
    int rounds = 0;
    double t_warm = now_s();
    snapshot(p, c);
    for (;; rounds++) {
        if (rounds == 60 || now_s() - t_warm > 240.0)
            fail("leg %s: the route did not warm in %d rounds", leg, rounds);
        counts_t p0 = counts(pstats.ce), c0 = counts(cstats.ce);
        snprintf(topic, sizeof topic, "gpu-smoke-%s-warm%d", leg, rounds);
        create_topic(p, topic);
        produce(p, topic, warm_n, warm_tail);
        consume(c, topic, warm_n, warm_tail);
        snapshot(p, c);
        counts_t p1 = counts(pstats.ce), c1 = counts(cstats.ce);
        if (p1.launches + p1.comp_launches > p0.launches + p0.comp_launches
            && c1.launches > c0.launches && p1.cpu_routes == p0.cpu_routes
            && c1.cpu_routes == c0.cpu_routes)
            break;
    }
    double warm_s = now_s() - t_warm;

    /* the counted window */
    for (int r = 0; r < REPEATS; r++) {
        snprintf(topic, sizeof topic, "gpu-smoke-%s-r%d", leg, r);
        create_topic(p, topic);
    }
    snapshot(p, c);
    print_stats(leg, "before");
    double prod[16], cons[16];
    for (int r = 0; r < REPEATS; r++) {
        snprintf(topic, sizeof topic, "gpu-smoke-%s-r%d", leg, r);
        prod[r] = produce(p, topic, N, TAIL);
        cons[r] = consume(c, topic, N, TAIL);
    }
    snapshot(p, c);
    print_stats(leg, "after");
    printf("GPU-SMOKE {\"leg\": \"%s\", \"partitions\": %d, \"records\": %d,"
           " \"size\": %d, \"repeats\": %d, \"tail\": %d, "
           "\"warm_rounds\": %d, \"warm_s\": %.3f, \"dr_ok\": %lld, "
           "\"produce\": [", leg, P, N, SIZE, REPEATS, TAIL, rounds + 1,
           warm_s, dr_ok);
    for (int r = 0; r < REPEATS; r++)
        printf("%s%.1f", r ? ", " : "", prod[r]);
    printf("], \"consume\": [");
    for (int r = 0; r < REPEATS; r++)
        printf("%s%.1f", r ? ", " : "", cons[r]);
    printf("], \"leg_s\": %.3f}\n", now_s() - t_leg);
    fflush(stdout);
    tk_destroy(c);
    tk_destroy(p);
}

static int int_arg(int argc, char **argv, int *i, int lo, int hi) {
    if (*i + 1 >= argc)
        usage(argv[*i]);
    char *end;
    long v = strtol(argv[++*i], &end, 10);
    if (*end || v < lo || v > hi)
        usage(argv[*i]);
    return (int)v;
}

/* key=value with no character that would need escaping in JSON */
static int plain_kv(const char *s) {
    const char *eq = strchr(s, '=');
    return eq && eq != s && !strpbrk(s, "\"\\");
}

int main(int argc, char **argv) {
    for (int i = 1; i < argc; i++) {
        const char *a = argv[i];
        if (!strcmp(a, "--partitions"))
            P = int_arg(argc, argv, &i, 1, 1024);
        else if (!strcmp(a, "--records"))
            N = int_arg(argc, argv, &i, 1, 1 << 20);
        else if (!strcmp(a, "--repeats"))
            REPEATS = int_arg(argc, argv, &i, 1, 16);
        else if (!strcmp(a, "--tail"))
            TAIL = int_arg(argc, argv, &i, 0, 1 << 20);
        else if (!strcmp(a, "--conf") && i + 1 < argc && nconf < MAX_CONF
                 && plain_kv(argv[i + 1]))
            confs[nconf++] = argv[++i];
        else if (!strcmp(a, "--leg") && i + 1 < argc && nlegs < MAX_LEGS) {
            char *spec = argv[++i], *colon = strchr(spec, ':');
            size_t n = colon ? (size_t)(colon - spec) : strlen(spec);
            if (n == 0 || n >= sizeof legs[0].name)
                usage(spec);
            memcpy(legs[nlegs].name, spec, n);
            legs[nlegs].name[n] = '\0';
            legs[nlegs].kv = colon ? colon + 1 : NULL;
            if (colon) {
                char *kv = strdup(colon + 1);
                for (char *s = strtok(kv, ","); s; s = strtok(NULL, ","))
                    if (!plain_kv(s))
                        usage(spec);
                free(kv);
            }
            nlegs++;
        } else {
            usage(a);
        }
    }
    if (TAIL > N)
        usage("--tail");
    if (nlegs == 0) {
        strcpy(legs[0].name, "a");
        nlegs = 1;
    }
    make_arenas();
    for (int li = 0; li < nlegs; li++)
        run_leg(li);
    printf("GPU-SMOKE-OK\n");
    return 0;
}
