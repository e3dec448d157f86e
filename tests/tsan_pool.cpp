/* ThreadSanitizer driver for the port's native codec pool
 * (librdkafka_tpu_torch/ops/native/codec.cpp run_pool): calls of
 * several pool grains, which wake parked workers, from several app
 * threads at once, so calls also find the pool held and run alone.
 * Every output must equal the one-thread loop's.  Built and run by
 * tests/test_torch_tsan.py; any TSAN report fails.
 */
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
int64_t tk_lz4f_bound(int64_t n);
int64_t tk_pool_grain();
void tk_lz4f_compress_many(const uint8_t *base, const int64_t *offs,
                           const int64_t *lens, int n, uint8_t *outbase,
                           const int64_t *out_offs, int64_t *out_lens,
                           int nthreads);
void tk_lz4f_decompress_many(const uint8_t *base, const int64_t *offs,
                             const int64_t *lens, int n, uint8_t *outbase,
                             const int64_t *out_offs,
                             const int64_t *out_caps, int64_t *out_lens,
                             int nthreads);
void tk_pool_stats(int64_t *out);
}

static const int NBUF = 8;

struct Call {
    int64_t buf;
    std::vector<uint8_t> base, out;
    std::vector<int64_t> offs, lens, out_offs, out_lens;
    explicit Call(int64_t b) : buf(b), base(NBUF * b), offs(NBUF),
                               lens(NBUF), out_offs(NBUF), out_lens(NBUF) {
        int64_t cap = tk_lz4f_bound(b);
        out.resize(NBUF * cap);
        for (int i = 0; i < NBUF; i++) {
            offs[i] = i * b;
            lens[i] = b;
            out_offs[i] = i * cap;
            for (int64_t j = 0; j < b; j++)
                base[i * b + j] = (uint8_t)(((j * 131) ^ (j >> 7) ^ i) % 61);
        }
    }
    void compress(int nthreads) {
        tk_lz4f_compress_many(base.data(), offs.data(), lens.data(), NBUF,
                              out.data(), out_offs.data(), out_lens.data(),
                              nthreads);
    }
};

static int round_trip(Call &c, const Call &want) {
    c.compress(0);
    for (int i = 0; i < NBUF; i++) {
        if (c.out_lens[i] != want.out_lens[i] ||
            memcmp(c.out.data() + c.out_offs[i],
                   want.out.data() + want.out_offs[i], c.out_lens[i]))
            return 1;
    }
    std::vector<uint8_t> plain(NBUF * c.buf);
    std::vector<int64_t> poffs(NBUF), caps(NBUF, c.buf), plens(NBUF);
    for (int i = 0; i < NBUF; i++) poffs[i] = i * c.buf;
    tk_lz4f_decompress_many(c.out.data(), c.out_offs.data(),
                            c.out_lens.data(), NBUF, plain.data(),
                            poffs.data(), caps.data(), plens.data(), 0);
    for (int i = 0; i < NBUF; i++)
        if (plens[i] != c.buf) return 2;
    return plain == c.base ? 0 : 3;
}

int main() {
    // one item per half grain: four participants a large call
    int64_t sizes[2] = {tk_pool_grain() / 2, 3000};
    std::vector<Call> want;
    for (int64_t b : sizes) {
        want.emplace_back(b);
        want.back().compress(1);
    }
    std::vector<std::thread> apps;
    int rc[4] = {0, 0, 0, 0};
    for (int t = 0; t < 4; t++)
        apps.emplace_back([&, t]() {
            std::vector<Call> mine;
            for (int64_t b : sizes) mine.emplace_back(b);
            for (int r = 0; r < 6 && rc[t] == 0; r++)
                rc[t] = round_trip(mine[r % 2], want[r % 2]);
        });
    for (auto &t : apps) t.join();
    for (int t = 0; t < 4; t++)
        if (rc[t]) { std::fprintf(stderr, "round failed: %d\n", rc[t]); return 1; }
    int64_t st[4];
    tk_pool_stats(st);
    if (st[3] == 0) { std::fprintf(stderr, "no worker woke\n"); return 1; }
    std::printf("TSAN-POOL-OK calls %lld solo %lld busy %lld wakes %lld\n",
                (long long)st[0], (long long)st[1], (long long)st[2],
                (long long)st[3]);
    return 0;
}
