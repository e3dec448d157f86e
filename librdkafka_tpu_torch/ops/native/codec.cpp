// codec.cpp — native CPU codec provider for librdkafka_tpu_torch (a copy of
// librdkafka_tpu/ops/native/codec.cpp; the two packages build separately).
//
// Self-contained implementations (no third-party code) of:
//   - CRC32C (Castagnoli, slice-by-8)            [ref: src/crc32c.c]
//   - xxHash32 (needed for the LZ4 frame header checksum)
//   - LZ4 block + frame compress / decompress     [ref: vendored lz4*.c + src/rdkafka_lz4.c]
//   - Snappy raw compress / decompress            [ref: vendored src/snappy.c]
//
// The LZ4 *encoder* follows the deterministic "TPU-greedy" spec shared with
// the JAX/Pallas provider (ops/lz4_jax.py): 12-bit multiplicative hash,
// candidate = most recent previous position with the same hash (every
// position's hash is inserted, including match interiors), greedy parse,
// match length capped at MAXMATCH, last-5-literals / 12-byte-tail rules per
// the public LZ4 block spec. Both providers therefore emit bit-identical,
// spec-compliant LZ4 streams — the bit-exactness contract of BASELINE.json.
//
// Build: g++ -O3 -shared -fPIC (see build.py). Exposed via ctypes.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#if defined(__x86_64__) || defined(__i386__)
#include <cpuid.h>
#endif

#define EXPORT extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------- crc32c --
// Runtime hw/sw dispatch like the reference (crc32c.c:39 SSE4.2 path,
// :138 runtime detect): the x86 crc32 instruction computes this exact
// (Castagnoli, reflected) polynomial at ~1 cycle per 8 bytes vs ~3-4
// cycles for the slice-by-8 table fold.

static uint32_t crc32c_tab[8][256];

static void crc32c_init_once() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++) c = (c >> 1) ^ (poly & (0u - (c & 1)));
        crc32c_tab[0][i] = c;
    }
    for (int k = 1; k < 8; k++)
        for (uint32_t i = 0; i < 256; i++)
            crc32c_tab[k][i] = crc32c_tab[0][crc32c_tab[k-1][i] & 0xFF] ^ (crc32c_tab[k-1][i] >> 8);
}

static void crc32c_init() {
    // function-local static: race-free one-time init (the done-flag
    // form raced between broker threads — TSAN tier, test_0124)
    static const bool done = (crc32c_init_once(), true);
    (void)done;
}

static uint32_t crc32c_sw(const uint8_t *p, int64_t n, uint32_t crc) {
    crc32c_init();
    crc = ~crc;
    while (n >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, p, 4); memcpy(&hi, p + 4, 4);
        crc ^= lo;
        crc = crc32c_tab[7][crc & 0xFF] ^ crc32c_tab[6][(crc >> 8) & 0xFF]
            ^ crc32c_tab[5][(crc >> 16) & 0xFF] ^ crc32c_tab[4][crc >> 24]
            ^ crc32c_tab[3][hi & 0xFF] ^ crc32c_tab[2][(hi >> 8) & 0xFF]
            ^ crc32c_tab[1][(hi >> 16) & 0xFF] ^ crc32c_tab[0][hi >> 24];
        p += 8; n -= 8;
    }
    while (n-- > 0) crc = crc32c_tab[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

// GF(2) zero-advance: zshift[k] = columns of M^(2^k), where M advances
// a raw CRC register through one zero byte (the combine math of
// crc32c_combine, utils/crc.py, in C). Used to stitch the 3-stream
// hardware fold back together.
static uint32_t crc32c_zshift[64][32];

static void crc32c_zshift_init_once() {
    crc32c_init();
    for (int j = 0; j < 32; j++) {       // M^1: one zero byte
        uint32_t reg = 1u << j;
        crc32c_zshift[0][j] = crc32c_tab[0][reg & 0xFF] ^ (reg >> 8);
    }
    for (int k = 1; k < 64; k++)         // M^(2^k) = (M^(2^(k-1)))^2
        for (int j = 0; j < 32; j++) {
            uint32_t v = crc32c_zshift[k - 1][j], acc = 0;
            for (int b = 0; v; b++, v >>= 1)
                if (v & 1) acc ^= crc32c_zshift[k - 1][b];
            crc32c_zshift[k][j] = acc;
        }
}

static void crc32c_zshift_init() {
    static const bool done = (crc32c_zshift_init_once(), true);
    (void)done;
}

// advance raw register `reg` through `n` zero bytes
static uint32_t crc32c_shift(uint32_t reg, int64_t n) {
    crc32c_zshift_init();
    for (int k = 0; n; k++, n >>= 1) {
        if (n & 1) {
            uint32_t acc = 0, v = reg;
            for (int b = 0; v; b++, v >>= 1)
                if (v & 1) acc ^= crc32c_zshift[k][b];
            reg = acc;
        }
    }
    return reg;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
static uint64_t crc32c_hw_fold(const uint8_t *p, int64_t n, uint64_t c) {
    while (n >= 8) {
        uint64_t v;
        memcpy(&v, p, 8);
        c = __builtin_ia32_crc32di(c, v);
        p += 8; n -= 8;
    }
    uint32_t cc = (uint32_t)c;
    while (n-- > 0) cc = __builtin_ia32_crc32qi(cc, *p++);
    return cc;
}

__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(const uint8_t *p, int64_t n, uint32_t crc) {
    uint64_t c0 = ~crc;
    // the crc32 instruction is 1/cycle throughput but 3-cycle latency:
    // a single dependent chain runs at 1/3 peak. Three independent
    // contiguous thirds fold in parallel and are stitched with the
    // GF(2) zero-advance (same math as crc32c_combine).
    if (n >= 3 * 64) {
        int64_t L = (n / 3) & ~7LL;          // 8-byte aligned lane length
        const uint8_t *a = p, *b = p + L, *cst = p + 2 * L;
        uint64_t ca = c0, cb = 0, cc = 0;
        for (int64_t i = 0; i < L; i += 8) {
            uint64_t va, vb, vc;
            memcpy(&va, a + i, 8);
            memcpy(&vb, b + i, 8);
            memcpy(&vc, cst + i, 8);
            ca = __builtin_ia32_crc32di(ca, va);
            cb = __builtin_ia32_crc32di(cb, vb);
            cc = __builtin_ia32_crc32di(cc, vc);
        }
        int64_t tail = n - 3 * L;            // fold [3L, n) into lane C
        cc = crc32c_hw_fold(p + 3 * L, tail, cc);
        uint32_t reg = crc32c_shift((uint32_t)ca, L + L + tail)
                     ^ crc32c_shift((uint32_t)cb, L + tail)
                     ^ (uint32_t)cc;
        return ~reg;
    }
    return ~(uint32_t)crc32c_hw_fold(p, n, c0);
}

static bool cpu_has_sse42() {
    unsigned a = 0, b = 0, c = 0, d = 0;
    if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
    return (c & (1u << 20)) != 0;
}
#endif

typedef uint32_t (*crc32c_fn)(const uint8_t *, int64_t, uint32_t);

static crc32c_fn crc32c_pick() {
#if defined(__x86_64__)
    if (cpu_has_sse42()) return crc32c_hw;
#endif
    return crc32c_sw;
}

EXPORT uint32_t tk_crc32c(const uint8_t *p, int64_t n, uint32_t crc) {
    // function-local static: C++11 guarantees race-free one-time init
    // (the lazy nullable-pointer form was a data race between broker
    // threads — caught by the TSAN tier, tests/test_0124_tsan.py)
    static const crc32c_fn impl = crc32c_pick();
    return impl(p, n, crc);
}

// sw path kept callable for tests (hw/sw bit-exactness cross-check)
EXPORT uint32_t tk_crc32c_sw(const uint8_t *p, int64_t n, uint32_t crc) {
    return crc32c_sw(p, n, crc);
}

// Batched CRC over many slices of one base buffer (one call per launch).
EXPORT void tk_crc32c_many(const uint8_t *base, const int64_t *offs,
                           const int64_t *lens, uint32_t *out, int count) {
    for (int i = 0; i < count; i++)
        out[i] = tk_crc32c(base + offs[i], lens[i], 0);
}

// ----------------------------------------------------------------- xxh32 --

static const uint32_t XP1 = 2654435761u, XP2 = 2246822519u, XP3 = 3266489917u,
                      XP4 = 668265263u, XP5 = 374761393u;

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }
static inline uint32_t rd32le(const uint8_t *p) { uint32_t v; memcpy(&v, p, 4); return v; }
static inline uint16_t rd16le(const uint8_t *p) { uint16_t v; memcpy(&v, p, 2); return v; }

EXPORT uint32_t tk_xxh32(const uint8_t *p, int64_t n, uint32_t seed) {
    const uint8_t *end = p + n;
    uint32_t h;
    if (n >= 16) {
        uint32_t v1 = seed + XP1 + XP2, v2 = seed + XP2, v3 = seed, v4 = seed - XP1;
        const uint8_t *lim = end - 16;
        do {
            v1 = rotl32(v1 + rd32le(p) * XP2, 13) * XP1; p += 4;
            v2 = rotl32(v2 + rd32le(p) * XP2, 13) * XP1; p += 4;
            v3 = rotl32(v3 + rd32le(p) * XP2, 13) * XP1; p += 4;
            v4 = rotl32(v4 + rd32le(p) * XP2, 13) * XP1; p += 4;
        } while (p <= lim);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + XP5;
    }
    h += (uint32_t)n;
    while (p + 4 <= end) { h = rotl32(h + rd32le(p) * XP3, 17) * XP4; p += 4; }
    while (p < end)      { h = rotl32(h + (*p++) * XP5, 11) * XP1; }
    h ^= h >> 15; h *= XP2; h ^= h >> 13; h *= XP3; h ^= h >> 16;
    return h;
}

// ------------------------------------------------------- LZ4 block encode --
//
// Deterministic TPU-greedy spec (shared with ops/lz4_jax.py):
//   HASH(x32le) = (x * 2654435761u) >> 20          (4096-entry table)
//   candidate   = previous position with same hash (insert ALL positions)
//   match iff   cand >= 0, p-cand <= 65535, 4-byte prefix equal
//   mlen        = longest common prefix, capped at min(MAXMATCH, n-5-p)
//   parse       = greedy left-to-right; main loop stops at p+12 > n

static const int LZ4_HASH_BITS = 12;
static const int LZ4_MAXMATCH = 273;

static inline uint32_t lz4_hash(uint32_t x) {
    return (x * 2654435761u) >> (32 - LZ4_HASH_BITS);
}

EXPORT int64_t tk_lz4_block_bound(int64_t n) { return n + n / 255 + 16; }

EXPORT int64_t tk_lz4_block_compress(const uint8_t *src, int64_t n,
                                     uint8_t *dst, int64_t cap) {
    if (n < 0 || cap < tk_lz4_block_bound(n)) return -1;
    int32_t table[1 << LZ4_HASH_BITS];
    memset(table, -1, sizeof(table));
    int64_t anchor = 0, p = 0, o = 0;
    while (p + 12 <= n) {
        uint32_t seq = rd32le(src + p);
        uint32_t h = lz4_hash(seq);
        int64_t cand = table[h];
        table[h] = (int32_t)p;
        if (cand >= 0 && p - cand <= 65535 && rd32le(src + cand) == seq) {
            int64_t mmax = n - 5 - p;
            if (mmax > LZ4_MAXMATCH) mmax = LZ4_MAXMATCH;
            int64_t mlen = 4;
            while (mlen < mmax && src[cand + mlen] == src[p + mlen]) mlen++;
            // emit sequence: literals [anchor, p), then match (offset, mlen)
            int64_t lit = p - anchor;
            uint8_t *tok = dst + o++;
            if (lit >= 15) {
                *tok = 0xF0;
                int64_t rem = lit - 15;
                while (rem >= 255) { dst[o++] = 255; rem -= 255; }
                dst[o++] = (uint8_t)rem;
            } else *tok = (uint8_t)(lit << 4);
            memcpy(dst + o, src + anchor, lit); o += lit;
            uint16_t off = (uint16_t)(p - cand);
            dst[o++] = off & 0xFF; dst[o++] = off >> 8;
            int64_t mrem = mlen - 4;
            if (mrem >= 15) {
                *tok |= 0x0F;
                mrem -= 15;
                while (mrem >= 255) { dst[o++] = 255; mrem -= 255; }
                dst[o++] = (uint8_t)mrem;
            } else *tok |= (uint8_t)mrem;
            // insert-all: match interior positions also enter the table
            for (int64_t q = p + 1; q < p + mlen && q + 4 <= n; q++)
                table[lz4_hash(rd32le(src + q))] = (int32_t)q;
            p += mlen;
            anchor = p;
        } else {
            p += 1;
        }
    }
    // final literal run
    int64_t lit = n - anchor;
    uint8_t *tok = dst + o++;
    if (lit >= 15) {
        *tok = 0xF0;
        int64_t rem = lit - 15;
        while (rem >= 255) { dst[o++] = 255; rem -= 255; }
        dst[o++] = (uint8_t)rem;
    } else *tok = (uint8_t)(lit << 4);
    memcpy(dst + o, src + anchor, lit); o += lit;
    return o;
}

// -------------------------------------------------- LZ4 block encode, fast --
//
// Throughput-first encoder for the CPU provider's default path. Same
// public LZ4 block format (any decoder accepts it), different parse:
//   - 13-bit hash over 5 bytes, insert only at sequence starts plus two
//     interior anchor points (match interiors are skipped — on
//     compressible streams this is the difference between ~100 MB/s for
//     the insert-all deterministic spec above and >500 MB/s here)
//   - miss acceleration: step grows every 64 consecutive misses
//   - 8-bytes-at-a-time match extension (XOR + count-trailing-zeros)
// The deterministic insert-all encoder above remains the
// compression.backend=tpu bit-exactness contract; this one is what the
// broker hot path uses (reference ships vendored lz4 fast mode for the
// same role, rdkafka_lz4.c + lz4.c).

static const int LZ4F_HASH_BITS = 13;

static inline uint32_t lz4_hash5(uint64_t x) {
    return (uint32_t)(((x << 24) * 889523592379ULL) >> (64 - LZ4F_HASH_BITS));
}

EXPORT int64_t tk_lz4_block_compress_fast(const uint8_t *src, int64_t n,
                                          uint8_t *dst, int64_t cap) {
    if (n < 0 || cap < tk_lz4_block_bound(n)) return -1;
    if (n < 13) {   // too short for the main loop: all-literal block
        int64_t o = 0;
        uint8_t *tok = dst + o++;
        *tok = (uint8_t)(n << 4);
        memcpy(dst + o, src, n);
        return o + n;
    }
    int32_t table[1 << LZ4F_HASH_BITS];
    memset(table, -1, sizeof(table));
    int64_t anchor = 0, p = 0, o = 0;
    const int64_t mflimit = n - 12;      // last match must start before
    int64_t misses = 1 << 6;
    while (p <= mflimit) {
        uint64_t seq8;
        memcpy(&seq8, src + p, 8);
        uint32_t h = lz4_hash5(seq8);
        int64_t cand = table[h];
        table[h] = (int32_t)p;
        if (cand < 0 || p - cand > 65535
            || (uint32_t)seq8 != rd32le(src + cand)) {
            p += (misses++ >> 6);
            continue;
        }
        misses = 1 << 6;
        // back-extend over pending literals (free compression)
        while (p > anchor && cand > 0 && src[p - 1] == src[cand - 1]) {
            p--; cand--;
        }
        // forward extension, 8 bytes at a time
        int64_t mlen = 4;
        const int64_t safe = n - 5;      // last 5 bytes must be literals
        {
            int64_t q = p + 4, c = cand + 4;
            while (q + 8 <= safe) {
                uint64_t a, b;
                memcpy(&a, src + q, 8);
                memcpy(&b, src + c, 8);
                uint64_t x = a ^ b;
                if (x) { mlen += __builtin_ctzll(x) >> 3; goto emit; }
                q += 8; c += 8; mlen += 8;
            }
            while (q < safe && src[q] == src[c]) { q++; c++; mlen++; }
        }
    emit:;
        int64_t lit = p - anchor;
        uint8_t *tok = dst + o++;
        if (lit >= 15) {
            *tok = 0xF0;
            int64_t rem = lit - 15;
            while (rem >= 255) { dst[o++] = 255; rem -= 255; }
            dst[o++] = (uint8_t)rem;
        } else *tok = (uint8_t)(lit << 4);
        memcpy(dst + o, src + anchor, lit); o += lit;
        uint16_t off = (uint16_t)(p - cand);
        dst[o++] = off & 0xFF; dst[o++] = off >> 8;
        int64_t mrem = mlen - 4;
        if (mrem >= 15) {
            *tok |= 0x0F;
            mrem -= 15;
            while (mrem >= 255) { dst[o++] = 255; mrem -= 255; }
            dst[o++] = (uint8_t)mrem;
        } else *tok |= (uint8_t)mrem;
        // two interior anchors keep long-range matches findable without
        // the insert-all tax
        if (p + 2 + 8 <= n)
            { uint64_t v; memcpy(&v, src + p + 2, 8);
              table[lz4_hash5(v)] = (int32_t)(p + 2); }
        p += mlen;
        if (p - 2 >= 0 && p - 2 + 8 <= n)
            { uint64_t v; memcpy(&v, src + p - 2, 8);
              table[lz4_hash5(v)] = (int32_t)(p - 2); }
        anchor = p;
    }
    // final literal run
    int64_t lit = n - anchor;
    uint8_t *tok = dst + o++;
    if (lit >= 15) {
        *tok = 0xF0;
        int64_t rem = lit - 15;
        while (rem >= 255) { dst[o++] = 255; rem -= 255; }
        dst[o++] = (uint8_t)rem;
    } else *tok = (uint8_t)(lit << 4);
    memcpy(dst + o, src + anchor, lit); o += lit;
    return o;
}

// ------------------------------------------------------- LZ4 block decode --

// hist = decoded bytes present before dst (for linked-block frames whose
// matches reach into previous blocks).
static int64_t lz4_block_decompress_hist(const uint8_t *src, int64_t n,
                                         uint8_t *dst, int64_t cap,
                                         int64_t hist) {
    int64_t i = 0, o = 0;
    while (i < n) {
        uint8_t tok = src[i++];
        int64_t lit = tok >> 4;
        if (lit == 15) {
            uint8_t b;
            do { if (i >= n) return -1; b = src[i++]; lit += b; } while (b == 255);
        }
        if (i + lit > n) return -1;
        if (o + lit > cap) return -4;
        memcpy(dst + o, src + i, lit); i += lit; o += lit;
        if (i == n) break;            // last sequence: literals only
        if (i + 2 > n) return -1;
        int64_t off = rd16le(src + i); i += 2;
        if (off == 0 || off > o + hist) return -1;
        int64_t mlen = (tok & 0x0F) + 4;
        if ((tok & 0x0F) == 15) {
            uint8_t b;
            do { if (i >= n) return -1; b = src[i++]; mlen += b; } while (b == 255);
        }
        if (o + mlen > cap) return -4;
        const uint8_t *m = dst + o - off;
        if (off >= 16 && o + mlen + 16 <= cap) {
            // wild copy: 16-byte chunks may overshoot mlen by up to 15
            // bytes — safe inside cap, and the tail is overwritten by
            // the next sequence's literals (liblz4's own fast path)
            for (int64_t k = 0; k < mlen; k += 16)
                memcpy(dst + o + k, m + k, 16);
        } else if (off >= 8) {
            // non-overlapping at word granularity: 8-byte strided copy
            // (the byte loop measured ~0.6 GB/s on the fetch path)
            int64_t k = 0;
            for (; k + 8 <= mlen; k += 8) memcpy(dst + o + k, m + k, 8);
            for (; k < mlen; k++) dst[o + k] = m[k];
        } else if (mlen <= off * 2) {
            for (int64_t k = 0; k < mlen; k++) dst[o + k] = m[k];
        } else {
            // small-offset overlap (RLE-ish data): pattern doubling —
            // seed one period, then double the written segment with
            // non-overlapping memcpys (log2 copies instead of a byte
            // loop; this path measured 340 MB/s byte-at-a-time)
            for (int64_t k = 0; k < off; k++) dst[o + k] = m[k];
            int64_t seg = off;
            while (seg < mlen) {
                int64_t c = seg <= mlen - seg ? seg : mlen - seg;
                memcpy(dst + o + seg, dst + o, c);
                seg += c;
            }
        }
        o += mlen;
    }
    return o;
}

EXPORT int64_t tk_lz4_block_decompress(const uint8_t *src, int64_t n,
                                       uint8_t *dst, int64_t cap) {
    return lz4_block_decompress_hist(src, n, dst, cap, 0);
}

// ------------------------------------------------------------- LZ4 frame --
//
// Frame layout per the public LZ4 Frame spec v1.6.1:
//   magic 0x184D2204 | FLG | BD | HC | blocks... | EndMark(0) [| C.Checksum]
// We write: version=01, block-independent, 64KB max block, no content
// checksum/size (FLG=0x60, BD=0x40). The reader accepts any compliant
// frame, incl. linked blocks (decoded into one contiguous buffer so
// back-references across blocks resolve naturally) and content checksums.
// [ref behavior: rdkafka_lz4.c:168,330]

static const uint32_t LZ4F_MAGIC = 0x184D2204u;
static const int64_t LZ4F_BLOCKSIZE = 65536;

EXPORT int64_t tk_lz4f_bound(int64_t n) {
    int64_t blocks = n / LZ4F_BLOCKSIZE + 1;
    return 7 + n + n / 255 + blocks * 20 + 8;
}

static int64_t lz4f_compress_impl(const uint8_t *src, int64_t n,
                                  uint8_t *dst, int64_t cap,
                                  int64_t (*block)(const uint8_t *, int64_t,
                                                   uint8_t *, int64_t)) {
    if (cap < tk_lz4f_bound(n)) return -1;
    int64_t o = 0;
    uint32_t magic = LZ4F_MAGIC;
    memcpy(dst + o, &magic, 4); o += 4;
    dst[o++] = 0x60;  // FLG: version=01, B.Indep=1
    dst[o++] = 0x40;  // BD: 64KB max block size
    dst[o] = (uint8_t)(tk_xxh32(dst + 4, 2, 0) >> 8); o++;  // HC
    for (int64_t pos = 0; pos < n; pos += LZ4F_BLOCKSIZE) {
        int64_t blen = n - pos < LZ4F_BLOCKSIZE ? n - pos : LZ4F_BLOCKSIZE;
        int64_t csize = block(src + pos, blen, dst + o + 4, cap - o - 4);
        if (csize < 0) return -1;
        uint32_t hdr;
        if (csize < blen) {
            hdr = (uint32_t)csize;
        } else {  // incompressible: store raw with high bit set
            hdr = (uint32_t)blen | 0x80000000u;
            memcpy(dst + o + 4, src + pos, blen);
            csize = blen;
        }
        memcpy(dst + o, &hdr, 4); o += 4 + csize;
    }
    uint32_t endmark = 0;
    memcpy(dst + o, &endmark, 4); o += 4;
    return o;
}

EXPORT int64_t tk_lz4f_compress(const uint8_t *src, int64_t n,
                                uint8_t *dst, int64_t cap) {
    return lz4f_compress_impl(src, n, dst, cap, tk_lz4_block_compress);
}

// Fast-parse frame: same spec-compliant wire format, throughput-first
// block encoder (the broker hot path's default).
EXPORT int64_t tk_lz4f_compress_fast(const uint8_t *src, int64_t n,
                                     uint8_t *dst, int64_t cap) {
    return lz4f_compress_impl(src, n, dst, cap, tk_lz4_block_compress_fast);
}

EXPORT int64_t tk_lz4f_decompress(const uint8_t *src, int64_t n,
                                  uint8_t *dst, int64_t cap) {
    int64_t i = 0, o = 0;
    if (n < 7) return -1;
    uint32_t magic = rd32le(src);
    if (magic != LZ4F_MAGIC) return -2;
    i = 4;
    uint8_t flg = src[i], bd = src[i + 1];
    (void)bd;
    if ((flg >> 6) != 1) return -3;            // version
    bool has_csize = flg & 0x08, has_cchk = flg & 0x04, has_dict = flg & 0x01;
    bool has_bchk = flg & 0x10;
    i += 2;
    if (has_csize) i += 8;
    if (has_dict) i += 4;
    i += 1;  // HC (not verified on read; transport has its own integrity)
    if (i > n) return -1;
    while (true) {
        if (i + 4 > n) return -1;
        uint32_t hdr = rd32le(src + i); i += 4;
        if (hdr == 0) break;  // EndMark
        bool raw = hdr & 0x80000000u;
        int64_t bsz = hdr & 0x7FFFFFFF;
        if (i + bsz > n) return -1;
        if (raw) {
            if (o + bsz > cap) return -4;
            memcpy(dst + o, src + i, bsz); o += bsz;
        } else {
            int64_t dsz = lz4_block_decompress_hist(src + i, bsz, dst + o,
                                                    cap - o, o);
            if (dsz < 0) return dsz == -4 ? -4 : -5;
            o += dsz;
        }
        i += bsz;
        if (has_bchk) i += 4;
    }
    if (has_cchk) {
        if (i + 4 > n) return -1;
        if (rd32le(src + i) != tk_xxh32(dst, o, 0)) return -6;
    }
    return o;
}

// --------------------------------------------------------------- snappy ---
//
// Raw snappy block format (public spec: format_description.txt):
//   preamble = uvarint uncompressed length
//   elements: tag&3 == 0 literal / 1 copy-1byte-offset / 2 copy-2byte / 3 copy-4byte
// Encoder is a fast-parse greedy scheme (r5): uncapped matches emitted
// as chained <=64-byte copy tags, sparse table seeding, miss
// acceleration — any spec-valid stream is legal snappy, and both the
// fused and 3-phase paths share THIS function so their wire bytes
// stay identical (test_0122). A TPU snappy provider would need its
// own deterministic spec, as the lz4 one has.
// [ref: vendored src/snappy.c; java-framing compat handled in msgset reader]

static const int SN_HASH_BITS = 12;

static inline uint32_t sn_hash(uint32_t x) {
    return (x * 2654435761u) >> (32 - SN_HASH_BITS);
}

EXPORT int64_t tk_snappy_bound(int64_t n) { return 32 + n + n / 6; }

EXPORT int64_t tk_snappy_compress(const uint8_t *src, int64_t n,
                                  uint8_t *dst, int64_t cap) {
    if (cap < tk_snappy_bound(n)) return -1;
    int64_t o = 0;
    // preamble: uncompressed length uvarint
    uint64_t v = (uint64_t)n;
    do { uint8_t b = v & 0x7F; v >>= 7; dst[o++] = b | (v ? 0x80 : 0); } while (v);

    auto emit_literal = [&](int64_t from, int64_t len) {
        while (len > 0) {
            int64_t l = len;  // snappy literals can be up to 2^32; chunk at 2^16 for 2-byte len
            if (l > 65536) l = 65536;
            if (l <= 60) dst[o++] = (uint8_t)((l - 1) << 2);
            else if (l <= 256) { dst[o++] = 60 << 2; dst[o++] = (uint8_t)(l - 1); }
            else { dst[o++] = 61 << 2; dst[o++] = (uint8_t)((l - 1) & 0xFF);
                   dst[o++] = (uint8_t)((l - 1) >> 8); }
            memcpy(dst + o, src + from, l); o += l; from += l; len -= l;
        }
    };
    auto emit_copy = [&](int64_t off, int64_t len) {
        // len in [4,64]; use copy-1 when len<=11 && off<2048, else copy-2
        if (len <= 11 && off < 2048) {
            dst[o++] = (uint8_t)(1 | ((len - 4) << 2) | ((off >> 8) << 5));
            dst[o++] = (uint8_t)(off & 0xFF);
        } else {
            dst[o++] = (uint8_t)(2 | ((len - 1) << 2));
            dst[o++] = (uint8_t)(off & 0xFF); dst[o++] = (uint8_t)(off >> 8);
        }
    };

    // fast-parse loop (r5; the same techniques as
    // tk_lz4_block_compress_fast): 8-byte XOR/ctz match extension,
    // uncapped matches emitted as chained <=64-byte copy tags (what
    // libsnappy does), sparse table seeding at match ends instead of
    // insert-all over interiors, and miss-acceleration strides through
    // incompressible runs. The old insert-all loop measured 1.8 us per
    // 1KB record in the fused batch builder vs lz4's 0.2.
    int32_t table[1 << SN_HASH_BITS];
    memset(table, -1, sizeof(table));
    int64_t anchor = 0, p = 0;
    while (p + 12 <= n) {
        uint32_t seq = rd32le(src + p);
        uint32_t h = sn_hash(seq);
        int64_t cand = table[h];
        table[h] = (int32_t)p;
        if (cand >= 0 && p - cand <= 65535 && rd32le(src + cand) == seq) {
            int64_t maxm = n - p;
            int64_t mlen = 4;
            while (mlen + 8 <= maxm) {
                uint64_t a, b;
                memcpy(&a, src + cand + mlen, 8);
                memcpy(&b, src + p + mlen, 8);
                uint64_t x = a ^ b;
                if (x) { mlen += __builtin_ctzll(x) >> 3; break; }
                mlen += 8;
            }
            if (mlen + 8 > maxm)
                while (mlen < maxm && src[cand + mlen] == src[p + mlen])
                    mlen++;
            emit_literal(anchor, p - anchor);
            int64_t off = p - cand, rem = mlen;
            while (rem >= 68) { emit_copy(off, 64); rem -= 64; }
            if (rem > 64) { emit_copy(off, 60); rem -= 60; }
            emit_copy(off, rem);           /* rem in [4, 64] */
            int64_t end = p + mlen;
            if (end - 1 > p && end + 3 <= n)
                table[sn_hash(rd32le(src + end - 1))] = (int32_t)(end - 1);
            if (end - 2 > p && end + 2 <= n)
                table[sn_hash(rd32le(src + end - 2))] = (int32_t)(end - 2);
            p = end;
            anchor = p;
        } else {
            p += 1 + ((uint32_t)(p - anchor) >> 7);
        }
    }
    emit_literal(anchor, n - anchor);
    return o;
}

EXPORT int64_t tk_snappy_uncompressed_length(const uint8_t *src, int64_t n) {
    uint64_t v = 0; int shift = 0; int64_t i = 0;
    while (true) {
        if (i >= n || shift > 35) return -1;
        uint8_t b = src[i++];
        v |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) return (int64_t)v;
        shift += 7;
    }
}

EXPORT int64_t tk_snappy_decompress(const uint8_t *src, int64_t n,
                                    uint8_t *dst, int64_t cap) {
    // skip preamble
    int64_t i = 0;
    while (i < n && (src[i] & 0x80)) i++;
    if (i++ >= n) return -1;
    int64_t o = 0;
    while (i < n) {
        uint8_t tag = src[i++];
        int t = tag & 3;
        if (t == 0) {                       // literal
            int64_t len = (tag >> 2) + 1;
            if (len > 60) {
                int nb = (int)len - 60;
                if (i + nb > n) return -1;
                len = 0;
                for (int k = nb - 1; k >= 0; k--) len = (len << 8) | src[i + k];
                len += 1; i += nb;
            }
            if (i + len > n || o + len > cap) return -1;
            memcpy(dst + o, src + i, len); i += len; o += len;
        } else {
            int64_t len, off;
            if (t == 1) {
                len = ((tag >> 2) & 7) + 4;
                if (i >= n) return -1;
                off = ((int64_t)(tag >> 5) << 8) | src[i++];
            } else if (t == 2) {
                len = (tag >> 2) + 1;
                if (i + 2 > n) return -1;
                off = rd16le(src + i); i += 2;
            } else {
                len = (tag >> 2) + 1;
                if (i + 4 > n) return -1;
                off = rd32le(src + i); i += 4;
            }
            if (off == 0 || off > o || o + len > cap) return -1;
            const uint8_t *m = dst + o - off;
            for (int64_t k = 0; k < len; k++) dst[o + k] = m[k];
            o += len;
        }
    }
    return o;
}

// ---------------------------------------------------- v2 record framing --
//
// Frame a run of messages into the MessageSet v2 records wire layout
// (reference hot loop: rd_kafka_msgset_writer_write_msg_v2,
// rdkafka_msgset_writer.c:653 — per-record varint framing).  One call per
// batch; the GIL is released for the duration, so framing overlaps the
// app thread's produce() loop.  Headers are framed by the Python fallback.
//
// Layout per record: [len vi][attr=0][ts_delta vi][offset_delta vi]
//                    [klen vi][key][vlen vi][value][header_cnt vi = 0]

static inline int vi_size(int64_t v) {
    uint64_t u = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);  // zigzag
    int n = 1;
    while (u >= 0x80) { u >>= 7; n++; }
    return n;
}

static inline uint8_t *vi_put(uint8_t *p, int64_t v) {
    uint64_t u = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
    while (u >= 0x80) { *p++ = (uint8_t)(u | 0x80); u >>= 7; }
    *p++ = (uint8_t)u;
    return p;
}

// bytes needed in the worst case for `count` records over `payload_bytes`
EXPORT int64_t tk_frame_v2_bound(int64_t payload_bytes, int count) {
    return payload_bytes + (int64_t)count * 40 + 64;
}

// base: concatenated key||value bytes per message, in order
// klens/vlens: -1 = null
// ts_deltas: timestamp - first_timestamp per message
// Returns bytes written, or -1 on capacity shortfall.
EXPORT int64_t tk_frame_v2(const uint8_t *base, const int32_t *klens,
                           const int32_t *vlens, const int64_t *ts_deltas,
                           int count, uint8_t *out, int64_t cap) {
    uint8_t *p = out;
    const uint8_t *end = out + cap;
    const uint8_t *src = base;
    for (int i = 0; i < count; i++) {
        int64_t kl = klens[i], vl = vlens[i];
        int64_t body = 1 + vi_size(ts_deltas[i]) + vi_size(i)
                     + vi_size(kl) + (kl > 0 ? kl : 0)
                     + vi_size(vl) + (vl > 0 ? vl : 0)
                     + 1;                       // header count varint(0)
        if (p + vi_size(body) + body > end) return -1;
        p = vi_put(p, body);
        *p++ = 0;                               // record attributes
        p = vi_put(p, ts_deltas[i]);
        p = vi_put(p, i);                       // offset delta
        p = vi_put(p, kl);
        if (kl > 0) { memcpy(p, src, kl); p += kl; src += kl; }
        p = vi_put(p, vl);
        if (vl > 0) { memcpy(p, src, vl); p += vl; src += vl; }
        *p++ = 0;                               // varint(0) headers
    }
    return p - out;
}

// Run-native framer for the widened fast lane: per-record timestamps
// (0 = unset -> now_ms, matching the slow path's "timestamp and
// timestamp > 0 else now" rule) and PRE-ENCODED header blobs (each
// blob already carries its header-count varint + per-header framing —
// the enqueue lane encodes them once at produce() time).  tss/hbuf/
// hlens may be NULL: NULL tss means every record stamps now_ms (zero
// deltas), NULL hlens means every record writes varint(0) headers.
// first/max effective timestamps come back for the v2 batch header.
EXPORT int64_t tk_frame_v2_run(const uint8_t *base, const int32_t *klens,
                               const int32_t *vlens, const int64_t *tss,
                               int64_t now_ms, const uint8_t *hbuf,
                               const int32_t *hlens, int count,
                               uint8_t *out, int64_t cap,
                               int64_t *first_ts, int64_t *max_ts) {
    uint8_t *p = out;
    const uint8_t *end = out + cap;
    const uint8_t *src = base;
    const uint8_t *hsrc = hbuf;
    int64_t f = now_ms, mx = now_ms;
    for (int i = 0; i < count; i++) {
        int64_t ts = (tss && tss[i] > 0) ? tss[i] : now_ms;
        if (i == 0) { f = ts; mx = ts; }
        else if (ts > mx) mx = ts;
        int64_t d = ts - f;                     // may be negative
        int64_t kl = klens[i], vl = vlens[i];
        int64_t hl = hlens ? hlens[i] : 0;
        int64_t body = 1 + vi_size(d) + vi_size(i)
                     + vi_size(kl) + (kl > 0 ? kl : 0)
                     + vi_size(vl) + (vl > 0 ? vl : 0)
                     + (hl > 0 ? hl : 1);
        if (p + vi_size(body) + body > end) return -1;
        p = vi_put(p, body);
        *p++ = 0;                               // record attributes
        p = vi_put(p, d);
        p = vi_put(p, i);                       // offset delta
        p = vi_put(p, kl);
        if (kl > 0) { memcpy(p, src, kl); p += kl; src += kl; }
        p = vi_put(p, vl);
        if (vl > 0) { memcpy(p, src, vl); p += vl; src += vl; }
        if (hl > 0) { memcpy(p, hsrc, hl); p += hl; hsrc += hl; }
        else *p++ = 0;                          // varint(0) headers
    }
    if (first_ts) *first_ts = f;
    if (max_ts) *max_ts = mx;
    return p - out;
}

// ------------------------------------------------------ batched parallel --
//
// The provider seam (SURVEY.md §3.2) hands MANY independent per-partition
// batches at once; unlike the reference — which compresses each batch
// sequentially on its broker thread (rdkafka_msgset_writer.c:1129) — the
// batch axis parallelizes across cores here.  Inputs are packed into one
// contiguous base buffer with offsets; outputs go to caller-provided
// per-item regions (capacity >= tk_lz4f_bound).

#include <thread>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <cstdio>
#include <pthread.h>
#include <semaphore.h>
#include <time.h>

// The CPU the pool's workers spent on the calling thread's calls: each
// worker reads its own thread clock around its share of a call, and the
// caller adds the sum here as the call returns.  No reading outside
// (/proc/self/task) can split a parked worker's CPU by call, so this is
// the record of it; tk_pool_cpu_take() hands it over.
static thread_local int64_t tl_pool_cpu_ns = 0;

static inline int64_t thread_cpu_ns() {
    timespec ts;
    clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
    return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

// The CPU nanoseconds of the pool workers that served the calling
// thread's *_many calls since its last take; zeroes the account.
EXPORT int64_t tk_pool_cpu_take() {
    int64_t v = tl_pool_cpu_ns;
    tl_pool_cpu_ns = 0;
    return v;
}

// Each participant of a call gets at least this much input.  A woken
// worker costs CPU beyond its share, more the smaller the share, and
// the client pays in CPU: smaller grains only buy wall time (the sweep
// in PERF.md).
static const int64_t POOL_GRAIN = 1 << 20;

EXPORT int64_t tk_pool_grain() { return POOL_GRAIN; }

// How often the pool engages, process-wide: *_many calls, calls with
// one participant, calls that found the pool held by another call and
// so ran alone, and worker participations.
static std::atomic<int64_t> pool_calls{0}, pool_solo_calls{0},
    pool_busy_calls{0}, pool_wakes{0};

// out[0..3] = calls, solo calls, busy calls, worker participations.
EXPORT void tk_pool_stats(int64_t *out) {
    out[0] = pool_calls.load(std::memory_order_relaxed);
    out[1] = pool_solo_calls.load(std::memory_order_relaxed);
    out[2] = pool_busy_calls.load(std::memory_order_relaxed);
    out[3] = pool_wakes.load(std::memory_order_relaxed);
}

// One process-wide set of parked workers that serves one call at a
// time.  A call that wants k participants posts its work, then wakes
// workers 0 .. k-2, each on a semaphore of its own, so every wake
// reaches the worker it names; it runs the work too, and returns once
// each woken worker has left the work.
struct Pool {
    std::mutex mu;
    std::condition_variable done;
    void (*fn)(void *) = nullptr;
    void *arg = nullptr;
    int pending = 0;         // woken workers still inside the call
    int64_t cpu = 0;         // their thread CPU in it
    int size = 0;            // workers started
    sem_t *go = nullptr;     // one a worker
    std::atomic<bool> held{false};
};

// One worker a core less one (the caller is the last participant); read
// once, since hardware_concurrency() reads /sys on every call.
static int pool_size() {
    static const int n = [] {
        unsigned hw = std::thread::hardware_concurrency();
        return hw ? (int)hw - 1 : 3;
    }();
    return n;
}

static void pool_worker(Pool *p, int id) {
    char name[16];
    snprintf(name, sizeof name, "tk-pool/%d", id);
    pthread_setname_np(pthread_self(), name);
    for (;;) {
        while (sem_wait(&p->go[id]) != 0) {
        }
        int64_t c0 = thread_cpu_ns();
        p->fn(p->arg);
        int64_t c = thread_cpu_ns() - c0;
        std::lock_guard<std::mutex> lk(p->mu);
        p->cpu += c;
        if (--p->pending == 0) p->done.notify_one();
    }
}

// Built at the first call that wants a worker and never destroyed, so
// nothing joins parked workers at exit.  A forked child holds none of
// its parent's workers: it drops the pool and builds its own.
static std::atomic<Pool *> g_pool{nullptr};
static std::mutex g_pool_build;

static void pool_fork_prepare() { g_pool_build.lock(); }
static void pool_fork_parent() { g_pool_build.unlock(); }
static void pool_fork_child() {
    g_pool.store(nullptr, std::memory_order_relaxed);
    g_pool_build.unlock();
}

static Pool *get_pool() {
    Pool *p = g_pool.load(std::memory_order_acquire);
    if (p) return p;
    std::lock_guard<std::mutex> g(g_pool_build);
    p = g_pool.load(std::memory_order_relaxed);
    if (p) return p;
    static const bool forks = (pthread_atfork(pool_fork_prepare,
                                              pool_fork_parent,
                                              pool_fork_child), true);
    (void)forks;
    p = new Pool();
    int n = pool_size();
    p->go = new sem_t[n];
    try {
        for (; p->size < n; p->size++) {
            sem_init(&p->go[p->size], 0, 0);
            std::thread(pool_worker, p, p->size).detach();
        }
    } catch (...) {
        // no more threads to be had: serve with the workers started
    }
    g_pool.store(p, std::memory_order_release);
    return p;
}

// Items [0, n) of a *_many call holding `bytes` of input, each running
// work(): over one participant per POOL_GRAIN of input, at most n and
// at most `nthreads` (0: the pool's workers and the caller).  One
// participant, or a pool held by another call, runs on the caller.
template <class Work>
static void run_pool(int n, int64_t bytes, int nthreads, Work &work) {
    pool_calls.fetch_add(1, std::memory_order_relaxed);
    int64_t k = bytes / POOL_GRAIN;
    int64_t cap = nthreads > 0 ? nthreads : pool_size() + 1;
    if (k > cap) k = cap;
    if (k > n) k = n;
    Pool *p = k > 1 ? get_pool() : nullptr;
    if (p && k > p->size + 1) k = p->size + 1;
    if (k <= 1) {
        pool_solo_calls.fetch_add(1, std::memory_order_relaxed);
        work();
        return;
    }
    bool idle = false;
    if (!p->held.compare_exchange_strong(idle, true,
                                         std::memory_order_acquire)) {
        pool_busy_calls.fetch_add(1, std::memory_order_relaxed);
        work();
        return;
    }
    p->fn = [](void *w) { (*static_cast<Work *>(w))(); };
    p->arg = &work;
    {
        std::lock_guard<std::mutex> lk(p->mu);
        p->pending = (int)k - 1;
        p->cpu = 0;
    }
    for (int i = 0; i < k - 1; i++) sem_post(&p->go[i]);
    work();
    int64_t cpu;
    {
        std::unique_lock<std::mutex> lk(p->mu);
        p->done.wait(lk, [&] { return p->pending == 0; });
        cpu = p->cpu;
    }
    p->held.store(false, std::memory_order_release);
    pool_wakes.fetch_add(k - 1, std::memory_order_relaxed);
    tl_pool_cpu_ns += cpu;
}

static int64_t total_len(const int64_t *lens, int n) {
    int64_t t = 0;
    for (int i = 0; i < n; i++) t += lens[i];
    return t;
}

static void lz4f_compress_many_impl(
    const uint8_t *base, const int64_t *offs, const int64_t *lens, int n,
    uint8_t *outbase, const int64_t *out_offs, int64_t *out_lens,
    int nthreads,
    int64_t (*one)(const uint8_t *, int64_t, uint8_t *, int64_t)) {
    if (n <= 0) return;
    std::atomic<int> next(0);
    auto work = [&]() {
        int i;
        while ((i = next.fetch_add(1)) < n) {
            out_lens[i] = one(base + offs[i], lens[i],
                              outbase + out_offs[i],
                              tk_lz4f_bound(lens[i]));
        }
    };
    run_pool(n, total_len(lens, n), nthreads, work);
}

EXPORT void tk_lz4f_compress_many(const uint8_t *base, const int64_t *offs,
                                  const int64_t *lens, int n,
                                  uint8_t *outbase, const int64_t *out_offs,
                                  int64_t *out_lens, int nthreads) {
    lz4f_compress_many_impl(base, offs, lens, n, outbase, out_offs,
                            out_lens, nthreads, tk_lz4f_compress);
}

EXPORT void tk_lz4f_compress_many_fast(
    const uint8_t *base, const int64_t *offs, const int64_t *lens, int n,
    uint8_t *outbase, const int64_t *out_offs, int64_t *out_lens,
    int nthreads) {
    lz4f_compress_many_impl(base, offs, lens, n, outbase, out_offs,
                            out_lens, nthreads, tk_lz4f_compress_fast);
}

EXPORT void tk_snappy_compress_many(const uint8_t *base, const int64_t *offs,
                                    const int64_t *lens, int n,
                                    uint8_t *outbase, const int64_t *out_offs,
                                    int64_t *out_lens, int nthreads) {
    if (n <= 0) return;
    std::atomic<int> next(0);
    auto work = [&]() {
        int i;
        while ((i = next.fetch_add(1)) < n) {
            out_lens[i] = tk_snappy_compress(base + offs[i], lens[i],
                                             outbase + out_offs[i],
                                             tk_snappy_bound(lens[i]));
        }
    };
    run_pool(n, total_len(lens, n), nthreads, work);
}

// Exact decompressed size by a write-free sequence walk (the lz4 frame
// format carries no content size with our FLG; a wrong capacity guess
// costs full re-decodes — the snappy preamble-length pattern, but
// computed). ~#sequences work, not #bytes.
static int64_t lz4_block_decompressed_size(const uint8_t *src, int64_t n) {
    int64_t i = 0, o = 0;
    while (i < n) {
        uint8_t tok = src[i++];
        int64_t lit = tok >> 4;
        if (lit == 15) {
            uint8_t b;
            do { if (i >= n) return -1; b = src[i++]; lit += b; } while (b == 255);
        }
        if (i + lit > n) return -1;
        i += lit; o += lit;
        if (i == n) break;
        if (i + 2 > n) return -1;
        i += 2;
        int64_t mlen = (tok & 0x0F) + 4;
        if ((tok & 0x0F) == 15) {
            uint8_t b;
            do { if (i >= n) return -1; b = src[i++]; mlen += b; } while (b == 255);
        }
        o += mlen;
    }
    return o;
}

EXPORT int64_t tk_lz4f_decompressed_size(const uint8_t *src, int64_t n) {
    int64_t i = 0, o = 0;
    // the result sizes an allocation BEFORE any decode validates the
    // data, and the input is untrusted network bytes — clamp to the
    // lz4 format's own max expansion (~255:1 via run-length extension
    // bytes) so a corrupt frame cannot request terabytes
    const int64_t max_out = n * 256 + (64 << 10);
    if (n < 7) return -1;
    if (rd32le(src) != LZ4F_MAGIC) return -2;
    i = 4;
    uint8_t flg = src[i];
    if ((flg >> 6) != 1) return -3;
    bool has_csize = flg & 0x08, has_dict = flg & 0x01;
    bool has_bchk = flg & 0x10;
    i += 2;
    if (has_csize) {
        // content size present: trust the header field within bounds
        if (i + 8 > n) return -1;
        int64_t cs;
        memcpy(&cs, src + i, 8);
        if (cs < 0 || cs > max_out) return -6;
        return cs;
    }
    if (has_dict) i += 4;
    i += 1;
    while (true) {
        if (i + 4 > n) return -1;
        uint32_t hdr = rd32le(src + i); i += 4;
        if (hdr == 0) break;
        bool raw = hdr & 0x80000000u;
        int64_t bsz = hdr & 0x7FFFFFFF;
        if (i + bsz > n) return -1;
        if (raw) o += bsz;
        else {
            int64_t d = lz4_block_decompressed_size(src + i, bsz);
            if (d < 0) return -5;
            o += d;
        }
        if (o > max_out) return -6;
        i += bsz;
        if (has_bchk) i += 4;
    }
    return o;
}

EXPORT void tk_lz4f_decompressed_size_many(const uint8_t *base,
                                           const int64_t *offs,
                                           const int64_t *lens, int n,
                                           int64_t *out_sizes) {
    for (int i = 0; i < n; i++)
        out_sizes[i] = tk_lz4f_decompressed_size(base + offs[i], lens[i]);
}

EXPORT void tk_lz4f_decompress_many(const uint8_t *base, const int64_t *offs,
                                    const int64_t *lens, int n,
                                    uint8_t *outbase, const int64_t *out_offs,
                                    const int64_t *out_caps,
                                    int64_t *out_lens, int nthreads) {
    if (n <= 0) return;
    std::atomic<int> next(0);
    auto work = [&]() {
        int i;
        while ((i = next.fetch_add(1)) < n) {
            out_lens[i] = tk_lz4f_decompress(base + offs[i], lens[i],
                                             outbase + out_offs[i],
                                             out_caps[i]);
        }
    };
    run_pool(n, total_len(lens, n), nthreads, work);
}

EXPORT void tk_snappy_decompress_many(const uint8_t *base, const int64_t *offs,
                                      const int64_t *lens, int n,
                                      uint8_t *outbase,
                                      const int64_t *out_offs,
                                      const int64_t *out_caps,
                                      int64_t *out_lens, int nthreads) {
    if (n <= 0) return;
    std::atomic<int> next(0);
    auto work = [&]() {
        int i;
        while ((i = next.fetch_add(1)) < n) {
            out_lens[i] = tk_snappy_decompress(base + offs[i], lens[i],
                                               outbase + out_offs[i],
                                               out_caps[i]);
        }
    };
    run_pool(n, total_len(lens, n), nthreads, work);
}

// ---------------------------------------------------------------------------
// MessageSet v2 record parsing (the consumer hot loop: the Python
// varint walk was ~40% of consume time). Emits 8 int64 fields per
// record into `out`:
//   [ts_delta, off_delta, key_off, key_len, val_off, val_len,
//    hdrs_off, n_headers]
// key/val offsets index into the records payload; -1 length = null.
// Returns the record count parsed, or -1 on malformed input.
static inline int vi_dec(const uint8_t *p, const uint8_t *end, int64_t *out) {
    uint64_t u = 0;
    int shift = 0, i = 0;
    while (p + i < end && i < 10) {
        uint8_t b = p[i++];
        u |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            *out = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // zig-zag
            return i;
        }
        shift += 7;
    }
    return -1;
}

EXPORT int64_t tk_parse_v2(const uint8_t *buf, int64_t n, int64_t max_recs,
                           int64_t *out) {
    // NOTE: all bounds checks are in LENGTH space (len > rend - p), not
    // pointer space (p + len > rend) — the lengths come off the wire
    // and p + INT64_MAX is undefined behavior the optimizer may exploit
    const uint8_t *p = buf, *end = buf + n;
    int64_t cnt = 0;
    while (p < end && cnt < max_recs) {
        int64_t rec_len;
        int c = vi_dec(p, end, &rec_len);
        if (c < 0 || rec_len < 0) return -1;
        p += c;
        if (rec_len > end - p) return -1;
        const uint8_t *rend = p + rec_len;
        if (p >= rend) return -1;
        p += 1;                                   // record attributes
        int64_t ts_delta, off_delta, klen, vlen, nh;
        if ((c = vi_dec(p, rend, &ts_delta)) < 0) return -1;
        p += c;
        if ((c = vi_dec(p, rend, &off_delta)) < 0) return -1;
        p += c;
        if ((c = vi_dec(p, rend, &klen)) < 0) return -1;
        p += c;
        int64_t key_off = p - buf;
        if (klen > 0) {
            if (klen > rend - p) return -1;
            p += klen;
        }
        if ((c = vi_dec(p, rend, &vlen)) < 0) return -1;
        p += c;
        int64_t val_off = p - buf;
        if (vlen > 0) {
            if (vlen > rend - p) return -1;
            p += vlen;
        }
        if ((c = vi_dec(p, rend, &nh)) < 0) return -1;
        p += c;
        int64_t hdrs_off = p - buf;           // first header record
        if (nh < 0) return -1;
        // validate the header section stays inside the record — the
        // Python side re-walks it unnarrowed, so a malformed length
        // must fail HERE, not silently read the next record's bytes
        for (int64_t h = 0; h < nh; h++) {
            int64_t hkl, hvl;
            if ((c = vi_dec(p, rend, &hkl)) < 0 || hkl < 0) return -1;
            p += c;
            if (hkl > rend - p) return -1;
            p += hkl;
            if ((c = vi_dec(p, rend, &hvl)) < 0) return -1;
            p += c;
            if (hvl > 0) {
                if (hvl > rend - p) return -1;
                p += hvl;
            }
        }
        if (p != rend) return -1;             // trailing garbage
        int64_t *row = out + cnt * 8;
        row[0] = ts_delta; row[1] = off_delta;
        row[2] = key_off;  row[3] = klen;
        row[4] = val_off;  row[5] = vlen;
        row[6] = hdrs_off; row[7] = nh;
        cnt++;
    }
    return (p == end || cnt == max_recs) ? cnt : -1;
}
