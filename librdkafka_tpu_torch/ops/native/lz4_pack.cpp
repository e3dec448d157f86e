// The device lz4 route's staging, built into _codec.so after codec.cpp
// (ops/native/build.py).  A file of its own: the enqueue lane links
// codec.cpp too and needs none of it, and appended to codec.cpp it moved
// that file's later functions in both libraries.
#include <cstdint>
#include <cstring>

#define EXPORT extern "C" __attribute__((visibility("default")))

// One round of the port's device lz4 route (ops/lz4_torch.py pack_lz4),
// written straight into its staging slot `dst`: buffer i from a 16-byte
// aligned offset, with zeros up to the next one (its 64 KB LZ4F blocks
// lie back to back); then each block's offset in the slot (int64) and
// length (int32, and one zero int32 more when the block count is odd).
// The layout of plan_lz4.  Returns the bytes written, or -1 (nothing
// written) when they would exceed `cap`.
EXPORT int64_t tk_lz4_pack_round(const uint8_t *const *bufs,
                                 const int64_t *lens, int n, uint8_t *dst,
                                 int64_t cap) {
    const int64_t block = 65536;
    int64_t flat = 0, nblocks = 0;
    for (int i = 0; i < n; i++) {
        flat += (lens[i] + 15) & ~int64_t{15};
        nblocks += (lens[i] + block - 1) / block;
    }
    const int64_t total = flat + 8 * nblocks + 4 * (nblocks + (nblocks & 1));
    if (total > cap) return -1;
    uint8_t *offs = dst + flat, *blens = offs + 8 * nblocks;
    int64_t pos = 0, b = 0;
    for (int i = 0; i < n; i++) {
        const int64_t len = lens[i], padded = (len + 15) & ~int64_t{15};
        if (len) memcpy(dst + pos, bufs[i], len);
        memset(dst + pos + len, 0, padded - len);
        for (int64_t o = 0; o < len; o += block, b++) {
            const int64_t at = pos + o;
            const int32_t bl = (int32_t)(len - o < block ? len - o : block);
            memcpy(offs + 8 * b, &at, 8);
            memcpy(blens + 4 * b, &bl, 4);
        }
        pos += padded;
    }
    if (nblocks & 1) memset(blens + 4 * nblocks, 0, 4);
    return total;
}
