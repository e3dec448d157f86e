// crc_fold.cuh — the slice-by-8 CRC fold shared by the port's kernels
// (crc_rows.cu, lz4_rows.cu).
//
// A polynomial's constants are one block of kPolyWords uint32 words, built
// on the host by ops/crc32c_torch.py (_kernel_consts): its slice-by-8 step
// as 16 nibble tables; nibble zero-shift tables over kPiece << k bytes for
// k < kShifts; then M^-m for m = 0..15 as 32 columns each.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPiece = 64;                      // bytes folded by a thread
constexpr int kShifts = 9;                      // kPiece << k, k = 0..8
constexpr int kShiftWords = 8 * 16;             // one nibble-table shift
constexpr int kShiftOffset = 2 * kShiftWords;
constexpr int kInvOffset = kShiftOffset + kShifts * kShiftWords;
constexpr int kPolyWords = kInvOffset + 16 * 32;
static_assert(kPolyWords % 4 == 0, "copies move 16-byte multiples");

// Bytes [lo, hi) of a 32-bit word, clamped to 0..4, as a mask.
__device__ __forceinline__ uint32_t byte_mask(int lo, int hi) {
  lo = lo < 0 ? 0 : (lo > 4 ? 4 : lo);
  hi = hi < 0 ? 0 : (hi > 4 ? 4 : hi);
  if (hi <= lo) return 0;
  return static_cast<uint32_t>(((1ull << (8 * hi)) - 1) &
                               ~((1ull << (8 * lo)) - 1));
}

// Advance v through a fixed run of zero bytes: 8 lookups of an (8, 16)
// nibble table.  Each 16-word row spans 16 banks, so a warp's lookups never
// conflict (a byte table's would, about 3.5-way).
__device__ __forceinline__ uint32_t shift(const uint32_t* s, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) r ^= s[k * 16 + ((v >> (4 * k)) & 15)];
  return r;
}

// One slice-by-8 step: fold the 8 bytes w0 (bytes 0..3, little-endian) and
// w1 (bytes 4..7) into crc, as 16 nibble lookups.  A byte table's lookups
// conflict about 4-way on the banks; nibble lookups never do, so twice the
// lookups cost half the shared-memory cycles.
__device__ __forceinline__ uint32_t step8(const uint32_t* t, uint32_t crc,
                                          uint32_t w0, uint32_t w1) {
  return shift(t, crc ^ w0) ^ shift(t + kShiftWords, w1);
}

// Fold the 16 bytes at virtual position g (16-aligned) into crc, with the
// bytes outside the segment [start, end) masked to zero; `inject` XORs ~0
// into the first min(4, n) real bytes.
__device__ __forceinline__ uint32_t fold16(const uint32_t* tab, uint32_t crc,
                                           uint4 v, int g, int start, int end,
                                           bool inject) {
  if (g < start + (inject ? 4 : 0) || g + 16 > end) {
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gw = g + 4 * i;
      w[i] &= byte_mask(start - gw, end - gw);
      if (inject) {
        const int hi = start + 4 < end ? start + 4 : end;
        w[i] ^= byte_mask(start - gw, hi - gw);
      }
    }
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  crc = step8(tab, crc, v.x, v.y);
  return step8(tab, crc, v.z, v.w);
}

// Apply a GF(2) 32x32 matrix, given as 32 columns in shared memory.
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* cols,
                                              uint32_t v) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc ^= (0u - ((v >> i) & 1u)) & cols[i];
  return acc;
}

}  // namespace
