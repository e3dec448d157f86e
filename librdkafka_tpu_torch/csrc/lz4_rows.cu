// lz4_rows.cu — LZ4 block compression of many rows, with a fused CRC32C
// epilogue, on Hopper (sm_90a).
//
// Replaces device functions of librdkafka_tpu/ops/lz4_jax.py:
//   E  _lz4_block_one + _jit_for / lz4_block_compress_many (:63-196,
//      :227-236, :360-369): the deterministic insert-all greedy encoder
//   F  _fused_fn / _fused_for (:239-285, jit at :282): E, then the CRC32C of
//      the compressed row and of the raw row in the same launch
// and, inside F, computes what D (_crc_kernel, crc32c_jax.py:99-169)
// computes: the standard CRC32C of a row from its length.
//
// The function (the spec of tk_lz4_block_compress, ops/native/codec.cpp):
//   HASH(x32le) = (x * 2654435761) >> 20, a 4096-entry table of positions;
//   every position the parse passes enters the table in order (insert-all);
//   a match needs cand >= 0, p - cand <= 65535 and an equal 4-byte prefix;
//   mlen = the common prefix, capped at min(273, n - 5 - p); the greedy
//   parse stops at p + 12 > n; then one literal run.  The output bytes equal
//   the native encoder's row for row.
//
// In: `data`, row r at data + r * N (or at data + row_offsets[r], 16-byte
// aligned), `lens` (B,) int32, clamped to [0, N].  Out: the compressed row,
// either padded at comp + r * C and zeroed up to C (C = N + N / 255 + 16),
// or packed: each row at comp + offsets[r], claimed with an atomicAdd on
// `cursor`, so the host reads back only the bytes made; `olen` (B,) int32;
// with CRCs asked for, crc_comp / crc_raw (B,) int64 holding the uint32.
//
// What bounds it on an H100 SXM.  Not the bytes: a row is read once and its
// output written once (about 3.35 TB/s of HBM would move the main path's
// 64 MB round in about 20 us).  The parse is the bound: the greedy parse is
// a serial chain (where the next sequence starts depends on this match's
// length), and the table it reads depends on every earlier insert.  The
// TPU formulation broke the chain with a sort and pointer doubling over all
// N positions (O(N log N) work per row); here one warp walks the chain with
// 32 positions in flight per step, which is O(N) work but latency-bound per
// row, so the card's 132 SMs each take whole rows.
//
// Design (simple and right first; faster forms are listed in ROADMAP.md):
//   - One CTA of 256 threads per row.  The row, the 4096-entry int32 hash
//     table and the output row live in shared memory (at N = 64 KB: 64 KB +
//     16 KB + 65,824 B, with the CRC constants 7.5 KB: one CTA per SM).
//   - Warp 0 walks the parse.  A miss step evaluates the 32 positions
//     p..p+31 at once: each lane hashes its position; the candidate of lane
//     i is the highest lane j < i with the same hash (__match_any_sync), else
//     the table entry; the first lane whose candidate matches is the next
//     match (__ballot_sync / __ffs), and the positions up to it enter the
//     table, the highest position winning where hashes collide.  A match is
//     extended 32 bytes per step (ballot of mismatches), its sequence is
//     written by the warp (token, length bytes, literals 32 at a time,
//     offset), and its interior positions enter the table 32 at a time.
//   - The whole CTA then writes the row out and folds the CRCs from shared
//     memory: each thread folds 64 bytes slice-by-8, the pieces are joined
//     with zero-shift tables (warp shuffles, then across warps), tiles of
//     16 KB counted back from the row's 16-byte-aligned end are joined by
//     Horner, and M^-m undoes the trailing zeros (crc_fold.cuh; the tables
//     come from ops/crc32c_torch.py, as for crc_rows.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/lz4_torch.py does this at first use).

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "crc_fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kPiece;        // 16 KB: one fold round
constexpr int kHashBits = 12;
constexpr int kHashSize = 1 << kHashBits;
constexpr int kMaxMatch = 273;
constexpr int kMinMatch = 4;
constexpr int kMaxN = 65536;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPiece << (kShifts - 1) == kTile, "last shift is one tile");

struct Args {
  const uint8_t* data;
  const int64_t* row_offsets;   // (B,) or null: row r at r * N
  const int32_t* lens;          // (B,)
  uint8_t* comp;                // padded (B, C), or packed bytes
  unsigned long long* cursor;   // null: padded; else the packed byte cursor
  int64_t* offsets;             // (B,) packed: where row r's bytes start
  int32_t* olen;                // (B,)
  int64_t* crc_comp;            // (B,) or null
  int64_t* crc_raw;             // (B,) or null
  const uint32_t* consts;       // crc32c's constants (kPolyWords words)
  int N, C;
};

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// The 4 bytes at q, little-endian, from a shared row (32-bit aligned base).
__device__ __forceinline__ uint32_t rd32(const uint8_t* row, int q) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (q >> 2);
  return __funnelshift_r(w[0], w[1], (q & 3) * 8);
}

__device__ __forceinline__ uint32_t lz4_hash(uint32_t x) {
  return (x * 2654435761u) >> (32 - kHashBits);
}

// A length field's extension bytes (L >= 15: (L - 15) / 255 bytes of 255,
// then the remainder), written by the warp at out[o..]; returns the end.
__device__ __forceinline__ int put_ext(uint8_t* out, int o, int L, int lane) {
  if (L < 15) return o;
  const int e = (L - 15) / 255 + 1;
  for (int i = lane; i < e; i += 32)
    out[o + i] = i < e - 1 ? 255 : static_cast<uint8_t>((L - 15) % 255);
  return o + e;
}

__device__ __forceinline__ int put_bytes(uint8_t* out, int o,
                                         const uint8_t* src, int n, int lane) {
  for (int i = lane; i < n; i += 32) out[o + i] = src[i];
  return o + n;
}

// The greedy parse of row[0:n] by one warp; returns the compressed length.
// Every lane returns the same value.
__device__ int lz4_walk(const uint8_t* row, int n, int32_t* table,
                        uint8_t* out, int lane) {
  int p = 0, anchor = 0, o = 0;
  while (p + 12 <= n) {
    // 32 positions at once, up to the first that matches
    const int q = p + lane;
    const bool live = q + 12 <= n;
    const uint32_t seq = live ? rd32(row, q) : 0u;
    const uint32_t h = live ? lz4_hash(seq) : kHashSize + lane;
    const unsigned grp = __match_any_sync(kFull, h);
    const unsigned lower = grp & ((1u << lane) - 1u);
    int cand = lower ? p + 31 - __clz(lower) : (live ? table[h] : -1);
    const bool ok = live && cand >= 0 && q - cand <= 65535 &&
                    rd32(row, cand) == seq;
    const unsigned hits = __ballot_sync(kFull, ok);
    const unsigned lives = __ballot_sync(kFull, live);   // lane 0 is live
    const int last = hits ? __ffs(hits) - 1 : 31 - __clz(lives);
    const unsigned upto = last == 31 ? kFull : (2u << last) - 1u;
    __syncwarp();
    if (lane <= last && 31 - __clz(grp & upto) == lane) table[h] = q;
    __syncwarp();
    if (!hits) {
      p += last + 1;
      continue;
    }
    p += last;
    cand = __shfl_sync(kFull, cand, last);

    // extend the match 32 bytes a step
    const int mmax = min(kMaxMatch, n - 5 - p);
    int mlen = kMinMatch;
    for (;;) {
      const int k = mlen + lane;
      const bool eq = k < mmax && row[cand + k] == row[p + k];
      const unsigned ne = __ballot_sync(kFull, !eq);
      if (ne == 0) {
        mlen += 32;
        continue;
      }
      mlen += __ffs(ne) - 1;
      break;
    }

    // the sequence: token, literal length bytes, literals, offset, match
    // length bytes
    const int lit = p - anchor, m = mlen - kMinMatch, off = p - cand;
    const int tok = o;
    o = put_ext(out, tok + 1, lit, lane);
    o = put_bytes(out, o, row + anchor, lit, lane);
    if (lane == 0) {
      out[tok] = static_cast<uint8_t>((min(lit, 15) << 4) | min(m, 15));
      out[o] = static_cast<uint8_t>(off & 0xff);
      out[o + 1] = static_cast<uint8_t>(off >> 8);
    }
    o = put_ext(out, o + 2, m, lane);

    // insert-all: the match's interior positions, in order
    const int end = p + mlen;
    for (int base = p + 1; base < end; base += 32) {
      const int qi = base + lane;
      const bool in = qi < end;
      const uint32_t hi = in ? lz4_hash(rd32(row, qi)) : kHashSize + lane;
      const unsigned g = __match_any_sync(kFull, hi);
      if (in && 31 - __clz(g) == lane) table[hi] = qi;
      __syncwarp();
    }
    p = anchor = end;
  }
  const int lit = n - anchor;
  if (lane == 0) out[o] = static_cast<uint8_t>(min(lit, 15) << 4);
  o = put_ext(out, o + 1, lit, lane);
  o = put_bytes(out, o, row + anchor, lit, lane);
  __syncwarp();
  return o;
}

// The standard CRC32C of buf[0:len] (shared memory, 16-byte aligned, readable
// up to round16(len)), by the whole CTA; the result is thread 0's.
__device__ uint32_t crc_block(const uint8_t* buf, int len,
                              const uint32_t* poly, uint32_t* part) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t* shifts = poly + kShiftOffset;
  const int E = round16(len);
  const int ntile = max(1, (E + kTile - 1) / kTile);
  uint32_t reg = 0;
  for (int k = 0; k < ntile; ++k) {
    const int g = E - (ntile - k) * kTile + t * kPiece;
    uint32_t crc = 0;
    if (g + kPiece > 0 && g < len) {
#pragma unroll
      for (int c = 0; c < kPiece / 16; ++c) {
        const int gc = g + 16 * c;
        const uint4 v = gc >= 0 ? *reinterpret_cast<const uint4*>(buf + gc)
                                : make_uint4(0, 0, 0, 0);
        crc = fold16(poly, crc, v, gc, 0, len, true);
      }
    }
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const uint32_t right = __shfl_down_sync(kFull, crc, 1 << s);
      crc = shift(shifts + s * kShiftWords, crc) ^ right;
    }
    if (lane == 0) part[warp] = crc;
    __syncthreads();
    if (warp == 0) {
      uint32_t r = lane < kWarps ? part[lane] : 0;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const uint32_t right = __shfl_down_sync(kFull, r, 1 << s);
        r = shift(shifts + (5 + s) * kShiftWords, r) ^ right;
      }
      if (lane == 0) reg = shift(shifts + (kShifts - 1) * kShiftWords, reg) ^ r;
    }
    __syncthreads();                  // part is read before it is refilled
  }
  if (E != len) reg = gf2_apply(poly + kInvOffset + (E - len) * 32, reg);
  if (len < 4) reg ^= 0xFFFFFFFFu >> (8 * len);
  return ~reg;
}

__global__ void __launch_bounds__(kThreads) lz4_rows_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t part[kWarps];
  __shared__ int s_olen;
  __shared__ unsigned long long s_base;
  uint32_t* tabs = reinterpret_cast<uint32_t*>(smem);
  uint8_t* row = smem + kPolyWords * 4;
  int32_t* table = reinterpret_cast<int32_t*>(row + a.N);
  uint8_t* out = reinterpret_cast<uint8_t*>(table + kHashSize);
  const int t = threadIdx.x;
  const int64_t r = blockIdx.x;
  const bool crcs = a.crc_comp != nullptr || a.crc_raw != nullptr;
  const int n = min(max(a.lens[r], 0), a.N);

  // stage the row (16 B a thread), the constants, an empty table
  const uint8_t* src =
      a.data + (a.row_offsets != nullptr ? a.row_offsets[r] : r * a.N);
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(row);
  for (int i = t; i < round16(n) / 16; i += kThreads) d4[i] = s4[i];
  if (crcs)
    for (int i = t; i < kPolyWords; i += kThreads) tabs[i] = a.consts[i];
  for (int i = t; i < kHashSize; i += kThreads) table[i] = -1;
  __syncthreads();

  if (t < 32) {
    const int o = lz4_walk(row, n, table, out, t);
    if (t == 0) s_olen = o;
  }
  __syncthreads();
  const int o = s_olen;

  if (a.cursor != nullptr) {
    if (t == 0) {
      s_base = atomicAdd(a.cursor, static_cast<unsigned long long>(o));
      a.offsets[r] = static_cast<int64_t>(s_base);
    }
    __syncthreads();
    uint8_t* dst = a.comp + s_base;
    for (int i = t; i < o; i += kThreads) dst[i] = out[i];
  } else {
    uint8_t* dst = a.comp + r * a.C;
    for (int i = t; i < a.C; i += kThreads) dst[i] = i < o ? out[i] : 0;
  }
  if (t == 0) a.olen[r] = o;

  if (a.crc_raw != nullptr) {
    const uint32_t c = crc_block(row, n, tabs, part);
    if (t == 0) a.crc_raw[r] = static_cast<int64_t>(c);
  }
  if (a.crc_comp != nullptr) {
    const uint32_t c = crc_block(out, o, tabs, part);
    if (t == 0) a.crc_comp[r] = static_cast<int64_t>(c);
  }
}

// Shared memory of a launch whose rows are at most n bytes (n % 16 == 0).
int lz4_rows_smem(int n) {
  return kPolyWords * 4 + n + kHashSize * 4 + round16(n + n / 255 + 16);
}

}  // namespace

// Launch B rows on `stream` (a cudaStream_t); returns a cudaError_t (0 =
// launched).  One CTA per row.
extern "C" int lz4_rows_launch(const void* data, const void* row_offsets,
                               const void* lens, void* comp, void* cursor,
                               void* offsets, void* olen, void* crc_comp,
                               void* crc_raw, const void* consts, int64_t B,
                               int N, int C, void* stream) {
  if (B <= 0) return 0;
  if (N < 16 || N > kMaxN || (N & 15) || C < N + N / 255 + 16 ||
      B > 0x7fffffff || (cursor != nullptr && offsets == nullptr) ||
      (row_offsets == nullptr && (reinterpret_cast<uintptr_t>(data) & 15)) ||
      ((crc_comp != nullptr || crc_raw != nullptr) && consts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // Per device, once: the shared-memory opt-in for the widest rows.
  // Callers may launch from several threads, so it is set under a lock.
  static bool opted[64];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!opted[dev]) {
      if ((err = cudaFuncSetAttribute(
               lz4_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               lz4_rows_smem(kMaxN))) != cudaSuccess)
        return static_cast<int>(err);
      opted[dev] = true;
    }
  }
  Args a{static_cast<const uint8_t*>(data),
         static_cast<const int64_t*>(row_offsets),
         static_cast<const int32_t*>(lens),
         static_cast<uint8_t*>(comp),
         static_cast<unsigned long long*>(cursor),
         static_cast<int64_t*>(offsets),
         static_cast<int32_t*>(olen),
         static_cast<int64_t*>(crc_comp),
         static_cast<int64_t*>(crc_raw),
         static_cast<const uint32_t*>(consts),
         N,
         C};
  lz4_rows_kernel<<<static_cast<unsigned>(B), kThreads, lz4_rows_smem(N),
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
