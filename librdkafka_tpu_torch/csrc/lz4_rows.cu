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
// `comp` must stay readable 16 bytes past the last byte written (the CRC
// of the compressed row reads whole 16-byte chunks).  `scratch` holds
// lz4_rows_scratch_bytes(B, N) bytes of device memory for the launch.
//
// What bounds it on an H100 SXM.  Not the bytes: a row is read once and its
// output written once (about 3.35 TB/s of HBM would move the main path's
// 64 MB round in about 20 us).  The greedy parse is a serial chain: where
// the next sequence starts depends on this match's length.  But the
// insert-all rule puts every position below a query in the table, whatever
// the parse did, so a position's candidate
//     cand[p] = max { q < p : HASH(q) == HASH(p) }
// does not depend on the parse; only the chain p -> next match -> p + mlen
// does (about 520 links a main-path block, not 65,536 positions).  The
// design takes the candidates off the chain, cuts the chain itself into
// segments walked at once, and then is bounded by latency and issue slots:
// the stage clocks (a -DLZ4_STAGE_CLOCKS build, ops/lz4_torch.py
// stage_clocks) put the candidate walks first.
//
//   1. Stage the row: one bulk async copy (cp.async.bulk, TMA) into shared
//      memory, completing on an mbarrier, while the threads empty the
//      candidate tables.
//   2. Candidates, by kSegments warps at once.  The positions P = [0, n-11)
//      that can start a match are cut into kSegments contiguous segments,
//      each a multiple of 32 long.  Warp s walks segment s 32 positions a
//      step against its own 4,096-entry table of 16-bit entries (pos + 1,
//      0 for empty): a lane's predecessor is its hash's entry, read before
//      the step writes; when two lanes of a step share a hash (found by
//      writing and reading back), the lanes set their bits in the word of
//      the lane whose write survived, which gives each the highest lower
//      lane of its hash, and the highest lane of each hash writes the
//      table.  The in-segment distance goes to scratch.  Then every thread
//      fixes up the positions with no predecessor in their own segment
//      (the candidate is the largest entry of the hash in the earlier
//      segments' tables: the nearest segment that has one) and writes the
//      `valid` bitmask (cand found, an equal 4-byte prefix; p - cand <=
//      65535 holds for every row of <= 64 KB) and the distance p - cand
//      (16 bits) to scratch.
//   3. The chain, read-only, from kWarps segment starts at once.  Each warp
//      walks from the start of its segment of P: from p, the next valid
//      position v (a ballot over 32 bitmask words, 1,024 positions, a
//      step), its distance (from registers: a lane holds 16 of the 512
//      distances from the last match's end on, fetched while that match
//      was measured), the match length at 8 bytes a lane, 256 a step (a
//      main-path match takes one or two), then p = v + mlen, until p
//      leaves the segment.  It lists its sequences in scratch and marks
//      its states p in an `anchors` bitmask.  Then warp 0 joins the walks
//      in order: the true chain enters segment w at e (segment 0's walk is
//      true); where e is one of w's anchors, w's walk from e on is the true
//      chain (from its j-th sequence, j = w's anchors before e); otherwise
//      the chain is walked on from e until it meets an anchor or leaves the
//      segment (on the main path about two links a join).  No hash table
//      is written.
//   4. Emission, by all warps: each warp sizes its segment's true
//      sequences, thread 0 scans the segments' sizes and claims the cursor
//      (packed form), then each warp writes its sequences straight into
//      `comp`, a lane a sequence (token, length bytes, literals, offset,
//      match length bytes; a literal run of kLaneLits or more by the whole
//      warp), and the CTA writes the last literal run (and, padded, the
//      zeros up to C).  No output row in shared memory.
//   5. The CRC epilogue: crc_raw from the staged row, crc_comp from the
//      bytes just written, read back through L2 (16-byte chunks from the
//      row's aligned-down start, the bytes outside masked).  Each thread
//      folds 64 bytes slice-by-8, the pieces are joined with zero-shift
//      tables (warp shuffles, then across warps), tiles of 16 KB counted
//      back from the 16-byte-aligned end are joined by Horner, and M^-m
//      undoes the trailing zeros (crc_fold.cuh; the tables come from
//      ops/crc32c_torch.py, as for crc_rows.cu).
//
// Shared memory at N = 65,536: row 64 KB + six 16-bit tables 48 KB =
// 114,688 B, so two CTAs fit an SM (228 KB, less 1 KB reserved a CTA).
// After the walks the bitmask takes the last table's place (no fix-up
// reads it); after the fix-up table 0 holds the anchors, table 1 the CRC
// constants (loaded again for each row), table 3 the per-segment counts.
// The grid is persistent: as many CTAs as fit on the card, each taking
// rows blockIdx.x, + grid, ..., with its own slice of scratch (2 B of
// distance a position, and a walk's and a join's sequence list a warp).
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
constexpr int kSegments = 6;                    // warps that find candidates
constexpr int kTile = kThreads * kPiece;        // 16 KB: one fold round
constexpr int kHashBits = 12;
constexpr int kHashSize = 1 << kHashBits;
constexpr int kMaxMatch = 273;
constexpr int kMinMatch = 4;
constexpr int kMaxN = 65536;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPiece << (kShifts - 1) == kTile, "last shift is one tile");
constexpr int kLaneLits = 32;   // longer literal runs are copied by a warp
static_assert(kSegments <= kWarps, "a warp a segment");

#ifdef LZ4_STAGE_CLOCKS
// Cycles of each stage summed over the CTAs' rows (thread 0's clock between
// the barriers that end the stages): a diagnostic build only.
constexpr int kStages = 7;
__device__ unsigned long long g_stage_clocks[kStages];
#define STAGE(k)                                                      \
  if (threadIdx.x == 0) {                                             \
    const long long now = clock64();                                  \
    atomicAdd(&g_stage_clocks[k], static_cast<unsigned long long>(now - clk)); \
    clk = now;                                                        \
  }
#else
#define STAGE(k)
#endif

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
  uint8_t* scratch;             // gridDim.x slices of scratch_per_cta(N)
  int64_t B;
  int N, C;
};

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Sequences a chain segment can hold: its matches start in a segment of
// at most N / 8 + 32 positions and each covers >= 4 bytes.
__host__ __device__ __forceinline__ int list_cap(int n) { return n / 32 + 80; }

// Scratch of one CTA: the distances (uint16, N), then a warp's sequence
// list from its own walk and one from the joins (uint2, list_cap each).
__host__ __device__ __forceinline__ int64_t scratch_per_cta(int n) {
  return 2 * int64_t{n} + 2 * kWarps * 8 * int64_t{list_cap(n)};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A copy that never lands is a fault: fail the launch after a few seconds
// of waiting rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try(bar, parity);)
    if (++spins == (1u << 22)) __trap();
}

// Bulk async copy global -> shared; completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The 4 bytes at q, little-endian, from a shared row (32-bit aligned base).
__device__ __forceinline__ uint32_t rd32(const uint8_t* row, int q) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (q >> 2);
  return __funnelshift_r(w[0], w[1], (q & 3) * 8);
}

// The 8 bytes at q, little-endian.
__device__ __forceinline__ uint64_t rd64(const uint8_t* row, int q) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (q >> 2);
  const int s = (q & 3) * 8;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  return (static_cast<uint64_t>(__funnelshift_r(w1, w2, s)) << 32) |
         __funnelshift_r(w0, w1, s);
}

__device__ __forceinline__ uint32_t lz4_hash(uint32_t x) {
  return (x * 2654435761u) >> (32 - kHashBits);
}

// Extension bytes of a literal / match length field.
__device__ __forceinline__ int ext_len(int L) {
  return L >= 15 ? (L - 15) / 255 + 1 : 0;
}

// A length field's extension bytes (L >= 15: (L - 15) / 255 bytes of 255,
// then the remainder), written by `lanes` threads from `lane` on at
// out[o..]; returns the end.
__device__ __forceinline__ int put_ext(uint8_t* out, int o, int L, int lane,
                                       int lanes) {
  const int e = ext_len(L);
  for (int i = lane; i < e; i += lanes)
    out[o + i] = i < e - 1 ? 255 : static_cast<uint8_t>((L - 15) % 255);
  return o + e;
}

// The first valid position >= p (a ballot over 32 bitmask words, 1,024
// positions, a step), or -1; the same on every lane.
__device__ __forceinline__ int next_valid(const uint32_t* mask, int p, int P,
                                          int lane) {
  for (int wb = p >> 5; wb * 32 < P; wb += 32) {
    const int wi = wb + lane;
    uint32_t m = wi * 32 < P ? mask[wi] : 0u;
    if (wi == (p >> 5)) m &= kFull << (p & 31);
    const unsigned hit = __ballot_sync(kFull, m != 0);
    if (hit) {
      const int f = __ffs(hit) - 1;
      return (wb + f) * 32 + __ffs(__shfl_sync(kFull, m, f)) - 1;
    }
  }
  return -1;
}

// The common prefix of row[v..] and row[c..] (equal in its first 4 bytes),
// capped at mmax: 8 bytes a lane, 256 a step.
__device__ __forceinline__ int match_len(const uint8_t* row, int v, int c,
                                         int mmax, int lane) {
  for (int k = kMinMatch;; k += 256) {
    const int o = k + 8 * lane;
    const uint64_t x = rd64(row, c + o) ^ rd64(row, v + o);
    const int e = x ? o + (__ffsll(static_cast<long long>(x)) - 1) / 8 : o + 8;
    const unsigned stop = __ballot_sync(kFull, x != 0 || o + 8 >= mmax);
    if (stop) return min(__shfl_sync(kFull, e, __ffs(stop) - 1), mmax);
  }
}

// A sequence of the chain: x = v | distance << 16, y = match length.
__device__ __forceinline__ uint2 make_seq(int v, int d, int mlen) {
  return make_uint2(static_cast<uint32_t>(v) | (static_cast<uint32_t>(d) << 16),
                    static_cast<uint32_t>(mlen));
}
__device__ __forceinline__ int seq_v(uint2 e) {
  return static_cast<int>(e.x & 0xffff);
}
__device__ __forceinline__ int seq_d(uint2 e) {
  return static_cast<int>(e.x >> 16);
}
__device__ __forceinline__ int seq_m(uint2 e) {
  return static_cast<int>(e.y);
}

// The standard CRC32C of buf[start:end] (buf 16-byte aligned, readable up
// to round16(end); 0 <= start), by the whole CTA; the result is thread 0's.
// Bytes of a chunk outside [start, end) are masked to zero.
__device__ uint32_t crc_block(const uint8_t* buf, int start, int end,
                              const uint32_t* poly, uint32_t* part) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t* shifts = poly + kShiftOffset;
  const int E = round16(end);
  const int ntile = max(1, (E - (start & ~15) + kTile - 1) / kTile);
  uint32_t reg = 0;
  for (int k = 0; k < ntile; ++k) {
    const int g = E - (ntile - k) * kTile + t * kPiece;
    uint32_t crc = 0;
    if (g + kPiece > start && g < end) {
#pragma unroll
      for (int c = 0; c < kPiece / 16; ++c) {
        const int gc = g + 16 * c;
        const uint4 v = gc >= 0 ? *reinterpret_cast<const uint4*>(buf + gc)
                                : make_uint4(0, 0, 0, 0);
        crc = fold16(poly, crc, v, gc, start, end, true);
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
  const int len = end - start;
  if (E != end) reg = gf2_apply(poly + kInvOffset + (E - end) * 32, reg);
  if (len < 4) reg ^= 0xFFFFFFFFu >> (8 * len);
  return ~reg;
}

__global__ void __launch_bounds__(kThreads, 2) lz4_rows_kernel(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ uint32_t part[kWarps];
  __shared__ uint32_t s_grp[kSegments][32];      // a walk's lanes by hash
  __shared__ int s_final;
  __shared__ unsigned long long s_base;
  uint8_t* row = smem;
  uint16_t* tables = reinterpret_cast<uint16_t*>(row + a.N);
  // the last segment's table is never read by the fix-up: the bitmask
  // takes its place
  uint32_t* mask =
      reinterpret_cast<uint32_t*>(tables + (kSegments - 1) * kHashSize);
  // after stage 2 the tables' space holds the chain's anchors (a bitmask,
  // in table 0) and the CRC constants (from table 1 on)
  uint32_t* anchors = reinterpret_cast<uint32_t*>(tables);
  uint32_t* tabs = reinterpret_cast<uint32_t*>(tables + kHashSize);
  // and (table 3) per chain segment: its walk's sequences and exit, the
  // join's sequences and the first of the walk's it keeps, the end of the
  // sequences before it, its output bytes and where they start
  int* s_nl = reinterpret_cast<int*>(tables + 3 * kHashSize);
  int *s_exit = s_nl + kWarps, *s_nf = s_exit + kWarps, *s_j = s_nf + kWarps;
  int *s_prev = s_j + kWarps, *s_bytes = s_prev + kWarps,
      *s_at = s_bytes + kWarps;
  uint16_t* dist = reinterpret_cast<uint16_t*>(
      a.scratch + blockIdx.x * scratch_per_cta(a.N));
  const int cap = list_cap(a.N);
  uint2* lists = reinterpret_cast<uint2*>(dist + a.N);
  uint2* joins = lists + kWarps * cap;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool crcs = a.crc_comp != nullptr || a.crc_raw != nullptr;

  if (t == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

#ifdef LZ4_STAGE_CLOCKS
  long long clk = clock64();
#endif
  int it = 0;
  for (int64_t r = blockIdx.x; r < a.B; r += gridDim.x, ++it) {
    const int n = min(max(a.lens[r], 0), a.N);
    const int P = max(0, n - 11);             // positions with p + 12 <= n

    // 1. stage the row; empty the candidate tables meanwhile
    if (t == 0) {
      const uint8_t* src =
          a.data + (a.row_offsets != nullptr ? a.row_offsets[r] : r * a.N);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(&bar, static_cast<uint32_t>(round16(n)));
      if (n) bulk_load(row, src, static_cast<uint32_t>(round16(n)), &bar);
    }
    uint4* t4 = reinterpret_cast<uint4*>(tables);
    for (int i = t; i < kSegments * kHashSize * 2 / 16; i += kThreads)
      t4[i] = make_uint4(0, 0, 0, 0);
    mbar_wait(&bar, it & 1);
    __syncthreads();
    STAGE(0);

    // 2a. in-segment candidates: warp s walks segment s, 32 positions a
    // step.  Each lane reads its hash's entry, then all lanes write theirs
    // and read it back: a lane that reads another's position shares its
    // hash with a lane of this step, and only then does the warp group its
    // lanes by hash (the highest lower lane of the hash is the
    // predecessor; the highest lane of each hash writes the table).  The
    // next step's bytes are read while this step's table traffic lands.
    // (Twelve ballots a step in place of the read-back took twice the
    // cycles on an H100: with a dozen walks an SM, issue slots are short.)
    const int seg = ((P + kSegments - 1) / kSegments + 31) & ~31;
    if (warp < kSegments) {
      uint16_t* T = tables + warp * kHashSize;
      const int lo = warp * seg, hi = min(P, lo + seg);
      uint32_t x = lo + lane < hi ? rd32(row, lo + lane) : 0u;
      for (int base = lo; base < hi; base += 32) {
        const int q = base + lane;
        const bool live = q < hi;
        const uint32_t h = live ? lz4_hash(x) : kHashSize + lane;
        x = q + 32 < hi ? rd32(row, q + 32) : 0u;
        const int old = live ? T[h] : 0;
        __syncwarp();
        if (live) T[h] = static_cast<uint16_t>(q + 1);
        __syncwarp();
        const int back = live ? T[h] : 0;
        int d = old ? q - (old - 1) : 0;
        if (__any_sync(kFull, live && back != q + 1)) {
          // the lanes of a hash all read back the same surviving lane: each
          // sets its bit in that lane's word, so the word is the hash's
          // lanes (what __match_any_sync gives)
          uint32_t* G = s_grp[warp];
          G[lane] = 0;
          __syncwarp();
          const int w = back - 1 - base;
          if (live) atomicOr(&G[w], 1u << lane);
          __syncwarp();
          const unsigned grp = live ? G[w] : 0u;
          const unsigned lower = grp & ((1u << lane) - 1u);
          if (lower) d = lane - (31 - __clz(lower));
          if (live && (grp >> lane) == 1u && w != lane)
            T[h] = static_cast<uint16_t>(q + 1);
          __syncwarp();
        }
        if (live) dist[q] = static_cast<uint16_t>(d);
      }
    }
    __syncthreads();
    STAGE(1);

    // 2b. fix-up from the nearest earlier segment, the bitmask, the
    // distances: every thread, 8 positions (one uint4 of distances, all in
    // one segment) a step
    uint4 dnext = make_uint4(0, 0, 0, 0);
    if (warp * 256 + lane * 8 < P)
      dnext = *reinterpret_cast<const uint4*>(dist + warp * 256 + lane * 8);
    for (int base = warp * 256; base < P; base += kWarps * 256) {
      const int q0 = base + lane * 8;
      const uint4 dv = dnext;         // this step's distances; the next's load
      if (q0 + kWarps * 256 < P)
        dnext = *reinterpret_cast<const uint4*>(dist + q0 + kWarps * 256);
      uint32_t bits = 0;
      if (q0 < P) {
        uint4* dp = reinterpret_cast<uint4*>(dist + q0);
        uint32_t w[4] = {dv.x, dv.y, dv.z, dv.w};
        uint32_t x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = rd32(row, q0 + j);
        const int s = q0 / seg;
        bool fixed = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = q0 + j;
          const int sh = 16 * (j & 1);
          int d = static_cast<int>((w[j >> 1] >> sh) & 0xffff);
          if (d == 0 && q < P && s > 0) {
            // the nearest earlier segment's entry is the largest: positions
            // grow with the segments
            const uint32_t h = lz4_hash(x[j]);
            int e = 0;
#pragma unroll
            for (int k = 0; k < kSegments - 1; ++k)
              if (k < s)
                e = max(e, static_cast<int>(tables[k * kHashSize + h]));
            if (e) {
              d = q - (e - 1);
              w[j >> 1] |= static_cast<uint32_t>(d) << sh;
              fixed = true;
            }
          }
          if (q < P && d != 0 && rd32(row, q - d) == x[j]) bits |= 1u << j;
        }
        if (fixed) *dp = make_uint4(w[0], w[1], w[2], w[3]);
      }
      // four lanes' bytes make one bitmask word
      bits <<= (lane & 3) * 8;
      bits |= __shfl_xor_sync(kFull, bits, 1);
      bits |= __shfl_xor_sync(kFull, bits, 2);
      if ((lane & 3) == 0) mask[(base >> 5) + (lane >> 2)] = bits;
    }
    __syncthreads();
    for (int i = t; i < ((P + 255) & ~255) / 32; i += kThreads) anchors[i] = 0;
    if (crcs)
      for (int i = t; i < kPolyWords; i += kThreads) tabs[i] = a.consts[i];
    __syncthreads();
    STAGE(2);

    // 3a. the chain, each warp from the start of its own segment: from p,
    // the next valid position v, its distance (from registers: a lane holds
    // 16 of the 512 distances from the last match's end on, fetched while
    // that match was measured), the match length, p = v + mlen.  The walk
    // writes its sequences to its list, marks each p inside its segment in
    // `anchors`, and stops at the first p (or v) past the segment.  It
    // writes no hash table.
    const int cseg = ((P + kWarps - 1) / kWarps + 31) & ~31;
    {
      const int cb = min(P, warp * cseg), ce = min(P, cb + cseg);
      uint2* L = lists + warp * cap;
      int p = cb, nl = 0, wbase = 0;
      uint4 wa = make_uint4(0, 0, 0, 0), wb = wa;
      auto fetch = [&](int from) {
        wbase = from;
        if (from + 16 * lane < P) {
          const uint4* src =
              reinterpret_cast<const uint4*>(dist + from + 16 * lane);
          wa = src[0];
          wb = src[1];
        }
      };
      fetch(cb & ~7);
      if (lane == 0 && cb < ce) atomicOr(&anchors[cb >> 5], 1u << (cb & 31));
      while (p < ce) {
        const int v = next_valid(mask, p, P, lane);
        if (v < 0 || v >= ce) break;
        int d;
        if (v - wbase < 512) {
          const int idx = v - wbase, e = idx & 15, k = (e & 7) >> 1;
          const uint4 hv = e < 8 ? wa : wb;
          const uint32_t w =
              k == 0 ? hv.x : k == 1 ? hv.y : k == 2 ? hv.z : hv.w;
          d = static_cast<int>(
              (__shfl_sync(kFull, w, idx >> 4) >> (16 * (e & 1))) & 0xffff);
        } else {
          d = static_cast<int>(dist[v]);
        }
        fetch((v + kMinMatch) & ~7);
        const int mlen =
            match_len(row, v, v - d, min(kMaxMatch, n - 5 - v), lane);
        if (lane == 0) L[nl] = make_seq(v, d, mlen);
        ++nl;
        p = v + mlen;
        if (lane == 0 && p < ce) atomicOr(&anchors[p >> 5], 1u << (p & 31));
      }
      if (lane == 0) {
        s_nl[warp] = nl;
        s_exit[warp] = max(p, ce);
      }
    }
    __syncthreads();
    STAGE(3);

    // 3b. the joins, warp 0, in order: the true chain enters segment w at
    // e (segment 0's walk is the true chain).  Where e is an anchor of
    // w's walk, the walk from e on is the true chain: keep its sequences
    // from e and take its exit.  Otherwise walk on from e, into `joins`,
    // until an anchor or the segment's end.
    if (warp == 0) {
      int e = s_exit[0];
      if (lane == 0) s_nf[0] = s_j[0] = 0;
      for (int w = 1; w < kWarps; ++w) {
        const int cb = min(P, w * cseg), ce = min(P, cb + cseg);
        uint2* F = joins + w * cap;
        int nf = 0, j = s_nl[w];
        while (e < ce) {
          if ((anchors[e >> 5] >> (e & 31)) & 1u) {
            // the walk's sequence from e is its j-th: one anchor before
            // each sequence, so j = the anchors in [cb, e)
            int c = 0;
            for (int wi = (cb >> 5) + lane; wi <= (e >> 5); wi += 32) {
              uint32_t m = anchors[wi];
              if (wi == (e >> 5)) m &= (1u << (e & 31)) - 1u;
              if (wi == (cb >> 5)) m &= kFull << (cb & 31);
              c += __popc(m);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
            j = c;
            e = s_exit[w];
            break;
          }
          const int v = next_valid(mask, e, P, lane);
          if (v < 0 || v >= ce) {
            e = ce;
            break;
          }
          const int d = static_cast<int>(dist[v]);
          const int mlen =
              match_len(row, v, v - d, min(kMaxMatch, n - 5 - v), lane);
          if (lane == 0) F[nf] = make_seq(v, d, mlen);
          ++nf;
          e = v + mlen;
        }
        if (lane == 0) {
          s_nf[w] = nf;
          s_j[w] = j;
        }
      }
      // where each segment's sequences start: the end of the last true
      // sequence before it
      if (lane == 0) {
        int last = 0;
        for (int w = 0; w < kWarps; ++w) {
          const int nf = s_nf[w], j = s_j[w], nl = s_nl[w];
          s_prev[w] = last;
          if (nl > j) {
            const uint2 q = lists[w * cap + nl - 1];
            last = seq_v(q) + seq_m(q);
          } else if (nf > 0) {
            const uint2 q = joins[w * cap + nf - 1];
            last = seq_v(q) + seq_m(q);
          }
        }
        s_final = last;
      }
    }
    __syncthreads();
    STAGE(4);

    // 4. emission, by all warps, straight into comp: warp w writes segment
    // w's true sequences (its joins', then its walk's from j on), 32 at a
    // time: a lane each to size them and scan the sizes, then the warp
    // writes them one by one (token, length bytes, literals, offset, match
    // length bytes).  First the sizes, for where each segment's bytes go.
    const int nf = s_nf[warp], j0 = s_j[warp];
    const int cnt = nf + s_nl[warp] - j0;
    const uint2* L = lists + warp * cap;
    const uint2* F = joins + warp * cap;
    auto seq_at = [&](int k) { return k < nf ? F[k] : L[j0 + k - nf]; };
    // the sizes of sequences k0 + lane (0 past cnt) and the end of the last
    auto sizes = [&](int k0, int& prev_end, int& sz, uint2& q, int& pe) {
      const int k = k0 + lane;
      q = k < cnt ? seq_at(k) : make_uint2(0, 0);
      const int end = seq_v(q) + seq_m(q);
      pe = __shfl_up_sync(kFull, end, 1);
      if (lane == 0) pe = prev_end;
      const int lit = seq_v(q) - pe, m = seq_m(q) - kMinMatch;
      sz = k < cnt ? 1 + ext_len(lit) + lit + 2 + ext_len(m) : 0;
      prev_end = __shfl_sync(kFull, end, min(31, cnt - 1 - k0));
    };
    {
      int prev_end = s_prev[warp], total = 0;
      for (int k0 = 0; k0 < cnt; k0 += 32) {
        int sz, pe;
        uint2 q;
        sizes(k0, prev_end, sz, q, pe);
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) sz += __shfl_xor_sync(kFull, sz, s);
        total += sz;
      }
      if (lane == 0) s_bytes[warp] = total;
    }
    __syncthreads();
    if (t == 0) {
      int at = 0;
      for (int w = 0; w < kWarps; ++w) {
        s_at[w] = at;
        at += s_bytes[w];
      }
      s_bytes[0] = at;                   // the sequences' bytes
      if (a.cursor != nullptr) {
        const int lit = n - s_final;
        const int o = at + 1 + ext_len(lit) + lit;
        s_base = atomicAdd(a.cursor, static_cast<unsigned long long>(o));
        a.offsets[r] = static_cast<int64_t>(s_base);
      }
    }
    __syncthreads();
    const int anchor = s_final, tot = s_bytes[0];
    const int lit = n - anchor;
    const int o = tot + 1 + ext_len(lit) + lit;
    uint8_t* dst = a.comp + (a.cursor != nullptr ? static_cast<int64_t>(s_base)
                                                 : r * a.C);
    {
      int prev_end = s_prev[warp], at = s_at[warp];
      for (int k0 = 0; k0 < cnt; k0 += 32) {
        int sz, pe;
        uint2 q;
        sizes(k0, prev_end, sz, q, pe);
        int incl = sz;                   // inclusive scan of the sizes
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, s);
          if (lane >= s) incl += y;
        }
        // a lane writes its own sequence; a literal run of kLaneLits or
        // more is the warp's, after
        const bool mine = k0 + lane < cnt;
        const int ql = seq_v(q) - pe, qm = seq_m(q) - kMinMatch;
        const bool long_lits = mine && ql >= kLaneLits;
        if (mine) {
          uint8_t* out = dst + at + incl - sz;
          out[0] = static_cast<uint8_t>((min(ql, 15) << 4) | min(qm, 15));
          int w = 1 + ext_len(ql);
          if (!long_lits) {
            put_ext(out, 1, ql, 0, 1);
            for (int i = 0; i < ql; ++i) out[w + i] = row[pe + i];
          }
          w += ql;
          out[w] = static_cast<uint8_t>(seq_d(q) & 0xff);
          out[w + 1] = static_cast<uint8_t>(seq_d(q) >> 8);
          put_ext(out, w + 2, qm, 0, 1);
        }
        for (unsigned l = __ballot_sync(kFull, long_lits); l; l &= l - 1) {
          const int i = __ffs(l) - 1;
          uint8_t* out = dst + at + __shfl_sync(kFull, incl - sz, i);
          const int ll = __shfl_sync(kFull, ql, i);
          const int la = __shfl_sync(kFull, pe, i);
          const int w = put_ext(out, 1, ll, lane, 32);
          for (int k = lane; k < ll; k += 32) out[w + k] = row[la + k];
        }
        at += __shfl_sync(kFull, incl, 31);
      }
    }
    if (t == 0) dst[tot] = static_cast<uint8_t>(min(lit, 15) << 4);
    const int lo = put_ext(dst, tot + 1, lit, t, kThreads);
    for (int i = t; i < lit; i += kThreads) dst[lo + i] = row[anchor + i];
    if (a.cursor == nullptr)
      for (int i = o + t; i < a.C; i += kThreads) dst[i] = 0;
    if (t == 0) a.olen[r] = o;
    __syncthreads();
    STAGE(5);

    // 5. the CRC epilogue
    if (a.crc_raw != nullptr) {
      const uint32_t c = crc_block(row, 0, n, tabs, part);
      if (t == 0) a.crc_raw[r] = static_cast<int64_t>(c);
    }
    if (a.crc_comp != nullptr) {
      const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
      const uint32_t c = crc_block(dst - mis, mis, mis + o, tabs, part);
      if (t == 0) a.crc_comp[r] = static_cast<int64_t>(c);
    }
    __syncthreads();                  // the row and tables are free again
    STAGE(6);
  }
}

// The bitmask covers whole steps of 256 positions.
int lz4_rows_smem(int n) {
  return n + (kSegments - 1) * kHashSize * 2 +
         max(kHashSize * 2, ((n + 255) & ~255) / 8);
}

// Per device, once: the shared-memory opt-in for the widest rows, and all
// of the SM's unified L1 / shared memory as shared memory (two CTAs of
// 114,176 B).  Callers may launch from several threads, so it is set under
// a lock.
cudaError_t opt_in(int* dev) {
  static bool opted[64];
  static std::mutex mu;
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!opted[*dev]) {
    if ((err = cudaFuncSetAttribute(
             lz4_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             lz4_rows_smem(kMaxN))) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             lz4_rows_kernel,
             cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
      return err;
    opted[*dev] = true;
  }
  return cudaSuccess;
}

// CTAs of rows <= N bytes that fit one SM, and on the whole card.
cudaError_t residency(int N, int* per_sm, int64_t* slots) {
  int dev = 0, sms = 0;
  cudaError_t err = opt_in(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, lz4_rows_kernel, kThreads, lz4_rows_smem(N));
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (slots != nullptr) *slots = int64_t{sms} * *per_sm;
  return err;
}

bool bad_width(int N) { return N < 16 || N > kMaxN || (N & 15); }

}  // namespace

#ifdef LZ4_STAGE_CLOCKS
// Copy the stage clocks out (kStages values) and zero them.
extern "C" int lz4_rows_stage_clocks(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_stage_clocks, sizeof(g_stage_clocks));
  if (err == cudaSuccess) {
    static const unsigned long long zero[kStages] = {};
    err = cudaMemcpyToSymbol(g_stage_clocks, zero, sizeof(g_stage_clocks));
  }
  return static_cast<int>(err);
}
#endif

// CTAs of the kernel resident on one SM of the current device at row width
// N, or a negative cudaError_t.
extern "C" int lz4_rows_ctas_per_sm(int N) {
  if (bad_width(N)) return -static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  const cudaError_t err = residency(N, &per_sm, nullptr);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// Bytes of scratch a launch of B rows of width N needs (one slice per CTA
// of the persistent grid), or a negative cudaError_t.
extern "C" int64_t lz4_rows_scratch_bytes(int64_t B, int N) {
  if (bad_width(N) || B < 0)
    return -static_cast<int64_t>(cudaErrorInvalidValue);
  int per_sm = 0;
  int64_t slots = 0;
  const cudaError_t err = residency(N, &per_sm, &slots);
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  return (B < slots ? B : slots) * scratch_per_cta(N);
}

// Launch B rows on `stream` (a cudaStream_t); returns a cudaError_t (0 =
// launched).  A persistent grid: min(B, the CTAs resident on the card).
extern "C" int lz4_rows_launch(const void* data, const void* row_offsets,
                               const void* lens, void* comp, void* cursor,
                               void* offsets, void* olen, void* crc_comp,
                               void* crc_raw, const void* consts,
                               void* scratch, int64_t B, int N, int C,
                               void* stream) {
  if (B <= 0) return 0;
  if (bad_width(N) || C < N + N / 255 + 16 || scratch == nullptr ||
      (cursor != nullptr && offsets == nullptr) ||
      (row_offsets == nullptr && (reinterpret_cast<uintptr_t>(data) & 15)) ||
      ((crc_comp != nullptr || crc_raw != nullptr) && consts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  int64_t slots = 0;
  cudaError_t err = residency(N, &per_sm, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
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
         static_cast<uint8_t*>(scratch),
         B,
         N,
         C};
  lz4_rows_kernel<<<static_cast<unsigned>(B < slots ? B : slots), kThreads,
                    lz4_rows_smem(N), static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Makes `device` current for a call and restores the caller's after.
struct OnDevice {
  int prev = -1, dev;
  cudaError_t err;
  explicit OnDevice(int d) : dev(d) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~OnDevice() {
    if (prev >= 0 && prev != dev) cudaSetDevice(prev);
  }
};

}  // namespace

// One round of the offload engine's compress route (ops/lz4_torch.py
// launch_lz4), queued on `stream` of `device` in one call: the H2D copy of
// the pinned slot (`nbytes` of `host` into `flat`: the blocks in
// `flat_bytes`, then B int64 row offsets and B int32 lengths), the metadata
// zeroed, a device-side wait for `wait` (the card's last launch when it
// ran on another stream, else null), the kernel with both CRCs into the
// packed `comp`, the metadata (`out_words` int64: cursor, offsets,
// crc_comp, crc_raw, then olen as int32 pairs) copied back into pinned
// `meta_host`, and `done` recorded.  `scratch` holds `scratch_bytes`.
// Returns a cudaError_t (0 = queued).
extern "C" int lz4_rows_round(int device, const void* host, void* flat,
                              int64_t nbytes, int64_t flat_bytes, int64_t B,
                              int N, void* comp, void* meta,
                              int64_t out_words, void* meta_host,
                              const void* consts, void* scratch,
                              int64_t scratch_bytes, void* stream, void* wait,
                              void* done) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  const int64_t need = lz4_rows_scratch_bytes(B, N);
  if (need < 0) return static_cast<int>(-need);
  if (need > scratch_bytes || flat_bytes + 12 * B > nbytes ||
      out_words < 1 + 3 * B + (B + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* f = static_cast<uint8_t*>(flat);
  auto* m = static_cast<int64_t*>(meta);
  cudaError_t err = cudaMemcpyAsync(flat, host, nbytes,
                                    cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(meta, 0, out_words * 8, s);
  if (err == cudaSuccess && wait != nullptr)
    err = cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(wait), 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = lz4_rows_launch(f, f + flat_bytes, f + flat_bytes + 8 * B,
                                 comp, m, m + 1, m + 1 + 3 * B, m + 1 + B,
                                 m + 1 + 2 * B, consts, scratch, B, N,
                                 N + N / 255 + 16, stream);
  if (rc != 0) return rc;
  err = cudaMemcpyAsync(meta_host, meta, out_words * 8,
                        cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess)
    err = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
  return static_cast<int>(err);
}

// The round's readback (ops/lz4_torch.py read_lz4): once `done` has
// completed, the cursor's bytes of `comp` (the bytes the kernel made) into
// pinned `back` on `stream`, synchronised.  With `block` 0 a round not yet
// done returns -cudaErrorNotReady at once, copying nothing.  Returns the
// cursor (nothing copied when it exceeds `cap`, the bytes `back` holds)
// or a negative cudaError_t.
extern "C" int64_t lz4_rows_readback(int device, void* done,
                                     const int64_t* meta_host, int64_t cap,
                                     const void* comp, void* back,
                                     void* stream, int block) {
  OnDevice on(device);
  if (on.err != cudaSuccess) return -static_cast<int64_t>(on.err);
  auto ev = static_cast<cudaEvent_t>(done);
  cudaError_t err = block ? cudaEventSynchronize(ev) : cudaEventQuery(ev);
  if (err == cudaErrorNotReady) (void)cudaGetLastError();   // not an error
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  const int64_t used = meta_host[0];
  if (used <= 0 || used > cap) return used;
  auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemcpyAsync(back, comp, used, cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return err == cudaSuccess ? used : -static_cast<int64_t>(err);
}
