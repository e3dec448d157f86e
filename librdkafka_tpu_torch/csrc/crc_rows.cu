// crc_rows.cu — CRC32C / CRC32 of packed ragged segments on Hopper (sm_90a).
//
// Replaces three device kernels of librdkafka_tpu/ops/crc32c_jax.py, which
// all compute the same function:
//   A  _jit_mxu_pallas (:441-486, pl.pallas_call at :471)
//   B  _mxu_rows_fn / _jit_mxu (:254-294), the main path's default route
//   C  _mxu_fused_rows_fn / _jit_mxu_fused (:297-344), the polynomial
//      picked per row by `sel`
// and computes what D (_crc_kernel / crc32c_many, :99-169) computes: the
// CRC of each buffer from its length, with no host term.
//
// Input: `flat` (M,) uint8, M % 16 == 0, 16-byte aligned; segment s is
// flat[offsets[s] : offsets[s] + lengths[s]], in any order, at any offset;
// sel[s] picks the polynomial (0 crc32c, nonzero crc32).  Output (S,)
// int64 holding the uint32
//   without terms: the standard CRC (register ~0 at the first real byte,
//                  final inversion);
//   with terms:    ~(raw ^ terms[s]), raw = fold of the segment from a ZERO
//                  register: the TPU row contract (rows left-padded with
//                  zeros, terms[s] = f(~0, 0^n) from the host), which
//                  crc_rows keeps by calling this kernel with offsets b*N.
//
// What bounds it on an H100 SXM (700 W; chip_smoke.py phase 2, PERF.md).
// The bytes: each segment byte is read once from HBM (3.35 TB/s): 1.5 MB on
// the main path's 64 regions (0.45 us), 16 MB at 256 x 64 KB (5.0 us), 63 MB
// at 61,440 x 1 KB (19 us).  What bounds it instead:
//   - main path: fixed costs.  A launch and its events take about 5 us
//     whatever the kernel; the kernel itself runs about 4.4 us (profiler),
//     most of it the latency of its constants and first tile landing and of
//     one tile's fold and combine.
//   - 256 x 64 KB: 0.018 ms with L2 warm, so not the bytes; and not the
//     fold's lookups alone: nibble tables, which halved their bank cycles,
//     left this shape's time where it was.  What is left is latency: every
//     block asks for its first two tiles at once, and a segment's last
//     tile waits for its siblings.
//   - small segments: a tile holds one segment, so 61,440 x 1 KB are
//     61,440 tiles of 1 KB, each paying the block's fixed per-tile path
//     (combine across warps, barrier, finish, next copy): about 2 us a tile
//     per block, 0.23 ms in all.
//
// Design.  The TPU turned the CRC into an int8 matmul because its gathers
// are slow; on Hopper a table lookup in shared memory is cheap, so this is
// the slice-by-8 CRC, cut so that the whole card works on every segment:
//   - Tiles aligned to each segment's end.  A segment is cut into tiles of
//     kTile = 16 KB counted back from E = ceil16(end); only its first tile
//     is partial.  Bytes outside [start, end) are masked to zero in
//     registers, which is the TPU's left padding done virtually: nothing
//     before a segment's 16-byte-aligned start is copied.  Trailing zeros
//     up to E are undone by M^-m (m = E - end < 16) when the segment is
//     finished.  The host lists each tile as {window start, segment start,
//     segment end, segment}; a segment's tiles are adjacent.
//   - Staging.  A cooperative grid of persistent blocks (as many as fit on
//     the card, at most one per tile) walks the tile list.  Each block
//     brings its next two tiles into shared memory with bulk async copies
//     (cp.async.bulk, TMA) completing on mbarriers, double-buffered, and its
//     polynomials' constants (fold tables, zero-shift tables, M^-m: 7.5 KB
//     each) with one more bulk copy, once per block rather than once per
//     tile.  A tile's descriptor is loaded one tile ahead, so no global
//     latency sits between two tiles.
//   - Fold.  Thread t folds the kPiece = 64 bytes at t * kPiece from a zero
//     register, slice-by-8 with each byte table split into two nibble
//     tables: 16 lookups per 8 bytes, none of which conflict on the banks,
//     where 8 byte-table lookups conflicted about 4-way.  Its four 16-byte
//     shared-memory loads are taken in a rotated order, so a quarter
//     warp's loads hit all 32 banks.  A piece with no real bytes is
//     skipped.
//   - Combine inside the block: warp shuffles, not a __syncthreads tree.
//     Each level is one zero-shift over a fixed distance kPiece << k, from
//     shared memory.  The shift tables are nibble tables (8 lookups of 16
//     words) rather than the _shift_tables byte form (4 lookups of 256):
//     a nibble row spans 16 banks, so its lookups never conflict, and nine
//     of them take 4.5 KB where byte tables took 36 KB of shared memory
//     and of every block's table copy.
//   - Join of a segment's tiles in the same launch, with no grid barrier:
//     a tile that is not its segment's last publishes its register to
//     scratch, flagged as ready; the block that folds the last tile waits
//     for the others' flags (a warp's lanes each watch one), zeroes each
//     slot it reads, joins them by Horner, reg = shift_T(reg) ^ tile, and
//     finishes the CRC.  A block takes its tiles in increasing order and
//     every block is resident (cooperative launch), so the tiles waited for
//     are always on their way.  A one-tile segment is finished at once.
//     A launch leaves its scratch zeroed as it found it, so a staged launch
//     may be fired again.
//   - The standard CRC's ~0 register is injected by XOR into the first
//     min(4, n) real bytes: f(~0, d) = f(0, d ^ ff..) ^ (~0 >> 8n) for n < 4.
//
// The fold, the nibble tables and the constants' layout are in
// crc_fold.cuh, shared with lz4_rows.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/crc32c_torch.py does this at first use).

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "crc_fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kPiece;        // 16 KB
static_assert(kPiece << (kShifts - 1) == kTile, "last shift is one tile");

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

struct Args {
  const uint8_t* flat;
  const int4* tiles;          // (ntiles,) {window start, start, end, segment}
  const int32_t* sel;         // (S,)
  const int64_t* terms;       // (S,) or null: the standard CRC
  const uint32_t* consts;     // (2, kPolyWords): per polynomial
  uint64_t* scratch;          // (ntiles,) zero, or 1 << 32 | tile register
  int64_t* out;               // (S,)
  int64_t ntiles;
  int poly_first;             // polynomial in slot 0
  int npolys;                 // 1, or 2 (slot = sel)
};

// A tile's register, published by another block of this launch; the slot
// is zeroed for the next launch.  Tiles are taken in increasing order and
// every block is resident (cooperative launch), so the tile is on its way;
// a wait of seconds is a fault: trap.
__device__ __forceinline__ uint32_t await_tile(uint64_t* p) {
  volatile uint64_t* slot = p;
  for (uint32_t spins = 0;; ++spins) {
    const uint64_t w = *slot;
    if (w >> 32) {
      *slot = 0;
      return static_cast<uint32_t>(w);
    }
    if (spins == (1u << 24)) __trap();
    __nanosleep(32);
  }
}

__global__ void __launch_bounds__(kThreads) crc_segments_kernel(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bar[3];      // data stage 0, 1; tables
  __shared__ uint32_t part[2][kWarps];
  uint8_t* buf = smem;                                 // 2 x kTile
  uint32_t* tabs = reinterpret_cast<uint32_t*>(smem + 2 * kTile);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t grid = gridDim.x;
  const bool inject = a.terms == nullptr;

  // Copy the real bytes of a tile's window [vs, vs + kTile), from its
  // segment's 16-byte-aligned start on, into stage s (thread 0 only).
  auto issue = [&](int4 d, int s) {
    const int src = max(d.y & ~15, d.x);
    const uint32_t bytes = static_cast<uint32_t>(d.x + kTile - src);
    mbar_expect(&bar[s], bytes);
    if (bytes) bulk_load(buf + s * kTile + (src - d.x), a.flat + src, bytes, &bar[s]);
  };
  auto slot_of = [&](int seg) { return a.npolys == 2 ? (a.sel[seg] != 0) : 0; };

  if (t == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(&bar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar[2], a.npolys * kPolyWords * 4);
    for (int p = 0; p < a.npolys; ++p)
      bulk_load(tabs + p * kPolyWords,
                a.consts + (a.poly_first + p) * kPolyWords, kPolyWords * 4,
                &bar[2]);
    for (int s = 0; s < 2; ++s)
      if (blockIdx.x + s * grid < a.ntiles)
        issue(__ldg(a.tiles + blockIdx.x + s * grid), s);
  }
  __syncthreads();

  // A tile's descriptor and its segment's polynomial are loaded one tile
  // ahead, and its bytes two tiles ahead, so no global latency sits
  // between two tiles.
  int4 cur = make_int4(0, 0, 0, 0);
  int cur_slot = 0;
  if (blockIdx.x < a.ntiles) {
    cur = __ldg(a.tiles + blockIdx.x);
    cur_slot = slot_of(cur.w);
  }
  mbar_wait(&bar[2], 0);
  int it = 0;
  for (int64_t i = blockIdx.x; i < a.ntiles; i += grid, ++it) {
    const int s = it & 1;
    const bool more = i + grid < a.ntiles, ahead = i + 2 * grid < a.ntiles;
    const int4 next = more ? __ldg(a.tiles + i + grid) : cur;
    const int next_slot = more ? slot_of(next.w) : 0;
    const int4 far = (t == 0 && ahead) ? __ldg(a.tiles + i + 2 * grid) : cur;
    const uint32_t* poly = tabs + cur_slot * kPolyWords;
    const uint32_t* shifts = poly + kShiftOffset;
    const int vs = cur.x, start = cur.y, end = cur.z;
    mbar_wait(&bar[s], (it >> 1) & 1);

    uint32_t crc = 0;
    const int g = vs + t * kPiece;
    if (g + kPiece > start && g < end) {
      // 4 chunks of 16 B, loaded in an order rotated by (t >> 1) & 3 so
      // that a quarter warp's loads cover all 32 banks, then put back.
      const uint4* p = reinterpret_cast<const uint4*>(buf + s * kTile) + 4 * t;
      const int r = (t >> 1) & 3;
      const uint4 x0 = p[r], x1 = p[(r + 1) & 3], x2 = p[(r + 2) & 3],
                  x3 = p[(r + 3) & 3];
      const uint4 v0 = r == 0 ? x0 : r == 1 ? x3 : r == 2 ? x2 : x1;
      const uint4 v1 = r == 0 ? x1 : r == 1 ? x0 : r == 2 ? x3 : x2;
      const uint4 v2 = r == 0 ? x2 : r == 1 ? x1 : r == 2 ? x0 : x3;
      const uint4 v3 = r == 0 ? x3 : r == 1 ? x2 : r == 2 ? x1 : x0;
      crc = fold16(poly, crc, v0, g, start, end, inject);
      crc = fold16(poly, crc, v1, g + 16, start, end, inject);
      crc = fold16(poly, crc, v2, g + 32, start, end, inject);
      crc = fold16(poly, crc, v3, g + 48, start, end, inject);
    }
    if (__any_sync(0xffffffffu, crc != 0)) {
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const uint32_t right = __shfl_down_sync(0xffffffffu, crc, 1 << k);
        crc = shift(shifts + k * kShiftWords, crc) ^ right;
      }
    }
    if (lane == 0) part[s][warp] = crc;
    __syncthreads();                  // part[s] is full; buf[s] is read
    if (t == 0 && ahead) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(far, s);
    }
    if (warp == 0) {
      uint32_t r = lane < kWarps ? part[s][lane] : 0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint32_t right = __shfl_down_sync(0xffffffffu, r, 1 << k);
        r = shift(shifts + (5 + k) * kShiftWords, r) ^ right;
      }
      r = __shfl_sync(0xffffffffu, r, 0);      // the tile's register

      // The segment's tiles end at E; this is its last tile when its
      // window does.  Earlier tiles publish; the last one joins them by
      // Horner, reg = shift_T(reg) ^ tile, and finishes the CRC.
      const int aligned_end = (end + 15) & ~15;
      if (aligned_end - vs != kTile) {
        if (lane == 0)
          *reinterpret_cast<volatile uint64_t*>(a.scratch + i) =
              (uint64_t{1} << 32) | r;
      } else {
        const int n = max(1, (aligned_end - (start & ~15) + kTile - 1) / kTile);
        const uint32_t* shift_tile = shifts + (kShifts - 1) * kShiftWords;
        uint32_t reg = 0;
        for (int64_t base = i - (n - 1); base < i; base += 32) {
          const int64_t j = base + lane;
          const uint32_t v = j < i ? await_tile(a.scratch + j) : 0;
          const int cnt = static_cast<int>(min(int64_t{32}, i - base));
          for (int l = 0; l < cnt; ++l)
            reg = shift(shift_tile, reg) ^ __shfl_sync(0xffffffffu, v, l);
        }
        if (lane == 0) {
          if (n > 1) r = shift(shift_tile, reg) ^ r;
          if (aligned_end != end)       // undo the trailing zeros up to E
            r = gf2_apply(poly + kInvOffset + (aligned_end - end) * 32, r);
          const int len = end - start;
          if (inject) {
            if (len < 4) r ^= 0xFFFFFFFFu >> (8 * len);
          } else {
            r ^= static_cast<uint32_t>(a.terms[cur.w]);
          }
          a.out[cur.w] = static_cast<int64_t>(static_cast<uint32_t>(~r));
        }
      }
    }
    cur = next;
    cur_slot = next_slot;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns a cudaError_t (0 = launched).
// The grid is cooperative, so that every block is resident: as many blocks
// as fit on the card at once, at most one per tile.
extern "C" int crc_segments_launch(const void* flat, const void* tiles,
                                   const void* sel, const void* terms,
                                   const void* consts, void* scratch,
                                   void* out, int64_t ntiles, int poly_first,
                                   int npolys, void* stream) {
  if (ntiles <= 0) return 0;
  if (npolys < 1 || npolys > 2 || poly_first < 0 ||
      poly_first + npolys > 2 || ntiles > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(flat) & 15) ||
      (reinterpret_cast<uintptr_t>(tiles) & 15) ||
      (reinterpret_cast<uintptr_t>(consts) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  // Per device and polynomial count, once: the shared-memory opt-in and
  // how many blocks fit on the card.  Callers may launch from several
  // threads, so the table is filled under a lock.
  static int cap[64][3];
  static std::mutex cap_mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const int smem = 2 * kTile + npolys * kPolyWords * 4;
  int64_t c;
  {
    std::lock_guard<std::mutex> lock(cap_mu);
    if (cap[dev][npolys] == 0) {
      int sms = 0, per_sm = 0;
      if ((err = cudaFuncSetAttribute(
               crc_segments_kernel,
               cudaFuncAttributeMaxDynamicSharedMemorySize,
               2 * kTile + 2 * kPolyWords * 4)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, crc_segments_kernel, kThreads, smem)) != cudaSuccess)
        return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      cap[dev][npolys] = sms * per_sm;
    }
    c = cap[dev][npolys];
  }
  Args a{static_cast<const uint8_t*>(flat),
         static_cast<const int4*>(tiles),
         static_cast<const int32_t*>(sel),
         static_cast<const int64_t*>(terms),
         static_cast<const uint32_t*>(consts),
         static_cast<uint64_t*>(scratch),
         static_cast<int64_t*>(out),
         ntiles,
         poly_first,
         npolys};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(crc_segments_kernel),
      dim3(static_cast<unsigned>(ntiles < c ? ntiles : c)), dim3(kThreads),
      params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
