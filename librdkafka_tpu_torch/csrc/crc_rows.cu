// crc_rows.cu — CRC32C / CRC32 of left-padded rows on Hopper (sm_90a).
//
// Replaces three device kernels of librdkafka_tpu/ops/crc32c_jax.py, which
// all compute the same function:
//   A  _jit_mxu_pallas (:441-486, pl.pallas_call at :471)
//   B  _mxu_rows_fn / _jit_mxu (:254-294), the main path's default route
//   C  _mxu_fused_rows_fn / _jit_mxu_fused (:297-344), the polynomial
//      picked per row by `sel`
//
//   out[b] = ~(raw_b ^ terms[b]),  raw_b = fold of row b from a ZERO register
//
// Rows are left-padded with zeros, which are a no-op under a zero register;
// terms[b] = f(~0, 0^n) is the host-computed length term (_term_host).
//
// Design (right first, not yet fast).  The TPU turned the CRC into an int8
// matmul because its gathers are slow; on Hopper a table lookup in shared
// memory is cheap, so this is the classic slice-by-8 CRC:
//   - one 256-thread block per row; the row's polynomial's slice-by-8
//     tables (8 KB) are staged into shared memory;
//   - each thread folds its contiguous N/256-byte chunk from a zero
//     register, 16 bytes per load;
//   - the 256 partial registers combine in shared memory as a log2 tree:
//     at level k, left = ZERO_OP[log2(N/256) + k] · left ^ right, the
//     32-step GF(2) apply of _apply_host (crc32c_jax.py:203-212).
//
// Bound: the kernel must read B×N bytes from HBM (B×64 KB on the main path;
// 4 MB for a 64-row round, about 1.25 µs at 3.35 TB/s); the ALU work is
// ~2 32-bit ops per byte, an order of magnitude under that.  Known gaps,
// left to later work: the per-thread chunks make uncoalesced loads (a warp
// touches 32 rows of 256 B apart per load), and at B < 132 rows part of the
// card idles.  Staging rows through shared memory with TMA, splitting a row
// across blocks and an int8-MMA form are the next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/crc32c_torch.py does this at first use).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLog2Threads = 8;

// Apply a GF(2) 32x32 matrix, given as 32 columns, to the register v.
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* __restrict__ cols,
                                              uint32_t v) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc ^= (0u - ((v >> i) & 1u)) & __ldg(cols + i);
  return acc;
}

// One slice-by-8 step: fold the 8 bytes w0 (bytes 0..3, little-endian) and
// w1 (bytes 4..7) into crc.
__device__ __forceinline__ uint32_t step8(uint32_t (*t)[256], uint32_t crc,
                                          uint32_t w0, uint32_t w1) {
  crc ^= w0;
  return t[7][crc & 0xFF] ^ t[6][(crc >> 8) & 0xFF] ^ t[5][(crc >> 16) & 0xFF] ^
         t[4][crc >> 24] ^ t[3][w1 & 0xFF] ^ t[2][(w1 >> 8) & 0xFF] ^
         t[1][(w1 >> 16) & 0xFF] ^ t[0][w1 >> 24];
}

// data (B, N) uint8; terms (B,) int64 holding uint32; sel (B,) int32;
// tables (2, 8, 256) uint32; zop (2, 64, 32) uint32; out (B,) int64.
// N is a power of two >= 4096, so each thread's chunk is a multiple of 16.
__global__ void __launch_bounds__(kThreads)
    crc_rows_kernel(const uint8_t* __restrict__ data,
                    const int64_t* __restrict__ terms,
                    const int32_t* __restrict__ sel,
                    const uint32_t* __restrict__ tables,
                    const uint32_t* __restrict__ zop,
                    int64_t* __restrict__ out, int64_t N, int log2_chunk) {
  __shared__ uint32_t tab[8][256];
  __shared__ uint32_t part[kThreads];
  const int64_t row = blockIdx.x;
  const int t = threadIdx.x;
  const int p = sel[row] != 0 ? 1 : 0;

  const uint32_t* ptab = tables + p * 8 * 256;
  for (int i = t; i < 8 * 256; i += kThreads) (&tab[0][0])[i] = ptab[i];
  __syncthreads();

  const int64_t chunk = N >> kLog2Threads;
  const uint4* src =
      reinterpret_cast<const uint4*>(data + row * N + t * chunk);
  uint32_t crc = 0;
  for (int64_t i = 0; i < chunk / 16; ++i) {
    const uint4 v = src[i];
    crc = step8(tab, crc, v.x, v.y);
    crc = step8(tab, crc, v.z, v.w);
  }
  part[t] = crc;
  __syncthreads();

  // Tree combine: part[t] covers chunk << k bytes at level k; the right
  // neighbour's length decides the zero-shift applied to the left one.
  const uint32_t* pz = zop + p * 64 * 32;
  for (int k = 0; k < kLog2Threads; ++k) {
    const int s = 1 << k;
    if ((t & (2 * s - 1)) == 0)
      part[t] = gf2_apply(pz + (log2_chunk + k) * 32, part[t]) ^ part[t + s];
    __syncthreads();
  }
  if (t == 0)
    out[row] = static_cast<int64_t>(
        static_cast<uint32_t>(~(part[0] ^ static_cast<uint32_t>(terms[row]))));
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError().
extern "C" int crc_rows_launch(const void* data, const void* terms,
                               const void* sel, const void* tables,
                               const void* zop, void* out, int64_t B,
                               int64_t N, int log2_chunk, void* stream) {
  if (B <= 0) return 0;
  if (B > 0x7fffffff || N < 4096 || (N & (N - 1)) != 0 ||
      (N >> kLog2Threads) != (int64_t{1} << log2_chunk) ||
      log2_chunk + kLog2Threads > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  crc_rows_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(terms),
      static_cast<const int32_t*>(sel), static_cast<const uint32_t*>(tables),
      static_cast<const uint32_t*>(zop), static_cast<int64_t*>(out), N,
      log2_chunk);
  return static_cast<int>(cudaGetLastError());
}
