// Threefry-2x32 random bits for NVIDIA Hopper (sm_90a): the draw the
// serving sampler's Gumbel noise starts from (paddle_tpu_torch/inference/
// prng.py), one launch for a batch of keys, the keys' fold_ins included.
//
//   key_i      = fold_in(fold_in((k1, k2), d1[i]), d2[i])   (each fold
//                optional; (k1, k2) one key or one a row)
//   out[i*n+j] = w0 ^ w1,  (w0, w1) = threefry2x32(key_i,
//                                     (j >> 32, j & 0xffffffff))
//
// for row i < rows (one key a sampled slot) and flat index j < n of the
// row's draw: jax's partitionable random bits (jax 0.9.0,
// jax_threefry_partitionable, `_threefry_random_bits_partitionable`),
// which the reference's sampler draws through XLA under the per-slot
// keys fold_in(fold_in(PRNGKey(seed), request id), token index)
// (jax.random.categorical at paddle_tpu/inference/serving.py:546,
// :554). fold_in(key, d) is threefry2x32(key, (0, d)). The reference has
// no Pallas kernel here; the port's plain version is the same hashes as
// int64 torch ops (kernels/threefry.py `bits_ref`), about 170
// elementwise launches a hash on the eager decode tick, which is bound
// by host launches.
//
// The hash: 20 rounds in five groups of four, rotations (13, 15, 26, 6)
// and (17, 29, 16, 24), the key schedule (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
// injected after each group with the group's count added to the second
// word. 32-bit unsigned arithmetic wraps as the plain version's masks
// do, so the bits are the plain version's exactly.
//
// What bounds it on an H100: operations, 73 32-bit integer operations
// an element (two counter adds, 20 rounds of add, rotate and xor, ten
// injections, the last xor) against 8 bytes written (int64 words, the
// plain version's dtype). Design: a row a block row (blockIdx.y); each
// thread derives its row's key once (the fold_ins, 2 x 74 operations)
// and then hashes up to COLS_PER_THREAD of the row's columns (more past
// the grid's cap), so at the sampler's [slots, V] draws the fold_ins add
// about a quarter to the draw's operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS_PER_THREAD = 8;
constexpr long long MAX_BLOCKS = 132 * 16;
constexpr long long MAX_GRID_Y = 65535;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t x1, uint32_t x2,
                                             uint32_t& w0, uint32_t& w1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  uint32_t a = x1 + ks[0];
  uint32_t b = x2 + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    const int r0 = (g & 1) ? 17 : 13, r1 = (g & 1) ? 29 : 15;
    const int r2 = (g & 1) ? 16 : 26, r3 = (g & 1) ? 24 : 6;
    a += b; b = rotl(b, r0) ^ a;
    a += b; b = rotl(b, r1) ^ a;
    a += b; b = rotl(b, r2) ^ a;
    a += b; b = rotl(b, r3) ^ a;
    a += ks[(g + 1) % 3];
    b += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  w0 = a;
  w1 = b;
}

// k1, k2: int64 [rows] key words, or null for the one key (s1, s2);
// d1, d2: int32 [rows] fold_in data, each or both null for no fold.
__global__ void __launch_bounds__(THREADS)
threefry_bits_kernel(const int64_t* __restrict__ k1,
                     const int64_t* __restrict__ k2, uint32_t s1,
                     uint32_t s2, const int32_t* __restrict__ d1,
                     const int32_t* __restrict__ d2,
                     int64_t* __restrict__ out, long long rows,
                     long long n) {
  const long long col_stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.y; i < rows; i += gridDim.y) {
    uint32_t a = k1 ? (uint32_t)k1[i] : s1;
    uint32_t b = k2 ? (uint32_t)k2[i] : s2;
    if (d1) threefry2x32(a, b, 0u, (uint32_t)d1[i], a, b);
    if (d2) threefry2x32(a, b, 0u, (uint32_t)d2[i], a, b);
    int64_t* row = out + i * n;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < n; j += col_stride) {
      uint32_t w0, w1;
      threefry2x32(a, b, (uint32_t)((unsigned long long)j >> 32),
                   (uint32_t)((unsigned long long)j & 0xffffffffull), w0,
                   w1);
      row[j] = (int64_t)(w0 ^ w1);
    }
  }
}

}  // namespace

// k1, k2: int64 [rows] holding 32-bit key words, or null for the single
// key (s1, s2); d1, d2: int32 [rows] fold_in data, or null; out: int64
// [rows, n]. Returns the CUDA error of the launch (0 on success).
extern "C" int threefry_bits(const void* k1, const void* k2,
                             unsigned int s1, unsigned int s2,
                             const void* d1, const void* d2, void* out,
                             long long rows, long long n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long grid_y = rows < MAX_GRID_Y ? rows : MAX_GRID_Y;
  long long grid_x = (n + (long long)THREADS * COLS_PER_THREAD - 1) /
                     ((long long)THREADS * COLS_PER_THREAD);
  long long cap = MAX_BLOCKS / grid_y;
  if (cap < 1) cap = 1;
  if (grid_x > cap) grid_x = cap;
  threefry_bits_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y), THREADS,
                         0, (cudaStream_t)stream>>>(
      (const int64_t*)k1, (const int64_t*)k2, s1, s2, (const int32_t*)d1,
      (const int32_t*)d2, (int64_t*)out, rows, n);
  return (int)cudaGetLastError();
}
