// Fused weight-only int8 dequant-matmul for NVIDIA Hopper (sm_90a).
//
//   y[M, N] = (x[M, K] . w_q[K, N]) * scale[N]     (f32 accumulator)
//
// Replaces the TPU kernel paddle_tpu/kernels/quant_matmul.py::
// _pallas_quant_matmul (pl.pallas_call at :181, body _qmm_kernel :153).
// Reference analog, as the JAX module cites it: the int8 matmul of the
// kernel-substitution pass quant2_int8_mkldnn_pass.py (int8 weights,
// float activations, dequant fused into the epilogue), restricted to
// the weight-only form of weight-only int8 serving.
//
// Operands: x is bf16 or f32, row-major [M, K]; w_q is int8, row-major
// [K, N] with N contiguous; scale is f32 [N] (the stored abs-max / 127).
// The result is written in x's dtype, rounded to nearest even, exactly
// as torch's .to(x.dtype) rounds the f32 value acc * scale[n].
//
// What bounds it on an H100: at decode M is the number of slots (8),
// so every weight byte is read once and used M times — the kernel is
// bound by the int8 weight bytes (K*N) over 3.35 TB/s. At a large-M
// prefill (M = 512) it is bound by the 2*M*K*N operations.
//
// Design (the first, simple and right one):
// - One block owns a BM x BN = 16 x 128 output tile, 256 threads; each
//   thread holds 2 rows x 4 adjacent columns of f32 accumulators.
// - The block loops over K in BK = 64 chunks. The x chunk goes to
//   shared memory as f32; the int8 w chunk goes to shared memory as
//   16-byte vectors along N (a masked scalar path covers the ragged N/K
//   edge and unaligned weights). No float copy of the weight ever exists
//   in device memory: int8 converts to f32 in registers.
// - The kernel masks the ragged M/N/K edges itself (the Pallas wrapper
//   padded to block multiples instead).
// - At decode shapes M <= BM, so each weight byte is read from device
//   memory exactly once.
//
// Later work, not here: wgmma tensor-core operands with TMA staging and
// split-K for the skinny decode shapes. bf16 x int8 products are exact
// in f32 (8 + 8 significant bits), so a tensor-core version changes
// only the order of summation, not the products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, T* __restrict__ y,
           int M, int K, int N, int vec_w) {
  __shared__ float xs[BM][BK];                    // 4 KB
  __shared__ __align__(16) int8_t ws[BK][BN];     // 8 KB

  const int tid = threadIdx.x;
  const int tx = tid & 31;        // columns tx*4 .. tx*4+3 of the tile
  const int ty = tid >> 5;        // rows ty*2, ty*2+1 (one per warp)
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x chunk: BM*BK values, 4 per thread, consecutive threads on
    // consecutive k
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    // w chunk: BK*BN bytes = 512 vectors of 16 bytes, 2 per thread
#pragma unroll
    for (int i = 0; i < (BK * BN) / (16 * THREADS); ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BN / 16);
      const int c = (v % (BN / 16)) * 16;
      const int k = k0 + r, n = n0 + c;
      if (vec_w && k < K && n + 16 <= N) {
        *reinterpret_cast<int4*>(&ws[r][c]) =
            __ldg(reinterpret_cast<const int4*>(w + (size_t)k * N + n));
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          ws[r][c + j] = (k < K && n + j < N) ? w[(size_t)k * N + n + j]
                                              : (int8_t)0;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const char4 wv = *reinterpret_cast<const char4*>(&ws[kk][tx * 4]);
      const float wf[4] = {(float)wv.x, (float)wv.y, (float)wv.z,
                           (float)wv.w};
      const float x0 = xs[ty * 2][kk];
      const float x1 = xs[ty * 2 + 1][kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[0][c] = fmaf(x0, wf[c], acc[0][c]);
        acc[1][c] = fmaf(x1, wf[c], acc[1][c]);
      }
    }
    __syncthreads();
  }

  // epilogue: per-output-channel scale on the f32 accumulator, one
  // rounding to the output dtype
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + ty * 2 + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < N) store_out(&y[(size_t)m * N + n], acc[r][c] * scale[n]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* y, int M,
           int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int vec_w = (N % 16 == 0) && ((uintptr_t)w % 16 == 0);
  qmm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(y), M, K, N, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every pointer and the stream are
// passed as void*; the return value is cudaGetLastError() after the
// launch (0 = launched).
extern "C" int quant_matmul_bf16(const void* x, const void* w,
                                 const void* scale, void* y, int M, int K,
                                 int N, void* stream) {
  return launch<__nv_bfloat16>(x, w, scale, y, M, K, N, stream);
}

extern "C" int quant_matmul_f32(const void* x, const void* w,
                                const void* scale, void* y, int M, int K,
                                int N, void* stream) {
  return launch<float>(x, w, scale, y, M, K, N, stream);
}
