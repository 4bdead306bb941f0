// One-pass softmax cross-entropy and its gradient for NVIDIA Hopper (sm_90a).
//
//   loss[t]  = logsumexp(x[t, :]) - x[t, target[t]]            (f32)
//   dx[t, v] = softmax(x[t, :])[v] - (v == target[t])          (x's dtype)
//
// x is [T, V] row-major, bf16 or f32; target is [T] int64. A target
// outside [0, V) gathers nothing (its loss is the row's lse) and puts
// no -1 in dx, as the Pallas kernel's masked one-hot does.
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas_ce.py::_ce_fused
// (pl.pallas_call :143, body _fused_kernel :80), which ce_fused_train
// (:272) calls once per training step: loss and the unit-cotangent
// d_logits in one launch, so the backward is a per-row scale of dx.
// Reference analog: phi/kernels/gpu/cross_entropy_kernel.cu (the fused
// softmax_with_cross_entropy kernel and its grad).
//
// What bounds it on an H100: bytes. The least work reads the logits once
// and writes dx once: at T = 8192, V = 32768 bf16 that is 1.07 GB, about
// 0.32 ms at 3.35 TB/s; the exps are far below the card's rate.
//
// Design (simple and right first): one block of 256 threads per row.
// Sweep 1 reads the row with coalesced loads and keeps a per-thread
// online (max, sum) pair, one exp per element; the pairs merge across
// the block (shuffles, then shared memory) into lse = m + log(max(l,
// 1e-30)). Sweep 2 reads the row again and writes (exp(x - lse) -
// onehot) rounded once to x's dtype. The row width is the loop bound,
// so a ragged vocab needs no padding or mask: the Pallas kernel padded
// V to its 512-column tiles and masked them with n_valid_v. Reading the
// row once (it fits in shared memory: 64 KB of bf16 at V = 32768) is
// the next step toward the byte bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// merge two online-softmax states (m, l) into (m, l)
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ce_kernel(const T* __restrict__ x, const int64_t* __restrict__ tgt,
                float* __restrict__ loss, T* __restrict__ dx, int V) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float row_lse;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  T* dr = dx + row * V;

  float m = NEG_INF, l = 0.f;
  for (int c = tid; c < V; c += THREADS) {
    const float s = to_f32(xr[c]);
    if (s > m) {
      l = l * expf(m - s) + 1.f;
      m = s;
    } else {
      l += expf(s - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  __syncthreads();
  if (tid == 0) {
    float mb = sm_m[0], lb = sm_l[0];
    for (int w = 1; w < WARPS; ++w) merge(mb, lb, sm_m[w], sm_l[w]);
    const float lse = mb + logf(fmaxf(lb, 1e-30f));
    const int64_t t = tgt[row];
    const float tv = (t >= 0 && t < V) ? to_f32(xr[t]) : 0.f;
    loss[row] = lse - tv;
    row_lse = lse;
  }
  __syncthreads();

  const float lse = row_lse;
  const int64_t t = tgt[row];
  for (int c = tid; c < V; c += THREADS) {
    const float p = expf(to_f32(xr[c]) - lse);
    store_out(&dr[c], c == t ? p - 1.f : p);
  }
}

template <typename T>
int launch(const void* x, const void* tgt, void* loss, void* dx, int T_,
           int V, void* stream) {
  if (T_ <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  fused_ce_kernel<T><<<T_, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(tgt),
      static_cast<float*>(loss), static_cast<T*>(dx), V);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes: x [T, V], target [T] int64,
// loss [T] f32, dx [T, V] in x's dtype, all contiguous. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_ce_bf16(const void* x, const void* tgt, void* loss,
                             void* dx, int T, int V, void* stream) {
  return launch<__nv_bfloat16>(x, tgt, loss, dx, T, V, stream);
}

extern "C" int fused_ce_f32(const void* x, const void* tgt, void* loss,
                            void* dx, int T, int V, void* stream) {
  return launch<float>(x, tgt, loss, dx, T, V, stream);
}
