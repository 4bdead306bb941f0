// Softmax cross-entropy for NVIDIA Hopper (sm_90a): the one-pass kernel
// that emits the loss and its gradient together, and the two-pass pair
// (forward saving the row's logsumexp, backward from it).
//
//   lse[t]   = logsumexp(x[t, :])                               (f32)
//   loss[t]  = lse[t] - x[t, target[t]]                         (f32)
//   dx[t, v] = (softmax(x[t, :])[v] - (v == target[t])) * g[t]  (x's dtype)
//
// x is [T, V] row-major, bf16 or f32; target is [T] int64. A target
// outside [0, V) gathers nothing (its loss is the row's lse) and puts
// no -1 in dx, as the Pallas kernels' masked one-hot does.
//
// Replaces three TPU kernels of paddle_tpu/kernels/pallas_ce.py:
// - fused_ce_kernel: `_ce_fused` (pl.pallas_call :143, body
//   _fused_kernel :80), which ce_fused_train (:272) calls once per
//   training step: loss and the unit-cotangent d_logits (g = 1) in one
//   launch, so the backward is a per-row scale of dx;
// - ce_fwd_kernel: `_ce_fwd` (pl.pallas_call :179, body _fwd_kernel
//   :34), the forward of ce_with_logits (:246): loss and lse, the
//   target logit gathered in the same pass;
// - ce_bwd_kernel: `_ce_bwd` (pl.pallas_call :218, body _bwd_kernel
//   :69), its backward: d_logits from the saved lse, scaled by the
//   cotangent and rounded once to x's dtype (pallas_ce.py:77).
// Reference analog: phi/kernels/gpu/cross_entropy_kernel.cu (the fused
// softmax_with_cross_entropy kernel and its grad).
//
// What bounds them on an H100: bytes; the exps are far below the card's
// rate. At T = 8192, V = 32000 bf16: ce_fwd reads the logits once (524
// MB, 0.157 ms at 3.35 TB/s), ce_bwd reads them and writes dx (0.313
// ms), fused_ce does both (0.313 ms at V = 32000, 0.32 ms at 32768).
//
// Design (simple and right first): one block of 256 threads per row;
// a per-thread online (max, sum) pair merged across the block (warp
// shuffles, then shared memory) into lse = m + log(max(l, 1e-30)), the
// reference's logsumexp_finalize. The row width is the loop bound, so a
// ragged vocab needs no padding or mask: the Pallas kernels padded V to
// their 512-column tiles and masked them with n_valid_v.
// - ce_fwd and ce_bwd read (and ce_bwd writes) the row in 16-byte
//   vectors (8 bf16 or 4 f32 a load, neighbouring threads on
//   neighbouring vectors). A row starts on a 16-byte boundary only when
//   V * sizeof(x) is a multiple of 16 (not at V = 50257 in bf16), so
//   the elements before the first boundary and after the last whole
//   vector are handled one at a time.
// - fused_ce reads the row twice, element by element: sweep 1 for the
//   lse, sweep 2 for dx. Reading the row once (it fits in shared
//   memory: 64 KB of bf16 at V = 32768) is the next step toward its
//   byte bound.

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

// elements of T in one 16-byte vector
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[Vec<T>::N]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) out[j] = to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[Vec<T>::N]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) store_out(&e[j], in[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

// A row of V elements at `row` as [0, head) scalars, nvec whole 16-byte
// vectors from head on, and the rest scalars.
struct RowSplit {
  int head, nvec;
};

template <typename T>
__device__ __forceinline__ RowSplit row_split(const T* row, int V) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(T));
  int head = mis ? Vec<T>::N - mis : 0;
  if (head > V) head = V;
  return {head, (V - head) / Vec<T>::N};
}

// merge two online-softmax states (m, l) into (m, l)
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// fold one value into a thread's online (m, l)
__device__ __forceinline__ void online_add(float& m, float& l, float s) {
  if (s > m) {
    l = l * expf(m - s) + 1.f;
    m = s;
  } else {
    l += expf(s - m);
  }
}

// The block's log-normalizer from each thread's (m, l), valid in thread
// 0 only. Ends with the block synchronised.
__device__ __forceinline__ float block_lse(float m, float l, float* sm_m,
                                           float* sm_l) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  float mb = sm_m[0], lb = sm_l[0];
  if (tid == 0)
    for (int w = 1; w < WARPS; ++w) merge(mb, lb, sm_m[w], sm_l[w]);
  return mb + logf(fmaxf(lb, 1e-30f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ce_kernel(const T* __restrict__ x, const int64_t* __restrict__ tgt,
                float* __restrict__ loss, T* __restrict__ dx, int V) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float row_lse;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  T* dr = dx + row * V;

  float m = NEG_INF, l = 0.f;
  for (int c = tid; c < V; c += THREADS) online_add(m, l, to_f32(xr[c]));
  const float lse_b = block_lse(m, l, sm_m, sm_l);
  if (tid == 0) {
    const int64_t t = tgt[row];
    const float tv = (t >= 0 && t < V) ? to_f32(xr[t]) : 0.f;
    loss[row] = lse_b - tv;
    row_lse = lse_b;
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
__global__ void __launch_bounds__(THREADS)
ce_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ tgt,
              float* __restrict__ loss, float* __restrict__ lse_out, int V) {
  constexpr int N = Vec<T>::N;
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float s_tv;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  const int64_t t = tgt[row];
  if (tid == 0) s_tv = 0.f;
  __syncthreads();

  // the one thread whose element is the target writes it to s_tv
  float m = NEG_INF, l = 0.f;
  const RowSplit rs = row_split(xr, V);
  const int tail = rs.head + rs.nvec * N;
  for (int c = tid; c < rs.head; c += THREADS) {
    const float s = to_f32(xr[c]);
    online_add(m, l, s);
    if (c == t) s_tv = s;
  }
  for (int i = tid; i < rs.nvec; i += THREADS) {
    const int c0 = rs.head + i * N;
    float v[N];
    load_vec(xr + c0, v);
    float vm = v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) vm = fmaxf(vm, v[j]);
    if (vm > m) {
      l *= expf(m - vm);
      m = vm;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      l += expf(v[j] - m);
      if (c0 + j == t) s_tv = v[j];
    }
  }
  for (int c = tail + tid; c < V; c += THREADS) {
    const float s = to_f32(xr[c]);
    online_add(m, l, s);
    if (c == t) s_tv = s;
  }
  const float lse = block_lse(m, l, sm_m, sm_l);
  if (tid == 0) {
    loss[row] = lse - s_tv;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ce_bwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ tgt,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dx, int V) {
  constexpr int N = Vec<T>::N;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  T* dr = dx + row * V;
  const int64_t t = tgt[row];
  const float lr = lse[row], gr = g[row];

  RowSplit rs = row_split(xr, V);
  if ((reinterpret_cast<uintptr_t>(xr) ^ reinterpret_cast<uintptr_t>(dr))
      & 15)
    rs = {V, 0};  // x and dx differ in alignment: all scalar
  const int tail = rs.head + rs.nvec * N;
  for (int c = tid; c < rs.head; c += THREADS)
    store_out(&dr[c], (expf(to_f32(xr[c]) - lr) - (c == t ? 1.f : 0.f)) * gr);
  for (int i = tid; i < rs.nvec; i += THREADS) {
    const int c0 = rs.head + i * N;
    float v[N];
    load_vec(xr + c0, v);
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] = (expf(v[j] - lr) - (c0 + j == t ? 1.f : 0.f)) * gr;
    store_vec(dr + c0, v);
  }
  for (int c = tail + tid; c < V; c += THREADS)
    store_out(&dr[c], (expf(to_f32(xr[c]) - lr) - (c == t ? 1.f : 0.f)) * gr);
}

int check(int T_, int V) {
  return (T_ <= 0 || V <= 0) ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. x [T, V], target [T] int64,
// loss, lse and g [T] f32, dx [T, V] in x's dtype, all contiguous. Each
// returns cudaGetLastError() after the launch (0 = launched).
#define CE_ENTRIES(SUFFIX, TYPE)                                             \
  extern "C" int fused_ce_##SUFFIX(const void* x, const void* tgt,           \
                                   void* loss, void* dx, int T, int V,       \
                                   void* stream) {                           \
    if (int e = check(T, V)) return e;                                       \
    fused_ce_kernel<TYPE><<<T, THREADS, 0, (cudaStream_t)stream>>>(          \
        (const TYPE*)x, (const int64_t*)tgt, (float*)loss, (TYPE*)dx, V);    \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int ce_fwd_##SUFFIX(const void* x, const void* tgt, void* loss, \
                                 void* lse, int T, int V, void* stream) {    \
    if (int e = check(T, V)) return e;                                       \
    ce_fwd_kernel<TYPE><<<T, THREADS, 0, (cudaStream_t)stream>>>(            \
        (const TYPE*)x, (const int64_t*)tgt, (float*)loss, (float*)lse, V);  \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int ce_bwd_##SUFFIX(const void* x, const void* tgt,             \
                                 const void* lse, const void* g, void* dx,   \
                                 int T, int V, void* stream) {               \
    if (int e = check(T, V)) return e;                                       \
    ce_bwd_kernel<TYPE><<<T, THREADS, 0, (cudaStream_t)stream>>>(            \
        (const TYPE*)x, (const int64_t*)tgt, (const float*)lse,              \
        (const float*)g, (TYPE*)dx, V);                                      \
    return (int)cudaGetLastError();                                          \
  }

CE_ENTRIES(bf16, __nv_bfloat16)
CE_ENTRIES(f32, float)
