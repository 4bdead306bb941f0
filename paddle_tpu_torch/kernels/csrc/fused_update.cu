// AdamW on one parameter leaf for NVIDIA Hopper (sm_90a), in place:
//
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   p' = p * (1 - lr * wd) - lr * (m' / bc1) / (sqrt(v' / bc2) + eps)
//
// g is read in its dtype and widened to f32; m and v are f32; p is read
// in its dtype (f32 or bf16), updated in f32 and stored back in its
// dtype. The hyperparameters arrive as a device f32 vector
// [lr, b1, b2, eps, wd, bc1, bc2] (bc1, bc2 depend on the step count),
// so a step needs no host synchronisation and no rebuild.
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas_update.py::
// _leaf_update (pl.pallas_call :87, body _update_kernel :37), which
// fused_apply_adamw (:102) launches once per leaf. Reference analog:
// phi/kernels/gpu/adamw_kernel.cu (one pass reading p/g/m/v and writing
// p/m/v with f32 master math).
//
// What bounds it on an H100: bytes. Per f32 parameter it reads p, g, m,
// v and writes p, m, v: 28 bytes, about 10 flops. Over the 1,034,512,384
// parameters of the TinyLlama-width tree that is 29.0 GB, 8.65 ms at
// 3.35 TB/s; the arithmetic is far below the card's rate.
//
// Design (simple and right first): a grid-stride loop, each thread
// updating 4 elements at a time with 16-byte loads of m and v and 16-
// (f32) or 8-byte (bf16) loads of p and g; a leaf whose pointers are not
// all 16-byte aligned, and the last n % 4 elements, go one at a time.
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, ...: no
// fused multiply-add), in _update_kernel's order (pallas_update.py:
// 51-59), so the kernel reproduces a plain f32 evaluation of the same
// expression exactly. One launch per leaf, as the Pallas kernel; one
// launch over a table of every leaf's pointers is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks of 256 per H100 SM

struct HP {
  float lr, b1, b2, eps, bc1, bc2, c1, c2, decay;
};

__device__ __forceinline__ HP load_hp(const float* __restrict__ hp) {
  HP h;
  h.lr = hp[0];
  h.b1 = hp[1];
  h.b2 = hp[2];
  h.eps = hp[3];
  const float wd = hp[4];
  h.bc1 = hp[5];
  h.bc2 = hp[6];
  h.c1 = __fsub_rn(1.f, h.b1);
  h.c2 = __fsub_rn(1.f, h.b2);
  h.decay = __fsub_rn(1.f, __fmul_rn(h.lr, wd));
  return h;
}

// one element: returns p', updates m and v
__device__ __forceinline__ float adamw(const HP& h, float p, float g,
                                       float& m, float& v) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.c2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps);
  return __fsub_rn(__fmul_rn(p, h.decay),
                   __fdiv_rn(__fmul_rn(h.lr, __fdiv_rn(m, h.bc1)), den));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 4 consecutive elements of a 16-byte-aligned leaf (8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  uint2 u;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __float2bfloat16_rn(o[j]);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS)
leaf_update_kernel(P* __restrict__ p, const G* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   const float* __restrict__ hp, long long n, int vec) {
  const HP h = load_hp(hp);
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = first; i < n4; i += stride) {
    float pf[4], gf[4], mf[4], vf[4];
    load4(p + 4 * i, pf);
    load4(g + 4 * i, gf);
    load4(m + 4 * i, mf);
    load4(v + 4 * i, vf);
#pragma unroll
    for (int j = 0; j < 4; ++j) pf[j] = adamw(h, pf[j], gf[j], mf[j], vf[j]);
    store4(p + 4 * i, pf);
    store4(m + 4 * i, mf);
    store4(v + 4 * i, vf);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    const float pi = adamw(h, to_f32(p[i]), to_f32(g[i]), mi, vi);
    store(&p[i], pi);
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename P, typename G>
int launch(void* p, const void* g, void* m, void* v, const void* hp,
           long long n, int vec, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long work = vec ? (n + 3) / 4 : n;
  const long long want = (work + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  leaf_update_kernel<P, G><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<const float*>(hp), n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes: leaf_update_<p dtype>_<g dtype>.
// p, g, m, v hold n contiguous elements (m, v f32) and are updated in
// place (p, m, v); hp is the device f32 [7] hyperparameter vector; vec
// = 1 when p, g, m and v all start on a 16-byte boundary. Returns
// cudaGetLastError() after the launch (0 = launched).
#define LEAF_ENTRY(NAME, PT, GT)                                            \
  extern "C" int NAME(void* p, const void* g, void* m, void* v,             \
                      const void* hp, long long n, int vec, void* stream) { \
    return launch<PT, GT>(p, g, m, v, hp, n, vec, stream);                  \
  }

LEAF_ENTRY(leaf_update_f32_f32, float, float)
LEAF_ENTRY(leaf_update_f32_bf16, float, __nv_bfloat16)
LEAF_ENTRY(leaf_update_bf16_f32, __nv_bfloat16, float)
LEAF_ENTRY(leaf_update_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
