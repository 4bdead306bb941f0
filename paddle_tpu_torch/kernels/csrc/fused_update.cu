// AdamW over a table of parameter leaves for NVIDIA Hopper (sm_90a), in
// place, one launch for every leaf of the table:
//
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   p' = p * (1 - lr * wd) - lr * (m' / bc1) / (sqrt(v' / bc2) + eps)
//
// g is read in its dtype and widened to f32; m and v are f32; p is read
// in its dtype (f32 or bf16), updated in f32 and stored back in its
// dtype. Every leaf of one launch has the same (p, g) dtype pair. The
// hyperparameters arrive as a device f32 vector [lr, b1, b2, eps, wd,
// bc1, bc2] (bc1, bc2 depend on the step count), so a step needs no host
// synchronisation and no rebuild.
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
// Design: one launch over a table of leaves passed BY VALUE as a kernel
// parameter (no host-to-device copy a step, nothing a CUDA graph would
// have to re-point). Each entry holds the leaf's p, g, m and v pointers,
// its element count, whether all four start on a 16-byte boundary, and
// the index of its first CHUNK-element chunk; the table fits the 4 KB
// kernel-parameter limit (TABLE_LEAVES entries), and a longer list of
// leaves goes in several launches. The grid is persistent (the SMs times
// the blocks an SM holds); each block walks the chunks c = blockIdx.x,
// + gridDim.x, ..., finds a chunk's leaf by a binary search over the
// entries' first chunks, and each thread holds UNROLL 16-byte vectors
// (8-byte for bf16) of each of p, g, m and v in flight before it
// computes. Plain loads and stores: with the streaming hint (__ldcs,
// __stcs) the full-depth tree took longer on an H100
// (tools/torch_train_kernels_ab.py, times in PERF.md, row 7). An
// unaligned leaf, and each leaf's last n % 4 elements, go one element
// at a time. Every operation is
// rounded on its own (__fmul_rn, __fadd_rn, ...: no fused multiply-add),
// in _update_kernel's order (pallas_update.py:51-59), so the kernel
// reproduces a plain f32 evaluation of the same expression exactly.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                      // vectors in flight a thread
constexpr int CHUNK = THREADS * UNROLL * 4;    // elements a chunk: 4096
constexpr int TABLE_LEAVES = 80;               // entries a launch
constexpr int MAX_DEVICES = 64;

struct Leaf {
  void* p;
  const void* g;
  float* m;
  float* v;
  long long n;
  int chunk0;  // the leaf's first chunk in the launch
  int vec;     // p, g, m and v all start on a 16-byte boundary
};

struct Table {
  Leaf leaf[TABLE_LEAVES];
  const float* hp;
  int count;
  int chunks;
};
static_assert(sizeof(Table) <= 4096, "the table must fit the 4 KB "
                                     "kernel-parameter limit");

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
leaves_update_kernel(const __grid_constant__ Table tab) {
  const HP h = load_hp(tab.hp);
  const int tid = threadIdx.x;
  for (int c = blockIdx.x; c < tab.chunks; c += gridDim.x) {
    // the leaf of chunk c: the last entry whose first chunk is <= c
    int lo = 0, hi = tab.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab.leaf[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    const Leaf& L = tab.leaf[lo];
    P* __restrict__ p = static_cast<P*>(L.p);
    const G* __restrict__ g = static_cast<const G*>(L.g);
    float* __restrict__ m = L.m;
    float* __restrict__ v = L.v;
    const long long start = (long long)(c - L.chunk0) * CHUNK;
    const long long stop = min(start + (long long)CHUNK, L.n);
    const long long vstop = L.vec ? start + ((stop - start) & ~3LL) : start;

    // every load of the chunk's vectors first, then the arithmetic
    float pf[UNROLL][4], gf[UNROLL][4], mf[UNROLL][4], vf[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = start + 4LL * (u * THREADS + tid);
      if (e < vstop) {
        load4(p + e, pf[u]);
        load4(g + e, gf[u]);
        load4(m + e, mf[u]);
        load4(v + e, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = start + 4LL * (u * THREADS + tid);
      if (e < vstop) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pf[u][j] = adamw(h, pf[u][j], gf[u][j], mf[u][j], vf[u][j]);
        store4(p + e, pf[u]);
        store4(m + e, mf[u]);
        store4(v + e, vf[u]);
      }
    }
    // an unaligned leaf's chunk, or the last n % 4 elements
    for (long long i = vstop + tid; i < stop; i += THREADS) {
      float mi = m[i], vi = v[i];
      const float pi = adamw(h, to_f32(p[i]), to_f32(g[i]), mi, vi);
      store(&p[i], pi);
      m[i] = mi;
      v[i] = vi;
    }
  }
}

// blocks the whole card holds at once, per device (0 = not asked yet)
template <typename P, typename G>
int resident_blocks() {
  static int cache[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, leaves_update_kernel<P, G>, THREADS, 0) != cudaSuccess)
      return 0;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[dev];
}

template <typename P, typename G>
int launch(void* const* ptrs, const long long* n, const int* vec,
           const int* chunk0, int count, int chunks, const void* hp,
           void* stream) {
  if (count <= 0 || count > TABLE_LEAVES || chunks <= 0)
    return (int)cudaErrorInvalidValue;
  Table tab;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) return (int)cudaErrorInvalidValue;
    tab.leaf[i] = {ptrs[4 * i], ptrs[4 * i + 1],
                   static_cast<float*>(ptrs[4 * i + 2]),
                   static_cast<float*>(ptrs[4 * i + 3]), n[i], chunk0[i],
                   vec[i]};
  }
  tab.hp = static_cast<const float*>(hp);
  tab.count = count;
  tab.chunks = chunks;
  const int resident = resident_blocks<P, G>();
  if (resident <= 0) {
    const int err = (int)cudaGetLastError();
    return err ? err : (int)cudaErrorUnknown;
  }
  const int blocks = chunks < resident ? chunks : resident;
  leaves_update_kernel<P, G><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      tab);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// leaves_update_<p dtype>_<g dtype>(ptrs, n, vec, chunk0, count, chunks,
// hp, stream): one launch over `count` (<= leaves_update_capacity())
// leaves; ptrs holds each leaf's p, g, m, v (4 a leaf, m and v f32), n
// its element count, vec 1 where all four start on a 16-byte boundary,
// chunk0 the index of its first 4096-element chunk (the chunks of the
// launch numbered leaf after leaf), chunks their total; hp is the device
// f32 [7] hyperparameter vector. p, m and v are updated in place.
// Returns cudaGetLastError() after the launch (0 = launched).
#define LEAVES_ENTRY(NAME, PT, GT)                                          \
  extern "C" int NAME(void* const* ptrs, const long long* n, const int* vec, \
                      const int* chunk0, int count, int chunks,             \
                      const void* hp, void* stream) {                       \
    return launch<PT, GT>(ptrs, n, vec, chunk0, count, chunks, hp, stream); \
  }

LEAVES_ENTRY(leaves_update_f32_f32, float, float)
LEAVES_ENTRY(leaves_update_f32_bf16, float, __nv_bfloat16)
LEAVES_ENTRY(leaves_update_bf16_f32, __nv_bfloat16, float)
LEAVES_ENTRY(leaves_update_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

// the table's entries and a chunk's elements, for the host planner
extern "C" int leaves_update_capacity() { return TABLE_LEAVES; }
extern "C" int leaves_update_chunk() { return CHUNK; }
