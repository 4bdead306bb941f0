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
// fused_ce's design: each row is read from device memory once.
// - Persistent blocks of 512 threads (the SMs times the blocks an SM
//   holds, at most one block a row) walk the rows blockIdx.x, +
//   gridDim.x, ...; a row comes into dynamic shared memory by one TMA
//   bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes) of its
//   16-byte-aligned middle, completing on an mbarrier, while the
//   threads load the few head and tail elements that share a 16-byte
//   vector with the neighbouring row (a ragged V: bf16 at V = 50257).
// - Two row buffers where both fit (bf16: 2 x 64 KB at V = 32768, 2 x
//   98.3 KB at V = 50304): the next row's copy is in flight while this
//   one is reduced.
// - In shared memory, 16-byte reads: the row's max (warp shuffles, then
//   the block's warps), the sum of exp(x - max) and lse = m + log(max(l,
//   1e-30)), then dx computed from the buffer, rounded once to x's dtype
//   and stored 16 bytes at a time with the streaming hint; the target
//   logit is read from the buffer. The two exps an element are one
//   fused multiply-add and one ex2.approx each (expf's ~8 instructions
//   made the row's arithmetic, not its bytes, the limit at [8192, 32768]
//   bf16; tools/torch_train_kernels_ab.py, times in PERF.md, row 4).
// - A row too wide for one block's 227 KB (f32 above ~58k columns, bf16
//   above ~116k) is split over a thread block cluster of 2-4 blocks,
//   each holding a slice in its own shared memory; their (max, sum)
//   pairs merge through distributed shared memory (map_shared_rank).
// fused_ce.py's `_ce_fused_plan` picks the cluster, the slice and the
// buffers, and refuses a V no plan fits; `_card_plan` sizes the grid
// from fused_ce_resident_<dtype>.
//
// ce_fwd and ce_bwd: one block of 256 threads per row; a per-thread
// online (max, sum) pair merged across the block (warp shuffles, then
// shared memory) into lse = m + log(max(l, 1e-30)), the reference's
// logsumexp_finalize. The row width is the loop bound, so a ragged vocab
// needs no padding or mask: the Pallas kernels padded V to their
// 512-column tiles and masked them with n_valid_v. They read (and ce_bwd
// writes) the row in 16-byte vectors (8 bf16 or 4 f32 a load,
// neighbouring threads on neighbouring vectors). A row starts on a
// 16-byte boundary only when V * sizeof(x) is a multiple of 16 (not at V
// = 50257 in bf16), so the elements before the first boundary and after
// the last whole vector are handled one at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>

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

// ---------------------------------------------------------------------------
// The one-pass kernel: each row read once from device memory, into shared
// memory by one TMA bulk copy, and reduced there.

constexpr int FUSED_THREADS = 512;
constexpr int FUSED_WARPS = FUSED_THREADS / 32;
constexpr int MAX_BUFFERS = 2;
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
}

// the calling thread's arrival, expecting `bytes` more to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this block's shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 2^x by the special function unit (about 2 ulp; 0 for results below
// the normal range): with x = v * log2(e) - m * log2(e) in one fused
// multiply-add, exp(v - m) in two instructions where expf takes ~8. The
// exps (two an element) are this kernel's largest instruction count.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ void load_smem_vec(const unsigned char* p,
                                              float (&out)[Vec<T>::N]) {
  load_vec(reinterpret_cast<const T*>(p), out);
}

template <typename T>
__device__ __forceinline__ void store_vec_cs(T* p,
                                             const float (&in)[Vec<T>::N]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) store_out(&e[j], in[j]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// A block's segment of a row (its columns [s0, s0 + len)) laid out in a
// shared buffer as it lies in device memory modulo 16 bytes: element c
// at byte mis + c * sizeof(T), so 16-byte vector k of the buffer is the
// segment's 16-byte-aligned vector k of device memory. Vectors [k0, k1)
// are whole and come by the bulk copy; elements [0, hd) and [tl, len)
// share a vector with bytes outside the segment and are loaded by the
// threads; nv vectors hold the segment.
template <typename T>
struct Seg {
  const T* src;
  int mis, k0, k1, nv, hd, tl;
};

template <typename T>
__device__ __forceinline__ Seg<T> segment(const T* x, long long row, int V,
                                          int s0, int len) {
  constexpr int ES = sizeof(T);
  Seg<T> s;
  s.src = x + row * V + s0;
  s.mis = (int)(reinterpret_cast<uintptr_t>(s.src) & 15);
  const int end = s.mis + len * ES;
  s.k0 = s.mis ? 1 : 0;
  s.k1 = max(end >> 4, s.k0);
  s.nv = (end + 15) >> 4;
  s.hd = min(len, (16 * s.k0 - s.mis) / ES);
  s.tl = max(s.hd, (16 * s.k1 - s.mis) / ES);
  return s;
}

// thread 0: the bulk copy of a segment's whole vectors into buf
template <typename T>
__device__ __forceinline__ void start_copy(const Seg<T>& s,
                                           unsigned char* buf,
                                           uint64_t* bar) {
  const uint32_t bytes = 16u * (uint32_t)(s.k1 - s.k0);
  mbar_expect(bar, bytes);
  if (bytes)
    bulk_load(buf + 16 * s.k0,
              reinterpret_cast<const unsigned char*>(s.src) - s.mis +
                  16 * s.k0,
              bytes, bar);
}

// threads 0-31: the element of the segment's head (threads 0-15) or tail
// (16-31) this thread loads, or -1
template <typename T>
__device__ __forceinline__ int edge_col(const Seg<T>& s, int len, int tid) {
  if (tid < 16) return tid < s.hd ? tid : -1;
  if (tid < 32) {
    const int c = s.tl + tid - 16;
    return c < len ? c : -1;
  }
  return -1;
}

template <typename T>
__device__ __forceinline__ void put_edge(unsigned char* buf, int mis, int c,
                                         T val) {
  *reinterpret_cast<T*>(buf + mis + c * (int)sizeof(T)) = val;
}

// Loss and unit-cotangent d_logits of rows blockIdx.x / cluster, + the
// grid's clusters, ...: a cluster of `cluster` blocks splits each row
// into slices of `slice` columns, one a block, each read once into the
// block's shared memory. nbuf (1 or 2) row buffers of buf_bytes each:
// the next row's copy flies while this one is reduced.
template <typename T>
__global__ void __launch_bounds__(FUSED_THREADS, 2)
fused_ce_kernel(const T* __restrict__ x, const int64_t* __restrict__ tgt,
                float* __restrict__ loss, T* __restrict__ dx, int rows,
                int V, int cluster, int slice, int nbuf, int buf_bytes) {
  constexpr int N = Vec<T>::N, ES = sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[MAX_BUFFERS];
  __shared__ float red_m[FUSED_WARPS], red_l[FUSED_WARPS];
  __shared__ float2 slot[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank =
      cluster > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  const int first = blockIdx.x / cluster, stride = gridDim.x / cluster;
  const int s0 = rank * slice, len = max(min(V - s0, slice), 0);
  // x's rows lie as dx's modulo 16 bytes (x's base is 16-byte aligned,
  // as dx's is): whole vectors of dx are stored 16 bytes at a time
  const bool same = ((reinterpret_cast<uintptr_t>(x) ^
                      reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  if (tid == 0) {
    for (int b = 0; b < MAX_BUFFERS; ++b) mbar_init(&bar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the first nbuf - 1 rows, into buffers 0, 1, ...
  const long long ahead = (long long)(nbuf - 1) * stride;
  for (int j = 0; j + 1 < nbuf && first + (long long)j * stride < rows;
       ++j) {
    const Seg<T> s = segment(x, first + (long long)j * stride, V, s0, len);
    unsigned char* buf = smem + j * buf_bytes;
    if (tid == 0) start_copy(s, buf, &bar[j]);
    const int c = edge_col(s, len, tid);
    if (c >= 0) put_edge(buf, s.mis, c, s.src[c]);
  }
  __syncthreads();

  int i = 0;
  for (long long row = first; row < rows; row += stride, ++i) {
    const int b = i % nbuf;
    unsigned char* buf = smem + b * buf_bytes;
    const Seg<T> s = segment(x, row, V, s0, len);
    const int64_t t = tgt[row];
    // the row to fetch now: nbuf - 1 rows ahead into the buffer the last
    // row freed, or (one buffer) this one; its head and tail elements
    // held in a register until the buffer may take them
    const long long fetch = row + ahead;
    const int fb = (i + nbuf - 1) % nbuf;
    int ec = -1;
    T ev;
    Seg<T> fs;
    if (fetch < rows) {
      fs = segment(x, fetch, V, s0, len);
      if (tid == 0) start_copy(fs, smem + fb * buf_bytes, &bar[fb]);
      ec = edge_col(fs, len, tid);
      if (ec >= 0) ev = fs.src[ec];
    }
    if (nbuf == 1) {
      if (ec >= 0) put_edge(buf, fs.mis, ec, ev);
      __syncthreads();
    }
    mbar_wait(&bar[b], (uint32_t)((i / nbuf) & 1));

    // the segment's max: 16-byte shared reads, warp shuffles
    const int lead = s.mis / ES;   // buffer vector 0's lane of element 0
    float mx = NEG_INF;
    for (int k = tid; k < s.nv; k += FUSED_THREADS) {
      float v[N];
      load_smem_vec<T>(buf + 16 * k, v);
      if (k >= s.k0 && k < s.k1) {
#pragma unroll
        for (int j = 0; j < N; ++j) mx = fmaxf(mx, v[j]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int c = k * N + j - lead;
          if (c >= 0 && c < len) mx = fmaxf(mx, v[j]);
        }
      }
    }
    if (nbuf > 1 && ec >= 0) put_edge(smem + fb * buf_bytes, fs.mis, ec, ev);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red_m[warp] = mx;
    __syncthreads();
    mx = red_m[0];
#pragma unroll
    for (int w = 1; w < FUSED_WARPS; ++w) mx = fmaxf(mx, red_m[w]);

    // the sum of exp(x - max)
    const float mx2 = mx * LOG2E;
    float l = 0.f;
    for (int k = tid; k < s.nv; k += FUSED_THREADS) {
      float v[N];
      load_smem_vec<T>(buf + 16 * k, v);
      if (k >= s.k0 && k < s.k1) {
#pragma unroll
        for (int j = 0; j < N; ++j)
          l += exp2_approx(fmaf(v[j], LOG2E, -mx2));
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int c = k * N + j - lead;
          if (c >= 0 && c < len) l += exp2_approx(fmaf(v[j], LOG2E, -mx2));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) red_l[warp] = l;
    __syncthreads();
    l = red_l[0];
#pragma unroll
    for (int w = 1; w < FUSED_WARPS; ++w) l += red_l[w];

    // lse: the block's (max, sum), merged over the cluster's slices
    // through distributed shared memory
    float lse;
    if (cluster == 1) {
      lse = mx + logf(fmaxf(l, 1e-30f));
    } else {
      auto cl = cooperative_groups::this_cluster();
      if (tid == 0) slot[i & 1] = make_float2(mx, l);
      cl.sync();
      // (a cluster holds at most 4 blocks; unrolled, part stays in
      // registers)
      float2 part[4];
      float m_all = NEG_INF, l_all = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        part[r] = r < cluster ? *cl.map_shared_rank(&slot[i & 1], r)
                              : make_float2(NEG_INF, 0.f);
        m_all = fmaxf(m_all, part[r].x);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) l_all += part[r].y * expf(part[r].x - m_all);
      lse = m_all + logf(fmaxf(l_all, 1e-30f));
    }

    // the loss, by the block holding the target (rank 0 when the target
    // is out of range and gathers nothing); the target logit from the
    // buffer
    const bool hit = t >= 0 && t < V;
    const int tloc = (hit && t >= s0 && t < s0 + len) ? (int)(t - s0) : -1;
    if (tid == 0) {
      if (tloc >= 0)
        loss[row] = lse - to_f32(*reinterpret_cast<const T*>(
                              buf + s.mis + tloc * ES));
      else if (!hit && rank == 0)
        loss[row] = lse;
    }

    // dx = softmax - onehot, rounded once to T, streamed to device memory
    const float lse2 = lse * LOG2E;
    T* dst = dx + row * V + s0;
    unsigned char* dvec = reinterpret_cast<unsigned char*>(dst) - s.mis;
    for (int k = tid; k < s.nv; k += FUSED_THREADS) {
      float v[N];
      load_smem_vec<T>(buf + 16 * k, v);
      const int c0 = k * N - lead;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[j] = exp2_approx(fmaf(v[j], LOG2E, -lse2));
        if (c0 + j == tloc) v[j] -= 1.f;
      }
      if (same && k >= s.k0 && k < s.k1) {
        store_vec_cs(reinterpret_cast<T*>(dvec + 16 * k), v);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (c0 + j >= 0 && c0 + j < len) store_out(&dst[c0 + j], v[j]);
      }
    }
    __syncthreads();   // the buffer is free for the copy after next
  }
  // no block leaves while a peer may still read its slots
  if (cluster > 1) cooperative_groups::this_cluster().sync();
}

template <typename T>
int fused_prepare() {
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    int optin = 0;
    cudaFuncAttributes attr;
    if ((e = cudaDeviceGetAttribute(&optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess ||
        (e = cudaFuncGetAttributes(&attr, fused_ce_kernel<T>)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(
             fused_ce_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             optin - (int)attr.sharedSizeBytes)) != cudaSuccess)
      return (int)e;
    done[dev] = true;
  }
  return 0;
}

template <typename T>
cudaLaunchConfig_t fused_config(int grid, int smem, void* stream,
                                cudaLaunchAttribute* attr, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(FUSED_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// clusters (blocks, at cluster 1) of the plan the card holds at once
template <typename T>
int fused_resident(int cluster, int smem, int* out) {
  if (int e = fused_prepare<T>()) return e;
  cudaError_t e;
  if (cluster == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fused_ce_kernel<T>, FUSED_THREADS, smem)) !=
            cudaSuccess)
      return (int)e;
    *out = sms * per_sm;
    return 0;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = fused_config<T>(cluster, smem, nullptr, attr,
                                           cluster);
  e = cudaOccupancyMaxActiveClusters(out, fused_ce_kernel<T>, &cfg);
  return (int)e;
}

template <typename T>
int fused_launch(const void* x, const void* tgt, void* loss, void* dx,
                 int rows, int V, int cluster, int slice, int nbuf,
                 int buf_bytes, int grid, void* stream) {
  if (rows <= 0 || V <= 0 || cluster < 1 || cluster > 4 || slice <= 0 ||
      (long long)slice * cluster < V || nbuf < 1 || nbuf > MAX_BUFFERS ||
      buf_bytes % 128 || grid <= 0 || grid % cluster)
    return (int)cudaErrorInvalidValue;
  if (int e = fused_prepare<T>()) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = fused_config<T>(grid, nbuf * buf_bytes, stream,
                                           attr, cluster);
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, fused_ce_kernel<T>, (const T*)x, (const int64_t*)tgt,
      (float*)loss, (T*)dx, rows, V, cluster, slice, nbuf, buf_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. x [T, V], target [T] int64,
// loss, lse and g [T] f32, dx [T, V] in x's dtype, all contiguous. Each
// returns cudaGetLastError() after the launch (0 = launched).
// fused_ce_<dtype> takes its plan from fused_ce.py's _card_plan
// (cluster size, columns a block, row buffers, bytes a buffer, blocks);
// fused_ce_resident_<dtype>(cluster, shared bytes, &n) gives the
// clusters (blocks, at cluster 1) of that shape the card holds at once.
#define CE_ENTRIES(SUFFIX, TYPE)                                             \
  extern "C" int fused_ce_##SUFFIX(                                         \
      const void* x, const void* tgt, void* loss, void* dx, int T, int V,    \
      int cluster, int slice, int nbuf, int buf_bytes, int grid,             \
      void* stream) {                                                        \
    return fused_launch<TYPE>(x, tgt, loss, dx, T, V, cluster, slice, nbuf,  \
                              buf_bytes, grid, stream);                      \
  }                                                                          \
  extern "C" int fused_ce_resident_##SUFFIX(int cluster, int smem,           \
                                            int* out) {                      \
    return fused_resident<TYPE>(cluster, smem, out);                         \
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
