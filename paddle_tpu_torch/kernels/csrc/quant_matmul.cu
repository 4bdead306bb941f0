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
// [K, N] with N contiguous (the reference's layout: no repacked copy of
// the weights exists); scale is f32 [N] (the stored abs-max / 127). The
// result is written in x's dtype, rounded to nearest even, exactly as
// torch's .to(x.dtype) rounds the f32 value acc * scale[n].
//
// What bounds it on an H100: at decode M is the number of slots (8), so
// every weight byte is read once and used M times: the kernel is bound
// by the int8 weight bytes (K*N) over 3.35 TB/s. At a large-M prefill
// (M = 128, 512) it is bound by the 2*M*K*N operations.
//
// bf16 x (every serving path): qmm_mma_kernel, on tensor cores.
// - It computes y^T = w^T x^T with mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators): the weight is the A operand (16 output columns a
//   product) and x the B operand, so the 8 slots of a decode tick are
//   exactly the n8 of one product and no half of a product is padding,
//   as it would be with x as A (rows 8-15 zero).
// - int8 -> bf16 is exact (|w| <= 127 fits bf16's 8-bit significand) and
//   bf16 x int8 products are exact in f32, so the result differs from the
//   reference's f32 dot only in the order of summation.
// - Fragments come from the int8 tile in shared memory (ldmatrix moves
//   b16 only). The sum over k is the same in any order of the output
//   columns, so each lane owns 4 adjacent columns: one 32-bit load per k
//   row gives it the A elements of two m16 products (column 4g + 2r is
//   row g of product r, 4g + 2r + 1 its row g + 8). The conversion is a
//   byte permute into the f32 pattern 0x4B0000uu (2^23 + u, with
//   u = w + 128), one subtraction, and a permute that keeps the upper
//   halves of two floats: the bf16 pair, with no I2F or F2F instruction.
// - x fragments are read with ldmatrix; the weight tile pitch is 144
//   bytes, so the 32 lanes' 4-byte reads fall in 32 distinct banks.
// - Tiles reach shared memory by 16-byte cp.async in 32-row K chunks,
//   eight stages deep at decode, four at prefill. A weight whose rows are off 16 bytes (N % 16 != 0
//   or an unaligned pointer), an x off 16 bytes, and the ragged M/N/K
//   edges take a masked path inside the same kernel (byte or element loads,
//   zeros past the edge); it is not a fallback to the plain version.
// - A block owns a BM x 128 output tile (4 warps of 32 columns), BM = 8
//   at decode, 16, or 64 at prefill. The tile and split plan comes from
//   the wrapper (kernels/quant_matmul.py::_plan).
// - Split-K fills the card at decode: the K chunks of a tile are dealt
//   to `splits` blocks (gridDim.z), enough for one wave on 132 SMs but
//   no more than 16 a tile (more partials cost more to reduce than the
//   SMs they fill). Each block writes its f32 partial to a
//   workspace, fences, and counts itself in on the tile's counter; the
//   last block to arrive sums the partials in split order 0, 1, ... (so
//   a call gives the same bits every time, whichever block is last),
//   resets the counter for the next call on the stream, and writes the
//   epilogue, as CUTLASS's serial split-K does. No float atomics.
// - Epilogue: acc * scale[n] rounded once to bf16.
//
// f32 x (no serving path runs it): qmm_simt_kernel, the first design on
// the CUDA cores. bf16 operands would lose x's bits. One 256-thread
// block owns a 16 x 128 tile and walks all of K in 64-row chunks staged
// in shared memory (x as f32, w as int8 in 16-byte vectors, a masked
// scalar path at the ragged edge), int8 converted to f32 in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ------------------------------------------------ f32 x: CUDA cores
constexpr int BM = 16;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
qmm_simt_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ y,
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
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + ty * 2 + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < N) y[(size_t)m * N + n] = acc[r][c] * scale[n];
    }
  }
}

// ------------------------------------------- bf16 x: tensor cores
typedef __nv_bfloat16 bf16;

constexpr int MMA_THREADS = 128;  // 4 warps x 32 output columns
constexpr int TN = 128;           // output columns a block
constexpr int TK = 32;            // k rows a stage (one chunk)
// stages: at decode 7 chunks of 4 KB of weight on their way while one
// is multiplied (bytes bound); at prefill 4, which keeps more 64-row
// blocks resident on an SM (78 KB of stages would allow 2, 39 KB allow 5)
template <int MT>
__host__ __device__ constexpr int qmm_stages() { return MT == 8 ? 4 : 8; }
constexpr int WP = TN + 16;       // weight tile pitch, bytes
constexpr int XP = TK + 8;        // x tile pitch, elements (80 bytes)

struct QArgs {
  const bf16* x;
  const int8_t* w;
  const float* scale;
  bf16* y;
  float* ws;                      // [tiles][splits][BM * TN] partials
  int* counters;                  // [tiles], zero between calls
  int M, K, N;
  int chunks_per_split, splits;
  int vec_w, vec_x;               // 16-byte rows of w, of x
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 of k row `lo` and the four of row `hi` (same columns) ->
// four bf16 pairs (lo[i] in the low half, hi[i] in the high), exactly:
// byte u = w + 128 goes into the f32 0x4B0000uu = 2^23 + u, minus
// 2^23 + 128 is w, whose upper 16 bits are its bf16.
__device__ __forceinline__ void i8_pairs(uint32_t lo, uint32_t hi,
                                         uint32_t (&out)[4]) {
  lo ^= 0x80808080u;
  hi ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float fl =
        __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540u | i)) -
        8388736.f;
    const float fh =
        __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540u | i)) -
        8388736.f;
    out[i] = __byte_perm(__float_as_uint(fl), __float_as_uint(fh), 0x7632u);
  }
}

// chunk `c` (k rows c*TK ..) of the block's w and x tiles into stage
// buffers; rows at or past kend, columns past N and x rows past M are
// zero. The 16-byte path uses cp.async (committed by the caller), the
// masked path plain loads and shared stores.
template <int BMT>
__device__ __forceinline__ void load_chunk(const QArgs& a, int8_t* Ws,
                                           bf16* Xs, int c, int kend,
                                           int m0, int n0) {
  const int tid = threadIdx.x;
  const int k0 = c * TK;
#pragma unroll
  for (int i = 0; i < TK * TN / 16 / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int r = idx / (TN / 16), col = (idx % (TN / 16)) * 16;
    const int k = k0 + r, n = n0 + col;
    int8_t* dst = Ws + r * WP + col;
    if (a.vec_w) {
      const bool ok = k < kend && n < a.N;     // N % 16 == 0 here
      cp_async16(smem_u32(dst), ok ? a.w + (size_t)k * a.N + n : a.w, ok);
    } else {
      uint32_t word[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nn = n + 4 * q + j;
          const uint32_t byte =
              (k < kend && nn < a.N)
                  ? (uint8_t)a.w[(size_t)k * a.N + nn] : 0u;
          v |= byte << (8 * j);
        }
        word[q] = v;
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
  for (int idx = tid; idx < BMT * (TK / 8); idx += MMA_THREADS) {
    const int r = idx / (TK / 8), col = (idx % (TK / 8)) * 8;
    const int m = m0 + r, k = k0 + col;
    bf16* dst = Xs + r * XP + col;
    if (a.vec_x) {
      const bool ok = m < a.M && k < kend;      // K % 8 == 0 here
      cp_async16(smem_u32(dst), ok ? a.x + (size_t)m * a.K + k : a.x, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (m < a.M && k + j < kend) ? a.x[(size_t)m * a.K + k + j]
                                           : __float2bfloat16_rn(0.f);
    }
  }
}

// One block: a (8 MT) x 128 tile of y, over the K chunks of its split.
// Warp w owns columns 32 w .. 32 w + 31; lane (g, t) = (lane / 4,
// lane % 4) owns columns 32 w + 4 g .. + 3 and, in each 8-row m tile j,
// rows 8 j + 2 t and + 1.
template <int MT>
__global__ void __launch_bounds__(MMA_THREADS) qmm_mma_kernel(QArgs a) {
  constexpr int BMT = 8 * MT;
  constexpr int STAGES = qmm_stages<MT>();
  constexpr int W_STAGE = TK * WP;                    // bytes
  constexpr int X_STAGE = BMT * XP;                   // elements
  extern __shared__ __align__(16) unsigned char smem_q[];
  int8_t* Ws = reinterpret_cast<int8_t*>(smem_q);
  bf16* Xs = reinterpret_cast<bf16*>(smem_q + STAGES * W_STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * BMT;
  const int split = blockIdx.z;
  const int n_chunks = (a.K + TK - 1) / TK;
  const int c_begin = split * a.chunks_per_split;
  const int n_mine = max(0, min(a.chunks_per_split, n_chunks - c_begin));
  const int kend = min(a.K, (c_begin + n_mine) * TK);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_mine)
      load_chunk<BMT>(a, Ws + s * W_STAGE, Xs + s * X_STAGE, c_begin + s,
                      kend, m0, n0);
    cp_async_commit();
  }

  float acc[2][MT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<STAGES - 2>();            // chunk i has landed
    __syncthreads();                        // ... and chunk i-1 is done
    if (i + STAGES - 1 < n_mine) {
      const int s = (i + STAGES - 1) % STAGES;
      load_chunk<BMT>(a, Ws + s * W_STAGE, Xs + s * X_STAGE,
                      c_begin + i + STAGES - 1, kend, m0, n0);
    }
    cp_async_commit();
    const int8_t* Wt = Ws + (i % STAGES) * W_STAGE + warp * 32 + 4 * g;
    const bf16* Xt = Xs + (i % STAGES) * X_STAGE;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const int8_t* wr = Wt + (kk * 16 + 2 * t) * WP;
      uint32_t lo[4], hi[4];
      i8_pairs(*reinterpret_cast<const uint32_t*>(wr),
               *reinterpret_cast<const uint32_t*>(wr + WP), lo);
      i8_pairs(*reinterpret_cast<const uint32_t*>(wr + 8 * WP),
               *reinterpret_cast<const uint32_t*>(wr + 9 * WP), hi);
      const uint32_t wa[2][4] = {{lo[0], lo[1], hi[0], hi[1]},
                                 {lo[2], lo[3], hi[2], hi[3]}};
      uint32_t xb[MT][2];
      if constexpr (MT == 1) {
        uint32_t r2[2];
        ldsm_x2(r2, smem_u32(Xt + (lane & 7) * XP + kk * 16 +
                             ((lane >> 3) & 1) * 8));
        xb[0][0] = r2[0];
        xb[0][1] = r2[1];
      } else {
#pragma unroll
        for (int jp = 0; jp < MT / 2; ++jp) {
          uint32_t r4[4];
          ldsm_x4(r4, smem_u32(Xt + (jp * 16 + (lane & 7) +
                                     ((lane >> 4) << 3)) * XP +
                               kk * 16 + ((lane >> 3) & 1) * 8));
          xb[2 * jp][0] = r4[0];
          xb[2 * jp][1] = r4[1];
          xb[2 * jp + 1][0] = r4[2];
          xb[2 * jp + 1][1] = r4[3];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < MT; ++j)
          mma_bf16(acc[r][j], wa[r], xb[j][0], xb[j][1]);
    }
  }
  cp_async_wait<0>();

  if (a.splits > 1) {
    // this split's partial, in the threads' own layout, then the arrive
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float4* part = reinterpret_cast<float4*>(a.ws) +
                   (size_t)tile * a.splits * (2 * MT * MMA_THREADS);
    float4* mine = part + (size_t)split * (2 * MT * MMA_THREADS);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < MT; ++j)
        mine[(r * MT + j) * MMA_THREADS + tid] =
            make_float4(acc[r][j][0], acc[r][j][1], acc[r][j][2],
                        acc[r][j][3]);
    __threadfence();
    __syncthreads();
    __shared__ int is_last;
    if (tid == 0)
      is_last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the sum in split order, whichever block arrived last
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
#pragma unroll 2
    for (int s = 0; s < a.splits; ++s) {
      const float4* src = part + (size_t)s * (2 * MT * MMA_THREADS) + tid;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const float4 p = __ldcg(src + (r * MT + j) * MMA_THREADS);
          acc[r][j][0] += p.x;
          acc[r][j][1] += p.y;
          acc[r][j][2] += p.z;
          acc[r][j][3] += p.w;
        }
    }
    if (tid == 0) a.counters[tile] = 0;     // ready for the next call
  }

  // epilogue: acc * scale[n], one rounding to bf16. Column 4g + 2r is
  // row g of product r (accumulator 0, 1), 4g + 2r + 1 its row g + 8
  // (accumulator 2, 3); accumulator 0/2 is row 2t of the m tile, 1/3
  // row 2t + 1.
  const int n = n0 + warp * 32 + 4 * g;
  float sc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) sc[q] = n + q < a.N ? a.scale[n + q] : 0.f;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 8 * j + 2 * t + half;
      if (m >= a.M) continue;
      const float v[4] = {acc[0][j][half], acc[0][j][2 + half],
                          acc[1][j][half], acc[1][j][2 + half]};
      bf16* dst = a.y + (size_t)m * a.N + n;
      if ((a.N & 3) == 0 && n + 4 <= a.N) {
        __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0] * sc[0], v[1] * sc[1]);
        __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2] * sc[2], v[3] * sc[3]);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&p0);
        packed.y = *reinterpret_cast<uint32_t*>(&p1);
        *reinterpret_cast<uint2*>(dst) = packed;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < a.N) dst[q] = __float2bfloat16_rn(v[q] * sc[q]);
      }
    }
}

template <int MT>
int launch_mma(const QArgs& a, int n_tiles, int m_tiles, cudaStream_t s) {
  constexpr size_t smem =
      qmm_stages<MT>() * ((size_t)TK * WP + sizeof(bf16) * 8 * MT * XP);
  const dim3 grid(n_tiles, m_tiles, a.splits);
  cudaError_t err = cudaFuncSetAttribute(
      qmm_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qmm_mma_kernel<MT><<<grid, MMA_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every pointer and the stream are
// passed as void*; the return value is cudaGetLastError() after the
// launch (0 = launched).
//
// bf16: the plan (kernels/quant_matmul.py::_plan) gives bm (8, 16 or 64
// rows a tile), chunks_per_split (32-row K chunks a block) and splits;
// ws holds tiles * splits * bm * 128 floats when splits > 1, counters
// one int a tile, zero on entry and left zero on exit.
extern "C" int quant_matmul_bf16(const void* x, const void* w,
                                 const void* scale, void* y, void* ws,
                                 void* counters, int M, int K, int N, int bm,
                                 int chunks_per_split, int splits,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || splits < 1 || chunks_per_split < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  QArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.y = static_cast<bf16*>(y);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.K = K;
  a.N = N;
  a.chunks_per_split = chunks_per_split;
  a.splits = splits;
  a.vec_w = (N % 16 == 0) && ((uintptr_t)w % 16 == 0);
  a.vec_x = (K % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const int n_tiles = (N + TN - 1) / TN;
  const int m_tiles = (M + bm - 1) / bm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 8: return launch_mma<1>(a, n_tiles, m_tiles, s);
    case 16: return launch_mma<2>(a, n_tiles, m_tiles, s);
    case 64: return launch_mma<8>(a, n_tiles, m_tiles, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int quant_matmul_f32(const void* x, const void* w,
                                const void* scale, void* y, int M, int K,
                                int N, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int vec_w = (N % 16 == 0) && ((uintptr_t)w % 16 == 0);
  qmm_simt_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), M, K, N,
      vec_w);
  return (int)cudaGetLastError();
}
