// Flash attention, forward and two-pass backward, for NVIDIA Hopper (sm_90a).
//
//   out = softmax(q k^T * scale + mask) v,  lse = logsumexp of each row
//   dq  = scale * (p * (do v^T - delta)) k
//   dk  = scale * (p * (do v^T - delta))^T q,   dv = p^T do
//
// q, k, v, do are [B, S, H, D] read through their strides (the last
// stride must be 1), so the q/k/v views that GPT's fused qkv projection
// makes are read in place. out, dq, dk, dv are written contiguous
// [B, S, H, D]; lse and delta are [B, H, Sq] f32. The causal mask is
// top-left aligned (q_pos >= kv_pos) and keys at or past kv_len are
// masked, both inside the kernel.
//
// Replaces the TPU kernels of paddle_tpu/kernels/pallas_attention.py:
// - flash_fwd_kernel, flash_fwd_q64_kernel (its 64-row tile up to D = 64)
//                        <- _mha_fwd_jit (pl.pallas_call :119, _fwd_kernel :31)
// - flash_bwd_dq_kernel  <- _mha_bwd_jit (pl.pallas_call :310, _bwd_dq_kernel :170)
// - flash_bwd_dkv_kernel <- _mha_bwd_jit (pl.pallas_call :327, _bwd_dkv_kernel :209)
// Reference analog: the flash-attention library the reference builds
// into phi/kernels/gpu/flash_attn_kernel.cu (and its grad kernel).
//
// Shared by all kernels:
// - One block owns one 64-row tile of one (batch, head): a q tile for
//   the forward and dq, a kv tile for dk/dv. The Pallas grid's
//   sequential innermost axis becomes a loop inside the block over the
//   other operand's tiles. The backward is two passes without atomics,
//   as in the reference: each output is written once, by one block, so
//   it is the same to the bit from run to run.
// - Rounding follows the Pallas kernels: p is rounded to the input
//   dtype before p.v and p^T.do, ds = p * (dp - delta) before ds.k and
//   ds^T.q, and the softmax scale multiplies dq and dk once at the end.
// - Tiles entirely above the causal diagonal (causal_block_live) and
//   entirely past kv_len are skipped. Padded q rows (past Sq) get p = 0:
//   the Pallas wrapper killed them with lse = 1e30 instead.
// - Rows with no valid key (possible only with kv_len) are outside the
//   contract; here they produce out = 0.
//
// On bf16 operands (the train steps' dtype) all three kernels run on
// tensor cores: flash_fwd_kernel, flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel. What bounds them on an H100 is operations:
// 4 P D for the forward (s = q k^T, p v), 6 P D for dq (s, dp = do v^T,
// ds k) and 8 P D for dk/dv (s^T, dp^T, p^T do, ds^T q), P the live
// (q, k) pairs, against 989 TFLOP/s of bf16; their bytes (each operand
// read once) are 10-30x below that at S >= 1024. The design follows
// FlashAttention-2:
// - every product is mma.sync.m16n8k16 on bf16 fragments with f32
//   accumulators; operand tiles reach shared memory by 16-byte cp.async
//   copies, at least two stages deep (the next tile is in flight while
//   this one is computed), with rows padded by 16 bytes so that ldmatrix
//   and cp.async are free of bank conflicts;
// - forward: a block owns 128 q rows up to D = 64 by default (each
//   warp two m16 row tiles, so every k and v fragment feeds two
//   products) or, at the caller's block_q = 64, 64 rows (one row tile a
//   warp, twice the blocks); 64 above D = 64. Each q row walks the same
//   kv tiles in the same order under either tile, so the two give the
//   same bits;
//   q stays in shared memory, k and v stream through a ring of three
//   stages up to D = 64 (two above) with one barrier a tile;
//   s = q k^T reads q and k with ldmatrix; the online softmax (m, l) is
//   kept per fragment row in f32, reduced over the 4 lanes of a quad, in
//   the log2 domain (exp2f of s * scale * log2 e; lse is converted back
//   to natural-log units for the backward); p is packed to bf16 A
//   fragments in registers (l sums it unrounded) and out += p v reads v
//   with ldmatrix.trans;
// - dq: q, do, lse and delta stay resident, k and v stream in;
//   s = q k^T and dp = do v^T read k and v with ldmatrix, ds is packed
//   to bf16 A fragments in registers and dq += ds k reads k with
//   ldmatrix.trans;
// - dk/dv: k and v stay resident, q, do, lse and delta stream in, in
//   the transposed form s^T = k q^T and dp^T = v do^T, so p^T and ds^T
//   are packed to A fragments in registers and dv += p^T do and
//   dk += ds^T q read do and q with ldmatrix.trans. p and ds never make
//   a round trip through shared memory in any of the three;
// - causal forward and dq blocks run the last q tiles (the longest
//   rows) first; only tiles that cross the diagonal or kv_len evaluate
//   the mask;
// - the operands' rows must start on 16-byte boundaries (the wrapper
//   checks it and raises otherwise).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, at
// the Llama step's [4, 2048, 32, 64] bf16 causal: dq 0.509 ms and dk/dv
// 0.699 ms (the CUDA-core pair before them: 6.233 + 7.153), about 200
// TFLOP/s; the forward's figures are in PERF.md (the CUDA-core forward
// before it: 3.458 ms).
//
// f32 operands keep the first design: every product as f32 FMAs from
// shared memory on the CUDA cores (flash_fwd_simt_kernel and the two
// *_simt_kernel backward passes). One block of 256 threads; tiles staged
// as f32 with a row pitch of D + 1 floats, so row-wise and column-wise
// reads are free of bank conflicts; thread (ty, tx) = (tid / 16, tid % 16)
// owns tile rows ty + 16 i and columns tx + 16 j; row statistics reduce
// over the 16 lanes of a half-warp with shuffles; online softmax
// (m, l, acc) in f32 registers, masked scores hold NEG_INF and their
// probabilities are zeroed, lse = m + log(max(l, 1e-30)),
// out = acc / max(l, 1e-30), as primitives.py finalizes. f32 attention
// stays off the tensor cores: TF32 keeps 10 bits of mantissa, and the
// f32 path is held to 2^-16 of its plain version; no train step runs
// attention in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;           // q rows per tile
constexpr int BK = 64;           // kv rows per tile
constexpr int THREADS = 256;
constexpr int PS = BK + 1;       // pitch of the 64 x 64 p / ds tiles

struct Strides {
  long long b, s, h;             // elements; the D stride is 1
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;              // [B, H, Sq] (backward input)
  const float* delta;            // [B, H, Sq]
  void* out;                     // [B, Sq, H, D]
  float* lse_out;                // [B, H, Sq] (forward output)
  void* dq;                      // [B, Sq, H, D]
  void* dk;                      // [B, Skv, H, D]
  void* dv;                      // [B, Skv, H, D]
  Strides sq, sk, sv, sdo;
  int B, H, Sq, Skv, kv_len, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the value an f32 takes once rounded to T (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows row0 .. row0+63 of (b, h) into dst[64][D + 1] as f32; rows at or
// past `limit` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          Strides st, int b, int h,
                                          int row0, int limit) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int pos = row0 + r;
    float val = 0.f;
    if (pos < limit)
      val = to_f32(base[(long long)b * st.b + (long long)pos * st.s +
                        (long long)h * st.h + c]);
    dst[r * (D + 1) + c] = val;
  }
}

// number of kv tiles a q tile starting at q0 visits
__device__ __forceinline__ int kv_tiles_for(const Args& a, int q0) {
  int n = (a.kv_len + BK - 1) / BK;
  if (a.causal) n = min(n, (q0 + BQ - 1) / BK + 1);   // causal_block_live
  return n;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_simt_kernel(Args a) {
  constexpr int P = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x P
  float* Ks = Qs + BQ * P;          // BK x P
  float* Vs = Ks + BK * P;          // BK x P
  float* Ps = Vs + BK * P;          // BQ x PS

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  load_tile<T, D>(Qs, q, a.sq, b, h, q0, a.Sq);

  float acc[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_tiles = kv_tiles_for(a, q0);
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();                // last tile's reads of Ks/Vs/Ps done
    load_tile<T, D>(Ks, k, a.sk, b, h, k0, a.Skv);
    load_tile<T, D>(Vs, v, a.sv, b, h, k0, a.Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < a.kv_len && (!a.causal || qpos >= kpos);
        s[i][j] = ok[j] ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BK; ++n) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + n];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = Vs[n * P + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    const long long o = (((long long)b * a.Sq + qpos) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      out[o + tx + 16 * jj] = from_f32<T>(acc[i][jj] / lf);
    if (tx == 0) a.lse_out[(long long)bh * a.Sq + qpos] = m[i] + logf(lf);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_simt_kernel(Args a) {
  constexpr int P = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x P
  float* Os = Qs + BQ * P;          // BQ x P  (do)
  float* Ks = Os + BQ * P;          // BK x P
  float* Vs = Ks + BK * P;          // BK x P
  float* DSs = Vs + BK * P;         // BQ x PS

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  load_tile<T, D>(Qs, q, a.sq, b, h, q0, a.Sq);
  load_tile<T, D>(Os, dout, a.sdo, b, h, q0, a.Sq);

  float lse_r[4], delta_r[4], acc[4][NJ];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    row_ok[i] = qpos < a.Sq;
    const long long r = (long long)bh * a.Sq + qpos;
    lse_r[i] = row_ok[i] ? a.lse[r] : 0.f;
    delta_r[i] = row_ok[i] ? a.delta[r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_tiles = kv_tiles_for(a, q0);
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();
    load_tile<T, D>(Ks, k, a.sk, b, h, k0, a.Skv);
    load_tile<T, D>(Vs, v, a.sv, b, h, k0, a.Skv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * P + d];
        ov[i] = Os[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * P + d];
        vv[j] = Vs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = row_ok[i] && kpos < a.kv_len &&
                        (!a.causal || qpos >= kpos);
        const float p = ok ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        DSs[(ty + 16 * i) * PS + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BK; ++n) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = DSs[(ty + 16 * i) * PS + n];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) kv[jj] = Ks[n * P + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          acc[i][jj] = fmaf(dsv[i], kv[jj], acc[i][jj]);
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    const long long o = (((long long)b * a.Sq + qpos) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      dq[o + tx + 16 * jj] = from_f32<T>(acc[i][jj] * a.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_simt_kernel(Args a) {
  constexpr int P = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // BK x P
  float* Vs = Ks + BK * P;          // BK x P
  float* Qs = Vs + BK * P;          // BQ x P
  float* Os = Qs + BQ * P;          // BQ x P  (do)
  float* PT = Os + BQ * P;          // BK x PS  (p^T)
  float* DST = PT + BK * PS;        // BK x PS  (ds^T)
  float* lse_s = DST + BK * PS;     // BQ
  float* delta_s = lse_s + BQ;      // BQ

  // thread (ty, tx) owns kv rows ty + 16 i of the tile; in the 64 x 64
  // transposed score tile it owns q columns tx + 16 j, and in dk/dv the
  // feature columns tx + 16 jj
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BK;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  load_tile<T, D>(Ks, k, a.sk, b, h, k0, a.Skv);
  load_tile<T, D>(Vs, v, a.sv, b, h, k0, a.Skv);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  const int n_q = (a.Sq + BQ - 1) / BQ;
  // first q tile that reaches this kv tile (causal_block_live); a kv
  // tile wholly past kv_len gets no gradient
  int i_start = a.causal ? k0 / BQ : 0;
  if (k0 >= a.kv_len) i_start = n_q;

  for (int it = i_start; it < n_q; ++it) {
    const int q0 = it * BQ;
    __syncthreads();
    load_tile<T, D>(Qs, q, a.sq, b, h, q0, a.Sq);
    load_tile<T, D>(Os, dout, a.sdo, b, h, q0, a.Sq);
    if (tid < BQ) {
      const int qpos = q0 + tid;
      const long long r = (long long)bh * a.Sq + qpos;
      lse_s[tid] = qpos < a.Sq ? a.lse[r] : 0.f;
      delta_s[tid] = qpos < a.Sq ? a.delta[r] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * P + d];
        vv[i] = Vs[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * P + d];
        ov[j] = Os[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const int qpos = q0 + r;
        const bool ok = qpos < a.Sq && kpos < a.kv_len &&
                        (!a.causal || qpos >= kpos);
        const float p = ok ? expf(st[i][j] * a.scale - lse_s[r]) : 0.f;
        PT[(ty + 16 * i) * PS + r] = round_to<T>(p);
        DST[(ty + 16 * i) * PS + r] = round_to<T>(p * (dpt[i][j] - delta_s[r]));
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dsv[4], ov[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = PT[(ty + 16 * i) * PS + r];
        dsv[i] = DST[(ty + 16 * i) * PS + r];
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        ov[jj] = Os[r * P + tx + 16 * jj];
        qv[jj] = Qs[r * P + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          dv_acc[i][jj] = fmaf(pv[i], ov[jj], dv_acc[i][jj]);
          dk_acc[i][jj] = fmaf(dsv[i], qv[jj], dk_acc[i][jj]);
        }
    }
  }

  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= a.Skv) continue;
    const long long o = (((long long)b * a.Skv + kpos) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      dk[o + tx + 16 * jj] = from_f32<T>(dk_acc[i][jj] * a.scale);
      dv[o + tx + 16 * jj] = from_f32<T>(dv_acc[i][jj]);
    }
  }
}

// ------------------------------------------------------------------
// The bf16 backward pair on tensor cores (FlashAttention-2's backward).
//
// Every product is mma.sync.m16n8k16 with bf16 operands and f32
// accumulators. Operand tiles sit in shared memory as bf16 with a row
// pitch of D + 8 elements (2D + 16 bytes: an odd multiple of 16 bytes
// modulo 128, so the 8 row addresses of every ldmatrix phase fall in
// distinct banks), and arrive by 16-byte cp.async copies, two stages
// deep, so the next tile is in flight while this one is computed.
// Warp w owns 16 rows of the block's tile. The accumulator fragment of
// an m16n8 product (lane holds row lane/4 and lane/4 + 8, columns
// 2(lane%4) and +1) is the A fragment of an m16k16 product once two
// neighbouring n-tiles are packed to bf16 pairs, so p and ds go from
// the first products to the second in registers.

constexpr int MMA_THREADS = 128;   // 4 warps x 16 rows
constexpr int MMA_ROWS = 64;       // rows of the tile a block owns
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

// two f32 rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory addresses of one lane's ldmatrix.x4 row, for a tile
// X[rows][pitch P] starting at (r0, c0):
// - A fragment of X[r0:+16][c0:+16] (row-major A);
__device__ __forceinline__ uint32_t a_addr(const bf16* x, int P, int r0,
                                           int c0, int lane) {
  return smem_u32(x + (r0 + (lane & 15)) * P + c0 + (lane >> 4) * 8);
}
// - B fragments of two n8 tiles where B[k][n] = X[r0 + n][c0 + k], the
//   operand of X^T (k on X's columns): regs 0-1 are n-tile 0, 2-3 n-tile 1;
__device__ __forceinline__ uint32_t bt_addr(const bf16* x, int P, int r0,
                                            int c0, int lane) {
  return smem_u32(x + (r0 + (lane & 7) + ((lane >> 4) << 3)) * P + c0 +
                  ((lane >> 3) & 1) * 8);
}
// - B fragments of two n8 tiles where B[k][n] = X[r0 + k][c0 + n], read
//   with ldmatrix.trans: regs 0-1 are n-tile 0, 2-3 n-tile 1.
__device__ __forceinline__ uint32_t b_addr(const bf16* x, int P, int r0,
                                           int c0, int lane) {
  return smem_u32(x + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + c0 +
                  (lane >> 4) * 8);
}

// rows row0 .. row0+ROWS-1 of (b, h) into dst[ROWS][D + 8] by 16-byte
// cp.async (not committed); rows at or past `limit` are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* base,
                                                Strides st, int b, int h,
                                                int row0, int limit) {
  constexpr int CH = D / 8;                 // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += MMA_THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int pos = row0 + r;
    const bool ok = pos < limit;
    const bf16* src = ok ? base + (long long)b * st.b +
                               (long long)pos * st.s + (long long)h * st.h + c
                         : base;
    cp_async16(smem_u32(dst + r * (D + 8) + c), src, ok);
  }
}

// m16 row tiles each warp of the forward owns, WM: 2 gives a 128-row q
// tile a block (every k and v fragment feeds two products and each k/v
// tile is read from L2 half as often), 1 a 64-row tile (twice the
// blocks). Both are built up to D = 64, where the registers allow 2;
// above, 1 alone. The default is the larger where it is built; the
// caller may pick either (block_q 128 or 64; kernels/autotune.py).
template <int D>
__host__ __device__ constexpr int fwd_wm() { return D <= 64 ? 2 : 1; }

// k/v stages of the forward: the copies of the next stages - 1 tiles
// are in flight while one is computed. 3 up to D = 64 (72 KB a block at
// D = 64, 2 blocks an SM), 2 above (a third would leave one block an SM)
template <int D>
__host__ __device__ constexpr int fwd_stages() { return D <= 64 ? 3 : 2; }

template <int D, int WM>
constexpr size_t fwd_smem() {               // q; the stages of k, v
  return sizeof(bf16) * (size_t)(WM + 2 * fwd_stages<D>()) * MMA_ROWS *
         (D + 8);
}

// out = softmax(q k^T * scale) v over the live kv tiles, online, with
// lse = m + log(l). One block: 64 * WM q rows of one (batch, head); q
// stays in shared memory (its A fragments are reloaded each tile, which
// frees the registers of the second row tile), k and v stream through a
// ring of
// fwd_stages tiles with one barrier a tile. Scores live
// in the log2 domain (s * scale * log2 e, m likewise) so each exp is one
// exp2f; lse goes back to natural-log units at the end.
template <int D, int WM>
__device__ __forceinline__ void flash_fwd_tile(const Args& a) {
  constexpr int FWD_STAGES = fwd_stages<D>();
  constexpr int BQ = WM * MMA_ROWS;         // q rows a block
  constexpr int P = D + 8;
  constexpr int BK = MMA_ROWS;
  constexpr int NS = BK / 8;                // n-tiles of s
  constexpr int ND = D / 8;                 // n-tiles of out
  constexpr int KD = D / 16;                // k-steps of q k^T
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);
  bf16* Ks = Qs + BQ * P;                   // FWD_STAGES stages
  bf16* Vs = Ks + FWD_STAGES * BK * P;      // FWD_STAGES stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // the heaviest causal tiles (last q rows) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  int n_tiles = (a.kv_len + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  // one copy group a tile (q rides with tile 0)
  auto load_kv = [&](int jt) {
    const int st = jt % FWD_STAGES;
    load_tile_async<BK, D>(Ks + st * BK * P, k, a.sk, b, h, jt * BK, a.Skv);
    load_tile_async<BK, D>(Vs + st * BK * P, v, a.sv, b, h, jt * BK, a.Skv);
  };
  load_tile_async<BQ, D>(Qs, q, a.sq, b, h, q0, a.Sq);
#pragma unroll
  for (int jt = 0; jt < FWD_STAGES - 1; ++jt) {
    if (jt < n_tiles) load_kv(jt);
    cp_async_commit();
  }

  // this lane's rows in row tile mt: mt * 64 + r and + 8, r below
  const int r = warp * 16 + (lane >> 2);
  int qpos[WM][2];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
    qpos[mt][0] = q0 + mt * MMA_ROWS + r;
    qpos[mt][1] = qpos[mt][0] + 8;
  }
  const float scale_log2 = a.scale * LOG2E;
  // m2: the row max in log2 units (the same in the 4 lanes of a quad);
  // l: this lane's share of the row sum, reduced over the quad at the end
  float m2[WM][2], l[WM][2], acc[WM][ND][4];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m2[mt][i] = NEG_INF;
      l[mt][i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  for (int jt = 0; jt < n_tiles; ++jt) {
    cp_async_wait<FWD_STAGES - 2>();        // tile jt (and q) has landed
    __syncthreads();                        // ... and tile jt - 1 is done
    if (jt + FWD_STAGES - 1 < n_tiles) load_kv(jt + FWD_STAGES - 1);
    cp_async_commit();
    const int stage = jt % FWD_STAGES;
    const bf16* Kt = Ks + stage * BK * P;
    const bf16* Vt = Vs + stage * BK * P;

    // s = q k^T: 16 x 64 per row tile
    float s[WM][NS][4];
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[WM][4];
#pragma unroll
      for (int mt = 0; mt < WM; ++mt)
        ldsm_x4(qa[mt], a_addr(Qs, P, mt * MMA_ROWS + warp * 16, kk * 16,
                               lane));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, bt_addr(Kt, P, np * 16, kk * 16, lane));
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

    // the online softmax; only tiles that cross the diagonal or kv_len
    // evaluate the mask, and a masked score holds NEG_INF. The row max is
    // taken on the raw scores (scale > 0), the exponent is one fma.
    const int k0 = jt * BK;
    const bool masked = k0 + BK > a.kv_len || (a.causal && k0 + BK - 1 > q0);
    uint32_t pa[WM][BK / 16][4];
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked) {
            const int kpos = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
            const bool ok = kpos < a.kv_len &&
                            (!a.causal || qpos[mt][e >> 1] >= kpos);
            s[mt][n][e] = ok ? s[mt][n][e] : NEG_INF;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a row with no valid score yet keeps m2 = NEG_INF
        const float m_new = fmaxf(m2[mt][i],
                                  mx[i] == NEG_INF ? NEG_INF
                                                   : mx[i] * scale_log2);
        corr[i] = exp2f(m2[mt][i] - m_new);
        m2[mt][i] = m_new;
        l[mt][i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= corr[e >> 1];

      // p, summed unrounded into l, rounded to bf16 A fragments for p v
      // (a masked score is forced to 0: exp2 of NEG_INF - NEG_INF is 1)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(fmaf(s[mt][n][e], scale_log2, -m2[mt][e >> 1]));
          if (masked && s[mt][n][e] == NEG_INF) p[e] = 0.f;
          l[mt][e >> 1] += p[e];
        }
        pa[mt][n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[mt][n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }

    // out += p . v
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, b_addr(Vt, P, j * 16, dp2 * 16, lane));
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
          mma_bf16(acc[mt][2 * dp2], pa[mt][j], vb[0], vb[1]);
          mma_bf16(acc[mt][2 * dp2 + 1], pa[mt][j], vb[2], vb[3]);
        }
      }
  }

  bf16* out = static_cast<bf16*>(a.out);
  constexpr float LN2 = 0.6931471805599453f;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int qp = qpos[mt][i];
      if (qp >= a.Sq) continue;
      const float lf = fmaxf(li, 1e-30f);
      bf16* row = out + (((long long)b * a.Sq + qp) * a.H + h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[mt][n][2 * i] / lf,
                                  acc[mt][n][2 * i + 1] / lf);
      if ((lane & 3) == 0)
        a.lse_out[(long long)bh * a.Sq + qp] = m2[mt][i] * LN2 + logf(lf);
    }
}

// the 128-row tile up to D = 64 (WM 2), the 64-row one above (WM 1)
template <int D, int WM>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_kernel(Args a) {
  flash_fwd_tile<D, WM>(a);
}

// the 64-row tile up to D = 64, compiled for 3 blocks an SM (its shared
// memory allows 3; left to itself ptxas aims at 4 and spills at D = 64)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 3)
    flash_fwd_q64_kernel(Args a) {
  flash_fwd_tile<D, 1>(a);
}

template <int D>
constexpr size_t dq_smem() {                // q, do; 2 stages of k, v
  return sizeof(bf16) * (size_t)(2 + 4) * MMA_ROWS * (D + 8);
}

// q tile rows of the dk/dv kernel: its four accumulators (s^T, dp^T, dk,
// dv) fit the register file at 64 up to D = 64, at 32 above
template <int D>
__host__ __device__ constexpr int dkv_bq() { return D <= 64 ? 64 : 32; }

template <int D>
constexpr size_t dkv_smem() {               // k, v; 2 stages of q, do,
  return sizeof(bf16) * (size_t)(2 * MMA_ROWS + 4 * dkv_bq<D>()) * (D + 8) +
         sizeof(float) * 4 * dkv_bq<D>();   // ... lse, delta
}

// dq = scale * sum over live kv tiles of ds . k, ds = p * (dp - delta),
// p = exp(q k^T * scale - lse), dp = do v^T. One block: 64 q rows of one
// (batch, head); q and do resident, k and v double-buffered.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_kernel(Args a) {
  constexpr int P = D + 8;
  constexpr int BK = MMA_ROWS;
  constexpr int NS = BK / 8;                // n-tiles of s and dp
  constexpr int ND = D / 8;                 // n-tiles of dq
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);
  bf16* Os = Qs + MMA_ROWS * P;             // do
  bf16* Ks = Os + MMA_ROWS * P;             // 2 stages
  bf16* Vs = Ks + 2 * BK * P;               // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // the heaviest causal tiles (last q rows) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_ROWS;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  int n_tiles = (a.kv_len + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + MMA_ROWS - 1) / BK + 1);

  load_tile_async<MMA_ROWS, D>(Qs, q, a.sq, b, h, q0, a.Sq);
  load_tile_async<MMA_ROWS, D>(Os, dout, a.sdo, b, h, q0, a.Sq);
  load_tile_async<BK, D>(Ks, k, a.sk, b, h, 0, a.Skv);
  load_tile_async<BK, D>(Vs, v, a.sv, b, h, 0, a.Skv);
  cp_async_commit();

  // this lane's rows: r and r + 8 of the warp's 16
  const int r = warp * 16 + (lane >> 2);
  const float scale_log2 = a.scale * LOG2E;
  int qpos[2];
  bool row_ok[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + r + 8 * i;
    row_ok[i] = qpos[i] < a.Sq;
    const long long o = (long long)bh * a.Sq + qpos[i];
    lse2[i] = row_ok[i] ? a.lse[o] * LOG2E : 0.f;
    dlt[i] = row_ok[i] ? a.delta[o] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int stage = jt & 1;
    if (jt + 1 < n_tiles) {
      load_tile_async<BK, D>(Ks + (stage ^ 1) * BK * P, k, a.sk, b, h,
                             (jt + 1) * BK, a.Skv);
      load_tile_async<BK, D>(Vs + (stage ^ 1) * BK * P, v, a.sv, b, h,
                             (jt + 1) * BK, a.Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();                     // tile jt has landed
    __syncthreads();
    const bf16* Kt = Ks + stage * BK * P;
    const bf16* Vt = Vs + stage * BK * P;

    // s = q k^T, dp = do v^T: 16 x 64 per warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, a_addr(Qs, P, warp * 16, kk * 16, lane));
      ldsm_x4(oa, a_addr(Os, P, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, bt_addr(Kt, P, np * 16, kk * 16, lane));
        ldsm_x4(vb, bt_addr(Vt, P, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }

    // p and ds in the accumulators; ds rounded to bf16 A fragments
    const int k0 = jt * BK;
    const bool masked = q0 + MMA_ROWS > a.Sq || k0 + BK > a.kv_len ||
                        (a.causal && k0 + BK - 1 > q0);
    uint32_t dsa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(fmaf(s[n][e], scale_log2, -lse2[i]));
        if (masked) {
          const int kpos = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const bool ok = row_ok[i] && kpos < a.kv_len &&
                          (!a.causal || qpos[i] >= kpos);
          p = ok ? p : 0.f;
        }
        ds[e] = p * (dp[n][e] - dlt[i]);
      }
      dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dq += ds . k
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
        uint32_t kb[4];
        ldsm_x4_t(kb, b_addr(Kt, P, j * 16, dp2 * 16, lane));
        mma_bf16(acc[2 * dp2], dsa[j], kb[0], kb[1]);
        mma_bf16(acc[2 * dp2 + 1], dsa[j], kb[2], kb[3]);
      }
    __syncthreads();                        // stage free for tile jt + 2
  }

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    bf16* row = dq + (((long long)b * a.Sq + qpos[i]) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[n][2 * i] * a.scale,
                                acc[n][2 * i + 1] * a.scale);
  }
}

// dv = sum over live q tiles of p^T . do, dk = scale * sum of ds^T . q,
// in the transposed form: s^T = k q^T and dp^T = v do^T, so each warp's
// 16 kv rows are the rows of every product. One block: 64 kv rows of one
// (batch, head); k and v resident, q, do, lse and delta double-buffered.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkv_kernel(Args a) {
  constexpr int P = D + 8;
  constexpr int BQ = dkv_bq<D>();
  constexpr int NS = BQ / 8;                // n-tiles of s^T and dp^T
  constexpr int ND = D / 8;                 // n-tiles of dk and dv
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_mma);
  bf16* Vs = Ks + MMA_ROWS * P;
  bf16* Qs = Vs + MMA_ROWS * P;             // 2 stages
  bf16* Os = Qs + 2 * BQ * P;               // 2 stages (do)
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * P);   // 2 stages
  float* Ds = Ls + 2 * BQ;                  // 2 stages (delta)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * MMA_ROWS;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  const int n_q = (a.Sq + BQ - 1) / BQ;
  // first q tile that reaches this kv tile (causal_block_live); a kv
  // tile wholly past kv_len gets no gradient
  int i_start = a.causal ? k0 / BQ : 0;
  if (k0 >= a.kv_len) i_start = n_q;

  // q, do, lse and delta of q tile `it` into stage `st` (not committed)
  auto load_q_tile = [&](int it, int st) {
    const int q0 = it * BQ;
    load_tile_async<BQ, D>(Qs + st * BQ * P, q, a.sq, b, h, q0, a.Sq);
    load_tile_async<BQ, D>(Os + st * BQ * P, dout, a.sdo, b, h, q0, a.Sq);
    if (tid < 2 * BQ) {
      const int c = tid % BQ, pos = q0 + c;
      const float* src = tid < BQ ? a.lse : a.delta;
      float* dst = (tid < BQ ? Ls : Ds) + st * BQ + c;
      const bool ok = pos < a.Sq;
      cp_async4(smem_u32(dst), ok ? src + (long long)bh * a.Sq + pos : src,
                ok);
    }
  };

  if (i_start < n_q) {
    load_tile_async<MMA_ROWS, D>(Ks, k, a.sk, b, h, k0, a.Skv);
    load_tile_async<MMA_ROWS, D>(Vs, v, a.sv, b, h, k0, a.Skv);
    load_q_tile(i_start, 0);
  }
  cp_async_commit();

  // this lane's kv rows: r and r + 8 of the warp's 16
  const int r = warp * 16 + (lane >> 2);
  const float scale_log2 = a.scale * LOG2E;

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = i_start; it < n_q; ++it) {
    const int stage = (it - i_start) & 1;
    if (it + 1 < n_q) load_q_tile(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                     // tile it has landed
    __syncthreads();
    const bf16* Qt = Qs + stage * BQ * P;
    const bf16* Ot = Os + stage * BQ * P;
    const float* Lt = Ls + stage * BQ;
    const float* Dt = Ds + stage * BQ;

    // s^T = k q^T, dp^T = v do^T: 16 x BQ per warp
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr(Ks, P, warp * 16, kk * 16, lane));
      ldsm_x4(va, a_addr(Vs, P, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, bt_addr(Qt, P, np * 16, kk * 16, lane));
        ldsm_x4(ob, bt_addr(Ot, P, np * 16, kk * 16, lane));
        mma_bf16(st[2 * np], ka, qb[0], qb[1]);
        mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
        mma_bf16(dpt[2 * np], va, ob[0], ob[1]);
        mma_bf16(dpt[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // p^T and ds^T in the accumulators, rounded to bf16 A fragments
    const int q0 = it * BQ;
    const bool masked = q0 + BQ > a.Sq || k0 + MMA_ROWS > a.kv_len ||
                        (a.causal && k0 + MMA_ROWS - 1 > q0);
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane & 3) + (e & 1);    // q column
        float pv = exp2f(fmaf(st[n][e], scale_log2, -Lt[c] * LOG2E));
        if (masked) {
          const int qpos = q0 + c, kpos = k0 + r + 8 * (e >> 1);
          const bool ok = qpos < a.Sq && kpos < a.kv_len &&
                          (!a.causal || qpos >= kpos);
          pv = ok ? pv : 0.f;
        }
        p[e] = pv;
        ds[e] = pv * (dpt[n][e] - Dt[c]);
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dv += p^T . do, dk += ds^T . q
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
#pragma unroll
      for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
        uint32_t ob[4], qb[4];
        ldsm_x4_t(ob, b_addr(Ot, P, j * 16, dp2 * 16, lane));
        ldsm_x4_t(qb, b_addr(Qt, P, j * 16, dp2 * 16, lane));
        mma_bf16(dv_acc[2 * dp2], pa[j], ob[0], ob[1]);
        mma_bf16(dv_acc[2 * dp2 + 1], pa[j], ob[2], ob[3]);
        mma_bf16(dk_acc[2 * dp2], dsa[j], qb[0], qb[1]);
        mma_bf16(dk_acc[2 * dp2 + 1], dsa[j], qb[2], qb[3]);
      }
    __syncthreads();                        // stage free for tile it + 2
  }

  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k0 + r + 8 * i;
    if (kpos >= a.Skv) continue;
    const long long o = (((long long)b * a.Skv + kpos) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dk + o + c) = __floats2bfloat162_rn(
          dk_acc[n][2 * i] * a.scale, dk_acc[n][2 * i + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + c) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

enum Which { FWD = 0, BWD_DQ = 1, BWD_DKV = 2 };

// shared memory of the CUDA-core kernels (f32 operands)
template <int D>
constexpr size_t simt_smem(Which w) {
  return sizeof(float) *
         (w == FWD ? (size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * PS
          : w == BWD_DQ ? (size_t)(2 * BQ + 2 * BK) * (D + 1) +
                              (size_t)BQ * PS
                        : (size_t)(2 * BQ + 2 * BK) * (D + 1) +
                              (size_t)2 * BK * PS + 2 * BQ);
}

int launch_kernel(void (*kern)(Args), int threads, size_t smem,
                  const Args& a, int rows, int tile, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + tile - 1) / tile, a.B * a.H);
  kern<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// (block_q, block_k): every kernel takes 64 x 64; the bf16 forward also
// 128 x 64 up to D = 64. Any other pair is refused (cudaErrorInvalidValue)
template <typename T, int D>
int launch_d(Which w, const Args& a, int block_q, int block_k,
             cudaStream_t stream) {
  const int rows = w == BWD_DKV ? a.Skv : a.Sq;
  const bool tile64 = block_q == 64 && block_k == 64;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // every bf16 kernel runs on tensor cores
    if (w != FWD && !tile64) return (int)cudaErrorInvalidValue;
    if (w == BWD_DQ)
      return launch_kernel(flash_bwd_dq_kernel<D>, MMA_THREADS, dq_smem<D>(),
                           a, rows, MMA_ROWS, stream);
    if (w == BWD_DKV)
      return launch_kernel(flash_bwd_dkv_kernel<D>, MMA_THREADS,
                           dkv_smem<D>(), a, rows, MMA_ROWS, stream);
    // the forward's q tile: 64 * WM rows, the kv tile 64
    if (block_k != MMA_ROWS) return (int)cudaErrorInvalidValue;
    if constexpr (fwd_wm<D>() == 2) {
      if (block_q == 2 * MMA_ROWS)
        return launch_kernel(flash_fwd_kernel<D, 2>, MMA_THREADS,
                             fwd_smem<D, 2>(), a, rows, 2 * MMA_ROWS,
                             stream);
      if (block_q == MMA_ROWS)
        return launch_kernel(flash_fwd_q64_kernel<D>, MMA_THREADS,
                             fwd_smem<D, 1>(), a, rows, MMA_ROWS, stream);
    } else {
      if (block_q == MMA_ROWS)
        return launch_kernel(flash_fwd_kernel<D, 1>, MMA_THREADS,
                             fwd_smem<D, 1>(), a, rows, MMA_ROWS, stream);
    }
    return (int)cudaErrorInvalidValue;
  } else {
    if (!tile64) return (int)cudaErrorInvalidValue;
    void (*kern)(Args) = w == FWD      ? flash_fwd_simt_kernel<T, D>
                         : w == BWD_DQ ? flash_bwd_dq_simt_kernel<T, D>
                                       : flash_bwd_dkv_simt_kernel<T, D>;
    return launch_kernel(kern, THREADS, simt_smem<D>(w), a, rows,
                         w == BWD_DKV ? BK : BQ, stream);
  }
}

template <typename T>
int launch(Which w, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* o0,
           void* o1, void* o2, int B, int H, int Sq, int Skv, int D,
           int kv_len, int causal, int block_q, int block_k,
           const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || kv_len <= 0 ||
      kv_len > Skv)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = o0;
  a.lse_out = static_cast<float*>(o1);
  a.dq = o0;
  a.dk = o1;
  a.dv = o2;
  a.sq = Strides{strides[0], strides[1], strides[2]};
  a.sk = Strides{strides[3], strides[4], strides[5]};
  a.sv = Strides{strides[6], strides[7], strides[8]};
  a.sdo = Strides{strides[9], strides[10], strides[11]};
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.kv_len = kv_len;
  a.causal = causal;
  a.scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(w, a, block_q, block_k, s);
    case 32: return launch_d<T, 32>(w, a, block_q, block_k, s);
    case 48: return launch_d<T, 48>(w, a, block_q, block_k, s);
    case 64: return launch_d<T, 64>(w, a, block_q, block_k, s);
    case 80: return launch_d<T, 80>(w, a, block_q, block_k, s);
    case 96: return launch_d<T, 96>(w, a, block_q, block_k, s);
    case 112: return launch_d<T, 112>(w, a, block_q, block_k, s);
    case 128: return launch_d<T, 128>(w, a, block_q, block_k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers and the stream are
// void*; (block_q, block_k) is the tile (launch_d lists the pairs each
// kernel takes); `strides` points to 12 host int64s, the (batch, seq,
// head) element strides of q, k, v and do (the forward ignores do's).
// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or tile it does not take.
#define FLASH_ENTRY(NAME, T, W)                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* dout, const void* lse, const void* delta,  \
                      void* o0, void* o1, void* o2, int B, int H, int Sq,    \
                      int Skv, int D, int kv_len, int causal, int block_q,   \
                      int block_k, const long long* strides, void* stream) { \
    return launch<T>(W, q, k, v, dout, lse, delta, o0, o1, o2, B, H, Sq,    \
                     Skv, D, kv_len, causal, block_q, block_k, strides,      \
                     stream);                                                \
  }

// forward: o0 = out, o1 = lse;  dq: o0 = dq;  dkv: o1 = dk, o2 = dv
FLASH_ENTRY(flash_fwd_bf16, __nv_bfloat16, FWD)
FLASH_ENTRY(flash_fwd_f32, float, FWD)
FLASH_ENTRY(flash_bwd_dq_bf16, __nv_bfloat16, BWD_DQ)
FLASH_ENTRY(flash_bwd_dq_f32, float, BWD_DQ)
FLASH_ENTRY(flash_bwd_dkv_bf16, __nv_bfloat16, BWD_DKV)
FLASH_ENTRY(flash_bwd_dkv_f32, float, BWD_DKV)
