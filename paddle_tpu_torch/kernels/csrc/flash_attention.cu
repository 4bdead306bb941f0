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
// - flash_fwd_kernel     <- _mha_fwd_jit (pl.pallas_call :119, _fwd_kernel :31)
// - flash_bwd_dq_kernel  <- _mha_bwd_jit (pl.pallas_call :310, _bwd_dq_kernel :170)
// - flash_bwd_dkv_kernel <- _mha_bwd_jit (pl.pallas_call :327, _bwd_dkv_kernel :209)
// Reference analog: the flash-attention library the reference builds
// into phi/kernels/gpu/flash_attn_kernel.cu (and its grad kernel).
//
// What bounds it on an H100: at GPT's [8, 1024, 16, 64] bf16 causal
// shape, the forward's least time is set by its bytes (q, k, v read and
// out written once, ~20 us) and just below it by its operations; each
// backward pass is bound by operations (the S = q k^T recompute, dp and
// one or two more products per live tile). All of that assumes tensor
// cores. This first design does every product as f32 FMAs from shared
// memory on the CUDA cores, far from either bound; tensor cores
// (mma.sync / wgmma on bf16 tiles fed by TMA) are the next kernel PR.
//
// Design (simple and right first), shared by the three kernels:
// - One block of 256 threads owns one 64-row tile of one (batch, head):
//   a q tile for the forward and dq, a kv tile for dk/dv. The Pallas
//   grid's sequential innermost axis becomes a loop inside the block
//   over the other operand's 64-row tiles.
// - Tiles are staged in shared memory as f32 with a row pitch of D + 1
//   floats, so both row-wise and column-wise reads are free of bank
//   conflicts. Thread (ty, tx) = (tid / 16, tid % 16) owns tile rows
//   ty + 16 i and columns tx + 16 j; row statistics reduce over the 16
//   lanes of a half-warp with shuffles.
// - Online softmax (m, l, acc) in f32 registers; masked scores hold
//   NEG_INF and their probabilities are zeroed. lse = m + log(max(l,
//   1e-30)), out = acc / max(l, 1e-30), as primitives.py finalizes.
// - Rounding follows the Pallas kernels: p is rounded to the input
//   dtype before p.v and p^T.do, ds before ds.k and ds^T.q, and the
//   softmax scale multiplies dq and dk once at the end.
// - Tiles entirely above the causal diagonal (causal_block_live) and
//   entirely past kv_len are skipped. Padded q rows (past Sq) get p = 0:
//   the Pallas wrapper killed them with lse = 1e30 instead.
// - Rows with no valid key (possible only with kv_len) are outside the
//   contract; here they produce out = 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Args a) {
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
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Args a) {
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
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Args a) {
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

enum Which { FWD = 0, BWD_DQ = 1, BWD_DKV = 2 };

template <int D>
constexpr size_t smem_bytes(Which w) {
  return sizeof(float) *
         (w == FWD ? (size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * PS
          : w == BWD_DQ ? (size_t)(2 * BQ + 2 * BK) * (D + 1) +
                              (size_t)BQ * PS
                        : (size_t)(2 * BQ + 2 * BK) * (D + 1) +
                              (size_t)2 * BK * PS + 2 * BQ);
}

template <typename T, int D>
int launch_d(Which w, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(w);
  void (*kern)(Args) = w == FWD      ? flash_fwd_kernel<T, D>
                       : w == BWD_DQ ? flash_bwd_dq_kernel<T, D>
                                     : flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = w == BWD_DKV ? a.Skv : a.Sq;
  const int tile = w == BWD_DKV ? BK : BQ;
  const dim3 grid((rows + tile - 1) / tile, a.B * a.H);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(Which w, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* o0,
           void* o1, void* o2, int B, int H, int Sq, int Skv, int D,
           int kv_len, int causal, const long long* strides, void* stream) {
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
    case 16: return launch_d<T, 16>(w, a, s);
    case 32: return launch_d<T, 32>(w, a, s);
    case 48: return launch_d<T, 48>(w, a, s);
    case 64: return launch_d<T, 64>(w, a, s);
    case 80: return launch_d<T, 80>(w, a, s);
    case 96: return launch_d<T, 96>(w, a, s);
    case 112: return launch_d<T, 112>(w, a, s);
    case 128: return launch_d<T, 128>(w, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers and the stream are
// void*; `strides` points to 12 host int64s, the (batch, seq, head)
// element strides of q, k, v and do (the forward ignores do's). Each
// returns cudaGetLastError() after the launch (0 = launched).
#define FLASH_ENTRY(NAME, T, W)                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* dout, const void* lse, const void* delta,  \
                      void* o0, void* o1, void* o2, int B, int H, int Sq,    \
                      int Skv, int D, int kv_len, int causal,                \
                      const long long* strides, void* stream) {              \
    return launch<T>(W, q, k, v, dout, lse, delta, o0, o1, o2, B, H, Sq,    \
                     Skv, D, kv_len, causal, strides, stream);               \
  }

// forward: o0 = out, o1 = lse;  dq: o0 = dq;  dkv: o1 = dk, o2 = dv
FLASH_ENTRY(flash_fwd_bf16, __nv_bfloat16, FWD)
FLASH_ENTRY(flash_fwd_f32, float, FWD)
FLASH_ENTRY(flash_bwd_dq_bf16, __nv_bfloat16, BWD_DQ)
FLASH_ENTRY(flash_bwd_dq_f32, float, BWD_DQ)
FLASH_ENTRY(flash_bwd_dkv_bf16, __nv_bfloat16, BWD_DKV)
FLASH_ENTRY(flash_bwd_dkv_f32, float, BWD_DKV)
