// Short-sequence fused self-attention, forward and backward, for Hopper
// (sm_90a): every fp32 kernel. Every bf16 forward is short_attention_fwd.cu's
// and every bf16 backward short_attention_bwd.cu's.
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_attention.py:
//   K1  _fwd_kernel_pairs / _bwd_kernel_pairs (via _pallas_fwd_pairs and
//       _pallas_bwd_pairs, entry fused_attention_dense): packed qkv
//       [B, N, 3C] (column order [3, H, D]) -> out [B, N, C]; backward:
//       qkv, dout -> packed dqkv [B, N, 3C];
//   K2  _fwd_kernel / _bwd_kernel (via _pallas_fwd and _pallas_bwd, entry
//       fused_attention): q, k, v, out [B, H, N, D]; backward: q, k, v,
//       dout -> dq, dk, dv.
//   K3  _fwd_kernel_relwin_pairs / _bwd_kernel_relwin_pairs (via
//       _pallas_fwd_relwin_pairs and _pallas_bwd_relwin_pairs, entry
//       fused_attention_relwin_dense) and K4 _fwd_kernel_relwin /
//       _bwd_kernel_relwin (via _relwin_fwd_factory and _relwin_bwd_factory,
//       entry fused_attention_relwin): K1 and K2 with SAM's decomposed
//       rel-pos bias, score(i, j) += rel_h[i, j / KW] + rel_w[i, j % KW]
//       (fp32, N = KH * KW, each term read through its own strides); the
//       backward also gives drel_h and drel_w (fp32).
//   K2b _fwd_kernel_bias / _bwd_kernel_bias (via _pallas_fwd_bias and
//       _pallas_bwd_bias, entry fused_attention(bias=)): K2 with a full
//       additive score bias, score(i, j) += bias[b, h, i, j] (fp32 or bf16,
//       read through its own strides, 0 on an axis it is broadcast over);
//       the backward also writes dbias = dS0 (fp32, [B, H, N, N]).
//   K9  _fwd_kernel_packed / _bwd_kernel_packed (via _pallas_fwd_packed and
//       _pallas_bwd_packed, entry fused_attention_qkv): K1's launch at the
//       strides of a packed [B, N, 3, H, D] qkv, any D <= 128; out [B, N, H,
//       D]; backward: dqkv packed the same way. No device code of its own.
// One kernel body per dtype and direction serves all of them: the wrapper
// passes the (batch, head, row) strides of the inputs and of the outputs,
// and each head's columns are read and written in place in either layout
// (no layout copies). The backward kernels have their own notes further
// down.
//
// Math, as the TPU kernels: s = q.k^T * scale in fp32; keys at or past
// n_real get -1e9 (not -inf); softmax over the whole row in fp32; P is
// normalised, then cast to the input dtype; P.V accumulates in fp32 and the
// output is written in the input dtype. N <= 1024, D <= 128.
//
// fp32 design (not on the main path): one block per 32 query rows keeps
// the whole fp32 score row in shared memory and uses plain FMA loops, so
// fp32 inputs keep full fp32 precision. The C entry points refuse bf16
// (the short_attention_*.cu kernels').

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace saicv;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;
constexpr float kNegInf = -1e9f;  // _NEG_INF of the TPU kernels

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A full additive score bias (K2b): bias[b, h, i, j] of query i and key j,
// fp32 or bf16, read through its (batch, head, row) strides, 0 on an axis
// it is broadcast over; the key axis is contiguous. When `grad` is set, the
// dq kernel writes dS0, the bias's fp32 gradient, to it as a contiguous
// [B, H, N, N].
struct FullBias {
  const void* p;  // nullptr: no full bias
  long long sb, sh, sn;
  int is_bf16;
  float* grad;

  __device__ __forceinline__ long long row(int b, int hd, int i) const {
    return b * sb + hd * sh + static_cast<long long>(i) * sn;
  }
  __device__ __forceinline__ float at(long long off) const {
    return is_bf16 ? __bfloat162float(__ldg(static_cast<const bf16*>(p) + off))
                   : __ldg(static_cast<const float*>(p) + off);
  }
};

// ------------------------------------------------------------- fp32 path

constexpr int kQTile = 32;   // query rows per block
constexpr int kKChunk = 64;  // keys staged in shared memory at a time
constexpr int kPadF = 1;     // row padding (floats) against bank conflicts

// Row stride (floats) of the score rows.
__host__ __device__ inline int score_stride(int N) { return ((N + 31) & ~31) + 4; }

// Copy `rows` rows into shared memory [rows][LD], zero past nvalid / D.
template <int DP, int LD>
__device__ void load_rows_f32(float* dst, const float* src, long long sn, int rows,
                              int nvalid, int D) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    dst[r * LD + c] = (r < nvalid && c < D) ? src[r * sn + c] : 0.f;
  }
}

// With rel.h set (K3, K4) each score gains rel_h[q, j / KW] + rel_w[q, j % KW];
// with fb.p set (K2b) it gains the full bias.
template <int DP>
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  long long in_sb, long long in_sh, long long in_sn,
                  long long out_sb, long long out_sh, long long out_sn,
                  int N, int D, int n_real, float scale, RelPos rel, FullBias fb) {
  constexpr int LD = DP + kPadF;
  constexpr int kPer = kMaxN / 32;
  const int NP = (N + 15) & ~15;
  const int LDS = score_stride(N);
  const int q0 = blockIdx.x * kQTile;
  const long long in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const float* qh = q + in_off;
  const float* kh = k + in_off;
  const float* vh = v + in_off;
  float* oh = o + blockIdx.z * out_sb + blockIdx.y * out_sh;

  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);  // [kQTile][LDS]
  float* Qs = S + kQTile * LDS;               // [kQTile][LD]
  float* KVs = Qs + kQTile * LD;              // [kKChunk][LD]

  load_rows_f32<DP, LD>(Qs, qh + q0 * in_sn, in_sn, kQTile, N - q0, D);
  for (int c0 = 0; c0 < NP; c0 += kKChunk) {  // raw scores, chunk by chunk
    const int cols = min(kKChunk, NP - c0);
    __syncthreads();
    load_rows_f32<DP, LD>(KVs, kh + c0 * in_sn, in_sn, cols, N - c0, D);
    __syncthreads();
    for (int i = threadIdx.x; i < kQTile * cols; i += kThreads) {
      const float* qr = Qs + (i / cols) * LD;
      const float* kr = KVs + (i % cols) * LD;
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) a = fmaf(qr[d], kr[d], a);
      S[(i / cols) * LDS + c0 + i % cols] = a;
    }
  }
  __syncthreads();

  // whole-row softmax, one warp per row; P overwrites the scores
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kQTile; r += kWarps) {
    float* row = S + r * LDS;
    const RelRows rr = rel.h ? rel.rows(blockIdx.z, blockIdx.y, q0 + r, N) : RelRows{};
    const long long brow = fb.p ? fb.row(blockIdx.z, blockIdx.y, min(q0 + r, N - 1)) : 0;
    float vals[kPer];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (32 * i >= N) break;
      const int c = lane + 32 * i;
      float bias = 0.f;
      if (rel.h && c < N) {
        int jh, jw;
        col_split(c, rel.inv_kw, rel.KW, jh, jw);
        bias = rr.h[0][jh] + rr.w[0][jw];
      }
      if (fb.p && c < N) bias = fb.at(brow + c);
      vals[i] = c >= N ? -INFINITY : (c < n_real ? row[c] * scale + bias : kNegInf);
      mx = fmaxf(mx, vals[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (32 * i >= N) break;
      vals[i] = lane + 32 * i < N ? expf(vals[i] - mx) : 0.f;
      sum += vals[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (32 * i >= NP) break;
      const int c = lane + 32 * i;
      if (c < NP) row[c] = c < N ? vals[i] / sum : 0.f;
    }
  }

  constexpr int kOutPerThread = kQTile * DP / kThreads;
  float acc[kOutPerThread];
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < NP; c0 += kKChunk) {  // O = P.V, V chunk by chunk
    const int cols = min(kKChunk, NP - c0);
    __syncthreads();
    load_rows_f32<DP, LD>(KVs, vh + c0 * in_sn, in_sn, cols, N - c0, D);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const float* prow = S + (i / DP) * LDS + c0;
      const float* vcol = KVs + (i % DP);
      float a = acc[j];
      for (int kk = 0; kk < cols; ++kk) a = fmaf(prow[kk], vcol[kk * LD], a);
      acc[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / DP;
    const int c = i % DP;
    if (q0 + r < N && c < D) oh[(q0 + r) * out_sn + c] = acc[j];
  }
}

// ---------------------------------------------------------- the backward
//
// Two kernels (below): the first owns query rows and writes dQ, the row
// statistics and (K3, K4) drel or (K2b) dbias; the second owns key rows and
// writes dK and dV from those statistics. Every output row has one owner:
// no atomics.

struct BwdArgs {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;  // [B, H, N] each
  long long in_sb, in_sh, in_sn, do_sb, do_sh, do_sn, out_sb, out_sh, out_sn;
  int B, H, N, D, n_real;
  float scale;
  cudaStream_t stream;
  RelPos rel;    // rel.h == nullptr: no rel-pos bias (K1, K2)
  RelGrad drel;  // K3, K4: written by the dq kernel
  FullBias bias;  // bias.p == nullptr: no full bias; K2b's dbias in bias.grad
};

// -------------------------------------------------------- fp32 backward
//
// The same split in plain FMA loops (not on the main path): a block owns 16
// query rows (dQ) or 16 key rows (dK, dV) and keeps their whole score and
// dP rows in shared memory, so fp32 inputs keep fp32 precision throughout.

constexpr int kBwdRows = 16;

// out[r][c0 + c] = own[r] . chunk[c] for every row of `src`, chunk by chunk.
template <int DP, int LD>
__device__ void rows_times_all_t(float* out, int LDS, const float* own, float* chunk,
                                 const float* src, long long sn, int N, int NP, int D) {
  for (int c0 = 0; c0 < NP; c0 += kKChunk) {
    const int cols = min(kKChunk, NP - c0);
    __syncthreads();
    load_rows_f32<DP, LD>(chunk, src + c0 * sn, sn, cols, N - c0, D);
    __syncthreads();
    for (int i = threadIdx.x; i < kBwdRows * cols; i += kThreads) {
      const float* a = own + (i / cols) * LD;
      const float* b = chunk + (i % cols) * LD;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) acc = fmaf(a[d], b[d], acc);
      out[(i / cols) * LDS + c0 + i % cols] = acc;
    }
  }
  __syncthreads();
}

// acc[j] += sum_c w[r][c] * src[c][d] over all rows c of `src`.
template <int DP, int LD>
__device__ void all_weighted_rows(float (&acc)[kBwdRows * DP / kThreads], const float* w,
                                  int LDS, float* chunk, const float* src, long long sn, int N,
                                  int NP, int D) {
  for (int c0 = 0; c0 < NP; c0 += kKChunk) {
    const int cols = min(kKChunk, NP - c0);
    __syncthreads();
    load_rows_f32<DP, LD>(chunk, src + c0 * sn, sn, cols, N - c0, D);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBwdRows * DP / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const float* wr = w + (i / DP) * LDS + c0;
      const float* col = chunk + (i % DP);
      float x = acc[j];
      for (int kk = 0; kk < cols; ++kk) x = fmaf(wr[kk], col[kk * LD], x);
      acc[j] = x;
    }
  }
}

template <int DP>
__device__ void store_rows_f32(float* head, long long sn,
                               const float (&acc)[kBwdRows * DP / kThreads], int row0, int N,
                               int D) {
#pragma unroll
  for (int j = 0; j < kBwdRows * DP / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / DP;
    const int c = i % DP;
    if (row0 + r < N && c < D) head[(row0 + r) * sn + c] = acc[j];
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_f32(BwdArgs a) {
  constexpr int LD = DP + kPadF;
  const int N = a.N, D = a.D, n_real = a.n_real;
  const int NP = (N + 15) & ~15;
  const int LDS = score_stride(N);
  const int q0 = blockIdx.x * kBwdRows;
  const long long in_off = blockIdx.z * a.in_sb + blockIdx.y * a.in_sh;
  const float* qh = static_cast<const float*>(a.q) + in_off;
  const float* kh = static_cast<const float*>(a.k) + in_off;
  const float* vh = static_cast<const float*>(a.v) + in_off;
  const float* doh =
      static_cast<const float*>(a.dout) + blockIdx.z * a.do_sb + blockIdx.y * a.do_sh;
  float* dqh = static_cast<float*>(a.dq) + blockIdx.z * a.out_sb + blockIdx.y * a.out_sh;
  const long long stat_off = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * N;

  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);  // [kBwdRows][LDS] scores, then dS
  float* dP = S + kBwdRows * LDS;             // [kBwdRows][LDS]
  float* Qs = dP + kBwdRows * LDS;            // [kBwdRows][LD]
  float* dOs = Qs + kBwdRows * LD;            // [kBwdRows][LD]
  float* chunk = dOs + kBwdRows * LD;         // [kKChunk][LD]

  load_rows_f32<DP, LD>(Qs, qh + q0 * a.in_sn, a.in_sn, kBwdRows, N - q0, D);
  load_rows_f32<DP, LD>(dOs, doh + q0 * a.do_sn, a.do_sn, kBwdRows, N - q0, D);
  rows_times_all_t<DP, LD>(S, LDS, Qs, chunk, kh, a.in_sn, N, NP, D);
  rows_times_all_t<DP, LD>(dP, LDS, dOs, chunk, vh, a.in_sn, N, NP, D);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool rel = a.rel.h != nullptr;   // K3, K4
  const bool full = a.bias.p != nullptr;  // K2b
  const bool unscaled = rel || full;      // drel and dbias read dS0 before the scale
  const int KH = a.rel.KH, KW = a.rel.KW;
  for (int r = warp; r < kBwdRows; r += kWarps) {
    float* srow = S + r * LDS;
    const float* dprow = dP + r * LDS;
    const RelRows rr = rel ? a.rel.rows(blockIdx.z, blockIdx.y, q0 + r, N) : RelRows{};
    const long long brow = full ? a.bias.row(blockIdx.z, blockIdx.y, min(q0 + r, N - 1)) : 0;
    float mx = -INFINITY;
    for (int c = lane; c < N; c += 32) {
      float bias = 0.f;
      if (rel) {
        int jh, jw;
        col_split(c, a.rel.inv_kw, KW, jh, jw);
        bias = rr.h[0][jh] + rr.w[0][jw];
      }
      if (full) bias = a.bias.at(brow + c);
      srow[c] = c < n_real ? srow[c] * a.scale + bias : kNegInf;
      mx = fmaxf(mx, srow[c]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) sum += expf(srow[c] - mx);
    const float lse = mx + logf(warp_sum(sum));
    float row = 0.f;
    for (int c = lane; c < N; c += 32) row += expf(srow[c] - lse) * dprow[c];
    row = warp_sum(row);
    // dS0 = P * (dP - row), times the scale (rel, full: after drel or dbias
    // has read it)
    for (int c = lane; c < NP; c += 32)
      srow[c] = c < N ? expf(srow[c] - lse) * (dprow[c] - row) * (unscaled ? 1.f : a.scale) : 0.f;
    if (lane == 0 && q0 + r < N) {
      a.lse[stat_off + q0 + r] = lse;
      a.delta[stat_off + q0 + r] = row;
    }
    if (rel) {  // drel_h[kh] = sum over jw of dS0[kh * KW + jw], drel_w likewise
      __syncwarp();
      if (q0 + r < N) {
        float* gh = a.drel.h_row(blockIdx.z, blockIdx.y, q0 + r);
        float* gw = a.drel.w_row(blockIdx.z, blockIdx.y, q0 + r);
        for (int kh = lane; kh < KH; kh += 32) {
          float x = 0.f;
          for (int jw = 0; jw < KW; ++jw) x += srow[kh * KW + jw];
          gh[kh] = x;
        }
        for (int kw = lane; kw < KW; kw += 32) {
          float x = 0.f;
          for (int jh = 0; jh < KH; ++jh) x += srow[jh * KW + kw];
          gw[kw] = x;
        }
      }
      __syncwarp();
    }
    if (full && a.bias.grad && q0 + r < N) {  // dbias = dS0
      float* gb = a.bias.grad + (stat_off + q0 + r) * N;
      for (int c = lane; c < N; c += 32) gb[c] = srow[c];
    }
    if (unscaled)
      for (int c = lane; c < N; c += 32) srow[c] *= a.scale;
  }

  float acc[kBwdRows * DP / kThreads];
#pragma unroll
  for (int j = 0; j < kBwdRows * DP / kThreads; ++j) acc[j] = 0.f;
  all_weighted_rows<DP, LD>(acc, S, LDS, chunk, kh, a.in_sn, N, NP, D);
  store_rows_f32<DP>(dqh, a.out_sn, acc, q0, N, D);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_f32(BwdArgs a) {
  constexpr int LD = DP + kPadF;
  const int N = a.N, D = a.D, n_real = a.n_real;
  const int NP = (N + 15) & ~15;
  const int LDS = score_stride(N);
  const int k0 = blockIdx.x * kBwdRows;
  const long long in_off = blockIdx.z * a.in_sb + blockIdx.y * a.in_sh;
  const float* qh = static_cast<const float*>(a.q) + in_off;
  const float* kh = static_cast<const float*>(a.k) + in_off;
  const float* vh = static_cast<const float*>(a.v) + in_off;
  const float* doh =
      static_cast<const float*>(a.dout) + blockIdx.z * a.do_sb + blockIdx.y * a.do_sh;
  const long long out_off = blockIdx.z * a.out_sb + blockIdx.y * a.out_sh;
  const long long stat_off = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * N;

  extern __shared__ __align__(128) unsigned char smem[];
  float* PT = reinterpret_cast<float*>(smem);  // [kBwdRows][LDS] S^T, then P^T
  float* dST = PT + kBwdRows * LDS;            // [kBwdRows][LDS] dP^T, then dS^T
  float* Ko = dST + kBwdRows * LDS;            // own keys [kBwdRows][LD]
  float* Vo = Ko + kBwdRows * LD;              // own values [kBwdRows][LD]
  float* chunk = Vo + kBwdRows * LD;           // [kKChunk][LD]
  float* lse_s = chunk + kKChunk * LD;         // [NP]
  float* delta_s = lse_s + NP;                 // [NP]

  load_rows_f32<DP, LD>(Ko, kh + k0 * a.in_sn, a.in_sn, kBwdRows, N - k0, D);
  load_rows_f32<DP, LD>(Vo, vh + k0 * a.in_sn, a.in_sn, kBwdRows, N - k0, D);
  for (int i = threadIdx.x; i < NP; i += kThreads) {
    lse_s[i] = i < N ? a.lse[stat_off + i] : 0.f;
    delta_s[i] = i < N ? a.delta[stat_off + i] : 0.f;
  }
  rows_times_all_t<DP, LD>(PT, LDS, Ko, chunk, qh, a.in_sn, N, NP, D);
  rows_times_all_t<DP, LD>(dST, LDS, Vo, chunk, doh, a.do_sn, N, NP, D);

  for (int i = threadIdx.x; i < kBwdRows * NP; i += kThreads) {
    const int r = i / NP;
    const int c = i % NP;
    const bool valid = c < N && k0 + r < n_real;
    // K3, K4: rel_h[c, jh(key)] + rel_w[c, jw(key)]; K2b: bias[c, key]
    float bias = 0.f;
    if (a.rel.h && valid) {
      int jh, jw;
      col_split(k0 + r, a.rel.inv_kw, a.rel.KW, jh, jw);
      const RelRows rr = a.rel.rows(blockIdx.z, blockIdx.y, c, N);
      bias = rr.h[0][jh] + rr.w[0][jw];
    }
    if (a.bias.p && valid) bias = a.bias.at(a.bias.row(blockIdx.z, blockIdx.y, c) + k0 + r);
    const float p = valid ? expf(PT[r * LDS + c] * a.scale + bias - lse_s[c]) : 0.f;
    PT[r * LDS + c] = p;
    dST[r * LDS + c] = p * (dST[r * LDS + c] - delta_s[c]) * a.scale;
  }

  float dk[kBwdRows * DP / kThreads], dv[kBwdRows * DP / kThreads];
#pragma unroll
  for (int j = 0; j < kBwdRows * DP / kThreads; ++j) dk[j] = dv[j] = 0.f;
  all_weighted_rows<DP, LD>(dv, PT, LDS, chunk, doh, a.do_sn, N, NP, D);
  all_weighted_rows<DP, LD>(dk, dST, LDS, chunk, qh, a.in_sn, N, NP, D);
  store_rows_f32<DP>(static_cast<float*>(a.dk) + out_off, a.out_sn, dk, k0, N, D);
  store_rows_f32<DP>(static_cast<float*>(a.dv) + out_off, a.out_sn, dv, k0, N, D);
}

// ------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v;
  void* o;
  long long in_sb, in_sh, in_sn, out_sb, out_sh, out_sn;
  int B, H, N, D, n_real;
  float scale;
  cudaStream_t stream;
  RelPos rel;     // rel.h == nullptr: no rel-pos bias
  FullBias bias;  // bias.p == nullptr: no full bias
};

template <int DP>
int launch_f32(const Args& a) {
  constexpr int LD = DP + kPadF;
  const size_t smem =
      sizeof(float) * (kQTile * score_stride(a.N) + (kQTile + kKChunk) * LD);
  auto kernel = attention_fwd_f32<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.N + kQTile - 1) / kQTile, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.in_sb, a.in_sh, a.in_sn,
      a.out_sb, a.out_sh, a.out_sn, a.N, a.D, a.n_real, a.scale, a.rel, a.bias);
  return static_cast<int>(cudaGetLastError());
}

// fp32 only: every bf16 forward is short_attention_fwd.cu's
template <int DP>
int launch_dtype(const Args& a, int is_bf16) {
  return is_bf16 ? static_cast<int>(cudaErrorInvalidValue) : launch_f32<DP>(a);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DP>
int launch_bwd_f32(const BwdArgs& a) {
  constexpr int LD = DP + kPadF;
  const int NP = (a.N + 15) & ~15;
  const size_t smem = sizeof(float) * (2 * kBwdRows * score_stride(a.N) +
                                       (2 * kBwdRows + kKChunk) * LD + 2 * NP);
  const dim3 grid((a.N + kBwdRows - 1) / kBwdRows, a.H, a.B);
  auto dq_kernel = attention_bwd_dq_f32<DP>;
  auto dkv_kernel = attention_bwd_dkv_f32<DP>;
  cudaError_t err = allow_smem(dq_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(dkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<grid, kThreads, smem, a.stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<grid, kThreads, smem, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// fp32 only: every bf16 backward is short_attention_bwd.cu's
template <int DP>
int launch_bwd_dtype(const BwdArgs& a, int is_bf16) {
  return is_bf16 ? static_cast<int>(cudaErrorInvalidValue) : launch_bwd_f32<DP>(a);
}

Args forward_args(const void* q, const void* k, const void* v, void* o, long long in_sb,
                  long long in_sh, long long in_sn, long long out_sb, long long out_sh,
                  long long out_sn, int B, int H, int N, int D, int n_real, float scale,
                  void* stream) {
  return Args{q,      k, v, o, in_sb,  in_sh, in_sn, out_sb, out_sh,
              out_sn, B, H, N, D, n_real, scale,
              static_cast<cudaStream_t>(stream), RelPos{}, FullBias{}};
}

bool bad_shape(int B, int H, int N, int D, int n_real) {
  return B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > kMaxN || D < 1 || D > 128 ||
         n_real < 1 || n_real > N;
}

BwdArgs backward_args(const void* q, const void* k, const void* v, const void* dout, void* dq,
                      void* dk, void* dv, void* stats, long long in_sb, long long in_sh,
                      long long in_sn, long long do_sb, long long do_sh, long long do_sn,
                      long long out_sb, long long out_sh, long long out_sn, int B, int H, int N,
                      int D, int n_real, float scale, int is_bf16, void* stream) {
  float* lse = static_cast<float*>(stats);
  return BwdArgs{q,     k,     v,     dout,  dq,     dk,     dv,     lse,
                 lse + static_cast<long long>(B) * H * N,
                 in_sb, in_sh, in_sn, do_sb, do_sh,  do_sn,  out_sb, out_sh, out_sn,
                 B,     H,     N,     D,     n_real, scale,
                 static_cast<cudaStream_t>(stream), RelPos{}, RelGrad{}, FullBias{}};
}

// The dispatchers over every head dim and the C entry points; a source that
// includes this file for its kernels (attn_block.cu) defines
// SAICV_ATTENTION_DEVICE_ONLY and instantiates only the head dims it uses.
#ifndef SAICV_ATTENTION_DEVICE_ONLY

int launch_forward(const Args& a, int is_bf16) {
  switch ((a.D + 15) / 16 * 16) {
    case 16: return launch_dtype<16>(a, is_bf16);
    case 32: return launch_dtype<32>(a, is_bf16);
    case 48: return launch_dtype<48>(a, is_bf16);
    case 64: return launch_dtype<64>(a, is_bf16);
    case 80: return launch_dtype<80>(a, is_bf16);
    case 96: return launch_dtype<96>(a, is_bf16);
    case 112: return launch_dtype<112>(a, is_bf16);
    default: return launch_dtype<128>(a, is_bf16);
  }
}

int launch_backward(const BwdArgs& a, int is_bf16) {
  switch ((a.D + 15) / 16 * 16) {
    case 16: return launch_bwd_dtype<16>(a, is_bf16);
    case 32: return launch_bwd_dtype<32>(a, is_bf16);
    case 48: return launch_bwd_dtype<48>(a, is_bf16);
    case 64: return launch_bwd_dtype<64>(a, is_bf16);
    case 80: return launch_bwd_dtype<80>(a, is_bf16);
    case 96: return launch_bwd_dtype<96>(a, is_bf16);
    case 112: return launch_bwd_dtype<112>(a, is_bf16);
    default: return launch_bwd_dtype<128>(a, is_bf16);
  }
}

#endif  // SAICV_ATTENTION_DEVICE_ONLY

}  // namespace

#ifndef SAICV_ATTENTION_DEVICE_ONLY

// Plain C entry point, loaded with ctypes. Pointers are device pointers of
// the input dtype (is_bf16 = 1: bfloat16, 0: float32); strides are in
// elements; the head dim is contiguous. Returns a cudaError_t (0 = launched).
extern "C" int saicv_fused_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long in_sb, long long in_sh, long long in_sn,
    long long out_sb, long long out_sh, long long out_sn,
    int B, int H, int N, int D, int n_real, float scale, int is_bf16,
    void* stream) {
  if (bad_shape(B, H, N, D, n_real)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_forward(forward_args(q, k, v, o, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn,
                                     B, H, N, D, n_real, scale, stream),
                        is_bf16);
}

// The same forward with SAM's decomposed rel-pos bias (K3, K4): the score of
// query i and key j gains rel_h[i, j / KW] + rel_w[i, j % KW], with N = KH *
// KW. rel_h and rel_w are fp32, each with its own (batch, head, row)
// strides and a contiguous last axis of KH or KW values. fp32 inputs only
// (is_bf16 = 0): the bf16 forward is short_attention_fwd.cu's.
extern "C" int saicv_fused_attention_relpos_fwd(
    const void* q, const void* k, const void* v, void* o, const float* rel_h,
    const float* rel_w, long long in_sb, long long in_sh, long long in_sn,
    long long out_sb, long long out_sh, long long out_sn, long long h_sb, long long h_sh,
    long long h_sn, long long w_sb, long long w_sh, long long w_sn, int B, int H, int N,
    int D, int n_real, int KH, int KW, float scale, int is_bf16, void* stream) {
  if (bad_shape(B, H, N, D, n_real) || KH < 1 || KW < 1 || KH * KW != N || !rel_h || !rel_w)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = forward_args(q, k, v, o, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, B, H, N, D,
                        n_real, scale, stream);
  a.rel = RelPos{rel_h, rel_w, h_sb, h_sh, h_sn, w_sb, w_sh, w_sn, KH, KW, 1.f / KW};
  return launch_forward(a, is_bf16);
}

// The same forward with a full additive score bias (K2b): the score of
// query i and key j of (batch b, head h) gains bias[b * b_sb + h * b_sh + i *
// b_sn + j], fp32 (bias_bf16 = 0) or bf16 (1); a stride is 0 on an axis the
// bias is broadcast over. fp32 inputs only, as above.
extern "C" int saicv_fused_attention_bias_fwd(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    long long in_sb, long long in_sh, long long in_sn,
    long long out_sb, long long out_sh, long long out_sn,
    long long b_sb, long long b_sh, long long b_sn,
    int B, int H, int N, int D, int n_real, float scale, int is_bf16, int bias_bf16,
    void* stream) {
  if (bad_shape(B, H, N, D, n_real) || !bias) return static_cast<int>(cudaErrorInvalidValue);
  Args a = forward_args(q, k, v, o, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, B, H, N, D,
                        n_real, scale, stream);
  a.bias = FullBias{bias, b_sb, b_sh, b_sn, bias_bf16, nullptr};
  return launch_forward(a, is_bf16);
}

// Backward of the same function: dq, dk, dv (one stride set, head dim
// contiguous) from q, k, v (one stride set) and dout (its own strides).
// `stats` is fp32 scratch of 2 * B * H * N elements. Two launches on
// `stream`; returns a cudaError_t (0 = both launched).
extern "C" int saicv_fused_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* stats,
    long long in_sb, long long in_sh, long long in_sn,
    long long do_sb, long long do_sh, long long do_sn,
    long long out_sb, long long out_sh, long long out_sn,
    int B, int H, int N, int D, int n_real, float scale, int is_bf16,
    void* stream) {
  if (bad_shape(B, H, N, D, n_real)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_backward(
      backward_args(q, k, v, dout, dq, dk, dv, stats, in_sb, in_sh, in_sn, do_sb, do_sh, do_sn,
                    out_sb, out_sh, out_sn, B, H, N, D, n_real, scale, is_bf16, stream),
      is_bf16);
}

// Backward of the rel-pos forward (K3, K4): as saicv_fused_attention_bwd,
// and drel_h, drel_w (fp32, the shapes of rel_h and rel_w, their own
// strides), the sums over each query row's keys of dS0 = P * (dP - sum_k dP
// * P), unscaled, by the key's row jh and column jw of the key grid.
extern "C" int saicv_fused_attention_relpos_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* stats, const float* rel_h, const float* rel_w,
    float* drel_h, float* drel_w,
    long long in_sb, long long in_sh, long long in_sn,
    long long do_sb, long long do_sh, long long do_sn,
    long long out_sb, long long out_sh, long long out_sn,
    long long h_sb, long long h_sh, long long h_sn, long long w_sb, long long w_sh,
    long long w_sn, long long dh_sb, long long dh_sh, long long dh_sn, long long dw_sb,
    long long dw_sh, long long dw_sn,
    int B, int H, int N, int D, int n_real, int KH, int KW, float scale, int is_bf16,
    void* stream) {
  if (bad_shape(B, H, N, D, n_real) || KH < 1 || KW < 1 || KH * KW != N || !rel_h ||
      !rel_w || !drel_h || !drel_w)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = backward_args(q, k, v, dout, dq, dk, dv, stats, in_sb, in_sh, in_sn, do_sb,
                            do_sh, do_sn, out_sb, out_sh, out_sn, B, H, N, D, n_real, scale,
                            is_bf16, stream);
  a.rel = RelPos{rel_h, rel_w, h_sb, h_sh, h_sn, w_sb, w_sh, w_sn, KH, KW, 1.f / KW};
  a.drel = RelGrad{drel_h, drel_w, dh_sb, dh_sh, dh_sn, dw_sb, dw_sh, dw_sn};
  return launch_backward(a, is_bf16);
}

// Backward of the full-bias forward (K2b): as saicv_fused_attention_bwd,
// and, unless dbias is null, dbias = dS0 = P * (dP - sum_k dP * P),
// unscaled, fp32, a contiguous [B, H, N, N] whatever the bias's strides.
extern "C" int saicv_fused_attention_bias_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* stats, const void* bias, float* dbias,
    long long in_sb, long long in_sh, long long in_sn,
    long long do_sb, long long do_sh, long long do_sn,
    long long out_sb, long long out_sh, long long out_sn,
    long long b_sb, long long b_sh, long long b_sn,
    int B, int H, int N, int D, int n_real, float scale, int is_bf16, int bias_bf16,
    void* stream) {
  if (bad_shape(B, H, N, D, n_real) || !bias) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = backward_args(q, k, v, dout, dq, dk, dv, stats, in_sb, in_sh, in_sn, do_sb,
                            do_sh, do_sn, out_sb, out_sh, out_sn, B, H, N, D, n_real, scale,
                            is_bf16, stream);
  a.bias = FullBias{bias, b_sb, b_sh, b_sn, bias_bf16, dbias};
  return launch_backward(a, is_bf16);
}

#endif  // SAICV_ATTENTION_DEVICE_ONLY
