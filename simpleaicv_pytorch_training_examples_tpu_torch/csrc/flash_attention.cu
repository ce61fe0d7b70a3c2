// Streaming (flash) attention with SAM's decomposed relative-position bias
// (kernel K5) and with a per-key bias (kernel K6): the fp32 forward and the
// fp32 backward of both. The bf16 forward of both is flash_attention_fwd.cu,
// K5's bf16 backward flash_relpos_bwd.cu, K6's flash_keybias_bwd.cu.
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/flash_attention.py for fp32 inputs: _fwd_rel_kernel (via
// _flash_rel_forward, entry flash_attention_relpos) and
// _bwd_rel_fused_kernel (via _flash_rel_backward; its notes are further
// down); _fwd_kernel (via _flash_forward, entry flash_attention) and
// _bwd_fused_kernel. q, k, v [B, H, N, D] (K5: one set of strides with the head dim
// contiguous; K6: each its own, Nq queries and Nk keys), rel_h [B, H, N,
// KH] and rel_w [B, H, N, KW] fp32 with N = KH * KW (K5) or an fp32 key
// bias [B, Nk] read through its batch stride and shared by the heads and
// the queries (K6) -> out (its own strides) and the fp32 log-sum-exp of
// every query row, [B * H, Nq]. The score of query i and key j = jh * KW +
// jw is q_i.k_j * scale + rel_h[i, jh] + rel_w[i, jw] (K5), or q_i.k_j *
// sm_scale + bias[j] (K6; keys past Nk get -inf, the bias stays finite, so
// a row whose keys are all masked averages V, as on the TPU); the score
// matrix never leaves the chip.
//
// Math, as the TPU kernels: fp32 scores, one walk over the keys with an
// online row max and sum, the output divided by the sum at the end.
//
// fp32 design (not on the main path): a block of 4 warps owns 16 query rows;
// a lane scores one key of a 32-key tile in plain FMA loops and owns D / 32
// output columns, so fp32 inputs keep fp32 precision. The same bodies with
// the template flag kRel off are K6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace saicv;

constexpr int kWarps = 4;

// Strides in elements (batch, head, row) of one [B, H, N, D] operand.
struct Strides {
  long long b, h, n;
};

struct FlashArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;  // [B * H, Nq]
  Strides qs, ks, vs, os;
  RelPos rel;          // kRel (K5): the decomposed rel-pos bias, Nq = Nk
  const float* kbias;  // !kRel (K6): the key bias [B, Nk] or nullptr
  long long kbias_sb;
  int B, H, Nq, Nk, D;
  float scale;
};

// The backward's: delta = rowsum(dO * O) comes from the wrapper (one torch
// op, as the JAX package computes it outside its kernel).
struct FlashBwdArgs {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  const float *lse, *delta;  // [B * H, Nq] each; lse in natural log
  Strides qs, ks, vs, dos;   // the inputs
  Strides dqs, dkvs;         // dq; dk and dv (one set)
  RelPos rel;                // kRel (K5): Nq = Nk
  RelGrad drel;
  const float* kbias;  // K6: the key bias [B, Nk] or nullptr
  long long kbias_sb;
  int B, H, Nq, Nk, D;
  float scale;
};

// ------------------------------------------------------------- fp32 path

constexpr int kRowsF = 16;  // query rows a block
constexpr int kTileF = 32;  // keys a tile, one a lane

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

// rows rows of one head (row stride sn) -> shared [rows][LD], zero past
// nvalid and D
__device__ void load_rows_f32(float* dst, const float* src, long long sn, int rows,
                              int nvalid, int D, int LD) {
  for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
    const int r = i / LD;
    const int c = i % LD;
    dst[i] = (r < nvalid && c < D) ? src[r * sn + c] : 0.f;
  }
}

// DC = output columns a lane (D <= 32 * DC)
template <int DC, bool kRel>
__device__ __forceinline__ void flash_fwd_f32(const FlashArgs& a) {
  constexpr int LD = 32 * DC + 1;  // odd stride: a lane a bank
  constexpr int kPerWarp = kRowsF / kWarps;
  const int Nq = a.Nq, Nk = a.Nk, D = a.D;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kRowsF][LD]
  float* Ks = Qs + kRowsF * LD;                // [kTileF][LD]
  float* Vs = Ks + kTileF * LD;                // [kTileF][LD]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRowsF;
  const int bz = blockIdx.z, hy = blockIdx.y;
  const float* qh = static_cast<const float*>(a.q) + bz * a.qs.b + hy * a.qs.h;
  const float* kh = static_cast<const float*>(a.k) + bz * a.ks.b + hy * a.ks.h;
  const float* vh = static_cast<const float*>(a.v) + bz * a.vs.b + hy * a.vs.h;
  const float* kbias = a.kbias ? a.kbias + bz * a.kbias_sb : nullptr;

  load_rows_f32(Qs, qh + q0 * a.qs.n, a.qs.n, kRowsF, Nq - q0, D, LD);
  float m[kPerWarp], l[kPerWarp], acc[kPerWarp][DC];
  RelRows rr[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    if constexpr (kRel) rr[i] = a.rel.rows(bz, hy, q0 + warp * kPerWarp + i, Nq);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int key0 = 0; key0 < Nk; key0 += kTileF) {
    __syncthreads();
    load_rows_f32(Ks, kh + key0 * a.ks.n, a.ks.n, kTileF, Nk - key0, D, LD);
    load_rows_f32(Vs, vh + key0 * a.vs.n, a.vs.n, kTileF, Nk - key0, D, LD);
    __syncthreads();
    const int col = key0 + lane;
    int jh = 0, jw = 0;
    float kb = 0.f;  // K6: this lane's key bias
    if constexpr (kRel) {
      if (col < Nk) col_split(col, a.rel.inv_kw, a.rel.KW, jh, jw);
    } else {
      if (col < Nk && kbias) kb = kbias[col];
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const float* qr = Qs + (warp * kPerWarp + i) * LD;
      const float* kr = Ks + lane * LD;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      if constexpr (kRel) kb = rr[i].h[0][jh] + rr[i].w[0][jw];
      s = col < Nk ? s * a.scale + kb : -INFINITY;
      const float mnew = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - mnew);
      const float p = expf(s - mnew);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float x = acc[i][c] * alpha;
        for (int j = 0; j < kTileF; ++j)
          x = fmaf(__shfl_sync(0xffffffffu, p, j), Vs[j * LD + lane + 32 * c], x);
        acc[i][c] = x;
      }
    }
  }

  const long long lse_base = (static_cast<long long>(bz) * a.H + hy) * Nq;
  float* oh = static_cast<float*>(a.o) + bz * a.os.b + hy * a.os.h;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = q0 + warp * kPerWarp + i;
    if (row >= Nq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (lane + 32 * c < D) oh[row * a.os.n + lane + 32 * c] = acc[i][c] / l[i];
    if (lane == 0) a.lse[lse_base + row] = m[i] + logf(l[i]);
  }
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_relpos_fwd_f32(FlashArgs a) {
  flash_fwd_f32<DC, true>(a);
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_keybias_fwd_f32(FlashArgs a) {
  flash_fwd_f32<DC, false>(a);
}

// fp32 backward (not on the main path), in the forward's fp32 layout: a
// block of 4 warps owns 16 rows (4 a warp), a lane takes one query or key of
// a 32-wide tile and owns D / 32 output columns. K5's drel goes through a
// warp's tile of dS0 in shared memory: lane r (r + 4) adds row r's terms
// into drel_h (drel_w) in device memory, in key order. K6 (kRel off) takes
// the key bias of each key instead, and keys past Nk get P = 0.

// DC = output columns a lane (D <= 32 * DC)
template <int DC, bool kRel>
__device__ __forceinline__ void flash_bwd_dkv_f32(const FlashBwdArgs& a) {
  constexpr int LD = 32 * DC + 1;
  constexpr int kPerWarp = kRowsF / kWarps;
  const int Nq = a.Nq, Nk = a.Nk, D = a.D;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ko = reinterpret_cast<float*>(smem);  // own keys [kRowsF][LD]
  float* Vo = Ko + kRowsF * LD;                // own values [kRowsF][LD]
  float* Qs = Vo + kRowsF * LD;                // [kTileF][LD]
  float* dOs = Qs + kTileF * LD;               // [kTileF][LD]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kRowsF;
  const int bz = blockIdx.z, hy = blockIdx.y;
  const float* qh = static_cast<const float*>(a.q) + bz * a.qs.b + hy * a.qs.h;
  const float* doh = static_cast<const float*>(a.dout) + bz * a.dos.b + hy * a.dos.h;
  const long long stat_off = (static_cast<long long>(bz) * a.H + hy) * Nq;
  const float* relh = kRel ? a.rel.h + bz * a.rel.h_sb + hy * a.rel.h_sh : nullptr;
  const float* relw = kRel ? a.rel.w + bz * a.rel.w_sb + hy * a.rel.w_sh : nullptr;

  load_rows_f32(Ko, static_cast<const float*>(a.k) + bz * a.ks.b + hy * a.ks.h + k0 * a.ks.n,
                a.ks.n, kRowsF, Nk - k0, D, LD);
  load_rows_f32(Vo, static_cast<const float*>(a.v) + bz * a.vs.b + hy * a.vs.h + k0 * a.vs.n,
                a.vs.n, kRowsF, Nk - k0, D, LD);
  int jh[kPerWarp], jw[kPerWarp];
  float kb[kPerWarp];  // K6: the key's bias
  float dk[kPerWarp][DC], dv[kPerWarp][DC];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int key = min(k0 + warp * kPerWarp + i, Nk - 1);
    jh[i] = jw[i] = 0;
    kb[i] = 0.f;
    if constexpr (kRel)
      col_split(key, a.rel.inv_kw, a.rel.KW, jh[i], jw[i]);
    else if (a.kbias)
      kb[i] = a.kbias[bz * a.kbias_sb + key];
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < Nq; q0 += kTileF) {
    __syncthreads();
    load_rows_f32(Qs, qh + q0 * a.qs.n, a.qs.n, kTileF, Nq - q0, D, LD);
    load_rows_f32(dOs, doh + q0 * a.dos.n, a.dos.n, kTileF, Nq - q0, D, LD);
    __syncthreads();
    const int qi = q0 + lane;
    const bool valid = qi < Nq;
    const int qc = min(qi, Nq - 1);
    const float lse = a.lse[stat_off + qc];
    const float delta = a.delta[stat_off + qc];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const float* kr = Ko + (warp * kPerWarp + i) * LD;
      const float* vr = Vo + (warp * kPerWarp + i) * LD;
      const float* qr = Qs + lane * LD;
      const float* dor = dOs + lane * LD;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dor[d], vr[d], dp);
      }
      float bias = kb[i];
      if constexpr (kRel)
        bias = relh[qc * a.rel.h_sn + jh[i]] + relw[qc * a.rel.w_sn + jw[i]];
      const float p = valid ? expf(s * a.scale + bias - lse) : 0.f;
      const float ds0 = p * (dp - delta);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float xv = dv[i][c], xk = dk[i][c];
        for (int j = 0; j < kTileF; ++j) {
          xv = fmaf(__shfl_sync(0xffffffffu, p, j), dOs[j * LD + lane + 32 * c], xv);
          xk = fmaf(__shfl_sync(0xffffffffu, ds0, j), Qs[j * LD + lane + 32 * c], xk);
        }
        dv[i][c] = xv;
        dk[i][c] = xk;
      }
    }
  }

  const long long out_off = bz * a.dkvs.b + hy * a.dkvs.h;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = k0 + warp * kPerWarp + i;
    if (row >= Nk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = lane + 32 * c;
      if (col >= D) continue;
      static_cast<float*>(a.dk)[out_off + row * a.dkvs.n + col] = dk[i][c] * a.scale;
      static_cast<float*>(a.dv)[out_off + row * a.dkvs.n + col] = dv[i][c];
    }
  }
}

template <int DC, bool kRel>
__device__ __forceinline__ void flash_bwd_dq_f32(const FlashBwdArgs& a) {
  constexpr int LD = 32 * DC + 1;
  constexpr int kPerWarp = kRowsF / kWarps;
  const int Nq = a.Nq, Nk = a.Nk, D = a.D;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kRowsF][LD]
  float* dOs = Qs + kRowsF * LD;               // [kRowsF][LD]
  float* Ks = dOs + kRowsF * LD;               // [kTileF][LD]
  float* Vs = Ks + kTileF * LD;                // [kTileF][LD]
  float* ds_s = Vs + kTileF * LD;              // [kWarps][kPerWarp][kTileF]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRowsF;
  const int bz = blockIdx.z, hy = blockIdx.y;
  const float* kh = static_cast<const float*>(a.k) + bz * a.ks.b + hy * a.ks.h;
  const float* vh = static_cast<const float*>(a.v) + bz * a.vs.b + hy * a.vs.h;
  const long long stat_off = (static_cast<long long>(bz) * a.H + hy) * Nq;
  const float* kbias = !kRel && a.kbias ? a.kbias + bz * a.kbias_sb : nullptr;

  load_rows_f32(Qs, static_cast<const float*>(a.q) + bz * a.qs.b + hy * a.qs.h + q0 * a.qs.n,
                a.qs.n, kRowsF, Nq - q0, D, LD);
  load_rows_f32(dOs,
                static_cast<const float*>(a.dout) + bz * a.dos.b + hy * a.dos.h + q0 * a.dos.n,
                a.dos.n, kRowsF, Nq - q0, D, LD);
  float acc[kPerWarp][DC], lse[kPerWarp], delta[kPerWarp];
  RelRows rr[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = min(q0 + warp * kPerWarp + i, Nq - 1);
    lse[i] = a.lse[stat_off + row];
    delta[i] = a.delta[stat_off + row];
    if constexpr (kRel) rr[i] = a.rel.rows(bz, hy, row, Nq);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  float* ds_w = ds_s + warp * kPerWarp * kTileF;

  for (int key0 = 0; key0 < Nk; key0 += kTileF) {
    __syncthreads();
    load_rows_f32(Ks, kh + key0 * a.ks.n, a.ks.n, kTileF, Nk - key0, D, LD);
    load_rows_f32(Vs, vh + key0 * a.vs.n, a.vs.n, kTileF, Nk - key0, D, LD);
    __syncthreads();
    const int col = key0 + lane;
    int jh = 0, jw = 0;
    float kb = 0.f;  // K6: this lane's key bias
    if constexpr (kRel) {
      if (col < Nk) col_split(col, a.rel.inv_kw, a.rel.KW, jh, jw);
    } else {
      if (col < Nk && kbias) kb = kbias[col];
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const float* qr = Qs + (warp * kPerWarp + i) * LD;
      const float* dor = dOs + (warp * kPerWarp + i) * LD;
      const float* kr = Ks + lane * LD;
      const float* vr = Vs + lane * LD;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dor[d], vr[d], dp);
      }
      if constexpr (kRel) kb = rr[i].h[0][jh] + rr[i].w[0][jw];
      const float p = col < Nk ? expf(s * a.scale + kb - lse[i]) : 0.f;
      const float ds0 = p * (dp - delta[i]);
      if constexpr (kRel) ds_w[i * kTileF + lane] = ds0;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float x = acc[i][c];
        for (int j = 0; j < kTileF; ++j)
          x = fmaf(__shfl_sync(0xffffffffu, ds0, j), Ks[j * LD + lane + 32 * c], x);
        acc[i][c] = x;
      }
    }
    if constexpr (kRel) {
      __syncwarp();
      if (lane < 2 * kPerWarp) {  // lane i: row i's drel_h; lane kPerWarp + i: drel_w
        const int i = lane % kPerWarp;
        const int row = q0 + warp * kPerWarp + i;
        if (row < Nq) {
          float* h_row = a.drel.h_row(bz, hy, row);
          float* w_row = a.drel.w_row(bz, hy, row);
          const int cols = min(kTileF, Nk - key0);
          int run_jh = -1;
          float run = 0.f;
          for (int jj = 0; jj < cols; ++jj) {
            int kh_, kw_;
            col_split(key0 + jj, a.rel.inv_kw, a.rel.KW, kh_, kw_);
            const float x = ds_w[i * kTileF + jj];
            if (lane >= kPerWarp) {
              w_row[kw_] += x;
            } else {
              if (kh_ != run_jh) {
                if (run_jh >= 0) h_row[run_jh] += run;
                run_jh = kh_;
                run = 0.f;
              }
              run += x;
            }
          }
          if (lane < kPerWarp && run_jh >= 0) h_row[run_jh] += run;
        }
      }
      __syncwarp();
    }
  }

  float* dqh = static_cast<float*>(a.dq) + bz * a.dqs.b + hy * a.dqs.h;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = q0 + warp * kPerWarp + i;
    if (row >= Nq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (lane + 32 * c < D) dqh[row * a.dqs.n + lane + 32 * c] = acc[i][c] * a.scale;
  }
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_relpos_bwd_dkv_f32(FlashBwdArgs a) {
  flash_bwd_dkv_f32<DC, true>(a);
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_relpos_bwd_dq_f32(FlashBwdArgs a) {
  flash_bwd_dq_f32<DC, true>(a);
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_keybias_bwd_dkv_f32(FlashBwdArgs a) {
  flash_bwd_dkv_f32<DC, false>(a);
}

template <int DC>
__global__ void __launch_bounds__(32 * kWarps) flash_keybias_bwd_dq_f32(FlashBwdArgs a) {
  flash_bwd_dq_f32<DC, false>(a);
}


// ------------------------------------------------------------- launchers

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const FlashArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DC, bool kRel>
int launch_f32(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kRowsF + 2 * kTileF) * (32 * DC + 1);
  const dim3 grid((a.Nq + kRowsF - 1) / kRowsF, a.H, a.B);
  if constexpr (kRel) return launch(flash_relpos_fwd_f32<DC>, grid, smem, a, stream);
  return launch(flash_keybias_fwd_f32<DC>, grid, smem, a, stream);
}

// The forward of either entry point in fp32, by head dim (bf16 is
// flash_attention_fwd.cu: cudaErrorInvalidValue here).
template <bool kRel>
int launch_fwd(const FlashArgs& a, int is_bf16, cudaStream_t s) {
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  switch ((a.D + 31) / 32) {
    case 1: return launch_f32<1, kRel>(a, s);
    case 2: return launch_f32<2, kRel>(a, s);
    case 3: return launch_f32<3, kRel>(a, s);
    case 4: return launch_f32<4, kRel>(a, s);
    case 5: return launch_f32<5, kRel>(a, s);
    case 6: return launch_f32<6, kRel>(a, s);
    case 7: return launch_f32<7, kRel>(a, s);
    default: return launch_f32<8, kRel>(a, s);
  }
}

template <typename Kernel>
int launch_bwd(Kernel kernel, dim3 grid, size_t smem, const FlashBwdArgs& a,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DC, bool kRel>
int launch_bwd_f32(const FlashBwdArgs& a, cudaStream_t stream) {
  const dim3 dkv_grid((a.Nk + kRowsF - 1) / kRowsF, a.H, a.B);
  const dim3 dq_grid((a.Nq + kRowsF - 1) / kRowsF, a.H, a.B);
  const size_t dkv_smem = sizeof(float) * (2 * kRowsF + 2 * kTileF) * (32 * DC + 1);
  const size_t dq_smem = sizeof(float) * ((2 * kRowsF + 2 * kTileF) * (32 * DC + 1) +
                                          kRowsF * kTileF);
  int err;
  if constexpr (kRel)
    err = launch_bwd(flash_relpos_bwd_dkv_f32<DC>, dkv_grid, dkv_smem, a, stream);
  else
    err = launch_bwd(flash_keybias_bwd_dkv_f32<DC>, dkv_grid, dkv_smem, a, stream);
  if (err != 0) return err;
  if constexpr (kRel) return launch_bwd(flash_relpos_bwd_dq_f32<DC>, dq_grid, dq_smem, a, stream);
  return launch_bwd(flash_keybias_bwd_dq_f32<DC>, dq_grid, dq_smem, a, stream);
}

// The backward of either entry point in fp32, by head dim (bf16 is
// flash_relpos_bwd.cu and flash_keybias_bwd.cu: cudaErrorInvalidValue here).
template <bool kRel>
int launch_bwd_all(const FlashBwdArgs& a, int is_bf16, cudaStream_t s) {
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  switch ((a.D + 31) / 32) {
    case 1: return launch_bwd_f32<1, kRel>(a, s);
    case 2: return launch_bwd_f32<2, kRel>(a, s);
    case 3: return launch_bwd_f32<3, kRel>(a, s);
    case 4: return launch_bwd_f32<4, kRel>(a, s);
    case 5: return launch_bwd_f32<5, kRel>(a, s);
    case 6: return launch_bwd_f32<6, kRel>(a, s);
    case 7: return launch_bwd_f32<7, kRel>(a, s);
    default: return launch_bwd_f32<8, kRel>(a, s);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v and o are device pointers
// of the input dtype (is_bf16 = 0: float32; bf16 is flash_attention_fwd.cu
// and returns cudaErrorInvalidValue here); lse, rel_h and rel_w are fp32.
// Strides are in elements, (batch, head, row); the last axis of every
// tensor is contiguous. Returns a cudaError_t (0 = launched).
extern "C" int saicv_flash_attention_relpos_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, const float* rel_h,
    const float* rel_w, long long in_sb, long long in_sh, long long in_sn, long long out_sb,
    long long out_sh, long long out_sn, long long h_sb, long long h_sh, long long h_sn,
    long long w_sb, long long w_sh, long long w_sn, int B, int H, int N, int D, int KH, int KW,
    float scale, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > (1 << 20) || D < 1 ||
      D > 256 || KH < 1 || KW < 1 || static_cast<long long>(KH) * KW != N || !rel_h ||
      !rel_w || !lse)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides in{in_sb, in_sh, in_sn};
  FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.qs = a.ks = a.vs = in;
  a.os = Strides{out_sb, out_sh, out_sn};
  a.rel = RelPos{rel_h, rel_w, h_sb, h_sh, h_sn, w_sb, w_sh, w_sn, KH, KW, 1.f / KW};
  a.B = B;
  a.H = H;
  a.Nq = a.Nk = N;
  a.D = D;
  a.scale = scale;
  return launch_fwd<true>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

// Kernel K6: q [B, H, Nq, D], k and v [B, H, Nk, D] and o [B, H, Nq, D],
// each with its own (batch, head, row) strides in elements and the head dim
// contiguous, fp32 (is_bf16 = 0; bf16 is flash_attention_fwd.cu and
// returns cudaErrorInvalidValue here); bias: the fp32 key bias [B, Nk] with
// batch stride bias_sb and the keys contiguous, or null; lse: fp32 [B * H,
// Nq]. Returns a cudaError_t (0 = launched).
extern "C" int saicv_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, const float* bias,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long out_sb,
    long long out_sh, long long out_sn, long long bias_sb, int B, int H, int Nq, int Nk, int D,
    float scale, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Nq < 1 || Nq > (1 << 24) || Nk < 1 ||
      Nk > (1 << 24) || D < 1 || D > 256 || !lse)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.qs = Strides{q_sb, q_sh, q_sn};
  a.ks = Strides{k_sb, k_sh, k_sn};
  a.vs = Strides{v_sb, v_sh, v_sn};
  a.os = Strides{out_sb, out_sh, out_sn};
  a.kbias = bias;
  a.kbias_sb = bias_sb;
  a.B = B;
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.D = D;
  a.scale = scale;
  return launch_fwd<false>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

// Backward of the same function in fp32 (is_bf16 = 0; bf16 is
// flash_relpos_bwd.cu and returns cudaErrorInvalidValue here): dq, dk, dv
// (one stride set, head dim contiguous) and drel_h, drel_w (fp32, the
// shapes of rel_h and rel_w, their own strides; zero-filled by the caller)
// from q, k, v (one stride set), dout (its own strides), rel_h, rel_w, and
// the forward's log-sum-exp and delta = rowsum(dout * out), both fp32 [B *
// H, N]. Two launches on `stream`; returns a cudaError_t (0 = both
// launched).
extern "C" int saicv_flash_attention_relpos_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
    void* dv, const float* lse, const float* delta, const float* rel_h, const float* rel_w,
    float* drel_h, float* drel_w, long long in_sb, long long in_sh, long long in_sn,
    long long do_sb, long long do_sh, long long do_sn, long long out_sb, long long out_sh,
    long long out_sn, long long h_sb, long long h_sh, long long h_sn, long long w_sb,
    long long w_sh, long long w_sn, long long dh_sb, long long dh_sh, long long dh_sn,
    long long dw_sb, long long dw_sh, long long dw_sn, int B, int H, int N, int D, int KH,
    int KW, float scale, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > (1 << 20) || D < 1 ||
      D > 256 || KH < 1 || KW < 1 || static_cast<long long>(KH) * KW != N || !rel_h ||
      !rel_w || !drel_h || !drel_w || !lse || !delta)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides in{in_sb, in_sh, in_sn}, out{out_sb, out_sh, out_sn};
  FlashBwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = lse;
  a.delta = delta;
  a.qs = a.ks = a.vs = in;
  a.dos = Strides{do_sb, do_sh, do_sn};
  a.dqs = a.dkvs = out;
  a.rel = RelPos{rel_h, rel_w, h_sb, h_sh, h_sn, w_sb, w_sh, w_sn, KH, KW, 1.f / KW};
  a.drel = RelGrad{drel_h, drel_w, dh_sb, dh_sh, dh_sn, dw_sb, dw_sh, dw_sn};
  a.B = B;
  a.H = H;
  a.Nq = a.Nk = N;
  a.D = D;
  a.scale = scale;
  return launch_bwd_all<true>(a, is_bf16, static_cast<cudaStream_t>(stream));
}

// Backward of kernel K6 in fp32 (is_bf16 = 0; bf16 is flash_keybias_bwd.cu
// and returns cudaErrorInvalidValue here): dq [B, H, Nq, D] (strides dq_*),
// dk and dv [B, H, Nk, D] (one stride set, dkv_*), from q, k, v and dout
// (each with its own strides, head dim contiguous), the key bias of the
// forward ([B, Nk] fp32 with batch stride bias_sb, or null), the forward's
// log-sum-exp and delta = rowsum(dout * out), fp32 [B * H, Nq] each. The
// bias gets no gradient. Two launches on `stream`; returns a cudaError_t
// (0 = both launched).
extern "C" int saicv_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
    void* dv, const float* lse, const float* delta, const float* bias, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn, long long do_sb, long long do_sh,
    long long do_sn, long long dq_sb, long long dq_sh, long long dq_sn, long long dkv_sb,
    long long dkv_sh, long long dkv_sn, long long bias_sb, int B, int H, int Nq, int Nk,
    int D, float scale, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Nq < 1 || Nq > (1 << 24) || Nk < 1 ||
      Nk > (1 << 24) || D < 1 || D > 256 || !lse || !delta)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashBwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = lse;
  a.delta = delta;
  a.qs = Strides{q_sb, q_sh, q_sn};
  a.ks = Strides{k_sb, k_sh, k_sn};
  a.vs = Strides{v_sb, v_sh, v_sn};
  a.dos = Strides{do_sb, do_sh, do_sn};
  a.dqs = Strides{dq_sb, dq_sh, dq_sn};
  a.dkvs = Strides{dkv_sb, dkv_sh, dkv_sn};
  a.kbias = bias;
  a.kbias_sb = bias_sb;
  a.B = B;
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.D = D;
  a.scale = scale;
  return launch_bwd_all<false>(a, is_bf16, static_cast<cudaStream_t>(stream));
}
