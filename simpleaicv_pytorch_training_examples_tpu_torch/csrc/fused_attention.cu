// Short-sequence fused self-attention, forward and backward, for Hopper
// (sm_90a).
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
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the ViT-B/16
// eval shape (B=256, N=197, H=12, D=64, bf16) one launch reads 232 MB of qkv
// and writes 77 MB, 92 us of memory time, against 30.5 GFLOP = 31 us of
// tensor-core time: the kernel is bound by bytes. At the ViT-H/14 shape
// (B=256, H=16, N=257, D=80) it moves 4 x 256*16*257*80*2 B = 674 MB, 201 us,
// against 4*B*H*N^2*D = 86.6 GFLOP = 88 us: bound by bytes as well.
//
// bf16 design: one warp per 16 query rows, the head's row tiles split
// evenly over the fewest blocks of at most 8 warps (ViT-B/16: 13 tiles, two
// blocks of 7 warps), scores in registers (mma.sync m16n8k16, fp32
// accumulation). The block copies K and V of its head into shared memory
// once with cp.async (V landing while the first pass runs); a head too
// large for that streams 64-key tiles through a two-stage pipeline. Two
// passes over the keys: the first keeps each row's running max and sum
// (online softmax), the second recomputes the scores, forms P = exp(s - max)
// / sum, casts it to bf16 and multiplies it by V. P is thus normalised
// before its cast, as on the TPU, and the score matrix never leaves the
// registers. exp runs as one FFMA and one ex2.approx per score, with the
// scale and 1/sum folded in: P differs from the plain version's in the last
// fp32 bits, far below its bf16 rounding. The head dim is zero-padded to a
// multiple of 16 in shared memory and every tile masks its ragged edge
// (N = 197 and 257 are not multiples of 16; D = 80 is not a power of two).
//
// What bounds it now (diagnostic builds, H100): the copies from L2 and the
// Q.K^T products, which the second pass repeats; the softmax arithmetic and
// P.V cost little beside them. The B fragments of Q.K^T come from shared
// memory by ldmatrix.x4, two key groups at once: with two 4-byte loads per
// mma.sync instead, instruction issue held the kernel 13-19% slower.
//
// The rel-pos bias (K3, K4; a template parameter, so K1 and K2 are compiled
// without it): each score becomes a log2-domain logit s*scale*log2(e) +
// (rel_h + rel_w)*log2(e) as it leaves the tensor cores, with both terms
// read through the L1 cache (KW = 14 does not align with the 64-key
// tiles). At SAM-B's windows (B' = 200 windows of 196 tokens, H = 12, D =
// 64, bf16) a launch moves 294 MB (qkv, out and the fp32 rel terms), 88 us
// at 3.35 TB/s, against 23.6 GFLOP = 24 us: bound by bytes. The bias loads,
// two a score in each of the two passes, cost it about 1.7x K1's time for
// the same bytes (PERF.md).
//
// The full bias (K2b; a third value of the same template parameter) enters
// the same way: s*scale*log2(e) + bias*log2(e), one load a score in each
// pass, through L1. At SAM-B's windows with an fp32 bias [200, 12, 196,
// 196] a launch moves 241 MB of q, k, v and out and 369 MB of bias: 0.182
// ms at 3.35 TB/s, bound by bytes (23.6 GFLOP = 0.024 ms); the bias is read
// twice, once a pass, the second time mostly from L2.
//
// fp32 design (not on the main path): one block per 32 query rows keeps
// the whole fp32 score row in shared memory and uses plain FMA loops, so
// fp32 inputs keep full fp32 precision.

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

// ------------------------------------------------------------ bf16 path

constexpr int kMaxWarps = 8;   // one warp per 16 query rows, up to 8 a block
constexpr int kKeyTile = 64;   // keys per pipeline stage
// K and V of a whole head stay in shared memory when Q, K and V fit in this
// budget (ViT-B/16's and ViT-H/14's heads do); larger heads stream through
// the two-stage pipeline.
constexpr int kResidentBytes = 160000;

// What the scores gain: nothing (K1, K2), SAM's decomposed rel-pos bias (K3,
// K4) or a full bias (K2b). With either bias each score becomes the
// log2-domain logit s*scale*log2(e) + bias*log2(e) as soon as it leaves the
// tensor cores, and the softmax then runs with c = 1.
enum BiasMode { kNoBias, kRelBias, kFullBias };

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

// Raw scores q.k of one key tile (FR fragments of 8 keys from key0) ->
// log2-domain logits s*sc + bias*log2(e), the bias read at `rows`, the
// offsets of the lane's fragment rows g and g + 8; keys at or past N get
// -inf, keys at or past n_real `masked`.
template <int FR>
__device__ __forceinline__ void full_logits(float (&s)[FR][4], const FullBias& fb,
                                            const long long (&rows)[2], int key0, int t,
                                            int N, int n_real, float sc, float masked) {
#pragma unroll
  for (int j = 0; j < FR; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = key0 + 8 * j + 2 * t + half;
      if (col >= N) {
        s[j][half] = s[j][2 + half] = -INFINITY;
      } else if (col >= n_real) {
        s[j][half] = s[j][2 + half] = masked;
      } else {
        s[j][half] = fmaf(s[j][half], sc, fb.at(rows[0] + col) * kLog2e);
        s[j][2 + half] = fmaf(s[j][2 + half], sc, fb.at(rows[1] + col) * kLog2e);
      }
    }
}

// The full-bias row offsets of a lane's fragment rows `row` and row + 8;
// rows past N read row N - 1 (their scores are never stored).
__device__ __forceinline__ void full_bias_rows(long long (&rows)[2], const FullBias& fb, int b,
                                               int hd, int row, int N) {
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = fb.row(b, hd, min(row + 8 * i, N - 1));
}

template <int DP, int MODE>
__global__ void __launch_bounds__(32 * kMaxWarps)
attention_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   long long in_sb, long long in_sh, long long in_sn,
                   long long out_sb, long long out_sh, long long out_sn,
                   int N, int D, int n_real, float scale, int vec, int out_vec,
                   int resident, RelPos rel, FullBias bias) {
  constexpr bool REL = MODE == kRelBias;
  constexpr bool FULL = MODE == kFullBias;
  constexpr int LD = DP + 8;       // 16-byte pad: conflict-free fragment loads
  // exp(s*scale - max) = 2^(s*c - max*log2 e): one FFMA and one ex2 per score
  const float sc = scale * kLog2e;
  const float c = MODE != kNoBias ? 1.f : sc;
  // raw score that scales to -1e9 (with a bias: the logit itself)
  const float masked_raw = MODE != kNoBias ? kNegInf * kLog2e : kNegInf / sc;
  constexpr int kSteps = DP / 16;  // k-steps of Q.K^T
  constexpr int kOutTiles = DP / 8;
  constexpr int kKeyFrags = kKeyTile / 8;

  extern __shared__ __align__(128) unsigned char smem[];
  // Q [rows][LD]; K and V each [NP][LD] when resident, else
  // [2][kKeyTile][LD] (two pipeline stages)
  const int rows = 16 * (blockDim.x / 32);  // query rows of this block
  const int NP = (N + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + rows * LD;
  bf16* Vs = Ks + (resident ? NP : 2 * kKeyTile) * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and +8)
  const int t = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * rows;
  const long long in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const bf16* qh = q + in_off;
  const bf16* kh = k + in_off;
  const bf16* vh = v + in_off;
  bf16* oh = o + blockIdx.z * out_sb + blockIdx.y * out_sh;

  const int tiles = (N + kKeyTile - 1) / kKeyTile;
  const int steps = 2 * tiles;  // pass 1: K tiles; pass 2: K and V tiles
  auto issue = [&](int step) {
    const int tile = step < tiles ? step : step - tiles;
    const int buf = step & 1;
    const long long off = static_cast<long long>(tile) * kKeyTile * in_sn;
    load_tile_bf16<DP, LD>(Ks + buf * kKeyTile * LD, kh + off, in_sn, kKeyTile,
                           N - tile * kKeyTile, D, vec);
    if (step >= tiles)
      load_tile_bf16<DP, LD>(Vs + buf * kKeyTile * LD, vh + off, in_sn, kKeyTile,
                             N - tile * kKeyTile, D, vec);
  };

  load_tile_bf16<DP, LD>(Qs, qh + q0 * in_sn, in_sn, rows, N - q0, D, vec);
  if (resident) {  // two groups: Q and all of K, then all of V
    load_tile_bf16<DP, LD>(Ks, kh, in_sn, NP, N, D, vec);
    cp_async_commit();
    load_tile_bf16<DP, LD>(Vs, vh, in_sn, NP, N, D, vec);
  } else {
    issue(0);
  }
  cp_async_commit();

  const int row0 = q0 + 16 * warp;  // this warp's first query row
  const bool active = row0 < N;
  RelRows rr{};
  if (REL) rr = rel.rows(blockIdx.z, blockIdx.y, row0 + g, N);
  long long brows[2] = {0, 0};
  if (FULL) full_bias_rows(brows, bias, blockIdx.z, blockIdx.y, row0 + g, N);
  uint32_t qf[kSteps][4];
  // rows g and g+8: running max of s*c, then max + log2(sum); sum per lane
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kOutTiles][4];
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    if (!resident) {
      if (step + 1 < steps) issue(step + 1);
      cp_async_commit();  // one group per step, possibly empty
      cp_async_wait_one();
      __syncthreads();
    } else if (step == 0) {  // Q and K have landed
      cp_async_wait_one();
      __syncthreads();
    } else if (step == tiles) {  // V has landed
      cp_async_wait_all();
      __syncthreads();
    }

    if (step == 0 && active) load_a_frags<DP, LD>(qf, Qs + 16 * warp * LD, g, t);

    if (active) {
      const int tile = step < tiles ? step : step - tiles;
      const int key0 = tile * kKeyTile;
      const bf16* Kb = Ks + (resident ? key0 : (step & 1) * kKeyTile) * LD;
      float s[kKeyFrags][4];
      own_times_other_t<DP, LD, kKeyFrags>(s, qf, Kb, key0, N, lane);
      if (REL) {
        rel_logits(s, rr, key0, t, N, n_real, sc, masked_raw, rel.KW, rel.inv_kw);
      } else if (FULL) {
        full_logits(s, bias, brows, key0, t, N, n_real, sc, masked_raw);
      } else if (key0 + kKeyTile > n_real) {  // edge tile: mask padding and n_real
#pragma unroll
        for (int j = 0; j < kKeyFrags; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = key0 + 8 * j + 2 * t + (e & 1);
            s[j][e] = col >= N ? -INFINITY : (col >= n_real ? masked_raw : s[j][e]);
          }
      }

      if (step < tiles) {  // pass 1: online row max and sum
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < kKeyFrags; ++j)
            tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const float mnew = fmaxf(m[r], tmax * c);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kKeyFrags; ++j)
            if (key0 + 8 * j < N)
              sum += exp2_approx(fmaf(s[j][2 * r], c, -mnew)) +
                     exp2_approx(fmaf(s[j][2 * r + 1], c, -mnew));
          l[r] = l[r] * exp2_approx(m[r] - mnew) + sum;
          m[r] = mnew;
        }
        if (step == tiles - 1) {  // row sums over the quad; fold 1/sum into m
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            m[r] += __log2f(l[r]);
          }
        }
      } else {  // pass 2: P = 2^(s*c - max - log2 sum) in bf16, O += P.V
        const bf16* Vb = Vs + (resident ? key0 : (step & 1) * kKeyTile) * LD;
#pragma unroll
        for (int kk = 0; kk < kKeyTile / 16; ++kk) {
          if (key0 + 16 * kk >= N) break;
          const float* s0 = s[2 * kk];
          const float* s1 = s[2 * kk + 1];
          uint32_t a[4];
          a[0] = pack_bf16(exp2_approx(fmaf(s0[0], c, -m[0])), exp2_approx(fmaf(s0[1], c, -m[0])));
          a[1] = pack_bf16(exp2_approx(fmaf(s0[2], c, -m[1])), exp2_approx(fmaf(s0[3], c, -m[1])));
          a[2] = pack_bf16(exp2_approx(fmaf(s1[0], c, -m[0])), exp2_approx(fmaf(s1[1], c, -m[0])));
          a[3] = pack_bf16(exp2_approx(fmaf(s1[2], c, -m[1])), exp2_approx(fmaf(s1[3], c, -m[1])));
          accumulate_ax<DP, LD>(acc, a, Vb + 16 * kk * LD, lane);
        }
      }
    }
    if (!resident) __syncthreads();  // this step's buffers are free for step + 2
  }

  if (active) store_rows_bf16<DP>(oh, out_sn, acc, row0, N, D, g, t, out_vec);
}

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

// -------------------------------------------------------- bf16 backward
//
// Two kernels, both shaped like the forward (one warp owns 16 rows whose
// fragments stay in registers; the other operand's rows sit in shared
// memory), so that every output row has exactly one owner and no atomics
// are needed: the result is reproducible bit for bit.
//   attention_bwd_dq_bf16: a warp owns 16 query rows and walks the keys
//     twice: first the row max and sum (online, as the forward) and, in the
//     same walk, row = sum_k dP*P with the fp32 P (its numerator rescaled
//     with the sum when the max moves); then dS = P*(dP - row)*scale in bf16
//     and dQ += dS.K. It leaves each row's max + log2(sum) and `row` in a
//     small fp32 scratch.
//   attention_bwd_dkv_bf16: a warp owns 16 key rows and walks the queries
//     once: S^T = K.Q^T, P^T from the scratch, dP^T = V.dO^T, then
//     dV += bf16(P^T).dO and dK += bf16(dS^T).Q.
// Q.K^T and dO.V^T are thus computed three times each, nine products where
// five would be the least, and nothing but the inputs has to be saved by
// the forward. A head whose rows do not fit in shared memory is walked in
// chunks of whole 64-row tiles, loaded one after another.
//
// With the rel-pos bias (K3, K4; a template parameter of both kernels) the
// scores become the forward's log2-domain logits, and the dq kernel, which
// owns the query rows, also sums the fp32 dS0 = P * (dP - row) (unscaled)
// into drel_h[i, kh] and drel_w[i, kw]: each warp writes its 16 x 64 dS0
// tile to shared memory, then lane r adds row r's terms by key-grid row and
// lane r + 16 by key-grid column into the warp's own [16, KH + KW] sums, in
// key order (no atomics), written out at the end. The dK/dV kernel reads
// each query's rel_h and rel_w terms of its own keys through L1, two loads
// a score. At SAM-B's windows (B' = 200, N = 196, H = 12, D = 64, bf16) a
// backward moves qkv, dout, dqkv (7*B'*N*C*2 B = 422 MB) and the fp32 rel
// terms and their gradients (2*B'*N*H*28*4 B = 105 MB): 0.16 ms, bound by
// bytes (the five products are 59 GFLOP = 0.06 ms).
//
// With the full bias (K2b) the scores become logits the same way, and the
// dq kernel, which owns the query rows, writes each fp32 dS0 straight from
// its fragments to dbias [B, H, N, N]: one owner an element, no atomics;
// the wrapper sums it over the axes the bias was broadcast over. The dK/dV
// kernel reads bias[qi, key] through L1, one load a score. At SAM-B's
// windows with an fp32 bias a backward moves 422 MB of q, k, v, dout and
// their gradients, and reads 369 MB of bias and writes 369 MB of dbias:
// 0.346 ms, bound by bytes.
//
// Bound on one H100 SXM: at the ViT-B/16 shape (B=256, N=197, H=12, D=64,
// bf16) the backward reads qkv and dout and writes dqkv, 7*B*N*C*2 B =
// 542 MB, 162 us, against 10*B*H*N^2*D = 76 GFLOP = 77 us: bound by bytes.
// Measured there: 1.39 ms, 8.6 times the bound and twice the backward of
// PyTorch's fused attention. The kernels hold 166 (dq) and 236 (dk/dv)
// registers a thread at D = 64, so one block of 7 warps runs on an SM at a
// time: registers, not bytes, set their pace.

struct BwdArgs {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;  // [B, H, N] each
  long long in_sb, in_sh, in_sn, do_sb, do_sh, do_sn, out_sb, out_sh, out_sn;
  int B, H, N, D, n_real;
  float scale;
  int vec, do_vec, out_vec;
  cudaStream_t stream;
  RelPos rel;    // rel.h == nullptr: no rel-pos bias (K1, K2)
  RelGrad drel;  // K3, K4: written by the dq kernel
  FullBias bias;  // bias.p == nullptr: no full bias; K2b's dbias in bias.grad
};

// The dq kernel's rel-pos scratch (K3, K4), per warp: the fp32 dS0 of one
// 16 x 64 tile (row stride kDsLD) and the 16 rows' drel_h | drel_w sums
// (row stride rel_ld).
constexpr int kDsLD = kKeyTile + 1;
__host__ __device__ inline int rel_ld(int KH, int KW) { return (KH + KW) | 1; }

template <int DP, int MODE>
__global__ void __launch_bounds__(32 * kMaxWarps)
attention_bwd_dq_bf16(BwdArgs a, int chunk_rows) {
  constexpr bool REL = MODE == kRelBias;
  constexpr bool FULL = MODE == kFullBias;
  constexpr int LD = DP + 8;
  constexpr int kFrags = kKeyTile / 8;
  const int N = a.N, D = a.D, n_real = a.n_real;
  const float sc = a.scale * kLog2e;
  // with a bias the scores are log2-domain logits
  const float c = MODE != kNoBias ? 1.f : sc;
  const float masked_raw = MODE != kNoBias ? kNegInf * kLog2e : kNegInf / sc;

  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int rows = 16 * warps;
  const int NP = (N + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [rows][LD]
  bf16* dOs = Qs + rows * LD;                // [rows][LD]
  bf16* Ks = dOs + rows * LD;                // [chunk_rows][LD]
  bf16* Vs = Ks + chunk_rows * LD;           // [chunk_rows][LD]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = blockIdx.x * rows;
  const long long in_off = blockIdx.z * a.in_sb + blockIdx.y * a.in_sh;
  const bf16* qh = static_cast<const bf16*>(a.q) + in_off;
  const bf16* kh = static_cast<const bf16*>(a.k) + in_off;
  const bf16* vh = static_cast<const bf16*>(a.v) + in_off;
  const bf16* doh =
      static_cast<const bf16*>(a.dout) + blockIdx.z * a.do_sb + blockIdx.y * a.do_sh;
  bf16* dqh = static_cast<bf16*>(a.dq) + blockIdx.z * a.out_sb + blockIdx.y * a.out_sh;
  const long long stat_off = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * N;

  const bool single = chunk_rows >= N;  // the whole head stays in shared memory
  const int row0 = q0 + 16 * warp;
  const bool active = row0 < N;

  // REL: this warp's dS0 tile and drel sums (see kDsLD)
  const int KH = a.rel.KH, KW = a.rel.KW, RL = rel_ld(KH, KW);
  float* ds_w = reinterpret_cast<float*>(Vs + chunk_rows * LD) + warp * 16 * kDsLD;
  float* drel_s = reinterpret_cast<float*>(Vs + chunk_rows * LD) + warps * 16 * kDsLD +
                  warp * 16 * RL;
  RelRows rr{};
  if (REL) {
    rr = a.rel.rows(blockIdx.z, blockIdx.y, row0 + g, N);
    for (int i = lane; i < 16 * RL; i += 32) drel_s[i] = 0.f;
  }
  long long brows[2] = {0, 0};
  if (FULL) full_bias_rows(brows, a.bias, blockIdx.z, blockIdx.y, row0 + g, N);
  // FULL: dS0 of this head's rows in dbias, or nullptr
  float* dbias = FULL && a.bias.grad ? a.bias.grad + stat_off * N : nullptr;

  load_tile_bf16<DP, LD>(Qs, qh + q0 * a.in_sn, a.in_sn, rows, N - q0, D, a.vec);
  load_tile_bf16<DP, LD>(dOs, doh + q0 * a.do_sn, a.do_sn, rows, N - q0, D, a.do_vec);

  uint32_t qf[DP / 16][4], dof[DP / 16][4];
  float m[2] = {-INFINITY, -INFINITY};  // row max of s*c, then max + log2(sum)
  float l[2] = {0.f, 0.f};              // sum_k exp(s - max)
  float rowsum[2] = {0.f, 0.f};         // sum_k exp(s - max) * dP, then / l
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < N; c0 += chunk_rows) {
      if (pass == 0 || !single) {
        __syncthreads();  // the chunk before this one has been read
        const int crows = min(chunk_rows, NP - c0);
        load_tile_bf16<DP, LD>(Ks, kh + c0 * a.in_sn, a.in_sn, crows, N - c0, D, a.vec);
        load_tile_bf16<DP, LD>(Vs, vh + c0 * a.in_sn, a.in_sn, crows, N - c0, D, a.vec);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        if (pass == 0 && c0 == 0 && active) {
          load_a_frags<DP, LD>(qf, Qs + 16 * warp * LD, g, t);
          load_a_frags<DP, LD>(dof, dOs + 16 * warp * LD, g, t);
        }
      }
      if (!active) continue;
      const int c1 = min(c0 + chunk_rows, N);
      for (int key0 = c0; key0 < c1; key0 += kKeyTile) {
        const bf16* Kb = Ks + (key0 - c0) * LD;
        float s[kFrags][4], dp[kFrags][4];
        own_times_other_t<DP, LD, kFrags>(s, qf, Kb, key0, N, lane);
        own_times_other_t<DP, LD, kFrags>(dp, dof, Vs + (key0 - c0) * LD, key0, N, lane);
        if (REL) {
          rel_logits(s, rr, key0, t, N, n_real, sc, masked_raw, KW, a.rel.inv_kw);
        } else if (FULL) {
          full_logits(s, a.bias, brows, key0, t, N, n_real, sc, masked_raw);
        } else if (key0 + kKeyTile > n_real) {  // edge tile: mask padding and n_real
#pragma unroll
          for (int j = 0; j < kFrags; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = key0 + 8 * j + 2 * t + (e & 1);
              s[j][e] = col >= N ? -INFINITY : (col >= n_real ? masked_raw : s[j][e]);
            }
        }
        if (pass == 0) {
          // online over the key tiles: row max, sum_k e and sum_k e * dP with
          // e = exp(s - max), both rescaled when the max moves
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float tmax = -INFINITY;
#pragma unroll
            for (int j = 0; j < kFrags; ++j)
              tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
            const float mnew = fmaxf(m[r], tmax * c);
            float sum = 0.f, weighted = 0.f;
#pragma unroll
            for (int j = 0; j < kFrags; ++j)
              if (key0 + 8 * j < N) {
                const float e0 = exp2_approx(fmaf(s[j][2 * r], c, -mnew));
                const float e1 = exp2_approx(fmaf(s[j][2 * r + 1], c, -mnew));
                sum += e0 + e1;
                weighted += e0 * dp[j][2 * r] + e1 * dp[j][2 * r + 1];
              }
            const float rescale = exp2_approx(m[r] - mnew);
            l[r] = l[r] * rescale + sum;
            rowsum[r] = rowsum[r] * rescale + weighted;
            m[r] = mnew;
          }
          continue;
        }
        // pass 1: dS0 = P * (dP - row) (REL: kept in fp32 for drel; FULL:
        // written to dbias), dS = dS0 * scale in bf16, dQ += dS.K
#pragma unroll
        for (int j = 0; j < kFrags; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ds0 =
                exp2_approx(fmaf(s[j][e], c, -m[e >> 1])) * (dp[j][e] - rowsum[e >> 1]);
            if (REL) ds_w[(g + 8 * (e >> 1)) * kDsLD + 8 * j + 2 * t + (e & 1)] = ds0;
            if (FULL && dbias) {
              const int row = row0 + g + 8 * (e >> 1);
              const int col = key0 + 8 * j + 2 * t + (e & 1);
              if (row < N && col < N) dbias[static_cast<long long>(row) * N + col] = ds0;
            }
            s[j][e] = ds0 * a.scale;
          }
        if (REL) {
          // drel_h[i, kh] += sum of dS0[i, j] over the tile's keys with jh(j) =
          // kh, and drel_w likewise: lane r sums row r's rel_h terms, lane r +
          // 16 its rel_w terms, walking the keys in order (no atomics)
          __syncwarp();
          const int r = lane & 15;
          const float* dsr = ds_w + r * kDsLD;
          float* sums = drel_s + r * RL + (lane < 16 ? 0 : KH);
          const int cols = min(kKeyTile, N - key0);
          for (int jj = 0; jj < cols; ++jj) {
            int jh, jw;
            col_split(key0 + jj, a.rel.inv_kw, KW, jh, jw);
            sums[lane < 16 ? jh : jw] += dsr[jj];
          }
          __syncwarp();
        }
#pragma unroll
        for (int kk = 0; kk < kKeyTile / 16; ++kk) {
          if (key0 + 16 * kk >= N) break;
          const float* s0 = s[2 * kk];
          const float* s1 = s[2 * kk + 1];
          uint32_t af[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                            pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
          accumulate_ax<DP, LD>(acc, af, Kb + 16 * kk * LD, lane);
        }
      }
    }
    if (pass == 0) {  // sums over the quad; row = sum e*dP / sum e; fold log2(sum) into m
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 1);
        rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 2);
        rowsum[r] /= l[r];
        m[r] += __log2f(l[r]);
      }
    }
  }

  if (!active) return;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < N) {
        a.lse[stat_off + row] = m[r];
        a.delta[stat_off + row] = rowsum[r];
      }
    }
  }
  store_rows_bf16<DP>(dqh, a.out_sn, acc, row0, N, D, g, t, a.out_vec);
  if (REL) {
    for (int i = lane; i < 16 * (KH + KW); i += 32) {
      const int r = i / (KH + KW);
      const int k = i % (KH + KW);
      const int row = row0 + r;
      if (row >= N) continue;
      if (k < KH)
        a.drel.h_row(blockIdx.z, blockIdx.y, row)[k] = drel_s[r * RL + k];
      else
        a.drel.w_row(blockIdx.z, blockIdx.y, row)[k - KH] = drel_s[r * RL + k];
    }
  }
}

template <int DP, int MODE>
__global__ void __launch_bounds__(32 * kMaxWarps)
attention_bwd_dkv_bf16(BwdArgs a, int chunk_rows) {
  constexpr bool REL = MODE == kRelBias;
  constexpr bool FULL = MODE == kFullBias;
  constexpr int LD = DP + 8;
  constexpr int kQTileB = DP <= 64 ? 64 : 32;  // queries per step (registers)
  constexpr int kFrags = kQTileB / 8;
  const int N = a.N, D = a.D, n_real = a.n_real;
  const float sc = a.scale * kLog2e;

  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = 16 * (blockDim.x / 32);
  const int NP = (N + 15) & ~15;
  bf16* Ko = reinterpret_cast<bf16*>(smem);  // own keys [rows][LD]
  bf16* Vo = Ko + rows * LD;                 // own values [rows][LD]
  bf16* Qs = Vo + rows * LD;                 // [chunk_rows][LD]
  bf16* dOs = Qs + chunk_rows * LD;          // [chunk_rows][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + chunk_rows * LD);  // [chunk_rows]
  float* delta_s = lse_s + chunk_rows;                             // [chunk_rows]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k0 = blockIdx.x * rows;
  const long long in_off = blockIdx.z * a.in_sb + blockIdx.y * a.in_sh;
  const bf16* qh = static_cast<const bf16*>(a.q) + in_off;
  const bf16* kh = static_cast<const bf16*>(a.k) + in_off;
  const bf16* vh = static_cast<const bf16*>(a.v) + in_off;
  const bf16* doh =
      static_cast<const bf16*>(a.dout) + blockIdx.z * a.do_sb + blockIdx.y * a.do_sh;
  const long long out_off = blockIdx.z * a.out_sb + blockIdx.y * a.out_sh;
  const long long stat_off = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * N;

  const int row0 = k0 + 16 * warp;  // this warp's first key row
  const bool active = row0 < N;
  // REL: the rel_h and rel_w columns of this lane's two key rows, read at
  // each query's row of the two terms
  int key_jh[2] = {0, 0}, key_jw[2] = {0, 0};
  const float* relh = nullptr;
  const float* relw = nullptr;
  if (REL) {
    relh = a.rel.h + blockIdx.z * a.rel.h_sb + blockIdx.y * a.rel.h_sh;
    relw = a.rel.w + blockIdx.z * a.rel.w_sb + blockIdx.y * a.rel.w_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      col_split(min(row0 + g + 8 * r, N - 1), a.rel.inv_kw, a.rel.KW, key_jh[r], key_jw[r]);
  }
  // FULL: bias[qi, key] at bias_head + qi * bias.sn + key
  const long long bias_head = FULL ? a.bias.row(blockIdx.z, blockIdx.y, 0) : 0;

  load_tile_bf16<DP, LD>(Ko, kh + k0 * a.in_sn, a.in_sn, rows, N - k0, D, a.vec);
  load_tile_bf16<DP, LD>(Vo, vh + k0 * a.in_sn, a.in_sn, rows, N - k0, D, a.vec);

  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int c0 = 0; c0 < N; c0 += chunk_rows) {
    __syncthreads();  // the chunk before this one has been read
    const int crows = min(chunk_rows, NP - c0);
    load_tile_bf16<DP, LD>(Qs, qh + c0 * a.in_sn, a.in_sn, crows, N - c0, D, a.vec);
    load_tile_bf16<DP, LD>(dOs, doh + c0 * a.do_sn, a.do_sn, crows, N - c0, D, a.do_vec);
    for (int i = threadIdx.x; i < crows; i += blockDim.x) {
      const bool valid = c0 + i < N;
      lse_s[i] = valid ? a.lse[stat_off + c0 + i] : 0.f;
      delta_s[i] = valid ? a.delta[stat_off + c0 + i] : 0.f;
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (c0 == 0 && active) {
      load_a_frags<DP, LD>(kf, Ko + 16 * warp * LD, g, t);
      load_a_frags<DP, LD>(vf, Vo + 16 * warp * LD, g, t);
    }
    if (!active) continue;
    const int c1 = min(c0 + chunk_rows, N);
    for (int qt = c0; qt < c1; qt += kQTileB) {
      const bf16* Qb = Qs + (qt - c0) * LD;
      const bf16* dOb = dOs + (qt - c0) * LD;
      float st[kFrags][4], dpt[kFrags][4];  // S^T, dP^T: rows keys, columns queries
      own_times_other_t<DP, LD, kFrags>(st, kf, Qb, qt, N, lane);
      own_times_other_t<DP, LD, kFrags>(dpt, vf, dOb, qt, N, lane);
#pragma unroll
      for (int j = 0; j < kFrags; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qt + 8 * j + 2 * t + (e & 1);
          const int key = row0 + g + 8 * (e >> 1);
          // masked keys carry exp(-1e9 - max) = 0 in fp32, as on the TPU
          const bool valid = qi < N && key < n_real;
          const int ql = valid ? qi - c0 : 0;
          // the bias of (query qi, key) times log2(e): REL rel_h + rel_w, FULL
          // bias[qi, key]
          float bias = 0.f;
          if (REL && valid)
            bias = (__ldg(relh + qi * a.rel.h_sn + key_jh[e >> 1]) +
                    __ldg(relw + qi * a.rel.w_sn + key_jw[e >> 1])) * kLog2e;
          if (FULL && valid) bias = a.bias.at(bias_head + qi * a.bias.sn + key) * kLog2e;
          const float p = valid ? exp2_approx(fmaf(st[j][e], sc, bias - lse_s[ql])) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - delta_s[ql]) * a.scale;
        }
#pragma unroll
      for (int kk = 0; kk < kQTileB / 16; ++kk) {
        if (qt + 16 * kk >= N) break;
        const float* p0 = st[2 * kk];
        const float* p1 = st[2 * kk + 1];
        uint32_t pf[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                          pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
        accumulate_ax<DP, LD>(dv, pf, dOb + 16 * kk * LD, lane);
        const float* d0 = dpt[2 * kk];
        const float* d1 = dpt[2 * kk + 1];
        uint32_t df[4] = {pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                          pack_bf16(d1[0], d1[1]), pack_bf16(d1[2], d1[3])};
        accumulate_ax<DP, LD>(dk, df, Qb + 16 * kk * LD, lane);
      }
    }
  }

  if (!active) return;
  store_rows_bf16<DP>(static_cast<bf16*>(a.dk) + out_off, a.out_sn, dk, row0, N, D, g, t,
                      a.out_vec);
  store_rows_bf16<DP>(static_cast<bf16*>(a.dv) + out_off, a.out_sn, dv, row0, N, D, g, t,
                      a.out_vec);
}

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
  int vec, out_vec;
  cudaStream_t stream;
  RelPos rel;     // rel.h == nullptr: no rel-pos bias
  FullBias bias;  // bias.p == nullptr: no full bias
};

template <int DP>
int launch_bf16(const Args& a) {
  constexpr int LD = DP + 8;
  // the head's 16-row tiles split evenly over the fewest blocks of <= 8 warps
  const int row_tiles = (a.N + 15) / 16;
  const int blocks = (row_tiles + kMaxWarps - 1) / kMaxWarps;
  const int warps = (row_tiles + blocks - 1) / blocks;
  const int NP = 16 * row_tiles;
  const size_t resident_bytes = sizeof(bf16) * (16 * warps + 2 * NP) * LD;
  const int resident = resident_bytes <= kResidentBytes;
  const size_t smem =
      resident ? resident_bytes : sizeof(bf16) * (16 * warps + 4 * kKeyTile) * LD;
  auto kernel = a.rel.h    ? attention_fwd_bf16<DP, kRelBias>
                : a.bias.p ? attention_fwd_bf16<DP, kFullBias>
                           : attention_fwd_bf16<DP, kNoBias>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, a.H, a.B);
  kernel<<<grid, 32 * warps, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.in_sb, a.in_sh, a.in_sn,
      a.out_sb, a.out_sh, a.out_sn, a.N, a.D, a.n_real, a.scale, a.vec, a.out_vec,
      resident, a.rel, a.bias);
  return static_cast<int>(cudaGetLastError());
}

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

template <int DP>
int launch_dtype(const Args& a, int is_bf16) {
  return is_bf16 ? launch_bf16<DP>(a) : launch_f32<DP>(a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DP>
int launch_bwd_bf16(const BwdArgs& a) {
  constexpr int LD = DP + 8;
  const bool rel = a.rel.h != nullptr;
  // per warp: its own 16 rows of two operands and (K3, K4) the dq kernel's
  // rel-pos scratch; per row of the other operand (dK/dV kernel): two
  // operands and two fp32 statistics
  const size_t warp_bytes =
      sizeof(bf16) * 2 * 16 * LD +
      (rel ? sizeof(float) * 16 * (kDsLD + rel_ld(a.rel.KH, a.rel.KW)) : 0);
  const size_t row_bytes = sizeof(bf16) * 2 * LD + 2 * sizeof(float);
  // the head's 16-row tiles split evenly over the fewest blocks of <= 8
  // warps, fewer when the rel-pos scratch leaves no room for one key tile
  int max_warps = kMaxWarps;
  while (max_warps > 1 && max_warps * warp_bytes + kKeyTile * row_bytes > kResidentBytes)
    --max_warps;
  const int row_tiles = (a.N + 15) / 16;
  const int blocks = (row_tiles + max_warps - 1) / max_warps;
  const int warps = (row_tiles + blocks - 1) / blocks;
  const int NP = 16 * row_tiles;
  const size_t own_bytes = warps * warp_bytes;
  // the other operand's rows: the whole head if it fits, else whole 64-row tiles
  int chunk_rows = NP;
  if (own_bytes + NP * row_bytes > kResidentBytes)
    chunk_rows = static_cast<int>((kResidentBytes - own_bytes) / row_bytes) / kKeyTile * kKeyTile;
  const size_t smem = own_bytes + chunk_rows * row_bytes;
  const dim3 grid(blocks, a.H, a.B);
  auto dq_kernel = rel        ? attention_bwd_dq_bf16<DP, kRelBias>
                   : a.bias.p ? attention_bwd_dq_bf16<DP, kFullBias>
                              : attention_bwd_dq_bf16<DP, kNoBias>;
  auto dkv_kernel = rel        ? attention_bwd_dkv_bf16<DP, kRelBias>
                    : a.bias.p ? attention_bwd_dkv_bf16<DP, kFullBias>
                               : attention_bwd_dkv_bf16<DP, kNoBias>;
  cudaError_t err = allow_smem(dq_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(dkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<grid, 32 * warps, smem, a.stream>>>(a, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<grid, 32 * warps, smem, a.stream>>>(a, chunk_rows);
  return static_cast<int>(cudaGetLastError());
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

template <int DP>
int launch_bwd_dtype(const BwdArgs& a, int is_bf16) {
  return is_bf16 ? launch_bwd_bf16<DP>(a) : launch_bwd_f32<DP>(a);
}

Args forward_args(const void* q, const void* k, const void* v, void* o, long long in_sb,
                  long long in_sh, long long in_sn, long long out_sb, long long out_sh,
                  long long out_sn, int B, int H, int N, int D, int n_real, float scale,
                  int is_bf16, void* stream) {
  const long long es = is_bf16 ? 2 : 4;
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && (D * es) % 16 == 0 &&
                  (in_sb * es) % 16 == 0 && (in_sh * es) % 16 == 0 &&
                  (in_sn * es) % 16 == 0;
  const int out_vec = (reinterpret_cast<uintptr_t>(o) & 3u) == 0 && D % 2 == 0 &&
                      out_sb % 2 == 0 && out_sh % 2 == 0 && out_sn % 2 == 0;
  return Args{q,      k,     v,      o, in_sb, in_sh, in_sn,   out_sb, out_sh,
              out_sn, B,     H,      N, D,     n_real, scale, vec,    out_vec,
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
  const long long es = is_bf16 ? 2 : 4;
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && (D * es) % 16 == 0 &&
                  (in_sb * es) % 16 == 0 && (in_sh * es) % 16 == 0 &&
                  (in_sn * es) % 16 == 0;
  const int do_vec = aligned16(dout) && (D * es) % 16 == 0 && (do_sb * es) % 16 == 0 &&
                     (do_sh * es) % 16 == 0 && (do_sn * es) % 16 == 0;
  const auto even4 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3u) == 0; };
  const int out_vec = even4(dq) && even4(dk) && even4(dv) && D % 2 == 0 && out_sb % 2 == 0 &&
                      out_sh % 2 == 0 && out_sn % 2 == 0;
  float* lse = static_cast<float*>(stats);
  return BwdArgs{q,     k,     v,     dout,  dq,     dk,     dv,     lse,
                 lse + static_cast<long long>(B) * H * N,
                 in_sb, in_sh, in_sn, do_sb, do_sh,  do_sn,  out_sb, out_sh, out_sn,
                 B,     H,     N,     D,     n_real, scale,  vec,    do_vec, out_vec,
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
                                     B, H, N, D, n_real, scale, is_bf16, stream),
                        is_bf16);
}

// The same forward with SAM's decomposed rel-pos bias (K3, K4): the score of
// query i and key j gains rel_h[i, j / KW] + rel_w[i, j % KW], with N = KH *
// KW. rel_h and rel_w are fp32, each with its own (batch, head, row)
// strides and a contiguous last axis of KH or KW values.
extern "C" int saicv_fused_attention_relpos_fwd(
    const void* q, const void* k, const void* v, void* o, const float* rel_h,
    const float* rel_w, long long in_sb, long long in_sh, long long in_sn,
    long long out_sb, long long out_sh, long long out_sn, long long h_sb, long long h_sh,
    long long h_sn, long long w_sb, long long w_sh, long long w_sn, int B, int H, int N,
    int D, int n_real, int KH, int KW, float scale, int is_bf16, void* stream) {
  if (bad_shape(B, H, N, D, n_real) || KH < 1 || KW < 1 || KH * KW != N || !rel_h || !rel_w)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = forward_args(q, k, v, o, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, B, H, N, D,
                        n_real, scale, is_bf16, stream);
  a.rel = RelPos{rel_h, rel_w, h_sb, h_sh, h_sn, w_sb, w_sh, w_sn, KH, KW, 1.f / KW};
  return launch_forward(a, is_bf16);
}

// The same forward with a full additive score bias (K2b): the score of
// query i and key j of (batch b, head h) gains bias[b * b_sb + h * b_sh + i *
// b_sn + j], fp32 (bias_bf16 = 0) or bf16 (1); a stride is 0 on an axis the
// bias is broadcast over.
extern "C" int saicv_fused_attention_bias_fwd(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    long long in_sb, long long in_sh, long long in_sn,
    long long out_sb, long long out_sh, long long out_sn,
    long long b_sb, long long b_sh, long long b_sn,
    int B, int H, int N, int D, int n_real, float scale, int is_bf16, int bias_bf16,
    void* stream) {
  if (bad_shape(B, H, N, D, n_real) || !bias) return static_cast<int>(cudaErrorInvalidValue);
  Args a = forward_args(q, k, v, o, in_sb, in_sh, in_sn, out_sb, out_sh, out_sn, B, H, N, D,
                        n_real, scale, is_bf16, stream);
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
