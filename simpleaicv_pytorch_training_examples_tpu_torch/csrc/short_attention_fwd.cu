// Forward of the short-sequence attention kernels in bf16, for Hopper
// (sm_90a): wgmma products on TMA-fed tiles, any bias staged once.
//
// Replaces, for bf16 inputs, the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_attention.py:
//   K1  _fwd_kernel_pairs (via _pallas_fwd_pairs, entry
//       fused_attention_dense): q, k, v read in place from the packed qkv
//       [B, N, 3C], an optional sm_scale;
//   K2  _fwd_kernel (via _pallas_fwd, entry fused_attention): q, k, v [B,
//       H, N, D] through their strides (views of a packed qkv included);
//   K9  _fwd_kernel_packed (via _pallas_fwd_packed, entry
//       fused_attention_qkv): q, k, v read in place from a packed [B, N, 3,
//       H, D];
//   K2b _fwd_kernel_bias (via _pallas_fwd_bias, entry fused_attention(bias=)):
//       a full additive score bias, score(i, j) += bias[b, h, i, j], fp32 or
//       bf16, read through its own strides (0 on an axis it is broadcast
//       over);
//   K3  _fwd_kernel_relwin_pairs (via _pallas_fwd_relwin_pairs, entry
//       fused_attention_relwin_dense) and K4 _fwd_kernel_relwin (via
//       _relwin_fwd_factory, entry fused_attention_relwin): SAM's decomposed
//       rel-pos bias, score(i, j) += rel_h[i, j / KW] + rel_w[i, j % KW]
//       (fp32, N = KH * KW, each term through its own strides).
// The bias is a template value of the one kernel (kNoBias for K1, K2 and
// K9). q, k and v are read in place through 4-D tensor maps {D, N, H, B},
// each with its own strides; the output is written through its own. fp32
// inputs keep fused_attention.cu's FMA forward. The backward
// (short_attention_bwd.cu, every mode) reads neither this kernel's output
// nor any statistics of it: it recomputes P.
// K8's attention core (attn_block.cu) is this kernel's kNoBias mode too.
//
// Math, as the TPU kernels: s = q.k^T * scale in fp32, plus the bias in
// fp32; keys at or past n_real get -1e9, padding -inf; softmax over the
// whole row in fp32; P normalised, then cast to bf16; P.V accumulated in
// fp32 and written in bf16. Each score becomes the log2-domain logit
// s*scale*log2(e) + bias*log2(e) as it leaves the tensor cores; the row's
// sum of 2^(logit - max) is folded into the max, and P = 2^(logit - max -
// log2(sum)) (two ex2.approx a score), as the backward kernels recompute
// it: P differs from the plain version's in the last fp32 bits, far below
// its bf16 rounding.
// N <= 1024, D <= 128.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at ViT-B/16
// (B = 256, N = 197, H = 12, D = 64) a launch reads q, k, v and writes the
// output, 310 MB: 0.092 ms, against 30.5 GFLOP = 0.031 ms of products; at
// ViT-H/14 (B = 256, H = 16, N = 257, D = 80) 674 MB, 0.201 ms, against
// 86.6 GFLOP = 0.088 ms. At SAM-B's windows (B' = 200 windows of N = 196
// tokens, H = 12, D = 64) a launch moves 241 MB, and K2b reads an fp32 bias
// [200, 12, 196, 196] of 369 MB: 0.182 ms, against 23.6 GFLOP = 0.024 ms of
// products; K3's rel terms are 53 MB (0.088 ms). SAM-H's K4 (H = 16, D =
// 80) moves 472 MB: 0.141 ms against 39 GFLOP = 0.040 ms. Every case is
// bound by bytes, the bias first where there is one.
//
// Design.
//   - A block is one warpgroup (128 threads) that owns 64 query rows of one
//     (batch, head). At its start one thread issues the TMA copies of its Q
//     tile and of the head's whole K and V (each in one box of N rows
//     rounded up to 16, two boxes past 256 rows) and the bias: where the
//     tile's bias rows lie back to back (a dense [B, H, N, N] bias; K4's
//     [B, H, N, K] rel terms) one bulk copy of each term (K2b: 64 x N, fp32
//     50 KB or bf16 25 KB at N = 196; K4: 64 x (KH + KW) fp32, 7 KB), else
//     the 128 threads copy the rows with cp.async (K3's [B, N, H, K] terms,
//     broadcast or unaligned biases). The block then runs S = Q.K^T while
//     the bias is in flight. Every byte the block needs is requested at
//     once, and two or three blocks share an SM (all of its 228 KB as shared
//     memory: 110 KB a block at K2b's fp32 case, 70 KB at K3's, 85 KB at
//     K4's, 62 KB without a bias at ViT-B; 168 registers a thread at N =
//     196, D = 64), so one block's copies are in flight while another
//     computes: a block walks one tile, so it needs no producer warp or
//     ring.
//   - The row tiles of a head are adjacent in launch order (blockIdx.x), so
//     the head's K and V come from device memory once and from L2 for the
//     head's other blocks (196 rows: four blocks; 132 SMs hold 66 heads'
//     worth at a time, a few MB against L2's 50 MB).
//   - S = Q.K^T runs as wgmma m64nNk16, Q and K K-major from shared memory,
//     64 keys a chunk; the last chunk only as wide as the keys rounded up to
//     8 (at N = 196 and 197 an n = 8 product, and the accumulators of 200
//     keys, not 256, as a template value; at N = 257 (ViT-H/14) four chunks
//     and an n = 8 one, 132 accumulators). Where N <= 264 (every main-path
//     case) the whole score row stays in the accumulators: one pass takes
//     the logits, the row max, the sum of 2^(logit - max), the 1/sum fold, P
//     and its bf16 cast, so Q.K^T is computed once and the bias read once.
//     P.V then runs as a register-A wgmma (P's accumulator layout is the A
//     operand's), V read MN-major, so nothing is transposed.
//   - Where 264 < N <= 1024 the keys go in groups of 256 in two passes, the
//     row statistics, then the output, each group's K, V and bias staged as
//     above (the same code with the group count above 1).
//   - Head dims: the k-steps run over D rounded up to 16 (D = 35: 48), the
//     tensor maps filling the columns past D with zeros. Columns 0-63 lie in
//     boxes of 64 columns (128-byte rows, 128-byte swizzle). D = 80's
//     160-byte rows do not fill two such boxes, so columns 64-79 go in a box
//     of 16 columns (32-byte rows, 32-byte swizzle, one k-step, an n = 16
//     P.V); past 80 the second box has 64 columns.
//   - 196 rows leave a 4-row tail in 64-row tiles, and N = 196 computes 200
//     keys: 23% of the products are wasted. The rows are bound by bytes (at
//     K4's case the products take ~40 us, ~52 us with the tail, against a
//     141 us bound), so the tail is cheaper than a second tile shape.
//   - The rel-pos bias is added as each score leaves the accumulator: (j /
//     KW, j % KW) of each key column from a per-launch table in shared
//     memory, rel_h and rel_w from the staged rows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"
#include "short_attention.cuh"

namespace saicv {
namespace short_attn {
namespace fwd {

// Byte offsets in a block's dynamic shared memory (1024-byte aligned): Q, K
// and V in boxes of 64 columns, their column tails (columns 64..), the
// staged bias (K2b) or rel_h and rel_w rows and the key-column table
// (K3/K4), three mbarriers.
struct Smem {
  int q, k, v, qt, kt, vt, terms, tab, bars, bytes;
};

struct FwdParams {
  CUtensorMap q_map, k_map, v_map;     // boxes of 64 columns, 128-byte swizzle
  CUtensorMap q_tail, k_tail, v_tail;  // D in (64, 80]: boxes of 16 columns, 32-byte swizzle
  bf16* o;
  long long o_sb, o_sh, o_sn;
  const void* bias;                    // K2b
  long long b_sb, b_sh, b_sn;          // elements; 0 on a broadcast axis
  int bias_bf16;
  int bias_unit;                       // bytes a copy: 16, 8, 4 (cp.async) or 2 (loads)
  int bias_bulk;                       // the tile's rows as one bulk copy (bias_ld = N)
  int bias_rows;                       // rows staged: 64, or 1 when broadcast over rows
  int bias_ld;                         // elements between staged rows
  const float* rel_h;                  // K3/K4
  const float* rel_w;
  long long h_sb, h_sh, h_sn, w_sb, w_sh, w_sn;
  int KH, KW;
  int rel_bulk;                        // each term's rows as one bulk copy
  int rel_unit;                        // else bytes a cp.async: 16, 8 or 4
  int N, D, n_real;
  int groups;                          // groups of kGroupKeys keys (1: one pass)
  int key_rows;                        // rows of K or V staged
  int key_box;                         // rows of a K or V box (key_rows in one or two)
  int out_vec;                         // bf16 pairs of the output stored as 32-bit words
  float scale;
  Smem sm;
};

// The first byte of the bias at (b, hd, row, key0).
__device__ __forceinline__ const char* bias_at(const FwdParams& p, int b, int hd, int row,
                                               int key0) {
  return static_cast<const char*>(p.bias) +
         (b * p.b_sb + hd * p.b_sh + row * p.b_sn + static_cast<long long>(key0)) *
             (p.bias_bf16 ? 2 : 4);
}

// K2b with rows that lie back to back (bias_bulk): thread 0 copies the
// block's rows q0.. below N, one contiguous block, in one bulk copy that
// completes on `bar` (rows past N stay unset: their scores are never
// stored).
__device__ __forceinline__ void bulk_bias(const FwdParams& p, unsigned char* dst, uint64_t* bar,
                                          int b, int hd, int q0) {
  const uint32_t bytes = min(kRows, p.N - q0) * p.N * (p.bias_bf16 ? 2 : 4);
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, bias_at(p, b, hd, q0, 0), bytes, bar);
}

// K2b otherwise: the block's bias rows q0.. (one row when broadcast over
// rows), columns key0.. up to N or the group's end, at bias_ld elements a
// row, a warp a row; rows at or past N are zeros.
__device__ __forceinline__ void stage_bias(const FwdParams& p, unsigned char* dst, int b, int hd,
                                           int q0, int key0) {
  const int es = p.bias_bf16 ? 2 : 4;
  const int row_bytes = (p.groups == 1 ? p.N : min(p.N - key0, kGroupKeys)) * es;
  const int unit = p.bias_unit;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < p.bias_rows; r += kThreads / 32) {
    const bool in = q0 + r < p.N;
    const char* src = bias_at(p, b, hd, in ? q0 + r : 0, key0);
    unsigned char* out = dst + r * p.bias_ld * es;
    if (unit >= 4) {
      for (int c = lane * unit; c < row_bytes; c += 32 * unit)
        cp_async_part(out + c, in ? src + c : src, unit, in ? min(unit, row_bytes - c) : 0);
    } else {  // bf16 rows off a 4-byte boundary: element by element
      for (int c = lane; c < row_bytes / 2; c += 32)
        reinterpret_cast<bf16*>(out)[c] =
            in ? reinterpret_cast<const bf16*>(src)[c] : __float2bfloat16_rn(0.f);
    }
  }
}

// o (64 x 64, columns 0-63) and ot (64 x kTail, columns 64..) += P . V, P
// the bf16 rounding of s (already normalised), `steps` 16-key steps of the
// staged group (all of them where the last chunk is 8 keys), V MN-major.
// A chunk of keys a commit group: the next chunk's fragments are packed
// while it runs, and at most two chunks' fragments are live (each kept
// live, by settle, until the wait that ends its products). Returns when
// every product is done.
template <int KC, int kLast, int kTail>
__device__ __forceinline__ void times_v(float (&o)[32], float (&ot)[kTail == 0 ? 1 : kTail / 2],
                                        const float (&s)[KC][32], uint32_t v, uint32_t vt,
                                        int steps) {
  uint32_t a[KC][4][4];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * jj + 2 * r;  // registers i, i + 1 of chunk c
        a[c][jj][r] = i < regs_of<KC, kLast>(c) ? pack_bf16(s[c][i], s[c][i + 1]) : 0u;
      }
      settle(a[c][jj]);
    }
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * c + jj;  // 16-key step of the group
      if (8 * jj < regs_of<KC, kLast>(c) && (kLast == 8 || j < steps)) {
        wgmma_rs<64>(o, a[c][jj], sw128_desc(v + 16 * 128 * j, 16), 1);
        if constexpr (kTail == 16)
          wgmma_rs<16>(ot, a[c][jj], sw32_desc(vt + 16 * 32 * j), 1);
        else if constexpr (kTail == 64)
          wgmma_rs<64>(ot, a[c][jj], sw128_desc(vt + 16 * 128 * j, 16), 1);
      }
    }
    wg_commit();
    if (c > 0) {  // chunk c - 1's products are done
      wg_wait_one();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) settle(a[c - 1][jj]);
    }
  }
  wg_wait_all();
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) settle(a[KC - 1][jj]);
  fence_regs(o);
  fence_regs(ot);
}

// Raw scores of the staged group (keys key0..) -> log2-domain logits
// s*sc + bias*log2(e); keys at or past n_real `masked`, at or past N -inf.
template <int KC, int kLast, int MODE>
__device__ __forceinline__ void logits(float (&s)[KC][32], const FwdParams& p,
                                       const unsigned char* sm, int key0, int warp, int g,
                                       int t, float sc, float masked) {
  if constexpr (MODE == kNoBias) {
    plain_logits<KC, kLast>(s, key0, t, p.N, p.n_real, sc, masked);
    return;
  }
  const int rl0 = 16 * warp + g;  // local rows rl0 and rl0 + 8
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int j = 0; j < regs_of<KC, kLast>(c) / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = rl0 + 8 * h;
        const int cg = 64 * c + 8 * j + 2 * t;  // column in the group (and + 1)
        const int col = key0 + cg;
        float b0, b1;
        if constexpr (MODE == kFullBias) {
          const int at = (p.bias_rows == 1 ? 0 : rl * p.bias_ld) + cg;
          if (p.bias_bf16) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sm + p.sm.terms + 2 * at));
            b0 = x.x;
            b1 = x.y;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(sm + p.sm.terms + 4 * at);
            b0 = x.x;
            b1 = x.y;
          }
        } else {
          const float* terms = reinterpret_cast<const float*>(sm + p.sm.terms);
          rel_pair(terms + rl * p.KH, terms + kRows * p.KH + rl * p.KW,
                   reinterpret_cast<const int*>(sm + p.sm.tab), p.N, col, b0, b1);
        }
        float* e = &s[c][4 * j + 2 * h];
        e[0] = biased_logit(e[0], b0, col, p.n_real, p.N, sc, masked);
        e[1] = biased_logit(e[1], b1, col + 1, p.n_real, p.N, sc, masked);
      }
}

// Block (row tile, head, batch): 64 query rows. KC: 64-key chunks of a
// pass (4 when the keys go in groups, 5 for 257..264 keys); kLast: keys of
// the last chunk (8, or 64 with the width decided at run time); kTail: the
// columns past 64 (0, 16 or 64). Two blocks an SM: with the wgmma pipeline
// not serialized, N = 196 at D = 64 needs more than the 168 registers of
// three (it spilled there, and ran 30% slower than at two).
template <int KC, int kLast, int kTail, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    short_attention_fwd(const __grid_constant__ FwdParams p) {
  unsigned char* sm = aligned_smem();
  const int hd = blockIdx.y, b = blockIdx.z;
  const int q0 = kRows * blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  uint64_t* bar_k = reinterpret_cast<uint64_t*>(sm + p.sm.bars);  // Q and K
  uint64_t* bar_v = bar_k + 1;
  uint64_t* bar_b = bar_k + 2;  // the bulk bias copy
  constexpr int kTailBytes = kTail == 16 ? 32 : kTail == 64 ? 128 : 0;  // a tail box row
  const uint32_t base = smem_addr(sm);
  const uint32_t qa = base + p.sm.q, ka = base + p.sm.k, va = base + p.sm.v;
  const uint32_t qta = base + p.sm.qt, kta = base + p.sm.kt, vta = base + p.sm.vt;

  if (tid == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_init(bar_b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: the key group's K (and the first time Q) on bar_k, its V on
  // bar_v when `with_v`
  auto issue = [&](int key0, bool with_q, bool with_v) {
    const uint32_t kv_bytes = p.key_rows * (128 + kTailBytes);
    mbar_expect_tx(bar_k, kv_bytes + (with_q ? kRows * (128 + kTailBytes) : 0));
    if (with_q) {
      tma_box(sm + p.sm.q, &p.q_map, bar_k, 0, q0, hd, b);
      if (kTail) tma_box(sm + p.sm.qt, kTail == 16 ? &p.q_tail : &p.q_map, bar_k, 64, q0, hd, b);
    }
    // one box of the staged rows, or two past 256 rows
    auto rows = [&](int at, int at_t, const CUtensorMap* map, const CUtensorMap* tail,
                    uint64_t* bar) {
      for (int r = 0; r < p.key_rows; r += p.key_box) {
        tma_box(sm + at + r * 128, map, bar, 0, key0 + r, hd, b);
        if (kTail) tma_box(sm + at_t + r * kTailBytes, kTail == 16 ? tail : map, bar, 64, key0 + r, hd, b);
      }
    };
    rows(p.sm.k, p.sm.kt, &p.k_map, &p.k_tail, bar_k);
    if (with_v) {
      mbar_expect_tx(bar_v, kv_bytes);
      rows(p.sm.v, p.sm.vt, &p.v_map, &p.v_tail, bar_v);
    }
  };

  const float sc = p.scale * kLog2e;
  const float masked = kNegInf * kLog2e;
  const int groups = p.groups;
  // keys of the last chunk (one pass: N rounded up to 8) and 16-key steps
  // of P.V a group
  const int width = groups == 1 ? ((p.N + 7) & ~7) - 64 * (KC - 1) : 64;
  const int pv_steps = groups == 1 ? (p.N + 15) / 16 : kGroupKeys / 16;

  float s[KC][32];
  float o[32], ot[kTail == 0 ? 1 : kTail / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < tail_regs<kTail>(); ++i) ot[i] = 0.f;
  fence_regs(o);
  fence_regs(ot);
  // running row max and sum of the statistics pass (two passes only)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int k_phase = 0, v_phase = 0;

  if constexpr (MODE == kRelBias) {
    float* rh = reinterpret_cast<float*>(sm + p.sm.terms);
    stage_rel(p, rh, rh + kRows * p.KH, reinterpret_cast<int*>(sm + p.sm.tab), bar_b, b, hd,
              q0);
  }

  // one pass (groups == 1), or the statistics pass and the output pass
  for (int pass = groups == 1 ? 1 : 0; pass < 2; ++pass) {
    for (int gi = 0; gi < groups; ++gi) {
      const int key0 = gi * kGroupKeys;
      const bool first = gi == 0 && (pass == 0 || groups == 1);
      if (!first) __syncthreads();  // every thread is done with the last group's buffers
      if (tid == 0) issue(key0, first, pass == 1);
      if constexpr (MODE == kFullBias) {
        if (!p.bias_bulk)
          stage_bias(p, sm + p.sm.terms, b, hd, q0, key0);
        else if (tid == 0)  // one group: copied once
          bulk_bias(p, sm + p.sm.terms, bar_b, b, hd, q0);
      }
      cp_async_commit();

      mbar_wait(bar_k, k_phase);
      k_phase ^= 1;
      scores<KC, kLast, kTail>(s, qa, qta, ka, kta, width);
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < KC; ++c) fence_regs(s[c]);
      if constexpr (MODE != kNoBias) {
        if (first && (MODE == kFullBias ? p.bias_bulk : p.rel_bulk))
          mbar_wait(bar_b, 0);  // the bulk or TMA copy of the bias
        cp_async_wait_all();
        __syncthreads();  // the staged bias (and table) of every thread
      }
      logits<KC, kLast, MODE>(s, p, sm, key0, warp, g, t, sc, masked);

      float mx[2], sum[2];
      if (pass == 0) {  // online row max and sum
        row_max<KC, kLast>(s, mx);
#pragma unroll
        for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], m[h]);
        exp2_rows<KC, kLast>(s, mx, sum);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] = l[h] * exp2_approx(m[h] - mx[h]) + quad_sum(sum[h]);
          m[h] = mx[h];
        }
        continue;
      }
      if (groups == 1) {
        // the whole row is here: its max and sum, 1/sum folded into the
        // max, then P = 2^(logit - max - log2(sum)), as the backward kernels
        // recompute it
        row_max<KC, kLast>(s, mx);
        sum[0] = sum[1] = 0.f;
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int i = 0; i < regs_of<KC, kLast>(c); ++i)
            sum[(i >> 1) & 1] += exp2_approx(s[c][i] - mx[(i >> 1) & 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) m[h] = mx[h] + __log2f(quad_sum(sum[h]));
      }
      exp2_rows<KC, kLast>(s, m, sum);  // P = 2^(logit - max - log2(sum))
      mbar_wait(bar_v, v_phase);
      v_phase ^= 1;
      times_v<KC, kLast, kTail>(o, ot, s, va, vta, pv_steps);
    }
    if (pass == 0) {  // fold 1/sum into the max
#pragma unroll
      for (int h = 0; h < 2; ++h) m[h] += __log2f(l[h]);
    }
  }

  bf16* oh = p.o + b * p.o_sb + hd * p.o_sh;
  const int row0 = q0 + 16 * warp + g;
  store_bf16<64>(oh, p.o_sn, o, 1.f, row0, p.N, 0, p.D, t, p.out_vec);
  if constexpr (kTail > 0) store_bf16<kTail>(oh, p.o_sn, ot, 1.f, row0, p.N, 64, p.D, t, p.out_vec);
}

// ------------------------------------------------------------- host side

Smem layout(int kTail, int mode, const FwdParams& p) {
  const int tail = kTail == 16 ? 32 : kTail == 64 ? 128 : 0;
  Smem s;
  s.q = 0;
  s.k = s.q + kRows * 128;
  s.v = s.k + p.key_rows * 128;
  s.qt = s.v + p.key_rows * 128;
  s.kt = s.qt + kRows * tail;
  s.vt = s.kt + p.key_rows * tail;
  s.terms = s.vt + p.key_rows * tail;
  const int terms = mode == kFullBias ? p.bias_rows * p.bias_ld * (p.bias_bf16 ? 2 : 4)
                    : mode == kRelBias ? kRows * (p.KH + p.KW) * 4
                                       : 0;
  s.tab = s.terms + (terms + 15) / 16 * 16;
  s.bars = s.tab + (mode == kRelBias ? (p.N * 4 + 15) / 16 * 16 : 0);
  s.bytes = s.bars + 24;
  return s;
}

template <int KC, int kLast, int kTail, int MODE>
int launch(FwdParams& p, int B, int H, cudaStream_t stream) {
  p.sm = layout(kTail, MODE, p);
  const int smem = p.sm.bytes + 1024;  // room to align the base to 1024 bytes
  auto kernel = short_attention_fwd<KC, kLast, kTail, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // all of the SM's 228 KB as shared memory, so that two or three blocks
  // fit beside each other
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.N + kRows - 1) / kRows, H, B), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kTail, int MODE>
int launch_chunks(FwdParams& p, int B, int H, cudaStream_t stream) {
  const int chunks = p.groups > 1 ? 4 : (p.N + 63) / 64;
  // SAM's 14 x 14 windows, ViT-B/16's 197 tokens
  if (p.groups == 1 && chunks == 4 && (p.N + 7) / 8 * 8 == 200)
    return launch<4, 8, kTail, MODE>(p, B, H, stream);
  if (p.groups == 1 && chunks == 5)  // 257..264 keys: ViT-H/14's 257 tokens
    return launch<5, 8, kTail, MODE>(p, B, H, stream);
  switch (chunks) {
    case 1: return launch<1, 64, kTail, MODE>(p, B, H, stream);
    case 2: return launch<2, 64, kTail, MODE>(p, B, H, stream);
    case 3: return launch<3, 64, kTail, MODE>(p, B, H, stream);
    default: return launch<4, 64, kTail, MODE>(p, B, H, stream);
  }
}

// Shapes, tensor maps and the rest of the launch's parameters; returns 0 or
// a cudaError_t.
int prepare(FwdParams& p, const void* q, const void* k, const void* v, void* o,
            const long long (&st)[12], int B, int H, int N, int D, int n_real, float scale) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > kMaxN || D < 1 || D > 128 ||
      n_real < 1 || n_real > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* in[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!tma_ok(in[i], st[3 * i], st[3 * i + 1], st[3 * i + 2], B, H, N))
      return static_cast<int>(cudaErrorInvalidValue);
  p.groups = N <= kOnePassKeys ? 1 : (N + kGroupKeys - 1) / kGroupKeys;
  p.key_rows = staged_rows(N, p.groups);
  p.key_box = box_rows(p.key_rows);
  CUtensorMap* main_maps[3] = {&p.q_map, &p.k_map, &p.v_map};
  CUtensorMap* tail_maps[3] = {&p.q_tail, &p.k_tail, &p.v_tail};
  for (int i = 0; i < 3; ++i)
    if (!make_maps(main_maps[i], tail_maps[i], in[i], st[3 * i], st[3 * i + 1], st[3 * i + 2], B,
                   H, N, D, i == 0 ? kRows : p.key_box))
      return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<bf16*>(o);
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_sn = st[11];
  p.N = N;
  p.D = D;
  p.n_real = n_real;
  p.out_vec = (reinterpret_cast<uintptr_t>(o) & 3u) == 0 && D % 2 == 0 && p.o_sb % 2 == 0 &&
              p.o_sh % 2 == 0 && p.o_sn % 2 == 0;
  p.scale = scale;
  return 0;
}

// kOnly >= 0: only that tail's kernels (a caller that knows its head dims).
template <int MODE, int kOnly = -1>
int launch_mode(FwdParams& p, int B, int H, cudaStream_t stream) {
  if constexpr (kOnly >= 0) {
    return launch_chunks<kOnly, MODE>(p, B, H, stream);
  } else {
    if (p.D <= 64) return launch_chunks<0, MODE>(p, B, H, stream);
    if (p.D <= 80) return launch_chunks<16, MODE>(p, B, H, stream);
    return launch_chunks<64, MODE>(p, B, H, stream);
  }
}

// K1, K2, K9 and K8's attention core (no bias): `st` the (batch, head, row)
// strides of q, k, v and the output; returns 0 or a cudaError_t.
template <int kOnly = -1>
int run_plain(const void* q, const void* k, const void* v, void* o, const long long (&st)[12],
              int B, int H, int N, int D, int n_real, float scale, cudaStream_t stream) {
  FwdParams p{};
  const int err = prepare(p, q, k, v, o, st, B, H, N, D, n_real, scale);
  return err != 0 ? err : launch_mode<kNoBias, kOnly>(p, B, H, stream);
}

}  // namespace fwd
}  // namespace short_attn
}  // namespace saicv

// The dispatchers' C entry points; a source that includes this file for its
// kernels (attn_block.cu) defines SAICV_ATTENTION_DEVICE_ONLY.
#ifndef SAICV_ATTENTION_DEVICE_ONLY

using namespace saicv::short_attn;
using namespace saicv::short_attn::fwd;

// Plain C entry points, loaded with ctypes. q, k, v and the output are
// bf16 device pointers, each with its own (batch, head, row) strides in
// elements and a contiguous head dim; q, k and v must be readable by TMA
// (16-byte aligned bases, strides multiples of 8 elements on axes longer
// than 1: the wrapper copies an operand that is not). Launch on `stream`;
// return a cudaError_t (0 = launched; cudaErrorInvalidValue for a shape,
// an operand or a tensor map the kernel cannot take).

// K1, K2, K9: no bias; scores scaled by `scale` (K1's sm_scale).
extern "C" int saicv_short_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         long long q_sb, long long q_sh, long long q_sn,
                                         long long k_sb, long long k_sh, long long k_sn,
                                         long long v_sb, long long v_sh, long long v_sn,
                                         long long out_sb, long long out_sh, long long out_sn,
                                         int B, int H, int N, int D, int n_real, float scale,
                                         void* stream) {
  const long long st[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                            v_sb, v_sh, v_sn, out_sb, out_sh, out_sn};
  return run_plain(q, k, v, o, st, B, H, N, D, n_real, scale, static_cast<cudaStream_t>(stream));
}

// K3/K4: the score of query i and key j gains rel_h[i, j / KW] + rel_w[i,
// j % KW] (fp32, N = KH * KW, each with its own (batch, head, row) strides
// and a contiguous last axis).
extern "C" int saicv_short_attention_relpos_fwd(
    const void* q, const void* k, const void* v, void* o, const float* rel_h,
    const float* rel_w, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long out_sb, long long out_sh, long long out_sn, long long h_sb, long long h_sh,
    long long h_sn, long long w_sb, long long w_sh, long long w_sn, int B, int H, int N, int D,
    int n_real, int KH, int KW, float scale, void* stream) {
  if (KH < 1 || KW < 1 || KH * KW != N || !rel_h || !rel_w)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{};
  const long long st[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                            v_sb, v_sh, v_sn, out_sb, out_sh, out_sn};
  const int err = prepare(p, q, k, v, o, st, B, H, N, D, n_real, scale);
  if (err != 0) return err;
  p.rel_h = rel_h;
  p.rel_w = rel_w;
  p.h_sb = h_sb;
  p.h_sh = h_sh;
  p.h_sn = h_sn;
  p.w_sb = w_sb;
  p.w_sh = w_sh;
  p.w_sn = w_sn;
  p.KH = KH;
  p.KW = KW;
  plan_rel_copies(p, N);
  return launch_mode<kRelBias>(p, B, H, static_cast<cudaStream_t>(stream));
}

// K2b: the score of query i and key j of (batch b, head h) gains bias[b *
// b_sb + h * b_sh + i * b_sn + j], fp32 (bias_bf16 = 0) or bf16 (1); a
// stride is 0 on an axis the bias is broadcast over.
extern "C" int saicv_short_attention_bias_fwd(
    const void* q, const void* k, const void* v, void* o, const void* bias, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn, long long out_sb, long long out_sh,
    long long out_sn, long long b_sb, long long b_sh, long long b_sn, int B, int H, int N, int D,
    int n_real, float scale, int bias_bf16, void* stream) {
  if (!bias) return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{};
  const long long st[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                            v_sb, v_sh, v_sn, out_sb, out_sh, out_sn};
  const int err = prepare(p, q, k, v, o, st, B, H, N, D, n_real, scale);
  if (err != 0) return err;
  p.bias = bias;
  p.b_sb = b_sb;
  p.b_sh = b_sh;
  p.b_sn = b_sn;
  p.bias_bf16 = bias_bf16;
  const long long es = bias_bf16 ? 2 : 4;
  const auto divides = [&](long long unit) {
    return reinterpret_cast<uintptr_t>(bias) % unit == 0 && (b_sb * es) % unit == 0 &&
           (b_sh * es) % unit == 0 && (b_sn * es) % unit == 0;
  };
  p.bias_unit = divides(16) ? 16 : divides(8) ? 8 : divides(4) ? 4 : 2;
  p.bias_rows = b_sn == 0 ? 1 : kRows;
  p.bias_ld = p.groups == 1 ? (N + 7) / 8 * 8 : kGroupKeys;
  // rows back to back (b_sn = N, N even for the pair loads) whose every
  // tile starts and ends on 16 bytes: one bulk copy a block, the rows
  // packed at N elements
  const long long tail_rows = N % kRows == 0 ? kRows : N % kRows;
  if (p.groups == 1 && b_sn == N && N % 2 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
      (b_sb * es) % 16 == 0 && (b_sh * es) % 16 == 0 && (kRows * N * es) % 16 == 0 &&
      (tail_rows * N * es) % 16 == 0) {
    p.bias_bulk = 1;
    p.bias_ld = N;
  }
  return launch_mode<kFullBias>(p, B, H, static_cast<cudaStream_t>(stream));
}

#endif  // SAICV_ATTENTION_DEVICE_ONLY
