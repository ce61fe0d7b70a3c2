// Backward of the short-sequence attention kernels in bf16, for Hopper
// (sm_90a): wgmma products on TMA-fed tiles, any bias staged once.
//
// Replaces, for bf16 inputs, the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_attention.py:
//   K1  _bwd_kernel_pairs (via _pallas_bwd_pairs, entry
//       fused_attention_dense): packed qkv [B, N, 3C] and dout [B, N, C] ->
//       the packed dqkv, an optional sm_scale;
//   K2  _bwd_kernel (via _pallas_bwd, entry fused_attention): q, k, v, dout
//       [B, H, N, D] through their strides -> dq, dk, dv;
//   K9  _bwd_kernel_packed (via _pallas_bwd_packed, entry
//       fused_attention_qkv): a packed [B, N, 3, H, D] qkv -> the packed
//       dqkv;
//   K2b _bwd_kernel_bias (via _pallas_bwd_bias, entry fused_attention(bias=)):
//       K2 with a full score bias (fp32 or bf16, its own strides, 0 on a
//       broadcast axis) -> also dbias = dS0, in the bias's dtype where the
//       bias has the full [B, H, N, N] shape, else fp32 for the wrapper to
//       sum over the broadcast axes;
//   K3  _bwd_kernel_relwin_pairs (via _pallas_bwd_relwin_pairs, entry
//       fused_attention_relwin_dense) and K4 _bwd_kernel_relwin (via
//       _relwin_bwd_factory, entry fused_attention_relwin): SAM's decomposed
//       rel-pos bias, score(i, j) += rel_h[i, j / KW] + rel_w[i, j % KW]
//       (fp32, N = KH * KW, each term through its own strides) -> also
//       drel_h[i, kh] and drel_w[i, kw] (fp32).
// K8's attention core (attn_block.cu) runs the no-bias mode too. The bias
// is a template value of both kernels (kNoBias, kRelBias, kFullBias). q, k,
// v and dout are read in place through 4-D tensor maps {D, N, H, B}, each
// with its own strides; dq, dk and dv are written through one stride set.
// fp32 inputs keep fused_attention.cu's FMA backward.
//
// Math, as the TPU kernels: s = q.k^T * scale in fp32, the bias added in
// fp32; keys at or past n_real get -1e9, padding -inf; P in fp32,
// normalised, as the forward (short_attention_fwd.cu) forms it: P =
// 2^(logit - lse2), logit = s * scale * log2(e) + bias * log2(e), lse2 =
// max + log2(sum of 2^(logit - max)); dV = bf16(P)^T.dO; dP = dO.V^T in
// fp32; row = sum_k dP * P with the fp32 P (not rowsum(dO * O)); dS0 = P *
// (dP - row) in fp32; dS = dS0 * scale rounded to bf16; dQ = dS.K and dK =
// dS^T.Q; fp32 accumulation, bf16 outputs; dbias = dS0 (rounded once to a
// bf16 bias's dtype); drel_h and drel_w the fp32 sums of dS0 over each
// key-grid row and column, in key order. Masked keys get P = 0 and so
// exactly zero dk, dv and dbias. Every output element has one owner and no
// sum crosses blocks: no atomics, and two runs give the same bits.
// N <= 1024, D <= 128.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at ViT-B/16
// (B = 256, N = 197, H = 12, D = 64) a backward reads q, k, v, dout and
// writes dq, dk, dv, 7 * B * N * C * 2 B = 542 MB: 0.162 ms, against the
// five products' 10 * B * H * N^2 * D = 76 GFLOP = 0.077 ms; at ViT-H/14
// (B = 256, H = 16, N = 257, D = 80) 1180 MB, 0.352 ms, against 217 GFLOP =
// 0.219 ms. At SAM-B's windows (B' = 200 windows of N = 196, H = 12, D =
// 64) q, k, v, dout and their gradients are 422 MB; K2b adds an fp32 bias
// read and its gradient written, 2 * 369 MB: 0.346 ms; K3 the fp32 rel
// terms and their gradients, 105 MB: 0.157 ms; SAM-H's K4 (H = 16, D = 80)
// 842 MB: 0.252 ms. Bound by bytes.
//
// Design. Two kernels, each a warpgroup (128 threads) a block that owns 64
// rows of one (batch, head), and stages the other two operands' rows of the
// head in shared memory by TMA (the same 4-D maps, 128-byte swizzle, D = 80's
// columns 64-79 in 16-column boxes with the 32-byte swizzle, as the
// forward), the row tiles of a head adjacent in launch order so that the
// staged rows come from L2 after the first block:
//   short_attention_bwd_dq: owns 64 query rows, stages Q and dO tiles and
//     the head's K and V (N <= 264: one box of N rows rounded up to 16, two
//     past 256 rows; 53 KB at ViT-B). S = Q.K^T runs as wgmma m64nNk16 with
//     the whole row in the accumulators (100 registers at N = 197, 132 at
//     257: four chunks of 64 keys and one of 8); the bias is added as the
//     scores leave them (below), so one pass gives the max, the sum, lse2
//     and P. dP = dO.V^T then runs in 64-key chunks against the resident
//     fp32 P, twice: the first walk sums row, the second forms dS0, rounds
//     dS0 * scale to bf16 as a register-A operand (the accumulator layout
//     is the A operand's) and runs dQ += dS.K with K read MN-major. It
//     writes lse2 and row of its rows to a small fp32 scratch [2, B, H, N].
//   short_attention_bwd_dkv: owns 64 key rows, stages its K and V tiles and
//     the head's Q and dO rows, and their lse2 and row; for each chunk of 64
//     queries S^T = K.Q^T and dP^T = V.dO^T on wgmma, P^T = 2^(S^T * scale *
//     log2(e) + bias * log2(e) - lse2[q]) (no row reduction), dS^T = P^T *
//     (dP^T - row[q]) * scale, then dV += bf16(P^T).dO and dK +=
//     bf16(dS^T).Q as register-A products, dO and Q read MN-major: nothing
//     is transposed through shared memory.
// The biased modes:
//   - the dQ kernel reads K2b's bias rows straight into the score
//     registers' layout (each quad of lanes reads 32 contiguous bytes of a
//     row: whole sectors), a chunk's loads issued together with no branch
//     between them, after prefetching the tile's rows into L2 at the
//     block's start: a 50 KB fp32 tile staged in shared memory beside the
//     69 KB of Q, dO, K and V would cost the SM its second block. K3/K4's
//     rel rows [64][KH + KW] (7 KB) and the key-column table are staged as
//     the forward stages them (stage_rel; where they do not fit, read in
//     place).
//   - dS0 of each 64-key chunk goes through shared memory, into the chunk's
//     K and V rows, which its last products have just freed: K2b's dbias
//     tile row-major (in dbias's dtype, 16-byte units swizzled by row),
//     copied out to [B, H, N, N] once per key group in whole 16-byte (or the
//     widest aligned) stores; K3/K4's fp32 tile key-major, from which,
//     once the group's chunks are done and P's registers free, the threads
//     sum each row's rel_h bins (a key-grid row's keys) and rel_w bins (a
//     key-grid column's) [64][KH + KW], each in key order, four loads ahead
//     of their adds, written out at the end.
//   - the dK/dV kernel stages, for each chunk of 64 queries, the bias its
//     keys read through a two-slot ring filled by cp.async a chunk ahead:
//     K2b's bias rows at the block's 64 key columns ([64][68] fp32 or
//     [64][72] bf16, 35 KB or 18 KB a ring: 106 KB a block at SAM-B with an
//     fp32 bias, two blocks an SM), or K3/K4's rel_h columns of the block's
//     key-grid rows and rel_w columns of its keys ([64][<= 6 + 14] fp32 at
//     SAM's windows, 4-byte copies: K3's [B, N, H, 14] rows are 56 bytes).
//     The whole slice in one buffer (57 KB fp32 at N = 196) would leave one
//     block an SM; so does the fp32 ring at D = 80 (123 KB a block).
// Measured on one H100 at SAM-B's windows (PERF.md §6,
// tools/profile_attention_backward.py): K2b's fp32 bias backward 0.99 ms
// (dQ 0.54, dK/dV 0.45), K3's 1.48 (0.90 + 0.58), where K1's no-bias
// backward of ViT-B/16 takes 0.63 (0.34 + 0.28): the drel sums (latency,
// not issue, bound) and the rel logits are K3's extra work in the dQ
// kernel, two blocks an SM where the no-bias dK/dV kernel runs three its
// extra in the other.
// Products: S, dP twice and dQ in the first kernel, S^T, dP^T, dV and dK in
// the second: eight of 64 x N x D, where five are the least. The five
// product design (one walk, dQ summed across key tiles) would write dQ
// partial sums in fp32 that at ViT-B outweigh the whole bound (~620 MB
// against 542 MB), so it does not pay at these lengths; keeping dP in
// shared memory instead of computing it again (fp32, 51 KB at N = 197)
// would cost a block of the two an SM that the registers allow.
// Where N > 264 (up to 1024) the same code walks the keys in groups of 256:
// the first kernel takes three passes (online max and sum, row, dS and dQ),
// computing S (and reading the bias) in each; the second walks the query
// groups in turn.
// Head dims: the k-steps run over D rounded up to 16, the maps filling the
// columns past D with zeros.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_tiles.cuh"
#include "short_attention.cuh"

namespace saicv {
namespace short_attn {
namespace bwd {

// Byte offsets in a block's dynamic shared memory (1024-byte aligned): the
// block's own two tiles (64 rows), the two staged operands (`rows` rows),
// their column tails (columns 64..), (dK/dV) the staged queries' lse2 and
// row, (dQ, K3/K4) the rows' rel terms, the key-column table, the staged
// keys' dS0 offsets and the drel sums, (dK/dV, biased) the bias ring, four
// mbarriers.
struct Smem {
  int own[2], all[2], own_t[2], all_t[2], stats, terms, tab, koff, bins, ring, bars, bytes;
};

struct BwdParams {
  // the first kernel: own Q and dO, staged K and V; the second: own K and
  // V, staged Q and dO. Boxes of 64 columns (128-byte swizzle) and, for D
  // in (64, 80], of 16 (32-byte swizzle); own 64 rows a box, staged `box`.
  CUtensorMap own[2], own_t[2], all[2], all_t[2];
  float* lse2;  // [B, H, N]: max + log2(sum) of each query row's logits
  float* row;   // [B, H, N]: sum_k dP * P
  bf16 *dq, *dk, *dv;
  long long g_sb, g_sh, g_sn;  // strides of dq, dk and dv
  int N, D, n_real;
  int groups;   // groups of kGroupKeys rows (1: the whole head at once)
  int rows;     // rows of a staged group
  int box;      // rows of a staged box (rows in one or two)
  int narrow;   // the row's last chunk is an 8-wide one (groups == 1)
  int out_vec;  // bf16 pairs of the gradients stored as 32-bit words
  float scale;
  // K2b: the bias, its (batch, head, row) strides in elements (0 on a
  // broadcast axis), and its gradient
  const void* bias;
  long long b_sb, b_sh, b_sn;
  int bias_bf16;
  int bias_pairs;  // (dQ) two keys' bias as one 8- or 4-byte load (N even)
  int bias_unit;   // (dK/dV) bytes a ring copy: 16, 8, 4 (cp.async) or 2 (loads)
  void* dbias;     // nullptr: none; else a contiguous [B, H, N, N]
  int dbias_bf16;
  int dbias_unit;  // bytes a store of the copy-out: 16, 8, 4 or 2
  // K3/K4: the rel terms and their gradients, strides in floats
  const float* rel_h;
  const float* rel_w;
  long long h_sb, h_sh, h_sn, w_sb, w_sh, w_sn;
  float* drel_h;
  float* drel_w;
  long long dh_sb, dh_sh, dh_sn, dw_sb, dw_sh, dw_sn;
  int KH, KW;
  int rel_staged;   // (dQ) the rows' terms in shared memory (else read in place)
  int rel_bulk;     // (dQ) stage_rel's copies
  int rel_unit;
  int bins_shared;  // (dQ) the drel sums in shared memory (else in drel itself)
  int bins_ld;      // (dQ) floats a row of the shared drel sums
  int ring_ld;   // (dK/dV) elements a row of a ring slot
  Smem sm;
};

// Thread 0: the block's own two tiles (with_own) on `own_bar`, and rows
// row0.. of the two staged operands, the first on bar_a, the second on
// bar_b (with_b).
template <int kTail>
__device__ __forceinline__ void load_tiles(const BwdParams& p, unsigned char* sm, uint64_t* own_bar,
                                      uint64_t* bar_a, uint64_t* bar_b, int own0, int row0,
                                      bool with_own, bool with_b, int hd, int b) {
  constexpr int kTb = tail_bytes<kTail>();
  if (with_own) {
    mbar_expect_tx(own_bar, 2 * kRows * (128 + kTb));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tma_box(sm + p.sm.own[i], &p.own[i], own_bar, 0, own0, hd, b);
      if (kTail) tma_box(sm + p.sm.own_t[i], kTail == 16 ? &p.own_t[i] : &p.own[i], own_bar, 64,
                         own0, hd, b);
    }
  }
  for (int i = 0; i < (with_b ? 2 : 1); ++i) {
    uint64_t* bar = i == 0 ? bar_a : bar_b;
    mbar_expect_tx(bar, p.rows * (128 + kTb));
    for (int r = 0; r < p.rows; r += p.box) {
      tma_box(sm + p.sm.all[i] + r * 128, &p.all[i], bar, 0, row0 + r, hd, b);
      if (kTail) tma_box(sm + p.sm.all_t[i] + r * kTb, kTail == 16 ? &p.all_t[i] : &p.all[i], bar,
                         64, row0 + r, hd, b);
    }
  }
}

__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ----------------------------------------------- the bias of the dQ kernel

// K2b: the first byte of the bias row of query `row` of (b, hd).
__device__ __forceinline__ const char* bias_row(const BwdParams& p, int b, int hd, int row) {
  return static_cast<const char*>(p.bias) +
         (b * p.b_sb + hd * p.b_sh + static_cast<long long>(row) * p.b_sn) * (p.bias_bf16 ? 2 : 4);
}

// K2b: the block's bias rows q0.. (one row when broadcast over rows) into
// L2, 128-byte lines spread over the threads.
__device__ __forceinline__ void prefetch_bias(const BwdParams& p, int b, int hd, int q0) {
  const int row_bytes = p.N * (p.bias_bf16 ? 2 : 4), lines = (row_bytes + 127) / 128;
  const int rows = p.b_sn == 0 ? 1 : min(kRows, p.N - q0);
  for (int i = threadIdx.x; i < rows * lines; i += kThreads) {
    const char* at = bias_row(p, b, hd, q0 + i / lines) + min(128 * (i % lines), row_bytes - 1);
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(at));
  }
}

// K2b: the bias of key columns col and col + 1 of rows brow[h] times
// log2(e), added to the raw scores times sc (biased_logit), for every
// register of s: two keys a load where the rows allow it (kPairs), else a
// key a load. A column past N reads the row's last pair or key (its logit
// is -inf whatever it reads), so that no load waits on a branch and a
// chunk's loads go out together.
template <int KC, int kLast, bool kPairs, typename T>
__device__ __forceinline__ void bias_logits(float (&s)[KC][32], const BwdParams& p,
                                            const char* const (&brow)[2], int key0, int t,
                                            float sc, float masked) {
  const int last = kPairs ? p.N - 2 : p.N - 1;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    float bv[32];
#pragma unroll
    for (int i = 0; i < regs_of<KC, kLast>(c); i += 2) {
      const int col = key0 + 64 * c + 8 * (i >> 2) + 2 * t;
      const T* row = reinterpret_cast<const T*>(brow[(i >> 1) & 1]);
      if constexpr (kPairs) {
        float2 x;
        if constexpr (std::is_same<T, float>::value)
          x = __ldg(reinterpret_cast<const float2*>(row + min(col, last)));
        else
          x = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(row + min(col, last))));
        bv[i] = x.x;
        bv[i + 1] = x.y;
      } else if constexpr (std::is_same<T, float>::value) {
        bv[i] = __ldg(row + min(col, last));
        bv[i + 1] = __ldg(row + min(col + 1, last));
      } else {
        bv[i] = __bfloat162float(__ldg(row + min(col, last)));
        bv[i + 1] = __bfloat162float(__ldg(row + min(col + 1, last)));
      }
    }
#pragma unroll
    for (int i = 0; i < regs_of<KC, kLast>(c); ++i) {
      const int col = key0 + 64 * c + 8 * (i >> 2) + 2 * t + (i & 1);
      s[c][i] = biased_logit(s[c][i], bv[i], col, p.n_real, p.N, sc, masked);
    }
  }
}

// K3/K4: the rel terms of the thread's two rows (rows rh[h] and rw[h])
// added to the raw scores times sc (biased_logit), the key columns' (j /
// KW, j % KW) from the table, shared by the two rows.
template <int KC, int kLast>
__device__ __forceinline__ void rel_logits(float (&s)[KC][32], const BwdParams& p,
                                           const float* const (&rh)[2],
                                           const float* const (&rw)[2], const int* tab,
                                           int key0, int t, float sc, float masked) {
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int j = 0; j < regs_of<KC, kLast>(c) / 4; ++j) {
      const int col = key0 + 64 * c + 8 * j + 2 * t;
      const int e0 = tab[min(col, p.N - 1)], e1 = tab[min(col + 1, p.N - 1)];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* e = &s[c][4 * j + 2 * h];
        e[0] = biased_logit(e[0], rh[h][e0 & 0xffff] + rw[h][e0 >> 16], col, p.n_real, p.N, sc,
                            masked);
        e[1] = biased_logit(e[1], rh[h][e1 & 0xffff] + rw[h][e1 >> 16], col + 1, p.n_real, p.N,
                            sc, masked);
      }
    }
}

// Raw scores of keys key0.. -> log2-domain logits s*sc + bias*log2(e), as
// the forward forms them; keys at or past n_real `masked`, at or past N
// -inf. K2b reads the bias rows of the thread's rows (rows past N read row
// N - 1: their scores are never stored); K3/K4 the staged rel rows (or,
// where they do not fit, the rel rows in place).
template <int KC, int kLast, int MODE>
__device__ __forceinline__ void dq_logits(float (&s)[KC][32], const BwdParams& p,
                                          const unsigned char* sm, int b, int hd, int q0,
                                          int key0, int warp, int g, int t, float sc,
                                          float masked) {
  const int rl0 = 16 * warp + g;  // local rows rl0 and rl0 + 8
  if constexpr (MODE == kNoBias) {
    plain_logits<KC, kLast>(s, key0, t, p.N, p.n_real, sc, masked);
  } else if constexpr (MODE == kFullBias) {
    const char* const brow[2] = {bias_row(p, b, hd, min(q0 + rl0, p.N - 1)),
                                 bias_row(p, b, hd, min(q0 + rl0 + 8, p.N - 1))};
    if (p.bias_bf16) {
      if (p.bias_pairs)
        bias_logits<KC, kLast, true, bf16>(s, p, brow, key0, t, sc, masked);
      else
        bias_logits<KC, kLast, false, bf16>(s, p, brow, key0, t, sc, masked);
    } else {
      if (p.bias_pairs)
        bias_logits<KC, kLast, true, float>(s, p, brow, key0, t, sc, masked);
      else
        bias_logits<KC, kLast, false, float>(s, p, brow, key0, t, sc, masked);
    }
  } else {
    const int* tab = reinterpret_cast<const int*>(sm + p.sm.tab);
    if (p.rel_staged) {  // the block's rows [64][KH], then [64][KW]
      const float* terms = reinterpret_cast<const float*>(sm + p.sm.terms);
      const float* const rh[2] = {terms + rl0 * p.KH, terms + (rl0 + 8) * p.KH};
      const float* const rw[2] = {terms + kRows * p.KH + rl0 * p.KW,
                                  terms + kRows * p.KH + (rl0 + 8) * p.KW};
      rel_logits<KC, kLast>(s, p, rh, rw, tab, key0, t, sc, masked);
    } else {  // the rows in place (rows past N read row N - 1)
      const int r0 = min(q0 + rl0, p.N - 1), r1 = min(q0 + rl0 + 8, p.N - 1);
      const float* h0 = p.rel_h + b * p.h_sb + hd * p.h_sh;
      const float* w0 = p.rel_w + b * p.w_sb + hd * p.w_sh;
      const float* const rh[2] = {h0 + r0 * p.h_sn, h0 + r1 * p.h_sn};
      const float* const rw[2] = {w0 + r0 * p.w_sn, w0 + r1 * p.w_sn};
      rel_logits<KC, kLast>(s, p, rh, rw, tab, key0, t, sc, masked);
    }
  }
}

// ------------------------------------------ dS0 through the freed K and V

// The staged K (half 1) or V (half 0) rows of key chunk c (64, or 16 for
// an 8-wide chunk): free once the chunk's products of the last pass are
// done, they hold the halves of the chunk's dS0 tile.
__device__ __forceinline__ unsigned char* tile_half(unsigned char* sm, const BwdParams& p, int c,
                                                    int half) {
  return sm + p.sm.all[half == 0 ? 1 : 0] + 64 * 128 * c;
}

// K2b: byte offset of (row r, key j) of a dbias tile of kWidth keys, es
// bytes an element, in its half (rows 0-31, then 32-63): rows of kWidth
// keys, a 64-wide row's 16-byte units swizzled by its row (no bank
// conflicts where a warp writes its fragments, nor where it reads a row).
template <int kWidth>
__device__ __forceinline__ int dbias_at(int r, int j, int es) {
  const int byte = j * es;
  const int swz = kWidth == 64 ? (es == 4 ? 2 * (r & 3) : (r & 7)) : 0;
  return (r & 31) * kWidth * es + ((((byte >> 4) ^ swz)) << 4) + (byte & 15);
}

// K2b: the thread's dS0 of a chunk (its fragments' layout) into the chunk's
// dbias tile, in dbias's dtype.
template <int kWidth>
__device__ __forceinline__ void put_dbias(unsigned char* sm, const BwdParams& p, int c,
                                          const float (&ds0)[32], int warp, int g, int t) {
  const int es = p.dbias_bf16 ? 2 : 4;
#pragma unroll
  for (int i = 0; i < kWidth / 2; i += 2) {
    const int r = 16 * warp + g + 8 * ((i >> 1) & 1), j = 8 * (i >> 2) + 2 * t;
    unsigned char* at = tile_half(sm, p, c, r >> 5) + dbias_at<kWidth>(r, j, es);
    if (es == 4)
      *reinterpret_cast<float2*>(at) = make_float2(ds0[i], ds0[i + 1]);
    else
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(ds0[i], ds0[i + 1]);
  }
}

// K2b: the dbias tiles of the staged key group (keys key0..) out to dbias's
// rows q0.., a warp a row, dbias_unit bytes a store.
template <int KC, int kLast>
__device__ void store_dbias(unsigned char* sm, const BwdParams& p, int b, int hd, int q0,
                            int key0) {
  const int es = p.dbias_bf16 ? 2 : 4, unit = p.dbias_unit;
  const int cols = p.groups == 1 ? p.N : min(p.N - key0, kGroupKeys);
  const int per = cols * es / unit, rows = min(kRows, p.N - q0);
  char* out = static_cast<char*>(p.dbias) +
              ((static_cast<long long>(b) * gridDim.y + hd) * p.N + q0) * p.N * es +
              static_cast<long long>(key0) * es;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, byte = (i - r * per) * unit;
    const int c = byte / (64 * es), in = byte - c * 64 * es;
    const bool narrow = kLast == 8 && c == KC - 1;
    const int swz = narrow ? 0 : es == 4 ? 2 * (r & 3) : (r & 7);
    const unsigned char* src = tile_half(sm, p, c, r >> 5) + (r & 31) * (narrow ? 8 : 64) * es +
                               (((in >> 4) ^ swz) << 4) + (in & 15);
    char* dst = out + static_cast<long long>(r) * p.N * es + byte;
    if (unit == 16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else if (unit == 8)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    else if (unit == 4)
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
    else
      *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  }
}

// K3/K4: a chunk's fp32 dS0 tile is key-major: key j's 64 rows (256
// bytes) at (j % 32) * 256 of half j / 32, row r at 4r (a warp's fragment
// stores meet 4-way bank conflicts, 32 a chunk; 32 threads reading one
// key's rows meet none). `koff` holds, for each key of a staged group, the
// byte offset of its rows from the block's shared memory.
__device__ __forceinline__ void key_offsets(int* koff, const BwdParams& p) {
  for (int j = threadIdx.x; j < p.rows; j += kThreads)
    koff[j] = p.sm.all[(j >> 5) & 1 ? 0 : 1] + 64 * 128 * (j >> 6) + (j & 31) * 256;
}

// K3/K4: the thread's dS0 of a chunk into the chunk's tile: two per-thread
// bases (the halves) plus compile-time offsets.
template <int kWidth>
__device__ __forceinline__ void put_ds0t(unsigned char* sm, const BwdParams& p, int c,
                                         const float (&ds0)[32], int warp, int g, int t) {
  unsigned char* half[2] = {tile_half(sm, p, c, 0) + 512 * t + 4 * (16 * warp + g),
                            tile_half(sm, p, c, 1) + 512 * t + 4 * (16 * warp + g)};
#pragma unroll
  for (int i = 0; i < kWidth / 2; ++i) {
    const int jj = i >> 2;
    *reinterpret_cast<float*>(half[jj >> 2] + (8 * (jj & 3) + (i & 1)) * 256 +
                              32 * ((i >> 1) & 1)) = ds0[i];
  }
}

// K3/K4: row q0 + r's rel_h (h) or rel_w drel sums: a row of the shared
// sums or, where those do not fit, the row of drel_h or drel_w itself
// (nullptr past N).
__device__ __forceinline__ float* drel_row(unsigned char* sm, const BwdParams& p, int b, int hd,
                                           int q0, int r, bool h) {
  if (p.bins_shared)
    return reinterpret_cast<float*>(sm + p.sm.bins) + r * p.bins_ld + (h ? 0 : p.KH);
  if (q0 + r >= p.N) return nullptr;
  return h ? p.drel_h + b * p.dh_sb + hd * p.dh_sh + (q0 + r) * p.dh_sn
           : p.drel_w + b * p.dw_sb + hd * p.dw_sh + (q0 + r) * p.dw_sn;
}

// K3/K4: the staged group's keys key.. key + cols - 1 (their dS0 tiles in
// the freed K and V rows) added to the drel sums, each sum over its keys in
// key order: an item is a row and one key-grid row kh (the rel_h sum of
// the group's keys in it) or one key-grid column (the rel_w sum of its
// keys), the 64 rows of an item in adjacent threads (no bank conflicts on
// the key-major tiles). After the group's chunks, when P's registers are
// free.
__device__ void sum_drel(unsigned char* sm, const BwdParams& p, int b, int hd, int q0, int key,
                         int cols) {
  const int KW = p.KW, jh0 = key / KW;
  const int nh = (key + cols - 1) / KW - jh0 + 1, nw = min(KW, cols);
  const int* koff = reinterpret_cast<const int*>(sm + p.sm.koff);
  for (int i = threadIdx.x; i < kRows * (nh + nw); i += kThreads) {
    const int r = i & (kRows - 1), m = i / kRows;
    float* sums = drel_row(sm, p, b, hd, q0, r, m < nh);
    if (sums == nullptr) continue;
    const unsigned char* rows = sm + 4 * r;
    auto ds0 = [&](int j) { return *reinterpret_cast<const float*>(rows + koff[j]); };
    // keys j0, j0 + step, .. below hi added in order, four loads issued
    // before their adds (a warp waits on no load but the first)
    auto sum = [&](float* at, int j0, int step, int hi) {
      float acc = *at;
      int j = j0;
      for (; j + 3 * step < hi; j += 4 * step) {
        const float x0 = ds0(j), x1 = ds0(j + step), x2 = ds0(j + 2 * step),
                    x3 = ds0(j + 3 * step);
        acc += x0;
        acc += x1;
        acc += x2;
        acc += x3;
      }
      for (; j < hi; j += step) acc += ds0(j);
      *at = acc;
    };
    if (m < nh) {
      const int kh = jh0 + m;
      sum(sums + kh, max(kh * KW, key) - key, 1, min(kh * KW + KW, key + cols) - key);
    } else {
      const int j0 = m - nh;
      sum(sums + (key + j0) % KW, j0, KW, cols);
    }
  }
}

// ------------------------------------------------------------- dQ kernel
//
// Block (query tile, head, batch). KC: 64-key chunks of a group (4 when the
// keys go in groups, 5 for 257..264 keys); kLast: keys of the last chunk
// (8, or 64 with the width decided at run time); kTail: the head columns
// past 64 (0, 16 or 64); MODE: the bias.
template <int KC, int kLast, int kTail, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    short_attention_bwd_dq(const __grid_constant__ BwdParams p) {
  unsigned char* sm = aligned_smem();
  const int hd = blockIdx.y, b = blockIdx.z;
  const int q0 = kRows * blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // Q and dO, K, V, the rel terms' bulk copy
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + p.sm.bars);
  const uint32_t base = smem_addr(sm);
  const uint32_t qa = base + p.sm.own[0], doa = base + p.sm.own[1];
  const uint32_t qta = base + p.sm.own_t[0], dota = base + p.sm.own_t[1];
  const uint32_t ka = base + p.sm.all[0], va = base + p.sm.all[1];
  const uint32_t kta = base + p.sm.all_t[0], vta = base + p.sm.all_t[1];
  init_bars(bars);

  const float sc = p.scale * kLog2e;
  const float masked = kNegInf * kLog2e;
  const int N = p.N, groups = p.groups;
  // dS0 goes through the freed K and V rows: K2b's dbias, K3/K4's drel
  const bool ds_tile = MODE == kRelBias || (MODE == kFullBias && p.dbias != nullptr);

  if constexpr (MODE == kRelBias) {
    float* rh = reinterpret_cast<float*>(sm + p.sm.terms);
    int* tab = reinterpret_cast<int*>(sm + p.sm.tab);
    if (p.rel_staged)
      stage_rel(p, rh, rh + kRows * p.KH, tab, bars + 3, b, hd, q0);
    else
      key_table(tab, N, p.KW);
    cp_async_commit();
    key_offsets(reinterpret_cast<int*>(sm + p.sm.koff), p);
    // the drel sums start at 0 (seen by every thread after the barrier
    // before the logits)
    const int kk = p.KH + p.KW;
    for (int i = tid; i < kRows * kk; i += kThreads) {
      const int r = i / kk, k = i - r * kk;
      float* sums = drel_row(sm, p, b, hd, q0, r, k < p.KH);
      if (sums != nullptr) sums[k < p.KH ? k : k - p.KH] = 0.f;
    }
  }

  float s[KC][32];                       // logits, then P
  float dq[32], dq_t[tail_regs<kTail>()];  // dQ, columns 0-63 and 64..
  // rows g and g + 8: running max, then lse2; running sum; row
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, row[2] = {0.f, 0.f};
  int k_phase = 0, v_phase = 0;

  // groups == 1: one pass takes the statistics, P is kept, pass 1 sums row
  // and pass 2 forms dS and dQ; groups > 1: pass 0 the online statistics,
  // and S again in each pass
  for (int pass = groups == 1 ? 1 : 0; pass < 3; ++pass) {
    if (pass == 2) {  // dQ's accumulators live in the last pass only
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
#pragma unroll
      for (int i = 0; i < tail_regs<kTail>(); ++i) dq_t[i] = 0.f;
      fence_regs(dq);
      fence_regs(dq_t);
    }
    for (int gi = 0; gi < groups; ++gi) {
      const int key0 = gi * kGroupKeys;
      const bool first = gi == 0 && pass == (groups == 1 ? 1 : 0);
      if (first || groups > 1) {  // stage the group's K (and V)
        if (!first) __syncthreads();  // every thread is done with the last group
        if (tid == 0) load_tiles<kTail>(p, sm, bars, bars + 1, bars + 2, q0, key0, first, pass > 0, hd, b);
        if constexpr (MODE == kFullBias) {
          if (first && groups == 1) prefetch_bias(p, b, hd, q0);
        }
        mbar_wait(bars + 1, k_phase);
        k_phase ^= 1;
        if (first) mbar_wait(bars, 0);
      }
      if (first || groups > 1) {  // S = Q.K^T -> logits (-> P)
        scores<KC, kLast, kTail>(s, qa, qta, ka, kta, 64);
        wg_wait_all();
#pragma unroll
        for (int c = 0; c < KC; ++c) fence_regs(s[c]);
        if constexpr (MODE == kRelBias) {
          if (first) {  // the staged rel rows, the table and the zeroed sums
            if (p.rel_staged && p.rel_bulk) mbar_wait(bars + 3, 0);
            cp_async_wait_all();
            __syncthreads();
          }
        }
        dq_logits<KC, kLast, MODE>(s, p, sm, b, hd, q0, key0, warp, g, t, sc, masked);
        if (pass == 0) {  // online row max and sum
          float mx[2], sum[2];
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
        if (groups == 1) row_lse2<KC, kLast>(s, m);  // the whole row is here
        // P = 2^(logit - lse2)
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int i = 0; i < regs_of<KC, kLast>(c); ++i)
            s[c][i] = exp2_approx(s[c][i] - m[(i >> 1) & 1]);
        mbar_wait(bars + 2, v_phase);
        v_phase ^= 1;
      }
      // dP = dO.V^T a chunk at a time: pass 1 sums row, pass 2 forms dS0
      // and dQ += bf16(dS0 * scale).K
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (key0 + 64 * c >= N) break;
        constexpr bool kNarrow = kLast == 8;  // of the last chunk
        const bool narrow = kNarrow && c + 1 == KC;
        float dp[32];
        wg_fence();
        if (narrow)
          chunk_scores<kTail, 8>(dp, doa, dota, va, vta, 64 * c);
        else
          chunk_scores<kTail, 64>(dp, doa, dota, va, vta, 64 * c);
        wg_wait_all();
        fence_regs(dp);
        if (pass == 1) {
#pragma unroll
          for (int i = 0; i < regs_of<KC, kLast>(c); ++i) row[(i >> 1) & 1] += s[c][i] * dp[i];
          continue;
        }
#pragma unroll
        for (int i = 0; i < regs_of<KC, kLast>(c); ++i)
          dp[i] = s[c][i] * (dp[i] - row[(i >> 1) & 1]);  // dS0
        uint32_t a[4][4];
        if (narrow) {
          a_fragments<4>(a, dp, p.scale);
          wg_fence();
          times_rows<kTail, 1>(dq, dq_t, a, ka, kta, 64 * c);
        } else {
          a_fragments<32>(a, dp, p.scale);
          wg_fence();
          times_rows<kTail, 4>(dq, dq_t, a, ka, kta, 64 * c);
        }
        wg_wait_all();
        fence_regs(dq);
        fence_regs(dq_t);
#pragma unroll
        for (int j = 0; j < 4; ++j) settle(a[j]);  // live until their products are done
        if (MODE != kNoBias && ds_tile) {
          __syncthreads();  // every warp's products of this chunk are done
          if constexpr (MODE == kFullBias) {
            if (narrow)
              put_dbias<8>(sm, p, c, dp, warp, g, t);
            else
              put_dbias<64>(sm, p, c, dp, warp, g, t);
          } else {
            if (narrow)
              put_ds0t<8>(sm, p, c, dp, warp, g, t);
            else
              put_ds0t<64>(sm, p, c, dp, warp, g, t);
          }
        }
      }
      if (pass == 2 && ds_tile) {
        __syncthreads();  // the group's dS0 tiles
        if constexpr (MODE == kFullBias)
          store_dbias<KC, kLast>(sm, p, b, hd, q0, key0);
        else
          sum_drel(sm, p, b, hd, q0, key0, groups == 1 ? N : min(N - key0, kGroupKeys));
        // generic accesses of the K and V buffers before the next group's TMA
        if (groups > 1) fence_proxy_async();
      }
    }
    if (pass == 0) {  // fold log2(sum) into the max
#pragma unroll
      for (int h = 0; h < 2; ++h) m[h] += __log2f(l[h]);
    } else if (pass == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) row[h] = quad_sum(row[h]);
    }
  }

  const int row0 = q0 + 16 * warp + g;
  const long long goff = b * p.g_sb + hd * p.g_sh;
  store_bf16<64>(p.dq + goff, p.g_sn, dq, 1.f, row0, N, 0, p.D, t, p.out_vec);
  if constexpr (kTail > 0) store_bf16<kTail>(p.dq + goff, p.g_sn, dq_t, 1.f, row0, N, 64, p.D, t, p.out_vec);
  if (t == 0) {
    const long long at = (static_cast<long long>(b) * gridDim.y + hd) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + 8 * h < N) {
        p.lse2[at + row0 + 8 * h] = m[h];
        p.row[at + row0 + 8 * h] = row[h];
      }
  }
  if (MODE == kRelBias && p.bins_shared) {  // the drel sums of the block's rows
    __syncthreads();
    const float* bins = reinterpret_cast<const float*>(sm + p.sm.bins);
    const int kk = p.KH + p.KW;
    for (int i = tid; i < kRows * kk; i += kThreads) {
      const int r = i / kk, k = i - r * kk, qr = q0 + r;
      if (qr >= N) break;
      const float x = bins[r * p.bins_ld + k];
      if (k < p.KH)
        p.drel_h[b * p.dh_sb + hd * p.dh_sh + qr * p.dh_sn + k] = x;
      else
        p.drel_w[b * p.dw_sb + hd * p.dw_sh + qr * p.dw_sn + k - p.KH] = x;
    }
  }
}

// ------------------------------------------- the bias of the dK/dV kernel

// The items i = thread, thread + 128, ... of a [rows][per] grid as (row r,
// column c), without a division an item.
struct GridWalk {
  int r, c, dr, dc, per;
  __device__ __forceinline__ explicit GridWalk(int cols) : per(cols) {
    r = threadIdx.x / per;
    c = threadIdx.x - r * per;
    dr = kThreads / per;
    dc = kThreads - dr * per;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
};

// K2b: bias rows q0.. (64, or 1 when broadcast over rows) at the block's
// key columns k0.. into a ring slot [64][ring_ld]; rows at or past N zeros
// (their P is 0, and the bias must be finite), keys past N unset.
__device__ __forceinline__ void stage_bias_cols(const BwdParams& p, unsigned char* dst, int b,
                                                int hd, int q0, int k0) {
  const int es = p.bias_bf16 ? 2 : 4;
  const int bytes = min(kRows, p.N - k0) * es;
  const int rows = p.b_sn == 0 ? 1 : kRows;
  const int unit = p.bias_unit;
  if (unit >= 4) {
    for (GridWalk w((bytes + unit - 1) / unit); w.r < rows; w.next()) {
      const bool in = q0 + w.r < p.N;
      const int c = w.c * unit;
      cp_async_part(dst + w.r * p.ring_ld * es + c,
                    bias_row(p, b, hd, in ? q0 + w.r : 0) + k0 * es + c, unit,
                    in ? min(unit, bytes - c) : 0);
    }
  } else {  // bf16 rows off a 4-byte boundary: element by element
    for (GridWalk w(bytes / 2); w.r < rows; w.next()) {
      const bool in = q0 + w.r < p.N;
      reinterpret_cast<bf16*>(dst + w.r * p.ring_ld * es)[w.c] =
          in ? reinterpret_cast<const bf16*>(bias_row(p, b, hd, q0 + w.r))[k0 + w.c]
             : __float2bfloat16_rn(0.f);
    }
  }
}

// K3/K4: of queries q0.. (64 rows), the rel_h columns jh_lo.. jh_lo + nh -
// 1 (the key-grid rows of the block's keys) and the nw rel_w columns its
// keys read (all KW where KW <= 64, else (k0 + i) % KW of key k0 + i) into
// a ring slot [64][ring_ld], 4-byte copies; rows at or past N zeros.
__device__ __forceinline__ void stage_rel_cols(const BwdParams& p, float* dst, int b, int hd,
                                               int q0, int k0, int jh_lo, int nh, int nw) {
  const float* h0 = p.rel_h + b * p.h_sb + hd * p.h_sh + jh_lo;
  const float* w0 = p.rel_w + b * p.w_sb + hd * p.w_sh;
  for (GridWalk w(nh + nw); w.r < kRows; w.next()) {
    const int q = min(q0 + w.r, p.N - 1), c = w.c;
    cp_async4(dst + w.r * p.ring_ld + c,
              c < nh ? h0 + q * p.h_sn + c
                     : w0 + q * p.w_sn + (p.KW <= kRows ? c - nh : (k0 + c - nh) % p.KW),
              q0 + w.r < p.N);
  }
}

// ---------------------------------------------------------- dK/dV kernel
//
// Block (key tile, head, batch): the query groups in turn, 64 queries a
// chunk; with a bias, the chunk's bias through the two-slot ring.
template <int kTail, int MODE>
__global__ void __launch_bounds__(kThreads, kTail == 0 && MODE == kNoBias ? 3 : 2)
    short_attention_bwd_dkv(const __grid_constant__ BwdParams p) {
  unsigned char* sm = aligned_smem();
  const int hd = blockIdx.y, b = blockIdx.z;
  const int k0 = kRows * blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + p.sm.bars);  // K and V, Q, dO
  const uint32_t base = smem_addr(sm);
  const uint32_t ka = base + p.sm.own[0], va = base + p.sm.own[1];
  const uint32_t kta = base + p.sm.own_t[0], vta = base + p.sm.own_t[1];
  const uint32_t qa = base + p.sm.all[0], doa = base + p.sm.all[1];
  const uint32_t qta = base + p.sm.all_t[0], dota = base + p.sm.all_t[1];
  const int rows64 = (p.rows + 63) & ~63;
  float* lse_s = reinterpret_cast<float*>(sm + p.sm.stats);  // [rows64], then row [rows64]
  float* row_s = lse_s + rows64;
  init_bars(bars);

  const float sc = p.scale * kLog2e;
  const int N = p.N;
  const long long at = (static_cast<long long>(b) * gridDim.y + hd) * N;
  const int key_lo = k0 + 16 * warp + g;  // the thread's keys key_lo and key_lo + 8
  const bool live[2] = {key_lo < p.n_real, key_lo + 8 < p.n_real};

  // the bias ring: query chunk i in slot i & 1; where each of the thread's
  // two keys finds its bias in a slot row (K2b: its column; K3/K4: its
  // rel_h and rel_w columns)
  const int n_chunks = (N + kRows - 1) / kRows;
  const int slot_bytes = kRows * p.ring_ld * (MODE == kFullBias && p.bias_bf16 ? 2 : 4);
  int jh_lo = 0, nh = 0, nw = 0, ih[2] = {0, 0}, iw[2] = {0, 0};
  if constexpr (MODE == kRelBias) {
    jh_lo = k0 / p.KW;
    nh = (min(k0 + kRows, N) - 1) / p.KW - jh_lo + 1;
    nw = min(p.KW, kRows);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = min(key_lo + 8 * h, N - 1), jh = key / p.KW;
      ih[h] = jh - jh_lo;
      iw[h] = nh + (p.KW <= kRows ? key - jh * p.KW : key - k0);
    }
  }
  auto stage = [&](int id) {
    unsigned char* slot = sm + p.sm.ring + (id & 1) * slot_bytes;
    if constexpr (MODE == kFullBias)
      stage_bias_cols(p, slot, b, hd, kRows * id, k0);
    else if constexpr (MODE == kRelBias)
      stage_rel_cols(p, reinterpret_cast<float*>(slot), b, hd, kRows * id, k0, jh_lo, nh, nw);
  };
  if constexpr (MODE != kNoBias) {
    stage(0);
    cp_async_commit();
    if (n_chunks > 1) stage(1);
    cp_async_commit();
  }

  float dk[32], dk_t[tail_regs<kTail>()], dv[32], dv_t[tail_regs<kTail>()];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < tail_regs<kTail>(); ++i) dk_t[i] = dv_t[i] = 0.f;
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(dk_t);
  fence_regs(dv_t);

  // one chunk of queries c0.. of the staged group (q0c.. of the head): 64
  // wide, or 8 (kWidth) at the end of a row of N = 64k + 1..8
  auto chunk = [&](int c0, int q0c, auto width) {
    constexpr int kWidth = decltype(width)::value;
    constexpr int kRegs = kWidth / 2;
    const int id = q0c / kRows;
    if constexpr (MODE != kNoBias) {  // the chunk's slot, from every thread
      cp_async_wait_one();
      __syncthreads();
    }
    float st[32], dpt[32];
    wg_fence();
    chunk_scores<kTail, kWidth>(st, ka, kta, qa, qta, c0);
    chunk_scores<kTail, kWidth>(dpt, va, vta, doa, dota, c0);
    wg_wait_all();
    fence_regs(st);
    fence_regs(dpt);
    const unsigned char* slot = sm + p.sm.ring + (id & 1) * slot_bytes;
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      const int qc = 8 * (i >> 2) + 2 * t + (i & 1);  // query in the chunk
      const int ql = c0 + qc;                         // in the group
      const int h = (i >> 1) & 1;
      float pt;
      if constexpr (MODE == kNoBias) {
        pt = live[h] ? exp2_approx(st[i] * sc - lse_s[ql]) : 0.f;
      } else {
        float bias;
        if constexpr (MODE == kFullBias) {
          const int e = (p.b_sn == 0 ? 0 : qc * p.ring_ld) + key_lo - k0 + 8 * h;
          bias = p.bias_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(slot)[e])
                             : reinterpret_cast<const float*>(slot)[e];
        } else {
          const float* r = reinterpret_cast<const float*>(slot) + qc * p.ring_ld;
          bias = r[ih[h]] + r[iw[h]];
        }
        pt = live[h] ? exp2_approx(fmaf(st[i], sc, bias * kLog2e) - lse_s[ql]) : 0.f;
      }
      st[i] = pt;
      dpt[i] = pt * (dpt[i] - row_s[ql]) * p.scale;
    }
    uint32_t ap[4][4], ad[4][4];
    a_fragments<kRegs>(ap, st);
    a_fragments<kRegs>(ad, dpt);
    constexpr int kSteps = (kWidth + 15) / 16;
    wg_fence();
    times_rows<kTail, kSteps>(dv, dv_t, ap, doa, dota, c0);
    times_rows<kTail, kSteps>(dk, dk_t, ad, qa, qta, c0);
    wg_wait_all();
    fence_regs(dv);
    fence_regs(dv_t);
    fence_regs(dk);
    fence_regs(dk_t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // live until their products are done
      settle(ap[j]);
      settle(ad[j]);
    }
    if constexpr (MODE != kNoBias) {  // every thread has read the slot: refill it
      __syncthreads();
      if (id + 2 < n_chunks) stage(id + 2);
      cp_async_commit();
    }
  };

  for (int gi = 0; gi < p.groups; ++gi) {
    const int qbase = gi * kGroupKeys;
    if (gi > 0) __syncthreads();  // every thread is done with the last group
    if (tid == 0) load_tiles<kTail>(p, sm, bars, bars + 1, bars + 2, k0, qbase, gi == 0, true, hd, b);
    for (int i = tid; i < rows64; i += kThreads) {  // +inf past N: P = 0
      const bool in = qbase + i < N;
      lse_s[i] = in ? p.lse2[at + qbase + i] : INFINITY;
      row_s[i] = in ? p.row[at + qbase + i] : 0.f;
    }
    __syncthreads();
    if (gi == 0) mbar_wait(bars, 0);
    mbar_wait(bars + 1, gi & 1);
    mbar_wait(bars + 2, gi & 1);
    const int queries = p.groups == 1 ? N : min(N - qbase, kGroupKeys);
    // whole chunks, then the narrow one (groups == 1 only)
    const int whole = p.narrow ? queries / 64 : (queries + 63) / 64;
    for (int c = 0; c < whole; ++c)
      chunk(64 * c, qbase + 64 * c, std::integral_constant<int, 64>{});
    if (p.narrow) chunk(64 * whole, qbase + 64 * whole, std::integral_constant<int, 8>{});
  }

  const long long goff = b * p.g_sb + hd * p.g_sh;
  store_bf16<64>(p.dk + goff, p.g_sn, dk, 1.f, key_lo, N, 0, p.D, t, p.out_vec);
  store_bf16<64>(p.dv + goff, p.g_sn, dv, 1.f, key_lo, N, 0, p.D, t, p.out_vec);
  if constexpr (kTail > 0) {
    store_bf16<kTail>(p.dk + goff, p.g_sn, dk_t, 1.f, key_lo, N, 64, p.D, t, p.out_vec);
    store_bf16<kTail>(p.dv + goff, p.g_sn, dv_t, 1.f, key_lo, N, 64, p.D, t, p.out_vec);
  }
}

// ------------------------------------------------------------- host side

// `terms`, `tab`, `bins`: the dQ kernel's rel rows, tables (the key
// columns' and the staged keys' dS0 offsets) and drel sums (K3/K4); `ring`:
// the dK/dV kernel's bias ring; bytes, 0 where unused.
Smem layout(int kTail, int rows, bool stats, int terms, int tab, int bins, int ring) {
  const int tail = kTail == 16 ? 32 : kTail == 64 ? 128 : 0;
  const auto up16 = [](int x) { return (x + 15) / 16 * 16; };
  Smem s;
  s.own[0] = 0;
  s.own[1] = kRows * 128;
  s.all[0] = 2 * kRows * 128;
  s.all[1] = s.all[0] + rows * 128;
  s.own_t[0] = s.all[1] + rows * 128;
  s.own_t[1] = s.own_t[0] + kRows * tail;
  s.all_t[0] = s.own_t[1] + kRows * tail;
  s.all_t[1] = s.all_t[0] + rows * tail;
  s.stats = s.all_t[1] + rows * tail;
  s.terms = s.stats + (stats ? 2 * ((rows + 63) & ~63) * 4 : 0);
  s.tab = s.terms + up16(terms);
  s.koff = s.tab + up16(tab);
  s.bins = s.koff + (tab > 0 ? rows * 4 : 0);
  s.ring = s.bins + up16(bins);
  s.bars = s.ring + up16(ring);
  s.bytes = s.bars + 32;
  return s;
}

template <typename Kernel>
int launch(Kernel kernel, const BwdParams& p, int B, int H, cudaStream_t stream) {
  const int smem = p.sm.bytes + 1024;  // room to align the base to 1024 bytes
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // all of the SM's 228 KB as shared memory, so that two blocks fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.N + kRows - 1) / kRows, H, B), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The first kernel at the chunk shape N asks for, as the forward chooses it.
template <int kTail, int MODE>
int launch_dq(const BwdParams& p, int B, int H, cudaStream_t stream) {
  const int chunks = p.groups > 1 ? 4 : (p.N + 63) / 64;
  if (p.groups == 1 && chunks == 4 && (p.N + 7) / 8 * 8 == 200)  // N = 193..200
    return launch(short_attention_bwd_dq<4, 8, kTail, MODE>, p, B, H, stream);
  if constexpr (kTail != 64) {
    if (p.groups == 1 && chunks == 5)  // 257..264 keys
      return launch(short_attention_bwd_dq<5, 8, kTail, MODE>, p, B, H, stream);
  }
  switch (chunks) {
    case 1: return launch(short_attention_bwd_dq<1, 64, kTail, MODE>, p, B, H, stream);
    case 2: return launch(short_attention_bwd_dq<2, 64, kTail, MODE>, p, B, H, stream);
    case 3: return launch(short_attention_bwd_dq<3, 64, kTail, MODE>, p, B, H, stream);
    default: return launch(short_attention_bwd_dq<4, 64, kTail, MODE>, p, B, H, stream);
  }
}

template <int kTail, int MODE>
int launch_both(BwdParams& dq, BwdParams& dkv, int B, int H, cudaStream_t stream) {
  if (MODE == kRelBias) {
    // the rows' terms, then the drel sums, in shared memory where they fit
    // beside the tiles and the table (a block takes at most 227 KB)
    const int terms = kRows * (dq.KH + dq.KW) * 4, tab = dq.N * 4;
    const int bins = kRows * dq.bins_ld * 4, room = 227 * 1024 - 1024;
    const int tiles = layout(kTail, dq.rows, false, 0, tab, 0, 0).bytes;
    dq.rel_staged = tiles + terms + 16 <= room;
    dq.bins_shared = tiles + (dq.rel_staged ? terms + 16 : 0) + bins + 16 <= room;
    dq.sm = layout(kTail, dq.rows, false, dq.rel_staged ? terms : 0, tab,
                   dq.bins_shared ? bins : 0, 0);
  } else {
    dq.sm = layout(kTail, dq.rows, false, 0, 0, 0, 0);
  }
  const int es = MODE == kFullBias && dkv.bias_bf16 ? 2 : 4;
  dkv.sm = layout(kTail, dkv.rows, true, 0, 0, 0,
                  MODE == kNoBias ? 0 : 2 * kRows * dkv.ring_ld * es);
  const int err = launch_dq<kTail, MODE>(dq, B, H, stream);
  return err != 0 ? err : launch(short_attention_bwd_dkv<kTail, MODE>, dkv, B, H, stream);
}

// Shapes, tensor maps and the rest of both launches' parameters: dq, dk, dv
// (`grads`, strides st[12..14]) from q, k, v and dout (`in`, strides
// st[0..11]), scratch `stats` fp32 [2, B, H, N]. The mode's fields, set in
// `dq` by the caller, are copied to `dkv`. Returns 0 or a cudaError_t.
int prepare(BwdParams& dq, BwdParams& dkv, const void* const (&in)[4], void* const (&grads)[3],
            float* stats, const long long (&st)[15], int B, int H, int N, int D, int n_real,
            float scale) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > kMaxN || D < 1 || D > 128 ||
      n_real < 1 || n_real > N || !stats)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 4; ++i)
    if (!tma_ok(in[i], st[3 * i], st[3 * i + 1], st[3 * i + 2], B, H, N))
      return static_cast<int>(cudaErrorInvalidValue);
  // 257..264 keys in one pass where the dQ accumulators leave room (D <= 80)
  const int one_pass = D <= 80 ? kOnePassKeys : kGroupKeys;
  dq.groups = N <= one_pass ? 1 : (N + kGroupKeys - 1) / kGroupKeys;
  // the staged rows cover every chunk's rows: whole chunks of 64, and the
  // 8-wide last chunk (N = 193..200 and 257..264 in the first kernel, N =
  // 64k + 1..8 in the second) rounded up to a 16-row k-step
  const int by64 = (N + 63) / 64 * 64, by16 = (N + 15) / 16 * 16;
  const bool dq_narrow = (N + 7) / 8 * 8 == 200 || (N > 256 && N <= kOnePassKeys);
  dq.rows = dq.groups > 1 ? kGroupKeys : dq_narrow ? by16 : by64;
  dq.box = box_rows(dq.rows);
  dq.lse2 = stats;
  dq.row = stats + static_cast<long long>(B) * H * N;
  dq.dq = static_cast<bf16*>(grads[0]);
  dq.dk = static_cast<bf16*>(grads[1]);
  dq.dv = static_cast<bf16*>(grads[2]);
  dq.g_sb = st[12];
  dq.g_sh = st[13];
  dq.g_sn = st[14];
  dq.N = N;
  dq.D = D;
  dq.n_real = n_real;
  bool even = D % 2 == 0 && st[12] % 2 == 0 && st[13] % 2 == 0 && st[14] % 2 == 0;
  for (int i = 0; i < 3; ++i) even = even && (reinterpret_cast<uintptr_t>(grads[i]) & 3u) == 0;
  dq.out_vec = even;
  dq.scale = scale;
  dkv = dq;
  dkv.narrow = dq.groups == 1 && narrow_tail(N);
  dkv.rows = dq.groups > 1 ? kGroupKeys : dkv.narrow ? by16 : by64;
  dkv.box = box_rows(dkv.rows);
  // the first kernel owns q and dout (in[0], in[3]) and stages k and v; the
  // second the other way round
  const int own_dq[2] = {0, 3}, own_dkv[2] = {1, 2};
  for (int i = 0; i < 2; ++i) {
    const int a = own_dq[i], c = own_dkv[i];
    if (!make_maps(&dq.own[i], &dq.own_t[i], in[a], st[3 * a], st[3 * a + 1], st[3 * a + 2], B,
                   H, N, D, kRows) ||
        !make_maps(&dq.all[i], &dq.all_t[i], in[c], st[3 * c], st[3 * c + 1], st[3 * c + 2], B,
                   H, N, D, dq.box) ||
        !make_maps(&dkv.own[i], &dkv.own_t[i], in[c], st[3 * c], st[3 * c + 1], st[3 * c + 2], B,
                   H, N, D, kRows) ||
        !make_maps(&dkv.all[i], &dkv.all_t[i], in[a], st[3 * a], st[3 * a + 1], st[3 * a + 2], B,
                   H, N, D, dkv.box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// kOnly >= 0: only that tail's kernels (a caller that knows its head dims).
template <int MODE, int kOnly = -1>
int launch_mode(BwdParams& dq, BwdParams& dkv, int B, int H, cudaStream_t stream) {
  if constexpr (kOnly >= 0) {
    return launch_both<kOnly, MODE>(dq, dkv, B, H, stream);
  } else {
    if (dq.D <= 64) return launch_both<0, MODE>(dq, dkv, B, H, stream);
    if (dq.D <= 80) return launch_both<16, MODE>(dq, dkv, B, H, stream);
    return launch_both<64, MODE>(dq, dkv, B, H, stream);
  }
}

// K1, K2, K9 and K8's attention core (no bias); returns 0 or a cudaError_t.
template <int kOnly = -1>
int run_plain(const void* const (&in)[4], void* const (&grads)[3], float* stats,
              const long long (&st)[15], int B, int H, int N, int D, int n_real, float scale,
              cudaStream_t stream) {
  BwdParams dq{}, dkv{};
  const int err = prepare(dq, dkv, in, grads, stats, st, B, H, N, D, n_real, scale);
  return err != 0 ? err : launch_mode<kNoBias, kOnly>(dq, dkv, B, H, stream);
}

}  // namespace bwd
}  // namespace short_attn
}  // namespace saicv

// The C entry points; a source that includes this file for its kernels
// (attn_block.cu) defines SAICV_ATTENTION_DEVICE_ONLY.
#ifndef SAICV_ATTENTION_DEVICE_ONLY

using namespace saicv::short_attn;
using namespace saicv::short_attn::bwd;

// Plain C entry points, loaded with ctypes: dq, dk, dv (one stride set g_*)
// from q, k, v and dout, each with its own (batch, head, row) strides in
// elements and a contiguous head dim, each readable by TMA (16-byte aligned
// bases, strides multiples of 8 elements on axes longer than 1: the wrapper
// copies an operand that is not); scores scaled by `scale`. `stats` is fp32
// scratch of 2 * B * H * N elements. Two launches on `stream`; returns a
// cudaError_t (0 = both launched; cudaErrorInvalidValue for a shape, an
// operand or a tensor map the kernels cannot take).

// K1, K2, K9: no bias.
extern "C" int saicv_short_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
    float* stats, long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long do_sb,
    long long do_sh, long long do_sn, long long g_sb, long long g_sh, long long g_sn, int B,
    int H, int N, int D, int n_real, float scale, void* stream) {
  const void* const in[4] = {q, k, v, dout};
  void* const grads[3] = {dq, dk, dv};
  const long long st[15] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh,
                            v_sn, do_sb, do_sh, do_sn, g_sb, g_sh, g_sn};
  return run_plain(in, grads, stats, st, B, H, N, D, n_real, scale,
                   static_cast<cudaStream_t>(stream));
}

// K2b: the score of query i and key j of (batch b, head h) gained bias[b *
// b_sb + h * b_sh + i * b_sn + j], fp32 (bias_bf16 = 0) or bf16 (1), a
// stride 0 on an axis it is broadcast over; unless dbias is null, dbias =
// dS0 is written as a contiguous [B, H, N, N], fp32 (dbias_bf16 = 0) or
// bf16 (1).
extern "C" int saicv_short_attention_bias_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
    float* stats, const void* bias, void* dbias, long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long do_sb, long long do_sh, long long do_sn, long long g_sb,
    long long g_sh, long long g_sn, long long b_sb, long long b_sh, long long b_sn, int B, int H,
    int N, int D, int n_real, float scale, int bias_bf16, int dbias_bf16, void* stream) {
  if (!bias) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams pq{}, pkv{};
  pq.bias = bias;
  pq.b_sb = b_sb;
  pq.b_sh = b_sh;
  pq.b_sn = b_sn;
  pq.bias_bf16 = bias_bf16;
  const long long es = bias_bf16 ? 2 : 4;
  const auto divides = [&](long long unit) {
    return reinterpret_cast<uintptr_t>(bias) % unit == 0 && (b_sb * es) % unit == 0 &&
           (b_sh * es) % unit == 0 && (b_sn * es) % unit == 0;
  };
  pq.bias_pairs = N % 2 == 0 && divides(2 * es);  // every key pair in its row, aligned
  pq.bias_unit = divides(16) ? 16 : divides(8) ? 8 : divides(4) ? 4 : 2;
  pq.ring_ld = bias_bf16 ? 72 : 68;  // no bank conflicts where a warp reads its keys
  pq.dbias = dbias;
  pq.dbias_bf16 = dbias_bf16;
  const long long row_bytes = static_cast<long long>(N) * (dbias_bf16 ? 2 : 4);
  pq.dbias_unit = 2;
  for (const int unit : {16, 8, 4})
    if (row_bytes % unit == 0 && reinterpret_cast<uintptr_t>(dbias) % unit == 0) {
      pq.dbias_unit = unit;
      break;
    }
  const void* const in[4] = {q, k, v, dout};
  void* const grads[3] = {dq, dk, dv};
  const long long st[15] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh,
                            v_sn, do_sb, do_sh, do_sn, g_sb, g_sh, g_sn};
  const int err = prepare(pq, pkv, in, grads, stats, st, B, H, N, D, n_real, scale);
  return err != 0 ? err
                  : launch_mode<kFullBias>(pq, pkv, B, H, static_cast<cudaStream_t>(stream));
}

// K3/K4: the score of query i and key j gained rel_h[i, j / KW] + rel_w[i,
// j % KW] (fp32, N = KH * KW, each with its own (batch, head, row) strides
// and a contiguous last axis); drel_h and drel_w (fp32, the shapes of rel_h
// and rel_w, their own strides) are the sums over each query row's keys of
// dS0 by the key's row jh and column jw of the key grid.
extern "C" int saicv_short_attention_relpos_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
    float* stats, const float* rel_h, const float* rel_w, float* drel_h, float* drel_w,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long do_sb,
    long long do_sh, long long do_sn, long long g_sb, long long g_sh, long long g_sn,
    long long h_sb, long long h_sh, long long h_sn, long long w_sb, long long w_sh,
    long long w_sn, long long dh_sb, long long dh_sh, long long dh_sn, long long dw_sb,
    long long dw_sh, long long dw_sn, int B, int H, int N, int D, int n_real, int KH, int KW,
    float scale, void* stream) {
  if (KH < 1 || KW < 1 || KH * KW != N || !rel_h || !rel_w || !drel_h || !drel_w)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams pq{}, pkv{};
  pq.rel_h = rel_h;
  pq.rel_w = rel_w;
  pq.h_sb = h_sb;
  pq.h_sh = h_sh;
  pq.h_sn = h_sn;
  pq.w_sb = w_sb;
  pq.w_sh = w_sh;
  pq.w_sn = w_sn;
  pq.drel_h = drel_h;
  pq.drel_w = drel_w;
  pq.dh_sb = dh_sb;
  pq.dh_sh = dh_sh;
  pq.dh_sn = dh_sn;
  pq.dw_sb = dw_sb;
  pq.dw_sh = dw_sh;
  pq.dw_sn = dw_sn;
  pq.KH = KH;
  pq.KW = KW;
  plan_rel_copies(pq, N);
  pq.bins_ld = (KH + KW) | 1;  // odd: no bank conflicts between rows
  // a ring row: the rel_h columns of the key-grid rows that 64 keys span,
  // and the rel_w columns they read
  pq.ring_ld = min(KH, (kRows - 1) / KW + 2) + min(KW, kRows);
  const void* const in[4] = {q, k, v, dout};
  void* const grads[3] = {dq, dk, dv};
  const long long st[15] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh,
                            v_sn, do_sb, do_sh, do_sn, g_sb, g_sh, g_sn};
  const int err = prepare(pq, pkv, in, grads, stats, st, B, H, N, D, n_real, scale);
  return err != 0 ? err
                  : launch_mode<kRelBias>(pq, pkv, B, H, static_cast<cudaStream_t>(stream));
}

#endif  // SAICV_ATTENTION_DEVICE_ONLY
