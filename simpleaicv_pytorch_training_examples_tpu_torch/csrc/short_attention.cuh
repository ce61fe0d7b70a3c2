// Device and host pieces shared by the short-sequence attention kernels on
// wgmma (short_attention_fwd.cu, short_attention_bwd.cu): a block is one
// warpgroup that owns 64 rows of one (batch, head); the other operand's rows
// of the head (up to kOnePassKeys, or a group of kGroupKeys) are staged in
// shared memory by TMA; a 64 x N score row stays in the accumulators as
// chunks of 64 keys.
//
// Everything is in namespace saicv::short_attn, and each source puts its
// own code in a namespace nested in it, so that attn_block.cu can include
// both sources beside fused_attention.cu (whose names live in an anonymous
// namespace) without a clash.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace saicv {
namespace short_attn {

constexpr int kThreads = 128;      // one warpgroup
constexpr int kRows = 64;          // rows a block owns
constexpr int kGroupKeys = 256;    // keys a group holds in the accumulators
constexpr int kOnePassKeys = 264;  // a row this long stays whole: 256 + 8 keys
constexpr int kMaxN = 1024;
constexpr float kNegInf = -1e9f;  // _NEG_INF of the TPU kernels

// What the scores gain: nothing (K1, K2, K9), SAM's decomposed rel-pos bias
// (K3, K4) or a full bias (K2b).
enum BiasMode { kNoBias, kRelBias, kFullBias };

// The block's dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle's alignment), as an offset into the shared array, so
// that the compiler keeps loads through it in the shared space.
__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  return smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
}

// Accumulator registers of chunk c: 32 (64 keys), or kLast / 2 for the last
// chunk of a block whose last chunk is narrower (kLast = 8: N = 193..200 or
// 257..264).
template <int KC, int kLast>
__host__ __device__ constexpr int regs_of(int c) {
  return c + 1 < KC ? 32 : kLast / 2;
}

// Registers of a warpgroup's accumulators of the head columns past 64:
// none, 16 (D in (64, 80]) or 64 columns.
template <int kTail>
__host__ __device__ constexpr int tail_regs() {
  return kTail == 0 ? 1 : kTail / 2;
}

// 16-column k-steps of a product over the head dim: four over columns 0-63
// and one or four over the tail, whatever D (the tensor maps fill the
// columns past D with zeros, which add exact zeros), so that every wgmma's
// accumulate flag is known at compile time.
template <int kTail>
__host__ __device__ constexpr int ksteps_of() {
  return 4 + kTail / 16;
}

// Bytes of one staged row of the columns past 64 (the tail box): 32 (16
// columns, 32-byte swizzle) or 128.
template <int kTail>
__host__ __device__ constexpr int tail_bytes() {
  return kTail == 16 ? 32 : kTail == 64 ? 128 : 0;
}

// d (64 x width) = (acc ? d : 0) + A . B^T over one k-step, B K-major at
// `b` with `row_bytes` a row: n = 64, or the pieces of 32, 16 and 8 rows of
// a narrower chunk (width a multiple of 8; registers past it are left
// alone).
__device__ __forceinline__ void chunk_product(float (&d)[32], uint64_t a, uint32_t b,
                                              int row_bytes, bool sw32, int width, int acc) {
  auto desc = [&](int key) {
    const uint32_t at = b + key * row_bytes;
    return sw32 ? sw32_desc(at) : sw128_desc(at, 16);
  };
  auto n32 = [&](int key) {
    wgmma_ss<32, 0>(*reinterpret_cast<float(*)[16]>(&d[key / 2]), a, desc(key), acc);
  };
  auto n16 = [&](int key) {
    wgmma_ss<16, 0>(*reinterpret_cast<float(*)[8]>(&d[key / 2]), a, desc(key), acc);
  };
  auto n8 = [&](int key) {
    wgmma_ss<8, 0>(*reinterpret_cast<float(*)[4]>(&d[key / 2]), a, desc(key), acc);
  };
  switch (width >> 3) {
    case 8: wgmma_ss<64, 0>(d, a, desc(0), acc); break;
    case 7: n32(0); n16(32); n8(48); break;
    case 6: n32(0); n16(32); break;
    case 5: n32(0); n8(32); break;
    case 4: n32(0); break;
    case 3: n16(0); n8(16); break;
    case 2: n16(0); break;
    default: n8(0); break;
  }
}

// The A and B descriptors of k-step kk of a product over the head dim: A a
// 64-row operand at a (columns 0-63) and at (the tail), B rows at b and bt;
// `row_bytes` is set to B's bytes a row.
template <int kTail>
__device__ __forceinline__ void kstep(int kk, uint32_t a, uint32_t at, uint32_t b, uint32_t bt,
                                      uint64_t& ad, uint32_t& bs, int& row_bytes, bool& sw32) {
  const bool head = kk < 4;  // columns 0-63
  sw32 = !head && kTail == 16;
  ad = head ? sw128_desc(a + 32 * kk, 16)
            : sw32 ? sw32_desc(at) : sw128_desc(at + 32 * (kk - 4), 16);
  bs = head ? b + 32 * kk : sw32 ? bt : bt + 32 * (kk - 4);
  row_bytes = sw32 ? 32 : 128;
}

// s[c] (64 x 64: rows 64c.. of the staged operand) = A . B^T; the last
// chunk only `width` rows wide (kLast = 8: an n = 8 product; registers past
// the width are left as they were). The first k-step sets the accumulators
// and the others, a loop the compiler keeps rolled (fewer live registers),
// add to them. Committed, not waited for.
template <int KC, int kLast, int kTail>
__device__ __forceinline__ void scores(float (&s)[KC][32], uint32_t a, uint32_t at, uint32_t b,
                                       uint32_t bt, int width) {
  auto step = [&](int kk, int acc) {
    uint64_t ad;
    uint32_t bs;
    int row_bytes;
    bool sw32;
    kstep<kTail>(kk, a, at, b, bt, ad, bs, row_bytes, sw32);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const uint32_t bc = bs + 64 * c * row_bytes;
      const uint64_t bd = sw32 ? sw32_desc(bc) : sw128_desc(bc, 16);
      if (c + 1 < KC)
        wgmma_ss<64, 0>(s[c], ad, bd, acc);
      else if constexpr (kLast == 8)
        wgmma_ss<8, 0>(*reinterpret_cast<float(*)[4]>(&s[c][0]), ad, bd, acc);
      else
        chunk_product(s[c], ad, bc, row_bytes, sw32, width, acc);
    }
  };
  wg_fence();
  step(0, 0);
#pragma unroll 1
  for (int kk = 1; kk < ksteps_of<kTail>(); ++kk) step(kk, 1);
  wg_commit();
}

// One chunk: d (64 x kWidth, kWidth 64 or 8) = A . B^T, B's rows from
// `row0` of the staged operand (kWidth = 8: registers 0-3). Not fenced: the
// caller fences once before its products. Committed, not waited for.
template <int kTail, int kWidth>
__device__ __forceinline__ void chunk_scores(float (&d)[32], uint32_t a, uint32_t at, uint32_t b,
                                             uint32_t bt, int row0) {
#pragma unroll
  for (int kk = 0; kk < ksteps_of<kTail>(); ++kk) {
    uint64_t ad;
    uint32_t bs;
    int row_bytes;
    bool sw32;
    kstep<kTail>(kk, a, at, b, bt, ad, bs, row_bytes, sw32);
    const uint32_t bc = bs + row0 * row_bytes;
    const uint64_t bd = sw32 ? sw32_desc(bc) : sw128_desc(bc, 16);
    if constexpr (kWidth == 64)
      wgmma_ss<64, 0>(d, ad, bd, kk > 0);
    else
      wgmma_ss<8, 0>(*reinterpret_cast<float(*)[4]>(&d[0]), ad, bd, kk > 0);
  }
  wg_commit();
}

// The bf16 A fragments of the 16-column k-steps of a 64 x 64 fp32
// accumulator chunk (times `scale`) of which the first kRegs registers are
// set (the accumulator layout is the A operand's; the rest are zeros),
// settled for the products that read them.
template <int kRegs>
__device__ __forceinline__ void a_fragments(uint32_t (&a)[4][4], const float (&s)[32],
                                            float scale = 1.f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[j][r] = 8 * j + 2 * r < kRegs
                    ? pack_bf16(s[8 * j + 2 * r] * scale, s[8 * j + 2 * r + 1] * scale)
                    : 0u;
    settle(a[j]);
  }
}

// acc (64 x 64, columns 0-63) and acc_t (64 x kTail, columns 64..) += A . B
// for the A fragments of kSteps 16-row k-steps, B the staged operand's rows
// row0.. read MN-major (its head dim is the product's N). Not fenced: the
// caller fences once before its products. Committed, not waited for.
template <int kTail, int kSteps>
__device__ __forceinline__ void times_rows(float (&acc)[32], float (&acc_t)[tail_regs<kTail>()],
                                           const uint32_t (&a)[4][4], uint32_t b, uint32_t bt,
                                           int row0) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int row = row0 + 16 * j;
    wgmma_rs<64>(acc, a[j], sw128_desc(b + row * 128, 16), 1);
    if constexpr (kTail == 16)
      wgmma_rs<16>(acc_t, a[j], sw32_desc(bt + row * 32), 1);
    else if constexpr (kTail == 64)
      wgmma_rs<64>(acc_t, a[j], sw128_desc(bt + row * 128, 16), 1);
  }
  wg_commit();
}

// Raw scores of keys key0.. (no bias) -> log2-domain logits s * sc; keys at
// or past n_real `masked`, at or past N -inf.
template <int KC, int kLast>
__device__ __forceinline__ void plain_logits(float (&s)[KC][32], int key0, int t, int N,
                                             int n_real, float sc, float masked) {
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int i = 0; i < regs_of<KC, kLast>(c); ++i) {
      const int col = key0 + 64 * c + 8 * (i >> 2) + 2 * t + (i & 1);
      s[c][i] = col < n_real ? s[c][i] * sc : col < N ? masked : -INFINITY;
    }
}

// The row maxima of the thread's rows g and g + 8 over the staged logits,
// over the quad's four lanes.
template <int KC, int kLast>
__device__ __forceinline__ void row_max(const float (&s)[KC][32], float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int i = 0; i < regs_of<KC, kLast>(c); ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[c][i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
}

// s = 2^(s - m) in place; returns the thread's share of each row's sum.
template <int KC, int kLast>
__device__ __forceinline__ void exp2_rows(float (&s)[KC][32], const float (&m)[2],
                                          float (&sum)[2]) {
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int i = 0; i < regs_of<KC, kLast>(c); ++i) {
      s[c][i] = exp2_approx(s[c][i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[c][i];
    }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The whole row's max + log2(sum of 2^(logit - max)) of the thread's rows
// g and g + 8: P = 2^(logit - lse2), as the forward forms it.
template <int KC, int kLast>
__device__ __forceinline__ void row_lse2(const float (&s)[KC][32], float (&lse2)[2]) {
  float mx[2], sum[2] = {0.f, 0.f};
  row_max<KC, kLast>(s, mx);
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int i = 0; i < regs_of<KC, kLast>(c); ++i)
      sum[(i >> 1) & 1] += exp2_approx(s[c][i] - mx[(i >> 1) & 1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) lse2[h] = mx[h] + __log2f(quad_sum(sum[h]));
}

// The log2-domain logit of raw score x of key col with its bias term:
// x*sc + bias*log2(e); keys at or past n_real `masked`, at or past N -inf.
__device__ __forceinline__ float biased_logit(float x, float bias, int col, int n_real, int N,
                                              float sc, float masked) {
  return col < n_real ? fmaf(x, sc, bias * kLog2e) : col < N ? masked : -INFINITY;
}

// An async copy of `bytes` (<= unit) of one unit (16, 8 or 4 bytes, both
// addresses aligned to it); the rest of the unit is zero-filled.
__device__ __forceinline__ void cp_async_part(void* dst, const void* src, int unit, int bytes) {
  if (unit == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  else if (unit == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) that completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// K3/K4: the table of (j / KW) | (j % KW) << 16 of every key column j < N.
__device__ __forceinline__ void key_table(int* tab, int N, int KW) {
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const int jh = j / KW;
    tab[j] = jh | (j - jh * KW) << 16;
  }
}

// K3/K4, for a launch's parameters P (the rel terms' fields, N): the
// block's rel_h rows [64][KH] and rel_w rows [64][KW] of query rows q0..:
// where a term's rows lie back to back (rel_bulk: K4's [B, H, N, K]) one
// bulk copy a term by thread 0 on `bar` (rows at or past N unset: their
// scores are never stored), else cp.async copies of rel_unit bytes (rows
// at or past N zeros); and the table of (j / KW) | (j % KW) << 16 of every
// key column j < N.
template <typename P>
__device__ __forceinline__ void stage_rel(const P& p, float* rh, float* rw, int* tab,
                                          uint64_t* bar, int b, int hd, int q0) {
  const float* h0 = p.rel_h + b * p.h_sb + hd * p.h_sh;
  const float* w0 = p.rel_w + b * p.w_sb + hd * p.w_sh;
  if (!p.rel_bulk) {
    const int unit = p.rel_unit, fu = unit / 4;  // floats a copy
    const int per_h = p.KH / fu, per_w = p.KW / fu;
    for (int i = threadIdx.x; i < kRows * per_h; i += kThreads) {
      const int r = i / per_h, c = i % per_h * fu;
      const bool in = q0 + r < p.N;
      cp_async_part(rh + r * p.KH + c, in ? h0 + (q0 + r) * p.h_sn + c : h0, unit,
                    in ? unit : 0);
    }
    for (int i = threadIdx.x; i < kRows * per_w; i += kThreads) {
      const int r = i / per_w, c = i % per_w * fu;
      const bool in = q0 + r < p.N;
      cp_async_part(rw + r * p.KW + c, in ? w0 + (q0 + r) * p.w_sn + c : w0, unit,
                    in ? unit : 0);
    }
  } else if (threadIdx.x == 0) {
    const int rows = min(kRows, p.N - q0);
    mbar_expect_tx(bar, rows * (p.KH + p.KW) * 4);
    bulk_copy(rh, h0 + q0 * p.h_sn, rows * p.KH * 4, bar);
    bulk_copy(rw, w0 + q0 * p.w_sn, rows * p.KW * 4, bar);
  }
  key_table(tab, p.N, p.KW);
}

// rel_h[j / KW] + rel_w[j % KW] of key columns j = col and col + 1 (at most
// N - 1) of one query row's terms rh and rw, by the key-column table.
__device__ __forceinline__ void rel_pair(const float* rh, const float* rw, const int* tab, int N,
                                         int col, float& b0, float& b1) {
  const int e0 = tab[min(col, N - 1)], e1 = tab[min(col + 1, N - 1)];
  b0 = rh[e0 & 0xffff] + rw[e0 >> 16];
  b1 = rh[e1 & 0xffff] + rw[e1 >> 16];
}

// ------------------------------------------------------------- host side

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// How stage_rel copies the rel terms of a launch's parameters P (rel_h,
// rel_w and their strides in floats, KH, KW set): rel_bulk where each
// term's rows lie back to back (K4's layout) and a tile's rows are one
// block whose ends lie on 16 bytes, else rel_unit, the widest copy that
// every row start and both row lengths allow (K3's [B, N, H, 14]: rows of
// 56 bytes at 8-byte boundaries, 8 bytes).
template <typename P>
inline void plan_rel_copies(P& p, int N) {
  const auto a16 = [](const void* ptr, long long x, long long y) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (x * 4) % 16 == 0 && (y * 4) % 16 == 0;
  };
  const long long tail_rows = N % kRows == 0 ? kRows : N % kRows;
  p.rel_bulk = p.h_sn == p.KH && p.w_sn == p.KW && a16(p.rel_h, p.h_sb, p.h_sh) &&
               a16(p.rel_w, p.w_sb, p.w_sh) && (tail_rows * p.KH * 4) % 16 == 0 &&
               (tail_rows * p.KW * 4) % 16 == 0;
  const auto divides = [&](long long unit) {
    const long long f = unit / 4;
    return reinterpret_cast<uintptr_t>(p.rel_h) % unit == 0 &&
           reinterpret_cast<uintptr_t>(p.rel_w) % unit == 0 && p.h_sb % f == 0 &&
           p.h_sh % f == 0 && p.h_sn % f == 0 && p.w_sb % f == 0 && p.w_sh % f == 0 &&
           p.w_sn % f == 0 && p.KH % f == 0 && p.KW % f == 0;
  };
  p.rel_unit = divides(16) ? 16 : divides(8) ? 8 : 4;
}

// TMA reads an operand in place: a 16-byte aligned base and (batch, head,
// row) strides that are multiples of 8 elements on every axis longer than 1.
inline bool tma_ok(const void* ptr, long long sb, long long sh, long long sn, int B, int H,
                   int N) {
  return aligned16(ptr) && (B == 1 || sb % 8 == 0) && (H == 1 || sh % 8 == 0) &&
         (N == 1 || sn % 8 == 0);
}

// Rows a group stages (N rounded up to 16 where one pass holds the row, else
// kGroupKeys) and the rows of one TMA box (at most 256: a staging of more
// rows goes in two boxes of half as many, each 1024-byte aligned).
inline int staged_rows(int N, int groups) { return groups == 1 ? (N + 15) / 16 * 16 : kGroupKeys; }
inline int box_rows(int rows) { return rows <= 256 ? rows : rows / 2; }

// Whether the row of N keys ends in a chunk of at most 8 (an n = 8 product).
inline bool narrow_tail(int N) { return N % 64 >= 1 && N % 64 <= 8; }

// The maps of one operand at `rows` rows a box: columns 0-63 (128-byte
// swizzle) and, for D in (64, 80], columns 64-79 in boxes of 16 (32-byte
// swizzle).
inline bool make_maps(CUtensorMap* main, CUtensorMap* tail, const void* ptr, long long sb,
                      long long sh, long long sn, int B, int H, int N, int D, int rows) {
  if (!make_map(main, ptr, sb, sh, sn, B, H, N, D, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  return !(D > 64 && D <= 80) ||
         make_map(tail, ptr, sb, sh, sn, B, H, N, D, 16, rows, CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace short_attn
}  // namespace saicv
