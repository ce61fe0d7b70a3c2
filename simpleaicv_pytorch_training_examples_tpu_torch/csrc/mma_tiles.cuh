// Tile helpers shared by the attention kernels: cp.async copies into
// shared memory, the bf16 packing, exp2 on the special-function unit and
// the decomposed rel-pos bias's indexing. The port's bf16 products all run
// on wgmma (hopper.cuh); no kernel issues mma.sync.
//
// Fragment rows and columns below follow wgmma's accumulator layout: g =
// lane / 4 is a fragment's row (and g + 8), t = lane % 4 its column pair.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace saicv {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4-byte async copy; src_bytes = 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// 2^x on the special-function unit (~2 ulp; 0 for -inf and below -126).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 pair of what rounding lo and hi to bf16 leaves out: with
// pack_bf16 it splits an fp32 pair into two bf16 pairs whose sum carries
// 16 bits of mantissa.
__device__ __forceinline__ uint32_t pack_bf16_residual(float lo, float hi) {
  const float2 r = __bfloat1622float2(__floats2bfloat162_rn(lo, hi));
  return pack_bf16(lo - r.x, hi - r.y);
}

// Decomposed relative-position bias of SAM's attention: the score of query
// row q and key j = jh * KW + jw gains rel_h[q, jh] + rel_w[q, jw] (fp32,
// each of the two with its own row stride, KH or KW contiguous values a
// row). `col_split` finds (jh, jw) for a key j < 2^20 without an integer
// division: (j + 0.5) / KW is at least 0.5 / KW from the next integer, far
// more than the float product's rounding error there.
__device__ __forceinline__ void col_split(int col, float inv_kw, int KW, int& jh, int& jw) {
  jh = static_cast<int>((static_cast<float>(col) + 0.5f) * inv_kw);
  jw = col - jh * KW;
}

// The rel_h and rel_w rows of a lane's two fragment rows.
struct RelRows {
  const float* h[2];
  const float* w[2];
};

// rel_h [.., N, KH] and rel_w [.., N, KW] of one launch, with their
// (batch, head, row) strides in elements; the last axis is contiguous.
struct RelPos {
  const float* h;
  const float* w;
  long long h_sb, h_sh, h_sn, w_sb, w_sh, w_sn;
  int KH, KW;
  float inv_kw;

  // rows `row` and row + 8 of (batch b, head hd); rows past N read row N - 1
  // (their scores are never stored)
  __device__ __forceinline__ RelRows rows(int b, int hd, int row, int N) const {
    RelRows r;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long n = min(row + 8 * i, N - 1);
      r.h[i] = h + b * h_sb + hd * h_sh + n * h_sn;
      r.w[i] = w + b * w_sb + hd * w_sh + n * w_sn;
    }
    return r;
  }
};

// The gradients of rel_h and rel_w (same shapes as the two terms, fp32),
// with their own (batch, head, row) strides in elements.
struct RelGrad {
  float* h;
  float* w;
  long long h_sb, h_sh, h_sn, w_sb, w_sh, w_sn;

  __device__ __forceinline__ float* h_row(int b, int hd, long long row) const {
    return h + b * h_sb + hd * h_sh + row * h_sn;
  }
  __device__ __forceinline__ float* w_row(int b, int hd, long long row) const {
    return w + b * w_sb + hd * w_sh + row * w_sn;
  }
};

// Raw scores q.k of one key tile (FR fragments of 8 keys from key0) ->
// log2-domain logits s*sc + (rel_h + rel_w)*log2(e), sc = scale*log2(e);
// keys at or past N get -inf, keys at or past n_real `masked`.
template <int FR>
__device__ __forceinline__ void rel_logits(float (&s)[FR][4], const RelRows& rr, int key0,
                                           int t, int N, int n_real, float sc, float masked,
                                           int KW, float inv_kw) {
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
        int jh, jw;
        col_split(col, inv_kw, KW, jh, jw);
        s[j][half] = fmaf(s[j][half], sc, (__ldg(rr.h[0] + jh) + __ldg(rr.w[0] + jw)) * kLog2e);
        s[j][2 + half] =
            fmaf(s[j][2 + half], sc, (__ldg(rr.h[1] + jh) + __ldg(rr.w[1] + jw)) * kLog2e);
      }
    }
}

}  // namespace saicv
