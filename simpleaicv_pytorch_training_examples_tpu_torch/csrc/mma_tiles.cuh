// Tile helpers shared by the attention kernels (fused_attention.cu,
// flash_attention.cu): cp.async copies into shared memory, mma.sync
// m16n8k16 bf16 products with fp32 accumulation, ldmatrix fragment loads,
// and the rows of a warp's 16 x D accumulators.
//
// Fragment layout of mma.sync m16n8k16: g = lane / 4 is a fragment's row
// (and g + 8), t = lane % 4 its column pair.

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

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

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

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Start copying `rows` rows of one head (row stride `sn`, D contiguous
// elements) into shared memory [rows][LD]; rows at or past `nvalid` and
// columns at or past D become zero. With vec (16-byte aligned rows, D % 8
// == 0) the copy is asynchronous; otherwise it is done here element-wise.
template <int DP, int LD>
__device__ void load_tile_bf16(bf16* dst, const bf16* src, long long sn, int rows,
                               int nvalid, int D, bool vec) {
  if (vec) {
    constexpr int kVecPerRow = DP / 8;
    for (int i = threadIdx.x; i < rows * kVecPerRow; i += blockDim.x) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const bool valid = r < nvalid && c < D;
      cp_async16(dst + r * LD + c, valid ? src + r * sn + c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
      const int r = i / DP;
      const int c = i % DP;
      dst[r * LD + c] = (r < nvalid && c < D) ? src[r * sn + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// The A fragments of a warp's 16 rows (row-major in shared memory).
template <int DP, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DP / 16][4], const bf16* rows16,
                                             int g, int t) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    f[ks][0] = ld_u32(rows16 + g * LD + 16 * ks + 2 * t);
    f[ks][1] = ld_u32(rows16 + (g + 8) * LD + 16 * ks + 2 * t);
    f[ks][2] = ld_u32(rows16 + g * LD + 16 * ks + 8 + 2 * t);
    f[ks][3] = ld_u32(rows16 + (g + 8) * LD + 16 * ks + 8 + 2 * t);
  }
}

// s[j] = own(16 x DP) . other(rows 8j..8j+7)^T for the FR fragments of one
// tile whose first row is `first` (a multiple of 16); 16-row groups at or
// past `limit` stay zero. One ldmatrix.x4 brings the B fragments of two
// adjacent 8-row groups for one k-step: lane -> row (lane % 8) of the group
// lane / 16, columns +0 or +8 by (lane / 8) % 2.
template <int DP, int LD, int FR>
__device__ __forceinline__ void own_times_other_t(float (&s)[FR][4],
                                                  const uint32_t (&af)[DP / 16][4],
                                                  const bf16* other, int first, int limit,
                                                  int lane) {
  const bf16* base = other + (lane % 8 + 8 * (lane / 16)) * LD + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int j = 0; j < FR; j += 2) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    s[j + 1][0] = s[j + 1][1] = s[j + 1][2] = s[j + 1][3] = 0.f;
    if (first + 8 * j < limit) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        uint32_t b[4];
        ldmatrix_x4(b, base + 8 * j * LD + 16 * ks);
        mma_16816(s[j], af[ks], b[0], b[1]);
        mma_16816(s[j + 1], af[ks], b[2], b[3]);
      }
    }
  }
}

// acc(16 x DP) += a(16 x 16) . x(16 rows x DP), x row-major in shared memory.
template <int DP, int LD>
__device__ __forceinline__ void accumulate_ax(float (&acc)[DP / 8][4], const uint32_t (&a)[4],
                                              const bf16* x16, int lane) {
  // lane -> row of one of four 8x8 matrices: rows +0/+8, columns +0/+8
  const int mi = lane / 8;
  const bf16* xr = x16 + ((mi & 1) * 8 + lane % 8) * LD + (mi >> 1) * 8;
#pragma unroll
  for (int e2 = 0; e2 < DP / 16; ++e2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, xr + 16 * e2);
    mma_16816(acc[2 * e2], a, b[0], b[1]);
    mma_16816(acc[2 * e2 + 1], a, b[2], b[3]);
  }
}

// Write a warp's 16 x DP accumulators as bf16 rows row0.. of one head.
template <int DP>
__device__ __forceinline__ void store_rows_bf16(bf16* head, long long sn,
                                                const float (&acc)[DP / 8][4], int row0, int N,
                                                int D, int g, int t, int out_vec) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= N) continue;
      bf16* dst = head + row * sn + c;
      if (out_vec) {
        if (c < D)
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        if (c < D) dst[0] = __float2bfloat16_rn(acc[j][2 * r]);
        if (c + 1 < D) dst[1] = __float2bfloat16_rn(acc[j][2 * r + 1]);
      }
    }
  }
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
